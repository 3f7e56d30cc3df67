"""Orchestration layer: config, contract loading, the analysis front door."""

from .orchestration import EVMContract, MythrilAnalyzer, MythrilConfig, MythrilDisassembler

__all__ = ["EVMContract", "MythrilAnalyzer", "MythrilConfig", "MythrilDisassembler"]
