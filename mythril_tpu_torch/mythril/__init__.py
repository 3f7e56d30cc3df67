"""Orchestration layer: config, contract loading, the analysis front door,
and the corpus campaign (``campaign.py``)."""

__all__ = ["EVMContract", "MythrilAnalyzer", "MythrilConfig", "MythrilDisassembler"]


def __getattr__(name):
    """Lazy exports (PEP 562): orchestration pulls the whole analysis
    stack (PyTorch and the engine), but ``campaign-merge`` — dict math
    over result JSONs — imports from this package too and needs none of
    it."""
    if name in __all__:
        from . import orchestration

        return getattr(orchestration, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
