"""Analysis driver: symbolic wrapper, detection modules, reporting."""

from .report import Issue, Report, SWC_TITLES
from .symbolic import AnalysisContext, SymExecWrapper
from .security import fire_lasers
from .module.base import DetectionModule, EntryPoint
from .module.loader import ModuleLoader, register_module
from .module import modules  # noqa: F401  (registers the SWC suite)

__all__ = [
    "Issue", "Report", "SWC_TITLES",
    "AnalysisContext", "SymExecWrapper", "fire_lasers",
    "DetectionModule", "EntryPoint", "ModuleLoader", "register_module",
]
