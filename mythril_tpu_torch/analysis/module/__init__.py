from .base import DetectionModule, EntryPoint
from .loader import ModuleLoader, register_module

__all__ = ["DetectionModule", "EntryPoint", "ModuleLoader", "register_module"]
