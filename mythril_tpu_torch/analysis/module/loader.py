"""ModuleLoader: the detection-module registry.

Reference: ``mythril/analysis/module/loader.py`` (⚠unv) — a singleton
with entrypoint discovery. Here: explicit registry + the same
``get_detection_modules(white_list)`` filtering surface.
"""

from __future__ import annotations

from typing import List, Optional, Type

from .base import DetectionModule

_REGISTRY: List[Type[DetectionModule]] = []


def register_module(cls: Type[DetectionModule]) -> Type[DetectionModule]:
    """Idempotent: repeated discovery passes (two analyses in one
    process, a plugin dir re-imported under the same synthetic module
    name) must not register a module twice — duplicates would make
    ModuleLoader instantiate it twice and double every finding. Keyed by
    (module, qualname) because a re-imported plugin file produces a NEW
    class object with the same identity path."""
    key = (cls.__module__, cls.__qualname__)
    for existing in _REGISTRY:
        if (existing.__module__, existing.__qualname__) == key:
            return cls
    _REGISTRY.append(cls)
    return cls


class ModuleLoader:
    _instance: Optional["ModuleLoader"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._modules = [m() for m in _REGISTRY]
        return cls._instance

    def get_detection_modules(self, white_list: Optional[List[str]] = None) -> List[DetectionModule]:
        mods = list(self._modules)
        # late registrations (tests, plugins)
        known = {type(m) for m in mods}
        for m in _REGISTRY:
            if m not in known:
                inst = m()
                self._modules.append(inst)
                mods.append(inst)
                known.add(m)
        if white_list:
            wl = {w.lower() for w in white_list}
            mods = [m for m in mods if m.name.lower() in wl
                    or type(m).__name__.lower() in wl]
        return mods

    def reset_modules(self) -> None:
        for m in self._modules:
            m.reset()
