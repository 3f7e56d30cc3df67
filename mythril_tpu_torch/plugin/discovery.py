"""Outer plugin discovery: load third-party extensions into the runtime.

PyTorch-package copy of the JAX package's ``plugin/discovery.py``: the
same two channels, installing into this package's registries:

- **installed packages**: ``importlib.metadata`` entry points in group
  ``mythril_tpu_torch.plugins`` (each entry point resolves to a plugin
  object, see below);
- **plugin directories** (``--plugin-dir``): every ``*.py`` file in the
  directory is imported — no pip install required, which matters in
  hermetic images.

A resolved object may be any of:

- a :class:`DetectionModule` subclass — registered into the global
  :func:`register_module` registry (shows up in ``list-detectors`` and
  ``fire_lasers`` immediately);
- a :class:`LaserPlugin` / :class:`PluginBuilder` subclass or instance —
  collected for ``SymExecWrapper(plugins=...)``;
- a module (entry point to a module, or a plugin-dir file) — scanned for
  a ``MYTHRIL_PLUGINS`` list of the above; without one, every top-level
  class DEFINED IN that module is classified.

Failures are isolated per plugin (one broken extension cannot take down
an analysis run — same degrade policy as detection modules).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import types
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..analysis.module.base import DetectionModule
from ..analysis.module.loader import register_module
from .interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)

ENTRYPOINT_GROUP = "mythril_tpu_torch.plugins"


@dataclass
class DiscoveredPlugins:
    """What discovery found and installed."""

    laser_plugins: List[LaserPlugin] = field(default_factory=list)
    detection_modules: List[str] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)

    def merge(self, other: "DiscoveredPlugins") -> "DiscoveredPlugins":
        self.laser_plugins += other.laser_plugins
        self.detection_modules += other.detection_modules
        self.errors.update(other.errors)
        return self


def _classify(obj, name: str, out: DiscoveredPlugins) -> bool:
    """Install one resolved object into the right registry."""
    if isinstance(obj, type):
        if issubclass(obj, DetectionModule):
            register_module(obj)
            out.detection_modules.append(obj.__name__)
            return True
        if issubclass(obj, PluginBuilder):
            out.laser_plugins.append(obj().build())
            return True
        if issubclass(obj, LaserPlugin):
            out.laser_plugins.append(obj())
            return True
        return False
    if isinstance(obj, PluginBuilder):
        out.laser_plugins.append(obj.build())
        return True
    if isinstance(obj, LaserPlugin):
        out.laser_plugins.append(obj)
        return True
    if isinstance(obj, types.ModuleType):
        _scan_module(obj, name, out)
        return True
    return False


def _scan_module(mod: types.ModuleType, name: str,
                 out: DiscoveredPlugins) -> None:
    declared = getattr(mod, "MYTHRIL_PLUGINS", None)
    if declared is not None:
        for i, obj in enumerate(declared):
            if not _classify(obj, f"{name}[{i}]", out):
                out.errors[f"{name}[{i}]"] = (
                    "not a DetectionModule/LaserPlugin/PluginBuilder: %r"
                    % (obj,))
        return
    # no manifest: classify classes defined in (not imported into) the file
    for attr in vars(mod).values():
        if isinstance(attr, type) and attr.__module__ == mod.__name__ \
                and attr not in (DetectionModule, LaserPlugin, PluginBuilder):
            _classify(attr, name, out)


def discover_entrypoints(group: str = ENTRYPOINT_GROUP) -> DiscoveredPlugins:
    """Load every installed entry point in ``group``."""
    from importlib import metadata

    out = DiscoveredPlugins()
    try:
        eps = metadata.entry_points(group=group)
    except Exception as e:  # noqa: BLE001 — metadata backends vary
        out.errors[group] = f"entry-point scan failed: {e!r}"
        return out
    for ep in eps:
        try:
            obj = ep.load()
            if not _classify(obj, ep.name, out):
                out.errors[ep.name] = f"unsupported plugin object: {obj!r}"
        except Exception as e:  # noqa: BLE001 — isolate per plugin
            log.exception("plugin entry point %s failed to load", ep.name)
            out.errors[ep.name] = repr(e)
    return out


def load_plugin_dir(path: str) -> DiscoveredPlugins:
    """Import every ``*.py`` file under ``path`` (non-recursive) and
    install what it defines/declares."""
    out = DiscoveredPlugins()
    if not os.path.isdir(path):
        out.errors[path] = "not a directory"
        return out
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        name = "mythril_tpu_torch_plugin_" + fn[:-3]
        try:
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(path, fn))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _scan_module(mod, fn, out)
        except Exception as e:  # noqa: BLE001 — isolate per file
            log.exception("plugin file %s failed to load", fn)
            out.errors[fn] = repr(e)
    return out


def discover(plugin_dir: Optional[str] = None,
             entrypoints: bool = True) -> DiscoveredPlugins:
    """Both channels; entry points first (installed packages are the
    stable base, directory plugins can shadow-extend per run)."""
    out = DiscoveredPlugins()
    if entrypoints:
        out.merge(discover_entrypoints())
    if plugin_dir:
        out.merge(load_plugin_dir(plugin_dir))
    return out
