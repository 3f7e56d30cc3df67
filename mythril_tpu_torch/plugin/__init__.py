"""Laser plugin framework: hooks at the host boundary (transaction
starts/ends, chunk boundaries, run end) and outer discovery of external
plugins (installed entry points and ``--plugin-dir`` files)."""

from .discovery import (DiscoveredPlugins, discover, discover_entrypoints,
                        load_plugin_dir)
from .interface import LaserPlugin, PluginBuilder
from .loader import LaserPluginLoader
from .plugins import BenchmarkPlugin, CoveragePlugin

__all__ = ["LaserPlugin", "PluginBuilder", "LaserPluginLoader",
           "BenchmarkPlugin", "CoveragePlugin", "DiscoveredPlugins",
           "discover", "discover_entrypoints", "load_plugin_dir"]
