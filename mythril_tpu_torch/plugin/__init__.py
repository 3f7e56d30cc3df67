"""Laser plugin hooks at the host boundary (transaction start/end, chunk
boundaries, run end); external plugin discovery is not part of this
package yet."""

from .interface import LaserPlugin, PluginBuilder
from .loader import LaserPluginLoader

__all__ = ["LaserPlugin", "PluginBuilder", "LaserPluginLoader"]
