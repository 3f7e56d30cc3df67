"""Plugin loader (reference: ``laser/plugin/loader.py`` singleton ⚠unv).

Explicit instance instead of a hidden singleton: build one, ``load``
builders/plugins, pass ``plugins`` to ``SymExecWrapper``.
"""

from __future__ import annotations

import logging
from typing import List, Union

from .interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)


class LaserPluginLoader:
    def __init__(self):
        self._plugins: List[LaserPlugin] = []

    def load(self, item: Union[LaserPlugin, PluginBuilder]) -> "LaserPluginLoader":
        plugin = item.build() if isinstance(item, PluginBuilder) else item
        self._plugins.append(plugin)
        return self

    @property
    def plugins(self) -> List[LaserPlugin]:
        return list(self._plugins)

    def fire(self, hook: str, *args) -> None:
        for p in self._plugins:
            try:
                getattr(p, hook)(*args)
            except Exception:  # noqa: BLE001 — degrade, don't kill the run
                log.exception("plugin %s failed in %s", p.name, hook)
