"""Plugin hook surface (reference: ``laser/plugin/interface.py`` ⚠unv)."""

from __future__ import annotations


class LaserPlugin:
    """Subclass and override any subset of the hooks. Exceptions are
    caught by the wrapper (one plugin can't kill the run — same degrade
    policy as detection modules)."""

    name = "plugin"

    def initialize(self, wrapper) -> None:
        """Called once before the first transaction."""

    def on_tx_start(self, tx_index: int, sf) -> None:
        """Before a transaction's exploration starts."""

    def on_chunk(self, sf, steps_done: int) -> None:
        """After each exploration chunk (only when the run is chunked)."""

    def on_tx_end(self, ctx) -> None:
        """After a transaction's AnalysisContext snapshot is taken."""

    def on_run_end(self, wrapper) -> None:
        """After the last transaction."""


class PluginBuilder:
    """Deferred construction (reference: ``PluginBuilder.build()`` ⚠unv)."""

    name = "builder"

    def build(self) -> LaserPlugin:
        raise NotImplementedError
