"""Shipped plugins (the JAX package's ``plugin/plugins.py``).

The reference's pruners (mutation/dependency) and loop bound are engine
lane-kill policies here (``between_txs`` / ``_note_backjump``) — fused,
not hook-based; the call-depth limiter is the frame array's static depth
cap. What remains hook-shaped: benchmark + coverage.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .interface import LaserPlugin


class BenchmarkPlugin(LaserPlugin):
    """states/sec over the run (reference: ``plugins/benchmark.py`` ⚠unv):
    per-transaction wall time + executed lane-steps from the frontier's
    ``n_steps`` counters."""

    name = "benchmark"

    def __init__(self):
        self.tx_records: List[Dict] = []
        self._t0 = None
        self._steps0 = 0

    def initialize(self, wrapper) -> None:
        self.tx_records.clear()

    def on_tx_start(self, tx_index: int, sf) -> None:
        self._t0 = time.perf_counter()
        # the engine's frontier (torch) at a tx start, numpy in a context
        self._steps0 = int(sf.base.n_steps.sum())

    def on_tx_end(self, ctx) -> None:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        steps = int(np.asarray(ctx.sf.base.n_steps).sum()) - self._steps0
        self.tx_records.append({
            "wall_sec": round(dt, 4),
            "lane_steps": steps,
            "lane_steps_per_sec": round(steps / dt, 1) if dt > 0 else 0.0,
            "live_paths": int((np.asarray(ctx.sf.base.active)
                               & ~np.asarray(ctx.sf.base.error)).sum()),
        })

    def summary(self) -> Dict:
        total_steps = sum(r["lane_steps"] for r in self.tx_records)
        total_time = sum(r["wall_sec"] for r in self.tx_records)
        return {
            "transactions": self.tx_records,
            "total_lane_steps": total_steps,
            "total_wall_sec": round(total_time, 4),
            "lane_steps_per_sec": round(total_steps / total_time, 1)
            if total_time > 0 else 0.0,
        }


class CoveragePlugin(LaserPlugin):
    """Final instruction-coverage percentages (reference:
    ``plugins/coverage/`` ⚠unv) — reads the wrapper's visited bitmap."""

    name = "coverage"

    def __init__(self):
        self.coverage: Dict[str, float] = {}

    def on_run_end(self, wrapper) -> None:
        self.coverage = wrapper.instruction_coverage()
