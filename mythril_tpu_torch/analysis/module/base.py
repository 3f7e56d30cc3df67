"""DetectionModule base class — source-compatible shape, batched payload.

The reference's ``mythril/analysis/module/base.py`` (⚠unv) defines
``DetectionModule`` with ``entry_point`` (CALLBACK = hooked per opcode
during execution, POST = after exploration), ``pre_hooks``/``post_hooks``
opcode name lists, and ``_execute(state) -> issues``. Here the payload is
*batched*: a module's ``_execute`` receives the whole ``SymFrontier``
(plus corpus + solver budget) and scans every surviving lane's event
records at once — per the north-star, modules "stay source-compatible and
consume batched GlobalStates".

CALLBACK-style firing inside the jitted superstep would mean re-tracing
per module; instead the engine records per-opcode *events* (calls,
selfdestructs, symbolic jumps, arithmetic) on device, and modules run
POST over those records. The hook lists are kept for API compatibility
and used to decide which event streams a module consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List

from ..report import Issue


class EntryPoint(Enum):
    POST = 1
    CALLBACK = 2  # accepted for compatibility; fired from event records


class DetectionModule:
    name: str = ""
    swc_id: str = ""
    description: str = ""
    entry_point: EntryPoint = EntryPoint.POST
    pre_hooks: List[str] = []
    post_hooks: List[str] = []

    def __init__(self):
        self.issues: List[Issue] = []
        self._cache = set()  # (contract_id, address) pairs already reported

    def reset(self) -> None:
        self.issues = []
        self._cache = set()

    def execute(self, ctx) -> List[Issue]:
        """ctx: AnalysisContext with the final SymFrontier + corpus +
        solver budget. Returns newly found issues (also accumulated)."""
        new = self._execute(ctx)
        self.issues.extend(new)
        return new

    def _execute(self, ctx) -> List[Issue]:
        raise NotImplementedError

    def _seen(self, contract_id: int, address: int) -> bool:
        """Issue cache, as in the reference (one report per code location)."""
        key = (contract_id, address)
        if key in self._cache:
            return True
        self._cache.add(key)
        return False
