"""Exceptions (SWC-110): reachable assert violation (INVALID opcode).

Reference: ``mythril/analysis/module/modules/exceptions.py`` (⚠unv) —
solc compiles ``assert`` to INVALID (0xFE); reaching it with a
satisfiable path is an assert violation.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class Exceptions(DetectionModule):
    name = "Exceptions"
    swc_id = "110"
    description = "A reachable INVALID instruction (failed assert)."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["INVALID"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        inv_pc = np.asarray(ctx.sf.inv_pc)
        cids = np.asarray(ctx.sf.inv_cid)
        # INVALID halts exceptionally, so these lanes carry error=True
        for lane in ctx.lanes(include_errors=True):
            pc = int(inv_pc[lane])
            if pc < 0:
                continue
            cid = int(cids[lane])
            if self._seen(cid, pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Exception State",
                severity="Medium",
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "An assert violation (INVALID instruction) is reachable. "
                    "Assert conditions should only fail on internal bugs."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
