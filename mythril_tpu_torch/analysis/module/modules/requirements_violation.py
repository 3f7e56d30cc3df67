"""RequirementsViolation (SWC-123): a call into another contract violates
that callee's requirements (revert in a sub-frame).

Reference: ``mythril/analysis/module/modules/requirements_violation.py``
(⚠unv). The sub-transaction layer records the pc of the first CALL whose
callee frame reverted/failed in ``sub_revert_pc``
(``symbolic/engine.py:pop_frames``); a lane carrying that event witnessed
a violated callee requirement reachable from attacker inputs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module

ERROR_SELECTOR = bytes.fromhex("08c379a0")


@register_module
class RequirementsViolation(DetectionModule):
    name = "RequirementsViolation"
    swc_id = "123"
    description = "A requirement of a called contract is violated."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["REVERT"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        sub_pc = np.asarray(ctx.sf.sub_revert_pc)
        cids = np.asarray(ctx.sf.sub_revert_cid)
        for lane in ctx.lanes(include_reverted=True):
            pc = int(sub_pc[lane])
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
                title="Requirement violation in a called contract",
                severity="Medium",
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "A require() of a called contract can be violated by "
                    "this caller's inputs."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
