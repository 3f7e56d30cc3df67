"""StateChangeAfterCall (SWC-107 reentrancy pattern).

Reference: ``mythril/analysis/module/modules/state_change_external_calls.py``
(⚠unv) — storage written after an external call: the callee can re-enter
before the state update lands. The engine recorded the first such SSTORE
per lane (``sstore_after_call_pc``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....smt.tape import attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class StateChangeAfterCall(DetectionModule):
    name = "StateChangeAfterCall"
    swc_id = "107"
    description = "Storage is modified after an external call (reentrancy)."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        pc_arr = np.asarray(ctx.sf.sstore_after_call_pc)
        cids = np.asarray(ctx.sf.sstore_ac_cid)
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            pc = int(pc_arr[lane])
            if pc < 0:
                continue
            # the engine records this pc only when a re-enterable call
            # (CALL/CALLCODE/DELEGATECALL) preceded the store
            evs = list(calls.lane(lane))
            cid = int(cids[lane])
            if self._seen(cid, pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            tape = ctx.tape(lane)
            controlled = any(
                e.to_sym and attacker_controlled(tape, e.to_sym) for e in evs
            )
            sev = "Medium" if controlled else "Low"
            issues.append(Issue(
                swc_id=self.swc_id,
                title="State change after external call",
                severity=sev,
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "Storage is written after an external call; the callee "
                    "can re-enter and observe or race the stale state."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
