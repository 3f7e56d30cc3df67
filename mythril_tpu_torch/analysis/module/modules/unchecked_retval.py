"""UncheckedRetval (SWC-104): call return value never checked.

Reference: ``mythril/analysis/module/modules/unchecked_retval.py``
(⚠unv) — after a CALL, the return value must influence a later branch.
Here: the engine pushed a RETVAL leaf per call; if no path constraint of
the final lane depends on that leaf, the code never branched on it.
"""

from __future__ import annotations

from typing import List

from ....symbolic.ops import FreeKind, SymOp
from ....smt.tape import constraint_support
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class UncheckedRetval(DetectionModule):
    name = "UncheckedRetval"
    swc_id = "104"
    description = "The return value of an external call is not checked."
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            tape = ctx.tape(lane)
            checked_ids, _ = constraint_support(tape)
            # RETVAL leaves present on the tape, by call index
            retval_by_idx = {
                nd.b: i for i, nd in enumerate(tape.nodes)
                if nd.op == int(SymOp.FREE) and nd.a == int(FreeKind.RETVAL)
            }
            for ev in calls.lane(lane):
                if ev.op in (0xF0, 0xF5):  # CREATE handled elsewhere
                    continue
                leaf = retval_by_idx.get(ev.idx)
                if leaf is None or leaf in checked_ids:
                    continue
                cid = ev.cid
                if self._seen(cid, ev.pc):
                    continue
                asn = ctx.solve(lane)
                if asn is None:
                    self._cache.discard((cid, ev.pc))
                    continue
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title="Unchecked return value from external call",
                    severity="Medium",
                    address=ev.pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=(
                        "The success flag of an external call is ignored; a "
                        "failing call goes unnoticed."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
