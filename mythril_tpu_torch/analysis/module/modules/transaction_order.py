"""TransactionOrderDependence (SWC-114): value transfer gated on storage
another transaction can change first.

Reference: ``mythril/analysis/module/modules/transaction_order_dependence.py``
existed upstream (later folded into EtherThief variants ⚠unv): if the
amount/recipient/guard of an ether transfer depends on storage that any
earlier-in-block transaction can rewrite, the path is front-runnable.
Heuristic here: a lane that (a) performs a possible-value call and (b)
whose path condition depends on an initial-STORAGE leaf.
"""

from __future__ import annotations

from typing import List

from ....symbolic.ops import FreeKind
from ....smt.tape import constraint_support
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class TransactionOrderDependence(DetectionModule):
    name = "TransactionOrderDependence"
    swc_id = "114"
    description = "Ether transfer gated on front-runnable storage state."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            transfer = [e for e in calls.lane(lane)
                        if e.op in (0xF1, 0xF2) and (e.value_sym or e.value > 0)]
            if not transfer:
                continue
            tape = ctx.tape(lane)
            _, kinds = constraint_support(tape)
            if int(FreeKind.STORAGE) not in kinds:
                continue
            ev = transfer[0]
            cid = ev.cid
            if self._seen(cid, ev.pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, ev.pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Transaction order dependence",
                severity="Medium",
                address=ev.pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "A value transfer is guarded by storage state that a "
                    "front-running transaction can change first."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
