"""MultipleSends (SWC-113): multiple external calls in one transaction.

Reference: ``mythril/analysis/module/modules/multiple_sends.py`` (⚠unv)
— DoS risk: if the first call fails/consumes gas, later sends are lost.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class MultipleSends(DetectionModule):
    name = "MultipleSends"
    swc_id = "113"
    description = "Multiple external calls in the same transaction."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            evs = [e for e in calls.lane(lane) if e.op in (0xF1, 0xF2, 0xF4, 0xFA)]
            if len(evs) < 2:
                continue
            second = evs[1]
            cid = second.cid
            if self._seen(cid, second.pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, second.pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Multiple Calls in a Single Transaction",
                severity="Low",
                address=second.pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "This path performs multiple external calls; a failure "
                    "in an earlier call can block the later ones (DoS)."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
