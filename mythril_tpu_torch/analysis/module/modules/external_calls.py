"""ExternalCalls (SWC-107): call to a user-supplied address.

Reference: ``mythril/analysis/module/modules/external_calls.py`` (⚠unv)
— any CALL-family target taken from attacker input deserves review (gas
forwarding, reentrancy surface), independent of value transfer.
"""

from __future__ import annotations

from typing import List

from ....smt.tape import attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class ExternalCalls(DetectionModule):
    name = "ExternalCalls"
    swc_id = "107"
    description = "External call to a user-supplied address."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            for ev in calls.lane(lane):
                if ev.op not in (0xF1, 0xF2, 0xF4, 0xFA):
                    continue
                cid = ev.cid
                if self._seen(cid, ev.pc):
                    continue
                tape = ctx.tape(lane)
                if not (ev.to_sym and attacker_controlled(tape, ev.to_sym)):
                    self._cache.discard((cid, ev.pc))
                    continue
                asn = ctx.solve(lane)
                if asn is None:
                    self._cache.discard((cid, ev.pc))
                    continue
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title="External call to user-supplied address",
                    severity="Medium",
                    address=ev.pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=(
                        "An external message call targets an address taken "
                        "from transaction input; the callee is untrusted."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
