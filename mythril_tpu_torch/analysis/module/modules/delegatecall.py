"""DelegateCallToUntrustedContract (SWC-112).

Reference: ``mythril/analysis/module/modules/delegatecall.py`` (⚠unv) —
DELEGATECALL executes foreign code with this contract's storage; a
caller-controlled target is full takeover.
"""

from __future__ import annotations

from typing import List

from ....smt.tape import attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class DelegateCallToUntrustedContract(DetectionModule):
    name = "DelegateCallToUntrustedContract"
    swc_id = "112"
    description = "DELEGATECALL to an attacker-controlled address."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            for ev in calls.lane(lane):
                if ev.op != 0xF4:
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
                    title="Delegatecall to user-supplied address",
                    severity="High",
                    address=ev.pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=(
                        "DELEGATECALL targets an address taken from "
                        "attacker-controlled input; the callee runs with "
                        "this contract's storage and balance."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
