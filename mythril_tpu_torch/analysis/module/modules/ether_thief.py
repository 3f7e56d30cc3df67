"""EtherThief (SWC-105): unprotected ether withdrawal.

Reference: ``mythril/analysis/module/modules/ether_thief.py`` (⚠unv) —
an arbitrary sender can trigger a value transfer to an address they
control. Fires on recorded CALL/CALLCODE events whose target is
attacker-controlled and whose value can be nonzero.
"""

from __future__ import annotations

from typing import List

from ....symbolic.ops import SymOp
from ....smt.tape import HostNode, attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class EtherThief(DetectionModule):
    name = "EtherThief"
    swc_id = "105"
    description = "Arbitrary senders can withdraw ether from the contract."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "CALLCODE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        for lane in ctx.lanes():
            for ev in calls.lane(lane):
                if ev.op not in (0xF1, 0xF2):
                    continue
                cid = ev.cid
                if self._seen(cid, ev.pc):
                    continue
                tape = ctx.tape(lane)
                target_ok = (ev.to_sym and attacker_controlled(tape, ev.to_sym))
                if not target_ok:
                    self._cache.discard((cid, ev.pc))
                    continue
                if ev.value_sym:
                    # value must be able to exceed what the attacker paid in:
                    # nonzero is the v1 proxy (the reference compares against
                    # the attacker's net balance delta)
                    nz = HostNode(int(SymOp.ISZERO), ev.value_sym, 0, 0)
                    asn = ctx.solve(
                        lane,
                        extra_constraints=[(len(tape.nodes), False)],
                        extra_nodes=[nz],
                    )
                elif ev.value > 0:
                    asn = ctx.solve(lane)
                else:
                    self._cache.discard((cid, ev.pc))
                    continue
                if asn is None:
                    self._cache.discard((cid, ev.pc))
                    continue
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title="Unprotected Ether Withdrawal",
                    severity="High",
                    address=ev.pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=(
                        "Any sender can trigger a nonzero-value call to an "
                        "address they control."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
