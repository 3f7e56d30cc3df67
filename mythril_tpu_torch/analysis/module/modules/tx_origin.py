"""TxOrigin (SWC-115): authorization through tx.origin.

Reference: ``mythril/analysis/module/modules/dependence_on_origin.py``
(⚠unv) — a control-flow decision depends on ORIGIN. Detected by scanning
each lane's path constraints for the ORIGIN leaf in their support.
"""

from __future__ import annotations

from typing import List

from ....symbolic.ops import FreeKind
from ....smt.tape import support
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class TxOrigin(DetectionModule):
    name = "TxOrigin"
    swc_id = "115"
    description = "Control flow depends on tx.origin."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        for lane in ctx.lanes():
            tape = ctx.tape(lane)
            asn = None  # one witness serves every constraint of the lane
            for j, (node, _) in enumerate(tape.constraints):
                _, kinds = support(tape, node)
                if int(FreeKind.ORIGIN) not in kinds:
                    continue
                pc = tape.pcs[j] if j < len(tape.pcs) else 0
                cid = ctx.contract_of(lane)
                if self._seen(cid, pc):
                    continue
                asn = asn if asn is not None else ctx.solve(lane)
                if asn is None:
                    self._cache.discard((cid, pc))
                    break
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title="Dependence on tx.origin",
                    severity="Low",
                    address=pc,
                    contract=ctx.contract_name(lane),
                    lane=int(lane),
                    description=(
                        "A branch condition depends on tx.origin. Using "
                        "tx.origin for authorization lets phishing contracts "
                        "act on behalf of the victim."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
