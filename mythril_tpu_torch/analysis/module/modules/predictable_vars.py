"""PredictableVariables (SWC-116 / SWC-120): block values gate
value-bearing behavior.

Reference: ``mythril/analysis/module/modules/dependence_on_predictable_vars.py``
(⚠unv) — branch conditions depending on timestamp/number/blockhash/
prevrandao before an ether transfer; miners (and anyone, for timestamp
granularity) can bias them.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....symbolic.ops import FreeKind
from ....smt.tape import support
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog

_PREDICTABLE = {
    int(FreeKind.TIMESTAMP): ("block.timestamp", "116"),
    int(FreeKind.NUMBER): ("block.number", "116"),
    int(FreeKind.PREVRANDAO): ("block.prevrandao", "120"),
    int(FreeKind.BLOCKHASH): ("blockhash", "120"),
}


@register_module
class PredictableVariables(DetectionModule):
    name = "PredictableVariables"
    swc_id = "116"
    description = "Control flow depends on predictable block values."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        sd = np.asarray(ctx.sf.base.selfdestructed)
        for lane in ctx.lanes():
            # only paths that move value (call with possible value or
            # selfdestruct) — pure reads of block vars are not findings
            transfers = bool(sd[lane]) or any(
                (e.value_sym or e.value > 0) for e in calls.lane(lane)
            )
            if not transfers:
                continue
            tape = ctx.tape(lane)
            asn = None  # one witness serves every constraint of the lane
            for j, (node, _) in enumerate(tape.constraints):
                _, kinds = support(tape, node)
                hits = kinds & set(_PREDICTABLE)
                if not hits:
                    continue
                pc = tape.pcs[j] if j < len(tape.pcs) else 0
                cid = ctx.contract_of(lane)
                if self._seen(cid, pc):
                    continue
                asn = asn if asn is not None else ctx.solve(lane)
                if asn is None:
                    self._cache.discard((cid, pc))
                    break
                names = ", ".join(_PREDICTABLE[k][0] for k in sorted(hits))
                swc = _PREDICTABLE[min(hits)][1]
                issues.append(Issue(
                    swc_id=swc,
                    title="Dependence on predictable environment variable",
                    severity="Low",
                    address=pc,
                    contract=ctx.contract_name(lane),
                    lane=int(lane),
                    description=(
                        f"A value transfer is gated on {names}, which is "
                        "predictable or miner-influenceable."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
