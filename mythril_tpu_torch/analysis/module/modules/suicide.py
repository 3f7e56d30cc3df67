"""AccidentallyKillable (SWC-106): unprotected SELFDESTRUCT.

Reference: ``mythril/analysis/module/modules/suicide.py`` (⚠unv) — an
attacker transaction reaching SELFDESTRUCT. The engine flags the lane in
``base.selfdestructed`` and records the beneficiary operand.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....smt.tape import attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class AccidentallyKillable(DetectionModule):
    name = "AccidentallyKillable"
    swc_id = "106"
    description = "Anyone can kill this contract via SELFDESTRUCT."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SELFDESTRUCT"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        sd = np.asarray(ctx.sf.base.selfdestructed)
        sd_sym = np.asarray(ctx.sf.sd_to_sym)
        pcs = np.asarray(ctx.sf.sd_pc)  # recorded SELFDESTRUCT pc, not live pc
        cids = np.asarray(ctx.sf.sd_cid)  # contract whose code executed it
        for lane in ctx.lanes():
            if not bool(sd[lane]) or int(pcs[lane]) < 0:
                continue
            cid = int(cids[lane])
            pc = int(pcs[lane])
            if self._seen(cid, pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            tape = ctx.tape(lane)
            ben = int(sd_sym[lane])
            extra = ""
            if ben and attacker_controlled(tape, ben):
                extra = " The beneficiary address is attacker-controlled."
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Unprotected SELFDESTRUCT",
                severity="High",
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "An arbitrary caller can reach SELFDESTRUCT and kill "
                    "this contract." + extra
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
