"""ArbitraryJump (SWC-127): jump target controllable by the caller.

Reference: ``mythril/analysis/module/modules/arbitrary_jump.py`` (⚠unv)
fires on JUMP/JUMPI with a symbolic destination. The engine recorded the
destination node in ``sym_jump_dest`` when a (possibly) taken jump had a
symbolic target (engine._h_sym_jump).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....smt.tape import attacker_controlled
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class ArbitraryJump(DetectionModule):
    name = "ArbitraryJump"
    swc_id = "127"
    description = "Caller can redirect execution to arbitrary bytecode locations."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        dest = np.asarray(ctx.sf.sym_jump_dest)
        pcs = np.asarray(ctx.sf.sym_jump_pc)
        cids = np.asarray(ctx.sf.sym_jump_cid)
        for lane in ctx.lanes():
            node = int(dest[lane])
            pc = int(pcs[lane])
            if node == 0 or pc < 0:
                continue
            cid = int(cids[lane])
            if self._seen(cid, pc):
                continue
            tape = ctx.tape(lane)
            if not attacker_controlled(tape, node):
                # _seen inserted the key; release it so a later lane with an
                # attacker-controlled destination at the same (cid, pc) is
                # not suppressed
                self._cache.discard((cid, pc))
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Jump to an arbitrary instruction",
                severity="High",
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "The jump destination is taken from attacker-controlled "
                    "input. Execution can be redirected to any JUMPDEST in "
                    "the contract."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
