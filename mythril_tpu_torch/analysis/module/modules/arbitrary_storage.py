"""ArbitraryStorage (SWC-124): write to attacker-controlled slot.

Reference: ``mythril/analysis/module/modules/arbitrary_write.py`` (⚠unv)
— SSTORE whose key the attacker chooses freely. Keys derived through
KECCAK are solidity mapping/array accesses and are excluded (choosing
the hash preimage does not give slot control).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....smt.tape import attacker_controlled, keccak_derived
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class ArbitraryStorage(DetectionModule):
    name = "ArbitraryStorage"
    swc_id = "124"
    description = "A caller can write to arbitrary storage slots."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        key_node = np.asarray(ctx.sf.arb_key_node)
        key_pc = np.asarray(ctx.sf.arb_key_pc)
        cids = np.asarray(ctx.sf.arb_key_cid)
        for lane in ctx.lanes():
            pc = int(key_pc[lane])
            node = int(key_node[lane])
            if pc < 0 or node == 0:
                continue
            cid = int(cids[lane])
            if self._seen(cid, pc):
                continue
            tape = ctx.tape(lane)
            if keccak_derived(tape, node) or not attacker_controlled(tape, node):
                self._cache.discard((cid, pc))
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Write to an arbitrary storage location",
                severity="High",
                address=pc,
                contract=ctx.cid_name(cid),
                lane=int(lane),
                description=(
                    "The SSTORE key is attacker-controlled without hashing; "
                    "any storage slot (owner, balances) can be overwritten."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
