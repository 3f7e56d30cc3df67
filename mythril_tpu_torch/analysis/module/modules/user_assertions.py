"""UserAssertions (SWC-110): reachable solidity Panic reverts.

Reference: ``mythril/analysis/module/modules/user_assertions.py`` (⚠unv)
— user-visible assertion failures. Solidity >=0.8 encodes them as
``Panic(uint256)`` revert payloads (selector 0x4e487b71); the engine
captured each lane's revert payload in ``retval``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module

PANIC_SELECTOR = bytes.fromhex("4e487b71")

PANIC_CODES = {
    0x01: "assert failure",
    0x11: "arithmetic overflow/underflow (checked arithmetic)",
    0x12: "division by zero",
    0x21: "invalid enum conversion",
    0x31: "pop on empty array",
    0x32: "array index out of bounds",
    0x41: "allocation too large",
}


@register_module
class UserAssertions(DetectionModule):
    name = "UserAssertions"
    swc_id = "110"
    description = "Reachable Panic(uint256) assertion reverts."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["REVERT"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        reverted = np.asarray(ctx.sf.base.reverted)
        retval = np.asarray(ctx.sf.base.retval)
        retval_len = np.asarray(ctx.sf.base.retval_len)
        pcs = np.asarray(ctx.sf.base.pc)
        for lane in ctx.lanes(include_reverted=True):
            if not bool(reverted[lane]) or int(retval_len[lane]) < 36:
                continue
            payload = bytes(retval[lane, : int(retval_len[lane])])
            if payload[:4] != PANIC_SELECTOR:
                continue
            code = int.from_bytes(payload[4:36], "big")
            pc = int(pcs[lane])
            cid = ctx.contract_of(lane)
            if self._seen(cid, pc):
                continue
            asn = ctx.solve(lane)
            if asn is None:
                self._cache.discard((cid, pc))
                continue
            issues.append(Issue(
                swc_id=self.swc_id,
                title="Reachable assertion (Panic)",
                severity="Medium",
                address=pc,
                contract=ctx.contract_name(lane),
                lane=int(lane),
                description=(
                    "A Panic revert is reachable: "
                    + PANIC_CODES.get(code, f"panic code {code:#x}") + "."
                ),
                transaction_sequence=ctx.tx_sequence(asn),
            ))
        return issues
