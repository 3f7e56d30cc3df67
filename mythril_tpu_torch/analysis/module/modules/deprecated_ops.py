"""DeprecatedOperations (SWC-111): ORIGIN / CALLCODE usage.

Reference: ``mythril/analysis/module/modules/deprecated_ops.py`` (⚠unv)
fires when execution reaches a deprecated opcode. Detection here is
evidence-based: an ORIGIN leaf on a lane's tape means ORIGIN executed;
a CALLCODE call-log entry means CALLCODE executed.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module
from ..util import CallLog


@register_module
class DeprecatedOperations(DetectionModule):
    name = "DeprecatedOperations"
    swc_id = "111"
    description = "Use of deprecated opcodes (ORIGIN, CALLCODE)."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["ORIGIN", "CALLCODE"]

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        calls = CallLog(ctx.sf)
        origin_read = np.asarray(ctx.sf.origin_read)
        for lane in ctx.lanes():
            used_origin = bool(origin_read[lane])
            findings = []
            if used_origin:
                findings.append(("ORIGIN", "tx.origin is deprecated for "
                                 "authorization (see also SWC-115)", 0,
                                 ctx.contract_of(lane)))
            for ev in calls.lane(lane):
                if ev.op == 0xF2:
                    findings.append(("CALLCODE", "callcode is deprecated; "
                                     "use delegatecall", ev.pc, ev.cid))
            for opname, why, pc, cid in findings:
                if self._seen(cid, (opname, pc)):
                    continue
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title=f"Use of {opname}",
                    severity="Low",
                    address=pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=f"Deprecated operation {opname}: {why}.",
                ))
        return issues
