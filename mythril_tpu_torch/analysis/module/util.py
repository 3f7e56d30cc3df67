"""Shared scan helpers for detection modules (reference:
``mythril/analysis/module/util.py`` ⚠unv holds the analogous
issue-plumbing helpers)."""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from ...ops import u256


class CallEvent:
    __slots__ = ("idx", "op", "pc", "cid", "to_sym", "to", "value_sym", "value")

    def __init__(self, idx, op, pc, cid, to_sym, to, value_sym, value):
        self.idx, self.op, self.pc, self.cid = idx, op, pc, cid
        self.to_sym, self.to = to_sym, to
        self.value_sym, self.value = value_sym, value


class CallLog:
    """Host copy of the per-lane external-call records."""

    def __init__(self, sf):
        self.n = np.asarray(sf.n_calls)
        self.op = np.asarray(sf.call_op)
        self.pc = np.asarray(sf.call_pc)
        self.cid = np.asarray(sf.call_cid)
        self.to_sym = np.asarray(sf.call_to_sym)
        self.to = np.asarray(sf.call_to)
        self.value_sym = np.asarray(sf.call_value_sym)
        self.value = np.asarray(sf.call_value)

    def lane(self, lane: int) -> Iterator[CallEvent]:
        for j in range(min(int(self.n[lane]), self.op.shape[1])):
            yield CallEvent(
                idx=j,
                op=int(self.op[lane, j]),
                pc=int(self.pc[lane, j]),
                cid=int(self.cid[lane, j]),
                to_sym=int(self.to_sym[lane, j]),
                to=u256.to_int(self.to[lane, j]),
                value_sym=int(self.value_sym[lane, j]),
                value=u256.to_int(self.value[lane, j]),
            )
