"""Batched host dispatch for the 'slow' concrete precompiles.

0x3 ripemd160 (hashlib), 0x6/0x7/0x8 alt_bn128 (ops/bn128), 0x9 blake2f
(ops/blake2). The symbolic engine reaches this through one masked
device->host->device round trip — only supersteps where some lane
concretely calls one of these pay it
(reference: every native is a host-side C call too,
``mythril/laser/ethereum/natives.py`` ⚠unv).

Contract per lane: returns (out_bytes[64], out_len, ok). ``ok=False``
means the PRECOMPILE CALL FAILS (the EVM pushes 0 and returndata is
empty) — distinct from ecrecover's "invalid signature" which succeeds
with empty output.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from . import bn128
from .blake2 import blake2f_precompile

# blake2f rounds fence: gas charges 1/round so real traffic is small;
# an attacker-size rounds word (2^32) would stall the host round trip for
# minutes. Above the cap the ENGINE routes the call to the sound havoc
# leaf instead of calling here (engine._apply_precompiles).
BLAKE2F_MAX_ROUNDS = 1 << 16


def _ripemd160(data: bytes) -> bytes:
    h = hashlib.new("ripemd160", data).digest()
    return b"\x00" * 12 + h  # left-padded to 32 bytes, as the precompile


def natives_batch(inp: np.ndarray, pid: np.ndarray, a_len: np.ndarray,
                  mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """inp u8[P, INW], pid i32[P], a_len i64[P], mask bool[P] ->
    (out u8[P, 64], out_len i32[P], ok bool[P])."""
    P_lanes = inp.shape[0]
    out = np.zeros((P_lanes, 64), dtype=np.uint8)
    out_len = np.zeros(P_lanes, dtype=np.int32)
    ok = np.zeros(P_lanes, dtype=bool)
    for i in np.where(mask)[0]:
        data = bytes(inp[i, : int(a_len[i])])
        p = int(pid[i])
        res = None
        if p == 3:
            res = _ripemd160(data)
        elif p == 6:
            res = bn128.ecadd(data)
        elif p == 7:
            res = bn128.ecmul(data)
        elif p == 8:
            res = bn128.ecpairing(data)
        elif p == 9:
            res = blake2f_precompile(data)
        if res is not None:
            out[i, : len(res)] = np.frombuffer(res, dtype=np.uint8)
            out_len[i] = len(res)
            ok[i] = True
    return out, out_len, ok
