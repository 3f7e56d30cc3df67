"""Concrete ECRECOVER (precompile 0x1) on the host.

The reference recovers via libsecp256k1 (``coincurve``; SURVEY §2.2) —
unavailable here, so this is a self-contained affine-arithmetic
implementation of public-key recovery over secp256k1. It serves the
CONCRETE path only (witness replay through signature-gated code, and the
engine's concrete-input precompile dispatch via a host callback); the
symbolic case stays an uninterpreted ECRECOVER leaf, as in the reference.

Performance note: ~1 ms/recovery in pure Python. That is fine for its
role — signature checks are rare in fixtures and each concrete (hash, v,
r, s) tuple is memoized.
"""

from __future__ import annotations

import functools
from typing import Optional

from .keccak import keccak256_host

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (m * m - x1 - x2) % P
    return x3, (m * (x1 - x3) - y1) % P


def _mul(point, k: int):
    out = None
    while k:
        if k & 1:
            out = _add(out, point)
        point = _add(point, point)
        k >>= 1
    return out


@functools.lru_cache(maxsize=4096)
def ecrecover(msg_hash: int, v: int, r: int, s: int) -> Optional[int]:
    """Recovered 160-bit address, or None for an invalid signature
    (the precompile then returns empty output)."""
    if v not in (27, 28):
        return None
    if not (1 <= r < N and 1 <= s < N):
        return None
    # lift x = r onto the curve (the r + N branch needs x < P; r-values
    # that large do not occur for v in {27, 28})
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if (y * y) % P != y_sq:
        return None  # x not on the curve
    if y % 2 != (v - 27):
        y = P - y
    e = msg_hash % (1 << 256)
    r_inv = pow(r, -1, N)
    # Q = r^-1 * (s*R - e*G)
    q = _mul((x, y), (s * r_inv) % N)
    ge = _mul((GX, GY), (N - e % N) * r_inv % N)
    q = _add(q, ge)
    if q is None:
        return None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return int.from_bytes(keccak256_host(pub)[12:], "big")


def ecrecover_batch(inputs):
    """inputs: iterable of 128-byte precompile payloads
    (hash32 ++ v32 ++ r32 ++ s32). Returns a list of Optional[int]."""
    out = []
    for blob in inputs:
        b = bytes(blob).ljust(128, b"\x00")[:128]
        h = int.from_bytes(b[0:32], "big")
        v = int.from_bytes(b[32:64], "big")
        r = int.from_bytes(b[64:96], "big")
        s = int.from_bytes(b[96:128], "big")
        out.append(ecrecover(h, v, r, s))
    return out
