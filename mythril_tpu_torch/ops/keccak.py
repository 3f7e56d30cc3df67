"""Keccak-256 — host reference + batched PyTorch version and kernel K2.

- :func:`keccak256_host` — pure-Python implementation for host-side needs
  (selectors, code hashes, test oracle).
- :func:`keccak256_device` — keccak-256 of per-lane zero-padded bytes.
  A CUDA tensor goes to the hand-written kernel K2
  (``kernels/csrc/keccak256.cu``); a CPU tensor to the plain version,
  :func:`keccak256_plain`, built on :func:`keccak_f1600`.

Keccak (pre-NIST) padding: ``msg || 0x01 || 0* || 0x80``; rate 136 bytes.
64-bit lanes ride in int64 (PyTorch has no unsigned 64-bit arithmetic):
xor/and/not and left shifts act on the bit pattern, and every right
shift masks off the sign extension.
"""

from __future__ import annotations

import numpy as np
import torch

RATE_BYTES = 136  # 1088-bit rate for keccak-256
RATE_LANES = RATE_BYTES // 8

_RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
        0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
        0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
        0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
        0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)

# rotation offsets r[x][y] for lane A[x, y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Host reference (pure Python ints)
# ---------------------------------------------------------------------------


def _rotl_int(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def _f1600_host(lanes: list) -> list:
    # lanes: flat list of 25 ints, A[x, y] = lanes[5*y + x]
    a = [[lanes[5 * y + x] for y in range(5)] for x in range(5)]
    for rnd in range(24):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl_int(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl_int(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & _M64) & b[(x + 2) % 5][y])
        a[0][0] ^= int(_RC[rnd])
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak256_host(data: bytes) -> bytes:
    """Keccak-256 of concrete bytes (host path; test oracle)."""
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % RATE_BYTES:
        padded.append(0x00)
    padded[-1] |= 0x80
    lanes = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for i in range(RATE_LANES):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = _f1600_host(lanes)
    out = b"".join(int(lanes[i]).to_bytes(8, "little") for i in range(4))
    return out


def keccak256_host_int(data: bytes) -> int:
    return int.from_bytes(keccak256_host(data), "big")


# ---------------------------------------------------------------------------
# Batched PyTorch version (plain version of K2)
# ---------------------------------------------------------------------------

_RC_I64 = [int(np.int64(np.uint64(v).view(np.int64))) for v in _RC]


def _rotl(x, n: int):
    n %= 64
    if n == 0:
        return x
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f1600(state):
    """keccak-f[1600] permutation over ``int64[..., 25]`` (A[x,y] = [..., 5y+x])."""
    a = [[state[..., 5 * y + x] for y in range(5)] for x in range(5)]
    for rnd in range(24):
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        a = [[b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]) for y in range(5)]
             for x in range(5)]
        a[0][0] = a[0][0] ^ _RC_I64[rnd]
    return torch.stack([a[x][y] for y in range(5) for x in range(5)], dim=-1)


def keccak256_plain(data, length):
    """Plain version of K2. data ``u8[P, max_len]`` zero-padded message
    bytes, length ``i32[P]`` (<= max_len) -> ``int64[P, 8]`` little-endian
    u256 limbs of the big-endian hash value."""
    data = data.to(torch.int64)
    length = length.to(torch.int64)
    P, max_len = data.shape
    n_blocks = (max_len + 1 + RATE_BYTES - 1) // RATE_BYTES
    padded_len = n_blocks * RATE_BYTES
    pos = torch.arange(padded_len, device=data.device)[None, :]
    src = torch.nn.functional.pad(data, (0, padded_len - max_len))
    msg = torch.where(pos < length[:, None], src, 0)
    msg = torch.where(pos == length[:, None], 0x01, msg)
    final_block = length // RATE_BYTES
    last_byte_pos = (final_block + 1) * RATE_BYTES - 1
    msg = torch.where(pos == last_byte_pos[:, None], msg | 0x80, msg)
    shifts = torch.arange(8, device=data.device) * 8
    # byte 7 of a lane lands in the sign bit: the sum of disjoint shifted
    # bytes is the same bit pattern as their OR (int64 wraps)
    blocks = torch.sum(msg.reshape(P, n_blocks, RATE_LANES, 8) << shifts, dim=-1)
    state = torch.zeros(P, 25, dtype=torch.int64, device=data.device)
    for i in range(n_blocks):
        xored = torch.cat([state[:, :RATE_LANES] ^ blocks[:, i], state[:, RATE_LANES:]], dim=-1)
        nxt = keccak_f1600(xored)
        state = torch.where((i <= final_block)[:, None], nxt, state)
    byte_idx = torch.arange(32, device=data.device)
    hash_bytes = (state[:, byte_idx // 8] >> ((byte_idx % 8) * 8)) & 0xFF
    # limb i = hash bytes 28-4i .. 31-4i, the first one most significant
    k_base = 28 - 4 * torch.arange(8, device=data.device)
    gather = (k_base[:, None] + torch.arange(4, device=data.device)[None, :]).reshape(-1)
    b = hash_bytes[:, gather].reshape(P, 8, 4)
    weights = 1 << (8 * (3 - torch.arange(4, device=data.device)))
    return torch.sum(b * weights, dim=-1)


def keccak256_device(data, length):
    """Batched keccak-256: K2 on a CUDA tensor, the plain version on a CPU
    tensor. Same contract as the JAX package's ``keccak256_device``."""
    if data.is_cuda:
        from ..kernels import keccak256

        return keccak256(data.contiguous(), length.to(torch.int32).contiguous())
    return keccak256_plain(data, length)
