"""SHA-256 of per-lane byte buffers (precompile 0x2), plus the host
reference via hashlib.

PyTorch counterpart of the JAX package's ``ops/sha256.py``.
:func:`sha256_device` sends a CUDA tensor to the hand-written kernel K4
(``kernels/csrc/sha256.cu``) and a CPU tensor to :func:`sha256_plain`,
which repeats the JAX function's arithmetic over int64 carriers (32-bit
words masked with ``& 0xFFFFFFFF``). :func:`sha256_lanes` hashes only the
lanes of a mask: K4 in place in the buffer on a CUDA tensor, the plain
version over those lanes' rows on a CPU tensor.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

M32 = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_plain(data: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """Plain version of K4. ``data`` u8[P, N] (bytes past ``ln`` ignored),
    ``ln`` i32[P] logical lengths (0 <= ln <= N) -> the digest as u256
    limbs int64[P, 8] (limb 0 = the last digest word)."""
    P, N = data.shape
    dev = data.device
    max_blocks = (N + 9 + 63) // 64
    M = max_blocks * 64
    ln = ln.to(torch.int64)

    # padded message: msg || 0x80 || 0* || bit length, big-endian, in the
    # last 8 bytes of the lane's own final block
    k = torch.arange(M, device=dev)[None, :]
    d = torch.nn.functional.pad(data.to(torch.int64), (0, M - N))
    msg = torch.where(k < ln[:, None], d, torch.where(k == ln[:, None], 0x80, 0))
    n_blocks = (ln + 9 + 63) // 64
    bitlen = ln * 8
    len_pos = k - (n_blocks * 64 - 8)[:, None]
    in_len = (len_pos >= 0) & (len_pos < 8)
    len_byte = (bitlen[:, None] >> ((7 - torch.clamp(len_pos, 0, 7)) * 8)) & 0xFF
    msg = torch.where(in_len, len_byte, msg)

    # bytes -> big-endian 32-bit words [P, M/4]
    w32 = (msg[:, 0::4] << 24) | (msg[:, 1::4] << 16) | (msg[:, 2::4] << 8) | msg[:, 3::4]
    K = [int(x) for x in _K]
    state = torch.as_tensor(_H0.astype(np.int64), device=dev).expand(P, 8).clone()
    for blk in range(max_blocks):
        w = [w32[:, blk * 16 + t] for t in range(16)]
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
        a, b, c, dd, e, f, g, h = (state[:, i] for i in range(8))
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ M32) & g)
            t1 = h + S1 + ch + K[t] + w[t]
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            mj = (a & b) ^ (a & c) ^ (b & c)
            a, b, c, dd, e, f, g, h = ((t1 + S0 + mj) & M32, a, b, c,
                                       (dd + t1) & M32, e, f, g)
        new = (state + torch.stack([a, b, c, dd, e, f, g, h], dim=1)) & M32
        # blocks past the lane's message leave the state untouched
        state = torch.where((blk < n_blocks)[:, None], new, state)
    # big-endian digest words -> u256 limbs (limb 0 = last digest word)
    return state.flip(1).contiguous()


def sha256_device(data: torch.Tensor, ln: torch.Tensor) -> torch.Tensor:
    """SHA-256 of per-lane byte buffers: K4 on a CUDA tensor, the plain
    version on a CPU tensor. Same contract as the JAX package's
    ``sha256_device``."""
    if data.is_cuda:
        from ..kernels import sha256

        return sha256(data.to(torch.uint8).contiguous(), ln.to(torch.int32).contiguous())
    return sha256_plain(data, ln)


def sha256_lanes(data: torch.Tensor, ln: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`sha256_device` on the lanes of ``mask`` (bool[P]), zeros
    elsewhere. On a CUDA tensor one K4 launch reads the selected rows where
    they lie and writes every row of the result, so that a few lanes of a
    wide buffer cost no index, gather or scatter."""
    if data.is_cuda:
        from ..kernels import sha256

        return sha256(data.to(torch.uint8).contiguous(), ln.to(torch.int32).contiguous(),
                      mask.to(torch.bool).contiguous())
    idx = torch.nonzero(mask)[:, 0]
    out = torch.zeros((data.shape[0], 8), dtype=torch.int64, device=data.device)
    out[idx] = sha256_plain(data[idx], ln[idx])
    return out


def sha256_host(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
