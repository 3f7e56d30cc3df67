"""BLAKE2b compression function F (EIP-152 precompile 0x09), pure Python.

The reference computes this native via the blake2b-py Rust crate
(``mythril/laser/ethereum/natives.py`` ⚠unv, SURVEY.md §2.2); Rust is not
available in this image, and the precompile is a rare concrete-input host
path, so a direct RFC-7693 implementation is the right shape. Validated
against ``hashlib.blake2b`` by running the full hash through this F
(tests/test_precompiles.py).
"""

from __future__ import annotations

from typing import List, Optional

MASK64 = (1 << 64) - 1

IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def blake2b_f(rounds: int, h: List[int], m: List[int], t: List[int],
              final: bool) -> List[int]:
    """One F compression: h[8], m[16], t[2] are u64 words; returns h'[8]."""
    v = list(h) + list(IV)
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= MASK64

    for r in range(rounds):
        s = SIGMA[r % 10]

        def g(a, b, c, d, x, y):
            v[a] = (v[a] + v[b] + x) & MASK64
            v[d] = _rotr(v[d] ^ v[a], 32)
            v[c] = (v[c] + v[d]) & MASK64
            v[b] = _rotr(v[b] ^ v[c], 24)
            v[a] = (v[a] + v[b] + y) & MASK64
            v[d] = _rotr(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & MASK64
            v[b] = _rotr(v[b] ^ v[c], 63)

        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2f_precompile(data: bytes) -> Optional[bytes]:
    """EIP-152 byte-level semantics: 213-byte input
    rounds(4 BE) || h(64 LE) || m(128 LE) || t(16 LE) || final(1);
    returns 64 bytes, or None = precompile failure (bad length / flag)."""
    if len(data) != 213:
        return None
    final = data[212]
    if final not in (0, 1):
        return None
    rounds = int.from_bytes(data[0:4], "big")
    h = [int.from_bytes(data[4 + 8 * i:12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(data[68 + 8 * i:76 + 8 * i], "little") for i in range(16)]
    t = [int.from_bytes(data[196 + 8 * i:204 + 8 * i], "little") for i in range(2)]
    out = blake2b_f(rounds, h, m, t, final == 1)
    return b"".join(x.to_bytes(8, "little") for x in out)


def blake2b_hash(data: bytes, digest_size: int = 64) -> bytes:
    """Full BLAKE2b built on :func:`blake2b_f` — the test oracle path
    (compared against ``hashlib.blake2b``), not used by the precompile."""
    h = list(IV)
    h[0] ^= 0x01010000 ^ digest_size  # param block: digest len, fanout=depth=1
    blocks = [data[i:i + 128] for i in range(0, len(data), 128)] or [b""]
    t = 0
    for blk in blocks[:-1]:
        t += 128
        m = [int.from_bytes(blk[8 * i:8 * i + 8], "little") for i in range(16)]
        h = blake2b_f(12, h, m, [t & MASK64, t >> 64], False)
    last = blocks[-1]
    t += len(last)
    last = last.ljust(128, b"\x00")
    m = [int.from_bytes(last[8 * i:8 * i + 8], "little") for i in range(16)]
    h = blake2b_f(12, h, m, [t & MASK64, t >> 64], True)
    return b"".join(x.to_bytes(8, "little") for x in h)[:digest_size]
