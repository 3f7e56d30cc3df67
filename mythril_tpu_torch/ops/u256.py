"""256-bit word arithmetic as 8 x 32-bit limb vectors (little-endian limbs).

PyTorch counterpart of the JAX package's ``ops/u256.py``. Every EVM word
is a ``[..., 8]`` tensor, limb 0 the least significant 32 bits.

Carrier dtype: PyTorch's ``uint32`` has no add, shift, compare, ``where``
or ``gather`` on the CPU, so limbs ride in **int64** holding 0..2^32-1.
Every operation that can leave that range (add carries, borrows, products,
``~``) masks back with ``& 0xFFFFFFFF``; products are formed from 16-bit
halves so no intermediate exceeds 2^63. ``to_numpy`` seams convert to
``uint32`` (see ``core/frontier.py``).

Conventions (EVM): DIV/MOD by zero -> 0; SDIV overflow (-2^255 / -1)
-> -2^255; shifts with amount >= 256 -> 0 (SAR -> sign fill).

Every function here computes in plain PyTorch on any device, except
``modexp``, which goes to kernel K5 (``kernels/csrc/u256_modexp.cu``) on a
CUDA tensor and to ``modexp_plain`` on a CPU tensor. ``divmod_u`` (K1,
``kernels/csrc/u256_divmod.cu``), ``mul`` and ``mul_wide`` (K8,
``u256_mul.cu``), ``_mod_wide`` and ``exp`` (K9, ``u256_mulmod_exp.cu``)
are those kernels' plain versions: on the card the concrete step runs the
same arithmetic inside K10 (``evm_step.cu``), and these stay the
independent reference it is held to.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 8
LIMB_BITS = 32
WORD_BITS = 256
MASK32 = 0xFFFFFFFF
CARRIER = torch.int64

# ---------------------------------------------------------------------------
# Host-side conversions (numpy)
# ---------------------------------------------------------------------------


def from_int(x: int) -> np.ndarray:
    """Python int (mod 2^256) -> u32[8] limbs, little-endian."""
    x &= (1 << 256) - 1
    return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(NLIMBS)], dtype=np.uint32)


def from_ints(xs) -> np.ndarray:
    return np.stack([from_int(int(x)) for x in xs], axis=0)


def to_int(limbs) -> int:
    """u32[8] limbs -> Python int."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs, dtype=np.uint64)
    out = 0
    for i in range(NLIMBS):
        out |= int(limbs[..., i]) << (32 * i)
    return out


def to_ints(arr) -> list:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    flat = arr.reshape(-1, NLIMBS)
    return [to_int(row) for row in flat]


def from_bytes(b: bytes) -> np.ndarray:
    """Big-endian byte string (<=32 bytes) -> u32[8]."""
    return from_int(int.from_bytes(b, "big"))


def to_bytes(limbs) -> bytes:
    return to_int(limbs).to_bytes(32, "big")


def word(value: int, device=None) -> torch.Tensor:
    """A constant word as an int64 carrier tensor [8]."""
    return torch.as_tensor(from_int(value).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def from_u64_scalar(x: torch.Tensor) -> torch.Tensor:
    """Non-negative int64 scalar per lane -> u256 limbs."""
    x = x.to(torch.int64)
    lo = x & MASK32
    hi = (x >> 32) & MASK32
    rest = torch.zeros(x.shape + (NLIMBS - 2,), dtype=CARRIER, device=x.device)
    return torch.cat([lo[..., None], hi[..., None], rest], dim=-1)


def to_u64_saturating(a: torch.Tensor) -> torch.Tensor:
    """Low 64 bits, saturating to 2^64-1 if any higher limb is set,
    returned as the int64 with the same bit pattern (the JAX code casts
    this u64 to i64 at every use, so 2^64-1 reads as -1 there too)."""
    hi = a[..., 1]
    hi = torch.where(hi >= (1 << 31), hi - (1 << 32), hi)
    lo = hi * (1 << 32) + a[..., 0]
    overflow = torch.any(a[..., 2:] != 0, dim=-1)
    return torch.where(overflow, torch.full_like(lo, -1), lo)


def to_u32_saturating(a: torch.Tensor) -> torch.Tensor:
    """Low 32 bits, saturating if any higher limb set (for pc/offsets)."""
    overflow = torch.any(a[..., 1:] != 0, dim=-1)
    return torch.where(overflow, torch.full_like(a[..., 0], MASK32), a[..., 0])


# ---------------------------------------------------------------------------
# Bitwise
# ---------------------------------------------------------------------------


def bit_and(a, b):
    return a & b


def bit_or(a, b):
    return a | b


def bit_xor(a, b):
    return a ^ b


def bit_not(a):
    return a ^ MASK32


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


def is_zero(a) -> torch.Tensor:
    return torch.all(a == 0, dim=-1)


def eq(a, b) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def msb(a) -> torch.Tensor:
    """Sign bit (bit 255) as bool."""
    return (a[..., NLIMBS - 1] >> 31) != 0


is_neg = msb


def lt(a, b) -> torch.Tensor:
    """Unsigned a < b: decided by the most significant differing limb."""
    a, b = torch.broadcast_tensors(a, b)
    neq = a != b
    a_lt = a < b
    decided = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    result = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(NLIMBS - 1, -1, -1):
        take = (~decided) & neq[..., i]
        result = torch.where(take, a_lt[..., i], result)
        decided = decided | neq[..., i]
    return result


def gt(a, b):
    return lt(b, a)


def gte(a, b):
    return ~lt(a, b)


def lte(a, b):
    return ~lt(b, a)


def slt(a, b):
    """Signed a < b (two's complement)."""
    sa, sb = msb(a), msb(b)
    return torch.where(sa != sb, sa, lt(a, b))


def sgt(a, b):
    return slt(b, a)


def bool_to_word(p) -> torch.Tensor:
    """bool[...] -> u256 0/1."""
    out = torch.zeros(p.shape + (NLIMBS,), dtype=CARRIER, device=p.device)
    out[..., 0] = p.to(CARRIER)
    return out


# ---------------------------------------------------------------------------
# Add / Sub / Neg
# ---------------------------------------------------------------------------


def add(a, b):
    return add_carry(a, b)[0]


def add_carry(a, b):
    """(a + b mod 2^256, carry_out bool)."""
    a, b = torch.broadcast_tensors(a, b)
    out = []
    c = torch.zeros(a.shape[:-1], dtype=CARRIER, device=a.device)
    for i in range(NLIMBS):
        s = a[..., i] + b[..., i] + c
        out.append(s & MASK32)
        c = s >> 32
    return torch.stack(out, dim=-1), c != 0


def sub(a, b):
    return sub_borrow(a, b)[0]


def sub_borrow(a, b):
    """(a - b mod 2^256, borrow_out bool). borrow_out == (a < b)."""
    a, b = torch.broadcast_tensors(a, b)
    out = []
    borrow = torch.zeros(a.shape[:-1], dtype=CARRIER, device=a.device)
    for i in range(NLIMBS):
        d = a[..., i] - b[..., i] - borrow
        out.append(d & MASK32)
        borrow = (d < 0).to(CARRIER)
    return torch.stack(out, dim=-1), borrow != 0


def neg(a):
    """Two's complement negation."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return add(bit_not(a), one)


def abs_signed(a):
    """(|a| as unsigned, was_negative)."""
    n = msb(a)
    return torch.where(n[..., None], neg(a), a), n


# ---------------------------------------------------------------------------
# Mul (schoolbook over 16-bit halves: every partial product < 2^32, every
# column sum < 2^37, so int64 never overflows)
# ---------------------------------------------------------------------------


def _halves(a):
    return torch.stack([a & 0xFFFF, a >> 16], dim=-1).reshape(a.shape[:-1] + (2 * NLIMBS,))


def _product_halves(a, b, n_out: int):
    a16, b16 = _halves(a), _halves(b)
    cols = torch.zeros(a.shape[:-1] + (n_out + 16,), dtype=CARRIER, device=a.device)
    for i in range(16):
        if i >= n_out:
            break
        cols[..., i:i + 16] += a16[..., i:i + 1] * b16
    out = []
    carry = torch.zeros(a.shape[:-1], dtype=CARRIER, device=a.device)
    for k in range(n_out):
        t = cols[..., k] + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    h = torch.stack(out, dim=-1)
    return h[..., 0::2] | (h[..., 1::2] << 16)


def mul(a, b):
    """Low 256 bits of a*b (plain version of K8's low product)."""
    a, b = torch.broadcast_tensors(a, b)
    return _product_halves(a, b, 16)


def mul_wide(a, b):
    """Full 512-bit product as [..., 16] limbs (plain version of K8's
    wide product)."""
    a, b = torch.broadcast_tensors(a, b)
    return _product_halves(a, b, 32)


# ---------------------------------------------------------------------------
# Division (K1) and modulo
# ---------------------------------------------------------------------------


def _shift_in(r, bit):
    """(r << 1 | bit) mod 2^256, and the bit shifted out of 2^256."""
    overflow = (r[..., NLIMBS - 1] >> 31) != 0
    hi_bits = r >> 31
    r2 = (r << 1) & MASK32
    r2 = torch.cat([r2[..., :1] | bit[..., None], r2[..., 1:] | hi_bits[..., :-1]], dim=-1)
    return r2, overflow


def divmod_u(a, b):
    """Unsigned (a // b, a % b), division by zero -> (0, 0) per EVM; the
    plain version of K1: 256-step shift-subtract long division. The shifted-out bit is tracked: when set,
    the true remainder exceeds 2^256 > b, so the subtraction must occur."""
    a, b = torch.broadcast_tensors(a, b)
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    for k in range(256):
        i = 255 - k
        limb, shift = i // LIMB_BITS, i % LIMB_BITS
        bit = (a[..., limb] >> shift) & 1
        r2, overflow = _shift_in(r, bit)
        ge = gte(r2, b) | overflow
        r = torch.where(ge[..., None], sub(r2, b), r2)
        q[..., limb] |= ge.to(CARRIER) << shift
    bz = is_zero(b)[..., None]
    return torch.where(bz, 0, q), torch.where(bz, 0, r)


def div(a, b):
    return divmod_u(a, b)[0]


def mod(a, b):
    return divmod_u(a, b)[1]


def sdiv(a, b):
    aa, na = abs_signed(a)
    ab, nb = abs_signed(b)
    q = div(aa, ab)
    flip = na != nb
    q = torch.where(flip[..., None], neg(q), q)
    # EVM: -2^255 / -1 wraps to -2^255 — this falls out of two's complement
    return torch.where(is_zero(b)[..., None], 0, q)


def smod(a, b):
    aa, na = abs_signed(a)
    ab, _ = abs_signed(b)
    r = mod(aa, ab)
    r = torch.where(na[..., None], neg(r), r)
    return torch.where(is_zero(b)[..., None], 0, r)


def _top_bit(x) -> int:
    """Highest set bit over every lane of limb vectors ``x[..., n]``, -1
    when all are zero (one host read)."""
    nz = torch.nonzero(torch.any(x.reshape(-1, x.shape[-1]) != 0, dim=0))
    if nz.numel() == 0:
        return -1
    limb = int(nz.max())
    return LIMB_BITS * limb + int(torch.max(x[..., limb])).bit_length() - 1


def _mod_wide(wide, m):
    """([..., n] limb value) mod (u256 m); m==0 -> 0. Bitwise long
    division; the plain version of K9's ``mod_wide``."""
    r = torch.zeros(wide.shape[:-1] + (NLIMBS,), dtype=CARRIER, device=wide.device)
    m = m.expand_as(r)
    # leading zero bits common to every lane shift zeros into r = 0: skip them
    for i in range(_top_bit(wide), -1, -1):
        limb, shift = i // LIMB_BITS, i % LIMB_BITS
        bit = (wide[..., limb] >> shift) & 1
        r2, overflow = _shift_in(r, bit)
        ge = gte(r2, m) | overflow
        r = torch.where(ge[..., None], sub(r2, m), r2)
    return torch.where(is_zero(m)[..., None], 0, r)


def addmod(a, b, m):
    """(a + b) mod m over a 9-limb (288-bit) intermediate."""
    s, carry = add_carry(a, b)
    wide = torch.cat([s, carry.to(CARRIER)[..., None]], dim=-1)
    return _mod_wide(wide, m)


def mulmod(a, b, m):
    return _mod_wide(mul_wide(a, b), m)


# ---------------------------------------------------------------------------
# MODEXP (precompile 0x5; K5): Barrett reduction over a normalized modulus.
# Numbers here are base-2^16 digit vectors ("halves", int64[..., n]) so
# every digit product fits int64 with room for the column sums.
# ---------------------------------------------------------------------------


def _h_norm(cols, n: int):
    """Signed column sums [..., >= n] -> n base-2^16 digits (mod 2^(16n))."""
    out = []
    carry = torch.zeros(cols.shape[:-1], dtype=CARRIER, device=cols.device)
    for k in range(n):
        t = (cols[..., k] if k < cols.shape[-1] else 0) + carry
        out.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack(out, dim=-1)


def _h_mul(a, b, n_out: int):
    """Low n_out digits of a * b."""
    cols = torch.zeros(a.shape[:-1] + (a.shape[-1] + b.shape[-1],), dtype=CARRIER,
                       device=a.device)
    nb = b.shape[-1]
    for i in range(min(a.shape[-1], n_out)):
        cols[..., i:i + nb] += a[..., i:i + 1] * b
    return _h_norm(cols, n_out)


def _h_shift(x, s, n_out: int, left: bool):
    """x << s (or x >> s) for per-lane bit counts s (int64[...]), n_out digits."""
    q, r = (s // 16)[..., None], (s % 16)[..., None]
    ids = torch.arange(n_out, device=x.device)
    n = x.shape[-1]

    def digit(idx):
        idx = idx.expand(x.shape[:-1] + (n_out,))
        ok = (idx >= 0) & (idx < n)
        return torch.where(ok, torch.gather(x, -1, torch.clamp(idx, 0, n - 1)), 0)

    if left:
        return ((digit(ids - q) << r) & 0xFFFF) | (digit(ids - q - 1) >> (16 - r))
    return (digit(ids + q) >> r) | ((digit(ids + q + 1) << (16 - r)) & 0xFFFF)


def _h_gte(a, b):
    """a >= b for digit vectors of one width."""
    nz = (a - b) != 0
    top = a.shape[-1] - 1 - torch.argmax(nz.flip(-1).to(torch.int32), dim=-1).long()
    d = torch.gather(a - b, -1, top[..., None])[..., 0]
    return ~torch.any(nz, dim=-1) | (d > 0)


def _clz256(a):
    """Leading zero bits of a nonzero word, int64[...]."""
    nz = a != 0
    top = NLIMBS - 1 - torch.argmax(nz.flip(-1).to(torch.int32), dim=-1).long()
    v = torch.gather(a, -1, top[..., None])[..., 0]
    bits = torch.zeros_like(v)
    for sh in (16, 8, 4, 2, 1):
        big = (v >> sh) != 0
        bits = bits + torch.where(big, sh, 0)
        v = torch.where(big, v >> sh, v)
    return 255 - (32 * top + bits)


def modexp_plain(base, e, m):
    """Plain version of K5: ``base ** e mod m`` (m == 0 -> 0), the function
    of the JAX package's ``modexp`` (whose accumulator starts at 1, so
    m == 1 gives 0 even for e == 0).

    Reaches it in fewer steps than the JAX 256 x 2 bitwise ``_mod_wide``
    calls: the modulus is normalized (m_n = m << s, top bit 255), each
    product reduced by Barrett's method against mu = floor(2^512 / m_n)
    (at most two corrections), and the exponent's leading zero bits
    (common to all lanes) are skipped after starting from 1 mod m."""
    base, e, m = torch.broadcast_tensors(base, e, m)
    dev = base.device
    mz = is_zero(m)
    m1 = torch.where(mz[..., None], torch.as_tensor(from_int(1).astype(np.int64), device=dev), m)
    s = _clz256(m1)
    mn = _h_shift(_halves(m1), s, 16, left=True)
    # mu = floor(2^512 / m_n) in [2^256, 2^257]: bits 257..0 of the
    # quotient by shift-subtract; the remainder starts at 2^254
    r = torch.zeros(m.shape[:-1] + (17,), dtype=CARRIER, device=dev)
    r[..., 15] = 1 << 14
    mu = torch.zeros(m.shape[:-1] + (17,), dtype=CARRIER, device=dev)
    mn17 = torch.nn.functional.pad(mn, (0, 1))
    for i in range(257, -1, -1):
        r = _h_norm(r * 2, 17)
        ge = _h_gte(r, mn17)
        r = torch.where(ge[..., None], _h_norm(r - mn17, 17), r)
        mu[..., i // 16] |= ge.to(CARRIER) << (i % 16)
    mn18 = torch.nn.functional.pad(mn, (0, 2))
    c255 = torch.full_like(s, 255)
    c257 = torch.full_like(s, 257)

    def mulmod_b(a_h, b_h):
        xn = _h_shift(_h_mul(a_h, b_h, 32), s, 32, left=True)  # < m_n * 2^256
        q3 = _h_shift(_h_mul(_h_shift(xn, c255, 17, left=False), mu, 34),
                      c257, 17, left=False)
        rr = _h_norm(xn[..., :18] - _h_mul(q3, mn, 18), 18)  # in [0, 3 m_n)
        for _ in range(2):
            ge = _h_gte(rr, mn18)
            rr = torch.where(ge[..., None], _h_norm(rr - mn18, 18), rr)
        return _h_shift(rr, s, 16, left=False)

    base_h = _halves(base)
    acc = torch.zeros_like(base_h)
    acc[..., 0] = (m1[..., 0] != 1) | torch.any(m1[..., 1:] != 0, dim=-1)  # 1 mod m
    nz_e = torch.any(e != 0, dim=-1)
    top = int(torch.max(torch.where(nz_e, 255 - _clz256(torch.where(
        nz_e[..., None], e, 1)), -1)).item()) if e.numel() else -1
    for i in range(top, -1, -1):
        acc = mulmod_b(acc, acc)
        bit = ((e[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1) != 0
        acc = torch.where(bit[..., None], mulmod_b(acc, base_h), acc)
    out = acc[..., 0::2] | (acc[..., 1::2] << 16)
    return torch.where(mz[..., None], 0, out)


def modexp(base, e, m):
    """base ** e mod m (m == 0 -> 0): K5 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if base.is_cuda or e.is_cuda or m.is_cuda:
        from ..kernels import modexp_u256

        base, e, m = torch.broadcast_tensors(base, e, m)
        return modexp_u256(base.contiguous(), e.contiguous(), m.contiguous())
    return modexp_plain(base, e, m)


# ---------------------------------------------------------------------------
# Exp / SignExtend / Byte / Shifts
# ---------------------------------------------------------------------------


def exp(base, e):
    """base ** e mod 2^256, square-and-multiply (MSB-first); the plain
    version of K9's ``exp``."""
    base, e = torch.broadcast_tensors(base, e)
    acc = torch.zeros_like(base)
    acc[..., 0] = 1
    # leading zero bits common to every lane square 1 into 1: skip them
    for i in range(_top_bit(e), -1, -1):
        limb, shift = i // LIMB_BITS, i % LIMB_BITS
        bit = ((e[..., limb] >> shift) & 1) != 0
        acc = mul(acc, acc)
        acc = torch.where(bit[..., None], mul(acc, base), acc)
    return acc


def _take_limb(x, idx):
    """x[..., idx[...]] for an int64 per-lane limb index."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def signextend(k, x):
    """EVM SIGNEXTEND: extend sign from byte k (0 = least significant byte).
    If k >= 31, x is unchanged."""
    k32 = to_u32_saturating(k)
    t = 8 * k32 + 7
    bit_index = torch.clamp(t, 0, 255)
    limb = bit_index // LIMB_BITS
    shift = bit_index % LIMB_BITS
    sign = ((_take_limb(x, limb) >> shift) & 1) != 0
    limb_ids = torch.arange(NLIMBS, device=x.device)
    bits_into_limb = bit_index[..., None] - limb_ids * LIMB_BITS
    keep_all = bits_into_limb >= (LIMB_BITS - 1)
    keep_none = bits_into_limb < 0
    partial_shift = torch.clamp(bits_into_limb + 1, 0, LIMB_BITS - 1)
    partial_mask = (1 << partial_shift) - 1
    keep_mask = torch.where(keep_all, MASK32, torch.where(keep_none, 0, partial_mask))
    ext = torch.where(sign[..., None], keep_mask ^ MASK32, 0)
    res = (x & keep_mask) | ext
    noop = k32 >= 31
    return torch.where(noop[..., None], x, res)


def byte_op(i, x):
    """EVM BYTE: i-th byte of x counting from the most significant; >=32 -> 0."""
    i32 = to_u32_saturating(i)
    oob = i32 >= 32
    j = torch.clamp(31 - i32, 0, 31)
    limb = j // 4
    shift = (j % 4) * 8
    b = (_take_limb(x, limb) >> shift) & 0xFF
    b = torch.where(oob, 0, b)
    out = torch.zeros_like(x)
    out[..., 0] = b
    return out


def _shift_amount(s):
    """(amount >= 256, amount clipped to [0, 255]) of a u256 shift word."""
    big = torch.any(s[..., 1:] != 0, dim=-1) | (s[..., 0] >= 256)
    sh = torch.where(big, 255, s[..., 0])
    return big, sh


def _shift_limbs(a, ls, left: bool):
    ids = torch.arange(NLIMBS, device=a.device)
    idx = ids - ls[..., None] if left else ids + ls[..., None]
    valid = (idx >= 0) & (idx < NLIMBS)
    gathered = torch.gather(a, -1, torch.clamp(idx, 0, NLIMBS - 1))
    return torch.where(valid, gathered, 0)


def shl(s, a):
    """a << s (EVM operand order: shift amount first)."""
    big, sh = _shift_amount(s)
    ls, bs = sh // LIMB_BITS, (sh % LIMB_BITS)[..., None]
    moved = _shift_limbs(a, ls, left=True)
    lo = (moved << bs) & MASK32
    carry = torch.where(bs == 0, 0, moved >> ((32 - bs) % 32))
    out = torch.cat([lo[..., :1], lo[..., 1:] | carry[..., :-1]], dim=-1)
    return torch.where(big[..., None], 0, out)


def shr(s, a):
    """Logical a >> s."""
    big, sh = _shift_amount(s)
    ls, bs = sh // LIMB_BITS, (sh % LIMB_BITS)[..., None]
    moved = _shift_limbs(a, ls, left=False)
    hi = moved >> bs
    carry = torch.where(bs == 0, 0, (moved << ((32 - bs) % 32)) & MASK32)
    out = torch.cat([hi[..., :-1] | carry[..., 1:], hi[..., -1:]], dim=-1)
    return torch.where(big[..., None], 0, out)


def sar(s, a):
    """Arithmetic a >> s."""
    neg_in = msb(a)
    logical = shr(s, a)
    big, sh = _shift_amount(s)
    all_ones = torch.full_like(a, MASK32)
    fill = shl(from_u64_scalar(256 - sh), all_ones)
    res = torch.where(neg_in[..., None], logical | fill, logical)
    res_big = torch.where(neg_in[..., None], all_ones, 0)
    return torch.where(big[..., None], res_big, res)
