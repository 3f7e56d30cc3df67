"""alt_bn128 (BN254) curve arithmetic + optimal-ate pairing, pure Python.

Host-side backend for precompiles 0x6 (ECADD), 0x7 (ECMUL), 0x8
(ECPAIRING) — the reference computes these natives via py_ecc
(``mythril/laser/ethereum/natives.py`` ⚠unv, SURVEY.md §2.2). These are
rare, concrete-input-only paths reached through a gated host callback,
so plain Python bigints are the right tool (no device kernel).

The tower is the standard one for BN254:

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp12 = Fp[w]  / (w^12 - 18 w^6 + 82),   u = w^6 - 9

G2 lives on the sextic twist y^2 = x^3 + 3/(9+u) over Fp2; the pairing
untwists G2 into Fp12 (x·w^2, y·w^3) and runs a double-and-add Miller
loop over the ate loop count, then one final exponentiation
(p^12 - 1)/n. Validity rules follow EIP-196/197: coordinates must be
canonical field elements, points must be on their curve, and G2 inputs
must additionally lie in the order-n subgroup.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
CURVE_ORDER = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B1 = 3  # G1: y^2 = x^3 + 3
ATE_LOOP_COUNT = 29793968203157093288  # 6t + 2 for the BN parameter t


def _finv(a: int) -> int:
    return pow(a, P - 2, P)


class Fq:
    """Canonical Fp element — the generic point ops rely on canonical
    equality (infinity detection), which raw ints don't give."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fq(self.n + (o.n if isinstance(o, Fq) else o))

    __radd__ = __add__

    def __sub__(self, o):
        return Fq(self.n - (o.n if isinstance(o, Fq) else o))

    def __rsub__(self, o):
        return Fq((o.n if isinstance(o, Fq) else o) - self.n)

    def __neg__(self):
        return Fq(-self.n)

    def __mul__(self, o):
        return Fq(self.n * (o.n if isinstance(o, Fq) else o))

    __rmul__ = __mul__

    def inv(self) -> "Fq":
        return Fq(_finv(self.n))

    def is_zero(self) -> bool:
        return self.n == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq) and self.n == o.n

    def __hash__(self):
        return hash(self.n)

    def __repr__(self):
        return f"Fq({self.n})"


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


class Fq2:
    """c0 + c1·u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        return Fq2(self.c0 * o.c0 - self.c1 * o.c1,
                   self.c0 * o.c1 + self.c1 * o.c0)

    __rmul__ = __mul__

    def inv(self) -> "Fq2":
        den = _finv(self.c0 * self.c0 + self.c1 * self.c1)
        return Fq2(self.c0 * den, -self.c1 * den)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


FQ2_ONE = Fq2(1, 0)
FQ2_ZERO = Fq2(0, 0)
B2 = Fq2(3, 0) * Fq2(9, 1).inv()  # twist constant 3/(9+u)

# ---------------------------------------------------------------------------
# Fp12 as a dense degree-11 polynomial in w, reduced by w^12 = 18 w^6 - 82
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c",)

    MOD = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 + MOD·(1..w^11) = 0

    def __init__(self, coeffs: Sequence[int]):
        assert len(coeffs) == 12
        self.c = tuple(x % P for x in coeffs)

    @staticmethod
    def one() -> "Fq12":
        return Fq12((1,) + (0,) * 11)

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(tuple(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(tuple(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self) -> "Fq12":
        return Fq12(tuple(-a for a in self.c))

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(tuple(a * o for a in self.c))
        raw = [0] * 23
        for i, a in enumerate(self.c):
            if a:
                for j, b in enumerate(o.c):
                    raw[i + j] += a * b
        # reduce degrees 22..12 via w^12 = 18 w^6 - 82
        for d in range(22, 11, -1):
            v = raw[d]
            if v:
                raw[d] = 0
                raw[d - 6] += 18 * v
                raw[d - 12] -= 82 * v
        return Fq12(raw[:12])

    __rmul__ = __mul__

    def inv(self) -> "Fq12":
        # extended Euclid over Fp[w] against the modulus polynomial
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = [m % P for m in self.MOD] + [1]

        def deg(p):
            for d in range(len(p) - 1, -1, -1):
                if p[d]:
                    return d
            return 0

        while deg(low):
            # r = high / low  (polynomial long division, leading terms)
            r = [0] * 13
            rem = list(high)
            dl = deg(low)
            inv_lead = _finv(low[dl])
            for d in range(deg(rem) - dl, -1, -1):
                q = rem[d + dl] * inv_lead % P
                r[d] = q
                if q:
                    for i in range(dl + 1):
                        rem[d + i] = (rem[d + i] - q * low[i]) % P
            nm, new = list(hm), list(high)
            for i in range(13):
                if lm[i] or low[i]:
                    for j in range(13 - i):
                        if r[j]:
                            nm[i + j] -= lm[i] * r[j]
                            new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        scale = _finv(low[0])
        return Fq12(tuple(x * scale % P for x in lm[:12]))

    def pow(self, e: int) -> "Fq12":
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c == o.c

    def __hash__(self):
        return hash(self.c)

    def is_zero(self) -> bool:
        return all(a == 0 for a in self.c)


# ---------------------------------------------------------------------------
# Generic affine short-Weierstrass ops (field-agnostic; None = infinity)
# ---------------------------------------------------------------------------

Pt = Optional[Tuple[object, object]]


def _pt_double(pt: Pt) -> Pt:
    if pt is None:
        return None
    x, y = pt
    if _is_zero(y):
        return None
    m = _fdiv(3 * (x * x), 2 * y)
    nx = m * m - x - x
    return (nx, m * (x - nx) - y)


def _pt_add(p1: Pt, p2: Pt) -> Pt:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _pt_double(p1)
        return None
    m = _fdiv(y2 - y1, x2 - x1)
    nx = m * m - x1 - x2
    return (nx, m * (x1 - nx) - y1)


def _pt_mul(pt: Pt, n: int) -> Pt:
    r: Pt = None
    while n:
        if n & 1:
            r = _pt_add(r, pt)
        pt = _pt_double(pt)
        n >>= 1
    return r


def _pt_neg(pt: Pt) -> Pt:
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def _is_zero(v) -> bool:
    return v.is_zero()


def _fdiv(a, b):
    return a * b.inv()


# G1/G2 generators (standard BN254 constants, as in EIP-197)
G1 = (Fq(1), Fq(2))
G2 = (
    Fq2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    Fq2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def on_curve_g1(pt: Pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B1)).is_zero()


def on_curve_g2(pt: Pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B2)).is_zero()


def in_g2_subgroup(pt: Pt) -> bool:
    return _pt_mul(pt, CURVE_ORDER) is None


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------


def _twist(pt: Pt) -> Pt:
    """Map a twist point (Fq2 coords) onto the Fp12 curve y^2 = x^3 + 3."""
    if pt is None:
        return None
    x, y = pt
    # change of basis u -> w^6 - 9, then scale x by w^2, y by w^3
    xc = [(x.c0 - 9 * x.c1) % P, x.c1]
    yc = [(y.c0 - 9 * y.c1) % P, y.c1]
    nx = [0] * 12
    ny = [0] * 12
    nx[2], nx[8] = xc[0], xc[1]   # (xc0 + xc1 w^6) * w^2
    ny[3], ny[9] = yc[0], yc[1]   # (yc0 + yc1 w^6) * w^3
    return (Fq12(nx), Fq12(ny))


def _embed_g1(pt: Pt) -> Pt:
    if pt is None:
        return None
    x, y = pt
    return (Fq12((x.n,) + (0,) * 11), Fq12((y.n,) + (0,) * 11))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (Fp12 points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = _fdiv(y2 - y1, x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = _fdiv(3 * (x1 * x1), 2 * y1)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def _frob(pt: Pt) -> Pt:
    x, y = pt
    return (x.pow(P), y.pow(P))


def miller_loop(q_twisted: Pt, p_g1: Pt) -> Fq12:
    """Miller loop WITHOUT the final exponentiation (so a product of
    pairings pays the big exponentiation once)."""
    if q_twisted is None or p_g1 is None:
        return Fq12.one()
    q = _twist(q_twisted)
    pt = _embed_g1(p_g1)
    r = q
    f = Fq12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r, r, pt)
        r = _pt_double(r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q, pt)
            r = _pt_add(r, q)
    q1 = _frob(q)
    nq2 = _pt_neg(_frob(q1))
    f = f * _linefunc(r, q1, pt)
    r = _pt_add(r, q1)
    f = f * _linefunc(r, nq2, pt)
    return f


_FINAL_EXP = (P ** 12 - 1) // CURVE_ORDER


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(g1_pt, g2_pt), ...]; callers must have
    validated the points (on curve, G2 subgroup)."""
    acc = Fq12.one()
    for g1_pt, g2_pt in pairs:
        acc = acc * miller_loop(g2_pt, g1_pt)
    return acc.pow(_FINAL_EXP) == Fq12.one()


def pairing(g1_pt: Pt, g2_pt: Pt) -> Fq12:
    """Full single pairing (tests/bilinearity checks)."""
    return miller_loop(g2_pt, g1_pt).pow(_FINAL_EXP)


# ---------------------------------------------------------------------------
# Precompile entry points (EIP-196/197 semantics, byte-level)
# ---------------------------------------------------------------------------


def _read_g1(data: bytes) -> Tuple[Pt, bool]:
    """64 bytes -> (point, ok). (0,0) is infinity; out-of-range or
    off-curve coordinates are invalid."""
    x = int.from_bytes(data[0:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x >= P or y >= P:
        return None, False
    if x == 0 and y == 0:
        return None, True
    pt = (Fq(x), Fq(y))
    return pt, on_curve_g1(pt)


def _read_g2(data: bytes) -> Tuple[Pt, bool]:
    """128 bytes -> (point, ok). EIP-197 encodes Fp2 as (imag, real)."""
    xi = int.from_bytes(data[0:32], "big")
    xr = int.from_bytes(data[32:64], "big")
    yi = int.from_bytes(data[64:96], "big")
    yr = int.from_bytes(data[96:128], "big")
    if max(xi, xr, yi, yr) >= P:
        return None, False
    if xi == xr == yi == yr == 0:
        return None, True
    pt = (Fq2(xr, xi), Fq2(yr, yi))
    if not on_curve_g2(pt):
        return None, False
    return pt, in_g2_subgroup(pt)


def _write_g1(pt: Pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    x, y = pt
    return x.n.to_bytes(32, "big") + y.n.to_bytes(32, "big")


def ecadd(data: bytes) -> Optional[bytes]:
    """0x06: add two G1 points; None = precompile failure."""
    data = data[:128].ljust(128, b"\x00")
    a, ok_a = _read_g1(data[0:64])
    b, ok_b = _read_g1(data[64:128])
    if not (ok_a and ok_b):
        return None
    return _write_g1(_pt_add(a, b))


def ecmul(data: bytes) -> Optional[bytes]:
    """0x07: scalar-multiply a G1 point; None = failure."""
    data = data[:96].ljust(96, b"\x00")
    pt, ok = _read_g1(data[0:64])
    if not ok:
        return None
    n = int.from_bytes(data[64:96], "big")
    return _write_g1(_pt_mul(pt, n))


def ecpairing(data: bytes) -> Optional[bytes]:
    """0x08: pairing product check; None = failure (bad length/points)."""
    if len(data) % 192 != 0:
        return None
    pairs = []
    for k in range(0, len(data), 192):
        g1_pt, ok1 = _read_g1(data[k:k + 64])
        g2_pt, ok2 = _read_g2(data[k + 64:k + 192])
        if not (ok1 and ok2):
            return None
        if g1_pt is not None and g2_pt is not None:
            pairs.append((g1_pt, g2_pt))
    ok = pairing_check(pairs) if pairs else True
    return int(ok).to_bytes(32, "big")
