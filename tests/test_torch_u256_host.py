"""K1's and K9's bodies before the card. ``kernels/csrc/u256.cuh`` holds
the division core ``divrem`` (behind ``divmod8`` and ``mod_wide16``) and
``exp8``; ``torch_port_k10host`` builds it as host C++ with g++, with
loops over the lanes behind the C interfaces of ``u256_divmod.cu`` and
``u256_mulmod_exp.cu``. Each result is held to the port's plain version
(``ops/u256.py`` ``divmod_u``, ``_mod_wide``, ``exp``), to the JAX
package's function of the same name on the CPU and to Python's ints, on
the rare-branch cases that ``chip_smoke.py`` phase 3 also runs on the card
(``DIVMOD_CASES``, ``MODWIDE_CASES``, ``EXP_CASES``) and on seeded random
words.

A small Python model of the division (Knuth's algorithm D over 32-bit
limbs, as ``divrem`` runs it) and ``chip_smoke.exp_path`` assert the
branch each case reaches: the quick exits, the digit cap, the
second-limb correction once and twice, the add-back and every EXP fast
path. ``chip_smoke``'s vectorized ``exp_path_index`` (which counts K10's
EXP lanes by path on the card) and ``exp_ops`` (K9 exp's bound) are held
to that model and to a square-and-multiply's own count.

The host build and the plain versions run in one child process, the JAX
functions (each jitted once, on one shape) in another
(``torch_port_child``)."""

import numpy as np
import pytest

import torch_port_child
import torch_port_k10host as k10host

SMOKE = k10host.chip_smoke()
DIVMOD = {c[0]: c[1:] for c in SMOKE.DIVMOD_CASES}
MODWIDE = {c[0]: c[1:] for c in SMOKE.MODWIDE_CASES}
EXP = {c[0]: c[1:] for c in SMOKE.EXP_CASES}
exp_path = SMOKE.exp_path
M = (1 << 256) - 1
B = 1 << 32
N_RANDOM = 48


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _limbs(x: int, n: int) -> list:
    return [(x >> (32 * i)) & (B - 1) for i in range(n)]


def divrem_model(x: int, d: int, nx: int):
    """(x // d, x % d) (0, 0 for d == 0) as ``divrem<nx>`` computes it,
    and the set of branches taken."""
    if d == 0:
        return 0, 0, {"zero"}
    if x < d:
        return 0, x, {"below"}
    if d < B:
        return x // d, x % d, {"one_limb"}
    hits = {"digits"}
    s = 255 - (d.bit_length() - 1)
    v = d << s
    u = _limbs(x << s, nx + 9)
    v7, v6 = _limbs(v, 8)[7], _limbs(v, 8)[6]
    top = max([i + 1 for i in range(nx + 9) if u[i]] + [0])
    q = 0
    for j in range(nx, -1, -1):
        if j + 7 >= top:
            continue
        if u[j + 8] >= v7:
            qh, rh = B - 1, u[j + 7] + v7
            hits.add("cap")
        else:
            qh, rh = divmod(u[j + 8] * B + u[j + 7], v7)
        for k in range(2):
            if rh < B and qh * v6 > rh * B + u[j + 6]:
                qh, rh = qh - 1, rh + v7
                hits.add(("corr1", "corr2")[k])
        w = sum(u[j + i] << (32 * i) for i in range(9)) - qh * v
        if w < 0:
            qh, w = qh - 1, w + v
            hits.add("addback")
        assert 0 <= w < v
        u[j:j + 9] = _limbs(w, 9)
        q += qh << (32 * j)
    r = sum(u[i] << (32 * i) for i in range(8)) >> s
    return q, r, hits


def _wide(a, b, op):
    return a * b if op == "mulmod" else a + b


def _random(seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
            for _ in range(N_RANDOM)]


def _inputs():
    """Every lane of the three batches: the cases, then random words."""
    xs = [c[0] for c in DIVMOD.values()] + _random(1)
    ds = [c[1] for c in DIVMOD.values()] + _random(2)
    ra, rb, rm = _random(3), _random(4), _random(5)
    wides = [_wide(a, b, op) for a, b, _, op, _ in MODWIDE.values()] + [
        x * y for x, y in zip(ra, rb)]
    ms = [c[2] for c in MODWIDE.values()] + rm
    bs = [c[0] for c in EXP.values()] + _random(6)
    es = [c[1] for c in EXP.values()] + _random(7)
    return xs, ds, wides, ms, bs, es


def _limb_array(vals, n=8):
    return np.array([_limbs(v, n) for v in vals], dtype=np.uint32)


def _ints(arr) -> list:
    arr = np.asarray(arr).astype(np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in arr]


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------


def _torch(path):
    """Child process: the host build and the plain versions."""
    import ctypes

    torch = torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    lib = ctypes.CDLL(k10host.build())
    kernels.bind_divmod(lib)
    kernels.bind_mulmod_exp(lib)
    xs, ds, wides, ms, bs, es = _inputs()

    def t(vals, n=8):
        return torch.as_tensor(_limb_array(vals, n).astype(np.int64))

    def host_divmod(a, b):
        q, r = torch.empty_like(a), torch.empty_like(a)
        lib.divmod_u256(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(), a.shape[0],
                        None)
        return q, r

    def host2(fn, x, y):
        out = torch.empty_like(y)
        fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), y.shape[0], None)
        return out

    a, b = t(xs), t(ds)
    q, r = host_divmod(a, b)
    qp, rp = u256.divmod_u(a, b)
    # SDIV/SMOD as K10's step does them: signs stripped around the
    # unsigned division and put back
    aa, na = u256.abs_signed(a)
    ab, nb = u256.abs_signed(b)
    qa, ra = host_divmod(aa, ab)
    bz = u256.is_zero(b)[:, None]
    sdiv = torch.where(bz, 0, torch.where((na != nb)[:, None], u256.neg(qa), qa))
    smod = torch.where(bz, 0, torch.where(na[:, None], u256.neg(ra), ra))
    x, m = t(wides, 16), t(ms)
    base, e = t(bs), t(es)
    res = {"divmod": (u256.to_ints(q), u256.to_ints(r)),
           "divmod_plain": (u256.to_ints(qp), u256.to_ints(rp)),
           "sdiv": (u256.to_ints(sdiv), u256.to_ints(u256.sdiv(a, b))),
           "smod": (u256.to_ints(smod), u256.to_ints(u256.smod(a, b))),
           "mod_wide": u256.to_ints(host2(lib.u256_mod_wide, x, m)),
           "mod_wide_plain": u256.to_ints(u256._mod_wide(x, m)),
           "exp": u256.to_ints(host2(lib.u256_exp, base, e)),
           "exp_plain": u256.to_ints(u256.exp(base, e)),
           "exp_path_index": SMOKE.exp_path_index(base, e).tolist()}
    torch_port_child.dump(res, path)


def _jax(path):
    """Child process: the JAX package's functions, each jitted once."""
    import mythril_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp
    from mythril_tpu.ops import u256 as ju

    xs, ds, wides, ms, bs, es = _inputs()
    q, r = jax.jit(ju.divmod_u)(jnp.asarray(_limb_array(xs)), jnp.asarray(_limb_array(ds)))
    mw = jax.jit(ju._mod_wide)(jnp.asarray(_limb_array(wides, 16)), jnp.asarray(_limb_array(ms)))
    ex = jax.jit(ju.exp)(jnp.asarray(_limb_array(bs)), jnp.asarray(_limb_array(es)))
    torch_port_child.dump({"divmod": (_ints(q), _ints(r)), "mod_wide": _ints(mw),
                           "exp": _ints(ex)}, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    want, got = torch_port_child.run_pair("test_torch_u256_host", "_jax", "_torch",
                                          tmp_path_factory)
    return dict(jax=want, torch=got)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DIVMOD))
def test_divmod(res, name):
    xs, ds = _inputs()[:2]
    i = list(DIVMOD).index(name)
    x, d = xs[i], ds[i]
    want = (x // d, x % d) if d else (0, 0)
    got = (res["torch"]["divmod"][0][i], res["torch"]["divmod"][1][i])
    assert got == want
    assert (res["torch"]["divmod_plain"][0][i], res["torch"]["divmod_plain"][1][i]) == want
    assert (res["jax"]["divmod"][0][i], res["jax"]["divmod"][1][i]) == want
    q, r, hits = divrem_model(x, d, 8)
    assert (q, r) == want
    assert DIVMOD[name][2] in hits, hits


def test_divmod_all_lanes(res):
    """Every lane, the seeded random words included."""
    xs, ds = _inputs()[:2]
    want = [(x // d, x % d) if d else (0, 0) for x, d in zip(xs, ds)]
    assert list(zip(*res["torch"]["divmod"])) == want
    assert list(zip(*res["torch"]["divmod_plain"])) == want
    assert list(zip(*res["jax"]["divmod"])) == want


def _s(x):
    return x - (1 << 256) if x >> 255 else x


def test_signed_division(res):
    """SDIV/SMOD through the host build's unsigned division, signs put
    back as K10 does (-2^255 / -1 wraps to -2^255)."""
    xs, ds = _inputs()[:2]
    got_d, plain_d = res["torch"]["sdiv"]
    got_m, plain_m = res["torch"]["smod"]
    assert got_d == plain_d and got_m == plain_m
    for i, (x, d) in enumerate(zip(xs, ds)):
        if d == 0:
            assert got_d[i] == got_m[i] == 0
            continue
        a, b = _s(x), _s(d)
        q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
        r = abs(a) % abs(b) * (-1 if a < 0 else 1)
        assert (got_d[i], got_m[i]) == (q & M, r & M), (x, d)
    i = list(DIVMOD).index("sdiv_overflow_unsigned")
    assert got_d[i] == 1 << 255  # -2^255 / -1


@pytest.mark.parametrize("name", list(MODWIDE))
def test_mod_wide(res, name):
    _, _, wides, ms, _, _ = _inputs()
    i = list(MODWIDE).index(name)
    x, m = wides[i], ms[i]
    want = x % m if m else 0
    assert res["torch"]["mod_wide"][i] == want
    assert res["torch"]["mod_wide_plain"][i] == want
    assert res["jax"]["mod_wide"][i] == want
    _, r, hits = divrem_model(x, m, 16)
    assert r == want
    assert MODWIDE[name][4] in hits, hits


@pytest.mark.parametrize("name", list(EXP))
def test_exp(res, name):
    _, _, _, _, bs, es = _inputs()
    i = list(EXP).index(name)
    want = pow(bs[i], es[i], 1 << 256)
    assert res["torch"]["exp"][i] == want
    assert res["torch"]["exp_plain"][i] == want
    assert res["jax"]["exp"][i] == want
    assert exp_path(bs[i], es[i]) == EXP[name][2]


def test_mod_wide_and_exp_all_lanes(res):
    """Every lane of both batches, the seeded random words included."""
    _, _, wides, ms, bs, es = _inputs()
    want = [x % m if m else 0 for x, m in zip(wides, ms)]
    for got in (res["torch"]["mod_wide"], res["torch"]["mod_wide_plain"], res["jax"]["mod_wide"]):
        assert got == want
    want = [pow(b, e, 1 << 256) for b, e in zip(bs, es)]
    for got in (res["torch"]["exp"], res["torch"]["exp_plain"], res["jax"]["exp"]):
        assert got == want


def test_every_branch_has_a_case():
    """The case lists reach every branch of the division core, in K1's
    8-limb and K9's 16-limb dividends, and every path of EXP."""
    core = {"zero", "below", "one_limb", "digits", "cap", "corr1", "corr2", "addback"}
    for cases, nx in (([(c[0], c[1]) for c in DIVMOD.values()], 8),
                      ([(_wide(a, b, op), m) for a, b, m, op, _ in MODWIDE.values()], 16)):
        hits = set().union(*(divrem_model(x, d, nx)[2] for x, d in cases))
        assert hits >= core, core - hits
    assert {exp_path(b, e) for b, e, _ in EXP.values()} == {
        "e_zero", "base_01", "pow2", "even_big", "chain"}
    # the neighbours of the fast paths' edges: k e = 255 and 256, e = 255
    # and 256 with an even base, an odd base with a 256-bit e
    assert {(2, 255), (2, 256), (6, 255), (6, 256)} <= {(b, e) for b, e, _ in EXP.values()}
    assert any(b & 1 and e >> 255 and b > 1 for b, e, _ in EXP.values())


def test_exp_path_index_on_every_lane(res):
    """``chip_smoke.exp_path_index``, the vectorized ``exp_path`` that
    counts K10's EXP lanes on the card, on every lane of the EXP batch."""
    _, _, _, _, bs, es = _inputs()
    assert [SMOKE.EXP_PATHS[i] for i in res["torch"]["exp_path_index"]] == [
        exp_path(b, e) for b, e in zip(bs, es)]


def _square_multiply(base: int, e: int):
    """base ** e mod 2^256 by left-to-right square-and-multiply ->
    (result, squarings, multiplies)."""
    acc, sq, mul = base, 0, 0
    for bit in bin(e)[3:]:
        acc, sq = acc * acc % (1 << 256), sq + 1
        if bit == "1":
            acc, mul = acc * base % (1 << 256), mul + 1
    return acc, sq, mul


@pytest.mark.parametrize("seed", [6, 7])
def test_exp_bound_counts_what_each_lane_needs(seed):
    """``chip_smoke.exp_ops``, K9 exp's operation bound: nothing on an
    exact fast path, else a square-and-multiply's squarings at 20
    multiply-adds and multiplies at 36, 4 operations each."""
    lanes = [(b, e) for b, e, _ in EXP.values()] + list(zip(_random(seed), _random(seed + 1)))
    for b, e in lanes:
        if exp_path(b, e) != "chain":
            assert SMOKE.exp_ops(b, e) == 0
            continue
        acc, sq, mul = _square_multiply(b, e)
        assert acc == pow(b, e, 1 << 256)
        assert SMOKE.exp_ops(b, e) == (sq * 20 + mul * 36) * 4
