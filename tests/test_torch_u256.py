"""Parity of the PyTorch u256 limb ops with the JAX package's and with
Python integers, on seeded random words plus edge words (exact).

Both packages run in one child process (``torch_port_child``); the tests
compare its pickled results."""

import numpy as np
import pytest

import torch_port_child

M = (1 << 256) - 1
EDGE = [0, 1, 2, 1 << 255, M, M - 1, (1 << 255) - 1, 255, 256, 31, 32, 1 << 128,
        (1 << 64) - 1, 1 << 64]


def _operands(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
            for _ in range(2 * n)]
    xs = EDGE + EDGE[::-1] + rand[:n]
    ys = EDGE[::-1] + EDGE + rand[n:]
    # SDIV overflow and division by zero
    xs += [1 << 255, 5, M]
    ys += [M, 0, 0]
    return xs, ys


def _s(x):
    return x - (1 << 256) if x >> 255 else x


def _sdiv(x, y):
    if y == 0:
        return 0
    a, b = _s(x), _s(y)
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _smod(x, y):
    if y == 0:
        return 0
    a, b = _s(x), _s(y)
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def _signextend(k, x):
    if k >= 31:
        return x
    bit = 8 * k + 7
    v = x & ((1 << (bit + 1)) - 1)
    return v | (M ^ ((1 << (bit + 1)) - 1)) if (x >> bit) & 1 else v


BINARY = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x // y if y else 0,
    "mod": lambda x, y: x % y if y else 0,
    "sdiv": _sdiv,
    "smod": _smod,
    "shl": lambda x, y: (y << x) if x < 256 else 0,
    "shr": lambda x, y: (y >> x) if x < 256 else 0,
    "sar": lambda x, y: _s(y) >> min(x, 511),
    "signextend": _signextend,
    "byte_op": lambda x, y: 0 if x >= 32 else (y >> (8 * (31 - x))) & 0xFF,
    "bit_and": lambda x, y: x & y,
    "bit_or": lambda x, y: x | y,
    "bit_xor": lambda x, y: x ^ y,
}
PREDICATES = {
    "lt": lambda x, y: x < y,
    "gt": lambda x, y: x > y,
    "gte": lambda x, y: x >= y,
    "lte": lambda x, y: x <= y,
    "slt": lambda x, y: _s(x) < _s(y),
    "sgt": lambda x, y: _s(x) > _s(y),
    "eq": lambda x, y: x == y,
}


PAIRS = ["divmod_u", "add_carry", "sub_borrow", "mul_wide"]
TERNARY = ["addmod", "mulmod"]
UNARY = ["neg", "bit_not", "is_zero", "msb", "to_u32_saturating"]


def _compute(path):
    """Child process: every op through both packages."""
    torch = torch_port_child.torch_single_thread()
    import mythril_tpu  # noqa: F401  (x64)
    import jax.numpy as jnp
    from mythril_tpu.ops import u256 as ju
    from mythril_tpu_torch.ops import u256 as tu

    def both(xs):
        limbs = ju.from_ints(xs)
        return jnp.asarray(limbs), torch.as_tensor(limbs.astype(np.int64))

    def host(t):
        a = t.numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a

    out = {}
    for name in sorted(BINARY):
        xs, ys = _operands(sorted(BINARY).index(name))
        (ja, ta), (jb, tb) = both(xs), both(ys)
        got = getattr(tu, name)(ta, tb)
        out["binary", name] = (host(got), np.asarray(getattr(ju, name)(ja, jb)),
                               tu.to_ints(got.numpy()))
    xs, ys = _operands(7)
    (ja, ta), (jb, tb) = both(xs), both(ys)
    for name in sorted(PREDICATES):
        out["pred", name] = (getattr(tu, name)(ta, tb).numpy(),
                             np.asarray(getattr(ju, name)(ja, jb)))
    xs, ys = _operands(11)
    (ja, ta), (jb, tb) = both(xs), both(ys)
    for name in PAIRS:
        got, want = getattr(tu, name)(ta, tb), getattr(ju, name)(ja, jb)
        if name == "mul_wide":
            got, want = [got], [want]
        out["pair", name] = [(host(g), np.asarray(w)) for g, w in zip(got, want)]
    xs, ys = _operands(13, n=8)
    (ja, ta), (jb, tb), (jm, tm) = both(xs), both(ys), both(ys[::-1])
    for name in TERNARY:
        got = getattr(tu, name)(ta, tb, tm)
        out["ternary", name] = (host(got), np.asarray(getattr(ju, name)(ja, jb, jm)),
                                tu.to_ints(got.numpy()))
    xs, ys = _operands(17, n=6)
    (ja, ta), (jb, tb) = both(xs), both(ys)
    got = tu.exp(ta, tb)
    out["exp"] = (host(got), np.asarray(ju.exp(ja, jb)), tu.to_ints(got.numpy()))
    xs, _ = _operands(19)
    ja, ta = both(xs)
    for name in UNARY:
        out["unary", name] = (host(getattr(tu, name)(ta)), np.asarray(getattr(ju, name)(ja)))
    xs, _ = _operands(23)
    ja, ta = both(xs)
    out["u64"] = (tu.to_u64_saturating(ta).numpy(),
                  np.asarray(ju.to_u64_saturating(ja).astype(jnp.int64)))
    xs, _ = _operands(29)
    out["host"] = (tu.to_ints(tu.from_ints(xs)), tu.to_bytes(tu.from_bytes(b"\x01\x02")))
    out["cuda"] = None
    if torch.cuda.is_available():
        from mythril_tpu_torch import kernels

        xs, ys = _operands(31, n=500)
        (_, ta), (_, tb) = both(xs), both(ys)
        q, r = kernels.divmod_u256(ta.cuda(), tb.cuda())
        qp, rp = tu.divmod_u(ta, tb)
        out["cuda"] = bool(torch.equal(q.cpu(), qp) and torch.equal(r.cpu(), rp))
    torch_port_child.dump(out, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_u256", "_compute", tmp_path_factory)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op(res, name):
    got, want, ints = res["binary", name]
    np.testing.assert_array_equal(got, want)
    xs, ys = _operands(sorted(BINARY).index(name))
    assert ints == [BINARY[name](x, y) & M for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicate(res, name):
    got, want = res["pred", name]
    np.testing.assert_array_equal(got, want)
    xs, ys = _operands(7)
    assert got.tolist() == [PREDICATES[name](x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", PAIRS)
def test_pair_results(res, name):
    for got, want in res["pair", name]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", TERNARY)
def test_ternary(res, name):
    got, want, ints = res["ternary", name]
    np.testing.assert_array_equal(got, want)
    xs, ys = _operands(13, n=8)
    op = (lambda x, y: x + y) if name == "addmod" else (lambda x, y: x * y)
    assert ints == [op(x, y) % m if m else 0 for x, y, m in zip(xs, ys, ys[::-1])]


def test_exp(res):
    got, want, ints = res["exp"]
    np.testing.assert_array_equal(got, want)
    xs, ys = _operands(17, n=6)
    assert ints == [pow(x, y, 1 << 256) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", UNARY)
def test_unary(res, name):
    got, want = res["unary", name]
    np.testing.assert_array_equal(got.astype(want.dtype), want)


def test_to_u64_saturating_matches_the_jax_int64_view(res):
    got, want = res["u64"]
    np.testing.assert_array_equal(got, want)


def test_host_helpers_round_trip(res):
    ints, word = res["host"]
    xs, _ = _operands(29)
    assert ints == [x & M for x in xs]
    assert word == (0x0102).to_bytes(32, "big")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(res):
    if res["cuda"] is None:
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert res["cuda"]
