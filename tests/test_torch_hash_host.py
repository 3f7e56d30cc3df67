"""K2's and K4's bodies before the card. ``kernels/csrc/keccak.cuh`` (K2,
and K10's SHA3) absorbs whole aligned words lined up by funnel shifts;
``kernels/csrc/sha256.cuh`` (K4) reads 16-byte chunks and places the
padding as words. ``torch_port_k10host`` builds both as host C++ with g++,
with loops over the lanes behind the C interfaces of ``keccak256.cu`` and
``sha256.cu``, driven through the wrappers' own marshaling
(``kernels.keccak256_call``, ``kernels.sha256_call``).

Each result is held exactly to the port's plain version
(``keccak256_plain``, ``sha256_plain``), to ``keccak256_host_int`` /
``hashlib`` and to the JAX package's ``keccak256_device`` /
``sha256_device``: at the padding edges (K2: 0, 1, 31, 32, 135, 136, 137,
199, 200 bytes of 200-byte rows, and CREATE2's 85-byte rows; K4: 0, 1,
55, 56, 63, 64, 119, 120, 447, 448 bytes of the 448-byte precompile
window), with random bytes past each message, in buffers at an address
that is not 8-byte aligned and in rows whose length is not a multiple of
16, and through K4's lane mask. K10's SHA3 runs the same absorb: the host
build of ``evm_step.cuh`` steps ``chip_smoke.sha3_batch`` (every offset
mod 8, windows ending at the row's last byte, offsets below the row),
held field for field to ``superstep_plain`` and to the host keccak.

The host builds and the plain versions run in one child process, the JAX
functions (each jitted once) in another (``torch_port_child``)."""

import numpy as np
import pytest

import torch_port_child
import torch_port_k10host as k10host

SMOKE = k10host.chip_smoke()
K2_LENGTHS = [0, 1, 31, 32, 135, 136, 137, 199, 200]
CREATE2_LENGTHS = [85, 85, 85, 85, 0, 1, 7, 8, 9, 84]
K4_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 447, 448]
N_RANDOM = 7
# byte offsets of the buffers the host build also reads from an address
# that is not 8-byte (K2) or 16-byte (K4) aligned
K2_SHIFT, K4_SHIFT = 3, 4


def _rows(seed, lens, width):
    """Random rows of ``width`` bytes (random bytes past each message too)
    and their lengths, ``N_RANDOM`` random lengths after ``lens``."""
    rng = np.random.default_rng(seed)
    lens = np.array(list(lens) + list(rng.integers(0, width + 1, N_RANDOM)), dtype=np.int32)
    return rng.integers(0, 256, (len(lens), width), dtype=np.uint8), lens


def _inputs():
    """(name, rows, lengths) of every batch both children hash."""
    return {"k2": _rows(1, K2_LENGTHS, 200), "create2": _rows(2, CREATE2_LENGTHS, 85),
            "k4": _rows(3, K4_LENGTHS, 448), "k4_odd": _rows(4, [0, 1, 55, 56, 99, 100], 100)}


def _mask():
    return np.random.default_rng(5).random(len(K4_LENGTHS) + N_RANDOM) < 0.5


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------


def _shifted(torch, data, shift):
    """``data`` copied into a buffer ``shift`` bytes past an aligned start."""
    buf = torch.zeros(data.size + shift + 16, dtype=torch.uint8)
    view = buf[shift:shift + data.size].view(data.shape)
    view.copy_(torch.as_tensor(data))
    return view


def _torch(path):
    """Child process: the host builds, the plain versions, the host keccak
    and hashlib."""
    import hashlib

    torch = torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.ops import keccak, sha256, u256

    lib = k10host.load(k10host.build())
    kernels.bind_keccak256(lib)
    kernels.bind_sha256(lib)
    ints = lambda t: [u256.to_int(r) for r in t.numpy()]
    res = {}
    for name, (data, lens) in _inputs().items():
        d, n = torch.as_tensor(data), torch.as_tensor(lens)
        if name.startswith("k2") or name == "create2":
            res[name] = dict(
                host=ints(kernels.keccak256_call(lib.keccak256, 0, d, n)),
                shifted=ints(kernels.keccak256_call(lib.keccak256, 0,
                                                    _shifted(torch, data, K2_SHIFT), n)),
                plain=ints(keccak.keccak256_plain(d, n)),
                ref=[keccak.keccak256_host_int(bytes(r[:k])) for r, k in zip(data, lens)])
        else:
            res[name] = dict(
                host=ints(kernels.sha256_call(lib.sha256, 0, d, n)),
                shifted=ints(kernels.sha256_call(lib.sha256, 0,
                                                 _shifted(torch, data, K4_SHIFT), n)),
                plain=ints(sha256.sha256_plain(d, n)),
                ref=[int.from_bytes(hashlib.sha256(bytes(r[:k])).digest(), "big")
                     for r, k in zip(data, lens)])
    data, lens = _inputs()["k4"]
    d, n, m = torch.as_tensor(data), torch.as_tensor(lens), torch.as_tensor(_mask())
    res["k4_mask"] = dict(host=ints(kernels.sha256_call(lib.sha256, 0, d, n, m)),
                          lanes=ints(sha256.sha256_lanes(d, n, m)))

    # K10's SHA3 over the window batch, fused and split, in place
    f, env, corpus, windows = SMOKE.sha3_batch(TEST_LIMITS, np.random.default_rng(6))
    want = ci.superstep_plain(f, env, corpus)
    fused, split = kernels.own_evm_fields(f), kernels.own_evm_fields(f)
    kernels.evm_step_call("superstep", k10host.step(lib), fused, env, corpus)
    SMOKE.split_step(k10host.step(lib), split, env, corpus)
    res["sha3"] = dict(
        windows=windows, M=TEST_LIMITS.mem_bytes,
        fused=sorted(k for k, e in SMOKE.frontier_errs(fused, want).items() if e),
        split=sorted(k for k, e in SMOKE.frontier_errs(split, want).items() if e),
        error=want.error.tolist(), pushed=ints(fused.stack[:, 0]),
        plain=ints(want.stack[:, 0]),
        ok=(~want.error & (want.sp == 1)).tolist(),
        ref=SMOKE.sha3_digests(f.memory.numpy(), windows))
    torch_port_child.dump(res, path)


def _jax(path):
    """Child process: the JAX package's ``keccak256_device`` and
    ``sha256_device``, each jitted once a shape."""
    import mythril_tpu  # noqa: F401  (x64)
    import jax
    import jax.numpy as jnp
    from mythril_tpu.ops.keccak import keccak256_device
    from mythril_tpu.ops.sha256 import sha256_device

    def ints(arr):
        arr = np.asarray(arr).astype(np.uint64)
        return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in arr]

    out = {}
    for name, (data, lens) in _inputs().items():
        fn = jax.jit(sha256_device if name.startswith("k4") else keccak256_device)
        out[name] = ints(fn(jnp.asarray(data), jnp.asarray(lens)))
    torch_port_child.dump(out, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    want, got = torch_port_child.run_pair("test_torch_hash_host", "_jax", "_torch",
                                          tmp_path_factory)
    return dict(jax=want, torch=got)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _lane(res, batch, i):
    got = res["torch"][batch]
    return got["host"][i], got["shifted"][i], got["plain"][i], res["jax"][batch][i], got["ref"][i]


@pytest.mark.parametrize("n", K2_LENGTHS)
def test_keccak_at_the_padding_edges(res, n):
    host, shifted, plain, jax, ref = _lane(res, "k2", K2_LENGTHS.index(n))
    assert host == shifted == plain == jax == ref


@pytest.mark.parametrize("i", range(len(CREATE2_LENGTHS)))
def test_keccak_create2_rows_of_85_bytes(res, i):
    """CREATE2's 85-byte rows: a row starts mid-word, and the buffer's last
    word straddles its end."""
    host, shifted, plain, jax, ref = _lane(res, "create2", i)
    assert host == shifted == plain == jax == ref


@pytest.mark.parametrize("batch", ["k2", "create2"])
def test_keccak_every_lane(res, batch):
    got = res["torch"][batch]
    assert got["host"] == got["shifted"] == got["plain"] == res["jax"][batch] == got["ref"]


@pytest.mark.parametrize("n", K4_LENGTHS)
def test_sha256_at_the_padding_edges(res, n):
    host, shifted, plain, jax, ref = _lane(res, "k4", K4_LENGTHS.index(n))
    assert host == shifted == plain == jax == ref


@pytest.mark.parametrize("batch", ["k4", "k4_odd"])
def test_sha256_every_lane(res, batch):
    """Every lane; ``k4_odd``'s 100-byte rows and the shifted buffers take
    the body's byte-wise reads, the 448-byte rows its 16-byte loads."""
    got = res["torch"][batch]
    assert got["host"] == got["shifted"] == got["plain"] == res["jax"][batch] == got["ref"]


def test_sha256_lane_mask(res):
    """K4's lane mask: the selected lanes' digests, zeros elsewhere; and
    ``sha256_lanes`` on a CPU tensor (the plain version over those lanes)."""
    want = [h if m else 0 for h, m in zip(res["torch"]["k4"]["ref"], _mask())]
    assert 0 < sum(_mask()) < len(want)
    assert res["torch"]["k4_mask"]["host"] == res["torch"]["k4_mask"]["lanes"] == want


@pytest.mark.parametrize("part", ["fused", "split"])
def test_k10_sha3_windows_equal_the_plain_step(res, part):
    r = res["torch"]["sha3"]
    assert not any(r["error"])
    assert r[part] == []


def test_k10_sha3_windows_push_the_host_keccak(res):
    r = res["torch"]["sha3"]
    assert all(r["ok"])
    assert r["pushed"] == r["plain"] == r["ref"]


def test_sha3_windows_reach_every_offset_and_the_row_end(res):
    """The window batch and the stress batch's scripted SHA3 lanes line up
    from every offset mod 8 and read up to the row's last byte."""
    r = res["torch"]["sha3"]
    M = r["M"]
    for windows in (r["windows"], [tuple(w) for op, w, _ in SMOKE._edge_cases(M, 16)
                                   if op == 0x20]):
        assert {off % 8 for off, n in windows if n and off < M} == set(range(8))
        assert {n for off, n in windows if off + n == M} >= {1, 136, 137, 200}
        assert any(off >> 63 and n for off, n in windows)
