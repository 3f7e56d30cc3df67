"""The plain version of kernel K2 against the JAX package's batched
keccak and the host reference (exact), plus the card check (skipped
without CUDA). The work runs in a child process (``torch_port_child``)."""

import numpy as np
import pytest

import torch_port_child

LENGTHS = [0, 1, 31, 32, 64, 135, 136, 137, 199, 200]
EMPTY = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


def _messages(seed=3, extra=6, max_len=200):
    rng = np.random.default_rng(seed)
    lens = np.array(LENGTHS + list(rng.integers(0, max_len + 1, extra)), dtype=np.int32)
    data = rng.integers(0, 256, (len(lens), max_len), dtype=np.uint8)
    for i, n in enumerate(lens):
        data[i, n:] = 0
    return data, lens


def _compute(path):
    """Child process: the plain version, the JAX device keccak, the host
    reference, and (with a card) the kernel."""
    torch = torch_port_child.torch_single_thread()
    import mythril_tpu  # noqa: F401
    import jax.numpy as jnp
    from mythril_tpu.ops.keccak import keccak256_device as jax_keccak
    from mythril_tpu_torch.ops import keccak, u256

    data, lens = _messages()
    plain = keccak.keccak256_device(torch.as_tensor(data), torch.as_tensor(lens))
    out = {
        "plain": plain.numpy().astype(np.uint32),
        "jax": np.asarray(jax_keccak(jnp.asarray(data), jnp.asarray(lens))),
        "plain_ints": [u256.to_int(row) for row in plain.numpy()],
        "host_ints": [keccak.keccak256_host_int(bytes(data[i, :n]))
                      for i, n in enumerate(lens)],
        "empty": keccak.keccak256_host(b"").hex(),
        "cuda": None,
    }
    if torch.cuda.is_available():
        from mythril_tpu_torch import kernels

        data, lens = _messages(extra=200)
        d, n = torch.as_tensor(data, device="cuda"), torch.as_tensor(lens, device="cuda")
        out["cuda"] = bool(torch.equal(kernels.keccak256(d, n), keccak.keccak256_plain(d, n)))
    torch_port_child.dump(out, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_keccak", "_compute", tmp_path_factory)


def test_plain_matches_jax_device_keccak(res):
    np.testing.assert_array_equal(res["plain"], res["jax"])


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_matches_host_keccak(res, n):
    i = LENGTHS.index(n)
    assert res["plain_ints"][i] == res["host_ints"][i]


def test_host_known_vector(res):
    assert res["empty"] == EMPTY


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(res):
    if res["cuda"] is None:
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert res["cuda"]
