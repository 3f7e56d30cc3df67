"""One ``sym_run`` batch for the port's frame and precompile tests.

The CALL/CREATE programs of ``test_torch_frames`` (caller and partner at
corpus indices 2i, 2i+1) come first, the precompile programs of
``test_torch_precompiles`` after them, at one set of limits and one step
count: the JAX reference compiles its engine once for both modules. The
same two children also run the plain versions of kernels K4 and K5
(``sha256_plain``, ``modexp_plain``) and their JAX counterparts.
"""

import dataclasses

import numpy as np

import torch_port_child

STEPS = 160
SPARE_ACCOUNTS = 4  # room for the accounts the factories create


def layout():
    """-> (images, contract id per lane, active per lane, number of frame
    images, first lane of the precompile programs)."""
    from test_torch_frames import LANES as FL, frame_images
    from test_torch_precompiles import LANES as PL, precompile_images

    frames, pre = frame_images(), precompile_images()
    images = frames + pre
    n_callers = len(frames) // 2
    cid = np.concatenate([np.repeat(np.arange(0, len(frames), 2, dtype=np.int32), FL),
                          np.repeat(np.arange(len(frames), len(images), dtype=np.int32), PL)])
    active = np.zeros(len(cid), dtype=bool)
    active[:n_callers * FL:FL] = True
    active[n_callers * FL::PL] = True
    return images, cid, active, len(frames), n_callers * FL


def batch_limits(base, n_images):
    # every program's partner resolves through the account table
    return dataclasses.replace(base, max_accounts=2 + n_images + SPARE_ACCOUNTS, call_depth=3)


def leaves(sf, prefix=""):
    out = {}
    for fl in dataclasses.fields(sf):
        v = getattr(sf, fl.name)
        if fl.name == "base":
            out.update(leaves(v, "base."))
        elif v is not None:
            out[prefix + fl.name] = np.asarray(v)
    return out


def frame_lanes(want):
    """Lanes of the frame programs (by the JAX run's contract id); the
    other lanes are the precompile programs'. Each module compares its own
    lanes, so together they compare every lane once."""
    return want["base.contract_id"] < layout()[3]


def mismatched_fields(want, got, group, lanes):
    """Fields of ``group`` ("base" or "sym") that differ in name, dtype,
    shape or value on ``lanes`` (a lane mask; scalar fields whole)."""
    def differ(k):
        w, g = want[k], got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            return True
        return not (np.array_equal(g, w) if w.ndim == 0 else np.array_equal(g[lanes], w[lanes]))

    keys = sorted(k for k in set(want) | set(got) if k.startswith("base.") == (group == "base"))
    return [k for k in keys if k not in want or k not in got or differ(k)]


def _jax_reference(path):
    """Child process: the batch, ``sha256_device`` and ``modexp`` through JAX."""
    import jax.numpy as jnp

    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.core import Corpus, make_env
    from mythril_tpu.disassembler import ContractImage
    from mythril_tpu.ops import u256
    from mythril_tpu.ops.callbacks import host_callbacks_supported
    from mythril_tpu.ops.sha256 import sha256_device
    from mythril_tpu.symbolic import SymSpec, make_sym_frontier, sym_run
    from test_torch_precompiles import modexp_inputs, sha_inputs

    images, cid, active, _, _ = layout()
    L = batch_limits(TEST_LIMITS, len(images))
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, L.max_code) for c in images])
    sf = make_sym_frontier(len(cid), L, contract_id=cid, active=active, n_contracts=len(images))
    sf = sym_run(sf, make_env(len(cid)), corpus, SymSpec(), L, max_steps=STEPS)
    data, lens = sha_inputs()
    b, e, m = modexp_inputs()
    torch_port_child.dump({
        "batch": leaves(sf),
        "sha": np.asarray(sha256_device(jnp.asarray(data), jnp.asarray(lens))),
        "modexp": np.asarray(u256.modexp(jnp.asarray(b), jnp.asarray(e), jnp.asarray(m))),
        "cb_ok": host_callbacks_supported(),
    }, path)


def _torch_reference(path):
    """Child process: the same through the PyTorch port on the CPU."""
    torch = torch_port_child.torch_single_thread()
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import Corpus, make_env
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.ops import u256
    from mythril_tpu_torch.ops.sha256 import sha256_plain
    from mythril_tpu_torch.symbolic import SymSpec, make_sym_frontier, sym_run
    from test_torch_precompiles import modexp_inputs, sha_inputs

    images, cid, active, _, _ = layout()
    L = batch_limits(TEST_LIMITS, len(images))
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, L.max_code) for c in images])
    sf = make_sym_frontier(len(cid), L, contract_id=cid, active=active, n_contracts=len(images))
    sf = sym_run(sf, make_env(len(cid)), corpus, SymSpec(), L, max_steps=STEPS)
    data, lens = sha_inputs()
    b, e, m = (torch.as_tensor(x.astype(np.int64)) for x in modexp_inputs())
    torch_port_child.dump({
        "batch": leaves(sf.to_numpy()),
        "sha": sha256_plain(torch.as_tensor(data), torch.as_tensor(lens)).numpy()
        .astype(np.uint32),
        "modexp": u256.modexp_plain(b, e, m).numpy().astype(np.uint32),
    }, path)


def runs(tmp_path_factory):
    """(JAX results, PyTorch results), computed once per test session."""
    return torch_port_child.run_pair("torch_port_batch", "_jax_reference", "_torch_reference",
                                     tmp_path_factory)
