"""The PyTorch concrete interpreter's ``run`` against the JAX package's
``core.run``, field for field: every consensus-style VM vector of
``tests/fixtures/vmtests.json`` plus the ERC-20 transfer workload's
lanes, as ONE batched frontier (one XLA compile).

Both sides build their frontier from the same numpy inputs with their own
``make_frontier``/``Corpus``/``make_env``, each in its own child process
(``torch_port_child``), the two running at the same time."""

import dataclasses
import json
import os

import numpy as np
import pytest

import torch_port_child
from mythril_tpu_torch.config import TEST_LIMITS
from mythril_tpu_torch.disassembler.asm import abi_call, erc20_like

_FIXTURE = os.path.join(torch_port_child.HERE, "fixtures", "vmtests.json")
N_TRANSFER = 4
# the JAX package's erc20_transfer_workload: transfer(to, 0) from this caller
TRANSFER_SELECTOR = 0xA9059CBB
BENCH_CALLER = 0xDEADBEEF
MAX_STEPS = 192


def _inputs():
    """(names, codes, calldata, calldata_len, contract_id, gas_limit) for
    every VM vector (one lane each) plus N_TRANSFER lanes of transfer(to, 0)
    on the hand-assembled ERC-20."""
    with open(_FIXTURE) as fh:
        doc = json.load(fh)
    vectors = doc["tests"]
    names = sorted(vectors)
    L = TEST_LIMITS
    P = len(names) + N_TRANSFER
    codes = [bytes.fromhex(vectors[n]["exec"]["code"]) for n in names] + [erc20_like()]
    calldata = np.zeros((P, L.calldata_bytes), np.uint8)
    cd_len = np.zeros(P, np.int32)
    blobs = [bytes.fromhex(vectors[n]["exec"].get("data", "")) for n in names]
    blobs += [abi_call(TRANSFER_SELECTOR, 0x1000 + i, 0) for i in range(N_TRANSFER)]
    for i, blob in enumerate(blobs):
        calldata[i, :len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        cd_len[i] = len(blob)
    cid = np.concatenate([np.arange(len(names)), np.full(N_TRANSFER, len(names))])
    return names, codes, calldata, cd_len, cid.astype(np.int32), doc["gasLimit"]


def _leaves(f):
    return {fl.name: np.asarray(getattr(f, fl.name)) for fl in dataclasses.fields(f)
            if getattr(f, fl.name) is not None}


def _jax_reference(path):
    """Child process: the batch through the JAX package."""
    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.config import TEST_LIMITS as L
    from mythril_tpu.core import Corpus, make_env, make_frontier
    from mythril_tpu.core.interpreter import run
    from mythril_tpu.disassembler import ContractImage

    names, codes, calldata, cd_len, cid, gas = _inputs()
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, L.max_code) for c in codes])
    f = make_frontier(len(cid), L, contract_id=cid, calldata=calldata, calldata_len=cd_len,
                      gas_limit=gas, n_contracts=len(codes), caller=BENCH_CALLER)
    end = run(f, make_env(len(cid)), corpus, max_steps=MAX_STEPS)
    torch_port_child.dump({"start": _leaves(f), "end": _leaves(end)}, path)


def _torch_run(path):
    """Child process: the batch through the PyTorch port."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.core import Corpus, make_env, make_frontier
    from mythril_tpu_torch.core.interpreter import run
    from mythril_tpu_torch.disassembler import ContractImage

    names, codes, calldata, cd_len, cid, gas = _inputs()
    L = TEST_LIMITS
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, L.max_code) for c in codes])
    f = make_frontier(len(cid), L, contract_id=cid, calldata=calldata, calldata_len=cd_len,
                      gas_limit=gas, n_contracts=len(codes), caller=BENCH_CALLER)
    end = run(f, make_env(len(cid)), corpus, max_steps=MAX_STEPS)
    torch_port_child.dump({"start": _leaves(f.to_numpy()), "end": _leaves(end.to_numpy())},
                          path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want, got = torch_port_child.run_pair("test_torch_interpreter", "_jax_reference",
                                          "_torch_run", tmp_path_factory)
    return dict(n_vectors=len(_inputs()[0]), start=(want["start"], got["start"]),
                end=(want["end"], got["end"]))


def _assert_equal(want, got):
    bad = sorted(k for k in set(want) | set(got)
                 if k not in want or k not in got or got[k].dtype != want[k].dtype
                 or not np.array_equal(got[k], want[k]))
    assert not bad, f"fields differ from the JAX run: {bad}"


def test_make_frontier_matches_jax(runs):
    _assert_equal(*runs["start"])


def test_vmtests_and_erc20_transfers_match_jax(runs):
    _assert_equal(*runs["end"])


def test_erc20_transfers_succeed(runs):
    end = runs["end"][1]
    lanes = slice(runs["n_vectors"], None)
    assert end["halted"][lanes].all() and not end["error"][lanes].any()
    assert not end["reverted"][lanes].any()
