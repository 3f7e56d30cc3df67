"""The port's ERC-20 transfer workload (``mythril_tpu_torch/workloads.py``)
against the JAX package's (``mythril_tpu/workloads.py``) at P = 8 and the
test limits: the same code, and the frontier, env and corpus equal field
for field. Its ``run`` against the JAX ``run`` of the same transfers: the
four transfer lanes of ``test_torch_interpreter``'s batch (whose JAX and
PyTorch children this module shares, so no program is compiled anew).
Each side works in its own child process (``torch_port_child``)."""

import dataclasses
import json
import os

import numpy as np
import pytest

import torch_port_child

P = 8
N_SHARED = 4  # transfer lanes of test_torch_interpreter's batch
MAX_STEPS = 192  # test_torch_interpreter's step budget
# fields that name the contract by its place in a corpus (the batch holds
# every VM vector before the token) or hold the batch's gas limit
BATCH_FIELDS = ("contract_id", "home_contract", "acct_addr", "acct_code", "gas_limit")


def _leaves(obj):
    return {fl.name: np.asarray(getattr(obj, fl.name)) for fl in dataclasses.fields(obj)
            if getattr(obj, fl.name) is not None}


def _jax_workload(path):
    """Child process: the JAX package's workload (no program compiled)."""
    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.workloads import erc20_transfer_workload

    code, f, env, corpus = erc20_transfer_workload(P, TEST_LIMITS)
    torch_port_child.dump({"code": code, "f": _leaves(f), "env": _leaves(env),
                           "corpus": _leaves(corpus)}, path)


def _torch_workload(path):
    """Child process: the port's workload, and its run."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core.interpreter import run
    from mythril_tpu_torch.workloads import erc20_transfer_workload

    code, f, env, corpus = erc20_transfer_workload(P, TEST_LIMITS)
    end = run(f, env, corpus, max_steps=MAX_STEPS)
    torch_port_child.dump({"code": code, "f": _leaves(f.to_numpy()),
                           "env": _leaves(env.to_numpy()), "corpus": _leaves(corpus.to_numpy()),
                           "end": _leaves(end.to_numpy())}, path)


@pytest.fixture(scope="module")
def workloads(tmp_path_factory):
    return torch_port_child.run_pair("test_torch_workloads", "_jax_workload",
                                     "_torch_workload", tmp_path_factory)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    want, got = torch_port_child.run_pair("test_torch_interpreter", "_jax_reference",
                                          "_torch_run", tmp_path_factory)
    return want["end"]


def _bad(want, got):
    return sorted(k for k in set(want) | set(got)
                  if k not in want or k not in got or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


def test_same_code(workloads):
    want, got = workloads
    assert got["code"] == want["code"]


@pytest.mark.parametrize("part", ["f", "env", "corpus"])
def test_workload_equals_the_jax_workload(workloads, part):
    want, got = workloads
    assert _bad(want[part], got[part]) == []


def test_run_equals_the_jax_run_of_the_same_transfers(workloads, batch):
    # transfer(0x1000 + i, 0) is lane i of the workload and lane
    # n_vectors + i of the batch
    end = workloads[1]["end"]
    n = next(iter(batch.values())).shape[0] - N_SHARED
    want = {k: v[n:] for k, v in batch.items() if k not in BATCH_FIELDS}
    got = {k: v[:N_SHARED] for k, v in end.items() if k not in BATCH_FIELDS}
    assert _bad(want, got) == []


def test_run_matches_the_pinned_step_counts(workloads):
    # tests/torch_port_fixtures.py pins the reference EVM's counts at the
    # bench width (chip_smoke.py phase 10 holds the card to them)
    end = workloads[1]["end"]
    with open(os.path.join(torch_port_child.HERE, "fixtures", "torch_port",
                           "erc20_transfer_steps.json")) as fh:
        pin = json.load(fh)
    assert end["n_steps"].tolist() == [pin["n_steps"]] * P
    assert end["halted"].all() and not end["error"].any() and not end["reverted"].any()
