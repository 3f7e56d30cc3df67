"""The PyTorch symbolic engine against the JAX package's, field for
field: the whole ``SymFrontier`` after each transaction's chunked
``sym_run`` (spill, propagation, forks, hash-consed tape) and after
``between_txs``, on ten fixtures run as five two-contract batches at the
goldens' settings (test limits, 16 lanes per contract, 192 steps, two
transactions); for the [erc20full, erc721] batch also the issues and the
coverage block.

Each package runs in its own child process (``torch_port_child``), the
two at the same time; every batch has one shape, so the JAX child
compiles ``sym_run`` once."""

import dataclasses
import os

import numpy as np
import pytest

import torch_port_child
from mythril_tpu_torch.disassembler.asm import assemble

REALWORLD = os.path.join(torch_port_child.HERE, "fixtures", "realworld")
COVERAGE_KEYS = ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
                 "lanes_errored", "lanes_lost_to_caps", "instruction_coverage_pct",
                 "rebalanced_lanes", "saturated_call_logs", "saturated_arith_logs")


def _realworld(name):
    with open(os.path.join(REALWORLD, f"{name}.bin-runtime")) as fh:
        return bytes.fromhex(fh.read().strip().removeprefix("0x"))


def _cd(off):
    return [off, "CALLDATALOAD"]


def _forks():
    out = []
    for i in range(6):
        out += [*_cd(4), 1 << i, "AND", ("ref", f"l{i}"), "JUMPI", ("label", f"l{i}")]
    return out + [1, 0, "SSTORE", "STOP"]


def _storage_cap():
    out = []
    for i in range(20):  # more keys than the 16 storage slots of the test limits
        out += [i, *_cd(4 + 32 * (i % 3)), "ADD", "SSTORE"]
    return out + ["STOP"]


FIXTURES = {
    # solc ERC-20/721: SHA3 mapping keys, DIV selector dispatch, storage
    "erc20full": lambda: _realworld("erc20full"),
    "erc721": lambda: _realworld("erc721"),
    # symbolic MUL/EXP/SDIV/SMOD/ADDMOD/SIGNEXTEND/BYTE/SAR/NOT nodes
    "sym_arith": lambda: assemble(
        *_cd(4), *_cd(36), "MUL", *_cd(68), "EXP", 0, "SSTORE",
        *_cd(4), *_cd(36), "SDIV", 1, "SSTORE", *_cd(4), 7, "SMOD", 2, "SSTORE",
        *_cd(4), *_cd(36), *_cd(68), "ADDMOD", 3, "SSTORE", *_cd(4), 3, "SIGNEXTEND", 4,
        "SSTORE", *_cd(4), 5, "BYTE", 5, "SSTORE", *_cd(4), 3, "SAR", 6, "SSTORE",
        *_cd(4), "NOT", "ISZERO", 7, "SSTORE", "STOP"),
    # the concrete 256/512-step handlers: EXP, MULMOD, ADDMOD, SDIV overflow
    "conc_arith": lambda: assemble(
        0xFFFFFFFFFFFF1234, 0xABCDEF, "MUL", 3, "EXP", 0, "SSTORE",
        7, 0xFFFF, (1 << 200) + 5, "MULMOD", 1, "SSTORE",
        7, (1 << 255) + 3, (1 << 255) + 9, "ADDMOD", 2, "SSTORE",
        1 << 255, (1 << 256) - 1, "SDIV", 3, "SSTORE", 1, 0x80, "SIGNEXTEND", 4, "SSTORE",
        31, 0xAB, "BYTE", 5, "SSTORE", 4, 1 << 255, "SAR", 6, "SSTORE", "STOP"),
    # symbolic-offset MLOAD/MSTORE/SHA3/LOG/RETURN (the claimed misc handler)
    "sym_offsets": lambda: assemble(
        *_cd(4), "MLOAD", 1, "SSTORE", 5, *_cd(36), "MSTORE", 0, "MLOAD", 2, "SSTORE",
        *_cd(68), 0, "SHA3", 3, "SSTORE", 1, 2, *_cd(100), 0, "LOG1",
        *_cd(4), ("ref", "r"), "JUMPI", 32, *_cd(36), "RETURN", ("label", "r"),
        0, 0, "SSTORE", "STOP"),
    # CALLDATACOPY/CODECOPY/RETURNDATACOPY/EXTCODECOPY, unaligned memory
    "copies": lambda: assemble(
        64, 0, 0, "CALLDATACOPY", 0, "MLOAD", 1, "SSTORE", 32, 3, 64, "CODECOPY",
        64, "MLOAD", 2, "SSTORE", 0, 0, 96, "RETURNDATACOPY", 20, 0, 128, 0xAFFE,
        "EXTCODECOPY", 128, "MLOAD", 3, "SSTORE", 66, 5, 7, "CALLDATACOPY", 0, "MLOAD",
        4, "SSTORE", *_cd(4), 33, "MSTORE", 32, "MLOAD", 5, "SSTORE", *_cd(36), 7,
        "MSTORE8", 0, "MLOAD", 6, "SSTORE", "STOP"),
    # environment leaves and havocs, LOG0-LOG4 records
    "env_logs": lambda: assemble(
        "ADDRESS", "BALANCE", "ORIGIN", "ADD", "CALLER", "ADD", "CALLVALUE", "ADD",
        "CALLDATASIZE", "ADD", "CODESIZE", "ADD", "GASPRICE", "ADD", 0xAFFE, "EXTCODESIZE",
        "ADD", 0xAFFE, "EXTCODEHASH", "ADD", 1, "BLOCKHASH", "ADD", "TIMESTAMP", "ADD",
        "NUMBER", "ADD", "SELFBALANCE", "ADD", *_cd(4), "BALANCE", "ADD", "PC", "ADD",
        0, "SSTORE", *_cd(4), 0, "MSTORE", 32, 0, "LOG0", 1, 32, 0, "LOG1",
        1, 2, 3, 4, 32, 0, "LOG4", "STOP"),
    # more forks than free lanes (deferred forks), and a full storage cache
    "forks": lambda: assemble(*_forks()),
    "storage_cap": lambda: assemble(*_storage_cap()),
    "swc101_guarded_add": lambda: assemble(
        4, "CALLDATALOAD", ("push1", 100), "SWAP1", "GT", ("ref", "bad"), "JUMPI",
        0, "SLOAD", 4, "CALLDATALOAD", "ADD", 0, "SSTORE", "STOP",
        ("label", "bad"), 0, 0, "REVERT"),
}
BATCHES = {
    "realworld": ("erc20full", "erc721"),
    "arith": ("sym_arith", "conc_arith"),
    "memory": ("sym_offsets", "copies"),
    "pressure": ("forks", "env_logs"),
    "storage": ("storage_cap", "swc101_guarded_add"),
}
KW = dict(lanes_per_contract=16, max_steps=192, transaction_count=2)


def _issue_rows(issues):
    return sorted((i.contract, i.swc_id, i.address, i.title, i.severity) for i in issues)


def _leaves(sf, prefix=""):
    out = {}
    for fl in dataclasses.fields(sf):
        v = getattr(sf, fl.name)
        if fl.name == "base":
            out.update(_leaves(v, "base."))
        elif v is not None:
            out[prefix + fl.name] = np.asarray(v)
    return out


def _jax_reference(path):
    """Child process: every batch through the JAX package."""
    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.symbolic.engine import between_txs

    out = {}
    for batch, names in sorted(BATCHES.items()):
        w = SymExecWrapper([FIXTURES[n]() for n in names], contract_names=list(names),
                           limits=TEST_LIMITS, **KW)
        out[batch] = {
            "txs": [_leaves(c.sf) for c in w.tx_contexts],
            "trap_counts": [c.trap_counts for c in w.tx_contexts],
            "between": _leaves(between_txs(w.tx_contexts[0].sf)),
            "visited": np.asarray(w._visited),
        }
        if batch == "realworld":
            report = fire_lasers(w)
            out[batch]["issues"] = _issue_rows(report.issues)
            out[batch]["coverage"] = {k: report.coverage[k] for k in COVERAGE_KEYS}
    torch_port_child.dump(out, path)


def _torch_run(path):
    """Child process: every batch through the PyTorch port; ``between``
    is the port's ``between_txs`` of its own first-transaction snapshot."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.symbolic import SymFrontier, between_txs

    out = {}
    for batch, names in sorted(BATCHES.items()):
        w = SymExecWrapper([FIXTURES[n]() for n in names], contract_names=list(names),
                           limits=TEST_LIMITS, device="cpu", **KW)
        tx0 = SymFrontier.from_numpy(w.tx_contexts[0].sf, "cpu")
        out[batch] = {
            "txs": [_leaves(c.sf) for c in w.tx_contexts],
            "trap_counts": [c.trap_counts for c in w.tx_contexts],
            "between": _leaves(between_txs(tx0).to_numpy()),
            "visited": w.visited,
        }
        if batch == "realworld":
            report = fire_lasers(w)
            out[batch]["issues"] = _issue_rows(report.issues)
            out[batch]["coverage"] = {k: report.coverage[k] for k in COVERAGE_KEYS}
    torch_port_child.dump(out, path)


def _differing(want, got):
    return sorted(k for k in set(want) | set(got)
                  if k not in want or k not in got or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_port_child.run_pair("test_torch_engine", "_jax_reference", "_torch_run",
                                     tmp_path_factory)


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_frontier_after_each_transaction_matches_jax(runs, batch):
    want, got = runs
    assert len(got[batch]["txs"]) == len(want[batch]["txs"]) == 2
    for tx in range(2):
        assert _differing(want[batch]["txs"][tx], got[batch]["txs"][tx]) == [], f"tx {tx}"
    assert got[batch]["trap_counts"] == want[batch]["trap_counts"]


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_between_txs_matches_jax(runs, batch):
    want, got = runs
    assert _differing(want[batch]["between"], got[batch]["between"]) == []


def test_coverage_bitmap_matches_jax(runs):
    want, got = runs
    assert np.array_equal(want["realworld"]["visited"], got["realworld"]["visited"])


def test_realworld_batch_issues_match_jax(runs):
    want, got = runs
    assert got["realworld"]["issues"] == want["realworld"]["issues"]


def test_realworld_batch_coverage_matches_jax(runs):
    want, got = runs
    assert got["realworld"]["coverage"] == want["realworld"]["coverage"]
