"""Call frames and creation transactions on the CPU: the PyTorch
analyzer against the JAX package.

- the six golden fixtures with CALL/DELEGATECALL, issue for issue
  against ``tests/fixtures/goldens``;
- the real-world batch (EIP-1167 proxy, ERC-20, ERC-721, multisig) and
  BASELINE config 4 (creation tx + frames at call depth 3) at the limits
  of ``test_realworld.py`` / ``test_config4.py``, against their pinned
  goldens (no JAX run);
- one batch of CALL/CREATE programs (the shapes of ``test_calls.py`` and
  ``test_creation.py``) after ``sym_run``, field for field against the
  JAX frontier. The batch also holds ``test_torch_precompiles``'s
  programs, so the two modules share one JAX engine compile
  (``torch_port_batch``).

The PyTorch and JAX work runs in child processes (``torch_port_child``),
side by side; the tests compare what they pickled.
"""

import dataclasses
import json
import os

import pytest

import torch_port_batch
import torch_port_child
from mythril_tpu_torch.disassembler.asm import assemble
from torch_port_fixtures import config4_system, precompiles_files, read_hex, realworld_system

HERE = torch_port_child.HERE
GOLDEN_DIR = os.path.join(HERE, "fixtures", "goldens")
CALL_GOLDENS = ["swc104_checked", "swc105_drain", "swc107_sstore_after_call",
                "swc112_deleg_user", "swc113_multi_send", "swc116_timestamp"]


def _issue_key(d):
    return {"contract": d["contract"], "swc-id": d["swc-id"], "address": d["address"],
            "title": d["title"], "severity": d["severity"]}


def _sorted(issue_dicts, by_contract=False):
    key = ((lambda d: (d["contract"], d["swc-id"], d["address"], d["title"])) if by_contract
           else (lambda d: (d["swc-id"], d["address"], d["title"])))
    return sorted((_issue_key(d) for d in issue_dicts), key=key)


# ---------------------------------------------------------------------------
# the CALL/CREATE batch: each program is a caller at an even corpus index
# whose partner (a callee, or an image a factory deploys) sits next to it
# ---------------------------------------------------------------------------


def _addr(i):
    return 0xAFFE + 0x10000 * i  # core.frontier.contract_address


def _call(op, to, value=0, args=(0, 0), ret=(0, 32), gas=50_000):
    vals = [value] if op in ("CALL", "CALLCODE") else []
    return [ret[1], ret[0], args[1], args[0], *vals, ("push3", to), ("push2", gas), op]


_CHILD_RUNTIME = assemble(0x42, 5, "SSTORE", "STOP")
_CHILD_INIT_EMPTY = assemble(1, 0, "SSTORE", 0, 0, "RETURN")
_CHILD_INIT_DEPLOY = assemble(("push6", int.from_bytes(_CHILD_RUNTIME, "big")), 0, "MSTORE",
                              6, 26, "RETURN")


def _init_push(init):
    return [("push" + str(len(init)), int.from_bytes(init, "big")), 0, "MSTORE"]


def _programs():
    """name -> (caller(partner_addr) -> bytes, partner bytes)."""
    attacker = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
    n_ed = len(_CHILD_INIT_EMPTY)
    n_dp = len(_CHILD_INIT_DEPLOY)
    return {
        "returndata": (lambda a: assemble(*_call("CALL", a), 1, "SSTORE", 0, "MLOAD", 2,
                                          "SSTORE", "RETURNDATASIZE", 3, "SSTORE", "STOP"),
                       assemble(42, 0, "MSTORE", 32, 0, "RETURN")),
        "revert_rollback": (lambda a: assemble(*_call("CALL", a, value=1000), 1, "SSTORE",
                                               "STOP"),
                            assemble(11, 7, "SSTORE", 0, 0, "REVERT")),
        "invalid_callee": (lambda a: assemble(*_call("CALL", a), 1, "SSTORE", "STOP"),
                           assemble(5, 5, "SSTORE", "INVALID")),
        "delegate": (lambda a: assemble(*_call("DELEGATECALL", a, ret=(0, 32)), "POP",
                                        *_call("CALLCODE", a, value=5), "POP", "STOP"),
                     assemble("CALLER", 9, "SSTORE", "CALLVALUE", 8, "SSTORE", "STOP")),
        "static": (lambda a: assemble(*_call("STATICCALL", a), 1, "SSTORE", "STOP"),
                   assemble(5, 9, "SSTORE", "STOP")),
        "sym_fork_in_callee": (
            lambda a: assemble(0, "CALLDATALOAD", 0, "MSTORE",
                               *_call("CALL", a, args=(0, 32)), 1, "SSTORE", "STOP"),
            assemble(0, "CALLDATALOAD", ("ref", "ok"), "JUMPI", 0, 0, "REVERT",
                     ("label", "ok"), 1, 8, "SSTORE", 64, 0, "RETURN")),
        "eoa_unknown_symbolic": (
            lambda a: assemble(0, 0, 0, 0, 1000, ("push32", attacker), ("push2", 50000),
                               "CALL", "POP", "SELFBALANCE", 2, "SSTORE",
                               0, 0, 0, 0, 0, ("push3", 0xEEEEEE), ("push2", 50000), "CALL",
                               ("ref", "y"), "JUMPI", 1, 1, "SSTORE",
                               ("label", "y"), 0, 0, 0, 0, 0, 4, "CALLDATALOAD",
                               ("push2", 50000), "CALL", 3, "SSTORE", "STOP"),
            assemble(0, "SELFDESTRUCT")),
        "create_frame": (lambda a: assemble(*_init_push(_CHILD_INIT_EMPTY), n_ed, 32 - n_ed,
                                            7, "CREATE", 1, "SSTORE",
                                            0, 0, 0, "CREATE", 2, "SSTORE", "STOP"),
                         assemble("STOP")),
        "create_deploy_call": (lambda a: assemble(0, 0, 0, 0, 0, *_init_push(_CHILD_INIT_DEPLOY),
                                                  n_dp, 32 - n_dp, 0, "CREATE",
                                                  ("push2", 60000), "CALL", "POP", "STOP"),
                               _CHILD_RUNTIME),
        "create2_revert": (lambda a: assemble(*_init_push(_CHILD_INIT_EMPTY), ("push2", 0x1234),
                                              n_ed, 32 - n_ed, 0, "CREATE2", 1, "SSTORE",
                                              *_init_push(assemble(0, 0, "REVERT")), 0x1234,
                                              5, 27, 0, "CREATE2", 2, "SSTORE", "STOP"),
                           assemble("STOP")),
    }


LANES = 4  # per program


def frame_images():
    """Caller and partner of each program, in name order."""
    images = []
    for i, (_, (caller, partner)) in enumerate(sorted(_programs().items())):
        images += [caller(_addr(2 * i + 1)), partner]
    return images


def _torch_run(path):
    """Child process: the goldens and the pinned batches through the
    PyTorch port."""
    torch_port_child.torch_single_thread()
    from test_goldens import _fixtures

    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import TEST_LIMITS

    res = {}
    for name in CALL_GOLDENS:
        code, fkw = _fixtures()[name]
        sym = SymExecWrapper([code], device="cpu", limits=TEST_LIMITS, lanes_per_contract=16,
                             max_steps=192, **fkw)
        res["golden", name] = _sorted(i.as_dict() for i in fire_lasers(sym.ctx).issues)

    system = realworld_system()
    sym = SymExecWrapper([c for _, c in system], contract_names=[n for n, _ in system],
                         limits=dataclasses.replace(TEST_LIMITS, max_accounts=8, call_depth=3,
                                                    max_code=1024),
                         lanes_per_contract=16, max_steps=192, transaction_count=2,
                         device="cpu")
    report = fire_lasers(sym)
    cov = report.coverage or {}
    res["realworld"] = {
        "issues": _sorted((i.as_dict() for i in report.issues), by_contract=True),
        "coverage": {k: cov.get(k) for k in ("surviving_paths", "dropped_forks")}
        | {"lanes_errored": cov.get("lanes_errored", {})}}

    system = config4_system()
    sym = SymExecWrapper([r for _, _, r in system], contract_names=[n for n, _, _ in system],
                         creation_bytecodes=[c for _, c, _ in system],
                         limits=dataclasses.replace(TEST_LIMITS, call_depth=4, max_accounts=6),
                         lanes_per_contract=16, max_steps=192, transaction_count=2,
                         device="cpu")
    res["config4"] = _sorted((i.as_dict() for i in fire_lasers(sym).issues), by_contract=True)
    res["config4_txs"] = len(sym.tx_contexts)
    # --create-timeout bounds the constructor run alone: the precompile
    # fixture's constructor outlives one chunk, so an expired creation
    # deadline cuts it there — and is not the run's own deadline
    creation, runtime = precompiles_files()
    sym = SymExecWrapper([read_hex(runtime)], creation_bytecodes=[read_hex(creation)],
                         create_timeout=0.0, limits=TEST_LIMITS, lanes_per_contract=16,
                         max_steps=384, transaction_count=2, device="cpu")
    res["create_timeout"] = ([c.timed_out for c in sym.tx_contexts], sym.timed_out)
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """This module's PyTorch results; its child runs beside the batch's."""
    def compute():
        path = tmp_path_factory.mktemp("frames") / "out.pkl"
        proc = torch_port_child.start("test_torch_frames", "_torch_run", path)
        torch_port_batch.runs(tmp_path_factory)
        return torch_port_child.finish(proc, path)

    return torch_port_child.once("test_torch_frames._torch_run", compute, tmp_path_factory)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """(JAX, PyTorch) results of the shared batch."""
    return tuple(r["batch"] for r in torch_port_batch.runs(tmp_path_factory))


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", CALL_GOLDENS)
def test_call_golden(runs, name):
    assert runs["golden", name] == _golden(name)


def test_realworld_issues_match_golden(runs):
    assert runs["realworld"]["issues"] == _golden("realworld")["issues"]


def test_realworld_coverage_matches_golden(runs):
    assert runs["realworld"]["coverage"] == _golden("realworld")["coverage"]


def test_config4_creation_and_frames_match_golden(runs):
    assert runs["config4_txs"] == 3  # creation tx + two message txs
    assert runs["config4"] == _golden("config4")


def test_create_timeout_bounds_the_constructor_only(runs):
    per_tx, overall = runs["create_timeout"]
    assert per_tx == [True] and overall is False


def test_config4_drain_found_through_three_frames(runs):
    assert any(d["contract"] == "Vault" and d["swc-id"] == "105" for d in runs["config4"])


def test_batch_programs_reach_frames():
    # the batch exercises every frame kind: no program is frame-free
    images = frame_images()
    from mythril_tpu_torch.disassembler.disassembly import Disassembly

    frame_ops = {0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xFA}
    callers = images[0::2]
    assert all(any(i.opcode in frame_ops for i in Disassembly(c).instruction_list)
               for c in callers)
    used = {i.opcode for c in callers for i in Disassembly(c).instruction_list}
    assert frame_ops <= used


@pytest.mark.parametrize("group", ["base", "sym"])
def test_batch_frontier_matches_jax_field_for_field(batch, group):
    want, got = batch
    lanes = torch_port_batch.frame_lanes(want)
    assert lanes.sum() > len(_programs())
    assert torch_port_batch.mismatched_fields(want, got, group, lanes) == []


def test_batch_took_frame_paths(batch):
    # sub-frames were pushed and popped (lanes are home again) and a
    # constructor ran: the comparison above covers the frame machinery
    got = batch[1]
    n_images = len(torch_port_batch.layout()[0])
    mine = torch_port_batch.frame_lanes(got)
    act = got["base.active"] & mine
    assert act.sum() > len(_programs())  # callee forks
    assert (got["base.depth"][act] == 0).all()
    assert (got["base.acct_used"][mine].sum(axis=1) > 2 + n_images).any()
