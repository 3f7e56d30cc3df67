"""Fork planning and lane movement (kernel K7 on the card) and the engine
loop with fork blocks, berlin gas and the instruction profiler, on the
CPU against the JAX package, field for field:

- ``expand_forks`` for each of the seven policies, one block (0) and
  blocks of 8 and 16 lanes, dropping or deferring starved forks, on a
  seeded frontier with JUMPI and call-enumeration requests and profiler
  rows;
- ``rebalance_parked`` and ``migrate_parked_device`` on the layouts of
  the JAX package's ``tests/test_migrate.py`` and seeded random ones,
  with the profiler's rows conserved;
- one ``sym_run`` batch (four programs in 8-lane fork blocks, the
  coverage policy, spill, in-loop migration, the berlin schedule, the
  profiler attached).

Child processes as in ``test_torch_arith``."""

import numpy as np
import pytest

import torch_port_policies as tp


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return tp.runs(tmp_path_factory)


def _differing(want, got):
    return sorted(k for k in set(want) | set(got)
                  if k not in want or k not in got or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


def _hist_total(leaves):
    return int(leaves["base.op_hist"].sum()) + int(leaves["base.op_resid"].sum())


CASES = [(p, b, d) for p in tp.POLICIES for b in tp.BLOCKS for d in (False, True)]


@pytest.mark.parametrize("policy,block,defer", CASES,
                         ids=[f"{p}-B{b}-{'defer' if d else 'drop'}" for p, b, d in CASES])
def test_expand_forks_matches_jax(res, policy, block, defer):
    want = res["jax"]["forks"][policy, block, defer]
    got = res["engine"]["forks"][policy, block, defer]
    assert _differing(want, got) == []
    if not defer:  # fork copies move their slot's rows to the sidecar
        assert _hist_total(got) == res["jax"]["hist_totals"][tp.FORK_SEEDS[0]]


def test_policies_admit_different_forks(res):
    # the copies' sources (their pc is the source's fork target) differ
    copies = {p: res["jax"]["forks"][p, 0, False]["base.pc"].tobytes() for p in tp.POLICIES}
    assert len(set(copies.values())) > 2


MOVES = range(len(tp.migrate_cases()))


@pytest.mark.parametrize("case", MOVES)
def test_migrate_parked_device_matches_jax(res, case):
    want, got = res["jax"]["moves"][case]["migrate"], res["engine"]["moves"][case]["migrate"]
    assert _differing(want, got) == []
    assert _hist_total(got) == res["jax"]["hist_totals"][tp.FORK_SEEDS[1]]


@pytest.mark.parametrize("case", MOVES)
def test_rebalance_parked_matches_jax(res, case):
    want, got = res["jax"]["moves"][case], res["engine"]["moves"][case]
    assert got["moved"] == want["moved"]
    assert _differing(want["rebalance"], got["rebalance"]) == []
    assert _hist_total(got["rebalance"]) == res["jax"]["hist_totals"][tp.FORK_SEEDS[1]]


def test_lanes_move_between_blocks(res):
    assert res["jax"]["moves"][0]["moved"] == 1
    assert any(m["moved"] > 0 for m in res["jax"]["moves"][3:])
    act = [m["migrate"]["base.active"] for m in res["jax"]["moves"]]
    assert not np.array_equal(act[0], tp.migrate_cases()[0][0])


def test_engine_batch_matches_jax(res):
    want, got = res["jax"]["engine"], res["engine"]["engine"]
    assert _differing(want["half1"], got["half1"]) == []
    assert np.array_equal(want["vis1"], got["vis1"])


def test_engine_batch_exercises_berlin_and_the_profiler(res):
    h = res["jax"]["engine"]["half1"]
    assert h["base.op_hist"].sum() > 0
    assert h["base.st_warm"].any() and h["base.warm_acct"].sum() > 2 * len(h["base.pc"])
    # cold surcharges on symbolic keys/addresses widen the gas interval
    assert np.any(h["base.gas_max"] > h["base.gas_min"])
