"""Fork planning and lane movement (kernel K7 on the card) and the engine
loop with fork blocks, berlin gas and the instruction profiler, on the
CPU against the JAX package, field for field:

- ``expand_forks`` for each of the seven policies, one block (0) and
  blocks of 8 and 16 lanes, dropping or deferring starved forks, on a
  seeded frontier with JUMPI and call-enumeration requests and profiler
  rows, the input unchanged; the in-place route (``expand_forks_inplace``
  through one descriptor, as ``sym_run`` runs it) equal to the plain
  functional route on each of those cases and on bounded-loops tables
  that backward copies hit, fill and overflow; the descriptor's
  ownership checks (shared memory raises, an expanded view is copied);
- ``rebalance_parked`` and ``migrate_parked_device`` on the layouts of
  the JAX package's ``tests/test_migrate.py`` and seeded random ones,
  with the profiler's rows conserved;
- one ``sym_run`` batch (four programs in 8-lane fork blocks, the
  coverage policy, spill, in-loop migration, the berlin schedule, the
  profiler attached), its input unchanged.

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


@pytest.mark.parametrize("policy,block,defer", CASES,
                         ids=[f"{p}-B{b}-{'defer' if d else 'drop'}" for p, b, d in CASES])
def test_inplace_route_matches_functional_route(res, policy, block, defer):
    # the route sym_run takes (one descriptor over every case) and the
    # public expand_forks, each against the plain functional gather
    assert res["engine"]["fork_routes"][policy, block, defer] == ([], [])


def test_expand_forks_leaves_its_input_unchanged(res):
    assert res["engine"]["forks_held"] == []


LB_CASES = [(p, d) for p in tp.POLICIES for d in (False, True)]


@pytest.mark.parametrize("policy,defer", LB_CASES,
                         ids=[f"{p}-{'defer' if d else 'drop'}" for p, d in LB_CASES])
def test_inplace_route_keeps_the_loop_tables(res, policy, defer):
    r = res["engine"]["forks_lb"][policy, defer]
    assert r["bad"] == []


def test_loop_table_cases_reach_every_path(res):
    # over the policies, backward copies hit an entry, add one, reuse a
    # full table's coldest slot, and retire a lane past the bound
    lb = res["engine"]["forks_lb"].values()
    assert all(sum(r[k] for r in lb) > 0 for k in ("hit", "grown", "cold", "trapped"))


def test_fork_descriptor_owns_its_fields(res):
    alias = res["engine"]["k7_alias"]
    assert alias is not None and "callvalue_sym" in alias and "caller_sym" in alias
    bad, contiguous, copied = res["engine"]["k7_view"]
    assert bad == [] and contiguous and copied


def test_sym_run_leaves_its_input_unchanged(res):
    assert res["engine"]["engine"]["held"] == []


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
