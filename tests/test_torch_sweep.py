"""The feasibility sweep (kernel K6 on the card) on the CPU against the
JAX package's ``propagate_feasibility``, field for field (the masking of
``kill_infeasible`` runs inside the engine batch of ``test_torch_forks``):
on seeded random tapes holding every op (NULL rows, clipped and
FREE-kind operands, random starting domains and constraints), and on the
real frontier of the engine batch of ``torch_port_policies`` taken with
nodes no sweep has seen yet. Child processes as in ``test_torch_arith``."""

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


def test_sweep_of_random_tapes_matches_jax(res):
    want, got = res["jax"]["sweep"], res["engine"]["sweep"]
    assert _differing(want["frontier"], got["frontier"]) == []
    assert np.array_equal(got["infeasible"], want["infeasible"])
    # the inputs decide both ways
    assert 0 < int(want["infeasible"].sum()) < len(want["infeasible"])


def test_sweep_of_a_real_frontier_matches_jax(res):
    want, got = res["jax"]["engine"], res["engine"]["engine"]
    assert _differing(want["swept"], got["swept"]) == []
    assert np.array_equal(got["infeasible"], want["infeasible"])
    # the snapshot held nodes the last sweep had not seen
    h1 = want["half1"]
    assert np.any(h1["prop_len"] < h1["tape_len"])
