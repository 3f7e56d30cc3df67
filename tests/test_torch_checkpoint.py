"""Frontier checkpoints and plugin discovery in the port, on the CPU:

- the JAX package's ``save_frontier`` npz of the engine batch of
  ``torch_port_policies`` loads into the port field for field, and the
  batch's second half resumed from it equals the JAX run's;
- the port's ``save_frontier`` of that frontier writes the JAX npz's
  arrays again; a torn newest file is caught and the rotated copy loads;
- a checkpointed arith run resumed mid-transaction from its rotated
  ``frontier.npz.1`` gives the JAX report of the uninterrupted run;
- ``--checkpoint-dir`` is the campaign's flag, as in the JAX CLI: a
  single-contract ``analyze`` with it writes nothing and reports the same;
- ``--plugin-dir`` loads a detection module and a laser plugin.

Child processes as in ``test_torch_arith``."""

import json
import os

import numpy as np
import pytest

import torch_port_policies as tp
from torch_port_fixtures import FIXTURE_DIR


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return tp.runs(tmp_path_factory)


def _differing(want, got):
    return sorted(k for k in set(want) | set(got)
                  if k not in want or k not in got or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


def test_port_loads_the_jax_checkpoint(res):
    assert _differing(res["jax"]["engine"]["half1"], res["resume"]["loaded"]) == []
    assert res["resume"]["meta"] == {"tx": 0, "steps_done": tp.ENGINE_STEPS}


def test_resume_from_the_jax_checkpoint_matches_jax(res):
    assert _differing(res["jax"]["engine"]["half2"], res["resume"]["half2"]) == []
    assert np.array_equal(res["jax"]["engine"]["vis2"], res["resume"]["vis2"])


def _issues(doc):
    return sorted((d["contract"], d["swc-id"], d["address"], d["title"]) for d in doc["issues"])


def test_resumed_run_report_matches_jax(res):
    assert "frontier.npz.1" in res["cli_b"]["ckpt_files"]
    got = res["cli_b"]["resumed"]
    with open(os.path.join(FIXTURE_DIR, "arith_bfs_test.json")) as fh:
        want = json.load(fh)
    assert _issues(got) == _issues(want)
    # instruction coverage before the checkpoint is not part of it
    for k in ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
              "lanes_errored"):
        assert got["coverage"][k] == want["coverage"][k], k


def test_port_writes_the_jax_checkpoint_format(res):
    want, got = res["resume"]["jax_npz"], res["resume"]["port_npz"]
    assert sorted(got) == sorted(want)
    # the schema blob holds the per-leaf digests, equal iff the leaves are
    assert [k for k in want if want[k].dtype != got[k].dtype
            or not np.array_equal(want[k], got[k])] == []


def test_torn_checkpoint_falls_back_to_the_rotated_copy(res):
    got = res["resume"]
    assert got["torn"] == "CheckpointCorrupt"
    fb = got["fallback"]
    assert fb["source"] == "port_frontier.npz.1" and fb["quarantined"]
    assert fb["meta"] == got["meta"]
    assert _differing(got["loaded"], fb["leaves"]) == []


def test_cli_checkpoint_dir_writes_no_checkpoint(res):
    rc, out, err = res["cli_a"]["iprof"]
    assert rc == 0, err[-2000:]
    assert "--checkpoint-dir has no effect" in err
    assert not res["cli_a"]["ckpt_dir_made"]
    with open(os.path.join(FIXTURE_DIR, "arith_bfs_test.json")) as fh:
        assert _issues(json.loads(out)) == _issues(json.load(fh))


def test_plugin_dir_discovery(res):
    rc, out, _ = res["cli_b"]["detectors"]
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 18 and any(line.startswith("PluginProbe") for line in lines)
    rc, _, err = res["cli_b"]["plugin_run"]
    assert rc == 0, err[-2000:]
    assert res["cli_b"]["plugin_marker"] == "2"  # on_run_end saw both transactions
