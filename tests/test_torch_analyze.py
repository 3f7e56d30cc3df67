"""End to end on the CPU: the PyTorch analyzer against the JAX package.

- the 20 golden fixtures, issue for issue against ``tests/fixtures/goldens``;
- the CLI with ``--device cpu -o json``, with ``--creation-code`` (the
  precompile fixture at the test profile, against the JAX CLI's report
  pinned in ``tests/fixtures/torch_port/precompiles_test.json``), the
  refusal of each part not ported yet, and a run with each flag that an
  earlier slice refused (strategies, the profiler, checkpoints, plugins).

(The [erc20full, erc721] batch against the JAX ``SymExecWrapper`` —
issues, coverage and frontiers — is in ``test_torch_engine.py``, whose
child process compiles the JAX engine once for all its batches.) The
work runs in a child process (``torch_port_child``).
"""

import contextlib
import io
import json
import os

import pytest

import torch_port_child
from test_goldens import GOLDEN_DIR, _fixtures, _issue_key
from torch_port_fixtures import FIXTURE_DIR, precompiles_files

GOLDENS = sorted(_fixtures())
# a corpus campaign runs since the campaign slice; its fleet mode is cut
CUT_FLAGS = [["--corpus", "d", "--fleet", "ledger"], ["-a", "0x" + "11" * 20],
             ["--rpc", "http://localhost:1"], ["--call-depth-limit", "3"]]
FORMER_CUTS = [["--checkpoint-dir"], ["--strategy", "dfs"], ["--enable-iprof"],
               ["--plugin-dir"]]
CREATION_ARGS = ["--limits-profile", "test", "--lanes-per-contract", "16", "--max-steps", "384"]


def _sorted_keys(issue_dicts):
    return sorted((_issue_key(d) for d in issue_dicts),
                  key=lambda d: (d["swc-id"], d["address"], d["title"]))


def _compute(path):
    """Child process: the goldens and the CLI runs."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.interfaces.cli import main

    kw = dict(limits=TEST_LIMITS, lanes_per_contract=16, max_steps=192)

    def cli(*argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(list(argv))
            except SystemExit as e:
                rc = e.code
        return rc, out.getvalue(), err.getvalue()

    res = {}
    for name in GOLDENS:
        code, fkw = _fixtures()[name]
        sym = SymExecWrapper([code], device="cpu", **kw, **fkw)
        res["golden", name] = _sorted_keys(i.as_dict() for i in fire_lasers(sym.ctx).issues)
    creation, runtime = precompiles_files()
    res["creation"] = cli("analyze", "-f", runtime, "--creation-code", creation,
                          "--device", "cpu", "-o", "json", *CREATION_ARGS)
    res["json"] = cli("analyze", "-c", _fixtures()["swc124_arbitrary_write"][0].hex(),
                      "--device", "cpu", "-o", "json", "--limits-profile", "test",
                      "--lanes-per-contract", "16", "--max-steps", "192")
    for flag in CUT_FLAGS:
        res["cut", flag[0]] = cli("analyze", "-c", "00", "--device", "cpu", *flag)
    import tempfile

    for flag in FORMER_CUTS:
        if flag[0] in ("--checkpoint-dir", "--plugin-dir"):
            flag = [flag[0], tempfile.mkdtemp()]
        res["former", flag[0]] = cli("analyze", "-c", "6001600055", "--device", "cpu",
                                     "-o", "json", *flag, "--limits-profile", "test",
                                     "--lanes-per-contract", "4", "--max-steps", "16")
    res["version"] = cli("version")
    res["detectors"] = cli("list-detectors")
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_analyze", "_compute", tmp_path_factory)


@pytest.mark.parametrize("name", GOLDENS)
def test_golden(res, name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as fh:
        assert res["golden", name] == json.load(fh)


def _pinned_creation_report():
    with open(os.path.join(FIXTURE_DIR, "precompiles_test.json")) as fh:
        return json.load(fh)


def test_cli_creation_code_issues_match_jax(res):
    rc, out, _ = res["creation"]
    assert rc == 0
    got = json.loads(out)
    key = lambda d: (d["contract"], d["swc-id"], d["address"], d["title"])
    want = _pinned_creation_report()
    assert sorted(map(_issue_key, got["issues"]), key=key) == \
        sorted(map(_issue_key, want["issues"]), key=key)
    assert any(d["contract"] == "MAIN (constructor)" for d in got["issues"])


def test_cli_creation_code_coverage_matches_jax(res):
    got = json.loads(res["creation"][1])["coverage"]
    want = _pinned_creation_report()["coverage"]
    for k in ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
              "lanes_errored", "instruction_coverage_pct"):
        assert got[k] == want[k], k


def test_cli_device_cpu_json(res):
    rc, out, _ = res["json"]
    assert rc == 0
    doc = json.loads(out)
    with open(os.path.join(GOLDEN_DIR, "swc124_arbitrary_write.json")) as fh:
        want = json.load(fh)
    assert [dict(g, contract="contract_0") for g in _sorted_keys(doc["issues"])] == want
    assert doc["coverage"]["lanes"] == 16


@pytest.mark.parametrize("flag", [f[0] for f in CUT_FLAGS])
def test_cli_refuses_the_cuts(res, flag):
    rc, _, err = res["cut", flag]
    assert rc == 2 and "not supported" in err


@pytest.mark.parametrize("flag", [f[0] for f in FORMER_CUTS])
def test_cli_runs_the_former_cuts(res, flag):
    rc, out, err = res["former", flag]
    assert rc == 0, err[-2000:]
    assert json.loads(out)["coverage"]["lanes"] == 4
    if flag == "--enable-iprof":
        assert "Instruction profile" in err and "SSTORE" in err


def test_version_and_list_detectors(res):
    rc, out, _ = res["version"]
    assert rc == 0 and out.startswith("mythril_tpu_torch ")
    rc, out, _ = res["detectors"]
    assert rc == 0 and len(out.strip().splitlines()) == 17
