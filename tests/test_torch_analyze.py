"""End to end on the CPU: the PyTorch analyzer against the JAX package.

- the 14 CALL-free golden fixtures, issue for issue against
  ``tests/fixtures/goldens`` (the other six need call frames and are
  refused, as the swc105_drain check shows);
- the CLI with ``--device cpu -o json``, the refusal of each cut, and
  the CALL pre-scan.

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
from mythril_tpu_torch.support import FRAME_OPCODES, frame_opcodes_in

CALL_FREE = sorted(n for n, (code, _) in _fixtures().items() if not frame_opcodes_in(code))
CUT_FLAGS = [["--creation-code", "x.hex"], ["--corpus", "d"], ["--checkpoint-dir", "d"],
             ["--strategy", "dfs"], ["--enable-iprof"], ["--plugin-dir", "d"]]


def _sorted_keys(issue_dicts):
    return sorted((_issue_key(d) for d in issue_dicts),
                  key=lambda d: (d["swc-id"], d["address"], d["title"]))


def _compute(path):
    """Child process: the goldens, the prescan refusal and the CLI runs."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.interfaces.cli import main
    from mythril_tpu_torch.support import UnsupportedConfiguration

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
    for name in CALL_FREE:
        code, fkw = _fixtures()[name]
        sym = SymExecWrapper([code], device="cpu", **kw, **fkw)
        res["golden", name] = _sorted_keys(i.as_dict() for i in fire_lasers(sym.ctx).issues)
    try:  # refused before the device is even looked at
        SymExecWrapper([_fixtures()["swc105_drain"][0]], device="cuda", **kw)
        res["prescan"] = None
    except UnsupportedConfiguration as e:
        res["prescan"] = str(e)
    res["json"] = cli("analyze", "-c", _fixtures()["swc124_arbitrary_write"][0].hex(),
                      "--device", "cpu", "-o", "json", "--limits-profile", "test",
                      "--lanes-per-contract", "16", "--max-steps", "192")
    for flag in CUT_FLAGS:
        res["cut", flag[0]] = cli("analyze", "-c", "00", "--device", "cpu", *flag)
    res["call"] = cli("analyze", "-c", _fixtures()["swc105_drain"][0].hex(), "--device", "cpu")
    res["version"] = cli("version")
    res["detectors"] = cli("list-detectors")
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_analyze", "_compute", tmp_path_factory)


def test_the_call_free_goldens_are_fourteen():
    assert len(CALL_FREE) == 14


@pytest.mark.parametrize("name", CALL_FREE)
def test_golden(res, name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as fh:
        assert res["golden", name] == json.load(fh)


def test_call_prescan_refuses_swc105_drain_before_device_work(res):
    assert res["prescan"] is not None and "CALL at" in res["prescan"]


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


def test_cli_refuses_call_bytecode(res):
    rc, _, err = res["call"]
    assert rc == 2 and "CALL at" in err


def test_frame_opcode_prescan_skips_push_data():
    # 0xF1 inside PUSH2 data is not an instruction
    assert frame_opcodes_in(bytes([0x61, 0xF1, 0xF1, 0x00])) == []
    assert frame_opcodes_in(bytes([0x5F, 0xF1])) == [(1, FRAME_OPCODES[0xF1])]


def test_version_and_list_detectors(res):
    rc, out, _ = res["version"]
    assert rc == 0 and out.startswith("mythril_tpu_torch ")
    rc, out, _ = res["detectors"]
    assert rc == 0 and len(out.strip().splitlines()) == 17
