"""The PyTorch package stands alone: no module of ``mythril_tpu_torch``
(and not ``chip_smoke.py``) imports JAX or the JAX package — the host
natives it copied (``ops/natives_host.py``, ``bn128.py``, ``blake2.py``,
``secp256k1.py``) and the campaign's modules (``resilience.py``,
``fleet.py``, ``mythril/campaign.py``) included —, an analyze run and a
corpus campaign load neither, and the smoke script's golden fixtures
are the fixtures of ``tests/test_goldens.py``."""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest

import torch_port_child

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mythril_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "mythril_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_cpu_analyze_loads_neither_jax_nor_the_jax_package():
    script = (
        "import sys\n"
        "import mythril_tpu_torch\n"
        "from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers\n"
        "from mythril_tpu_torch.config import TEST_LIMITS\n"
        "from mythril_tpu_torch.disassembler.asm import assemble\n"
        "code = assemble(4, 'CALLDATALOAD', 'SELFDESTRUCT')\n"
        "sym = SymExecWrapper([code], limits=TEST_LIMITS, lanes_per_contract=16,\n"
        "                     max_steps=64, device='cpu')\n"
        "assert [i.swc_id for i in fire_lasers(sym).issues] == ['106']\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mythril_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cpu_campaign_loads_neither_jax_nor_the_jax_package(tmp_path):
    # the corpus campaign and campaign-merge; the merge is dict math and
    # loads no torch either
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "c000.hex").write_text("600435ff")  # 4 CALLDATALOAD SELFDESTRUCT
    (corpus / "c001.hex").write_text("00")
    script = (
        "import contextlib, io, json, sys\n"
        "from mythril_tpu_torch.interfaces.cli import main\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert main(['campaign-merge', sys.argv[2]]) == 0\n"
        "merge_torch = 'torch' in sys.modules\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert main(['analyze', '--corpus', sys.argv[1], '--device', 'cpu',\n"
        "                 '--limits-profile', 'test', '--batch-size', '2',\n"
        "                 '--lanes-per-contract', '8', '--max-steps', '64', '-t', '1',\n"
        "                 '-m', 'AccidentallyKillable', '-o', 'json']) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mythril_tpu'))\n"
        "print('LOADED', bad, 'merge loaded torch:', merge_torch)\n"
        "sys.exit(1 if bad or merge_torch else 0)\n")
    result = tmp_path / "result.json"
    result.write_text('{"contracts": 1, "batches": 1, "issues": 0, "wall_sec": 1.0}')
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script, str(corpus), str(result)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_campaign_modules_are_checked():
    new = {os.path.join(PKG, *p) for p in (("resilience.py",), ("fleet.py",),
                                            ("mythril", "campaign.py"),
                                            ("utils", "checkpoint.py"))}
    assert new <= set(_sources())


def test_the_copied_host_natives_are_checked():
    copied = {os.path.join(PKG, "ops", f"{m}.py")
              for m in ("natives_host", "bn128", "blake2", "secp256k1", "sha256")}
    assert copied <= set(_sources())


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_fixtures_equal_the_goldens():
    from test_goldens import _fixtures

    want = {n: code for n, (code, _) in _fixtures().items()}
    assert _smoke().golden_fixtures() == want


def test_chip_smoke_systems_equal_the_test_fixtures():
    # the smoke script keeps its own copy of the real-world batch and of
    # config 4 (torch_port_fixtures also pins the JAX reports): the same
    # contracts, in the same corpus order
    import torch_port_fixtures as tpf

    smoke = _smoke()
    assert (smoke.REALWORLD, smoke.CONFIG4, smoke.COVERAGE_KEYS) == \
        (tpf.REALWORLD, tpf.CONFIG4, tpf.COVERAGE_KEYS)
    assert smoke.realworld_system() == tpf.realworld_system()
    assert smoke.config4_system() == tpf.config4_system()
    assert smoke.forkblock_system() == tpf.forkblock_system()
    assert smoke.STRATEGIES == tpf.STRATEGIES
    assert list(smoke.ARITH_SHORT_ARGS) == tpf.ARITH_SHORT_ARGS


def _sweep_args(torch):
    P, T, C = 4, 8, 4
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    words = lambda: torch.zeros((P, T, 8), dtype=torch.int64)
    return [i32(P, T), i32(P, T), i32(P, T), words(), i32(P), i32(P), words(), words(),
            words(), words(), i32(P, C), torch.zeros((P, C), dtype=torch.bool), i32(P)]


def _fork_frontier():
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.symbolic import make_sym_frontier

    return make_sym_frontier(4, TEST_LIMITS)


def _compute(path):
    """Child process: the device default and the no-fallback rule."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.device import resolve_device

    res = {"cuda": torch.cuda.is_available(), "cpu": resolve_device("cpu").type}
    try:
        res["default"] = resolve_device().type
    except RuntimeError as e:
        res["default"] = str(e)
    cpu = torch.zeros((4, 8), dtype=torch.int64)
    calls = {
        "divmod_u256": lambda: kernels.divmod_u256(cpu, cpu),
        "sha256": lambda: kernels.sha256(torch.zeros((4, 64), dtype=torch.uint8),
                                         torch.zeros(4, dtype=torch.int32)),
        "modexp_u256": lambda: kernels.modexp_u256(cpu, cpu, cpu),
        "mul_u256": lambda: kernels.mul_u256(cpu, cpu, "wide"),
        "mod_wide_u256": lambda: kernels.mod_wide_u256(torch.zeros((4, 16), dtype=torch.int64),
                                                       cpu),
        "exp_u256": lambda: kernels.exp_u256(cpu, cpu),
        "propagate_sweep": lambda: kernels.propagate_sweep(*_sweep_args(torch)),
        "fork_plan": lambda: kernels.fork_plan(_fork_frontier(), block=4, policy="beam",
                                               defer=True),
    }
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.workloads import erc20_transfer_workload

    _, f, env, corpus = erc20_transfer_workload(4, TEST_LIMITS)
    op, run = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool)
    calls.update({
        "evm_prologue": lambda: kernels.evm_prologue(f, corpus),
        "evm_dispatch": lambda: kernels.evm_dispatch(f, env, corpus, op, run, f.pc),
        "evm_epilogue": lambda: kernels.evm_epilogue(f, op, run, f.pc),
        "evm_superstep": lambda: kernels.evm_superstep(f, env, corpus),
    })
    for name, call in calls.items():
        try:
            call()
            res["cpu_tensor_to", name] = None
        except ValueError as e:
            res["cpu_tensor_to", name] = str(e)
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_isolation", "_compute", tmp_path_factory)


def test_entry_points_default_to_the_card(res):
    assert res["cpu"] == "cpu"
    if res["cuda"]:
        assert res["default"] == "cuda"
    else:
        assert "no CUDA device" in res["default"]


@pytest.mark.parametrize("kernel", ["divmod_u256", "sha256", "modexp_u256", "mul_u256",
                                    "mod_wide_u256", "exp_u256", "propagate_sweep",
                                    "fork_plan", "evm_prologue", "evm_dispatch",
                                    "evm_epilogue", "evm_superstep"])
def test_cuda_tensor_never_falls_back_to_plain(res, kernel):
    # a kernel wrapper takes CUDA tensors only (and raises on anything
    # else); the routing functions send a CUDA tensor nowhere but here
    assert res["cpu_tensor_to", kernel] is not None
    assert "CUDA tensor" in res["cpu_tensor_to", kernel]


def test_collecting_the_port_tests_loads_no_torch():
    # the port's tests run PyTorch only in child processes
    # (torch_port_child), so the test worker itself stays torch-free
    assert "torch" not in sys.modules
