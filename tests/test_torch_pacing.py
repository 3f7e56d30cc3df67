"""Two repairs of the port's start-up cost, on the CPU (nothing compiles
here):

- the ``--execution-timeout`` pacing of ``SymExecWrapper``'s chunk loop
  takes no sample from a chunk size's first run in the process, which
  pays the kernel build — the JAX wrapper's ``cold``/``warm_shapes`` rule
  (``mythril_tpu/analysis/symbolic.py``) — checked with a fake clock and
  a fake engine step;
- ``kernels.ensure_built`` reuses the libraries an earlier process built
  when the stamp beside them matches (the sources, ``NVCC_FLAGS``,
  ``nvcc --version``) and rebuilds all of them when any of those
  changed, driven through a fake ``nvcc`` on ``PATH``.

Both run in child processes (``torch_port_child``): the test workers
load no PyTorch."""

import os
import stat

import pytest

import torch_port_child

# the fake clock's story: the first chunk pays a 15 s build, later chunks
# take 0.1 s, and the exploration has 20 s
CHUNK, MAX_STEPS, BUILD_S, STEP_S, BUDGET_S = 64, 320, 15.0, 0.1, 20.0


def _pacing(path):
    """Child process: the chunk sizes the wrapper runs under the fake
    clock, alone and with a warm-shape set shared across two wrappers."""
    import time

    torch = torch_port_child.torch_single_thread()
    from mythril_tpu_torch.analysis import symbolic as S
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.obs import metrics as obs_metrics

    clock = [1000.0]
    time.monotonic = lambda: clock[0]
    chunks = []

    def fake_sym_run(sf, env, corpus, spec, limits, max_steps, **kw):
        # the engine's lanes stay running; only the clock moves
        clock[0] += BUILD_S if not chunks else STEP_S
        chunks.append(max_steps)
        return sf, torch.zeros((1, limits.max_code), dtype=torch.bool)

    S.sym_run = fake_sym_run
    code = assemble(("label", "top"), ("ref", "top"), "JUMP")

    def run(warm=None):
        chunks.clear()
        S.SymExecWrapper([code], limits=TEST_LIMITS, lanes_per_contract=2,
                         max_steps=MAX_STEPS, deadline_chunk_steps=CHUNK,
                         execution_timeout=BUDGET_S, transaction_count=1, device="cpu",
                         warm_shapes=warm)
        return list(chunks)

    compiles = obs_metrics.REGISTRY.counter("engine_compiles_total")
    res = {"alone": run()}
    res["compiles_alone"] = compiles.value
    warm = set()
    res["first_of_class"] = run(warm)
    res["warm"] = sorted(warm)
    # a later wrapper of the same shape class: its first chunk is warm, so
    # a slow first chunk now is a sample
    res["second_of_class"] = run(warm)
    res["compiles"] = compiles.value
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def pacing(tmp_path_factory):
    return torch_port_child.run("test_torch_pacing", "_pacing", tmp_path_factory)


def test_the_chunk_that_pays_the_build_is_not_a_sample(pacing):
    # the old rule sampled 15 s / 64 steps and fell to chunk // 4 with 5 s
    # left; a 0.1 s chunk leaves the deadline far off, so n stays the chunk
    assert pacing["alone"] == [CHUNK] * (MAX_STEPS // CHUNK)
    assert pacing["compiles_alone"] == 1


def test_the_warm_set_is_shared_across_a_shape_class(pacing):
    assert pacing["first_of_class"] == [CHUNK] * (MAX_STEPS // CHUNK)
    assert pacing["warm"] == [CHUNK]
    # warm already: the slow first chunk is sampled (15 s / 64 steps), so
    # with ~5 s left the loop drops to chunk // 4, as the JAX wrapper does
    assert pacing["second_of_class"][0] == CHUNK
    assert set(pacing["second_of_class"][1:]) == {CHUNK // 4}
    assert pacing["compiles"] == 3  # alone: 64; the class: 64, then 16


FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "nvcc: NVIDIA (R) Cuda compiler"
  echo "Cuda compilation tools, release $FAKE_NVCC_RELEASE"
  exit 0
fi
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$out" >> "$FAKE_NVCC_LOG"
if [ -n "$FAKE_NVCC_FAIL" ]; then echo "error: fake failure"; exit 1; fi
echo "built from $*" > "$out"
"""


def _stamp(path):
    """Child process: each step's decision and how many sources it ran
    nvcc on, through a fake nvcc on PATH."""
    import tempfile

    torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels

    tmp = tempfile.mkdtemp(prefix="fake_nvcc_")
    csrc, bindir = os.path.join(tmp, "csrc"), os.path.join(tmp, "bin")
    os.mkdir(csrc)
    os.mkdir(bindir)
    for src in [*kernels.SOURCES.values(), "u256.cuh"]:
        with open(os.path.join(csrc, src), "w") as fh:
            fh.write(f"// {src}\n")
    nvcc = os.path.join(bindir, "nvcc")
    with open(nvcc, "w") as fh:
        fh.write(FAKE_NVCC)
    os.chmod(nvcc, os.stat(nvcc).st_mode | stat.S_IXUSR)
    log = os.path.join(tmp, "nvcc.log")
    open(log, "w").close()
    os.environ.update(PATH=bindir + os.pathsep + os.environ["PATH"], FAKE_NVCC_LOG=log,
                      FAKE_NVCC_RELEASE="12.4, V12.4.131")
    kernels._CSRC = csrc
    kernels.BUILD_DIR = os.path.join(tmp, "_build")
    found = kernels._nvcc()

    def step():
        with open(log) as fh:
            n0 = len(fh.readlines())
        try:
            mode = kernels.ensure_built(found)
        except kernels.KernelBuildError:
            mode = "failed"
        with open(log) as fh:
            return mode, len(fh.readlines()) - n0

    res = {"nvcc": found == nvcc, "mode_before": kernels.BUILD_MODE, "steps": []}
    res["steps"].append(("first", step()))
    res["steps"].append(("unchanged", step()))
    with open(os.path.join(csrc, "u256.cuh"), "a") as fh:
        fh.write("// an edit\n")
    res["steps"].append(("source changed", step()))
    res["steps"].append(("unchanged", step()))
    flags = list(kernels.NVCC_FLAGS)
    kernels.NVCC_FLAGS = flags + ["-lineinfo"]
    res["steps"].append(("flag changed", step()))
    res["steps"].append(("unchanged", step()))
    kernels.NVCC_FLAGS = flags
    res["steps"].append(("flag changed back", step()))
    os.environ["FAKE_NVCC_RELEASE"] = "12.8, V12.8.61"
    res["steps"].append(("nvcc changed", step()))
    res["steps"].append(("unchanged", step()))
    os.remove(os.path.join(kernels.BUILD_DIR, "libfork_plan.so"))
    res["steps"].append(("library missing", step()))
    with open(os.path.join(csrc, "fork_plan.cu"), "a") as fh:
        fh.write("// an edit\n")
    os.environ["FAKE_NVCC_FAIL"] = "1"
    res["steps"].append(("nvcc fails", step()))
    del os.environ["FAKE_NVCC_FAIL"]
    res["steps"].append(("after the failure", step()))
    res["build_dir"] = sorted(os.listdir(kernels.BUILD_DIR))
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def stamp(tmp_path_factory):
    return torch_port_child.run("test_torch_pacing", "_stamp", tmp_path_factory)


def test_build_stamp_decides_reuse_or_rebuild(stamp):
    n = 10  # sources
    assert stamp["nvcc"] and stamp["mode_before"] is None
    assert stamp["steps"] == [
        ("first", ("compiled", n)),
        ("unchanged", ("reused", 0)),
        ("source changed", ("compiled", n)),
        ("unchanged", ("reused", 0)),
        ("flag changed", ("compiled", n)),
        ("unchanged", ("reused", 0)),
        ("flag changed back", ("compiled", n)),
        ("nvcc changed", ("compiled", n)),
        ("unchanged", ("reused", 0)),
        ("library missing", ("compiled", n)),
        ("nvcc fails", ("failed", n)),
        ("after the failure", ("compiled", n)),
    ]


def test_build_leaves_only_libraries_and_the_stamp(stamp):
    # every library was renamed into place from a name of its own, the
    # stamp last; a failed build leaves no temporary files behind
    assert stamp["build_dir"] == sorted(
        [f"lib{n}.so" for n in ("u256_divmod", "keccak256", "tape_append", "sha256",
                                "u256_modexp", "propagate_sweep", "fork_plan", "u256_mul",
                                "u256_mulmod_exp", "evm_step")] + ["stamp"])
