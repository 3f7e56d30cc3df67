"""Kernel K10 (``kernels/csrc/evm_step.cu``) before the card: its
per-lane body (``evm_step.cuh``) is compiled as host C++ with ``g++`` and
a small shim, driven through ctypes by the same marshaling the CUDA
wrappers use (``kernels.evm_step_call``), and held field for field to
the plain ``superstep_plain`` / ``prologue_plain`` / ``dispatch_plain`` /
``epilogue_plain`` at the test limits: the vmtests batch stepped to
quiescence, and a seeded random-opcode stress batch (``chip_smoke.py``
builds both) that reaches every class and trap, under both gas
schedules, with the instruction profiler on and with a ``skip`` mask.

Also the routing rule on the CPU: a CPU frontier goes to the plain
versions and launches no kernel. Everything runs in one child process
(``torch_port_child``)."""

import os
import shutil
import subprocess

import pytest

import torch_port_child

CSRC = os.path.join(torch_port_child.ROOT, "mythril_tpu_torch", "kernels", "csrc")
STRESS_LANES = 384
STRESS_STEPS = 4

_SHIM_H = """// host build of the CUDA headers' device functions
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
static inline int __clz(unsigned int x) { return x ? __builtin_clz(x) : 32; }
"""

# the kernels' entry points as loops over the lanes
_SHIM_CPP = "#include \"evm_step.cuh\"\n" + "".join(
    f'extern "C" int evm_{e}(const uint64_t* ptrs, const int* dims, void*) {{\n'
    f"  evm::Frame f = evm::frame_from(ptrs, dims);\n"
    f"  for (int p = 0; p < f.P; ++p) evm::entry_{e}(f, p);\n"
    f"  return 0;\n}}\n"
    for e in ("prologue", "dispatch", "epilogue", "superstep"))


def _build(tmp):
    """Compile K10's body with g++ into tmp; -> the library's path."""
    inc = os.path.join(tmp, "shim")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "cuda_runtime.h"), "w") as fh:
        fh.write(_SHIM_H)
    src = os.path.join(tmp, "evm_step_host.cpp")
    with open(src, "w") as fh:
        fh.write(_SHIM_CPP)
    out = os.path.join(tmp, "libevm_step_host.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", inc, "-I", CSRC, "-o", out, src], check=True,
                   capture_output=True, text=True)
    return out


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(torch_port_child.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compute(path):
    """Child process: every comparison, as lists of differing fields."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci

    smoke = _smoke()
    res = {}

    def bad(got, want):
        return sorted(k for k, e in smoke.frontier_errs(got, want).items() if e != 0)

    # routing on the CPU: plain versions, no launch
    kernels.reset_launch_counts()
    f, env, corpus = smoke.vmtests_batch(TEST_LIMITS)
    a = ci.superstep(f, env, corpus)
    f1, op, run, old_pc = ci.prologue(f, corpus)
    d = ci.dispatch(f1, env, corpus, op, run, old_pc, skip=torch.zeros_like(run))
    r = ci.run(f, env, corpus, max_steps=8)
    res["routing"] = dict(
        launches=kernels.launch_counts(),
        superstep=bad(a, ci.superstep_plain(f, env, corpus)),
        dispatch=bad(d, ci.dispatch_plain(f1, env, corpus, op, run, old_pc)),
        run=bad(r, ci.run_plain(f, env, corpus, max_steps=8)))

    # the header's pointer list is the wrappers' list
    with open(os.path.join(CSRC, "evm_step.cuh")) as fh:
        text = fh.read()
    import re

    block = text[text.index("#define EVM_PTR_FIELDS"):text.index("// dims, in this order")]
    res["fields"] = (re.findall(r"X\([^,]+,\s*(\w+)\)", block),
                     [n for n, *_ in kernels.EVM_FIELDS])

    if not shutil.which("g++"):
        res["lib"] = None
        torch_port_child.dump(res, path)
        return
    tmp = tempfile.mkdtemp(prefix="evm_step_host_")
    lib = ctypes.CDLL(_build(tmp))
    kernels.bind_evm_step(lib)
    res["lib"] = True

    def host(entry, f, env, corpus, **kw):
        return kernels.evm_step_call(entry, getattr(lib, f"evm_{entry}"), 0, f, env, corpus,
                                     **kw)

    # the vmtests batch, step by step to quiescence (iprof on)
    f, env, corpus = smoke.vmtests_batch(TEST_LIMITS)
    f = f.attach_iprof()
    start = f
    steps, mism = 0, []
    while bool(f.running.any()) and steps < 256:
        want = ci.superstep_plain(f, env, corpus)
        got = host("superstep", f, env, corpus)[0]
        if bad(got, want):
            mism.append((steps, bad(got, want)))
        f = want
        steps += 1
    res["vmtests"] = dict(steps=steps, quiet=not bool(f.running.any()), mismatches=mism)
    # run's in-place path: own once, then every superstep in place
    g = kernels.own_evm_fields(start)
    for _ in range(steps):
        host("superstep", g, env, corpus, own=True)
    res["vmtests_in_place"] = bad(g, f)

    # the stress batch: fused and split paths, both gas schedules, skip mask
    rng = np.random.default_rng(20261017)
    f, env, corpus = smoke.evm_stress_batch(STRESS_LANES, TEST_LIMITS, rng)
    ops, codes, out = [], [], []
    for step in range(STRESS_STEPS):
        # the out-of-place entry points leave their input as it was
        before = f.replace(**{k: v.clone() for k, v in vars(f).items()
                              if isinstance(v, torch.Tensor)})
        for berlin in (False, True):
            fp, op, run, old_pc = ci.prologue_plain(f, corpus, berlin)
            hp, hop, hrun = host("prologue", f, env, corpus, berlin=berlin)
            skip = torch.as_tensor(rng.random(STRESS_LANES) < 0.3)
            dp = ci.dispatch_plain(fp, env, corpus, op, run, old_pc, skip=skip)
            hd = host("dispatch", fp, env, corpus, op=op, run=run, old_pc=old_pc, skip=skip)[0]
            ep = ci.epilogue_plain(dp, op, run, old_pc)
            he = host("epilogue", dp, None, None, op=op, run=run, old_pc=old_pc)[0]
            # fused: the plain composite (no skip)
            want = ci.epilogue_plain(ci.dispatch_plain(fp, env, corpus, op, run, old_pc),
                                     op, run, old_pc)
            got = host("superstep", f, env, corpus, berlin=berlin)[0]
            out.append(dict(step=step, berlin=berlin, prologue=bad(hp, fp),
                            op=bool(torch.equal(hop, op)), run=bool(torch.equal(hrun, run)),
                            dispatch=bad(hd, dp), epilogue=bad(he, ep), fused=bad(got, want),
                            inputs=bad(f, before)))
            ops.append(op[run].numpy())
            if berlin:
                f = want
        codes.append(f.err_code.numpy())
    res["stress"] = out
    res["classes"] = sorted({int(c) for c in ci.CLASS_TABLE[np.concatenate(ops)]})
    res["traps"] = sorted({int(c) for c in np.concatenate(codes)})
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_evm_step", "_compute", tmp_path_factory)


@pytest.fixture(scope="module")
def host(res):
    if res["lib"] is None:
        pytest.skip("g++ is not installed: K10's body cannot be built as host C++ here")
    return res


def test_cpu_frontier_takes_the_plain_versions_and_launches_nothing(res):
    r = res["routing"]
    assert all(n == 0 for n in r["launches"].values()), r["launches"]
    assert r["superstep"] == r["dispatch"] == r["run"] == []


def test_header_pointer_order_is_the_wrappers_order(res):
    header, wrappers = res["fields"]
    # the kernel's is_static is the field static, t_<name> the table NAME
    assert [n[2:].upper() if n.startswith("t_") else {"is_static": "static"}.get(n, n)
            for n in header] == wrappers


def test_vmtests_step_by_step_equal_the_plain_superstep(host):
    v = host["vmtests"]
    assert v["quiet"] and v["steps"] > 1
    assert v["mismatches"] == []


def test_run_in_place_equals_the_plain_steps(host):
    assert host["vmtests_in_place"] == []


@pytest.mark.parametrize("part", ["prologue", "op", "run", "dispatch", "epilogue", "fused",
                                  "inputs"])
def test_stress_batch_equals_the_plain_versions(host, part):
    bad = [(o["step"], o["berlin"], o[part]) for o in host["stress"]
           if o[part] not in ([], True)]
    assert bad == []


def test_stress_batch_reaches_every_class_and_trap(host):
    assert host["classes"] == list(range(16))
    assert {1, 2, 3, 4, 5, 6, 7, 10} <= set(host["traps"])
