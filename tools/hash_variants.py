"""Variants of the hash kernels, built from this tree's sources and timed
on one CUDA card in turns.

    python3 tools/hash_variants.py [--parent CSRC]

Each variant is this tree's ``mythril_tpu_torch/kernels/csrc`` copied to a
temporary directory with one text edit, built with nvcc and
``-Xptxas=-v`` beside the unedited sources, all builds at once:

- ``unrolled``: keccak's 24 rounds fully unrolled (``#pragma unroll``)
  instead of the rolled loop of one unrolled round the sources use;
- ``no SHA3 case``: K10 with the dispatch's SHA3 case deleted, for the
  stack frame and registers the rest of K10 needs;
- ``maxnreg N``: K10 with its entry points capped at N registers;
- ``threads N``: K2 and K4 launched with N threads a block (32 in the
  sources).

With ``--parent CSRC`` (another tree's ``kernels/csrc``, say the parent
commit's unpacked by ``git archive``) that tree's K2, K4 and K10 join.
Prints ptxas's registers, stack frame and spills of each build, then the
device time (torch.profiler) of K2 at P = 2048 (L = 200, and CREATE2's
85-byte rows), K4 at P = 2048 (N = 448) and of one 448-byte lane through
its lane mask, and K10's dispatch on ``chip_smoke.evm_stress_batch`` at
4096 lanes (its SHA3 lanes alone, then every lane), each build twice, in
turns (first to last, then last to first). Every build is held to the
plain version first.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "mythril_tpu_torch", "kernels", "csrc")
ROLLED = "#pragma unroll 1\n  for (int round = 0; round < 24; ++round) {"
UNROLLED = "#pragma unroll\n  for (int round = 0; round < 24; ++round) {"


def edited(edits):
    """A copy of this tree's sources with ``(file, old, new)`` edits."""
    d = tempfile.mkdtemp(prefix="hash_variant_")
    for f in os.listdir(CSRC):
        shutil.copy(os.path.join(CSRC, f), d)
    for f, old, new in edits:
        path = os.path.join(d, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            raise SystemExit(f"hash_variants: {f} no longer holds {old[:50]!r}")
        text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
    return d


def variants(parent):
    """{(kernel, name): source directory}"""
    out = {}
    if parent:
        for k in ("keccak256", "sha256", "evm_step"):
            out[(k, "parent")] = parent
    unrolled = edited([("keccak.cuh", ROLLED, UNROLLED)])
    out[("keccak256", "this")] = out[("sha256", "this")] = out[("evm_step", "this")] = CSRC
    out[("keccak256", "unrolled")] = out[("evm_step", "unrolled")] = unrolled
    out[("evm_step", "no SHA3 case")] = edited(
        [("evm_step.cuh", "    case CLS_SHA3: h_sha3(f, p, sp, true, o); break;\n", "")])
    for n in (104, 112, 116):
        out[("evm_step", f"maxnreg {n}")] = edited(
            [("evm_step.cu", "__global__ void evm_", f"__global__ void __maxnreg__({n}) evm_")])
    for n in (64, 128):
        for k, src, name in (("keccak256", "keccak256.cu", "K2_THREADS"),
                             ("sha256", "sha256.cu", "K4_THREADS")):
            out[(k, f"threads {n}")] = edited(
                [(src, f"constexpr int {name} = 32;", f"constexpr int {name} = {n};")])
    return out


def build(srcs):
    """Build every variant at once -> {(kernel, name): library path}."""
    from mythril_tpu_torch import kernels

    nvcc = kernels._nvcc()
    tmp = tempfile.mkdtemp(prefix="hash_variants_")
    procs, libs = {}, {}
    for i, ((kernel, name), d) in enumerate(srcs.items()):
        libs[(kernel, name)] = os.path.join(tmp, f"{kernel}_{i}.so")
        procs[(kernel, name)] = subprocess.Popen(
            [nvcc, "-Xptxas=-v", *kernels.NVCC_FLAGS, "-o", libs[(kernel, name)],
             os.path.join(d, f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log[-3000:]}")
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
            elif fn and ("stack frame" in ln or "Used" in ln) and not re.search(
                    "prologue|epilogue", fn):
                print(f"[ptxas] {key[0]} {key[1]} {fn}: {ln.strip()}", flush=True)
    return libs


def turns(what, fns, kernel, reps):
    """Device ms of each ``fns`` entry twice, first to last then back."""
    from chip_smoke import kernel_device_ms

    names = list(fns)
    got = {n: [] for n in names}
    for n in names + names[::-1]:
        got[n].append(kernel_device_ms(fns[n], kernel, reps))
    print(f"[turns] {what}, device ms: " + "; ".join(
        f"{n} {' / '.join(f'{x:.4f}' for x in v)}" for n, v in got.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.ops import keccak, sha256

    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv[:-1] else None
    print(f"card: {cs.card_line()}", flush=True)
    libs = build(variants(parent))
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(20261022)
    P = cs.P_MAIN

    def lib_of(key, bind):
        lib = ctypes.CDLL(libs[key])
        bind(lib)
        return lib

    def rows(width, lens):
        return (torch.as_tensor(rng.integers(0, 256, (P, width), dtype=np.uint8), device=dev),
                torch.as_tensor(np.asarray(lens, np.int32), device=dev))

    # K2
    k2 = {name: lib_of(("keccak256", name), kernels.bind_keccak256)
          for kernel, name in libs if kernel == "keccak256"}
    for what, (d, n) in (("K2 at P = 2048, L = 200", rows(200, rng.integers(0, 201, P))),
                         ("K2 on CREATE2's 85-byte rows", rows(85, np.full(P, 85)))):
        fns = {name: (lambda lib=lib, d=d, n=n: kernels.keccak256_call(lib.keccak256, stream,
                                                                       d, n))
               for name, lib in k2.items()}
        want = keccak.keccak256_plain(d, n)
        for name, fn in fns.items():
            if not torch.equal(fn(), want):
                raise SystemExit(f"K2 {name} disagrees with the plain version")
        turns(what, fns, "keccak256_kernel", 20)

    # K4: a parent before the lane mask takes one argument less
    d, n = rows(448, rng.integers(0, 449, P))
    one = torch.zeros(P, dtype=torch.bool, device=dev)
    one[0] = True
    n[0] = 448
    whole, lane = {}, {}
    for kernel, name in libs:
        if kernel != "sha256":
            continue
        if name == "parent":
            lib = ctypes.CDLL(libs[(kernel, name)])
            lib.masked = cs.k4_takes_mask(os.path.join(parent, "sha256.cu"))
            if lib.masked:
                kernels.bind_sha256(lib)
            fn = cs.parent_sha256(lib, dev)
            whole[name] = lambda fn=fn: fn(d, n)
            continue
        lib = lib_of((kernel, name), kernels.bind_sha256)
        whole[name] = lambda lib=lib: kernels.sha256_call(lib.sha256, stream, d, n)
        lane[name] = lambda lib=lib: kernels.sha256_call(lib.sha256, stream, d, n, one)
    want = sha256.sha256_plain(d, n)
    for name, fn in whole.items():
        if not torch.equal(fn(), want):
            raise SystemExit(f"K4 {name} disagrees with the plain version")
    turns("K4 at P = 2048, N = 448", whole, "sha256_kernel", 20)
    turns("K4, one 448-byte lane of 2048 through the lane mask", lane, "sha256_kernel", 20)

    # K10's stress dispatch
    f, env, corpus = cs.evm_stress_batch(cs.P_K10, DEFAULT_LIMITS,
                                         np.random.default_rng(20261017), dev)
    fp, op, run, old_pc = ci.prologue_plain(f, corpus)
    sha3 = run & (ci.Tables.on(dev).CLASS[op.long()] == ci.CLS_SHA3)
    want = ci.dispatch_plain(fp, env, corpus, op, run, old_pc)
    k10 = {name: kernels.EvmStep(lib_of((kernel, name), kernels.bind_evm_step), stream, dev)
           for kernel, name in libs if kernel == "evm_step" and name != "no SHA3 case"}

    def dispatch(k, skip):
        return lambda: kernels.evm_step_call(
            "dispatch", k, kernels.own_evm_fields(fp, "dispatch"), env, corpus, op=op, run=run,
            old_pc=old_pc, skip=skip)[0]

    for name, k in k10.items():
        bad = {x: e for x, e in cs.frontier_errs(dispatch(k, None)(), want).items() if e}
        if bad:
            raise SystemExit(f"K10 {name} disagrees with the plain dispatch: {bad}")
    turns(f"K10's stress dispatch, its {int(sha3.sum())} SHA3 lanes",
          {name: dispatch(k, ~sha3) for name, k in k10.items()}, "evm_dispatch_kernel", 5)
    turns(f"K10's stress dispatch, all {int(run.sum())} running lanes",
          {name: dispatch(k, None) for name, k in k10.items()}, "evm_dispatch_kernel", 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
