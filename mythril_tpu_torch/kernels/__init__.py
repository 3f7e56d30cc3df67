"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

=====  ==========================  =========================================
K1     ``csrc/u256_divmod.cu``     ``divmod_u256`` — u256 DIV/MOD
K2     ``csrc/keccak256.cu``       ``keccak256`` — SHA3 of per-lane bytes
K3     ``csrc/tape_append.cu``     ``tape_append`` — hash-consed tape append
K4     ``csrc/sha256.cu``          ``sha256`` — SHA-256 (precompile 0x2)
K5     ``csrc/u256_modexp.cu``     ``modexp_u256`` — MODEXP (precompile 0x5)
=====  ==========================  =========================================

Each source has a plain C interface. :func:`build` compiles them with
``nvcc`` — one process per source, all started together — into shared
libraries under ``kernels/_build/`` (listed in ``.gitignore``) and loads
them with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. A kernel is built at its first launch, never at import.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch returned a CUDA error, and adds one to its ``launches``
counter. The plain PyTorch versions live beside their callers
(``ops/u256.py``, ``ops/keccak.py``, ``ops/sha256.py``,
``symbolic/engine.py``); those
callers route a CPU tensor to the plain version and a CUDA tensor here.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = {
    "u256_divmod": "u256_divmod.cu",
    "keccak256": "keccak256.cu",
    "tape_append": "tape_append.cu",
    "sha256": "sha256.cu",
    "u256_modexp": "u256_modexp.cu",
}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> float:
    """Compile every kernel source (in parallel) and load the libraries.
    Returns the build's wall time in seconds; later calls return at once."""
    global BUILD_SECONDS
    with _LOCK:
        if _LIBS:
            return BUILD_SECONDS
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.monotonic()
        procs = {}
        for name, src in SOURCES.items():
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(_CSRC, src)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs[name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            elif verbose and log:
                print(f"[nvcc {name}]\n{log}", flush=True)
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
        libs = {name: ctypes.CDLL(out) for name, (out, _) in procs.items()}
        vp, ci = ctypes.c_void_p, ctypes.c_int
        libs["u256_divmod"].divmod_u256.argtypes = [vp, vp, vp, vp, ci, vp]
        libs["keccak256"].keccak256.argtypes = [vp, vp, vp, ci, ci, vp]
        libs["tape_append"].tape_append.argtypes = [vp] * 13 + [ci, ci, vp]
        libs["sha256"].sha256.argtypes = [vp, vp, vp, ci, ci, vp]
        libs["u256_modexp"].modexp_u256.argtypes = [vp, vp, vp, vp, ci, vp]
        for lib, fn in (("u256_divmod", "divmod_u256"), ("keccak256", "keccak256"),
                        ("tape_append", "tape_append"), ("sha256", "sha256"),
                        ("u256_modexp", "modexp_u256")):
            getattr(libs[lib], fn).restype = ci
        _LIBS.update(libs)
        BUILD_SECONDS = time.monotonic() - t0
        return BUILD_SECONDS


def _lib(name):
    if not _LIBS:
        build()
    return _LIBS[name]


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _launch_counter(fn):
    fn.launches = 0
    return fn


@_launch_counter
def divmod_u256(a: torch.Tensor, b: torch.Tensor):
    """K1 on int64 carrier words ``[..., 8]`` -> (quotient, remainder)."""
    dev = a.device
    _check(a, "divmod_u256 a", torch.int64, a.shape, dev)
    _check(b, "divmod_u256 b", torch.int64, a.shape, dev)
    if a.shape[-1] != 8:
        raise ValueError("divmod_u256: last dim must be 8 limbs")
    q = torch.empty_like(a)
    r = torch.empty_like(a)
    n = a.numel() // 8
    err = _lib("u256_divmod").divmod_u256(a.data_ptr(), b.data_ptr(), q.data_ptr(),
                                          r.data_ptr(), n, _stream(dev))
    _raise_on(err, "divmod_u256")
    divmod_u256.launches += 1
    return q, r


@_launch_counter
def keccak256(data: torch.Tensor, length: torch.Tensor):
    """K2: data ``uint8[P, L]``, length ``int32[P]`` -> ``int64[P, 8]``."""
    dev = data.device
    if data.dim() != 2:
        raise ValueError("keccak256: data must be [P, max_len]")
    P, L = data.shape
    _check(data, "keccak256 data", torch.uint8, (P, L), dev)
    _check(length, "keccak256 length", torch.int32, (P,), dev)
    out = torch.empty((P, 8), dtype=torch.int64, device=dev)
    err = _lib("keccak256").keccak256(data.data_ptr(), length.data_ptr(), out.data_ptr(),
                                      P, L, _stream(dev))
    _raise_on(err, "keccak256")
    keccak256.launches += 1
    return out


@_launch_counter
def tape_append(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                op, a, b, imm, mask):
    """K3, in place on the tape tensors. Returns (ids int32[P],
    overflow bool[P])."""
    dev = tape_op.device
    P, T = tape_op.shape
    for t, what, dt, shp in (
            (tape_op, "tape_op", torch.int32, (P, T)),
            (tape_a, "tape_a", torch.int32, (P, T)),
            (tape_b, "tape_b", torch.int32, (P, T)),
            (tape_imm, "tape_imm", torch.int64, (P, T, 8)),
            (tape_hash, "tape_hash", torch.int32, (P, T)),
            (tape_len, "tape_len", torch.int32, (P,)),
            (op, "op", torch.int32, (P,)),
            (a, "a", torch.int32, (P,)),
            (b, "b", torch.int32, (P,)),
            (imm, "imm", torch.int64, (P, 8)),
            (mask, "mask", torch.bool, (P,))):
        _check(t, f"tape_append {what}", dt, shp, dev)
    ids = torch.empty(P, dtype=torch.int32, device=dev)
    overflow = torch.empty(P, dtype=torch.bool, device=dev)
    err = _lib("tape_append").tape_append(
        tape_op.data_ptr(), tape_a.data_ptr(), tape_b.data_ptr(), tape_imm.data_ptr(),
        tape_hash.data_ptr(), tape_len.data_ptr(), op.data_ptr(), a.data_ptr(),
        b.data_ptr(), imm.data_ptr(), mask.data_ptr(), ids.data_ptr(),
        overflow.data_ptr(), P, T, _stream(dev))
    _raise_on(err, "tape_append")
    tape_append.launches += 1
    return ids, overflow


@_launch_counter
def sha256(data: torch.Tensor, length: torch.Tensor):
    """K4: data ``uint8[P, N]``, length ``int32[P]`` -> ``int64[P, 8]``."""
    dev = data.device
    if data.dim() != 2:
        raise ValueError("sha256: data must be [P, N]")
    P, N = data.shape
    _check(data, "sha256 data", torch.uint8, (P, N), dev)
    _check(length, "sha256 length", torch.int32, (P,), dev)
    out = torch.empty((P, 8), dtype=torch.int64, device=dev)
    err = _lib("sha256").sha256(data.data_ptr(), length.data_ptr(), out.data_ptr(),
                                P, N, _stream(dev))
    _raise_on(err, "sha256")
    sha256.launches += 1
    return out


@_launch_counter
def modexp_u256(base: torch.Tensor, e: torch.Tensor, m: torch.Tensor):
    """K5 on int64 carrier words ``[..., 8]`` -> base ** e mod m."""
    dev = base.device
    for t, what in ((base, "base"), (e, "e"), (m, "m")):
        _check(t, f"modexp_u256 {what}", torch.int64, base.shape, dev)
    if base.shape[-1] != 8:
        raise ValueError("modexp_u256: last dim must be 8 limbs")
    out = torch.empty_like(base)
    err = _lib("u256_modexp").modexp_u256(base.data_ptr(), e.data_ptr(), m.data_ptr(),
                                          out.data_ptr(), base.numel() // 8, _stream(dev))
    _raise_on(err, "modexp_u256")
    modexp_u256.launches += 1
    return out


KERNELS = {"divmod_u256": divmod_u256, "keccak256": keccak256,
           "tape_append": tape_append, "sha256": sha256, "modexp_u256": modexp_u256}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
