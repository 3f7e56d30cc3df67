"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

=====  ==========================  =========================================
K1     ``csrc/u256_divmod.cu``     ``divmod_u256`` — u256 DIV/MOD
K2     ``csrc/keccak256.cu``       ``keccak256`` — SHA3 of per-lane bytes
K3     ``csrc/tape_append.cu``     ``tape_append`` — hash-consed tape append
K4     ``csrc/sha256.cu``          ``sha256`` — SHA-256 (precompile 0x2)
K5     ``csrc/u256_modexp.cu``     ``modexp_u256`` — MODEXP (precompile 0x5)
K6     ``csrc/propagate_sweep.cu`` ``propagate_sweep`` — feasibility sweep
K7     ``csrc/fork_plan.cu``       ``fork_plan`` — policy-keyed fork planning
K8     ``csrc/u256_mul.cu``        ``mul_u256`` — MUL / wide product
K9     ``csrc/u256_mulmod_exp.cu`` ``mod_wide_u256``, ``exp_u256`` — ADDMOD /
                                   MULMOD remainder, EXP
K10    ``csrc/evm_step.cu``        ``evm_prologue``, ``evm_dispatch``,
                                   ``evm_epilogue``, ``evm_superstep`` — one
                                   concrete EVM step per lane
=====  ==========================  =========================================

``csrc/u256.cuh`` holds the limb helpers, the long division and the
Barrett reduction that K1, K5, K6, K8, K9 and K10 share; ``csrc/keccak.cuh``
the permutation K2 and K10 share; ``csrc/evm_step.cuh`` K10's per-lane
body (the CPU tests build it as host C++).

Each source has a plain C interface. :func:`build` compiles them with
``nvcc`` — one process per source, all started together — into shared
libraries under ``kernels/_build/`` (listed in ``.gitignore``) and loads
them with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. A kernel is built at its first launch, never at import. A stamp
beside the libraries records what they were built from (the sources,
the flags, the nvcc version); a later process whose stamp matches loads
them without running nvcc.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (K10: copies of the frontier fields it
writes), launches on PyTorch's current stream, raises
if the launch returned a CUDA error, and adds one to its ``launches``
counter. The plain PyTorch versions live beside their callers
(``ops/u256.py``, ``ops/keccak.py``, ``ops/sha256.py``,
``symbolic/engine.py``, ``symbolic/propagate.py``,
``core/interpreter.py``); those callers route a CPU tensor to the plain
version and a CUDA tensor here. K1, K8 and K9 have no such caller: their
arithmetic runs inside K10 on the card, and their plain versions in
``ops/u256.py`` compute in PyTorch on any device.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
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
    "propagate_sweep": "propagate_sweep.cu",
    "fork_plan": "fork_plan.cu",
    "u256_mul": "u256_mul.cu",
    "u256_mulmod_exp": "u256_mulmod_exp.cu",
    "evm_step": "evm_step.cu",
}
# largest dynamic shared memory one block may opt into on sm_90 (bytes)
MAX_SMEM = 232448
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS = None
#: ``"compiled"`` when this process ran nvcc, ``"reused"`` when it loaded
#: the libraries an earlier process built from the same sources
BUILD_MODE = None


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_stamp(nvcc: str) -> str:
    """What a build depends on: the sha256 of every file under ``csrc/``
    (by relative path and content), ``NVCC_FLAGS`` and the output of
    ``nvcc --version``."""
    h = hashlib.sha256()
    for d, dirs, files in os.walk(_CSRC):
        dirs.sort()
        for f in sorted(files):
            path = os.path.join(d, f)
            h.update(os.path.relpath(path, _CSRC).encode() + b"\0")
            with open(path, "rb") as fh:
                h.update(hashlib.sha256(fh.read()).digest())
    h.update(json.dumps(NVCC_FLAGS).encode())
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    if version.returncode != 0:
        raise KernelBuildError(f"{nvcc} --version failed:\n{version.stdout}{version.stderr}")
    h.update(version.stdout.encode())
    return h.hexdigest()


def _stamp_path() -> str:
    return os.path.join(BUILD_DIR, "stamp")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def ensure_built(nvcc: str, verbose: bool = False) -> str:
    """Bring ``_build/`` up to date with the sources: ``"reused"`` when
    the stamp beside the libraries matches :func:`source_stamp` and every
    library is there, else ``"compiled"`` after running nvcc on every
    source (one process each, all started together). ``verbose`` always
    compiles, so that ptxas prints its register and spill lines. Each
    library is written under a name of its own and renamed into place,
    the stamp last, so that a process never loads half a file or a
    library of other sources."""
    stamp = source_stamp(nvcc)
    try:
        with open(_stamp_path()) as fh:
            have = fh.read().strip()
    except OSError:
        have = None
    if (not verbose and have == stamp
            and all(os.path.exists(_lib_path(n)) for n in SOURCES)):
        return "reused"
    os.makedirs(BUILD_DIR, exist_ok=True)
    try:
        os.remove(_stamp_path())
    except FileNotFoundError:
        pass
    tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
    procs = {}
    for name, src in SOURCES.items():
        cmd = [nvcc, *NVCC_FLAGS, "-o", _lib_path(name) + tag, os.path.join(_CSRC, src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        elif verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
    if failed:
        for name in SOURCES:
            if os.path.exists(_lib_path(name) + tag):
                os.remove(_lib_path(name) + tag)
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    for name in SOURCES:
        os.replace(_lib_path(name) + tag, _lib_path(name))
    with open(_stamp_path() + tag, "w") as fh:
        fh.write(stamp + "\n")
    os.replace(_stamp_path() + tag, _stamp_path())
    return "compiled"


def build(verbose: bool = False) -> float:
    """Make sure the libraries match the sources (:func:`ensure_built`:
    compiled by this process or reused from an earlier one, as
    ``BUILD_MODE`` says) and load them. Returns the seconds that took;
    later calls return at once."""
    global BUILD_SECONDS, BUILD_MODE
    with _LOCK:
        if _LIBS:
            return BUILD_SECONDS
        t0 = time.monotonic()
        mode = ensure_built(_nvcc(), verbose)
        libs = {name: ctypes.CDLL(_lib_path(name)) for name in SOURCES}
        vp, ci = ctypes.c_void_p, ctypes.c_int
        libs["u256_divmod"].divmod_u256.argtypes = [vp, vp, vp, vp, ci, vp]
        libs["keccak256"].keccak256.argtypes = [vp, vp, vp, ci, ci, vp]
        libs["tape_append"].tape_append.argtypes = [vp] * 13 + [ci, ci, vp]
        libs["sha256"].sha256.argtypes = [vp, vp, vp, ci, ci, vp]
        libs["u256_modexp"].modexp_u256.argtypes = [vp, vp, vp, vp, ci, vp]
        libs["propagate_sweep"].propagate_sweep.argtypes = [vp] * 14 + [ci] * 3 + [vp]
        libs["fork_plan"].fork_plan.argtypes = [vp] * 13 + [ci] * 8 + [vp]
        libs["u256_mul"].u256_mul.argtypes = [vp, vp, vp, ci, ci, vp]
        libs["u256_mulmod_exp"].u256_mod_wide.argtypes = [vp, vp, vp, ci, vp]
        libs["u256_mulmod_exp"].u256_exp.argtypes = [vp, vp, vp, ci, vp]
        bind_evm_step(libs["evm_step"])
        for lib, fn in (("u256_divmod", "divmod_u256"), ("keccak256", "keccak256"),
                        ("tape_append", "tape_append"), ("sha256", "sha256"),
                        ("u256_modexp", "modexp_u256"), ("propagate_sweep", "propagate_sweep"),
                        ("fork_plan", "fork_plan"),
                        ("u256_mul", "u256_mul"), ("u256_mulmod_exp", "u256_mod_wide"),
                        ("u256_mulmod_exp", "u256_exp")):
            getattr(libs[lib], fn).restype = ci
        _LIBS.update(libs)
        BUILD_SECONDS = time.monotonic() - t0
        BUILD_MODE = mode
        return BUILD_SECONDS


def _lib(name):
    if not _LIBS:
        build()
    return _LIBS[name]


def _check(t: torch.Tensor, what: str, dtype, shape, device):
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor on {device}, got {t.device}")
    _check_layout(t, what, dtype, shape)


def _check_layout(t: torch.Tensor, what: str, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: the CUDA runtime's text for the errors a launch can return that the
#: campaign's resilience layer sorts (``resilience.classify_backend_error``
#: reads the message): an allocation failure, and the sticky errors after
#: which the CUDA context is lost
_CUDA_ERROR_TEXT = {
    2: "out of memory",
    46: "CUDA-capable device(s) busy or unavailable",
    100: "no CUDA-capable device is detected",
    214: "uncorrectable ECC error encountered",
    700: "an illegal memory access was encountered",
    710: "device-side assert triggered",
    714: "hardware stack error",
    715: "an illegal instruction was encountered",
    716: "misaligned address",
    718: "invalid program counter",
    719: "unspecified launch failure",
}


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({_CUDA_ERROR_TEXT.get(err, 'see cudaError_t')})")


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


def _check_words(ts, name, shape, dev):
    for t, what in ts:
        _check(t, f"{name} {what}", torch.int64, shape, dev)
    if shape[-1] != 8:
        raise ValueError(f"{name}: last dim must be 8 limbs")


_MUL_MODES = {"low": 0, "wide": 1}


@_launch_counter
def mul_u256(a: torch.Tensor, b: torch.Tensor, mode: str = "low"):
    """K8 on int64 carrier words ``[..., 8]``: ``mode`` "low" -> the low
    product ``[..., 8]``, "wide" -> the 512-bit product ``[..., 16]``."""
    dev = a.device
    _check_words(((a, "a"), (b, "b")), "mul_u256", a.shape, dev)
    lead = a.shape[:-1]
    out = torch.empty(lead + (8 if mode == "low" else 16,), dtype=torch.int64, device=dev)
    err = _lib("u256_mul").u256_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    a.numel() // 8, _MUL_MODES[mode], _stream(dev))
    _raise_on(err, "mul_u256")
    mul_u256.launches += 1
    return out


@_launch_counter
def mod_wide_u256(x: torch.Tensor, m: torch.Tensor):
    """K9: int64 carrier ``x[..., 16]`` (a 512-bit value) mod ``m[..., 8]``;
    m == 0 gives 0."""
    dev = x.device
    _check_words(((m, "m"),), "mod_wide_u256", m.shape, dev)
    _check(x, "mod_wide_u256 x", torch.int64, m.shape[:-1] + (16,), dev)
    out = torch.empty_like(m)
    err = _lib("u256_mulmod_exp").u256_mod_wide(x.data_ptr(), m.data_ptr(), out.data_ptr(),
                                                m.numel() // 8, _stream(dev))
    _raise_on(err, "mod_wide_u256")
    mod_wide_u256.launches += 1
    return out


@_launch_counter
def exp_u256(base: torch.Tensor, e: torch.Tensor):
    """K9: int64 carrier words ``[..., 8]`` -> base ** e mod 2^256."""
    dev = base.device
    _check_words(((base, "base"), (e, "e")), "exp_u256", base.shape, dev)
    out = torch.empty_like(base)
    err = _lib("u256_mulmod_exp").u256_exp(base.data_ptr(), e.data_ptr(), out.data_ptr(),
                                           base.numel() // 8, _stream(dev))
    _raise_on(err, "exp_u256")
    exp_u256.launches += 1
    return out


@_launch_counter
def propagate_sweep(tape_op, tape_a, tape_b, tape_imm, tape_len, prop_len,
                    iv_lo, iv_hi, kb_m, kb_v, con_node, con_sign, con_len):
    """K6, in place on ``prop_len`` and the four domain tensors. Returns
    the per-lane infeasible flags ``bool[P]``."""
    dev = tape_op.device
    P, T = tape_op.shape
    C = con_node.shape[1]
    for t, what, dt, shp in (
            (tape_op, "tape_op", torch.int32, (P, T)),
            (tape_a, "tape_a", torch.int32, (P, T)),
            (tape_b, "tape_b", torch.int32, (P, T)),
            (tape_imm, "tape_imm", torch.int64, (P, T, 8)),
            (tape_len, "tape_len", torch.int32, (P,)),
            (prop_len, "prop_len", torch.int32, (P,)),
            (iv_lo, "iv_lo", torch.int64, (P, T, 8)),
            (iv_hi, "iv_hi", torch.int64, (P, T, 8)),
            (kb_m, "kb_m", torch.int64, (P, T, 8)),
            (kb_v, "kb_v", torch.int64, (P, T, 8)),
            (con_node, "con_node", torch.int32, (P, C)),
            (con_sign, "con_sign", torch.bool, (P, C)),
            (con_len, "con_len", torch.int32, (P,))):
        _check(t, f"propagate_sweep {what}", dt, shp, dev)
    infeasible = torch.empty(P, dtype=torch.bool, device=dev)
    err = _lib("propagate_sweep").propagate_sweep(
        tape_op.data_ptr(), tape_a.data_ptr(), tape_b.data_ptr(), tape_imm.data_ptr(),
        tape_len.data_ptr(), prop_len.data_ptr(), iv_lo.data_ptr(), iv_hi.data_ptr(),
        kb_m.data_ptr(), kb_v.data_ptr(), con_node.data_ptr(), con_sign.data_ptr(),
        con_len.data_ptr(), infeasible.data_ptr(), P, T, C, _stream(dev))
    _raise_on(err, "propagate_sweep")
    propagate_sweep.launches += 1
    return infeasible


# fork policies as K7 numbers them (csrc/fork_plan.cu)
FORK_POLICIES = ("fifo", "shallow", "deep", "random", "weighted", "coverage", "beam")


def fork_plan_smem_bytes(B: int) -> int:
    """Dynamic shared memory K7 needs for a fork block of B lanes."""
    Bp = 1 << max(0, (B - 1).bit_length())
    return 4 * (Bp + 2 * B + min(Bp, 1024))


@_launch_counter
def fork_plan(active, fork_req, con_len, fork_dest, contract_id, pc, sp, dropped_forks,
              fork_cslot, call_enum, visited, *, block: int, policy: str, n_con: int,
              n_stack: int, defer: bool):
    """K7: the fork map and the per-lane fix-ups of ``expand_forks`` for
    every fork block of ``block`` lanes. ``visited`` is the coverage
    bitmap ``bool[C, MC]`` or None. Returns (``int32[9, P]``: src, slot,
    pc, sp, con_len, last sign index, stack slot, call_enum, dropped;
    ``bool[4, P]``: is_copy, fork_req, starved, backward copy)."""
    dev = active.device
    P = active.shape[0]
    if block <= 0 or P % block:
        raise ValueError(f"fork_plan: fork block {block} must divide P={P}")
    if fork_plan_smem_bytes(block) > MAX_SMEM:
        raise ValueError(f"fork_plan: a fork block of {block} lanes needs "
                         f"{fork_plan_smem_bytes(block)} bytes of shared memory, more "
                         f"than the {MAX_SMEM} one block can hold")
    _check(active, "fork_plan active", torch.bool, (P,), dev)
    _check(fork_req, "fork_plan fork_req", torch.bool, (P,), dev)
    for t, what in ((con_len, "con_len"), (fork_dest, "fork_dest"),
                    (contract_id, "contract_id"), (pc, "pc"), (sp, "sp"),
                    (dropped_forks, "dropped_forks"), (fork_cslot, "fork_cslot"),
                    (call_enum, "call_enum")):
        _check(t, f"fork_plan {what}", torch.int32, (P,), dev)
    vc = vm = 0
    vptr = None
    if visited is not None:
        vc, vm = visited.shape
        _check(visited, "fork_plan visited", torch.bool, (vc, vm), dev)
        vptr = visited.data_ptr()
    out_i = torch.empty((9, P), dtype=torch.int32, device=dev)
    out_b = torch.empty((4, P), dtype=torch.bool, device=dev)
    err = _lib("fork_plan").fork_plan(
        active.data_ptr(), fork_req.data_ptr(), con_len.data_ptr(), fork_dest.data_ptr(),
        contract_id.data_ptr(), pc.data_ptr(), sp.data_ptr(), dropped_forks.data_ptr(),
        fork_cslot.data_ptr(), call_enum.data_ptr(), vptr, out_i.data_ptr(),
        out_b.data_ptr(), P, block, FORK_POLICIES.index(policy), n_con, n_stack, vc, vm,
        int(defer), _stream(dev))
    _raise_on(err, "fork_plan")
    fork_plan.launches += 1
    return out_i, out_b


# ---------------------------------------------------------------------------
# K10: the concrete EVM step (csrc/evm_step.cu)
# ---------------------------------------------------------------------------

# The pointers K10 takes, in the order of ``EVM_PTR_FIELDS`` in
# csrc/evm_step.cuh: (name, where, dtype, shape). ``where`` is the
# frontier ("f", the kernel's ``is_static`` is the field ``static``), the
# env ("env"), the corpus ("corpus"), the opcode tables ("tab", the
# ``Tables`` attribute) or the step itself ("step"). Shapes name the dims.
_B, _U8, _I32, _I64 = torch.bool, torch.uint8, torch.int32, torch.int64
EVM_FIELDS = (
    ("active", "f", _B, ("P",)), ("halted", "f", _B, ("P",)), ("error", "f", _B, ("P",)),
    ("err_code", "f", _I32, ("P",)), ("reverted", "f", _B, ("P",)), ("pc", "f", _I32, ("P",)),
    ("contract_id", "f", _I32, ("P",)), ("depth", "f", _I32, ("P",)),
    ("sp_base", "f", _I32, ("P",)), ("static", "f", _B, ("P",)),
    ("cur_acct", "f", _I32, ("P",)), ("caller_addr", "f", _I64, ("P", 8)),
    ("callvalue", "f", _I64, ("P", 8)), ("pc_hold", "f", _B, ("P",)),
    ("init_code", "f", _U8, ("P", "IC")), ("init_len", "f", _I32, ("P",)),
    ("init_jd", "f", _B, ("P", "IC")), ("init_depth", "f", _I32, ("P",)),
    ("acct_addr", "f", _I64, ("P", "A", 8)), ("acct_code", "f", _I32, ("P", "A")),
    ("acct_bal", "f", _I64, ("P", "A", 8)), ("acct_used", "f", _B, ("P", "A")),
    ("stack", "f", _I64, ("P", "S", 8)), ("sp", "f", _I32, ("P",)),
    ("memory", "f", _U8, ("P", "M")), ("mem_words", "f", _I32, ("P",)),
    ("gas_min", "f", _I64, ("P",)), ("gas_max", "f", _I64, ("P",)),
    ("gas_limit", "f", _I64, ("P",)), ("st_keys", "f", _I64, ("P", "K", 8)),
    ("st_vals", "f", _I64, ("P", "K", 8)), ("st_used", "f", _B, ("P", "K")),
    ("st_written", "f", _B, ("P", "K")), ("st_acct", "f", _I32, ("P", "K")),
    ("calldata", "f", _U8, ("P", "CD")), ("calldata_len", "f", _I32, ("P",)),
    ("returndata", "f", _U8, ("P", "RD")), ("returndata_len", "f", _I32, ("P",)),
    ("retval", "f", _U8, ("P", "RD")), ("retval_len", "f", _I32, ("P",)),
    ("n_logs", "f", _I32, ("P",)), ("log_pc", "f", _I32, ("P", "LS")),
    ("log_cid", "f", _I32, ("P", "LS")), ("log_ntopics", "f", _I32, ("P", "LS")),
    ("log_topic0", "f", _I64, ("P", "LS", 8)), ("log_data0", "f", _I64, ("P", "LS", 8)),
    ("selfdestructed", "f", _B, ("P",)), ("n_steps", "f", _I32, ("P",)),
    ("op_hist", "f", _I32, ("P", 256)),
    *((k, "env", _I64, ("P", 8)) for k in ("origin", "gasprice", "coinbase", "timestamp",
                                           "number", "prevrandao", "blk_gaslimit",
                                           "chainid", "basefee")),
    ("code", "corpus", _U8, ("C", "MC")), ("code_len", "corpus", _I32, ("C",)),
    ("is_jumpdest", "corpus", _B, ("C", "MC")), ("code_hash", "corpus", _I64, ("C", 8)),
    ("CLASS", "tab", _I32, (256,)), ("STACK_IN", "tab", _I32, (256,)),
    ("STACK_OUT", "tab", _I32, (256,)), ("D_SP", "tab", _I32, (256,)),
    ("PUSHES", "tab", _B, (256,)), ("PUSH_WIDTH", "tab", _I32, (256,)),
    ("IS_VALID", "tab", _B, (256,)), ("GAS_MIN", "tab", _I64, (256,)),
    ("GAS_MAX", "tab", _I64, (256,)), ("EMPTY_KECCAK", "tab", _I64, (8,)),
    ("op", "step", _I32, ("P",)), ("run", "step", _B, ("P",)),
    ("old_pc", "step", _I32, ("P",)), ("skip", "step", _B, ("P",)),
)
EVM_DIMS = ("P", "S", "M", "CD", "RD", "K", "A", "LS", "IC", "MC", "C")
# the frontier fields each entry point writes; a wrapper writes into
# clones of them (so a tensor a caller still holds is never changed)
# unless the caller owns the frontier (``own=True``, as ``run`` does)
EVM_WRITES = {
    "prologue": ("error", "err_code", "gas_min", "gas_max"),
    "dispatch": ("stack", "sp", "gas_min", "gas_max", "mem_words", "error", "err_code",
                 "memory", "st_keys", "st_vals", "st_used", "st_written", "st_acct", "pc",
                 "halted", "reverted", "selfdestructed", "retval", "retval_len", "n_logs",
                 "log_pc", "log_cid", "log_ntopics", "log_topic0", "log_data0",
                 "returndata_len"),
    "epilogue": ("pc", "pc_hold", "n_steps", "op_hist", "error", "err_code"),
}
EVM_WRITES["superstep"] = tuple(dict.fromkeys(
    EVM_WRITES["prologue"] + EVM_WRITES["dispatch"] + EVM_WRITES["epilogue"]))
EVM_ENTRIES = ("evm_prologue", "evm_dispatch", "evm_epilogue", "evm_superstep")


def bind_evm_step(lib):
    """Argument and result types of K10's entry points on a loaded library
    (the nvcc build here; the CPU tests' host build of the same body)."""
    for name in EVM_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def own_evm_fields(f, entry: str = "superstep"):
    """``f`` with fresh, contiguous copies of the fields ``entry`` writes."""
    return f.replace(**{k: getattr(f, k).clone(memory_format=torch.contiguous_format)
                        for k in EVM_WRITES[entry] if getattr(f, k) is not None})


def evm_step_call(entry: str, fn, stream: int, f, env, corpus, *, berlin=False,
                  op=None, run=None, old_pc=None, skip=None, own=False):
    """Marshal one K10 step for ``fn`` (a library's entry point ``entry``,
    one of prologue/dispatch/epilogue/superstep) and call it. Checks the
    dtype, shape, device and contiguity of every tensor it passes; the
    frontier comes back with the fields ``entry`` wrote (in clones unless
    ``own``). -> (frontier, op, run)."""
    from ..core.interpreter import Tables

    dev = f.pc.device
    if not own:
        f = own_evm_fields(f, entry)
    P = f.n_lanes
    if entry == "prologue":
        op = torch.empty(P, dtype=_I32, device=dev)
        run = torch.empty(P, dtype=_B, device=dev)
    tb = Tables.on(dev)
    tabs = {name: getattr(tb, name) for name, where, _, _ in EVM_FIELDS if where == "tab"}
    if berlin:
        tabs.update(GAS_MIN=tb.GAS_MIN_BERLIN, GAS_MAX=tb.GAS_MAX_BERLIN)
    srcs = {"f": f, "env": env, "corpus": corpus}
    dims = dict(P=P, S=f.stack.shape[1], M=f.memory.shape[1], CD=f.calldata.shape[1],
                RD=f.retval.shape[1], K=f.st_used.shape[1], A=f.acct_used.shape[1],
                LS=f.log_pc.shape[1], IC=f.init_code.shape[1],
                MC=corpus.code.shape[1] if corpus is not None else 0,
                C=corpus.code.shape[0] if corpus is not None else 0)
    step = {"op": op, "run": run, "old_pc": old_pc, "skip": skip}
    optional = {"op_hist", "skip", "old_pc"} if entry == "prologue" else {"op_hist", "skip"}
    if entry == "superstep":
        optional |= {"op", "run", "old_pc"}
    # the prologue reads no env, the epilogue neither env nor corpus
    unread = {"prologue": ("env",), "epilogue": ("env", "corpus")}.get(entry, ())
    ptrs = []
    for name, where, dtype, shape in EVM_FIELDS:
        if where == "tab":
            t = tabs[name]
        elif where == "step":
            t = step[name]
        else:
            src = srcs[where]
            t = None if src is None else getattr(src, name)
        if t is None:
            if name not in optional and where not in unread:
                raise ValueError(f"evm_{entry}: {name} is required")
            ptrs.append(0)
            continue
        what = f"evm_{entry} {name}"
        if t.device != dev:
            raise ValueError(f"{what}: expected a tensor on {dev}, got {t.device}")
        _check_layout(t, what, dtype, [dims.get(d, d) for d in shape])
        ptrs.append(t.data_ptr())
    c_ptrs = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(EVM_DIMS))(*(dims[d] for d in EVM_DIMS))
    err = fn(ctypes.cast(c_ptrs, ctypes.c_void_p), ctypes.cast(c_dims, ctypes.c_void_p), stream)
    _raise_on(err, f"evm_{entry}")
    return f, op, run


def _evm_launch(wrapper, entry, f, env, corpus, **kw):
    if not f.pc.is_cuda:
        raise ValueError(f"evm_{entry}: expected a CUDA tensor, got {f.pc.device}")
    dev = f.pc.device
    out = evm_step_call(entry, getattr(_lib("evm_step"), f"evm_{entry}"), _stream(dev),
                        f, env, corpus, **kw)
    wrapper.launches += 1
    return out


@_launch_counter
def evm_prologue(f, corpus, berlin: bool = False, own: bool = False):
    """K10 prologue -> (frontier, op int32[P], run bool[P]); old_pc is
    the input's ``pc``, which it leaves as it was. ``own`` as for
    :func:`evm_superstep`."""
    return _evm_launch(evm_prologue, "prologue", f, None, corpus, berlin=berlin, own=own)


@_launch_counter
def evm_dispatch(f, env, corpus, op, run, old_pc, skip=None, own: bool = False):
    """K10 dispatch: each running lane not under ``skip`` runs its class
    handler and the stack writeback. -> frontier."""
    return _evm_launch(evm_dispatch, "dispatch", f, env, corpus, op=op, run=run,
                       old_pc=old_pc, skip=skip, own=own)[0]


@_launch_counter
def evm_epilogue(f, op, run, old_pc, own: bool = False):
    """K10 epilogue: pc advance, pc_hold reset, n_steps, iprof, OOG. ->
    frontier."""
    return _evm_launch(evm_epilogue, "epilogue", f, None, None, op=op, run=run,
                       old_pc=old_pc, own=own)[0]


@_launch_counter
def evm_superstep(f, env, corpus, berlin: bool = False, own: bool = False):
    """K10 fused prologue -> dispatch -> epilogue. ``own``: the caller owns
    every field the entry point writes (``own_evm_fields``) and it runs in
    place on them. -> frontier."""
    return _evm_launch(evm_superstep, "superstep", f, env, corpus, berlin=berlin,
                       own=own)[0]


KERNELS = {"divmod_u256": divmod_u256, "keccak256": keccak256,
           "tape_append": tape_append, "sha256": sha256, "modexp_u256": modexp_u256,
           "propagate_sweep": propagate_sweep, "fork_plan": fork_plan,
           "mul_u256": mul_u256, "mod_wide_u256": mod_wide_u256, "exp_u256": exp_u256,
           "evm_prologue": evm_prologue, "evm_dispatch": evm_dispatch,
           "evm_epilogue": evm_epilogue, "evm_superstep": evm_superstep}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
