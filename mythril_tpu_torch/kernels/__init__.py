"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

=====  ==========================  =========================================
K1     ``csrc/u256_divmod.cu``     ``divmod_u256`` — u256 DIV/MOD
K2     ``csrc/keccak256.cu``       ``keccak256`` — SHA3 of per-lane bytes
K3     ``csrc/tape_append.cu``     ``tape_append``, ``tape_append_group`` —
                                   hash-consed tape append, one row or R
                                   rows a lane in one launch
K4     ``csrc/sha256.cu``          ``sha256`` — SHA-256 (precompile 0x2),
                                   every lane or the lanes of a mask
K5     ``csrc/u256_modexp.cu``     ``modexp_u256`` — MODEXP (precompile 0x5),
                                   a quarter-warp per lane
K6     ``csrc/propagate_sweep.cu`` ``propagate_sweep`` — feasibility sweep
K7     ``csrc/fork_plan.cu``       ``fork_plan`` — the whole fork expansion
                                   (plan, row copy, fix-ups), in place
K8     ``csrc/u256_mul.cu``        ``mul_u256`` — MUL / wide product
K9     ``csrc/u256_mulmod_exp.cu`` ``mod_wide_u256``, ``exp_u256`` — ADDMOD /
                                   MULMOD remainder, EXP
K10    ``csrc/evm_step.cu``        ``evm_prologue``, ``evm_dispatch``,
                                   ``evm_epilogue``, ``evm_superstep`` — one
                                   concrete EVM step per lane
=====  ==========================  =========================================

``csrc/u256.cuh`` holds the limb helpers that K1, K6, K8, K9 and K10
share, and K1's, K9's and K10's division core (Knuth's algorithm D over
32-bit limbs) and EXP chain; ``csrc/keccak.cuh``
the word-wise absorb and permutation K2 and K10 share (with K2's per-lane
body); ``csrc/sha256.cuh`` K4's per-lane body; ``csrc/evm_step.cuh`` K10's per-lane
body, ``csrc/tape_append.cuh`` K3's and ``csrc/propagate.cuh`` K6's
per-warp bodies, ``csrc/modexp.cuh`` K5's quarter-warp body and
``csrc/fork_expand.cuh`` K7's per-lane bodies (the CPU tests build all of
them as host C++).

K3 and K6 run a warp per frontier lane. K3's warp scans the lane's
fingerprints 128 at a time and appends each row in place; its group
entry point appends the engine's SHA3 chain (10 rows) or a binary op's
CONST, CONST and node (3 rows) in one launch, each row's scan seeing the
rows before it. A launch's device work is a few microseconds, less than
its host side: the tape is marshaled once per loop (:class:`TapeAppend`),
and a group pays the host side once for its rows.
K6's warp takes the lane's new tape nodes in windows of 32, one a thread,
in rounds as deep as the window's dependency chain, stages their domains
in shared memory and commits them with coalesced stores; its bound is
the bytes of the nodes' rows and domains, and what stays serial is a
window's chain and the windows of a lane.
K5 spreads a lane over the eight threads of a quarter-warp, a limb each.
K7 is the whole fork expansion, in place on the fields the loop owns:
the plan, each copy lane's rows from its source, and the fix-ups.

Each source has a plain C interface. :func:`build` compiles them with
``nvcc`` — one process per source, all started together — into shared
libraries under ``kernels/_build/`` (listed in ``.gitignore``) and loads
them with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds. A kernel is built at its first launch, never at import. A stamp
beside the libraries records what they were built from (the sources,
the flags, the nvcc version); a later process whose stamp matches loads
them without running nvcc.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch returned a CUDA error, and adds one to its ``launches``
counter. K10 works in place on frontier fields its caller owns, through
a launch descriptor (:class:`EvmStep`) that a loop builds once and that
re-marshals only the tensors that changed since its last launch; K3 on
the tape the same way (:class:`TapeAppend`), and K7 on every lane-axis
field (:class:`ForkExpand`). The
plain PyTorch versions live beside their callers (``ops/u256.py``, ``ops/keccak.py``, ``ops/sha256.py``,
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
import weakref

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

_B, _U8, _I32, _I64 = torch.bool, torch.uint8, torch.int32, torch.int64

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


def bind_tape_append(lib):
    """Argument and result types of K3's entry points on a loaded library
    (the nvcc build here; the CPU tests' host build of the same body)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tape_append.argtypes = [vp, ci] + [vp] * 7 + [ci, vp]
    lib.tape_append_group.argtypes = [vp, ci] + [vp] * 9 + [ci, ci, vp]
    lib.tape_append.restype = lib.tape_append_group.restype = ci


def bind_propagate_sweep(lib):
    """Argument and result types of K6's entry point on a loaded library."""
    lib.propagate_sweep.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.propagate_sweep.restype = ctypes.c_int


def bind_divmod(lib):
    """Argument and result types of K1's entry point on a loaded library
    (the nvcc build here; a parent tree's in ``chip_smoke.py``; the CPU
    tests' host build of the same body)."""
    lib.divmod_u256.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    lib.divmod_u256.restype = ctypes.c_int


def bind_keccak256(lib):
    """Argument and result types of K2's entry point on a loaded library
    (the nvcc build here; the CPU tests' host build of the same body)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.keccak256.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.keccak256.restype = ci


def bind_sha256(lib):
    """Argument and result types of K4's entry point on a loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sha256.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    lib.sha256.restype = ci


def bind_mulmod_exp(lib):
    """Argument and result types of K9's entry points on a loaded library."""
    for fn in (lib.u256_mod_wide, lib.u256_exp):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


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
        bind_divmod(libs["u256_divmod"])
        bind_keccak256(libs["keccak256"])
        bind_tape_append(libs["tape_append"])
        bind_sha256(libs["sha256"])
        bind_modexp(libs["u256_modexp"])
        bind_propagate_sweep(libs["propagate_sweep"])
        bind_fork_expand(libs["fork_plan"])
        libs["u256_mul"].u256_mul.argtypes = [vp, vp, vp, ci, ci, vp]
        bind_mulmod_exp(libs["u256_mulmod_exp"])
        bind_evm_step(libs["evm_step"])
        libs["u256_mul"].u256_mul.restype = ci
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


def keccak256_call(fn, stream: int, data, length):
    """One launch of K2's C entry point ``fn`` (the nvcc build's; the CPU
    tests pass a host build's) on ``uint8[P, L]`` rows, each checked to lie
    on ``data``'s device -> ``int64[P, 8]``. The rows may start at any
    address and be of any length: the kernel reads whole aligned words of
    the buffer and never past its ends."""
    if data.dim() != 2:
        raise ValueError("keccak256: data must be [P, max_len]")
    P, L = data.shape
    if length.device != data.device:
        raise ValueError(f"keccak256 length: expected a tensor on {data.device}, "
                         f"got {length.device}")
    _check_layout(data, "keccak256 data", torch.uint8, (P, L))
    _check_layout(length, "keccak256 length", torch.int32, (P,))
    out = torch.empty((P, 8), dtype=torch.int64, device=data.device)
    _raise_on(fn(data.data_ptr(), length.data_ptr(), out.data_ptr(), P, L, stream), "keccak256")
    return out


@_launch_counter
def keccak256(data: torch.Tensor, length: torch.Tensor):
    """K2: data ``uint8[P, L]``, length ``int32[P]`` -> ``int64[P, 8]``."""
    dev = data.device
    _check(data, "keccak256 data", torch.uint8, data.shape, dev)
    out = keccak256_call(_lib("keccak256").keccak256, _stream(dev), data, length)
    keccak256.launches += 1
    return out


# K3's tape tensors, in the order of ``k3::Tape`` (csrc/tape_append.cuh)
TAPE_FIELDS = (("tape_op", _I32), ("tape_a", _I32), ("tape_b", _I32), ("tape_imm", _I64),
               ("tape_hash", _I32), ("tape_len", _I32))
#: rows one group launch of K3 takes (``k3::MAX_ROWS``)
MAX_GROUP_ROWS = 16


def _DEAD():
    """An empty slot of :class:`TapeAppend`, called like a dead weak
    reference."""
    return None


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TapeAppend:
    """K3's launch descriptor: the tape's six pointers, marshaled for a
    loop over one frontier and kept up to date from append to append.

    :meth:`bind` compares each tape tensor with the one its slot holds, by
    object, and checks (device, dtype, shape, contiguity) and re-marshals
    only the tensors that changed: the engine appends in place, and
    replaces the tape only where ``expand_forks`` and the migrations
    gather a new one. :meth:`append` and :meth:`append_group` then check
    and marshal only their row inputs. ``sym_run`` builds one per call;
    a wrapper given none builds its own. It holds the tape tensors by weak
    reference: a tape the loop has replaced is freed as it was without the
    descriptor, and a slot whose tensor is gone is marshaled again."""

    def __init__(self, lib, stream: int, device):
        self.lib, self.stream, self.device = lib, stream, _device(device)
        self._ptrs = (ctypes.c_uint64 * len(TAPE_FIELDS))()
        self._c_ptrs = ctypes.cast(self._ptrs, ctypes.c_void_p)
        self._held = [_DEAD] * len(TAPE_FIELDS)
        self.P = self.T = None
        #: tape tensors checked and marshaled so far
        self.refreshed = 0

    @classmethod
    def on_card(cls, device) -> "TapeAppend":
        """A descriptor for the nvcc build on ``device``'s current stream."""
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"K3: expected a CUDA tensor, got one on {dev}")
        return cls(_lib("tape_append"), _stream(dev), dev)

    def _check(self, t, what, dtype, shape):
        if t.device != self.device:
            raise ValueError(f"{what}: expected a tensor on {self.device}, got {t.device}")
        _check_layout(t, what, dtype, shape)

    def bind(self, tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len):
        """Point the descriptor at these tape tensors."""
        tape = (tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len)
        held = self._held
        if all(t is h() for t, h in zip(tape, held)):
            return
        P, T = tape_op.shape
        if (P, T) != (self.P, self.T):
            self.P, self.T = P, T
            held[:] = [_DEAD] * len(held)
        for i, (t, (name, dtype)) in enumerate(zip(tape, TAPE_FIELDS)):
            if t is not held[i]():
                shape = (P,) if name == "tape_len" else (P, T, 8) if name == "tape_imm" else (P, T)
                self._check(t, f"tape_append {name}", dtype, shape)
                self._ptrs[i] = t.data_ptr()
                held[i] = weakref.ref(t)
                self.refreshed += 1

    def _rows(self, what, rows):
        """The row inputs' pointers, each checked: (tensor, name, dtype,
        shape)."""
        dev = self.device
        for t, name, dtype, shape in rows:
            if t.dtype != dtype or t.shape != shape or t.device != dev or not t.is_contiguous():
                self._check(t, f"{what} {name}", dtype, shape)
        return [t.data_ptr() for t, *_ in rows]

    def append(self, op, a, b, imm, mask):
        """One row per lane (``op``, ``a``, ``b`` int32[P], ``imm``
        int64[P, 8], ``mask`` bool[P]) -> (ids int32[P], overflow
        bool[P])."""
        P, dev = self.P, self.device
        ptrs = self._rows("tape_append", (
            (op, "op", _I32, (P,)), (a, "a", _I32, (P,)), (b, "b", _I32, (P,)),
            (imm, "imm", _I64, (P, 8)), (mask, "mask", _B, (P,))))
        ids = torch.empty(P, dtype=_I32, device=dev)
        overflow = torch.empty(P, dtype=_B, device=dev)
        _raise_on(self.lib.tape_append(self._c_ptrs, self.T, *ptrs, ids.data_ptr(),
                                       overflow.data_ptr(), P, self.stream), "tape_append")
        tape_append.launches += 1
        return ids, overflow

    def append_group(self, op, a, b, a_src, b_src, imm, mask):
        """R rows per lane in one launch, in order (``op``, ``a``, ``b``,
        ``a_src``, ``b_src`` int32[P, R], ``imm`` int64[P, R, 8], ``mask``
        bool[P, R]); ``a_src[p, r]`` in [0, r) makes the operand the output
        of that earlier row, anything else the literal ``a[p, r]``. ->
        (out int32[P, R]: each row's id where masked in, its resolved a
        where not; overflow bool[P]: any row overflowed)."""
        P, dev = self.P, self.device
        if op.dim() != 2 or not 1 <= op.shape[1] <= MAX_GROUP_ROWS:
            raise ValueError(f"tape_append_group: op must be [P, R] with 1 <= R <= "
                             f"{MAX_GROUP_ROWS}, got {tuple(op.shape)}")
        R = op.shape[1]
        ptrs = self._rows("tape_append_group", (
            (op, "op", _I32, (P, R)), (a, "a", _I32, (P, R)), (b, "b", _I32, (P, R)),
            (a_src, "a_src", _I32, (P, R)), (b_src, "b_src", _I32, (P, R)),
            (imm, "imm", _I64, (P, R, 8)), (mask, "mask", _B, (P, R))))
        out = torch.empty((P, R), dtype=_I32, device=dev)
        overflow = torch.empty(P, dtype=_B, device=dev)
        _raise_on(self.lib.tape_append_group(self._c_ptrs, self.T, *ptrs, out.data_ptr(),
                                             overflow.data_ptr(), P, R, self.stream),
                  "tape_append_group")
        tape_append_group.launches += 1
        return out, overflow


@_launch_counter
def tape_append(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                op, a, b, imm, mask, k3: TapeAppend = None):
    """K3, in place on the tape tensors. Returns (ids int32[P],
    overflow bool[P]). ``k3``: the loop's descriptor, bound to this tape
    here; None: a descriptor of its own, every tensor checked."""
    k3 = k3 or TapeAppend.on_card(tape_op.device)
    k3.bind(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len)
    return k3.append(op, a, b, imm, mask)


@_launch_counter
def tape_append_group(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                      op, a, b, a_src, b_src, imm, mask, k3: TapeAppend = None):
    """K3's group entry point (:meth:`TapeAppend.append_group`), in place
    on the tape tensors. -> (out int32[P, R], overflow bool[P])."""
    k3 = k3 or TapeAppend.on_card(tape_op.device)
    k3.bind(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len)
    return k3.append_group(op, a, b, a_src, b_src, imm, mask)


def sha256_call(fn, stream: int, data, length, mask=None):
    """One launch of K4's C entry point ``fn`` (the nvcc build's; the CPU
    tests pass a host build's) on ``uint8[P, N]`` rows, each tensor checked
    to lie on ``data``'s device -> ``int64[P, 8]``: the digests of the
    lanes ``mask`` (``bool[P]``, optional) selects, zeros elsewhere."""
    if data.dim() != 2:
        raise ValueError("sha256: data must be [P, N]")
    P, N = data.shape
    for t, what in ((length, "length"), (mask, "mask")):
        if t is not None and t.device != data.device:
            raise ValueError(f"sha256 {what}: expected a tensor on {data.device}, got {t.device}")
    _check_layout(data, "sha256 data", torch.uint8, (P, N))
    _check_layout(length, "sha256 length", torch.int32, (P,))
    if mask is not None:
        _check_layout(mask, "sha256 mask", torch.bool, (P,))
    out = torch.empty((P, 8), dtype=torch.int64, device=data.device)
    _raise_on(fn(data.data_ptr(), length.data_ptr(), None if mask is None else mask.data_ptr(),
                 out.data_ptr(), P, N, stream), "sha256")
    return out


@_launch_counter
def sha256(data: torch.Tensor, length: torch.Tensor, mask: torch.Tensor = None):
    """K4: data ``uint8[P, N]``, length ``int32[P]`` -> ``int64[P, 8]``;
    with ``mask`` (``bool[P]``) only the selected lanes, zeros elsewhere."""
    dev = data.device
    _check(data, "sha256 data", torch.uint8, data.shape, dev)
    out = sha256_call(_lib("sha256").sha256, _stream(dev), data, length, mask)
    sha256.launches += 1
    return out


def bind_modexp(lib):
    """Argument and result types of K5's entry point on a loaded library
    (the nvcc build here; the CPU tests' host build of the same body)."""
    vp = ctypes.c_void_p
    lib.modexp_u256.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp]
    lib.modexp_u256.restype = ctypes.c_int


def modexp_call(fn, stream: int, base, e, m):
    """One launch of K5's C entry point ``fn`` (the nvcc build's; the CPU
    tests pass a host build's) on int64 carrier words ``[..., 8]``, each
    checked to lie on ``base``'s device -> base ** e mod m."""
    dev = base.device
    for t, what in ((base, "base"), (e, "e"), (m, "m")):
        if t.device != dev:
            raise ValueError(f"modexp_u256 {what}: expected a tensor on {dev}, got {t.device}")
        _check_layout(t, f"modexp_u256 {what}", torch.int64, base.shape)
    if base.shape[-1] != 8:
        raise ValueError("modexp_u256: last dim must be 8 limbs")
    out = torch.empty_like(base)
    _raise_on(fn(base.data_ptr(), e.data_ptr(), m.data_ptr(), out.data_ptr(),
                 base.numel() // 8, stream), "modexp_u256")
    return out


@_launch_counter
def modexp_u256(base: torch.Tensor, e: torch.Tensor, m: torch.Tensor):
    """K5 on int64 carrier words ``[..., 8]`` -> base ** e mod m."""
    dev = base.device
    _check(base, "modexp_u256 base", torch.int64, base.shape, dev)
    out = modexp_call(_lib("u256_modexp").modexp_u256, _stream(dev), base, e, m)
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


# K6's tensors in the order of its C interface (csrc/propagate_sweep.cu),
# with their dtypes and shapes
SWEEP_TENSORS = (
    ("tape_op", _I32, "PT"), ("tape_a", _I32, "PT"), ("tape_b", _I32, "PT"),
    ("tape_imm", _I64, "PT8"), ("tape_len", _I32, "P"), ("prop_len", _I32, "P"),
    ("iv_lo", _I64, "PT8"), ("iv_hi", _I64, "PT8"), ("kb_m", _I64, "PT8"), ("kb_v", _I64, "PT8"),
    ("con_node", _I32, "PC"), ("con_sign", _B, "PC"), ("con_len", _I32, "P"))


def sweep_call(fn, stream: int, *tensors):
    """One launch of K6's C entry point ``fn`` (the nvcc build's; the CPU
    tests pass a host build's) on ``tensors`` in the order of
    ``SWEEP_TENSORS``, each checked to lie on the first one's device. ->
    the per-lane infeasible flags ``bool[P]``."""
    dev = tensors[0].device
    P, T = tensors[0].shape
    C = tensors[10].shape[1]
    dims = {"PT": (P, T), "PT8": (P, T, 8), "P": (P,), "PC": (P, C)}
    for t, (name, dtype, shape) in zip(tensors, SWEEP_TENSORS):
        if t.device != dev:
            raise ValueError(f"propagate_sweep {name}: expected a tensor on {dev}, got {t.device}")
        _check_layout(t, f"propagate_sweep {name}", dtype, dims[shape])
    infeasible = torch.empty(P, dtype=_B, device=dev)
    _raise_on(fn(*(t.data_ptr() for t in tensors), infeasible.data_ptr(), P, T, C, stream),
              "propagate_sweep")
    return infeasible


@_launch_counter
def propagate_sweep(tape_op, tape_a, tape_b, tape_imm, tape_len, prop_len,
                    iv_lo, iv_hi, kb_m, kb_v, con_node, con_sign, con_len):
    """K6, in place on ``prop_len`` and the four domain tensors. Returns
    the per-lane infeasible flags ``bool[P]``."""
    dev = tape_op.device
    if not tape_op.is_cuda:
        raise ValueError(f"propagate_sweep: expected CUDA tensors, got {dev}")
    infeasible = sweep_call(_lib("propagate_sweep").propagate_sweep, _stream(dev), tape_op,
                            tape_a, tape_b, tape_imm, tape_len, prop_len, iv_lo, iv_hi, kb_m,
                            kb_v, con_node, con_sign, con_len)
    propagate_sweep.launches += 1
    return infeasible


# fork policies as K7 numbers them (csrc/fork_expand.cuh)
FORK_POLICIES = ("fifo", "shallow", "deep", "random", "weighted", "coverage", "beam")
# The fields the plan and the fix-ups name, first in K7's field table in
# this order (``k7::F_*`` in csrc/fork_expand.cuh): (path, dtype, shape);
# every other lane-axis field of the frontier follows, in field order.
FORK_NAMED = (
    ("base.active", _B, ("P",)), ("fork_req", _B, ("P",)), ("con_len", _I32, ("P",)),
    ("fork_dest", _I32, ("P",)), ("base.contract_id", _I32, ("P",)), ("base.pc", _I32, ("P",)),
    ("base.sp", _I32, ("P",)), ("dropped_forks", _I32, ("P",)), ("fork_cslot", _I32, ("P",)),
    ("call_enum", _I32, ("P",)), ("fork_cval", _I64, ("P", 8)),
    ("base.stack", _I64, ("P", "S", 8)), ("stack_sym", _I32, ("P", "S")),
    ("con_sign", _B, ("P", "C")), ("base.gas_min", _I64, ("P",)),
    ("base.gas_max", _I64, ("P",)), ("base.error", _B, ("P",)), ("base.err_code", _I32, ("P",)),
    ("lb_key", _I64, ("P", "LBS")), ("lb_cnt", _I32, ("P", "LBS")), ("lb_len", _I32, ("P",)))
# the pointers before the fields (``k7::X_*``): the profiler's rows, its
# sidecar and the run total of dropped forks are written in place too;
# the plan's outputs, the copy list and its length are the descriptor's;
# the coverage bitmap comes with each call
FORK_EXTRA = (("base.op_hist", _I32, ("P", 256)), ("base.op_resid", _I32, (256,)),
              ("dropped_total", _I32, ()))
FORK_EXTRA_PATHS = tuple(p for p, *_ in FORK_EXTRA)
_X_OUT_I, _X_OUT_B, _X_LIST, _X_COUNT, _X_VISITED, _N_EXTRA = range(3, 9)
(_I_P, _I_B, _I_POLICY, _I_C, _I_S, _I_LBS, _I_VC, _I_VM, _I_DEFER, _I_LOOP_BOUND, _I_TRAP,
 _I_N_FIELDS, _N_INTS) = range(13)
# ``k7::MAX_FIELDS``, and the largest fork block the plan's block sorts
FORK_MAX_FIELDS = 192
FORK_MAX_BLOCK = 8192
# fields that are not rows of the lane axis: run totals and the sidecar
_NOT_ROWS = frozenset(("base", "op_hist", "op_resid", "killed_total", "dropped_total"))


def bind_fork_expand(lib):
    """Argument and result types of K7's entry point on a loaded library
    (the nvcc build here; the CPU tests' host build of the same bodies)."""
    lib.fork_expand.argtypes = [ctypes.c_void_p] * 3
    lib.fork_expand.restype = ctypes.c_int


def fork_field(sf, path):
    """The field of ``sf`` at ``path`` (``"base.pc"``, ``"fork_req"``)."""
    owner, _, name = path.rpartition(".")
    return (sf.base if owner else sf).__dict__[name]


def fork_rows(sf):
    """The paths of every lane-axis field a fork expansion copies rows of,
    in K7's table order: ``FORK_NAMED`` first, then the rest in field
    order (the profiler's rows apart: a copy zeroes its row)."""
    import dataclasses

    named = [p for p, *_ in FORK_NAMED]
    rest = [f"base.{f.name}" for f in dataclasses.fields(sf.base) if f.name not in _NOT_ROWS]
    rest += [f.name for f in dataclasses.fields(sf) if f.name not in _NOT_ROWS]
    return named + [p for p in rest if p not in named]


class ForkExpand:
    """K7's launch descriptor: the pointers and row bytes of every field a
    fork expansion writes, marshaled for a loop over one frontier and kept
    up to date from expansion to expansion.

    Ownership rule: K7 writes in place on every lane-axis field, so its
    caller owns them all (``sym_run`` copies them once on entry,
    ``symbolic.engine.own_loop_fields``; the functional ``expand_forks``
    copies the frontier first). :meth:`bind` compares each field's tensor
    with the one its slot holds, by object, and only for the tensors that
    changed checks device, dtype and shape, makes a non-contiguous one (an
    expanded view a handler handed over) contiguous, once, and checks that
    its memory overlaps no other slot's: two fields that share memory
    raise, naming both. It holds the tensors by weak reference, so a field
    the loop replaced is freed as it was without the descriptor.

    On the card :meth:`expand` is one checked C call: the plan, the row
    copy and the fix-ups (csrc/fork_plan.cu). With no library (a CPU
    frontier) the descriptor only binds: the engine's plain in-place route
    does the work."""

    def __init__(self, lib, stream: int, device):
        self.fn = lib.fork_expand if lib is not None else None
        self.stream, self.device = stream, _device(device)
        self._ptrs = (ctypes.c_uint64 * (_N_EXTRA + FORK_MAX_FIELDS))()
        self._ints = (ctypes.c_int32 * (_N_INTS + FORK_MAX_FIELDS))()
        self._c_ptrs = ctypes.cast(self._ptrs, ctypes.c_void_p)
        self._c_ints = ctypes.cast(self._ints, ctypes.c_void_p)
        self.paths = None
        self.out_i = self.out_b = self.list = self.count = None
        #: slots checked and re-marshaled so far
        self.refreshed = 0

    @classmethod
    def on_card(cls, device) -> "ForkExpand":
        """A descriptor for the nvcc build on ``device``'s current stream."""
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"K7: expected a CUDA tensor, got one on {dev}")
        return cls(_lib("fork_plan"), _stream(dev), dev)

    @property
    def rows(self):
        """The paths of the fields whose rows a copy takes, in table order."""
        return self.paths[len(FORK_EXTRA):]

    @classmethod
    def for_frontier(cls, sf) -> "ForkExpand":
        """The card's descriptor for a frontier on the card, else one that
        only binds (the plain route's ownership checks)."""
        dev = sf.base.pc.device
        return cls.on_card(dev) if dev.type == "cuda" else cls(None, 0, dev)

    def _layout(self, sf):
        """Forget every slot and take the layout of ``sf``: its field paths,
        the named fields' dims and the plan's buffers."""
        from ..core.frontier import Trap

        paths = fork_rows(sf)
        if len(paths) > FORK_MAX_FIELDS:
            raise ValueError(f"fork_plan: {len(paths)} lane-axis fields, more than "
                             f"{FORK_MAX_FIELDS}")
        b = sf.base
        P = b.pc.shape[0]
        self.dims = dict(P=P, S=b.stack.shape[1], C=sf.con_sign.shape[1],
                         LBS=sf.lb_key.shape[1])
        self.paths = list(FORK_EXTRA_PATHS) + paths
        n = len(self.paths)
        self._shapes = [None] * n
        for i, (_, dtype, shape) in enumerate(FORK_EXTRA + FORK_NAMED):
            self._shapes[i] = (dtype, tuple(self.dims.get(d, d) for d in shape))
        self._held = [_DEAD] * n
        self._lo, self._hi, self._skey = [0] * n, [0] * n, [0] * n
        self._on = {}  # storage -> the slots on it
        self._ptrs[:] = [0] * len(self._ptrs)
        self._ints[:] = [0] * len(self._ints)
        for k, v in ((_I_P, P), (_I_C, self.dims["C"]), (_I_S, self.dims["S"]),
                     (_I_LBS, self.dims["LBS"]), (_I_TRAP, Trap.LOOP_BOUND),
                     (_I_N_FIELDS, len(paths))):
            self._ints[k] = v
        if self.fn is None:  # binds only: the plain route plans for itself
            return
        dev = self.device
        self.out_i = torch.zeros((9, P), dtype=_I32, device=dev)
        self.out_b = torch.zeros((4, P), dtype=_B, device=dev)
        self.list = torch.zeros(P, dtype=_I32, device=dev)
        self.count = torch.zeros(1, dtype=_I32, device=dev)
        for k, t in ((_X_OUT_I, self.out_i), (_X_OUT_B, self.out_b), (_X_LIST, self.list),
                     (_X_COUNT, self.count)):
            self._ptrs[k] = t.data_ptr()

    def _release(self, i: int):
        key = self._skey[i]
        if key:
            on = self._on[key]
            on.remove(i)
            if not on:
                del self._on[key]
            self._skey[i] = 0

    def _set(self, i: int, t):
        """Check ``t`` against slot ``i`` (released) and point the slot at it;
        its byte range must overlap no other slot's on its storage."""
        path = self.paths[i]
        self._held[i] = _DEAD if t is None else weakref.ref(t)
        self.refreshed += 1
        slot = i if i < len(FORK_EXTRA) else _N_EXTRA + i - len(FORK_EXTRA)
        if t is None:
            if path not in ("base.op_hist", "base.op_resid"):
                raise ValueError(f"fork_plan: {path} is required")
            self._ptrs[slot] = self._lo[i] = self._hi[i] = 0
            return
        if t.device != self.device:
            raise ValueError(f"fork_plan {path}: expected a tensor on {self.device}, "
                             f"got {t.device}")
        want = self._shapes[i]
        if want is None:  # a row field: its lanes, then what it was at the layout
            if t.dim() == 0 or t.shape[0] != self.dims["P"]:
                raise ValueError(f"fork_plan {path}: expected {self.dims['P']} lanes, got "
                                 f"shape {tuple(t.shape)}")
            self._shapes[i] = want = (t.dtype, tuple(t.shape))
        _check_layout(t, f"fork_plan {path}", *want)
        p, n = t.data_ptr(), t.nbytes
        self._ptrs[slot] = p
        if i >= len(FORK_EXTRA):
            self._ints[_N_INTS + i - len(FORK_EXTRA)] = n // self.dims["P"]
        self._lo[i], self._hi[i] = p, p + n
        if not n:
            return
        key = t.untyped_storage().data_ptr()
        for j in self._on.get(key, ()):
            if self._lo[j] < p + n and self._hi[j] > p:
                raise ValueError(f"fork_plan: {self.paths[j]} and {path} share memory, and "
                                 "K7 writes both in place")
        self._on.setdefault(key, []).append(i)
        self._skey[i] = key

    def bind(self, sf):
        """Point the descriptor at the fields of ``sf``; -> ``sf``, with a
        contiguous copy of any field that was not contiguous. A frontier of
        another layout (lanes, or a field's shape or dtype) is marshaled
        anew."""
        if self.paths is None or sf.base.pc.shape[0] != self.dims["P"]:
            self._layout(sf)
        try:
            return self._bind(sf)
        except ValueError:
            self._layout(sf)
            return self._bind(sf)

    def _bind(self, sf):
        held, todo = self._held, []
        for i, path in enumerate(self.paths):
            t = fork_field(sf, path)
            if t is not held[i]():
                todo.append((i, t))
        if not todo:
            return sf
        fixed = {}
        for i, t in todo:
            if t is not None and not t.is_contiguous():
                t = t.contiguous()
                fixed[self.paths[i]] = t
            self._release(i)
        for i, t in todo:
            self._set(i, fixed.get(self.paths[i], t))
        if fixed:
            base = {k[5:]: v for k, v in fixed.items() if k.startswith("base.")}
            sf = sf.replace(base=sf.base.replace(**base),
                            **{k: v for k, v in fixed.items() if not k.startswith("base.")})
        return sf

    def expand(self, sf, *, block: int, policy: str, defer: bool, loop_bound: int = 0,
               visited=None):
        """One fork expansion in place on ``sf``'s fields, which the caller
        owns: K7's plan, row copy and fix-ups. -> ``sf`` (as :meth:`bind`
        returns it)."""
        if self.fn is None:
            raise ValueError(f"K7: expected a CUDA tensor, got one on {self.device}")
        sf = self.bind(sf)
        P = self.dims["P"]
        if block <= 0 or P % block:
            raise ValueError(f"fork_plan: fork block {block} must divide P={P}")
        if block > FORK_MAX_BLOCK:
            raise ValueError(f"fork_plan: a fork block of {block} lanes is more than the "
                             f"{FORK_MAX_BLOCK} one plan block sorts")
        vc = vm = 0
        vptr = 0
        if visited is not None:
            vc, vm = visited.shape
            if visited.device != self.device:
                raise ValueError(f"fork_plan visited: expected a tensor on {self.device}, "
                                 f"got {visited.device}")
            _check_layout(visited, "fork_plan visited", _B, (vc, vm))
            vptr = visited.data_ptr()
        ints = self._ints
        ints[_I_B], ints[_I_POLICY], ints[_I_DEFER] = block, FORK_POLICIES.index(policy), int(defer)
        ints[_I_LOOP_BOUND], ints[_I_VC], ints[_I_VM] = loop_bound, vc, vm
        self._ptrs[_X_VISITED] = vptr
        _raise_on(self.fn(self._c_ptrs, self._c_ints, self.stream), "fork_plan")
        fork_plan.launches += 1
        return sf


@_launch_counter
def fork_plan(sf, *, block: int, policy: str, defer: bool, loop_bound: int = 0, visited=None,
              k7: ForkExpand = None):
    """K7: the whole fork expansion of ``expand_forks`` — the fork map for
    every fork block of ``block`` lanes, each copy lane's rows of every
    field from its source, and the fix-ups — in place on the fields of
    ``sf``, which the caller owns. ``visited`` is the coverage bitmap
    ``bool[C, MC]`` or None. ``k7``: the loop's descriptor; None: a
    descriptor of its own. -> ``sf``."""
    k7 = k7 or ForkExpand.on_card(sf.base.pc.device)
    return k7.expand(sf, block=block, policy=policy, defer=defer, loop_bound=loop_bound,
                     visited=visited)


# ---------------------------------------------------------------------------
# K10: the concrete EVM step (csrc/evm_step.cu)
# ---------------------------------------------------------------------------

# The pointers K10 takes, in the order of ``EVM_PTR_FIELDS`` in
# csrc/evm_step.cuh: (name, where, dtype, shape). ``where`` is the
# frontier ("f", the kernel's ``is_static`` is the field ``static``), the
# env ("env"), the corpus ("corpus"), the opcode tables ("tab", the
# ``Tables`` attribute) or the step itself ("step": the prologue's op,
# run and old_pc, dispatch's skip mask, the fused entry point's count of
# lanes still running). Shapes name the dims.
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
    ("n_running", "step", _I32, (1,)),
)
EVM_DIMS = ("P", "S", "M", "CD", "RD", "K", "A", "LS", "IC", "MC", "C")
# The frontier fields each entry point writes, in place. Ownership rule:
# K10 writes only fields its caller owns. A loop owns once — ``run`` and
# ``sym_run`` copy these fields on entry (``own_evm_fields``) and every
# superstep of the call then runs in place on them — and a standalone
# call (a wrapper given no descriptor, ``superstep``, ``sym_superstep``)
# copies the fields it writes first. So a tensor a caller holds is never
# changed.
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
EVM_ENTRIES = ("prologue", "dispatch", "epilogue", "superstep")


def bind_evm_step(lib):
    """Argument and result types of K10's entry points on a loaded library
    (the nvcc build here; the CPU tests' host build of the same body)."""
    for name in EVM_ENTRIES:
        fn = getattr(lib, f"evm_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if hasattr(lib, "evm_block_threads"):
        lib.evm_block_threads.argtypes = [ctypes.c_int]
        lib.evm_block_threads.restype = ctypes.c_int


def own_evm_fields(f, entry: str = "superstep"):
    """``f`` with fresh, contiguous copies of the fields ``entry`` writes.
    ``own_evm_fields.calls`` counts the calls (a loop makes one)."""
    own_evm_fields.calls += 1
    return f.replace(**{k: getattr(f, k).clone(memory_format=torch.contiguous_format)
                        for k in EVM_WRITES[entry] if getattr(f, k) is not None})


own_evm_fields.calls = 0

_SLOT = {name: i for i, (name, *_) in enumerate(EVM_FIELDS)}
# the slots some entry point writes: one of them may share memory with no
# other slot (the aliasing check of EvmStep)
_WRITTEN = frozenset([_SLOT[k] for k in EVM_WRITES["superstep"]]
                     + [_SLOT[k] for k in ("op", "run", "old_pc", "n_running")])
# the slots whose shapes give the dims (EvmStep._layout)
_DIM_SLOTS = frozenset(_SLOT[k] for k in ("pc", "stack", "memory", "calldata", "retval",
                                          "st_used", "acct_used", "log_pc", "init_code",
                                          "code"))
# what each entry point reads of env and corpus
_READS = {"prologue": ("corpus",), "dispatch": ("env", "corpus"), "epilogue": (),
          "superstep": ("env", "corpus")}


class EvmStep:
    """K10's launch descriptor: the pointer and dims arrays its entry
    points take, built once per frontier layout (the dims of
    ``EVM_DIMS``) and kept up to date from launch to launch.

    :meth:`bind` compares each tensor it is given with the one its slot
    holds, by object; only the slots whose tensor changed are checked
    (device, dtype, shape, contiguity: a bad tensor raises there) and
    re-marshaled, and its byte range is checked against every other
    slot's where either of the two is written: K10 writes in place, so a
    written field that shared memory with another would change it. An
    overlap raises, naming both fields. The opcode tables are marshaled
    once. :meth:`launch` is the bare C call.

    The descriptor owns the step's buffers: the prologue writes ``op``,
    ``run`` and ``old_pc`` (a copy of the pre-step pc) here, and the fused
    entry point ``n_running``, the count of lanes still running after the
    step. The next prologue or fused launch overwrites them. It launches on
    ``stream`` and holds the tensors it points at until they are
    replaced."""

    def __init__(self, lib, stream: int, device, berlin: bool = False):
        from ..core.interpreter import Tables

        self.stream, self.device, self.berlin = stream, _device(device), berlin
        self._fns = {e: getattr(lib, f"evm_{e}") for e in EVM_ENTRIES}
        n = len(EVM_FIELDS)
        self._ptrs = (ctypes.c_uint64 * n)()
        self._c_ptrs = ctypes.cast(self._ptrs, ctypes.c_void_p)
        self._c_dims = (ctypes.c_int * len(EVM_DIMS))()
        self._c_dims_p = ctypes.cast(self._c_dims, ctypes.c_void_p)
        self._dims = None
        self._groups = {w: [(i, name) for i, (name, where, _, _) in enumerate(EVM_FIELDS)
                            if where == w] for w in ("f", "env", "corpus")}
        tb = Tables.on(self.device)
        tabs = {name: getattr(tb, name) for name, where, _, _ in EVM_FIELDS if where == "tab"}
        if berlin:
            tabs.update(GAS_MIN=tb.GAS_MIN_BERLIN, GAS_MAX=tb.GAS_MAX_BERLIN)
        self._tabs = [(_SLOT[k], t) for k, t in tabs.items()]
        self.op = self.run = self.old_pc = self.n_running = None
        #: slots checked and re-marshaled so far
        self.refreshed = 0

    @classmethod
    def on_card(cls, device, berlin: bool = False) -> "EvmStep":
        """A descriptor for the nvcc build on ``device``'s current stream."""
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"K10: expected a CUDA tensor, got one on {dev}")
        return cls(_lib("evm_step"), _stream(dev), dev, berlin)

    def _layout(self, f, corpus) -> bool:
        """Take the dims of ``f`` (and ``corpus``, when given); on a new
        layout forget every slot and allocate the step's buffers."""
        dims = dict(P=f.pc.shape[0], S=f.stack.shape[1], M=f.memory.shape[1],
                    CD=f.calldata.shape[1], RD=f.retval.shape[1], K=f.st_used.shape[1],
                    A=f.acct_used.shape[1], LS=f.log_pc.shape[1], IC=f.init_code.shape[1],
                    MC=0, C=0)
        if corpus is not None:
            dims.update(MC=corpus.code.shape[1], C=corpus.code.shape[0])
        elif self._dims is not None:
            dims.update(MC=self._dims["MC"], C=self._dims["C"])
        if dims == self._dims:
            return False
        n = len(EVM_FIELDS)
        self._dims = dims
        self._c_dims[:] = [dims[d] for d in EVM_DIMS]
        self._ptrs[:] = [0] * n
        self._shapes = [tuple(dims.get(d, d) for d in shape) for *_, shape in EVM_FIELDS]
        self._held = [None] * n
        self._lo = [0] * n
        self._hi = [0] * n
        self._on = {}  # storage -> the slots on it
        self._skey = [0] * n
        P = dims["P"]
        self.op = torch.zeros(P, dtype=_I32, device=self.device)
        self.run = torch.zeros(P, dtype=_B, device=self.device)
        self.old_pc = torch.zeros(P, dtype=_I32, device=self.device)
        self.n_running = torch.zeros(1, dtype=_I32, device=self.device)
        for i, t in self._tabs:
            self._set(i, t)
        return True

    def _release(self, i: int):
        """Take slot ``i`` out of the storage map."""
        key = self._skey[i]
        if key:
            on = self._on[key]
            on.remove(i)
            if not on:
                del self._on[key]
            self._skey[i] = 0

    def _set(self, i: int, t):
        """Check ``t`` against slot ``i`` (released) and point the slot at
        it. Two tensors share memory only through one storage (the
        allocator's blocks are disjoint), so ``t``'s byte range is checked
        against the slots on its storage: an overlap where either slot is
        written raises."""
        name, _, dtype, _ = EVM_FIELDS[i]
        self._held[i] = t
        self.refreshed += 1
        if t is None:
            if name not in ("op_hist", "skip"):
                raise ValueError(f"evm_step: {name} is required")
            self._ptrs[i] = self._lo[i] = self._hi[i] = 0
            return
        if t.device != self.device:
            raise ValueError(f"evm_step {name}: expected a tensor on {self.device}, "
                             f"got {t.device}")
        if t.dtype != dtype or t.shape != self._shapes[i] or not t.is_contiguous():
            _check_layout(t, f"evm_step {name}", dtype, self._shapes[i])
        p, n = t.data_ptr(), t.nbytes
        if name == "memory" and p % 8:
            raise ValueError("evm_step memory: K10's SHA3 reads a lane's row by aligned 8-byte "
                             "words, so the field must start on an 8-byte boundary")
        self._ptrs[i] = p
        self._lo[i], self._hi[i] = p, p + n
        if not n:
            return
        key = t.untyped_storage().data_ptr()
        for j in self._on.get(key, ()):
            if (i in _WRITTEN or j in _WRITTEN) and self._lo[j] < p + n and self._hi[j] > p:
                x, y = (name, EVM_FIELDS[j][0]) if i in _WRITTEN else (EVM_FIELDS[j][0], name)
                raise ValueError(f"evm_step: {x} and {y} share memory, and K10 writes {x} "
                                 "in place")
        self._on.setdefault(key, []).append(i)
        self._skey[i] = key

    def bind(self, entry: str, f, env=None, corpus=None, op=None, run=None, old_pc=None,
             skip=None):
        """Point the descriptor at the tensors of one ``entry`` launch:
        frontier ``f``, ``env`` and ``corpus`` where ``entry`` reads them
        (required there, else ignored), and for dispatch and epilogue the
        prologue's ``op``, ``run`` and ``old_pc`` and dispatch's ``skip``."""
        reads = _READS[entry]
        srcs = [(self._groups["f"], f.__dict__)]
        for w, src in (("env", env), ("corpus", corpus)):
            if w in reads:
                if src is None:
                    raise ValueError(f"evm_{entry}: {w} is required")
                srcs.append((self._groups[w], src.__dict__))

        def stale():
            held = self._held
            return [(i, d[name]) for g, d in srcs for i, name in g if d[name] is not held[i]]

        todo = None if self._dims is None else stale()
        if todo is None or any(i in _DIM_SLOTS for i, _ in todo):
            if self._layout(f, corpus if "corpus" in reads else None):
                todo = stale()
        if entry in ("prologue", "superstep"):
            step = {"op": self.op, "run": self.run, "old_pc": self.old_pc}
        elif op is None or run is None or old_pc is None:
            raise ValueError(f"evm_{entry}: op, run and old_pc are required")
        else:
            step = {"op": op, "run": run, "old_pc": old_pc}
        if entry == "dispatch":  # the only entry point that reads it
            step["skip"] = skip
        step["n_running"] = self.n_running
        held = self._held
        todo += [(_SLOT[k], t) for k, t in step.items() if t is not held[_SLOT[k]]]
        for i, _ in todo:
            self._release(i)
        for i, t in todo:
            self._set(i, t)

    def launch(self, entry: str):
        """One launch of ``entry`` on what :meth:`bind` last pointed at."""
        _raise_on(self._fns[entry](self._c_ptrs, self._c_dims_p, self.stream), f"evm_{entry}")
        _EVM_WRAPPERS[entry].launches += 1


def evm_step_call(entry: str, k10: EvmStep, f, env, corpus, *, op=None, run=None,
                  old_pc=None, skip=None):
    """The one route from Python to K10's entry points: bind ``k10`` to
    these tensors and launch ``entry`` (prologue, dispatch, epilogue or
    superstep), in place on the fields of ``f`` it writes, which the
    caller owns. -> (frontier, op, run, old_pc): the prologue's are the
    descriptor's buffers, the others' what was passed."""
    k10.bind(entry, f, env, corpus, op, run, old_pc, skip)
    k10.launch(entry)
    if entry == "prologue":
        return f, k10.op, k10.run, k10.old_pc
    return f, op, run, old_pc


def _evm_launch(entry, f, env, corpus, k10, berlin=False, **step):
    """Without a descriptor: a standalone launch on the card, on copies of
    the fields ``entry`` writes. With one: in place, the caller owning."""
    if k10 is None:
        k10 = EvmStep.on_card(f.pc.device, berlin)
        f = own_evm_fields(f, entry)
    elif berlin != k10.berlin and entry in ("prologue", "superstep"):
        raise ValueError(f"evm_{entry}: berlin={berlin} on a descriptor built with "
                         f"berlin={k10.berlin}")
    return evm_step_call(entry, k10, f, env, corpus, **step)


@_launch_counter
def evm_prologue(f, corpus, berlin: bool = False, k10: EvmStep = None):
    """K10 prologue -> (frontier, op int32[P], run bool[P], old_pc
    int32[P]); old_pc is a copy of the input's pc. ``k10``: the loop's
    descriptor, in place (:func:`evm_step_call`); None: on copies."""
    return _evm_launch("prologue", f, None, corpus, k10, berlin)


@_launch_counter
def evm_dispatch(f, env, corpus, op, run, old_pc, skip=None, k10: EvmStep = None):
    """K10 dispatch: each running lane not under ``skip`` runs its class
    handler and the stack writeback. -> frontier."""
    return _evm_launch("dispatch", f, env, corpus, k10, op=op, run=run, old_pc=old_pc,
                       skip=skip)[0]


@_launch_counter
def evm_epilogue(f, op, run, old_pc, k10: EvmStep = None):
    """K10 epilogue: pc advance, pc_hold reset, n_steps, iprof, OOG. ->
    frontier."""
    return _evm_launch("epilogue", f, None, None, k10, op=op, run=run, old_pc=old_pc)[0]


@_launch_counter
def evm_superstep(f, env, corpus, berlin: bool = False, k10: EvmStep = None):
    """K10 fused prologue -> dispatch -> epilogue; the descriptor's
    ``n_running`` then holds the lanes still running. -> frontier."""
    return _evm_launch("superstep", f, env, corpus, k10, berlin)[0]


def evm_block_threads(threads: int) -> int:
    """Set the threads per block of K10's launches, a multiple of 32 up to
    1024 (a measurement knob for ``chip_smoke.py``'s sweep; the build's
    default is in csrc/evm_step.cu). -> the previous value."""
    old = _lib("evm_step").evm_block_threads(threads)
    if old < 0:
        raise ValueError(f"evm_block_threads: {threads} threads per block refused")
    return old


KERNELS = {"divmod_u256": divmod_u256, "keccak256": keccak256,
           "tape_append": tape_append, "tape_append_group": tape_append_group,
           "sha256": sha256, "modexp_u256": modexp_u256,
           "propagate_sweep": propagate_sweep, "fork_plan": fork_plan,
           "mul_u256": mul_u256, "mod_wide_u256": mod_wide_u256, "exp_u256": exp_u256,
           "evm_prologue": evm_prologue, "evm_dispatch": evm_dispatch,
           "evm_epilogue": evm_epilogue, "evm_superstep": evm_superstep}
_EVM_WRAPPERS = {e: KERNELS[f"evm_{e}"] for e in EVM_ENTRIES}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
