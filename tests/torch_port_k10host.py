"""K10's per-lane body (``kernels/csrc/evm_step.cuh``) built as host C++,
with the K1, K2 and K9 bodies it shares (``u256.cuh``, ``keccak.cuh``) and
K4's (``sha256.cuh``).

``g++`` compiles the header with a small shim (``__device__`` and the
like defined away) into a library whose entry points loop the lanes, as
``evm_step.cu``'s kernels run one thread per lane; the fused one zeroes
and counts ``n_running`` as that kernel does with its memset and ballot.
The library also exports K1's and K9's C interfaces (``divmod_u256``,
``u256_mod_wide``, ``u256_exp``) as loops over the lanes of
``u256.cuh``'s ``divmod8``, ``mod_wide16`` and ``exp8``, and K2's and
K4's (``keccak256``, ``sha256``) as loops over ``keccak.cuh``'s and
``sha256.cuh``'s per-lane bodies.
The CPU tests drive it through the wrappers' own marshaling
(``kernels.EvmStep``, ``kernels.evm_step_call``) and hold it to the plain
versions. ``route`` makes the interpreter and the engine take it for a
CPU frontier, as they take the nvcc build for a CUDA one.
"""

import ctypes
import os
import subprocess
import tempfile

import torch_port_child

CSRC = os.path.join(torch_port_child.ROOT, "mythril_tpu_torch", "kernels", "csrc")

_SHIM_H = """// host build of the CUDA headers' device functions
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
static inline int __clz(unsigned int x) { return x ? __builtin_clz(x) : 32; }
static inline unsigned int __funnelshift_r(unsigned int lo, unsigned int hi, unsigned int s) {
  return (unsigned int)((((unsigned long long)hi << 32) | lo) >> (s & 31));
}
// byte n of the result = byte (nibble n of s) & 7 of {y:x}, x the low four
static inline unsigned int __byte_perm(unsigned int x, unsigned int y, unsigned int s) {
  unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned int r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned int)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
}
struct uint4 { unsigned int x, y, z, w; };
static inline uint4 make_uint4(unsigned int x, unsigned int y, unsigned int z, unsigned int w) {
  return uint4{x, y, z, w};
}
"""

_ENTRY = ('extern "C" int evm_{e}(const uint64_t* ptrs, const int* dims, void*) {{\n'
          "  evm::Frame f = evm::frame_from(ptrs, dims);\n"
          "{body}"
          "  return 0;\n}}\n")

# the kernels' entry points as loops over the lanes
_SHIM_CPP = "#include \"evm_step.cuh\"\n#include \"sha256.cuh\"\n" + "".join(
    _ENTRY.format(e=e, body=f"  for (int p = 0; p < f.P; ++p) evm::entry_{e}(f, p);\n")
    for e in ("prologue", "dispatch", "epilogue")) + _ENTRY.format(
    e="superstep", body="  *f.n_running = 0;\n"
                        "  for (int p = 0; p < f.P; ++p)\n"
                        "    if (evm::entry_superstep(f, p)) ++*f.n_running;\n") + """
// K1's and K9's bodies (u256.cuh) as loops over the lanes, with the C
// interfaces of u256_divmod.cu and u256_mulmod_exp.cu
extern "C" int divmod_u256(const int64_t* a, const int64_t* b, int64_t* q, int64_t* r,
                           int n, void*) {
  for (int p = 0; p < n; ++p) {
    uint32_t x[8], d[8], qq[8], rr[8];
    u256::load(a + 8 * p, x);
    u256::load(b + 8 * p, d);
    u256::divmod8(x, d, qq, rr);
    u256::store(q + 8 * p, qq);
    u256::store(r + 8 * p, rr);
  }
  return 0;
}
extern "C" int u256_mod_wide(const int64_t* x, const int64_t* m, int64_t* out, int n, void*) {
  for (int p = 0; p < n; ++p) {
    uint32_t xx[16], mm[8], rr[8];
    u256::load(x + 16 * p, xx, 16);
    u256::load(m + 8 * p, mm);
    u256::mod_wide16(xx, mm, rr);
    u256::store(out + 8 * p, rr);
  }
  return 0;
}
// K2's and K4's bodies (keccak.cuh, sha256.cuh) as loops over the lanes,
// with the C interfaces of keccak256.cu and sha256.cu
extern "C" int keccak256(const uint8_t* data, const int32_t* length, int64_t* out, int n,
                         int max_len, void*) {
  for (int p = 0; p < n; ++p) keccak::hash_row(data, length, out, p, n, max_len);
  return 0;
}
extern "C" int sha256(const uint8_t* data, const int32_t* len, const uint8_t* mask, int64_t* out,
                      int P, int N, void*) {
  bool vec = k4::vec_rows(data, N);
  for (int p = 0; p < P; ++p) {
    if (vec) k4::hash_row<true>(data, len, mask, out, p, N);
    else k4::hash_row<false>(data, len, mask, out, p, N);
  }
  return 0;
}
extern "C" int u256_exp(const int64_t* base, const int64_t* e, int64_t* out, int n, void*) {
  for (int p = 0; p < n; ++p) {
    uint32_t b[8], ee[8], acc[8];
    u256::load(base + 8 * p, b);
    u256::load(e + 8 * p, ee);
    u256::exp8(b, ee, acc);
    u256::store(out + 8 * p, acc);
  }
  return 0;
}
"""


def chip_smoke():
    """``chip_smoke.py`` as a module (its K10 batches and comparisons)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(torch_port_child.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(tmp=None) -> str:
    """Compile K10's body with g++ into ``tmp``; -> the library's path."""
    tmp = tmp or tempfile.mkdtemp(prefix="evm_step_host_")
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


def load(path):
    from mythril_tpu_torch import kernels

    lib = ctypes.CDLL(path)
    kernels.bind_evm_step(lib)
    return lib


def step(lib, device="cpu", berlin=False):
    """A K10 descriptor over the host build."""
    from mythril_tpu_torch import kernels

    return kernels.EvmStep(lib, 0, device, berlin)


def route(lib):
    """Make ``core.interpreter`` and ``symbolic.engine`` run K10's host
    build for a CPU frontier (``k10_for``): ``run``, ``sym_run`` and
    ``sym_superstep`` then take their card path, ownership included."""
    from mythril_tpu_torch.core import interpreter as ci

    ci.k10_for = lambda f, berlin=False: step(lib, f.pc.device, berlin)
