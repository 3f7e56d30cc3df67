"""K6's and K3's warp bodies (``kernels/csrc/propagate.cuh``,
``tape_append.cuh``), K5's quarter-warp body (``modexp.cuh``) and K7's
per-lane bodies (``fork_expand.cuh``) built as host C++ with their warps
emulated.

``g++`` compiles the headers with a shim: ``__device__`` and the like are
defined away, and a warp runs as a loop over 32 user-level threads
(``ucontext``) on one OS thread: each runs until it reaches a vote
(``__ballot_sync``), a shuffle (``__shfl_sync``) or ``__syncwarp``, and
when all 32 wait there the collective's results are handed out and the
next round starts, so that the threads take every round of the warp's
loops together, as on the card. The threads of a round run from the
highest to the lowest, so a read of another thread's write that no
collective orders shows as a wrong result; a collective that some
thread does not reach aborts the process. The library
exports the C entry points of ``propagate_sweep.cu`` and
``tape_append.cu`` with their signatures, one warp per lane, lane after
lane; ``u256_modexp.cu``'s, a warp per four lanes as on the card; and
``fork_plan.cu``'s ``fork_expand``, whose plan's sort and scans (a whole
block's work on the card) run serially here around the kernel's own
per-lane bodies, then the copy items and the fix-ups one after another.
The CPU tests drive them through the wrappers' own marshaling
(``kernels.sweep_call``, ``kernels.TapeAppend``, ``kernels.modexp_call``,
``kernels.ForkExpand``).
"""

import ctypes
import os
import subprocess
import tempfile

import torch_port_child

CSRC = os.path.join(torch_port_child.ROOT, "mythril_tpu_torch", "kernels", "csrc")

_SHIM_H = r"""// host build of the CUDA headers' device functions, warps emulated
#pragma once
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ucontext.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
#define __grid_constant__
static inline int __clz(unsigned int x) { return x ? __builtin_clz(x) : 32; }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline int min(int a, int b) { return a < b ? a : b; }
static inline int max(int a, int b) { return a > b ? a : b; }
// one OS thread: no other thread races an update
static inline int atomicAdd(int* a, int v) {
  int old = *a;
  *a = old + v;
  return old;
}

// A warp as 32 user-level threads on one OS thread: each runs until it
// reaches a collective, the next one then runs, and when all 32 wait at
// the collective its results are computed and the next round starts.
// Threads run from the highest to the lowest in a round, so that a thread
// reading what a lower one writes (a backward operand, the row thread 0
// appends) sees it only after a collective between the two, as the card
// promises.
namespace warp_host {
enum { SYNC = 1, BALLOT, SHFL };
constexpr int STACK = 1 << 18;
struct Warp {
  ucontext_t sched, th[32];
  char* stack[32];
  int kind[32], arg[32];
  uint32_t val[32], res[32];
  bool finished[32];
  int lane;
  void (*fn)(void*, int);
  void* env;
};
inline Warp* warp = nullptr;

inline uint32_t collective(int kind, uint32_t v, int arg) {
  Warp* w = warp;
  const int l = w->lane;
  w->kind[l] = kind;
  w->val[l] = v;
  w->arg[l] = arg;
  swapcontext(&w->th[l], &w->sched);
  return w->res[l];
}

inline void entry(int l) {
  warp->fn(warp->env, l);
  warp->finished[l] = true;
}

// runs fn(env, t) for t = 0..31 as one warp
inline void run(void (*fn)(void*, int), void* env) {
  Warp w;
  warp = &w;
  w.fn = fn;
  w.env = env;
  for (int l = 0; l < 32; ++l) {
    w.stack[l] = (char*)std::malloc(STACK);
    w.finished[l] = false;
    getcontext(&w.th[l]);
    w.th[l].uc_stack.ss_sp = w.stack[l];
    w.th[l].uc_stack.ss_size = STACK;
    w.th[l].uc_link = &w.sched;
    makecontext(&w.th[l], (void (*)())entry, 1, l);
  }
  for (;;) {
    int done = 0;
    for (int l = 31; l >= 0; --l) {  // highest first: a read of a lower
      if (w.finished[l]) continue;     // thread's write needs a collective
      w.lane = l;
      swapcontext(&w.sched, &w.th[l]);
    }
    for (int l = 0; l < 32; ++l) done += w.finished[l];
    if (done == 32) break;
    bool same = done == 0;
    for (int l = 1; l < 32 && same; ++l) same = w.kind[l] == w.kind[0];
    if (!same) {
      std::fprintf(stderr, "warp emulation: a collective not reached by all 32 threads\n");
      std::abort();
    }
    uint32_t mask = 0u;
    for (int l = 0; l < 32; ++l) mask |= (w.val[l] ? 1u : 0u) << l;
    for (int l = 0; l < 32; ++l)
      w.res[l] = w.kind[l] == BALLOT ? mask : w.kind[l] == SHFL ? w.val[w.arg[l] & 31] : 0u;
  }
  for (int l = 0; l < 32; ++l) std::free(w.stack[l]);
  warp = nullptr;
}

// fn(t) for a lambda
template <class F>
void run_warp(F fn) {
  run([](void* env, int t) { (*(F*)env)(t); }, &fn);
}
}  // namespace warp_host

static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { warp_host::collective(warp_host::SYNC, 0u, 0); }
static inline unsigned __ballot_sync(unsigned, int pred) {
  return warp_host::collective(warp_host::BALLOT, pred ? 1u : 0u, 0);
}
static inline int __shfl_sync(unsigned, int v, int src) {
  return (int)warp_host::collective(warp_host::SHFL, (uint32_t)v, src);
}
"""

_ENTRIES_CPP = r"""
#include <algorithm>
#include <vector>

#include "fork_expand.cuh"
#include "modexp.cuh"
#include "propagate.cuh"
#include "tape_append.cuh"

using warp_host::run_warp;

extern "C" int propagate_sweep(const int32_t* tape_op, const int32_t* tape_a,
                               const int32_t* tape_b, const int64_t* tape_imm,
                               const int32_t* tape_len, int32_t* prop_len, int64_t* iv_lo,
                               int64_t* iv_hi, int64_t* kb_m, int64_t* kb_v,
                               const int32_t* con_node, const bool* con_sign,
                               const int32_t* con_len, bool* infeasible, int P, int T, int C,
                               void*) {
  const k6::Sweep s{tape_op, tape_a, tape_b, tape_imm, tape_len, prop_len,
                    {iv_lo, iv_hi, kb_m, kb_v}, con_node, con_sign, con_len, infeasible,
                    P, T, C};
  k6::Stage stage;
  for (int p = 0; p < P; ++p) run_warp([&](int t) { k6::sweep_warp(s, p, t, stage); });
  return 0;
}

extern "C" int tape_append(const uint64_t* tape, int T, const int32_t* op, const int32_t* a,
                           const int32_t* b, const int64_t* imm, const bool* mask, int32_t* ids,
                           bool* overflow, int P, void*) {
  const k3::Tape tp = k3::tape_from(tape, T);
  for (int p = 0; p < P; ++p)
    run_warp([&](int t) { k3::warp_append_lane(tp, p, t, op, a, b, imm, mask, ids, overflow); });
  return 0;
}

extern "C" int tape_append_group(const uint64_t* tape, int T, const int32_t* op,
                                 const int32_t* a, const int32_t* b, const int32_t* a_src,
                                 const int32_t* b_src, const int64_t* imm, const bool* mask,
                                 int32_t* out, bool* overflow, int P, int R, void*) {
  if (R < 1 || R > k3::MAX_ROWS) return cudaErrorInvalidValue;
  const k3::Tape tp = k3::tape_from(tape, T);
  for (int p = 0; p < P; ++p)
    run_warp([&](int t) {
      k3::warp_append_group(tp, p, t, R, op, a, b, a_src, b_src, imm, mask, out, overflow);
    });
  return 0;
}

// as u256_modexp.cu: 8 threads a lane, four lanes a warp; the groups past
// the last lane compute 0 ** 0 mod 1 with the others
extern "C" int modexp_u256(const int64_t* base, const int64_t* e, const int64_t* m,
                           int64_t* out, int n, void*) {
  for (int w = 0; w < (n + 3) / 4; ++w) {
    uint32_t tab[4][16 * 8];
    run_warp([&](int t) {
      const int p = 4 * w + (t >> 3);
      const k5::Group G{t & 7, t & 24};
      const bool live = p < n;
      const int64_t at = 8 * (int64_t)p + G.g;
      const uint32_t b = live ? (uint32_t)base[at] : 0u;
      const uint32_t ee = live ? (uint32_t)e[at] : 0u;
      const uint32_t mm = live ? (uint32_t)m[at] : (G.g == 0 ? 1u : 0u);
      const uint32_t r = k5::modexp(G, b, ee, mm, tab[t >> 3]);
      if (live) out[at] = (int64_t)r;
    });
  }
  return 0;
}

// fork_plan.cu's entry point: the plan's sort and scans serially, then the
// kernels' per-lane plan, every copy item and every lane's fix-ups
extern "C" int fork_expand(const uint64_t* ptrs, const int32_t* ints, void*) {
  using namespace k7;
  const int P = ints[I_P], B = ints[I_B];
  if (P <= 0) return 0;
  if (B <= 0 || P % B || ints[I_N_FIELDS] > MAX_FIELDS) return cudaErrorInvalidValue;
  const Plan q = make_plan(ptrs, ints);
  *q.count = 0;
  std::vector<int32_t> skey(B), rank(B), frank(B);
  for (int base = 0; base < P; base += B) {
    int n_req = 0, n_free = 0;
    for (int l = 0; l < B; ++l) {
      skey[l] = packed_key(q, base, l);
      n_req += q.fork_req[base + l] && q.active[base + l];
      frank[l] = n_free;
      n_free += !q.active[base + l];
    }
    std::sort(skey.begin(), skey.end());
    for (int i = 0; i < B; ++i) rank[skey[i] % B] = i;
    const int n_adm = q.policy == POL_BEAM ? min(n_free, max(1, B / 4)) : n_free;
    const int n_admit = min(n_adm, n_req);
    const int pos0 = *q.count;
    *q.count += n_admit;
    for (int l = 0; l < B; ++l)
      finish_lane(q, base, l, frank[l], rank[l], skey.data(), n_adm, n_admit, pos0);
  }
  const CopyTable t = make_copy(ptrs, ints);
  const int64_t n = *t.count;
  for (int64_t w = 0; w < n * t.n_chunks; ++w) copy_big(t, w, 0, 1);
  if (t.op_hist)
    for (int64_t w = 0; w < n; ++w) copy_hist(t, w, 0, 1);
  for (int64_t w = 0; w < n * (t.n_fields - t.n_big); ++w) copy_small(t, w);
  const Fix x = make_fix(ptrs, ints);
  for (int p = 0; p < P; ++p) fix_lane(x, p);
  return 0;
}
"""


def build(tmp=None) -> str:
    """Compile the K6, K3, K5 and K7 bodies with g++ into ``tmp``; -> the
    library's path."""
    tmp = tmp or tempfile.mkdtemp(prefix="warp_host_")
    inc = os.path.join(tmp, "shim")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "cuda_runtime.h"), "w") as fh:
        fh.write(_SHIM_H)
    src = os.path.join(tmp, "warp_host.cpp")
    with open(src, "w") as fh:
        fh.write(_ENTRIES_CPP)
    out = os.path.join(tmp, "libwarp_host.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", inc, "-I", CSRC, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return out


def load(path):
    """The host library, with the argument types the wrappers give the
    nvcc build's entry points."""
    from mythril_tpu_torch import kernels

    lib = ctypes.CDLL(path)
    kernels.bind_propagate_sweep(lib)
    kernels.bind_tape_append(lib)
    kernels.bind_modexp(lib)
    kernels.bind_fork_expand(lib)
    return lib
