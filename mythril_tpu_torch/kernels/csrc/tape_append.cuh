// K3's per-lane body: hash-consed appends to one lane's SSA tape by one
// warp. Included by tape_append.cu; the CPU tests build it as host C++
// with a shim that runs the 32 threads of a warp as threads and its votes
// and barriers with a std::barrier.
//
// The warp computes the row's 32-bit fingerprint, streams tape_hash[p,
// :len] coalesced (128 rows per step), finds the FIRST live row whose
// fingerprint matches with __ballot_sync + __ffs, and verifies op/a/b/imm
// of that one row only: a collision is a missed dedup (a duplicate row),
// never a wrong id. Thread 0 then appends the row with its fingerprint,
// or reports the overflow (tape_len == T) so the caller traps the lane
// with TAPE_LIMIT. The tape is updated IN PLACE (the JAX function
// returned a new tape).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace k3 {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_ROWS = 16;  // rows of one group launch
constexpr int SCAN = 4;       // 32-row chunks of the fingerprint scan a step

__device__ __forceinline__ uint32_t row_hash(uint32_t op, uint32_t a, uint32_t b,
                                             const int64_t* imm) {
  const uint32_t mult[8] = {0x27D4EB2Fu, 0x165667B1u, 0xD6E8FEB9u, 0xA3D8A6E3u,
                            0x83B58237u, 0xCC9E2D51u, 0x1B873593u, 0xE6546B65u};
  uint32_t h = (op * 0x9E3779B1u) ^ (a * 0x85EBCA6Bu) ^ (b * 0xC2B2AE35u);
  uint32_t s = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += (uint32_t)imm[i] * mult[i];
  h ^= s;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  return h ^ (h >> 15);
}

// The tape, written in place: [P, T] rows and [P] lengths. The wrappers
// marshal the six pointers in this order (kernels/__init__.py
// TAPE_FIELDS).
struct Tape {
  int32_t* op;
  int32_t* a;
  int32_t* b;
  int64_t* imm;  // [P, T, 8]
  int32_t* hash;
  int32_t* len;
  int T;
};

inline Tape tape_from(const uint64_t* ptrs, int T) {
  return Tape{(int32_t*)ptrs[0], (int32_t*)ptrs[1], (int32_t*)ptrs[2], (int64_t*)ptrs[3],
              (int32_t*)ptrs[4], (int32_t*)ptrs[5], T};
}

// One row appended to lane p's tape by its warp: every thread calls this
// with the same row and the same `len`, the lane's tape length, which it
// advances when the row is written. Returns the row's id (0 on overflow)
// and ORs the overflow into `ovf`. Ends with __syncwarp(), so that the
// next append's scan sees the row thread 0 wrote.
__device__ inline int warp_append(const Tape& tp, int p, int t, uint32_t op, uint32_t a,
                                  uint32_t b, const int64_t* imm, int& len, bool& ovf) {
  const uint32_t h = row_hash(op, a, b, imm);
  const int32_t* hrow = tp.hash + (size_t)p * tp.T;
  // the scan takes SCAN x 32 fingerprints a step, its loads issued
  // before its votes, so that a long tape costs a few round trips to
  // memory rather than one per 32 rows
  int first = -1;
  for (int base = 0; base < len && first < 0; base += SCAN * 32) {
    uint32_t hv[SCAN];
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
      const int j = base + 32 * k + t;
      hv[k] = j < len ? (uint32_t)hrow[j] : 0u;
    }
#pragma unroll
    for (int k = 0; k < SCAN; ++k) {
      const unsigned ballot = __ballot_sync(FULL, base + 32 * k + t < len && hv[k] == h);
      if (ballot) {
        first = base + 32 * k + __ffs((int)ballot) - 1;
        break;
      }
    }
  }
  int id = 0, new_len = len, o = 0;
  if (t == 0) {
    bool hit = false;
    if (first >= 0) {
      const size_t r = (size_t)p * tp.T + first;
      hit = tp.op[r] == (int32_t)op && tp.a[r] == (int32_t)a && tp.b[r] == (int32_t)b;
      for (int i = 0; i < 8; ++i) hit = hit && (tp.imm[8 * r + i] == imm[i]);
    }
    o = !hit && len >= tp.T;
    if (hit) {
      id = first;
    } else if (!o) {
      const size_t r = (size_t)p * tp.T + len;
      tp.op[r] = (int32_t)op;
      tp.a[r] = (int32_t)a;
      tp.b[r] = (int32_t)b;
      for (int i = 0; i < 8; ++i) tp.imm[8 * r + i] = imm[i];
      tp.hash[r] = (int32_t)h;
      tp.len[p] = len + 1;
      id = len;
      new_len = len + 1;
    }
  }
  id = __shfl_sync(FULL, id, 0);
  len = __shfl_sync(FULL, new_len, 0);
  ovf = ovf || __shfl_sync(FULL, o, 0) != 0;
  __syncwarp();
  return id;
}

// The single-row entry point's body for lane p: a masked-off lane reads
// nothing and gets id 0.
__device__ inline void warp_append_lane(const Tape& tp, int p, int t, const int32_t* op,
                                        const int32_t* a, const int32_t* b,
                                        const int64_t* imm, const bool* mask, int32_t* ids,
                                        bool* overflow) {
  int id = 0;
  bool ovf = false;
  if (mask[p]) {
    int len = tp.len[p];
    id = warp_append(tp, p, t, (uint32_t)op[p], (uint32_t)a[p], (uint32_t)b[p],
                     imm + 8 * (size_t)p, len, ovf);
  }
  if (t == 0) {
    ids[p] = id;
    overflow[p] = ovf;
  }
}

// R rows (R <= MAX_ROWS) appended to lane p's tape in order, as R
// sequential appends would: row r's fingerprint scan sees every row the
// group appended before it, so a row that repeats an earlier row of its
// group is a dedup hit. Inputs are [P, R] (imm [P, R, 8]). An operand is
// the literal a[p, r] unless a_src[p, r] names an earlier row s (0 <= s <
// r): then it is row s's output. A row's output is its id where mask[p,
// r] is set (0 on overflow) and its resolved a where not; `out` gets the
// outputs, `overflow` the OR of the rows' overflows.
__device__ inline void warp_append_group(const Tape& tp, int p, int t, int R,
                                         const int32_t* op, const int32_t* a,
                                         const int32_t* b, const int32_t* a_src,
                                         const int32_t* b_src, const int64_t* imm,
                                         const bool* mask, int32_t* out, bool* overflow) {
  int len = tp.len[p];
  bool ovf = false;
  int outs[MAX_ROWS];
  for (int r = 0; r < R; ++r) {
    const size_t q = (size_t)p * R + r;
    const int sa = a_src[q], sb = b_src[q];
    const int av = sa >= 0 && sa < r ? outs[sa] : a[q];
    const int bv = sb >= 0 && sb < r ? outs[sb] : b[q];
    outs[r] = mask[q] ? warp_append(tp, p, t, (uint32_t)op[q], (uint32_t)av, (uint32_t)bv,
                                    imm + 8 * q, len, ovf)
                      : av;
    if (t == 0) out[q] = outs[r];
  }
  if (t == 0) overflow[p] = ovf;
}

}  // namespace k3
