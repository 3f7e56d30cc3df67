// K3: hash-consed SSA tape append, one warp per frontier lane.
//
// Replaces the JAX package's symbolic/engine.py `append_node` together
// with symbolic/state.py `tape_row_hash`. Two entry points on the body in
// tape_append.cuh:
//
// - `tape_append`: one row per lane; masked-off lanes read nothing and
//   get id 0.
// - `tape_append_group`: R rows per lane in one launch, in order, an
//   operand either a literal or the output of an earlier row of the
//   group. The engine's SHA3 chain (seed, 8 absorbs, digest: 10 rows) and
//   a binary op's CONST, CONST and node (3 rows) are one launch each
//   instead of 10 and 3.
//
// Both take the tape as six pointers the wrapper marshals once per loop
// (kernels.TapeAppend) and update it IN PLACE (the JAX function returned
// a new tape).
//
// Bound: bytes, the tape_hash entries each row's scan reads — at most P x
// T x 4 bytes a row (4 MB at P = 2048, T = 512), fewer when the first
// match ends the scan. What a warp does is serial: its rows one after
// another, each a scan of a few dependent steps of 128 fingerprints. A
// launch's device work is a few microseconds, less than its host side,
// which the group launch pays once for its rows.

#include "tape_append.cuh"

namespace {

constexpr int WARPS = 8;  // lanes a block

__global__ void __launch_bounds__(WARPS * 32)
    append_kernel(const k3::Tape tp, const int32_t* __restrict__ op,
                  const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  const int64_t* __restrict__ imm, const bool* __restrict__ mask,
                  int32_t* __restrict__ ids, bool* __restrict__ overflow, int P) {
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p < P) k3::warp_append_lane(tp, p, threadIdx.x & 31, op, a, b, imm, mask, ids, overflow);
}

__global__ void __launch_bounds__(WARPS * 32)
    group_kernel(const k3::Tape tp, const int32_t* __restrict__ op,
                 const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 const int32_t* __restrict__ a_src, const int32_t* __restrict__ b_src,
                 const int64_t* __restrict__ imm, const bool* __restrict__ mask,
                 int32_t* __restrict__ out, bool* __restrict__ overflow, int P, int R) {
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p < P)
    k3::warp_append_group(tp, p, threadIdx.x & 31, R, op, a, b, a_src, b_src, imm, mask, out,
                          overflow);
}

}  // namespace

extern "C" int tape_append(const uint64_t* tape, int T, const int32_t* op, const int32_t* a,
                           const int32_t* b, const int64_t* imm, const bool* mask, int32_t* ids,
                           bool* overflow, int P, void* stream) {
  if (P <= 0) return 0;
  append_kernel<<<(P + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
      k3::tape_from(tape, T), op, a, b, imm, mask, ids, overflow, P);
  return (int)cudaGetLastError();
}

extern "C" int tape_append_group(const uint64_t* tape, int T, const int32_t* op,
                                 const int32_t* a, const int32_t* b, const int32_t* a_src,
                                 const int32_t* b_src, const int64_t* imm, const bool* mask,
                                 int32_t* out, bool* overflow, int P, int R, void* stream) {
  if (P <= 0) return 0;
  if (R < 1 || R > k3::MAX_ROWS) return (int)cudaErrorInvalidValue;
  group_kernel<<<(P + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
      k3::tape_from(tape, T), op, a, b, a_src, b_src, imm, mask, out, overflow, P, R);
  return (int)cudaGetLastError();
}
