// K3: hash-consed SSA tape append, one warp per frontier lane.
//
// Replaces the JAX package's symbolic/engine.py `append_node` together
// with symbolic/state.py `tape_row_hash`. The warp computes the row's
// 32-bit fingerprint, streams tape_hash[p, :len] coalesced (32 rows per
// step), finds the FIRST live row whose fingerprint matches with
// __ballot_sync + __ffs, and verifies op/a/b/imm of that one row only: a
// collision is a missed dedup (a duplicate row), never a wrong id. Lane 0
// of the warp then appends the row with its fingerprint, or reports the
// overflow (tape_len == T) so the caller traps the lane with TAPE_LIMIT.
// Masked-off lanes read nothing and get id 0.
//
// The tape is updated IN PLACE (the JAX function returned a new tape).
//
// Bound: the tape_hash bytes scanned — at most P x T x 4 bytes per call
// (4 MB at P = 2048, T = 512), fewer when the first match ends the scan.

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void tape_append_kernel(int32_t* __restrict__ tape_op,
                                   int32_t* __restrict__ tape_a,
                                   int32_t* __restrict__ tape_b,
                                   int64_t* __restrict__ tape_imm,
                                   int32_t* __restrict__ tape_hash,
                                   int32_t* __restrict__ tape_len,
                                   const int32_t* __restrict__ op,
                                   const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   const int64_t* __restrict__ imm,
                                   const bool* __restrict__ mask,
                                   int32_t* __restrict__ ids,
                                   bool* __restrict__ overflow, int n, int T) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= n) return;
  int p = warp;
  if (!mask[p]) {
    if (lane == 0) {
      ids[p] = 0;
      overflow[p] = false;
    }
    return;
  }
  const int64_t* row_imm = imm + 8 * (size_t)p;
  uint32_t h = row_hash((uint32_t)op[p], (uint32_t)a[p], (uint32_t)b[p], row_imm);
  int len = tape_len[p];
  const int32_t* hrow = tape_hash + (size_t)p * T;
  int first = -1;
  for (int base = 0; base < len; base += 32) {
    int j = base + lane;
    bool m = (j < len) && ((uint32_t)hrow[j] == h);
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, m);
    if (ballot) {
      first = base + __ffs(ballot) - 1;
      break;
    }
  }
  if (lane != 0) return;
  bool hit = false;
  if (first >= 0) {
    size_t r = (size_t)p * T + first;
    hit = tape_op[r] == op[p] && tape_a[r] == a[p] && tape_b[r] == b[p];
#pragma unroll
    for (int i = 0; i < 8; ++i) hit = hit && (tape_imm[8 * r + i] == row_imm[i]);
  }
  bool ovf = !hit && len >= T;
  int id = 0;
  if (hit) {
    id = first;
  } else if (!ovf) {
    size_t r = (size_t)p * T + len;
    tape_op[r] = op[p];
    tape_a[r] = a[p];
    tape_b[r] = b[p];
#pragma unroll
    for (int i = 0; i < 8; ++i) tape_imm[8 * r + i] = row_imm[i];
    tape_hash[r] = (int32_t)h;
    tape_len[p] = len + 1;
    id = len;
  }
  ids[p] = id;
  overflow[p] = ovf;
}

extern "C" int tape_append(int32_t* tape_op, int32_t* tape_a, int32_t* tape_b,
                           int64_t* tape_imm, int32_t* tape_hash, int32_t* tape_len,
                           const int32_t* op, const int32_t* a, const int32_t* b,
                           const int64_t* imm, const bool* mask, int32_t* ids,
                           bool* overflow, int n, int T, void* stream) {
  if (n <= 0) return 0;
  int threads = 256;  // 8 warps = 8 frontier lanes per block
  int blocks = (n * 32 + threads - 1) / threads;
  tape_append_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len, op, a, b, imm, mask,
      ids, overflow, n, T);
  return (int)cudaGetLastError();
}
