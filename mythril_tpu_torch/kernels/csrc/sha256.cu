// K4: SHA-256 of per-lane byte buffers, one thread per lane.
//
// Replaces the JAX package's ops/sha256.py `sha256_device` (precompile
// 0x2). A lane's message is data[p, 0:ln[p]] of a [P, N] uint8 buffer
// (N = min(memory, 448) on the engine's path, so at most 8 blocks). The
// body (sha256.cuh) reads whole 16-byte chunks of the row, places the
// padding and the length as words and keeps the state and the schedule in
// registers. Output limbs are the digest words in reverse order (limb 0 =
// last digest word), int64 carriers.
//
// An optional lane mask (uint8[P]) selects the lanes to hash and zeroes
// the others' rows of the output: the engine passes the precompile's own
// lane mask, so that its few sha256 lanes are hashed in place in the
// [P, 448] input window, with no index built on the host, no gather of
// their rows and no scatter of the results (ops/sha256.py `sha256_lanes`).
//
// Bound: ~2,400 32-bit operations per 64-byte block against the 64
// message bytes it reads: 37.5 operations per byte, against the card's
// ~20 (67 TOP/s over 3.35 TB/s), so operations. One dependent chain per
// thread; at the engine's widths (a handful of lanes per superstep) a
// launch is all latency: the chain of the longest lane. 32 threads a
// block: with 64 or 128 ptxas holds the body in 48 registers, not 63, and
// it ran ~16 % slower on an H100 (tools/hash_variants.py, PERF.md); a
// launch for a few lanes' mask runs one block per 32 rows, whose
// unselected threads write their zeros and exit.

#include "sha256.cuh"

constexpr int K4_THREADS = 32;

template <bool VEC>
__global__ void __launch_bounds__(K4_THREADS)
    sha256_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ len,
                  const uint8_t* __restrict__ mask, int64_t* __restrict__ out, int P, int N) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P) k4::hash_row<VEC>(data, len, mask, out, p, N);
}

extern "C" int sha256(const uint8_t* data, const int32_t* len, const uint8_t* mask, int64_t* out,
                      int P, int N, void* stream) {
  if (P <= 0) return 0;
  int blocks = (P + K4_THREADS - 1) / K4_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (k4::vec_rows(data, N))
    sha256_kernel<true><<<blocks, K4_THREADS, 0, s>>>(data, len, mask, out, P, N);
  else
    sha256_kernel<false><<<blocks, K4_THREADS, 0, s>>>(data, len, mask, out, P, N);
  return (int)cudaGetLastError();
}
