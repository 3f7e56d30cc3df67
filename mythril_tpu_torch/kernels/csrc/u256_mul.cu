// K8: the u256 product family, one thread per lane.
//
// Replaces the JAX package's ops/u256.py `mul` (low 256 bits of a*b,
// MUL) and `mul_wide` (the full 512-bit product, MULMOD's operand and the
// feasibility sweep's MUL interval). One schoolbook 8x8-limb product with
// 64-bit accumulation serves both; `mode` picks the output: 0 = the low
// 8 limbs, 1 = all 16 limbs.
//
// Bound: bytes at any real P. A lane reads 128 bytes and writes 64 or
// 128, against 64 multiply-adds; at P = 2048 that is well under a
// microsecond of either, so a launch is latency-bound (one short chain
// per thread).

#include "u256.cuh"

using namespace u256;

__global__ void mul_kernel(const int64_t* __restrict__ a_in,
                           const int64_t* __restrict__ b_in,
                           int64_t* __restrict__ out, int n, int mode) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t a[8], b[8], w[16];
  load(a_in + 8 * (int64_t)p, a);
  load(b_in + 8 * (int64_t)p, b);
  mul_low(a, 8, b, 8, w, 16);
  if (mode == 0) {
    store(out + 8 * (int64_t)p, w, 8);
  } else {
    store(out + 16 * (int64_t)p, w, 16);
  }
}

extern "C" int u256_mul(const int64_t* a, const int64_t* b, int64_t* out, int n, int mode,
                        void* stream) {
  if (n <= 0) return 0;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  mul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, b, out, n, mode);
  return (int)cudaGetLastError();
}
