// K1: unsigned 256-bit division with remainder, one thread per lane.
//
// Replaces the JAX package's ops/u256.py `divmod_u` (the 256-step
// fori_loop behind DIV/MOD/SDIV/SMOD). Limbs arrive in the port's int64
// carrier (0..2^32-1, little-endian, 8 per word) and are held as
// uint32_t in registers: the dividend, divisor, quotient and remainder
// (32 registers) stay there through all 256 shift-subtract steps, so the
// kernel reads each input word once and writes each output word once.
//
// Bound: 256 steps x ~40 integer operations per lane, far above the
// 128 bytes a lane moves; at P = 2048 lanes the card is latency-bound on
// one dependent chain per thread (a later PR can split the chain).
// EVM semantics: division by zero gives (0, 0). The signed variants
// (SDIV/SMOD) take absolute values and fix signs in PyTorch around
// this kernel (core/interpreter.py `_h_divmod`, ops/u256.py `sdiv`).

#include <cstdint>
#include <cuda_runtime.h>

__global__ void divmod_u256_kernel(const int64_t* __restrict__ a,
                                   const int64_t* __restrict__ b,
                                   int64_t* __restrict__ q_out,
                                   int64_t* __restrict__ r_out, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t x[8], d[8], q[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = (uint32_t)a[8 * p + i];
    d[i] = (uint32_t)b[8 * p + i];
    q[i] = 0u;
    r[i] = 0u;
  }
  uint32_t dz = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) dz |= d[i];

#pragma unroll 1
  for (int limb = 7; limb >= 0; --limb) {
    // runtime limb index -> select with a small unrolled scan, keeping x in
    // registers
    uint32_t xl = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) xl = (i == limb) ? x[i] : xl;
    uint32_t ql = 0u;
#pragma unroll 1
    for (int shift = 31; shift >= 0; --shift) {
      uint32_t bit = (xl >> shift) & 1u;
      // r = r << 1 | bit, remembering the bit shifted out of 2^256
      uint32_t overflow = r[7] >> 31;
#pragma unroll
      for (int i = 7; i > 0; --i) r[i] = (r[i] << 1) | (r[i - 1] >> 31);
      r[0] = (r[0] << 1) | bit;
      // ge = overflow || r >= d (compare from the most significant limb)
      uint32_t gt = 0u, lt = 0u;
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        uint32_t undecided = 1u ^ (gt | lt);
        gt |= undecided & (r[i] > d[i] ? 1u : 0u);
        lt |= undecided & (r[i] < d[i] ? 1u : 0u);
      }
      uint32_t ge = overflow | (1u ^ lt);
      uint32_t m = 0u - ge;  // all ones when subtracting
      uint64_t borrow = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint64_t t = (uint64_t)r[i] - (uint64_t)(d[i] & m) - borrow;
        r[i] = (uint32_t)t;
        borrow = (t >> 63) & 1u;
      }
      ql |= ge << shift;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = (i == limb) ? ql : q[i];
  }
  uint32_t keep = dz ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q_out[8 * p + i] = (int64_t)(q[i] & keep);
    r_out[8 * p + i] = (int64_t)(r[i] & keep);
  }
}

extern "C" int divmod_u256(const int64_t* a, const int64_t* b, int64_t* q,
                           int64_t* r, int n, void* stream) {
  if (n <= 0) return 0;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  divmod_u256_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, b, q, r, n);
  return (int)cudaGetLastError();
}
