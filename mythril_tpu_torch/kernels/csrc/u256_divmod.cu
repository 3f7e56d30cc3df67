// K1: unsigned 256-bit division with remainder, one thread per lane.
//
// Replaces the JAX package's ops/u256.py `divmod_u` (the 256-step
// fori_loop behind DIV/MOD/SDIV/SMOD). Limbs arrive in the port's int64
// carrier (0..2^32-1, little-endian, 8 per word) and are held as
// uint32_t in registers: the dividend, divisor, quotient and remainder
// (32 registers) stay there through all 256 shift-subtract steps
// (u256.cuh `divmod8`, which K10's DIV/MOD share), so the kernel reads
// each input word once and writes each output word once.
//
// Bound: 256 steps x ~40 integer operations per lane, far above the
// 128 bytes a lane moves; at P = 2048 lanes the card is latency-bound on
// one dependent chain per thread (a later PR can split the chain).
// EVM semantics: division by zero gives (0, 0). The signed variants
// (SDIV/SMOD) take absolute values and fix signs in PyTorch around
// this kernel (ops/u256.py `sdiv`, `smod`).

#include "u256.cuh"

using namespace u256;

__global__ void divmod_u256_kernel(const int64_t* __restrict__ a,
                                   const int64_t* __restrict__ b,
                                   int64_t* __restrict__ q_out,
                                   int64_t* __restrict__ r_out, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t x[8], d[8], q[8], r[8];
  load(a + 8 * (int64_t)p, x);
  load(b + 8 * (int64_t)p, d);
  divmod8(x, d, q, r);
  store(q_out + 8 * (int64_t)p, q);
  store(r_out + 8 * (int64_t)p, r);
}

extern "C" int divmod_u256(const int64_t* a, const int64_t* b, int64_t* q,
                           int64_t* r, int n, void* stream) {
  if (n <= 0) return 0;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  divmod_u256_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, b, q, r, n);
  return (int)cudaGetLastError();
}
