// K1: unsigned 256-bit division with remainder, one thread per lane.
//
// Replaces the JAX package's ops/u256.py `divmod_u` (the 256-step
// fori_loop behind DIV/MOD/SDIV/SMOD). Limbs arrive in the port's int64
// carrier (0..2^32-1, little-endian, 8 per word) and are held as
// uint32_t in registers; the kernel reads each input word once and writes
// each output word once.
//
// Bound: bytes, 256 a lane (a, b in; q, r out), 0.000157 ms at P = 2048;
// the operations the function needs (a schoolbook long division, ~10 a
// quotient limb plus 4 a divisor limb) are fewer. At 2048 lanes the card
// holds ~16 threads an SM, so what a launch takes is one lane's dependent
// chain: the design shortens the chain. The body is u256.cuh's division
// core (`divmod8` -> `divrem<8>`, which K10's DIV/MOD/SDIV/SMOD share):
// Knuth's algorithm D over 32-bit limbs with the divisor normalized to
// bit 255, at most 9 quotient digits of one reciprocal-based estimate
// (Möller and Granlund's 2-by-1, no hardware divide), at most two
// corrections against the second limb and one 8-limb multiply-subtract
// row each, leading zero digits skipped; quick exits for d == 0, x < d and
// a one-limb d. The bit-serial loop it replaces ran 256 steps of
// ~40 dependent operations whatever the operands.
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
