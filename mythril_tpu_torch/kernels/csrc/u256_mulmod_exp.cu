// K9: ADDMOD/MULMOD's 512-bit remainder and EXP, one thread per lane.
//
// `mod_wide` replaces the JAX package's ops/u256.py `_mod_wide` (the
// 512-step bitwise long division behind `addmod`/`mulmod`): a 16-limb x
// mod a 256-bit m, m == 0 giving 0. It reduces by Barrett on the
// normalized modulus (u256.cuh, shared with K5) in two steps that each
// meet Barrett's bound x < m * 2^256: first the high half x_hi (< 2^256
// <= m * 2^256), then r_hi * 2^256 + x_lo with r_hi < m.
//
// `exp` replaces `exp` (EXP): base ** e mod 2^256 by square-and-multiply
// of low products from the top set bit of e; e == 0 gives 1 (0 ** 0
// included), as the JAX loop's 256 squarings of 1 do.
//
// Both bodies live in u256.cuh (`mod_wide16`, `exp8`), which K10's
// ADDMOD/MULMOD/EXP share.
//
// Bound: operations. mod_wide pays the 258-step mu search and two
// ~190-multiply-add reductions per lane; exp up to 2 x 256 low products
// of 36 multiply-adds. Both read and write a few hundred bytes per lane.

#include "u256.cuh"

using namespace u256;

__global__ void mod_wide_kernel(const int64_t* __restrict__ x_in,
                                const int64_t* __restrict__ m_in,
                                int64_t* __restrict__ out, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t x[16], m[8], r[8];
  load(x_in + 16 * (int64_t)p, x, 16);
  load(m_in + 8 * (int64_t)p, m);
  mod_wide16(x, m, r);
  store(out + 8 * (int64_t)p, r);
}

__global__ void exp_kernel(const int64_t* __restrict__ base_in,
                           const int64_t* __restrict__ e_in,
                           int64_t* __restrict__ out, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t base[8], e[8], acc[8];
  load(base_in + 8 * (int64_t)p, base);
  load(e_in + 8 * (int64_t)p, e);
  exp8(base, e, acc);
  store(out + 8 * (int64_t)p, acc);
}

extern "C" int u256_mod_wide(const int64_t* x, const int64_t* m, int64_t* out, int n,
                             void* stream) {
  if (n <= 0) return 0;
  int threads = 64;
  int blocks = (n + threads - 1) / threads;
  mod_wide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, m, out, n);
  return (int)cudaGetLastError();
}

extern "C" int u256_exp(const int64_t* base, const int64_t* e, int64_t* out, int n,
                        void* stream) {
  if (n <= 0) return 0;
  int threads = 64;
  int blocks = (n + threads - 1) / threads;
  exp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(base, e, out, n);
  return (int)cudaGetLastError();
}
