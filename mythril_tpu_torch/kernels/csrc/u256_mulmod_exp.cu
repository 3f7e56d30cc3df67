// K9: ADDMOD/MULMOD's 512-bit remainder and EXP, one thread per lane.
//
// `mod_wide` replaces the JAX package's ops/u256.py `_mod_wide` (the
// 512-step bitwise long division behind `addmod`/`mulmod`): a 16-limb x
// mod a 256-bit m, m == 0 giving 0. Its body is u256.cuh's division core
// (`mod_wide16` -> `divrem<16>`, shared with K1): Knuth's algorithm D with
// m normalized to bit 255, at most 17 digits of a reciprocal-based
// estimate and an 8-limb multiply-subtract row each, the leading zero
// digits of a short x (ADDMOD's 257-bit sum) skipped, no quotient kept.
// The Barrett reduction it replaces paid a 258-step search for mu
// on every call, since every lane has its own modulus.
//
// `exp` replaces `exp` (EXP): base ** e mod 2^256, e == 0 giving 1 (0 ** 0
// included), as the JAX loop's 256 squarings of 1 do. Its body (`exp8`)
// first takes the exact fast paths, where the operands' bits give the
// result: e == 0, base 0 or 1, base = 2^k, an even base whose power 2^256
// divides. Otherwise it runs over e from the top in fixed 2-bit windows:
// base^2 and base^3 once, then per window two squarings (`sqr_low8`, 20
// products) and, unless its digit is 0, one multiply by base^digit
// (`mul_low8`, 36 products), picked from the three words by a select. Both
// products add their 32-bit halves into 64-bit column sums, so the
// products are independent of each other and only the last carry pass
// over 8 columns is serial. chip_smoke.py counts the EXP lanes K10 runs
// on each path on the repo's workloads (PERF.md).
//
// Both bodies live in u256.cuh, which K10's ADDMOD/MULMOD/EXP share.
//
// Bound: mod_wide by bytes (256 a lane: x in at 128, m in, r out), exp by
// operations, per lane what its operands need (chip_smoke.py `exp_ops`):
// none on a fast path, else a square-and-multiply's squarings at 20
// multiply-adds and its multiplies at 36, 4 operations each. Each lane is
// one dependent chain, and at P = 2048 the card holds ~16 threads an SM,
// so a launch takes the longest lane's chain: the design shortens the
// chains.

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
