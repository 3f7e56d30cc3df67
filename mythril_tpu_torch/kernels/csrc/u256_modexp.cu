// K5: u256 modular exponentiation base ** e mod m (m == 0 -> 0), a
// quarter-warp per lane.
//
// Replaces the JAX package's ops/u256.py `modexp` (precompile 0x5 for
// operands of at most 32 bytes), whose MSB-first square-and-multiply
// calls the 512-step bitwise `_mod_wide` twice per exponent bit. The
// function is the same — the accumulator starts at 1, so m == 1 gives 0
// even for e == 0.
//
// The precompile path hands the kernel only the lanes that call MODEXP,
// usually one or two, so a launch's time is one lane's chain of dependent
// modular products. The body (modexp.cuh) spreads each product over the
// eight threads of a quarter-warp, one limb each, with every limb in a
// register at a fixed index, and walks the exponent in fixed 4-bit
// windows: at most 256 squarings and 64 multiplies by a table of 16
// powers in shared memory, each reduced by Barrett's method on the
// normalized modulus (m may be even).
//
// Bound: operations. A modular product is three 8 x 8-limb products (190
// 32x32->64 multiply-adds) plus carries; a lane needs bitlen(e)
// squarings and popcount(e) multiplies. What is left serial is a lane's
// chain of products: each is a few dependent rounds of shuffles and
// ballots.

#include "modexp.cuh"

// lanes per block: 8 threads each
constexpr int LANES = 8;

__global__ void modexp_kernel(const int64_t* __restrict__ base_in,
                              const int64_t* __restrict__ e_in,
                              const int64_t* __restrict__ m_in,
                              int64_t* __restrict__ out, int n) {
  __shared__ uint32_t tab[LANES][16 * 8];
  const int t = threadIdx.x, p = blockIdx.x * LANES + (t >> 3);
  const k5::Group G{t & 7, t & 24};
  // groups past the last lane compute 0 ** 0 mod 1 with the others: every
  // thread of a warp takes every shuffle
  const bool live = p < n;
  const int64_t at = 8 * (int64_t)p + G.g;
  const uint32_t b = live ? (uint32_t)base_in[at] : 0u;
  const uint32_t e = live ? (uint32_t)e_in[at] : 0u;
  const uint32_t m = live ? (uint32_t)m_in[at] : (G.g == 0 ? 1u : 0u);
  const uint32_t r = k5::modexp(G, b, e, m, tab[t >> 3]);
  if (live) out[at] = (int64_t)r;
}

extern "C" int modexp_u256(const int64_t* base, const int64_t* e, const int64_t* m,
                           int64_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + LANES - 1) / LANES;
  modexp_kernel<<<blocks, 8 * LANES, 0, (cudaStream_t)stream>>>(base, e, m, out, n);
  return (int)cudaGetLastError();
}
