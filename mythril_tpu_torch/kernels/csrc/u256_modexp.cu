// K5: u256 modular exponentiation base ** e mod m (m == 0 -> 0), one
// thread per lane.
//
// Replaces the JAX package's ops/u256.py `modexp` (precompile 0x5 for
// operands of at most 32 bytes), whose MSB-first square-and-multiply
// calls the 512-step bitwise `_mod_wide` twice per exponent bit. The
// function is the same — the accumulator starts at 1, so m == 1 gives 0
// even for e == 0 — but the reduction is Barrett's: the modulus is
// normalized (m_n = m << s, top bit 255), mu = floor(2^512 / m_n) is
// found once per lane by shift-subtract (258 steps), and each 512-bit
// product x (< m_n * 2^256 after the shift) is reduced as
//   q3 = ((x >> 255) * mu) >> 257,  r = x - q3 * m_n  (in [0, 3 m_n)),
// then at most two subtractions of m_n, and r >> s. The thread walks
// its own exponent's bits from the highest set one (the leading zeros
// leave 1 mod m unchanged).
//
// Bound: operations. A product-reduce step is 190 32x32->64 multiply-
// adds (64 + 81 + 45) plus shifts; a lane does bitlen(e) squarings and
// popcount(e) multiplies, up to 512 for a 256-bit exponent. Limbs live
// in small local arrays indexed at run time by the per-lane shift; the
// limb helpers and the Barrett reduction are shared with K9 (u256.cuh).

#include "u256.cuh"

using namespace u256;

// r = a * b mod m for 8-limb a below m (so a * b < m * 2^256)
__device__ void mulmod(const Barrett& B, const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[16];
  mul_low(a, 8, b, 8, x, 16);
  barrett_reduce(B, x, r);
}

__global__ void modexp_kernel(const int64_t* __restrict__ base_in,
                              const int64_t* __restrict__ e_in,
                              const int64_t* __restrict__ m_in,
                              int64_t* __restrict__ out, int n) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t base[8], e[8], m[8];
  for (int i = 0; i < 8; ++i) {
    base[i] = (uint32_t)base_in[8 * (int64_t)p + i];
    e[i] = (uint32_t)e_in[8 * (int64_t)p + i];
    m[i] = (uint32_t)m_in[8 * (int64_t)p + i];
  }
  int top = top_bit8(m);
  if (top < 0) {  // m == 0
    for (int i = 0; i < 8; ++i) out[8 * (int64_t)p + i] = 0;
    return;
  }
  Barrett B;
  barrett_init(B, m, top);
  // accumulator: 1 mod m
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  bool m_is_one = (m[0] == 1u);
  for (int i = 1; i < 8; ++i) m_is_one = m_is_one && (m[i] == 0u);
  acc[0] = m_is_one ? 0u : 1u;
  int etop = top_bit8(e);
  uint32_t t[8];
  for (int i = etop; i >= 0; --i) {
    mulmod(B, acc, acc, t);
    for (int k = 0; k < 8; ++k) acc[k] = t[k];
    if ((e[i >> 5] >> (i & 31)) & 1u) {
      mulmod(B, acc, base, t);
      for (int k = 0; k < 8; ++k) acc[k] = t[k];
    }
  }
  for (int i = 0; i < 8; ++i) out[8 * (int64_t)p + i] = (int64_t)acc[i];
}

extern "C" int modexp_u256(const int64_t* base, const int64_t* e, const int64_t* m,
                           int64_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  int threads = 64;
  int blocks = (n + threads - 1) / threads;
  modexp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(base, e, m, out, n);
  return (int)cudaGetLastError();
}
