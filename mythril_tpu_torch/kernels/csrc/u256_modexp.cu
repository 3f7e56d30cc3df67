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
// in small local arrays indexed at run time by the per-lane shift.

#include <cstdint>
#include <cuda_runtime.h>

// x (n limbs) << s into out (n_out limbs), s in [0, 255]
__device__ void shl_bits(const uint32_t* x, int n, int s, uint32_t* out, int n_out) {
  int q = s >> 5, r = s & 31;
  for (int i = 0; i < n_out; ++i) {
    int j = i - q;
    uint32_t lo = (j >= 0 && j < n) ? x[j] : 0u;
    uint32_t lo1 = (j - 1 >= 0 && j - 1 < n) ? x[j - 1] : 0u;
    out[i] = r ? ((lo << r) | (lo1 >> (32 - r))) : lo;
  }
}

// x (n limbs) >> s into out (n_out limbs)
__device__ void shr_bits(const uint32_t* x, int n, int s, uint32_t* out, int n_out) {
  int q = s >> 5, r = s & 31;
  for (int i = 0; i < n_out; ++i) {
    int j = i + q;
    uint32_t lo = (j < n) ? x[j] : 0u;
    uint32_t hi = (j + 1 < n) ? x[j + 1] : 0u;
    out[i] = r ? ((lo >> r) | (hi << (32 - r))) : lo;
  }
}

// low n_out limbs of a (na) * b (nb)
__device__ void mul_low(const uint32_t* a, int na, const uint32_t* b, int nb,
                        uint32_t* out, int n_out) {
  for (int i = 0; i < n_out; ++i) out[i] = 0u;
  for (int i = 0; i < na && i < n_out; ++i) {
    uint64_t carry = 0;
    for (int j = 0; j < nb && i + j < n_out; ++j) {
      uint64_t t = (uint64_t)a[i] * b[j] + out[i + j] + carry;
      out[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    if (i + nb < n_out) out[i + nb] = (uint32_t)carry;
  }
}

// a >= b over n limbs
__device__ bool gte_n(const uint32_t* a, const uint32_t* b, int n) {
  for (int i = n - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

// a -= b over n limbs (mod 2^(32n))
__device__ void sub_n(uint32_t* a, const uint32_t* b, int n) {
  uint64_t borrow = 0;
  for (int i = 0; i < n; ++i) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)t;
    borrow = (t >> 63) & 1u;
  }
}

struct Barrett {
  uint32_t mn[9];  // normalized modulus, limb 8 = 0
  uint32_t mu[9];  // floor(2^512 / m_n), up to 2^257
  int s;
};

// r = a * b mod m, a and b 8 limbs, with a * b < m_n * 2^256 / 2^s
__device__ void mulmod(const Barrett& B, const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t x[16], xn[16], q1[9], q2[18], q3[9], qm[9];
  mul_low(a, 8, b, 8, x, 16);
  shl_bits(x, 16, B.s, xn, 16);
  shr_bits(xn, 16, 255, q1, 9);
  mul_low(q1, 9, B.mu, 9, q2, 18);
  shr_bits(q2, 18, 257, q3, 9);
  mul_low(q3, 9, B.mn, 9, qm, 9);
  uint32_t rr[9];
  for (int i = 0; i < 9; ++i) rr[i] = xn[i];
  sub_n(rr, qm, 9);  // exact: the true remainder estimate is < 3 m_n < 2^288
  for (int k = 0; k < 2; ++k) {
    if (gte_n(rr, B.mn, 9)) sub_n(rr, B.mn, 9);
  }
  shr_bits(rr, 9, B.s, r, 8);
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
  int top = -1;
  for (int i = 7; i >= 0 && top < 0; --i) {
    if (m[i]) top = 32 * i + 31 - __clz(m[i]);
  }
  if (top < 0) {  // m == 0
    for (int i = 0; i < 8; ++i) out[8 * (int64_t)p + i] = 0;
    return;
  }
  Barrett B;
  B.s = 255 - top;
  shl_bits(m, 8, B.s, B.mn, 8);
  B.mn[8] = 0u;
  // mu: quotient bits 257..0 of 2^512 / m_n; the remainder starts at 2^254
  uint32_t rem[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  rem[7] = 1u << 30;
  for (int i = 0; i < 9; ++i) B.mu[i] = 0u;
  for (int i = 257; i >= 0; --i) {
    for (int k = 8; k > 0; --k) rem[k] = (rem[k] << 1) | (rem[k - 1] >> 31);
    rem[0] <<= 1;
    if (gte_n(rem, B.mn, 9)) {
      sub_n(rem, B.mn, 9);
      B.mu[i >> 5] |= 1u << (i & 31);
    }
  }
  // accumulator: 1 mod m
  uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  bool m_is_one = (m[0] == 1u);
  for (int i = 1; i < 8; ++i) m_is_one = m_is_one && (m[i] == 0u);
  acc[0] = m_is_one ? 0u : 1u;
  int etop = -1;
  for (int i = 7; i >= 0 && etop < 0; --i) {
    if (e[i]) etop = 32 * i + 31 - __clz(e[i]);
  }
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
