// Shared 256-bit limb helpers for the u256 kernels (K5, K6, K8, K9).
//
// A word is 8 uint32_t limbs, little-endian; the port's tensors carry each
// limb in an int64 (0..2^32-1), so loads truncate and stores widen. Every
// helper works on small per-thread arrays; loops have compile-time trip
// counts where the limb count is fixed, so the compiler keeps the limbs in
// registers.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace u256 {

__device__ inline void load(const int64_t* src, uint32_t* dst, int n = 8) {
  for (int i = 0; i < n; ++i) dst[i] = (uint32_t)src[i];
}

__device__ inline void store(int64_t* dst, const uint32_t* src, int n = 8) {
  for (int i = 0; i < n; ++i) dst[i] = (int64_t)src[i];
}

__device__ inline void copy8(uint32_t* dst, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = src[i];
}

__device__ inline void fill8(uint32_t* dst, uint32_t v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = v;
}

__device__ inline bool is_zero8(const uint32_t* a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a[i];
  return acc == 0u;
}

__device__ inline bool eq8(const uint32_t* a, const uint32_t* b) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a[i] ^ b[i];
  return acc == 0u;
}

// a >= b over n limbs
__device__ inline bool gte_n(const uint32_t* a, const uint32_t* b, int n) {
  for (int i = n - 1; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

__device__ inline bool lt8(const uint32_t* a, const uint32_t* b) { return !gte_n(a, b, 8); }

// out = a + b mod 2^(32n); returns the carry out
__device__ inline bool add_n(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  uint64_t c = 0;
  for (int i = 0; i < n; ++i) {
    uint64_t t = (uint64_t)a[i] + b[i] + c;
    out[i] = (uint32_t)t;
    c = t >> 32;
  }
  return c != 0;
}

// a -= b over n limbs (mod 2^(32n))
__device__ inline void sub_n(uint32_t* a, const uint32_t* b, int n) {
  uint64_t borrow = 0;
  for (int i = 0; i < n; ++i) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    a[i] = (uint32_t)t;
    borrow = (t >> 63) & 1u;
  }
}

// x (n limbs) << s into out (n_out limbs), s in [0, 32 n_out)
__device__ inline void shl_bits(const uint32_t* x, int n, int s, uint32_t* out, int n_out) {
  int q = s >> 5, r = s & 31;
  for (int i = 0; i < n_out; ++i) {
    int j = i - q;
    uint32_t lo = (j >= 0 && j < n) ? x[j] : 0u;
    uint32_t lo1 = (j - 1 >= 0 && j - 1 < n) ? x[j - 1] : 0u;
    out[i] = r ? ((lo << r) | (lo1 >> (32 - r))) : lo;
  }
}

// x (n limbs) >> s into out (n_out limbs)
__device__ inline void shr_bits(const uint32_t* x, int n, int s, uint32_t* out, int n_out) {
  int q = s >> 5, r = s & 31;
  for (int i = 0; i < n_out; ++i) {
    int j = i + q;
    uint32_t lo = (j < n) ? x[j] : 0u;
    uint32_t hi = (j + 1 < n) ? x[j + 1] : 0u;
    out[i] = r ? ((lo >> r) | (hi << (32 - r))) : lo;
  }
}

// EVM shifts by a 256-bit amount word: an amount >= 256 gives 0
__device__ inline bool shift_big(const uint32_t* s) {
  uint32_t hi = 0u;
#pragma unroll
  for (int i = 1; i < 8; ++i) hi |= s[i];
  return hi != 0u || s[0] >= 256u;
}

__device__ inline void shl_word(const uint32_t* s, const uint32_t* a, uint32_t* out) {
  if (shift_big(s)) {
    fill8(out, 0u);
    return;
  }
  shl_bits(a, 8, (int)s[0], out, 8);
}

__device__ inline void shr_word(const uint32_t* s, const uint32_t* a, uint32_t* out) {
  if (shift_big(s)) {
    fill8(out, 0u);
    return;
  }
  shr_bits(a, 8, (int)s[0], out, 8);
}

// low n_out limbs of a (na limbs) * b (nb limbs): schoolbook, 64-bit
// accumulation
__device__ inline void mul_low(const uint32_t* a, int na, const uint32_t* b, int nb,
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

// index of the highest set bit of an 8-limb word, -1 for 0
__device__ inline int top_bit8(const uint32_t* a) {
  for (int i = 7; i >= 0; --i) {
    if (a[i]) return 32 * i + 31 - __clz(a[i]);
  }
  return -1;
}

// Barrett reduction by a nonzero 256-bit modulus m: the modulus is
// normalized (m_n = m << s, top bit 255) and mu = floor(2^512 / m_n) is
// found once by shift-subtract (258 steps). A 512-bit x < m * 2^256 is
// reduced as  q3 = ((x << s) >> 255) * mu >> 257,  r = (x << s) - q3 m_n
// (in [0, 3 m_n)), at most two subtractions of m_n, then r >> s.
struct Barrett {
  uint32_t mn[9];  // normalized modulus, limb 8 = 0
  uint32_t mu[9];  // floor(2^512 / m_n), up to 2^257
  int s;
};

__device__ inline void barrett_init(Barrett& B, const uint32_t* m, int top) {
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
}

// r = x mod m for a 16-limb x < m * 2^256
__device__ inline void barrett_reduce(const Barrett& B, const uint32_t* x, uint32_t* r) {
  uint32_t xn[16], q1[9], q2[18], q3[9], qm[9];
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

}  // namespace u256
