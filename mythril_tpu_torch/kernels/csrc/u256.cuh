// Shared 256-bit limb helpers for the u256 kernels (K1, K5, K6, K8, K9)
// and the concrete EVM step (K10).
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

// ---------------------------------------------------------------------------
// EVM word operations (K10; DIV/MOD shared with K1, MULMOD/EXP with K9)
// ---------------------------------------------------------------------------

__device__ inline bool msb8(const uint32_t* a) { return (a[7] >> 31) != 0u; }

// out = a - b mod 2^256
__device__ inline void sub8(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  copy8(out, a);
  sub_n(out, b, 8);
}

// two's complement negation
__device__ inline void neg8(const uint32_t* a, uint32_t* out) {
  uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  sub8(z, a, out);
}

// signed a < b
__device__ inline bool slt8(const uint32_t* a, const uint32_t* b) {
  bool sa = msb8(a), sb = msb8(b);
  return sa != sb ? sa : lt8(a, b);
}

// |a| as unsigned; returns whether a was negative
__device__ inline bool abs_signed8(const uint32_t* a, uint32_t* out) {
  bool n = msb8(a);
  if (n) {
    neg8(a, out);
  } else {
    copy8(out, a);
  }
  return n;
}

// the low 32 bits, saturating to 2^32 - 1 when a higher limb is set
__device__ inline uint32_t to_u32_sat(const uint32_t* a) {
  uint32_t hi = 0u;
#pragma unroll
  for (int i = 1; i < 8; ++i) hi |= a[i];
  return hi ? 0xFFFFFFFFu : a[0];
}

// the low 64 bits, saturating to 2^64 - 1 when a higher limb is set, as
// the int64 with that bit pattern (2^64 - 1 reads as -1)
__device__ inline int64_t to_i64_sat(const uint32_t* a) {
  uint32_t hi = 0u;
#pragma unroll
  for (int i = 2; i < 8; ++i) hi |= a[i];
  if (hi) return -1;
  return (int64_t)(((uint64_t)a[1] << 32) | a[0]);
}

// the word holding the 64-bit pattern of x
__device__ inline void from_i64(int64_t x, uint32_t* out) {
  fill8(out, 0u);
  out[0] = (uint32_t)(uint64_t)x;
  out[1] = (uint32_t)((uint64_t)x >> 32);
}

// SIGNEXTEND: extend the sign of byte k of x (k >= 31: x unchanged)
__device__ inline void signextend8(const uint32_t* k, const uint32_t* x, uint32_t* out) {
  uint32_t k32 = to_u32_sat(k);
  if (k32 >= 31u) {
    copy8(out, x);
    return;
  }
  int bi = 8 * (int)k32 + 7;
  bool sign = ((x[bi >> 5] >> (bi & 31)) & 1u) != 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int into = bi - 32 * i;
    uint32_t keep = into >= 31 ? 0xFFFFFFFFu : (into < 0 ? 0u : (1u << (into + 1)) - 1u);
    out[i] = (x[i] & keep) | (sign ? ~keep : 0u);
  }
}

// BYTE: byte i of x counting from the most significant (i >= 32: 0)
__device__ inline void byte8(const uint32_t* i, const uint32_t* x, uint32_t* out) {
  uint32_t i32 = to_u32_sat(i);
  fill8(out, 0u);
  if (i32 >= 32u) return;
  int j = 31 - (int)i32;
  out[0] = (x[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// SAR: arithmetic a >> s (s >= 256: the sign fill)
__device__ inline void sar_word(const uint32_t* s, const uint32_t* a, uint32_t* out) {
  bool neg = msb8(a);
  if (shift_big(s)) {
    fill8(out, neg ? 0xFFFFFFFFu : 0u);
    return;
  }
  int sh = (int)s[0];
  shr_bits(a, 8, sh, out, 8);
  if (neg && sh > 0) {
    uint32_t ones[8], fill[8];
    fill8(ones, 0xFFFFFFFFu);
    shl_bits(ones, 8, 256 - sh, fill, 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] |= fill[i];
  }
}

// Unsigned (x / d, x % d), division by zero giving (0, 0): the 256-step
// shift-subtract long division, with the limbs in registers throughout
// (K1's loop; DIV/MOD/SDIV/SMOD of K10)
__device__ inline void divmod8(const uint32_t* x, const uint32_t* d, uint32_t* q, uint32_t* r) {
  uint32_t dz = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q[i] = 0u;
    r[i] = 0u;
    dz |= d[i];
  }
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
    q[i] &= keep;
    r[i] &= keep;
  }
}

// r = x mod m for a 512-bit x (16 limbs), m == 0 giving 0: Barrett in two
// steps that each meet its bound x < m * 2^256 — first the high half, then
// r_hi * 2^256 + x_lo with r_hi < m (K9's mod_wide; ADDMOD/MULMOD of K10)
__device__ inline void mod_wide16(const uint32_t* x, const uint32_t* m, uint32_t* r) {
  int top = top_bit8(m);
  if (top < 0) {
    fill8(r, 0u);
    return;
  }
  Barrett B;
  barrett_init(B, m, top);
  uint32_t t[16];
  for (int i = 0; i < 8; ++i) {
    t[i] = x[8 + i];
    t[8 + i] = 0u;
  }
  uint32_t rh[8];
  barrett_reduce(B, t, rh);
  for (int i = 0; i < 8; ++i) {
    t[i] = x[i];
    t[8 + i] = rh[i];
  }
  barrett_reduce(B, t, r);
}

// base ** e mod 2^256 by square-and-multiply of low products from the top
// set bit of e; e == 0 gives 1 (K9's exp; EXP of K10)
__device__ inline void exp8(const uint32_t* base, const uint32_t* e, uint32_t* out) {
  uint32_t t[8];
  fill8(out, 0u);
  out[0] = 1u;
  for (int i = top_bit8(e); i >= 0; --i) {
    mul_low(out, 8, out, 8, t, 8);
    copy8(out, t);
    if ((e[i >> 5] >> (i & 31)) & 1u) {
      mul_low(out, 8, base, 8, t, 8);
      copy8(out, t);
    }
  }
}

}  // namespace u256
