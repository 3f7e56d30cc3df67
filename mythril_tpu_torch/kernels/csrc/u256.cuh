// Shared 256-bit limb helpers for the u256 kernels (K1, K6, K8, K9) and
// the concrete EVM step (K10), and the bodies K1, K9 and K10 share: the
// division core `divrem` (Knuth's algorithm D over 32-bit limbs, behind
// DIV/MOD and ADDMOD/MULMOD) and the EXP chain `exp8`.
//
// A word is 8 uint32_t limbs, little-endian; the port's tensors carry each
// limb in an int64 (0..2^32-1), so loads truncate and stores widen. Every
// helper works on small per-thread arrays. The division core and the EXP
// chain index their arrays with compile-time constants only (unrolled
// loops, select networks for runtime shifts and limb picks), so the limbs
// stay in registers: K1 and K9 have no stack frame and no spill.

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

// a < b over 8 limbs: the borrow out of a - b, unrolled and branch-free so
// that neither word leaves registers
__device__ inline bool lt8(const uint32_t* a, const uint32_t* b) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) borrow = (uint32_t)(((uint64_t)a[i] - b[i] - borrow) >> 63);
  return borrow != 0u;
}

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

// index of the highest set bit of an 8-limb word, -1 for 0 (a select a
// limb, no early exit: a loop that returns early indexes the word at run
// time and puts it in local memory)
__device__ inline int top_bit8(const uint32_t* a) {
  int t = -1;
#pragma unroll
  for (int i = 0; i < 8; ++i) t = a[i] ? 32 * i + 31 - __clz(a[i]) : t;
  return t;
}

// index of the lowest set bit of an 8-limb word, -1 for 0, as top_bit8
__device__ inline int low_bit8(const uint32_t* a) {
  int t = -1;
#pragma unroll
  for (int i = 7; i >= 0; --i) t = a[i] ? 32 * i + 31 - __clz(a[i] & (0u - a[i])) : t;
  return t;
}

// x (N limbs) << s in place for s in [0, 256): a funnel shift by s % 32,
// then the limbs moved by s / 32 through three select stages (1, 2, 4
// limbs). Every index is a compile-time constant, so the limbs stay in
// registers; bits shifted past limb N - 1 are dropped.
template <int N>
__device__ inline void shl_norm(uint32_t* x, int s) {
  int r = s & 31, ls = s >> 5;
#pragma unroll
  for (int i = N - 1; i > 0; --i)
    x[i] = (uint32_t)(((((uint64_t)x[i] << 32) | x[i - 1]) << r) >> 32);
  x[0] <<= r;
#pragma unroll
  for (int k = 1; k < 8; k <<= 1) {
    bool on = (ls & k) != 0;
#pragma unroll
    for (int i = N - 1; i >= 0; --i) x[i] = on ? (i >= k ? x[i - k] : 0u) : x[i];
  }
}

// x (N limbs) >> s in place for s in [0, 256), as shl_norm
template <int N>
__device__ inline void shr_norm(uint32_t* x, int s) {
  int r = s & 31, ls = s >> 5;
#pragma unroll
  for (int k = 1; k < 8; k <<= 1) {
    bool on = (ls & k) != 0;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = on ? (i + k < N ? x[i + k] : 0u) : x[i];
  }
#pragma unroll
  for (int i = 0; i < N - 1; ++i)
    x[i] = (uint32_t)((((uint64_t)x[i + 1] << 32) | x[i]) >> r);
  x[N - 1] >>= r;
}

// Möller and Granlund's reciprocal of a normalized limb d (top bit set):
// floor((2^64 - 1) / d) - 2^32. The quotient lies in [2^32, 2^33), so the
// cast drops the 2^32. One 64-bit division a call.
__device__ inline uint32_t recip32(uint32_t d) { return (uint32_t)(~0ull / d); }

// (u1 2^32 + u0) / d for a normalized d > u1, with v = recip32(d): the
// quotient, the remainder in rem (Möller and Granlund, "Improved division
// by invariant integers", 2011, algorithm 4). A multiply and at most two
// corrections, no hardware divide.
__device__ inline uint32_t div2by1(uint32_t u1, uint32_t u0, uint32_t d, uint32_t v,
                                   uint32_t& rem) {
  uint64_t p = (uint64_t)v * u1 + (((uint64_t)u1 << 32) | u0);
  uint32_t q1 = (uint32_t)(p >> 32) + 1u, q0 = (uint32_t)p;
  uint32_t r = u0 - q1 * d;
  if (r > q0) {
    --q1;
    r += d;
  }
  if (r >= d) {
    ++q1;
    r -= d;
  }
  rem = r;
  return q1;
}

// (x / d, x % d) for an NX-limb x and a 256-bit d, d == 0 giving (0, 0);
// the quotient's NX limbs are written only when Q. Knuth's algorithm D
// over 32-bit limbs (TAOCP vol. 2, 4.3.1), the divisor always 8 limbs:
//   - quick exits: d == 0; x < d; a one-limb d (NX 2-by-1 steps);
//   - d is shifted left until its top bit is bit 255, and x by the same
//     s bits into NX + 9 limbs, so the quotient has NX + 1 digits and
//     every limb index below is a compile-time constant (the digit loop
//     is unrolled); the leading digits whose window lies above x's top
//     limb are skipped;
//   - a digit is estimated from the window's top two limbs by div2by1
//     against the divisor's top limb (the cap 2^32 - 1 when they are
//     equal), lowered at most twice by Knuth's test against the second
//     limb, then its 8-limb multiply-subtract row runs with 64-bit
//     accumulation; a borrow out of the window adds the divisor back once;
//   - the remainder is the low 8 limbs shifted back by s.
template <int NX, bool Q>
__device__ inline void divrem(const uint32_t* x, const uint32_t* d, uint32_t* q,
                              uint32_t* r) {
  fill8(r, 0u);
  if (Q) {
#pragma unroll
    for (int i = 0; i < NX; ++i) q[i] = 0u;
  }
  int top = top_bit8(d);
  if (top < 0) return;
  uint32_t xhi = 0u;
#pragma unroll
  for (int i = 8; i < NX; ++i) xhi |= x[i];
  if (xhi == 0u && lt8(x, d)) {
    copy8(r, x);
    return;
  }
  if (top < 32) {
    int c = __clz(d[0]);
    uint32_t dn = d[0] << c, v = recip32(dn);
    uint32_t rem = (uint32_t)(((uint64_t)x[NX - 1] << c) >> 32);
#pragma unroll
    for (int i = NX - 1; i >= 0; --i) {
      uint32_t lo = i > 0 ? x[i - 1] : 0u;
      uint32_t ui = (uint32_t)(((((uint64_t)x[i] << 32) | lo) << c) >> 32);
      uint32_t qi = div2by1(rem, ui, dn, v, rem);
      if (Q) q[i] = qi;
    }
    r[0] = rem >> c;
    return;
  }
  int s = 255 - top;
  uint32_t v[8], u[NX + 9];
  copy8(v, d);
  shl_norm<8>(v, s);
#pragma unroll
  for (int i = 0; i < NX + 9; ++i) u[i] = i < NX ? x[i] : 0u;
  shl_norm<NX + 9>(u, s);
  int L = 0;  // limbs of the normalized dividend
#pragma unroll
  for (int i = 0; i < NX + 9; ++i) L = u[i] ? i + 1 : L;
  uint32_t v7 = v[7], v6 = v[6], rv = recip32(v7);
#pragma unroll
  for (int j = NX; j >= 0; --j) {
    if (j + 7 >= L) continue;  // window below 2^224: a zero digit
    uint32_t qh;
    uint64_t rh;
    if (u[j + 8] >= v7) {  // the cap
      qh = 0xFFFFFFFFu;
      rh = (uint64_t)u[j + 7] + v7;
    } else {
      uint32_t rr;
      qh = div2by1(u[j + 8], u[j + 7], v7, rv, rr);
      rh = rr;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // Knuth's test against the second limb
      if ((rh >> 32) == 0u && (uint64_t)qh * v6 > ((rh << 32) | u[j + 6])) {
        --qh;
        rh += v7;
      }
    }
    uint64_t carry = 0u;
    uint32_t borrow = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t p = (uint64_t)qh * v[i] + carry;
      carry = p >> 32;
      uint64_t t = (uint64_t)u[j + i] - (uint32_t)p - borrow;
      u[j + i] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    uint64_t t = (uint64_t)u[j + 8] - carry - borrow;
    u[j + 8] = (uint32_t)t;
    if (t >> 63) {  // qh was one too large: add the divisor back
      --qh;
      uint64_t c = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c += (uint64_t)u[j + i] + v[i];
        u[j + i] = (uint32_t)c;
        c >>= 32;
      }
      u[j + 8] += (uint32_t)c;
    }
    if (Q && j < NX) q[j] = qh;
  }
  shr_norm<8>(u, s);
  copy8(r, u);
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

// Unsigned (x / d, x % d), division by zero giving (0, 0): the division
// core on an 8-limb dividend, at most 9 digits (K1; DIV/MOD/SDIV/SMOD of
// K10)
__device__ inline void divmod8(const uint32_t* x, const uint32_t* d, uint32_t* q, uint32_t* r) {
  divrem<8, true>(x, d, q, r);
}

// r = x mod m for a 512-bit x (16 limbs), m == 0 giving 0: the division
// core on a 16-limb dividend, at most 17 digits, no quotient kept (K9's
// mod_wide; ADDMOD/MULMOD of K10)
__device__ inline void mod_wide16(const uint32_t* x, const uint32_t* m, uint32_t* r) {
  divrem<16, false>(x, m, nullptr, r);
}

// low 8 limbs of a * b from its 36 partial products, summed by column:
// each product's halves go into 64-bit column sums (a column takes at most
// 16 halves, far from overflow), so the products are independent of each
// other and only the final carry pass over the 8 columns is serial; out
// may be a or b
__device__ inline void mul_low8(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint64_t s[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; i + j < 8; ++j) {
      uint64_t p = (uint64_t)a[i] * b[j];
      s[i + j] += (uint32_t)p;
      s[i + j + 1] += p >> 32;
    }
  }
  uint64_t c = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += s[k];
    out[k] = (uint32_t)c;
    c >>= 32;
  }
}

// low 8 limbs of a * a in 20 products, by column as mul_low8: the 16
// a_i a_j with i < j and i + j < 8, doubled, and the 4 squares a_i^2; out
// may be a
__device__ inline void sqr_low8(const uint32_t* a, uint32_t* out) {
  uint64_t s[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i + 1; i + j < 8; ++j) {
      uint64_t p = (uint64_t)a[i] * a[j];
      s[i + j] += (uint32_t)p;
      s[i + j + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] <<= 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t p = (uint64_t)a[i] * a[i];
    s[2 * i] += (uint32_t)p;
    s[2 * i + 1] += p >> 32;
  }
  uint64_t c = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += s[k];
    out[k] = (uint32_t)c;
    c >>= 32;
  }
}

// base ** e mod 2^256, e == 0 giving 1 (0 ** 0 included) (K9's exp; EXP
// of K10). Exact fast paths first, in the order of their cost: e == 0;
// base 0 or 1; base = 2^k (1 << k e when k e < 256, else 0); an even
// base 2^t b' with t e >= 256 (e >= 256 included), whose power 2^256
// divides. Otherwise left-to-right exponentiation in fixed 2-bit windows
// of e: base^2 and base^3 precomputed (two products), then a window two
// squarings and, unless its digit is 0, one multiply by base^digit, which
// a select picks from the three words; e's limb is picked by a select
// scan, so e and the table stay in registers.
__device__ inline void exp8(const uint32_t* base, const uint32_t* e, uint32_t* out) {
  fill8(out, 0u);
  int te = top_bit8(e);
  if (te < 0) {
    out[0] = 1u;
    return;
  }
  int tb = top_bit8(base);
  if (tb <= 0) {
    out[0] = tb == 0 ? 1u : 0u;
    return;
  }
  int lb = low_bit8(base);
  bool small_e = te < 8;  // e < 256, e == e[0]
  if (lb == tb) {  // base = 2^k
    uint32_t ke = small_e ? (uint32_t)tb * e[0] : 256u;
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (ke < 256u && (int)(ke >> 5) == i) ? 1u << (ke & 31) : 0u;
    return;
  }
  if (lb > 0 && (!small_e || (uint32_t)lb * e[0] >= 256u)) return;
  uint32_t b1[8], b2[8], b3[8];
  copy8(b1, base);
  sqr_low8(b1, b2);
  mul_low8(b2, b1, b3);
  int top = te | 1;  // the top window, bits top and top - 1, holds te
  bool first = true;
#pragma unroll 1
  for (int l = top >> 5; l >= 0; --l) {
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) w = i == l ? e[i] : w;
#pragma unroll 1
    for (int k = l == (top >> 5) ? (top & 31) : 31; k > 0; k -= 2) {
      uint32_t d = (w >> (k - 1)) & 3u;
      uint32_t m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = d == 1u ? b1[i] : (d == 2u ? b2[i] : b3[i]);
      if (first) {  // its digit is not 0
        copy8(out, m);
        first = false;
        continue;
      }
      sqr_low8(out, out);
      sqr_low8(out, out);
      if (d) mul_low8(out, m, out);
    }
  }
}

}  // namespace u256
