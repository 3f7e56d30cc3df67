// K5's body: base ** e mod m for one lane on a quarter-warp.
//
// The eight threads of a group hold one limb each of every 256-bit value
// (thread g limb g), in registers at fixed indices; a 512-bit value is a
// limb pair per thread (g and g + 8). Limbs move between threads only by
// `__shfl_sync` with a computed source lane, so the normalization shift
// and the per-thread rotations never index an array at run time. Carries
// and borrows resolve by carry lookahead over the group's ballots: with
// G the limbs that generate one and Pm the limbs that pass one on (all
// ones for a carry, zero for a borrow), ((G << 1) + Pm) ^ Pm has the bit
// of every limb that receives one.
//
// Reduction is Barrett's on the normalized modulus m_n = m << s (top bit
// 255), with mu = floor(2^512 / m_n) = mu_top 2^256 + mu_lo, mu_top 1 or 2:
// a 512-bit x < m_n 2^256 has q = floor(x / m_n) >= qhat = mu_top q1 +
// floor(q1 mu_lo / 2^256), q1 = floor(x / 2^256), and q - qhat <= 3, so
// r = x - qhat m_n < 4 m_n: the largest of r - k m_n (k <= 3, computed
// side by side) that is not negative is x mod m_n. The
// walk stays in the scaled domain: a residue a is held as A = a 2^s mod
// m_n, and A times an unscaled b (< 2^256) reduces mod m_n to (a b mod m)
// 2^s. m may be even, so Montgomery's form does not serve.
//
// The exponent is walked from its top window in fixed 4-bit windows:
// four squarings and one multiply by a table entry each, at most 256
// squarings and 64 multiplies, with the 16 powers base^w mod m in the
// group's 512 bytes of shared memory (`tab`). Control flow is the same for
// every group of a warp (the window count is the warp's largest), so each
// collective has all 32 threads: m == 0 computes as m == 1 and is zeroed
// at the end.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace k5 {

constexpr unsigned FULL = 0xFFFFFFFFu;
typedef unsigned long long u64;

struct Group {
  int g;     // this thread's limb
  int base;  // the group's first lane in the warp
};

// limb j (mod 8) of the group's value v
__device__ inline uint32_t from(const Group& G, uint32_t v, int j) {
  return (uint32_t)__shfl_sync(FULL, (int)v, G.base + (j & 7));
}

// the group's bits of a ballot
__device__ inline unsigned bits(const Group& G, bool pred) {
  return (__ballot_sync(FULL, pred) >> G.base) & 0xFFu;
}

// 8-limb a += carries: each limb's value `v` and whether it carried out
// (`gen`); -> the carry out of limb 7
__device__ inline unsigned resolve8(const Group& G, uint32_t& v, bool gen) {
  const unsigned gm = bits(G, gen), pm = bits(G, v == 0xFFFFFFFFu);
  const unsigned s = (gm << 1) + pm;
  v += ((s ^ pm) >> G.g) & 1u;
  return (s >> 8) & 1u;
}

// the same over 16 limbs held as (lo, hi)
__device__ inline void resolve16(const Group& G, uint32_t& lo, bool gen_lo, uint32_t& hi,
                                 bool gen_hi) {
  const unsigned gm = bits(G, gen_lo) | (bits(G, gen_hi) << 8);
  const unsigned pm = bits(G, lo == 0xFFFFFFFFu) | (bits(G, hi == 0xFFFFFFFFu) << 8);
  const unsigned c = ((gm << 1) + pm) ^ pm;
  lo += (c >> G.g) & 1u;
  hi += (c >> (G.g + 8)) & 1u;
}

// a += b mod 2^256; -> the carry out
__device__ inline unsigned add8(const Group& G, uint32_t& a, uint32_t b) {
  const u64 s = (u64)a + b;
  a = (uint32_t)s;
  return resolve8(G, a, (s >> 32) != 0);
}

// a -= b mod 2^256; -> the borrow out
__device__ inline unsigned sub8(const Group& G, uint32_t& a, uint32_t b) {
  const bool gen = a < b;
  a -= b;
  const unsigned gm = bits(G, gen), pm = bits(G, a == 0u);
  const unsigned s = (gm << 1) + pm;
  a -= ((s ^ pm) >> G.g) & 1u;
  return (s >> 8) & 1u;
}

// v >> s and v << s over 8 limbs, s in [0, 256)
__device__ inline uint32_t shr8(const Group& G, uint32_t v, int s) {
  const int q = s >> 5, r = s & 31, j = G.g + q;
  const uint32_t x0 = from(G, v, j), x1 = from(G, v, j + 1);
  const uint32_t lo = j < 8 ? x0 : 0u, hi = j + 1 < 8 ? x1 : 0u;
  return r ? (lo >> r) | (hi << (32 - r)) : lo;
}

__device__ inline uint32_t shl8(const Group& G, uint32_t v, int s) {
  const int q = s >> 5, r = s & 31, j = G.g - q;
  const uint32_t x0 = from(G, v, j), x1 = from(G, v, j - 1);
  const uint32_t lo = j >= 0 ? x0 : 0u, hi = j - 1 >= 0 ? x1 : 0u;
  return r ? (lo << r) | (hi >> (32 - r)) : lo;
}

// a times b -> 16 limbs (lo: limb g, hi: limb g + 8); brot[i] = b's limb
// (g - i) mod 8. Thread g sums column g (products a_i b_{g-i}, i <= g) and
// column g + 8 (i > g) in 64 bits and a count of overflows, then the
// columns' high words move one and two limbs up.
__device__ inline void mul(const Group& G, uint32_t a, const uint32_t* brot, uint32_t& lo,
                           uint32_t& hi) {
  uint32_t ab[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ab[i] = from(G, a, i);
  u64 acc_lo = 0, acc_hi = 0;
  uint32_t ov_lo = 0, ov_hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const u64 p = (u64)ab[i] * brot[i];
    if (i <= G.g) {
      acc_lo += p;
      ov_lo += acc_lo < p;
    } else {
      acc_hi += p;
      ov_hi += acc_hi < p;
    }
  }
  const int g = G.g;
  // a column's bits 32..63 go one limb up, its overflows (<= 7) two; the
  // hi column g + 8 takes them from column g + 7 (thread 7's lo for g = 0)
  // and g + 6 (thread 6's or 7's lo for g < 2)
  const uint32_t p1_lo = from(G, (uint32_t)(acc_lo >> 32), g - 1);
  const uint32_t p1_hi = from(G, (uint32_t)(acc_hi >> 32), g - 1);
  const uint32_t p2 = from(G, ov_lo | (ov_hi << 8), g - 2);
  const uint32_t c1_lo = g >= 1 ? p1_lo : 0u, c1_hi = g >= 1 ? p1_hi : p1_lo;
  const uint32_t c2_lo = g >= 2 ? (p2 & 0xFFu) : 0u, c2_hi = g >= 2 ? (p2 >> 8) : (p2 & 0xFFu);
  const u64 t_lo = (u64)(uint32_t)acc_lo + c1_lo + c2_lo;
  const u64 t_hi = (u64)(uint32_t)acc_hi + c1_hi + c2_hi;
  // t < 2^34: its bits 32.. (<= 2) carry one limb up, then single carries
  const uint32_t cp = from(G, (uint32_t)(t_lo >> 32) | ((uint32_t)(t_hi >> 32) << 8), g - 1);
  const uint32_t ci_lo = g >= 1 ? (cp & 0xFFu) : 0u, ci_hi = g >= 1 ? (cp >> 8) : (cp & 0xFFu);
  const u64 s_lo = (u64)(uint32_t)t_lo + ci_lo, s_hi = (u64)(uint32_t)t_hi + ci_hi;
  lo = (uint32_t)s_lo;
  hi = (uint32_t)s_hi;
  resolve16(G, lo, (s_lo >> 32) != 0, hi, (s_hi >> 32) != 0);
}

// the reduction's constants for one lane
struct Mod {
  uint32_t mn, mn2, mn3;  // this thread's limb of m_n, 2 m_n and 3 m_n
  uint32_t top2, top3;    // limb 8 of 2 m_n and 3 m_n
  uint32_t mrot[8];       // m_n's limb (g - i) mod 8
  uint32_t murot[8];      // mu_lo's limb (g - i) mod 8
  bool mu2;               // mu_top == 2 (m_n == 2^255)
  int s;
};

// one of eight registers by a run-time index, without indexing an array
__device__ inline uint32_t pick8(const uint32_t* r, int j) {
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) v = i == j ? r[i] : v;
  return v;
}

// m (this thread's limb) nonzero -> the reduction's constants. mu by
// shift-subtract, the quotient bits 257..0 of 2^512 / m_n, computed by
// every thread of the group on the whole of m_n
__device__ inline void mod_init(const Group& G, Mod& M, uint32_t m) {
  const unsigned nz = bits(G, m != 0u);
  const int top_limb = nz ? 31 - __clz((int)nz) : 0;
  const uint32_t top_word = from(G, m, top_limb);
  M.s = 255 - (32 * top_limb + 31 - __clz((int)top_word));
  M.mn = shl8(G, m, M.s);
  M.mn2 = shl8(G, M.mn, 1);
  M.top2 = 1u;  // m_n's top bit
  M.mn3 = M.mn2;
  M.top3 = M.top2 + add8(G, M.mn3, M.mn);
  uint32_t mn[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mn[i] = from(G, M.mn, i);
    M.mrot[i] = from(G, M.mn, G.g - i);
  }
  uint32_t rem[9] = {0, 0, 0, 0, 0, 0, 0, 1u << 30, 0};  // 2^254
  uint32_t mu[9];
#pragma unroll
  for (int limb = 8; limb >= 0; --limb) {
    uint32_t qw = 0u;
#pragma unroll 1
    for (int bit = limb == 8 ? 1 : 31; bit >= 0; --bit) {
#pragma unroll
      for (int k = 8; k > 0; --k) rem[k] = (rem[k] << 1) | (rem[k - 1] >> 31);
      rem[0] <<= 1;
      // rem >= m_n (m_n's limb 8 is 0)
      bool ge = rem[8] != 0u, decided = ge;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        ge = decided ? ge : rem[k] > mn[k];
        decided = decided || rem[k] != mn[k];
      }
      ge = decided ? ge : true;
      u64 borrow = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const u64 t = (u64)rem[k] - (k < 8 ? mn[k] : 0u) - borrow;
        borrow = (t >> 63) & 1u;
        rem[k] = ge ? (uint32_t)t : rem[k];
      }
      qw |= (ge ? 1u : 0u) << bit;
    }
    mu[limb] = qw;
  }
  M.mu2 = mu[8] == 2u;
#pragma unroll
  for (int i = 0; i < 8; ++i) M.murot[i] = pick8(mu, (G.g - i) & 7);
}

// x = (lo, hi) < m_n 2^256 -> x mod m_n
__device__ inline uint32_t reduce(const Group& G, const Mod& M, uint32_t lo, uint32_t hi) {
  uint32_t ph_lo, ph_hi;
  mul(G, hi, M.murot, ph_lo, ph_hi);  // q1 mu_lo
  uint32_t qhat = ph_hi;
  add8(G, qhat, hi);
  add8(G, qhat, M.mu2 ? hi : 0u);
  uint32_t q_lo, q_hi;
  mul(G, qhat, M.mrot, q_lo, q_hi);   // qhat m_n, of which limbs 0..8 count
  const uint32_t x8 = from(G, hi, 0), q8 = from(G, q_hi, 0);
  uint32_t r = lo;
  const uint32_t r8 = x8 - q8 - sub8(G, r, q_lo);
  // r (limb 8: r8) < 4 m_n: the largest r - k m_n, k <= 3, that is not
  // negative, its sign read from limb 8 (|r - k m_n| < 2^258)
  uint32_t d1 = r, d2 = r, d3 = r;
  const int t1 = (int)(r8 - sub8(G, d1, M.mn));
  const int t2 = (int)(r8 - M.top2 - sub8(G, d2, M.mn2));
  const int t3 = (int)(r8 - M.top3 - sub8(G, d3, M.mn3));
  return t3 >= 0 ? d3 : t2 >= 0 ? d2 : t1 >= 0 ? d1 : r;
}

// A (scaled) times b (unscaled, brot its rotation) -> scaled
__device__ inline uint32_t mulmod(const Group& G, const Mod& M, uint32_t A, const uint32_t* brot) {
  uint32_t lo, hi;
  mul(G, A, brot, lo, hi);
  return reduce(G, M, lo, hi);
}

__device__ inline void rotation(const Group& G, uint32_t v, uint32_t* rot) {
#pragma unroll
  for (int i = 0; i < 8; ++i) rot[i] = from(G, v, G.g - i);
}

// this thread's limb of b ** e mod m (m == 0 -> 0); `tab` is the group's
// 16 x 8 words of shared memory
__device__ inline uint32_t modexp(const Group& G, uint32_t b, uint32_t e, uint32_t m,
                                  uint32_t* tab) {
  const bool m_zero = bits(G, m != 0u) == 0u;
  const bool m_one = bits(G, m != (G.g == 0 ? 1u : 0u)) == 0u;
  Mod M;
  mod_init(G, M, m_zero ? (G.g == 0 ? 1u : 0u) : m);
  // the scaled one: 2^s, or 0 when m == 1
  const uint32_t one_s = (!m_one && G.g == (M.s >> 5)) ? 1u << (M.s & 31) : 0u;
  uint32_t brot[8];
  rotation(G, b, brot);
  tab[G.g] = (!m_one && G.g == 0) ? 1u : 0u;
  uint32_t A = one_s;
#pragma unroll 1
  for (int w = 1; w < 16; ++w) {
    A = mulmod(G, M, A, brot);
    tab[w * 8 + G.g] = shr8(G, A, M.s);
  }
  // the warp's top window
  const unsigned enz = bits(G, e != 0u);
  const int etl = enz ? 31 - __clz((int)enz) : 0;
  const uint32_t etw = from(G, e, etl);
  int kmax = enz ? (32 * etl + 31 - __clz((int)etw)) >> 2 : -1;
  const int lane = G.base + G.g;
  kmax = max(kmax, __shfl_sync(FULL, kmax, lane ^ 8));
  kmax = max(kmax, __shfl_sync(FULL, kmax, lane ^ 16));
  __syncwarp();
  A = one_s;
#pragma unroll 1
  for (int k = kmax; k >= 0; --k) {
    if (k != kmax) {
#pragma unroll 1
      for (int sq = 0; sq < 4; ++sq) {
        uint32_t urot[8];
        rotation(G, shr8(G, A, M.s), urot);
        A = mulmod(G, M, A, urot);
      }
    }
    const int w = (int)((from(G, e, k >> 3) >> ((k & 7) * 4)) & 15u);
    uint32_t trot[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) trot[i] = tab[w * 8 + ((G.g - i) & 7)];
    A = mulmod(G, M, A, trot);
  }
  const uint32_t out = shr8(G, A, M.s);
  return m_zero ? 0u : out;
}

}  // namespace k5
