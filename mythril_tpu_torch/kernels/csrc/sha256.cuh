// SHA-256 for one thread: K4's per-lane body (sha256.cu), kept apart so
// that the CPU tests build it as host C++.
//
// The function is the plain version's (ops/sha256.py `sha256_plain`): the
// message is the first ln bytes of a row of N (bytes at or past N read as
// 0), padded with 0x80 at ln and the 64-bit big-endian bit length in the
// last 8 bytes of the lane's own final block, ceil((ln + 9) / 64) blocks,
// at most the (N + 9 + 63) / 64 the plain version runs.
//
// Design. A block's 16 message words come from four 16-byte loads of the
// row (VEC: the row is 16-byte aligned and N a multiple of 16, as the
// engine's [P, min(M, 448)] input window always is), issued together, only
// where they overlap the message, and byte-swapped with __byte_perm. Bytes
// past the message are masked off a word at a time, the 0x80 byte and the
// length are placed as words: no byte is tested on its own. The 8-word
// state and the 16-word schedule ring live in
// registers: the 64 rounds are unrolled, every index a constant. A lane
// stops after its own last block.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace k4 {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, (uint32_t)n);
}

// whether K4 may read a [P, N] buffer at `data` by aligned 16-byte loads
__device__ __host__ inline bool vec_rows(const uint8_t* data, int N) {
  return N % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
}

// the 16 little-endian words of block bytes [kb, kb + 64) of a row, zero
// where they do not overlap the first nread bytes (never read there)
template <bool VEC>
__device__ __forceinline__ void load_block(const uint8_t* row, int kb, int nread, uint32_t w[16]) {
  if (VEC) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kb + 16 * c < nread) v = *reinterpret_cast<const uint4*>(row + kb + 16 * c);
      w[4 * c] = v.x;
      w[4 * c + 1] = v.y;
      w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint32_t x = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kb + 4 * t + j < nread) x |= (uint32_t)row[kb + 4 * t + j] << (8 * j);
      w[t] = x;
    }
  }
}

// SHA-256 of the first ln bytes of a row of N -> the 8 digest words
template <bool VEC>
__device__ inline void sha256_row(const uint8_t* row, int ln, int N, uint32_t h[8]) {
  const int max_blocks = (N + 9 + 63) / 64;
  const int64_t need = (int64_t)ln + 9 + 63;  // ceil((ln + 9) / 64), floored for ln < -72
  const int64_t n_blocks = need >= 0 ? need / 64 : -((63 - need) / 64);
  const int run = n_blocks < max_blocks ? (int)n_blocks : max_blocks;
  const int nread = ln < N ? ln : N;
  const uint64_t bitlen = (uint64_t)(int64_t)ln * 8u;
  h[0] = 0x6a09e667u; h[1] = 0xbb67ae85u; h[2] = 0x3c6ef372u; h[3] = 0xa54ff53au;
  h[4] = 0x510e527fu; h[5] = 0x9b05688cu; h[6] = 0x1f83d9abu; h[7] = 0x5be0cd19u;
#pragma unroll 1
  for (int blk = 0; blk < run; ++blk) {
    const int kb = 64 * blk;
    uint32_t w[16];
    load_block<VEC>(row, kb, nread, w);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      int rel = nread - (kb + 4 * t);  // message bytes in this word
      uint32_t keep = rel >= 4 ? ~0u : (rel <= 0 ? 0u : ~0u << (32 - 8 * rel));
      int at = ln - (kb + 4 * t);  // the 0x80 byte
      uint32_t pad = (at >= 0 && at < 4) ? 0x80u << (24 - 8 * at) : 0u;
      w[t] = (__byte_perm(w[t], 0u, 0x0123) & keep) | pad;
    }
    if (blk == n_blocks - 1) {
      w[14] = (uint32_t)(bitlen >> 32);
      w[15] = (uint32_t)bitlen;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
        uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
        wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
        w[t & 15] = wt;
      }
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + kK[t] + wt;
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
      hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
}

// K4's lane p of a [P, N] byte buffer: the digest of row p's first len[p]
// bytes as u256 limbs (limb 0 = the last digest word) in out[8p .. 8p + 8),
// int64 carriers; zeros where `mask` (when given) leaves the lane out
template <bool VEC>
__device__ inline void hash_row(const uint8_t* data, const int32_t* len, const uint8_t* mask,
                                int64_t* out, int p, int N) {
  int64_t* o = out + 8 * (int64_t)p;
  uint32_t h[8];
  if (mask != nullptr && !mask[p]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = 0;
    return;
  }
  sha256_row<VEC>(data + (int64_t)p * N, len[p], N, h);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = (int64_t)h[7 - i];
}

}  // namespace k4
