// keccak-256 for one thread: the keccak-f[1600] permutation and the
// absorb/squeeze of a zero-padded message. Shared by K2 (keccak256.cu)
// and K10's SHA3 (evm_step.cuh).
//
// Padding is `msg || 0x01 || 0* || 0x80` exactly as the plain version
// (ops/keccak.py `keccak256_plain`) builds it over a buffer of max_len
// bytes, absorbing only the blocks up to the one that holds the 0x01
// byte. The 25-lane uint64_t state lives in registers; the 24 rounds are
// unrolled.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace keccak {

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

// state index s[x + 5y] = lane A[x, y]
__device__ __forceinline__ void f1600(uint64_t s[25]) {
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    uint64_t bc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) s[j + i] ^= t;
    }
    uint64_t t = s[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      int j = piln[i];
      uint64_t tmp = s[j];
      s[j] = rotl64(t, rotc[i]);
      t = tmp;
    }
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = s[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i) s[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    s[0] ^= kRC[round];
  }
}

// keccak-256 of the first `len` (<= max_len) bytes `byte_at(pos)` gives;
// out = the big-endian hash value as 8 little-endian 32-bit limbs
template <typename ByteAt>
__device__ inline void keccak256(const ByteAt& byte_at, int len, int max_len, uint32_t out[8]) {
  const int rate = 136;
  int n_blocks = (max_len + 1 + rate - 1) / rate;
  int final_block = len / rate;
  int last_byte_pos = (final_block + 1) * rate - 1;
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0ull;
  for (int blk = 0; blk < n_blocks && blk <= final_block; ++blk) {
#pragma unroll
    for (int w = 0; w < 17; ++w) {
      uint64_t lane = 0ull;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        int pos = blk * rate + 8 * w + k;
        uint32_t byte = (pos < len && pos < max_len) ? byte_at(pos) : 0u;
        if (pos == len) byte = 0x01u;
        if (pos == last_byte_pos) byte |= 0x80u;
        lane |= (uint64_t)byte << (8 * k);
      }
      s[w] ^= lane;
    }
    f1600(s);
  }
  // hash byte k = byte (k % 8) of lane k / 8; limb i = hash bytes
  // 28-4i .. 31-4i, the first most significant
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t limb = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int k = 28 - 4 * i + j;
      uint32_t hb = (uint32_t)((s[k / 8] >> (8 * (k % 8))) & 0xFFull);
      limb = (limb << 8) | hb;
    }
    out[i] = limb;
  }
}

}  // namespace keccak
