// keccak-256 for one thread: the keccak-f[1600] permutation and the
// absorb/squeeze of a message read from memory by whole words. Shared by
// K2 (keccak256.cu) and K10's SHA3 (evm_step.cuh).
//
// The function is the plain version's (ops/keccak.py `keccak256_plain`):
// `msg || 0x01 || 0* || 0x80` over a buffer of max_len bytes, absorbing
// only the blocks up to the one that holds the 0x01 byte.
//
// Design. Each 136-byte block's 17 lanes come from 18 aligned 8-byte
// loads, issued together before the block's permutation; a message that
// does not start on an 8-byte boundary is lined up with two 32-bit funnel
// shifts a lane. Bytes past the message are masked off a lane at a time,
// and the 0x01 and 0x80 pad bytes are ORed in as lane masks: no byte is
// loaded or tested on its own. A word is loaded only where it overlaps
// the message, and only inside the readable range of the `Window`, so a
// thread never reads outside its row (K10) or its buffer (K2). The
// 25-lane uint64_t state lives in registers: every index into it is a
// compile-time constant.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace keccak {

constexpr int RATE = 136;      // bytes a block
constexpr int RATE_LANES = 17;  // 64-bit lanes a block

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

// state index s[x + 5y] = lane A[x, y]. The 24 rounds run as a loop of one
// unrolled round. Fully unrolled, the permutation is some 4,500
// instructions of straight-line code, each run once a block; rolled, it
// is one round's ~190 run 24 times, and on an H100 it ran faster so
// (tools/hash_variants.py: K10's SHA3 class 0.048-0.050 -> 0.019 ms, K2
// 0.0191 -> 0.0153), which points at instruction fetch, not arithmetic.
__device__ __forceinline__ void f1600(uint64_t s[25]) {
  const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                        27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll 1
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

// Where a message lies: its bytes are base[start + i] for 0 <= i < len,
// where start + i lies in [lo, hi), and 0 elsewhere. `base` is 8-byte
// aligned; offsets are relative to it and may be negative (K10's SHA3 at
// an offset that saturated to -1 reads zeros before the row).
struct Window {
  const uint8_t* base;
  int64_t lo, hi;  // the bytes a thread may read
  int64_t start;   // the message's first byte
};

// Aligned 8-byte word `wi` of the window's base: the whole word when it
// lies in [lo, hi), 0 when it lies outside. With RAGGED (lo or hi not a
// multiple of 8: K2's rows of any length, in a buffer at any address), a
// word that straddles lo or hi is read a byte at a time, the bytes outside
// read as 0; K10's rows are 8-byte aligned and a multiple of 32 long.
template <bool RAGGED>
__device__ __forceinline__ uint64_t load_word(const Window& w, int64_t wi) {
  int64_t b = 8 * wi;
  if (b >= w.lo && b + 8 <= w.hi) return *reinterpret_cast<const uint64_t*>(w.base + b);
  uint64_t v = 0ull;
  if (RAGGED && b + 8 > w.lo && b < w.hi) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (b + k >= w.lo && b + k < w.hi) v |= (uint64_t)w.base[b + k] << (8 * k);
  }
  return v;
}

// lane mask of the first n bytes (n <= 0: none, n >= 8: all)
__device__ __forceinline__ uint64_t byte_mask(int n) {
  return n >= 8 ? ~0ull : (n <= 0 ? 0ull : (1ull << (8 * n)) - 1ull);
}

// keccak-256 of the `len` bytes of `win`, zero-padded to max_len; out = the
// big-endian hash value as 8 little-endian 32-bit limbs
template <bool RAGGED>
__device__ inline void keccak256(const Window& win, int len, int max_len, uint32_t out[8]) {
  const int n_blocks = (max_len + 1 + RATE - 1) / RATE;
  const int final_block = len < 0 ? -1 : len / RATE;  // floor, as the plain version's //
  const int last = final_block < n_blocks - 1 ? final_block : n_blocks - 1;
  const int nread = len < max_len ? len : max_len;  // bytes that come from memory
  const int64_t end = win.start + (nread > 0 ? nread : 0);
  const int64_t w0 = win.start >> 3;  // the aligned word that holds the first byte
  const bool upper = (win.start & 4) != 0;  // line up from the word's upper half
  const uint32_t sh = 8u * (uint32_t)(win.start & 3);
  uint64_t s[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) s[i] = 0ull;
  for (int blk = 0; blk <= last; ++blk) {
    // the block's words, as 32-bit halves, loaded together
    uint32_t h[2 * RATE_LANES + 2];
#pragma unroll
    for (int k = 0; k <= RATE_LANES; ++k) {
      int64_t wi = w0 + RATE_LANES * blk + k;
      uint64_t v = 8 * wi < end ? load_word<RAGGED>(win, wi) : 0ull;
      h[2 * k] = (uint32_t)v;
      h[2 * k + 1] = (uint32_t)(v >> 32);
    }
    const int first = RATE * blk;
#pragma unroll
    for (int w = 0; w < RATE_LANES; ++w) {
      uint32_t a0 = upper ? h[2 * w + 1] : h[2 * w];
      uint32_t a1 = upper ? h[2 * w + 2] : h[2 * w + 1];
      uint32_t a2 = upper ? h[2 * w + 3] : h[2 * w + 2];
      uint64_t lane = ((uint64_t)__funnelshift_r(a1, a2, sh) << 32) | __funnelshift_r(a0, a1, sh);
      int pos = first + 8 * w;  // the lane's first message byte
      lane &= byte_mask(nread - pos);
      int d = len - pos;  // the 0x01 pad byte
      if (d >= 0 && d < 8) lane |= 1ull << (8 * d);
      s[w] ^= lane;
    }
    if (blk == final_block) s[RATE_LANES - 1] ^= 0x80ull << 56;  // the last byte of the block
    f1600(s);
  }
  // hash byte k = byte (k % 8) of lane k / 8; limb i = hash bytes
  // 28-4i .. 31-4i, the first most significant: a half lane, byte-swapped
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = s[3 - i / 2];
    uint32_t half = (i % 2 == 0) ? (uint32_t)(v >> 32) : (uint32_t)v;
    out[i] = __byte_perm(half, 0u, 0x0123);
  }
}

// K2's lane p: the first length[p] bytes of row p of a [n, max_len] byte
// buffer at any address -> out[8p .. 8p + 8) (int64 carriers). The window
// is the whole buffer, so a word that holds the end of one row and the
// start of the next is loaded whole and the other row's bytes shifted or
// masked off; only the buffer's first and last words may straddle its ends.
__device__ inline void hash_row(const uint8_t* data, const int32_t* length, int64_t* out, int p,
                                int n, int max_len) {
  uintptr_t a = reinterpret_cast<uintptr_t>(data);
  int64_t lo = (int64_t)(a & 7u);
  Window w{reinterpret_cast<const uint8_t*>(a - (uintptr_t)lo), lo, lo + (int64_t)n * max_len,
           lo + (int64_t)p * max_len};
  uint32_t h[8];
  keccak256<true>(w, length[p], max_len, h);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * (int64_t)p + i] = (int64_t)h[i];
}

}  // namespace keccak
