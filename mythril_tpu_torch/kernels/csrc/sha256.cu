// K4: SHA-256 of per-lane byte buffers, one thread per lane.
//
// Replaces the JAX package's ops/sha256.py `sha256_device` (precompile
// 0x2). A lane's message is data[p, 0:ln[p]] of a [P, N] uint8 buffer
// (N = min(memory, 448) on the engine's path, so at most 8 blocks). The
// thread builds each 64-byte block on the fly from the message bytes,
// the 0x80 pad byte at ln and the 64-bit big-endian bit length in the
// last 8 bytes of the lane's own final block (ops/sha256.py's padding),
// keeps the 8-word state and a 16-word rolling schedule in registers,
// and stops after its own last block (the JAX loop runs every lane to
// the widest and masks; the result is the same). Output limbs are the
// digest words in reverse order (limb 0 = last digest word), int64
// carriers.
//
// Bound: ~2,400 32-bit operations per 64-byte block against the 64
// message bytes it reads: 37.5 operations per byte, against the card's
// ~20 (67 TOP/s over 3.35 TB/s), so operations. One dependent chain per
// thread; at the engine's widths (a handful of lanes per superstep) a
// launch is all latency.

#include <cstdint>
#include <cuda_runtime.h>

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
  return (x >> n) | (x << (32 - n));
}

// byte k of the padded message of a lane
__device__ __forceinline__ uint32_t msg_byte(const uint8_t* row, int64_t k, int64_t ln,
                                             int64_t total, int n) {
  if (k < ln) return k < n ? row[k] : 0u;
  if (k == ln) return 0x80u;
  int64_t lp = k - (total - 8);
  if (lp >= 0 && lp < 8) return (uint32_t)(((uint64_t)ln * 8u) >> ((7 - lp) * 8)) & 0xFFu;
  return 0u;
}

__global__ void sha256_kernel(const uint8_t* __restrict__ data,
                              const int32_t* __restrict__ len,
                              int64_t* __restrict__ out, int P, int N) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const uint8_t* row = data + (int64_t)p * N;
  int64_t ln = len[p];
  int64_t n_blocks = (ln + 9 + 63) / 64;
  int64_t total = n_blocks * 64;
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
#pragma unroll 1
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      int64_t k = blk * 64 + 4 * t;
      w[t] = (msg_byte(row, k, ln, total, N) << 24) | (msg_byte(row, k + 1, ln, total, N) << 16) |
             (msg_byte(row, k + 2, ln, total, N) << 8) | msg_byte(row, k + 3, ln, total, N);
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
      uint32_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * (int64_t)p + i] = (int64_t)h[7 - i];
}

extern "C" int sha256(const uint8_t* data, const int32_t* len, int64_t* out, int P, int N,
                      void* stream) {
  if (P <= 0) return 0;
  int threads = 128;
  int blocks = (P + threads - 1) / threads;
  sha256_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(data, len, out, P, N);
  return (int)cudaGetLastError();
}
