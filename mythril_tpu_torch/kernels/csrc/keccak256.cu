// K2: keccak-256 of per-lane zero-padded messages, one thread per lane.
//
// Replaces the JAX package's ops/keccak.py `keccak256_device` and its
// device permutation `keccak_f1600` (the SHA3 opcode: every solidity
// mapping key). The permutation and the padding live in keccak.cuh, which
// K10's SHA3 shares. The output is the big-endian hash value as 8
// little-endian 32-bit limbs in the port's int64 carrier.
//
// Bound: 24 rounds x ~100 64-bit operations per absorbed block per lane
// against the max_len + 68 bytes a lane moves — the card is bound by
// integer operations, not memory.

#include "keccak.cuh"

struct RowBytes {
  const uint8_t* msg;
  __device__ uint32_t operator()(int pos) const { return msg[pos]; }
};

__global__ void keccak256_kernel(const uint8_t* __restrict__ data,
                                 const int32_t* __restrict__ length,
                                 int64_t* __restrict__ out, int n, int max_len) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  uint32_t h[8];
  keccak::keccak256(RowBytes{data + (size_t)p * max_len}, length[p], max_len, h);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[8 * p + i] = (int64_t)h[i];
}

extern "C" int keccak256(const uint8_t* data, const int32_t* length,
                         int64_t* out, int n, int max_len, void* stream) {
  if (n <= 0) return 0;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  keccak256_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(data, length, out, n, max_len);
  return (int)cudaGetLastError();
}
