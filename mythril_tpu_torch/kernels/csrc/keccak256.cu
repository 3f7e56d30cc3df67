// K2: keccak-256 of per-lane zero-padded messages, one thread per lane.
//
// Replaces the JAX package's ops/keccak.py `keccak256_device` and its
// device permutation `keccak_f1600` (the SHA3 opcode: every solidity
// mapping key; on the port's path only CREATE2, since K10 runs SHA3
// itself). The body lives in keccak.cuh, which K10's SHA3 shares: whole
// 8-byte words a block, the state in registers. The output is the
// big-endian hash value as 8 little-endian 32-bit limbs in the port's
// int64 carrier.
//
// Bound: 24 rounds x ~100 64-bit operations per absorbed block per lane
// against the max_len + 68 bytes a lane moves — the card is bound by
// integer operations, not memory. A lane is one dependent chain of one or
// two permutations at the engine's widths, so a launch is the latency of
// its longest lane. 32 threads a block: on an H100 it beat 64 and 128
// (tools/hash_variants.py, PERF.md), and P = 2048 lanes then spread over
// 64 SMs, one warp each.

#include "keccak.cuh"

constexpr int K2_THREADS = 32;

__global__ void __launch_bounds__(K2_THREADS)
    keccak256_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ length,
                     int64_t* __restrict__ out, int n, int max_len) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) keccak::hash_row(data, length, out, p, n, max_len);
}

extern "C" int keccak256(const uint8_t* data, const int32_t* length, int64_t* out, int n,
                         int max_len, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + K2_THREADS - 1) / K2_THREADS;
  keccak256_kernel<<<blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(data, length, out, n,
                                                                    max_len);
  return (int)cudaGetLastError();
}
