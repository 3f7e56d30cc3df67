// K6: the incremental feasibility sweep, one warp per lane.
//
// Replaces the JAX package's symbolic/propagate.py `propagate_feasibility`
// (the per-node interval + known-bits transfer `_node_domains`, run as a
// lock-step loop over every lane's new tape nodes) and the constraint
// check of `kill_infeasible`. The JAX loop runs max-new-nodes iterations
// for every lane and needs that count on the host; here each lane's warp
// walks its own nodes [max(prop_len, 1), tape_len) and stops, so nothing
// is read back: it writes iv_lo/iv_hi/kb_m/kb_v of each live node in
// place, advances prop_len to tape_len, then checks the lane's live
// constraints against the updated domains and writes its infeasible flag.
// The warp's body and the transfer are in propagate.cuh.
//
// Design: a warp per lane, 8 warps a block (256 blocks at P = 2048 on 132
// SMs). The warp takes the new nodes in windows of 32, one a thread, and
// computes a window in dependency rounds: a round takes every node whose
// operands inside the window are done, so a window costs the depth of its
// dependency chain, not 32 serial transfers. The window's new domains are
// staged in shared memory as u32 limbs (4 KiB a warp) and committed with
// coalesced int64 stores; the constraint slots are split over the warp's
// threads and OR-ed with a ballot.
//
// Bound: bytes. A node reads its row (op, a, b, 8 imm limbs) and its two
// operands' four domains and writes four domains: ~600 bytes in int64
// carriers against a few hundred integer operations. What is left
// serial is a window's dependency chain and the windows of a lane, one
// after another: latency-bound at every size the engine gives it.

#include "propagate.cuh"

namespace {

constexpr int WARPS = 8;  // lanes a block

__global__ void __launch_bounds__(WARPS * 32) sweep_kernel(const k6::Sweep s) {
  __shared__ k6::Stage stage[WARPS];
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + w;
  if (p < s.P) k6::sweep_warp(s, p, threadIdx.x & 31, stage[w]);
}

}  // namespace

extern "C" int propagate_sweep(const int32_t* tape_op, const int32_t* tape_a,
                               const int32_t* tape_b, const int64_t* tape_imm,
                               const int32_t* tape_len, int32_t* prop_len, int64_t* iv_lo,
                               int64_t* iv_hi, int64_t* kb_m, int64_t* kb_v,
                               const int32_t* con_node, const bool* con_sign,
                               const int32_t* con_len, bool* infeasible, int P, int T, int C,
                               void* stream) {
  if (P <= 0) return 0;
  const k6::Sweep s{tape_op, tape_a, tape_b, tape_imm, tape_len, prop_len,
                    {iv_lo, iv_hi, kb_m, kb_v}, con_node, con_sign, con_len, infeasible,
                    P, T, C};
  sweep_kernel<<<(P + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
