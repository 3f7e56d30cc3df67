// K10: one concrete EVM step for every lane of the frontier, one thread
// per lane.
//
// Replaces the JAX package's core/interpreter.py `prologue` (:744),
// `dispatch` (:951) and `epilogue` (:1053), with the 16 class handlers
// (:276-723) and `_set_slot` (:147). The JAX code runs every present
// class's handler over the whole frontier under a lane mask, and the
// port's plain version does the same with ~hundreds of small PyTorch ops
// a step; here each thread runs only its own lane's handler
// (evm_step.cuh), in place on buffers the caller owns.
//
// Four entry points: `evm_prologue` (fetch, INVALID/STACK traps, static
// gas; writes op and run), `evm_dispatch` (the class handler and the
// shared two-port stack writeback, lanes under `skip` left out: the
// symbolic engine claims them), `evm_epilogue` (pc advance, pc_hold,
// n_steps, iprof, OOG) and `evm_superstep`, the three fused for the
// concrete `run`.
//
// Bound: bytes, for the usual step (a lane reads its control fields, its
// operand words and the code byte, and writes a few words); the
// DIV/MOD/EXP/MULMOD/SHA3 lanes are bound by their integer operations.
// A thread walks its lane serially and the lanes of a warp diverge by
// class, so a launch is latency-bound; making it fast (staging, graphs,
// fewer bytes per step) is later work.

#include "evm_step.cuh"

using evm::Frame;

__global__ void evm_prologue_kernel(Frame f) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < f.P) evm::entry_prologue(f, p);
}

__global__ void evm_dispatch_kernel(Frame f) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < f.P) evm::entry_dispatch(f, p);
}

__global__ void evm_epilogue_kernel(Frame f) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < f.P) evm::entry_epilogue(f, p);
}

__global__ void evm_superstep_kernel(Frame f) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < f.P) evm::entry_superstep(f, p);
}

static int launch(void (*kernel)(Frame), const uint64_t* ptrs, const int* dims, void* stream) {
  Frame f = evm::frame_from(ptrs, dims);
  if (f.P <= 0) return 0;
  int threads = 64;
  int blocks = (f.P + threads - 1) / threads;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}

extern "C" int evm_prologue(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_prologue_kernel, ptrs, dims, stream);
}

extern "C" int evm_dispatch(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_dispatch_kernel, ptrs, dims, stream);
}

extern "C" int evm_epilogue(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_epilogue_kernel, ptrs, dims, stream);
}

extern "C" int evm_superstep(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_superstep_kernel, ptrs, dims, stream);
}
