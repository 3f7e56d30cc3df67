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
// gas; writes op, run and old_pc), `evm_dispatch` (the class handler and
// the shared two-port stack writeback, lanes under `skip` left out: the
// symbolic engine claims them), `evm_epilogue` (pc advance, pc_hold,
// n_steps, iprof, OOG) and `evm_superstep`, the three fused for the
// concrete `run`, which also counts the lanes still running into
// `n_running` (zeroed here before the launch), so that `run` reads the
// device only every few supersteps.
//
// Bound: bytes, for the usual step (a lane reads its control fields, its
// operand words and the code byte, and writes a few words); the
// DIV/MOD/EXP/MULMOD/SHA3 lanes are bound by their integer operations.
// A thread walks its lane serially and the lanes of a warp diverge by
// class, so a launch is latency-bound. Its caller owns the fields it
// writes (a loop copies them once), and its pointer array (kernels/
// __init__.py `EvmStep`) is built once per frontier layout; a launch
// re-marshals only the tensors that changed since the last one. What
// bounds a launch now is the host: the Python bind, the ctypes call and
// the launch take ~0.01-0.02 ms of CUDA-event time on an H100, against
// ~0.003-0.01 ms on the device (PERF.md); on divergent batches, the
// slowest lane of a warp.

#include "evm_step.cuh"

using evm::Frame;

// threads per block; `evm_block_threads` changes it for chip_smoke.py's
// sweep. 32: on an H100 (PERF.md's sweep) the fused launch at P = 4096
// took 0.0091 ms at 32, 0.0094 at 64, 0.0106 at 128 and 0.0137 at 256,
// and the split ones at P = 2048 were the same at every size
static int g_threads = 32;

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
  bool alive = p < f.P && evm::entry_superstep(f, p);
  // one atomic per warp: the lanes still running, counted by ballot
  unsigned mask = __ballot_sync(0xffffffffu, alive);
  if ((threadIdx.x & 31) == 0 && mask) atomicAdd(f.n_running, __popc(mask));
}

static int launch(void (*kernel)(Frame), const uint64_t* ptrs, const int* dims, void* stream,
                  bool count) {
  Frame f = evm::frame_from(ptrs, dims);
  cudaStream_t s = (cudaStream_t)stream;
  if (count) {
    cudaError_t e = cudaMemsetAsync(f.n_running, 0, sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (f.P <= 0) return 0;
  int blocks = (f.P + g_threads - 1) / g_threads;
  kernel<<<blocks, g_threads, 0, s>>>(f);
  return (int)cudaGetLastError();
}

extern "C" int evm_prologue(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_prologue_kernel, ptrs, dims, stream, false);
}

extern "C" int evm_dispatch(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_dispatch_kernel, ptrs, dims, stream, false);
}

extern "C" int evm_epilogue(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_epilogue_kernel, ptrs, dims, stream, false);
}

extern "C" int evm_superstep(const uint64_t* ptrs, const int* dims, void* stream) {
  return launch(evm_superstep_kernel, ptrs, dims, stream, true);
}

// -> the previous threads per block; a value outside 32..1024 or not a
// multiple of 32 (the superstep kernel counts whole warps) is refused (-1)
extern "C" int evm_block_threads(int threads) {
  if (threads < 32 || threads > 1024 || threads % 32) return -1;
  int old = g_threads;
  g_threads = threads;
  return old;
}
