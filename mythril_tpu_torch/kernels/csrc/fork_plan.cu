// K7: the whole fork expansion, in place: plan, row copy, fix-ups.
//
// Replaces the JAX package's symbolic/engine.py `plan_fork_map` (the
// packed algorithm, every policy) together with `expand_forks`: the
// gather of every frontier field by the fork map and the fix-ups that
// follow it. JAX gathers a new frontier; here the loop owns its fields
// (symbolic/engine.py `own_loop_fields`) and the expansion writes them in
// place, through a descriptor marshaled once per loop
// (kernels.ForkExpand). One expansion is three launches and a memset:
//
//   1. plan, a block per fork block of B lanes (forks copy only into free
//      lanes of their own block): each lane's packed policy key, a
//      bitonic sort (stages whose partners lie in other warps through
//      shared memory, the others in registers with `__shfl_xor_sync`),
//      warp-ballot scans of the free mask, then per lane the copy mask,
//      the source, the admission slot and the fix-ups' values read from
//      the source (fork_expand.cuh `plan_lane`); each block appends its
//      copy lanes to one list (an atomic on its length);
//   2. copy, a persistent grid that reads the list's length on the
//      device: each copy lane's row of every lane-axis field from its
//      source (the profiler's row is not copied: its counts go to the
//      sidecar and a copy starts at zero). Rows of 512 B and more go by a
//      block per 16 KiB chunk, in 16-byte vectors where the addresses
//      allow, four loads a thread in flight; smaller rows by a thread per
//      (copy, field).
//      Sources are active lanes and copies land in free ones, so no copy
//      reads a row another writes;
//   3. fix-ups, a thread per lane, after the copy: pc, sp, the constraint
//      count and the taken sign, the concretized CALL target, the fork
//      plumbing, the dropped/deferred accounting, the starved JUMPIs' gas
//      and profiler undo, and the bounded-loops table for backward copies.
//
// Bound: bytes. Each copy reads and writes its source's row, 273,616 B at
// the default limits; the plan reads and writes ~74 B a lane. The plan's
// sort is B log^2 B / 2 compare-exchanges in shared memory, microseconds.

#include "fork_expand.cuh"

#include <climits>

using namespace k7;

// elements of a fork block per thread: Bp / threads, Bp <= 8192
constexpr int EMAX = 8;

__global__ void fork_plan_kernel(const Plan q, int Bp, int E) {
  extern __shared__ int32_t smem[];
  int32_t* skey = smem;       // [Bp] packed keys, sorted in place
  int32_t* rank = skey + Bp;  // [B] admission rank per lane
  __shared__ int32_t wsum[32];
  __shared__ int n_req, n_free, round_total, pos0;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5, B = q.B, base = blockIdx.x * B;
  const unsigned full = 0xFFFFFFFFu;
  if (tid == 0) n_req = 0;
  __syncthreads();
  for (int i = tid; i < Bp; i += nt) skey[i] = i < B ? packed_key(q, base, i) : INT_MAX;
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    if (e < E) {
      const int l = e * nt + tid;
      const bool req = l < B && q.fork_req[base + l] && q.active[base + l];
      const unsigned b = __ballot_sync(full, req);
      if (lane == 0 && b) atomicAdd(&n_req, __popc(b));
    }
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int k = 2; k <= Bp; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 1) {
      for (int i = tid; i < Bp; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int32_t a = skey[i], b = skey[ixj];
          if ((a > b) == ((i & k) == 0)) {
            skey[i] = b;
            skey[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < EMAX; ++e) {
      if (e < E) {
        const int i = e * nt + tid;
        int32_t v = skey[i];
        for (int jj = j; jj > 0; jj >>= 1) {
          const int32_t o = __shfl_xor_sync(full, v, jj);
          v = (((i & jj) == 0) == ((i & k) == 0)) ? min(v, o) : max(v, o);
        }
        skey[i] = v;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < B; i += nt) rank[skey[i] % B] = i;
  // exclusive scan of the free mask, E rounds of nt lanes: a ballot per
  // warp, then one warp scans the warps' counts
  int frank[EMAX];
  int run = 0;
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    frank[e] = 0;
    if (e < E) {
      const int l = e * nt + tid;
      const bool fr = l < B && !q.active[base + l];
      const unsigned b = __ballot_sync(full, fr);
      if (lane == 0) wsum[warp] = __popc(b);
      __syncthreads();
      if (warp == 0) {
        const int v = lane < nwarps ? wsum[lane] : 0;
        int x = v;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(full, x, d);
          if (lane >= d) x += y;
        }
        if (lane < nwarps) wsum[lane] = x - v;
        if (lane == 31) round_total = x;
      }
      __syncthreads();
      frank[e] = run + wsum[warp] + __popc(b & ((1u << lane) - 1u));
      run += round_total;
      __syncthreads();
    }
  }
  if (tid == 0) n_free = run;
  __syncthreads();
  const int n_adm = q.policy == POL_BEAM ? min(n_free, max(1, B / 4)) : n_free;
  const int n_admit = min(n_adm, n_req);
  if (tid == 0) pos0 = n_admit ? atomicAdd(q.count, n_admit) : 0;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EMAX; ++e) {
    const int l = e * nt + tid;
    if (e < E && l < B) finish_lane(q, base, l, frank[e], rank[l], skey, n_adm, n_admit, pos0);
  }
}

__global__ void fork_copy_kernel(const __grid_constant__ CopyTable t) {
  const int n = *t.count;
  const int64_t n_big = (int64_t)n * t.n_chunks;
  for (int64_t w = blockIdx.x; w < n_big; w += gridDim.x) copy_big(t, w, threadIdx.x, blockDim.x);
  if (t.op_hist) {
    for (int64_t w = blockIdx.x; w < n; w += gridDim.x)
      copy_hist(t, w, threadIdx.x, blockDim.x);
  }
  const int64_t n_small = (int64_t)n * (t.n_fields - t.n_big);
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; w < n_small;
       w += (int64_t)gridDim.x * blockDim.x)
    copy_small(t, w);
}

__global__ void fork_fix_kernel(const Fix x) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < x.P) fix_lane(x, p);
}

// the copy kernel's persistent grid: four blocks an SM
constexpr int COPY_BLOCKS = 528, COPY_THREADS = 256, FIX_THREADS = 256;

extern "C" int fork_expand(const uint64_t* ptrs, const int32_t* ints, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const int P = ints[I_P], B = ints[I_B];
  if (P <= 0) return 0;
  if (B <= 0 || P % B || ints[I_N_FIELDS] > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  int Bp = 32;
  while (Bp < B) Bp <<= 1;
  const int threads = Bp < 1024 ? Bp : 1024, E = Bp / threads;
  if (E > EMAX) return (int)cudaErrorInvalidValue;
  const int smem = (Bp + B) * (int)sizeof(int32_t);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fork_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaMemsetAsync((void*)ptrs[X_COUNT], 0, sizeof(int32_t), stream);
  if (e != cudaSuccess) return (int)e;
  fork_plan_kernel<<<P / B, threads, smem, stream>>>(make_plan(ptrs, ints), Bp, E);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fork_copy_kernel<<<COPY_BLOCKS, COPY_THREADS, 0, stream>>>(make_copy(ptrs, ints));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fork_fix_kernel<<<(P + FIX_THREADS - 1) / FIX_THREADS, FIX_THREADS, 0, stream>>>(
      make_fix(ptrs, ints));
  return (int)cudaGetLastError();
}
