// K7: policy-keyed fork planning, one CUDA thread block per fork block.
//
// Replaces the JAX package's symbolic/engine.py `plan_fork_map` (the
// packed algorithm, every policy) and the per-lane fix-ups of
// `expand_forks` that follow its frontier gather. A fork block is B
// lanes (fork_block = 0 means one block of P); forks only copy into free
// lanes of their own block, so blocks are independent and each runs in
// one thread block with its B keys in shared memory:
//
//   1. every lane's policy key (symbolic/engine.py `expand_forks`): 0 for
//      fifo, depth for shallow/beam, C - depth for deep, the shared 32-bit
//      multiplicative hash of (lane, target, depth) for random/weighted,
//      the visited bit of the taken target for coverage; packed as
//      min(key, KSENT - 1) * B + lane for requests, KSENT * B + lane else;
//   2. a bitonic sort of the packed keys (padded to a power of two); the
//      sorted position of a lane's key is its admission rank;
//   3. block scans of the free mask (each free slot's free rank) and
//      counts of requests and free slots; beam caps admissions at B / 4;
//   4. per lane: the copy mask, its source (the request whose rank equals
//      the slot's free rank), the admission sentinel (slot = P when
//      starved), and the fix-ups `expand_forks` applies to the gathered
//      frontier, read from the source lane: pc, sp, the constraint count
//      and the index of the sign to flip, the fork_cslot stack write, the
//      call-enumeration counter, dropped/deferred accounting and the
//      backward-copy flag.
//
// The gather of every frontier field by `src` stays in PyTorch (a copy).
//
// Bound: the sort. B log^2 B / 2 compare-exchanges per block in shared
// memory against ~50 bytes read and ~50 written per lane; at P = 2048 a
// launch is a few microseconds of work, so it is latency-bound.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

enum { POL_FIFO = 0, POL_SHALLOW, POL_DEEP, POL_RANDOM, POL_WEIGHTED, POL_COVERAGE, POL_BEAM };
// rows of the int32 and bool outputs
enum { O_SRC = 0, O_SLOT, O_PC, O_SP, O_CON_LEN, O_LAST, O_CIDX, O_CALL_ENUM, O_DROPPED, N_OI };
enum { B_COPY = 0, B_FORK_REQ, B_STARVED, B_BACK, N_OB };

__device__ inline int policy_key(int policy, int p, int depth, int dest, int cid, int C,
                                 const bool* visited, int Vc, int Vm) {
  switch (policy) {
    case POL_SHALLOW:
    case POL_BEAM:
      return depth;
    case POL_DEEP:
      return C - depth;
    case POL_RANDOM:
    case POL_WEIGHTED: {
      uint32_t h = (uint32_t)p * 2654435761u + (uint32_t)dest * 40503u + (uint32_t)depth * 131u;
      h = (h >> 16) ^ h;
      if (policy == POL_RANDOM) return (int)(h & 0x7FFFu);
      return (int)((h & 1023u) * (uint32_t)(depth + 1) % 65536u);
    }
    case POL_COVERAGE: {
      if (Vc <= 0) return 0;
      int r = min(max(cid, 0), Vc - 1), c = min(max(dest, 0), Vm - 1);
      return visited[(int64_t)r * Vm + c] ? 1 : 0;
    }
    default:
      return 0;
  }
}

__global__ void fork_plan_kernel(const bool* __restrict__ active,
                                 const bool* __restrict__ fork_req,
                                 const int32_t* __restrict__ con_len,
                                 const int32_t* __restrict__ fork_dest,
                                 const int32_t* __restrict__ contract_id,
                                 const int32_t* __restrict__ pc,
                                 const int32_t* __restrict__ sp,
                                 const int32_t* __restrict__ dropped,
                                 const int32_t* __restrict__ fork_cslot,
                                 const int32_t* __restrict__ call_enum,
                                 const bool* __restrict__ visited, int32_t* __restrict__ out_i,
                                 bool* __restrict__ out_b, int P, int B, int Bp, int policy,
                                 int C, int S, int Vc, int Vm, int defer, int ksent) {
  extern __shared__ int32_t smem[];
  int32_t* skey = smem;            // [Bp] packed keys, sorted in place
  int32_t* rank = skey + Bp;       // [B] admission rank per lane
  int32_t* frank = rank + B;       // [B] exclusive prefix of the free mask
  int32_t* sums = frank + B;       // [blockDim.x] per-thread scan totals
  __shared__ int n_req, n_free;
  const int g = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int base = g * B;
  if (tid == 0) {
    n_req = 0;
    n_free = 0;
  }
  __syncthreads();
  int my_req = 0, my_free = 0;
  for (int l = tid; l < Bp; l += nt) {
    if (l >= B) {
      skey[l] = INT_MAX;
      continue;
    }
    int p = base + l;
    bool req = fork_req[p] && active[p];
    int key = policy_key(policy, p, con_len[p], fork_dest[p], contract_id[p], C, visited, Vc,
                         Vm);
    skey[l] = (req ? min(key, ksent - 1) : ksent) * B + l;
    my_req += req;
    my_free += !active[p];
  }
  atomicAdd(&n_req, my_req);
  atomicAdd(&n_free, my_free);
  __syncthreads();
  // bitonic sort, ascending
  for (int k = 2; k <= Bp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < Bp; i += nt) {
        int ixj = i ^ j;
        if (ixj > i) {
          int32_t a = skey[i], b = skey[ixj];
          bool up = (i & k) == 0;
          if ((a > b) == up) {
            skey[i] = b;
            skey[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < B; i += nt) rank[skey[i] % B] = i;
  // exclusive scan of the free mask: a contiguous chunk per thread, then
  // the per-thread totals
  int chunk = (B + nt - 1) / nt;
  int lo = tid * chunk, hi = min(lo + chunk, B), run = 0;
  for (int l = lo; l < hi; ++l) {
    frank[l] = run;
    run += !active[base + l];
  }
  sums[tid] = run;
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int t = 0; t < nt; ++t) {
      int v = sums[t];
      sums[t] = acc;
      acc += v;
    }
  }
  __syncthreads();
  for (int l = lo; l < hi; ++l) frank[l] += sums[tid];
  __syncthreads();
  const int n_adm = policy == POL_BEAM ? min(n_free, max(1, B / 4)) : n_free;
  const int n_admit = min(n_adm, n_req);
  for (int l = tid; l < B; l += nt) {
    int p = base + l;
    bool act = active[p];
    bool req = fork_req[p] && act;
    bool is_copy = !act && frank[l] < n_admit;
    int s = is_copy ? base + skey[min(max(frank[l], 0), B - 1)] % B : p;
    int slot = (req && rank[l] < n_adm) ? 0 : P;
    bool starved = req && slot == P;
    int cs = fork_cslot[s];
    bool is_cf = cs >= 0;
    int pc_s = pc[s], dest_s = fork_dest[s];
    int pc_new = pc_s, sp_new = sp[s], cl_new = con_len[s];
    int ce_new = is_copy ? 0 : call_enum[s];
    if (is_copy) pc_new = dest_s;
    if (defer && starved) {
      if (!is_cf) {
        pc_new = pc_s - 1;
        sp_new += 2;
      }
      cl_new -= 1;
      if (is_cf) ce_new -= 1;
    }
    const int64_t P64 = P;
    out_i[O_SRC * P64 + p] = s;
    out_i[O_SLOT * P64 + p] = slot;
    out_i[O_PC * P64 + p] = pc_new;
    out_i[O_SP * P64 + p] = sp_new;
    out_i[O_CON_LEN * P64 + p] = cl_new;
    out_i[O_LAST * P64 + p] = is_copy ? con_len[s] - 1 : -1;
    out_i[O_CIDX * P64 + p] = (is_copy && cs >= 0 && cs < S) ? cs : S;
    out_i[O_CALL_ENUM * P64 + p] = ce_new;
    out_i[O_DROPPED * P64 + p] = (is_copy ? 0 : dropped[s]) + ((!defer && starved) ? 1 : 0);
    out_b[B_COPY * P64 + p] = is_copy;
    out_b[B_FORK_REQ * P64 + p] = defer && starved;
    out_b[B_STARVED * P64 + p] = starved;
    out_b[B_BACK * P64 + p] = is_copy && dest_s < pc_s;
  }
}

extern "C" int fork_plan(const bool* active, const bool* fork_req, const int32_t* con_len,
                         const int32_t* fork_dest, const int32_t* contract_id,
                         const int32_t* pc, const int32_t* sp, const int32_t* dropped,
                         const int32_t* fork_cslot, const int32_t* call_enum,
                         const bool* visited, int32_t* out_i, bool* out_b, int P, int B,
                         int policy, int C, int S, int Vc, int Vm, int defer, void* stream) {
  if (P <= 0) return 0;
  int Bp = 1;
  while (Bp < B) Bp <<= 1;
  int threads = Bp < 1024 ? Bp : 1024;
  int smem = (Bp + 2 * B + threads) * (int)sizeof(int32_t);
  // the packed-key sentinel: the key budget that keeps key * B + lane in
  // int32 (JAX plan_fork_map's KSENT)
  long long budget = (2147483647LL - (B - 1)) / B;
  int ksent = budget < (1 << 16) ? (int)budget : (1 << 16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fork_plan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  fork_plan_kernel<<<P / B, threads, smem, (cudaStream_t)stream>>>(
      active, fork_req, con_len, fork_dest, contract_id, pc, sp, dropped, fork_cslot,
      call_enum, visited, out_i, out_b, P, B, Bp, policy, C, S, Vc, Vm, defer, ksent);
  return (int)cudaGetLastError();
}
