// K7's per-lane bodies: the plan's per-lane outputs, the row copy and the
// fix-ups of a fork expansion, and the launch descriptor's layout.
//
// fork_plan.cu launches them; the CPU tests build this header as host C++
// (tests/torch_port_warphost.py) and drive the same bodies through the
// same descriptor (kernels.ForkExpand), with the plan's sort and scans,
// which need a whole block, done serially there.
//
// The descriptor is two arrays the wrapper marshals once per loop and
// refreshes only where a field's tensor changed: `ptrs` (N_EXTRA extra
// pointers, then one per lane-axis field of the frontier, the N_NAMED
// fields the plan and the fix-ups name first) and `ints` (N_INTS scalars,
// then each field's row bytes).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace k7 {

enum { POL_FIFO = 0, POL_SHALLOW, POL_DEEP, POL_RANDOM, POL_WEIGHTED, POL_COVERAGE, POL_BEAM };
// rows of the plan's int32 and bool outputs (symbolic/engine.py O_* / B_*)
enum { O_SRC = 0, O_SLOT, O_PC, O_SP, O_CON_LEN, O_LAST, O_CIDX, O_CALL_ENUM, O_DROPPED, N_OI };
enum { B_COPY = 0, B_FORK_REQ, B_STARVED, B_BACK, N_OB };
// the named fields, in the order of kernels.FORK_NAMED
enum { F_ACTIVE = 0, F_FORK_REQ, F_CON_LEN, F_FORK_DEST, F_CONTRACT_ID, F_PC, F_SP, F_DROPPED,
       F_FORK_CSLOT, F_CALL_ENUM, F_FORK_CVAL, F_STACK, F_STACK_SYM, F_CON_SIGN, F_GAS_MIN,
       F_GAS_MAX, F_ERROR, F_ERR_CODE, F_LB_KEY, F_LB_CNT, F_LB_LEN, N_NAMED };
// the pointers before the fields: the profiler's rows and sidecar (0 when
// off), the run total of dropped forks, the plan's outputs, the list of
// copy lanes and its length, the coverage bitmap (0 when none)
enum { X_OP_HIST = 0, X_OP_RESID, X_DROPPED_TOTAL, X_OUT_I, X_OUT_B, X_LIST, X_COUNT, X_VISITED,
       N_EXTRA };
// the scalars before the row bytes
enum { I_P = 0, I_B, I_POLICY, I_C, I_S, I_LBS, I_VC, I_VM, I_DEFER, I_LOOP_BOUND, I_TRAP,
       I_N_FIELDS, N_INTS };
constexpr int MAX_FIELDS = 192;
// rows of at least BIG bytes are copied by a block per CHUNK bytes, the
// others by a thread per (copy, field)
constexpr int BIG = 512;
constexpr int CHUNK = 16384;
constexpr int64_t HIST = 256;

// --- the plan ---------------------------------------------------------------

struct Plan {
  const bool *active, *fork_req, *visited;
  const int32_t *con_len, *fork_dest, *contract_id, *pc, *sp, *dropped, *fork_cslot,
      *call_enum;
  int32_t *out_i, *list, *count;
  bool* out_b;
  int P, B, policy, C, S, Vc, Vm, defer, ksent;
};

__host__ inline Plan make_plan(const uint64_t* ptrs, const int32_t* ints) {
  const uint64_t* f = ptrs + N_EXTRA;
  Plan q;
  q.active = (const bool*)f[F_ACTIVE];
  q.fork_req = (const bool*)f[F_FORK_REQ];
  q.visited = (const bool*)ptrs[X_VISITED];
  q.con_len = (const int32_t*)f[F_CON_LEN];
  q.fork_dest = (const int32_t*)f[F_FORK_DEST];
  q.contract_id = (const int32_t*)f[F_CONTRACT_ID];
  q.pc = (const int32_t*)f[F_PC];
  q.sp = (const int32_t*)f[F_SP];
  q.dropped = (const int32_t*)f[F_DROPPED];
  q.fork_cslot = (const int32_t*)f[F_FORK_CSLOT];
  q.call_enum = (const int32_t*)f[F_CALL_ENUM];
  q.out_i = (int32_t*)ptrs[X_OUT_I];
  q.out_b = (bool*)ptrs[X_OUT_B];
  q.list = (int32_t*)ptrs[X_LIST];
  q.count = (int32_t*)ptrs[X_COUNT];
  q.P = ints[I_P];
  q.B = ints[I_B];
  q.policy = ints[I_POLICY];
  q.C = ints[I_C];
  q.S = ints[I_S];
  q.Vc = q.visited ? ints[I_VC] : 0;
  q.Vm = ints[I_VM];
  q.defer = ints[I_DEFER];
  // the packed-key sentinel: the key budget that keeps key * B + lane in
  // int32 (JAX plan_fork_map's KSENT)
  long long budget = (2147483647LL - (q.B - 1)) / q.B;
  q.ksent = budget < (1 << 16) ? (int)budget : (1 << 16);
  return q;
}

// a lane's admission key (symbolic/engine.py `_policy_key`); lower admits first
__device__ inline int policy_key(const Plan& q, int p) {
  const int depth = q.con_len[p], dest = q.fork_dest[p];
  switch (q.policy) {
    case POL_SHALLOW:
    case POL_BEAM:
      return depth;
    case POL_DEEP:
      return q.C - depth;
    case POL_RANDOM:
    case POL_WEIGHTED: {
      uint32_t h = (uint32_t)p * 2654435761u + (uint32_t)dest * 40503u + (uint32_t)depth * 131u;
      h = (h >> 16) ^ h;
      if (q.policy == POL_RANDOM) return (int)(h & 0x7FFFu);
      return (int)((h & 1023u) * (uint32_t)(depth + 1) % 65536u);
    }
    case POL_COVERAGE: {
      if (q.Vc <= 0) return 0;
      int r = min(max(q.contract_id[p], 0), q.Vc - 1), c = min(max(dest, 0), q.Vm - 1);
      return q.visited[(int64_t)r * q.Vm + c] ? 1 : 0;
    }
    default:
      return 0;
  }
}

// the packed sort key of lane l of a block starting at lane `base`
__device__ inline int32_t packed_key(const Plan& q, int base, int l) {
  const int p = base + l;
  const bool req = q.fork_req[p] && q.active[p];
  return (req ? min(policy_key(q, p), q.ksent - 1) : q.ksent) * q.B + l;
}

// lane p's outputs once its block has decided: whether it requests a fork
// (`req`), is a copy slot, its source lane `s` and its admission slot
// (0 admitted, P starved); the fix-ups read from the source lane
__device__ inline void plan_lane(const Plan& q, int p, bool req, bool is_copy, int s, int slot) {
  const int64_t P = q.P;
  const bool starved = req && slot == q.P;
  const int cs = q.fork_cslot[s];
  const bool is_cf = cs >= 0;
  const int pc_s = q.pc[s], dest_s = q.fork_dest[s];
  int pc_new = is_copy ? dest_s : pc_s, sp_new = q.sp[s], cl_new = q.con_len[s];
  int ce_new = is_copy ? 0 : q.call_enum[s];
  if (q.defer && starved) {
    if (!is_cf) {
      pc_new = pc_s - 1;
      sp_new += 2;
    }
    cl_new -= 1;
    if (is_cf) ce_new -= 1;
  }
  q.out_i[O_SRC * P + p] = s;
  q.out_i[O_SLOT * P + p] = slot;
  q.out_i[O_PC * P + p] = pc_new;
  q.out_i[O_SP * P + p] = sp_new;
  q.out_i[O_CON_LEN * P + p] = cl_new;
  q.out_i[O_LAST * P + p] = is_copy ? q.con_len[s] - 1 : -1;
  q.out_i[O_CIDX * P + p] = (is_copy && cs >= 0 && cs < q.S) ? cs : q.S;
  q.out_i[O_CALL_ENUM * P + p] = ce_new;
  q.out_i[O_DROPPED * P + p] = (is_copy ? 0 : q.dropped[s]) + ((!q.defer && starved) ? 1 : 0);
  q.out_b[B_COPY * P + p] = is_copy;
  q.out_b[B_FORK_REQ * P + p] = q.defer && starved;
  q.out_b[B_STARVED * P + p] = starved;
  q.out_b[B_BACK * P + p] = is_copy && dest_s < pc_s;
}

// lane l of the block at `base`, once the block's packed keys are sorted
// (`skey`): its free rank among the block's free lanes, its admission
// rank, the block's admission cap and count, and where the block's copy
// lanes start in the list
__device__ inline void finish_lane(const Plan& q, int base, int l, int frank, int rank,
                                   const int32_t* skey, int n_adm, int n_admit, int pos0) {
  const int p = base + l;
  const bool act = q.active[p];
  const bool req = q.fork_req[p] && act;
  const bool is_copy = !act && frank < n_admit;
  const int s = is_copy ? base + skey[min(max(frank, 0), q.B - 1)] % q.B : p;
  plan_lane(q, p, req, is_copy, s, (req && rank < n_adm) ? 0 : q.P);
  if (is_copy) q.list[pos0 + frank] = p;
}

// --- the row copy -----------------------------------------------------------

// Every lane-axis field's row of each copy lane d, from its source src[d].
// Sources are active lanes and copies land only in free ones, so no copy
// reads a row another copy writes. Big fields come first. A copy's
// profiler row is not copied: its counts go to the sidecar and it is
// zeroed.
struct CopyTable {
  const int32_t *list, *count, *src;
  int32_t *op_hist, *op_resid;
  int n_fields, n_big, n_chunks;
  uint64_t ptr[MAX_FIELDS];
  int32_t bytes[MAX_FIELDS];
  int32_t chunk0[MAX_FIELDS];  // a big field's first chunk
};

__host__ inline CopyTable make_copy(const uint64_t* ptrs, const int32_t* ints) {
  CopyTable t;
  t.list = (const int32_t*)ptrs[X_LIST];
  t.count = (const int32_t*)ptrs[X_COUNT];
  t.src = (const int32_t*)ptrs[X_OUT_I] + (int64_t)O_SRC * ints[I_P];
  t.op_hist = (int32_t*)ptrs[X_OP_HIST];
  t.op_resid = (int32_t*)ptrs[X_OP_RESID];
  const int n = ints[I_N_FIELDS];
  t.n_fields = 0;
  t.n_chunks = 0;
  for (int big = 1; big >= 0; --big) {
    for (int f = 0; f < n; ++f) {
      const int32_t b = ints[N_INTS + f];
      if ((b >= BIG) != (big == 1)) continue;
      t.ptr[t.n_fields] = ptrs[N_EXTRA + f];
      t.bytes[t.n_fields] = b;
      if (big) {
        t.chunk0[t.n_fields] = t.n_chunks;
        t.n_chunks += (b + CHUNK - 1) / CHUNK;
      } else {
        t.chunk0[t.n_fields] = 0;
      }
      ++t.n_fields;
    }
    if (big) t.n_big = t.n_fields;
  }
  return t;
}

struct alignas(16) V16 {
  uint64_t a, b;
};

// four loads in flight before their stores
template <class V>
__device__ inline void copy_as(char* d, const char* s, int64_t len, int t, int nt) {
  V* dv = (V*)d;
  const V* sv = (const V*)s;
  const int64_t n = len / (int64_t)sizeof(V);
  int64_t i = t;
  for (; i + 3 * (int64_t)nt < n; i += 4 * (int64_t)nt) {
    const V a = sv[i], b = sv[i + nt], c = sv[i + 2 * nt], e = sv[i + 3 * nt];
    dv[i] = a;
    dv[i + nt] = b;
    dv[i + 2 * nt] = c;
    dv[i + 3 * nt] = e;
  }
  for (; i < n; i += nt) dv[i] = sv[i];
}

// len bytes from s to d by threads t of nt, at the widest width the
// addresses and the length allow
__device__ inline void copy_span(char* d, const char* s, int64_t len, int t, int nt) {
  const uint64_t a = (uint64_t)d | (uint64_t)s | (uint64_t)len;
  if (!(a & 15)) {
    copy_as<V16>(d, s, len, t, nt);
  } else if (!(a & 7)) {
    copy_as<uint64_t>(d, s, len, t, nt);
  } else if (!(a & 3)) {
    copy_as<uint32_t>(d, s, len, t, nt);
  } else {
    copy_as<uint8_t>(d, s, len, t, nt);
  }
}

// big-row item w (copy w / n_chunks, chunk w % n_chunks) by threads t of nt
__device__ inline void copy_big(const CopyTable& tb, int64_t w, int t, int nt) {
  const int c = (int)(w / tb.n_chunks), k = (int)(w % tb.n_chunks);
  int f = 0;
  while (f + 1 < tb.n_big && tb.chunk0[f + 1] <= k) ++f;
  const int d = tb.list[c], s = tb.src[d];
  const int64_t rb = tb.bytes[f], off = (int64_t)(k - tb.chunk0[f]) * CHUNK;
  const int64_t len = rb - off < CHUNK ? rb - off : CHUNK;
  char* base = (char*)tb.ptr[f];
  copy_span(base + d * rb + off, base + s * rb + off, len, t, nt);
}

// copy w's profiler row into the sidecar, zeroed, by threads t of nt
__device__ inline void copy_hist(const CopyTable& tb, int64_t w, int t, int nt) {
  int32_t* row = tb.op_hist + (int64_t)tb.list[w] * HIST;
  for (int k = t; k < HIST; k += nt) {
    if (row[k]) atomicAdd(tb.op_resid + k, row[k]);
    row[k] = 0;
  }
}

// small-row item w (copy w / n_small, field n_big + w % n_small), one thread
__device__ inline void copy_small(const CopyTable& tb, int64_t w) {
  const int ns = tb.n_fields - tb.n_big;
  const int c = (int)(w / ns), f = tb.n_big + (int)(w % ns);
  const int d = tb.list[c], s = tb.src[d];
  const int64_t rb = tb.bytes[f];
  char* base = (char*)tb.ptr[f];
  copy_span(base + d * rb, base + s * rb, rb, 0, 1);
}

// --- the fix-ups ------------------------------------------------------------

struct Fix {
  bool *active, *fork_req, *con_sign, *error;
  int32_t *con_len, *pc, *sp, *dropped, *fork_cslot, *call_enum, *stack_sym, *err_code, *lb_cnt,
      *lb_len, *op_hist, *dropped_total;
  const int32_t *fork_dest, *contract_id, *out_i;
  const bool* out_b;
  int64_t *fork_cval, *stack, *gas_min, *gas_max, *lb_key;
  int P, C, S, LBS, defer, loop_bound, trap;
};

__host__ inline Fix make_fix(const uint64_t* ptrs, const int32_t* ints) {
  const uint64_t* f = ptrs + N_EXTRA;
  Fix x;
  x.active = (bool*)f[F_ACTIVE];
  x.fork_req = (bool*)f[F_FORK_REQ];
  x.con_sign = (bool*)f[F_CON_SIGN];
  x.error = (bool*)f[F_ERROR];
  x.con_len = (int32_t*)f[F_CON_LEN];
  x.pc = (int32_t*)f[F_PC];
  x.sp = (int32_t*)f[F_SP];
  x.dropped = (int32_t*)f[F_DROPPED];
  x.fork_cslot = (int32_t*)f[F_FORK_CSLOT];
  x.call_enum = (int32_t*)f[F_CALL_ENUM];
  x.stack_sym = (int32_t*)f[F_STACK_SYM];
  x.err_code = (int32_t*)f[F_ERR_CODE];
  x.lb_cnt = (int32_t*)f[F_LB_CNT];
  x.lb_len = (int32_t*)f[F_LB_LEN];
  x.op_hist = (int32_t*)ptrs[X_OP_HIST];
  x.dropped_total = (int32_t*)ptrs[X_DROPPED_TOTAL];
  x.fork_dest = (const int32_t*)f[F_FORK_DEST];
  x.contract_id = (const int32_t*)f[F_CONTRACT_ID];
  x.out_i = (const int32_t*)ptrs[X_OUT_I];
  x.out_b = (const bool*)ptrs[X_OUT_B];
  x.fork_cval = (int64_t*)f[F_FORK_CVAL];
  x.stack = (int64_t*)f[F_STACK];
  x.gas_min = (int64_t*)f[F_GAS_MIN];
  x.gas_max = (int64_t*)f[F_GAS_MAX];
  x.lb_key = (int64_t*)f[F_LB_KEY];
  x.P = ints[I_P];
  x.C = ints[I_C];
  x.S = ints[I_S];
  x.LBS = ints[I_LBS];
  x.defer = ints[I_DEFER];
  x.loop_bound = ints[I_LOOP_BOUND];
  x.trap = ints[I_TRAP];
  return x;
}

// symbolic/engine.py `_note_backjump` for one backward copy: count the
// taken jump (contract, target, source pc) in the lane's table, and
// retire the lane past loop_bound visits
__device__ inline void note_backjump(const Fix& x, int p, int64_t src_pc) {
  const int L = x.LBS;
  int64_t* key_row = x.lb_key + (int64_t)p * L;
  int32_t* cnt_row = x.lb_cnt + (int64_t)p * L;
  const int64_t key = ((int64_t)x.contract_id[p] * 32768 + x.fork_dest[p]) * 32768 + src_pc;
  const int len = x.lb_len[p];
  int hit_slot = -1, cold = 0;
  for (int j = 0; j < L; ++j) {
    if (hit_slot < 0 && j < len && key_row[j] == key) hit_slot = j;
    if (cnt_row[j] < cnt_row[cold]) cold = j;
  }
  const bool hit = hit_slot >= 0, has_free = len < L;
  const int slot = hit ? hit_slot : has_free ? min(len, L - 1) : cold;
  const int cnt = hit ? cnt_row[slot] + 1 : 1;
  key_row[slot] = key;
  cnt_row[slot] = cnt;
  if (!hit && has_free) x.lb_len[p] = len + 1;
  if (cnt > x.loop_bound) {
    x.error[p] = true;
    if (x.err_code[p] == 0) x.err_code[p] = x.trap;
  }
}

// lane p's fix-ups, after the row copy (a copy's profiler row is zeroed
// there): what they read of the lane's own (copied) row is read before
// they write it
__device__ inline void fix_lane(const Fix& x, int p) {
  const int64_t P = x.P;
  const bool is_copy = x.out_b[B_COPY * P + p], starved = x.out_b[B_STARVED * P + p];
  const int cslot = x.fork_cslot[p], pc_old = x.pc[p];
  // a symbolic-callee copy re-executes its CALL with the target slot
  // concretized to the candidate
  const int cidx = x.out_i[O_CIDX * P + p];
  if (cidx >= 0 && cidx < x.S) {
    const int64_t at = (int64_t)p * x.S + cidx;
    for (int k = 0; k < 8; ++k) x.stack[at * 8 + k] = x.fork_cval[(int64_t)p * 8 + k];
    x.stack_sym[at] = 0;
  }
  // the copy takes the branch: its last sign flips to "taken"
  const int last = x.out_i[O_LAST * P + p];
  if (last >= 0 && last < x.C) x.con_sign[(int64_t)p * x.C + last] = true;
  if (x.defer && starved && cslot < 0) {
    // the retried JUMPI re-pays its static charge (10 = G_HIGH) and, with
    // the profiler, re-counts once
    x.gas_min[p] -= 10;
    x.gas_max[p] -= 10;
    if (x.op_hist) x.op_hist[p * HIST + 0x57] -= 1;
  }
  x.pc[p] = x.out_i[O_PC * P + p];
  x.sp[p] = x.out_i[O_SP * P + p];
  x.con_len[p] = x.out_i[O_CON_LEN * P + p];
  x.call_enum[p] = x.out_i[O_CALL_ENUM * P + p];
  x.dropped[p] = x.out_i[O_DROPPED * P + p];
  x.active[p] = x.active[p] || is_copy;
  x.fork_req[p] = x.out_b[B_FORK_REQ * P + p];
  x.fork_cslot[p] = -1;
  for (int k = 0; k < 8; ++k) x.fork_cval[(int64_t)p * 8 + k] = 0;
  if (!x.defer && starved) atomicAdd(x.dropped_total, 1);
  if (x.loop_bound > 0 && x.out_b[B_BACK * P + p]) note_backjump(x, p, (int64_t)pc_old - 1);
}

}  // namespace k7
