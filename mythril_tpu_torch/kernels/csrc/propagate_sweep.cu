// K6: the incremental feasibility sweep, one thread per lane.
//
// Replaces the JAX package's symbolic/propagate.py `propagate_feasibility`
// (the per-node interval + known-bits transfer `_node_domains`, run as a
// lock-step loop over every lane's new tape nodes) and the constraint
// check of `kill_infeasible`. The JAX loop runs max-new-nodes iterations
// for every lane and needs that count on the host; here each lane walks
// its own nodes [max(prop_len, 1), tape_len) and stops, so nothing is read
// back: the thread writes iv_lo/iv_hi/kb_m/kb_v of each live node in
// place, advances prop_len to tape_len, then checks the lane's live
// constraints against the updated domains and writes its infeasible flag.
//
// Every transfer copies the plain version (symbolic/propagate.py
// `_node_domains`) bit for bit: FREE-kind bounds, operand ids clipped to
// [0, T), NULL nodes left untouched, the MUL interval widened unless the
// product of the highs fits 256 bits.
//
// Bound: bytes. A node reads its row (op, a, b, 8 imm limbs) and its two
// operands' four domains and writes four domains: ~600 bytes in int64
// carriers against a few hundred integer operations. The walk is one
// dependent chain per lane (node i may read node i-1), so at P = 2048
// lanes the card runs 2048 threads of serial work: latency-bound.

#include "u256.cuh"

using namespace u256;

// symbolic/ops.py SymOp and FreeKind codes
enum {
  OP_NULL = 0, OP_CONST = 1, OP_FREE = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5,
  OP_DIV = 6, OP_MOD = 8, OP_LT = 12, OP_GT = 13, OP_SLT = 14, OP_SGT = 15,
  OP_EQ = 16, OP_ISZERO = 17, OP_AND = 18, OP_OR = 19, OP_XOR = 20, OP_NOT = 21,
  OP_BYTE = 22, OP_SHL = 23, OP_SHR = 24,
};
enum { FK_CALLER = 0, FK_CALLDATASIZE = 2, FK_ORIGIN = 4, FK_TIMESTAMP = 5, FK_NUMBER = 6 };

// inclusive bound 2^bits - 1
__device__ inline void bound_2exp(uint32_t* out, int bits) {
  for (int i = 0; i < 8; ++i) {
    int lo = 32 * i;
    out[i] = bits >= lo + 32 ? 0xFFFFFFFFu : (bits > lo ? (1u << (bits - lo)) - 1u : 0u);
  }
}

__device__ inline void set_bool_iv(bool surely_true, bool surely_false, uint32_t* lo,
                                   uint32_t* hi) {
  fill8(lo, 0u);
  fill8(hi, 0u);
  lo[0] = surely_true ? 1u : 0u;
  hi[0] = surely_false ? 0u : 1u;
}

__device__ void node_domains(int op, int a_id, const uint32_t* imm, const uint32_t* la,
                             const uint32_t* ha, const uint32_t* lb, const uint32_t* hb,
                             const uint32_t* ka, const uint32_t* va, const uint32_t* kb,
                             const uint32_t* vb, uint32_t* r_lo, uint32_t* r_hi,
                             uint32_t* rm, uint32_t* rv) {
  // defaults: the full interval, nothing known
  fill8(r_lo, 0u);
  fill8(r_hi, 0xFFFFFFFFu);
  fill8(rm, 0u);
  fill8(rv, 0u);
  bool sing_a = eq8(la, ha), sing_b = eq8(lb, hb);
  uint32_t t[8], u[8];
  switch (op) {
    case OP_CONST:
      copy8(r_lo, imm);
      copy8(r_hi, imm);
      fill8(rm, 0xFFFFFFFFu);
      copy8(rv, imm);
      break;
    case OP_FREE: {
      int kind = a_id;  // FREE stores its kind in a
      int bits = (kind == FK_CALLER || kind == FK_ORIGIN) ? 160
                 : (kind == FK_CALLDATASIZE || kind == FK_TIMESTAMP || kind == FK_NUMBER) ? 64
                 : 256;
      bound_2exp(r_hi, bits);
      if (bits < 256) {
        for (int i = 0; i < 8; ++i) rm[i] = ~r_hi[i];
      }
      break;
    }
    case OP_ADD: {
      bool c = add_n(ha, hb, t, 8);
      if (!c) {
        add_n(la, lb, r_lo, 8);
        copy8(r_hi, t);
      }
      break;
    }
    case OP_SUB:
      if (gte_n(la, hb, 8)) {
        copy8(r_lo, la);
        sub_n(r_lo, hb, 8);
        copy8(r_hi, ha);
        sub_n(r_hi, lb, 8);
      }
      break;
    case OP_MUL: {
      uint32_t w[16];
      mul_low(ha, 8, hb, 8, w, 16);
      uint32_t high = 0u;
      for (int i = 8; i < 16; ++i) high |= w[i];
      if (high == 0u) {
        mul_low(la, 8, lb, 8, r_lo, 8);
        copy8(r_hi, w);
      }
      break;
    }
    case OP_DIV:
      copy8(r_hi, ha);
      break;
    case OP_MOD:
      if (is_zero8(hb)) {
        fill8(r_hi, 0u);
      } else {
        uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
        copy8(t, hb);
        sub_n(t, one, 8);  // b_hi - 1
        copy8(r_hi, lt8(ha, t) ? ha : t);
      }
      break;
    case OP_AND:
      copy8(r_hi, lt8(ha, hb) ? ha : hb);
      for (int i = 0; i < 8; ++i) {
        rm[i] = (ka[i] & kb[i]) | (ka[i] & ~va[i]) | (kb[i] & ~vb[i]);
        rv[i] = va[i] & vb[i] & rm[i];
      }
      break;
    case OP_OR:
      copy8(r_lo, lt8(lb, la) ? la : lb);
      for (int i = 0; i < 8; ++i) {
        rm[i] = (ka[i] & kb[i]) | (ka[i] & va[i]) | (kb[i] & vb[i]);
        rv[i] = (va[i] | vb[i]) & rm[i];
      }
      break;
    case OP_XOR:
      for (int i = 0; i < 8; ++i) {
        rm[i] = ka[i] & kb[i];
        rv[i] = (va[i] ^ vb[i]) & ka[i] & kb[i];
      }
      break;
    case OP_NOT:
      for (int i = 0; i < 8; ++i) {
        r_lo[i] = ~ha[i];
        r_hi[i] = ~la[i];
        rm[i] = ka[i];
        rv[i] = ~va[i] & ka[i];
      }
      break;
    case OP_BYTE:
      fill8(r_hi, 0u);
      r_hi[0] = 255u;
      break;
    case OP_SHR:  // tape operand order: a = shift, b = value
      if (sing_a) {
        shr_word(la, lb, r_lo);
        shr_word(la, hb, r_hi);
      } else {
        copy8(r_hi, hb);
      }
      if (sing_a && !shift_big(la)) {
        uint32_t ones[8];
        fill8(ones, 0xFFFFFFFFu);
        shr_word(la, kb, t);
        shr_word(la, ones, u);
        for (int i = 0; i < 8; ++i) rm[i] = t[i] | ~u[i];
        shr_word(la, vb, rv);
      }
      break;
    case OP_SHL: {
      bool k_small = sing_a && !shift_big(la);
      shl_word(la, hb, t);  // shifted hi
      shr_word(la, t, u);   // shifted back
      if (k_small && eq8(u, hb)) {
        shl_word(la, lb, r_lo);
        copy8(r_hi, t);
      }
      if (k_small) {
        uint32_t ones[8];
        fill8(ones, 0xFFFFFFFFu);
        shl_word(la, kb, t);
        shl_word(la, ones, u);
        for (int i = 0; i < 8; ++i) rm[i] = t[i] | ~u[i];
        shl_word(la, vb, rv);
      }
      break;
    }
    case OP_LT:
    case OP_GT:
    case OP_SLT:
    case OP_SGT:
    case OP_EQ:
    case OP_ISZERO: {
      if (op == OP_LT) {
        set_bool_iv(lt8(ha, lb), gte_n(la, hb, 8), r_lo, r_hi);
      } else if (op == OP_GT) {
        set_bool_iv(lt8(hb, la), !lt8(lb, ha), r_lo, r_hi);
      } else if (op == OP_EQ) {
        set_bool_iv(sing_a && sing_b && eq8(la, lb), lt8(ha, lb) || lt8(hb, la), r_lo, r_hi);
      } else if (op == OP_ISZERO) {
        set_bool_iv(is_zero8(ha), !is_zero8(la), r_lo, r_hi);
      } else {
        set_bool_iv(false, false, r_lo, r_hi);
      }
      // known bits of a boolean: all but bit 0 are zero, sharpened for
      // EQ/ISZERO when the operands' known bits decide it
      fill8(rm, 0xFFFFFFFFu);
      rm[0] = 0xFFFFFFFEu;
      bool a_full = true, b_full = true, diff = false, xor0 = true, vka = false, va0 = true;
      for (int i = 0; i < 8; ++i) {
        a_full = a_full && ka[i] == 0xFFFFFFFFu;
        b_full = b_full && kb[i] == 0xFFFFFFFFu;
        diff = diff || (((va[i] ^ vb[i]) & ka[i] & kb[i]) != 0u);
        xor0 = xor0 && (va[i] ^ vb[i]) == 0u;
        vka = vka || ((va[i] & ka[i]) != 0u);
        va0 = va0 && va[i] == 0u;
      }
      bool dec = false, dec_one = false;
      if (op == OP_EQ) {
        bool kb_eq = a_full && b_full && xor0;
        dec = diff || kb_eq;
        dec_one = kb_eq;
      } else if (op == OP_ISZERO) {
        bool isz_z = a_full && va0;
        dec = vka || isz_z;
        dec_one = isz_z;
      }
      if (dec) fill8(rm, 0xFFFFFFFFu);
      if (dec_one) rv[0] = 1u;
      break;
    }
    default:
      break;
  }
}

__global__ void sweep_kernel(const int32_t* __restrict__ tape_op,
                             const int32_t* __restrict__ tape_a,
                             const int32_t* __restrict__ tape_b,
                             const int64_t* __restrict__ tape_imm,
                             const int32_t* __restrict__ tape_len, int32_t* prop_len,
                             int64_t* iv_lo, int64_t* iv_hi, int64_t* kb_m, int64_t* kb_v,
                             const int32_t* __restrict__ con_node,
                             const bool* __restrict__ con_sign,
                             const int32_t* __restrict__ con_len,
                             bool* __restrict__ infeasible, int P, int T, int C) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int64_t row = (int64_t)p * T;
  int len = tape_len[p];
  int start = prop_len[p] > 1 ? prop_len[p] : 1;
  uint32_t imm[8], la[8], ha[8], lb[8], hb[8], ka[8], va[8], kb[8], vb[8];
  uint32_t r_lo[8], r_hi[8], rm[8], rv[8];
  for (int idx = start; idx < len && idx < T; ++idx) {
    int op = tape_op[row + idx];
    if (op == OP_NULL) continue;
    int a_id = tape_a[row + idx], b_id = tape_b[row + idx];
    int64_t ai = 8 * (row + min(max(a_id, 0), T - 1));
    int64_t bi = 8 * (row + min(max(b_id, 0), T - 1));
    load(tape_imm + 8 * (row + idx), imm);
    load(iv_lo + ai, la);
    load(iv_hi + ai, ha);
    load(kb_m + ai, ka);
    load(kb_v + ai, va);
    load(iv_lo + bi, lb);
    load(iv_hi + bi, hb);
    load(kb_m + bi, kb);
    load(kb_v + bi, vb);
    node_domains(op, a_id, imm, la, ha, lb, hb, ka, va, kb, vb, r_lo, r_hi, rm, rv);
    int64_t o = 8 * (row + idx);
    store(iv_lo + o, r_lo);
    store(iv_hi + o, r_hi);
    store(kb_m + o, rm);
    store(kb_v + o, rv);
  }
  if (len > prop_len[p]) prop_len[p] = len;
  // constraint check: either domain may contradict a live constraint
  bool dead = false;
  int n_con = con_len[p];
  for (int c = 0; c < C && c < n_con && !dead; ++c) {
    int node = con_node[(int64_t)p * C + c];
    if (node == 0) continue;
    int64_t o = 8 * (row + min(max(node, 0), T - 1));
    bool hi0 = true, lo0 = true, km_full = true, kv0 = true, known1 = false;
    for (int i = 0; i < 8; ++i) {
      uint32_t lo = (uint32_t)iv_lo[o + i], hi = (uint32_t)iv_hi[o + i];
      uint32_t km = (uint32_t)kb_m[o + i], kv = (uint32_t)kb_v[o + i];
      hi0 = hi0 && hi == 0u;
      lo0 = lo0 && lo == 0u;
      km_full = km_full && km == 0xFFFFFFFFu;
      kv0 = kv0 && kv == 0u;
      known1 = known1 || (kv & km) != 0u;
    }
    bool cant_be_nonzero = hi0 || (km_full && kv0);
    bool cant_be_zero = !lo0 || known1;
    dead = con_sign[(int64_t)p * C + c] ? cant_be_nonzero : cant_be_zero;
  }
  infeasible[p] = dead;
}

extern "C" int propagate_sweep(const int32_t* tape_op, const int32_t* tape_a,
                               const int32_t* tape_b, const int64_t* tape_imm,
                               const int32_t* tape_len, int32_t* prop_len, int64_t* iv_lo,
                               int64_t* iv_hi, int64_t* kb_m, int64_t* kb_v,
                               const int32_t* con_node, const bool* con_sign,
                               const int32_t* con_len, bool* infeasible, int P, int T, int C,
                               void* stream) {
  if (P <= 0) return 0;
  int threads = 128;
  int blocks = (P + threads - 1) / threads;
  sweep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tape_op, tape_a, tape_b, tape_imm, tape_len, prop_len, iv_lo, iv_hi, kb_m, kb_v,
      con_node, con_sign, con_len, infeasible, P, T, C);
  return (int)cudaGetLastError();
}
