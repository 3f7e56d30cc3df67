// K6's per-lane body: the incremental feasibility sweep of one lane by
// one warp, with the per-node interval + known-bits transfer
// `node_domains`. Included by propagate_sweep.cu; the CPU tests build it
// as host C++ with a shim that runs the 32 threads of a warp as threads
// and its votes and barriers with a std::barrier.
//
// Every transfer copies the plain version (symbolic/propagate.py
// `_node_domains`) bit for bit: FREE-kind bounds, operand ids clipped to
// [0, T), NULL nodes left untouched, the MUL interval widened unless the
// product of the highs fits 256 bits.

#pragma once

#include "u256.cuh"

namespace k6 {

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

__device__ inline int imin(int a, int b) { return a < b ? a : b; }
__device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Whether a node's transfer reads its operands' domains: not CONST and
// FREE (FREE's a is its kind), BYTE, the signed compares and the ops
// without a transfer, whose results are fixed.
__device__ inline bool reads_operands(int op) {
  switch (op) {
    case OP_ADD: case OP_SUB: case OP_MUL: case OP_DIV: case OP_MOD: case OP_LT: case OP_GT:
    case OP_EQ: case OP_ISZERO: case OP_AND: case OP_OR: case OP_XOR: case OP_NOT:
    case OP_SHL: case OP_SHR:
      return true;
    default:
      return false;
  }
}

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WINDOW = 32;  // nodes a warp takes at a time, one a thread

struct Sweep {
  const int32_t* tape_op;
  const int32_t* tape_a;
  const int32_t* tape_b;
  const int64_t* tape_imm;
  const int32_t* tape_len;
  int32_t* prop_len;
  int64_t* dom[4];  // iv_lo, iv_hi, kb_m, kb_v: [P, T, 8] each
  const int32_t* con_node;
  const bool* con_sign;
  const int32_t* con_len;
  bool* infeasible;
  int P, T, C;
};

// A window's new domains, u32 limbs: node k's domain d at [k][d][0..8).
typedef uint32_t Stage[WINDOW][4][8];

// The four domains of operand x (clipped id): from the staging where x is
// a node of the window this thread waited for, else from device memory,
// which holds the old domain of x until the window commits.
__device__ inline void operand(const Sweep& s, int64_t row, int x, int w0, unsigned deps,
                               const Stage& st, uint32_t* lo, uint32_t* hi, uint32_t* km,
                               uint32_t* kv) {
  if (x >= w0 && x < w0 + WINDOW && ((deps >> (x - w0)) & 1u)) {
    const int k = x - w0;
    copy8(lo, st[k][0]);
    copy8(hi, st[k][1]);
    copy8(km, st[k][2]);
    copy8(kv, st[k][3]);
  } else {
    const int64_t o = 8 * (row + x);
    load(s.dom[0] + o, lo);
    load(s.dom[1] + o, hi);
    load(s.dom[2] + o, km);
    load(s.dom[3] + o, kv);
  }
}

// The sweep of lane p by its warp; t is the thread's index in the warp,
// and every thread of the warp calls this.
//
// The warp walks the new nodes [max(prop_len, 1), min(tape_len, T)) in
// windows of 32, node w0 + t to thread t. Within a window it runs rounds:
// each round computes every live node whose in-window operands before it
// are done (a done mask from __ballot_sync), so the rounds are as many as
// the longest dependency chain inside the window. The plain loop is
// lock-step over node index, so node i reads this sweep's domain of an
// operand j < i and the OLD domain of j >= i (a self or forward
// reference, or an id clipped to T - 1): a backward operand in the window
// is read from the staging, any other from device memory, which keeps the
// old values until the window commits its staging with coalesced int64
// stores. Then the warp's threads split the live constraint slots and a
// ballot says whether any is contradicted.
__device__ void sweep_warp(const Sweep& s, int p, int t, Stage& st) {
  const int T = s.T;
  const int64_t row = (int64_t)p * T;
  const int len = s.tape_len[p];
  const int pl = s.prop_len[p];
  const int end = imin(len, T);
  uint32_t imm[8], la[8], ha[8], lb[8], hb[8], ka[8], va[8], kb[8], vb[8];
  uint32_t r_lo[8], r_hi[8], rm[8], rv[8];
  for (int w0 = imax(pl, 1); w0 < end; w0 += WINDOW) {
    const int i = w0 + t;
    const int op = i < end ? s.tape_op[row + i] : OP_NULL;
    const bool live = op != OP_NULL;
    const unsigned live_mask = __ballot_sync(FULL, live);
    int a_id = 0, ai = 0, bi = 0;
    unsigned deps = 0u;  // the window's live nodes this one reads
    if (live) {
      a_id = s.tape_a[row + i];
      ai = imin(imax(a_id, 0), T - 1);
      bi = imin(imax(s.tape_b[row + i], 0), T - 1);
      if (reads_operands(op)) {
        if (ai >= w0 && ai < i) deps |= 1u << (ai - w0);
        if (bi >= w0 && bi < i) deps |= 1u << (bi - w0);
        deps &= live_mask;
      }
    }
    bool pending = live;
    for (unsigned done = 0u; done != live_mask;) {
      const bool ready = pending && (deps & ~done) == 0u;
      if (ready) {
        if (reads_operands(op)) {
          operand(s, row, ai, w0, deps, st, la, ha, ka, va);
          operand(s, row, bi, w0, deps, st, lb, hb, kb, vb);
        } else {  // read by no transfer of this op, but defined
          fill8(la, 0u), fill8(ha, 0u), fill8(ka, 0u), fill8(va, 0u);
          fill8(lb, 0u), fill8(hb, 0u), fill8(kb, 0u), fill8(vb, 0u);
        }
        if (op == OP_CONST) load(s.tape_imm + 8 * (row + i), imm);
        node_domains(op, a_id, imm, la, ha, lb, hb, ka, va, kb, vb, r_lo, r_hi, rm, rv);
        copy8(st[t][0], r_lo);
        copy8(st[t][1], r_hi);
        copy8(st[t][2], rm);
        copy8(st[t][3], rv);
        pending = false;
      }
      done |= __ballot_sync(FULL, ready);
      __syncwarp();
    }
    // commit: each domain's 32 x 8 limbs are contiguous in device memory
    for (int d = 0; d < 4; ++d) {
      int64_t* dst = s.dom[d] + 8 * (row + w0);
      for (int e = t; e < WINDOW * 8; e += 32) {
        if ((live_mask >> (e >> 3)) & 1u) dst[e] = (int64_t)st[e >> 3][d][e & 7];
      }
    }
    __syncwarp();
  }
  // constraint check: either domain may contradict a live constraint
  const int n_con = imin(s.con_len[p], s.C);
  bool dead = false;
  for (int c = t; c < n_con; c += 32) {
    const int node = s.con_node[(int64_t)p * s.C + c];
    if (node == 0) continue;
    const int64_t o = 8 * (row + imin(imax(node, 0), T - 1));
    bool hi0 = true, lo0 = true, km_full = true, kv0 = true, known1 = false;
    for (int k = 0; k < 8; ++k) {
      const uint32_t lo = (uint32_t)s.dom[0][o + k], hi = (uint32_t)s.dom[1][o + k];
      const uint32_t km = (uint32_t)s.dom[2][o + k], kv = (uint32_t)s.dom[3][o + k];
      hi0 = hi0 && hi == 0u;
      lo0 = lo0 && lo == 0u;
      km_full = km_full && km == 0xFFFFFFFFu;
      kv0 = kv0 && kv == 0u;
      known1 = known1 || (kv & km) != 0u;
    }
    const bool cant_be_nonzero = hi0 || (km_full && kv0);
    const bool cant_be_zero = !lo0 || known1;
    dead = dead || (s.con_sign[(int64_t)p * s.C + c] ? cant_be_nonzero : cant_be_zero);
  }
  const unsigned any_dead = __ballot_sync(FULL, dead);
  if (t == 0) {
    if (len > pl) s.prop_len[p] = len;
    s.infeasible[p] = any_dead != 0u;
  }
}

}  // namespace k6
