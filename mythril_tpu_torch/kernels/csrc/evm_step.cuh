// K10's per-lane body: one concrete EVM step of one lane of the frontier.
//
// Computes exactly what the port's plain `prologue_plain` ->
// `dispatch_plain` -> `epilogue_plain` (core/interpreter.py) compute,
// field for field, including their quirks: int64 offsets that wrap
// (2^64 - 1 saturates to -1), the first trap wins, a vetoed lane still
// moves its sp, OOB lanes still expand memory to the cap and pay for it.
//
// Every field the step changes is read and written in place through the
// pointers of `Frame`; the caller points them at buffers it owns (a loop
// copies the written fields once on entry, a standalone call copies them
// first; kernels/__init__.py `EVM_WRITES`), so a tensor someone else
// still holds is never written.
//
// Limbs ride in int64 carriers in memory and are loaded as uint32_t;
// offsets and gas are int64 with two's-complement wrap, as in PyTorch.

#pragma once

#include "keccak.cuh"
#include "u256.cuh"

namespace evm {

using namespace u256;

enum {
  CLS_STACK, CLS_ALU, CLS_MUL, CLS_DIVMOD, CLS_MODARITH, CLS_EXP, CLS_SHA3, CLS_ENV,
  CLS_COPY, CLS_MEM, CLS_STORAGE, CLS_JUMP, CLS_HALT, CLS_LOG, CLS_CALL, CLS_CREATE
};

// core/frontier.py Trap
enum {
  TRAP_STACK = 1, TRAP_INVALID_OP = 2, TRAP_BAD_JUMP = 3, TRAP_OOB_MEM = 4,
  TRAP_STORAGE_SLOTS = 5, TRAP_HASH_LIMIT = 6, TRAP_OOG = 7, TRAP_STATIC_WRITE = 10
};

// SHA3 input cap of the interpreter (core/interpreter.py MAX_HASH_BYTES)
constexpr int MAX_HASH_BYTES = 200;

// The pointers of one step, in the order kernels/__init__.py `EVM_FIELDS`
// passes them: frontier fields, env, corpus, opcode tables, then the
// step's own op/run/old_pc (the prologue writes them, dispatch and
// epilogue read them), skip and n_running (the fused entry point's count
// of lanes still running). Optional ones (op_hist, skip) may be null.
#define EVM_PTR_FIELDS(X)                                                              \
  X(const uint8_t*, active) X(uint8_t*, halted) X(uint8_t*, error)                     \
  X(int32_t*, err_code) X(uint8_t*, reverted) X(int32_t*, pc)                          \
  X(const int32_t*, contract_id) X(const int32_t*, depth) X(const int32_t*, sp_base)   \
  X(const uint8_t*, is_static) X(const int32_t*, cur_acct)                             \
  X(const int64_t*, caller_addr) X(const int64_t*, callvalue) X(uint8_t*, pc_hold)     \
  X(const uint8_t*, init_code) X(const int32_t*, init_len) X(const uint8_t*, init_jd)  \
  X(const int32_t*, init_depth) X(const int64_t*, acct_addr)                           \
  X(const int32_t*, acct_code) X(const int64_t*, acct_bal) X(const uint8_t*, acct_used) \
  X(int64_t*, stack) X(int32_t*, sp) X(uint8_t*, memory) X(int32_t*, mem_words)        \
  X(int64_t*, gas_min) X(int64_t*, gas_max) X(const int64_t*, gas_limit)               \
  X(int64_t*, st_keys) X(int64_t*, st_vals) X(uint8_t*, st_used)                       \
  X(uint8_t*, st_written) X(int32_t*, st_acct) X(const uint8_t*, calldata)             \
  X(const int32_t*, calldata_len) X(const uint8_t*, returndata)                        \
  X(int32_t*, returndata_len) X(uint8_t*, retval) X(int32_t*, retval_len)              \
  X(int32_t*, n_logs) X(int32_t*, log_pc) X(int32_t*, log_cid)                         \
  X(int32_t*, log_ntopics) X(int64_t*, log_topic0) X(int64_t*, log_data0)              \
  X(uint8_t*, selfdestructed) X(int32_t*, n_steps) X(int32_t*, op_hist)                \
  X(const int64_t*, origin) X(const int64_t*, gasprice) X(const int64_t*, coinbase)    \
  X(const int64_t*, timestamp) X(const int64_t*, number) X(const int64_t*, prevrandao) \
  X(const int64_t*, blk_gaslimit) X(const int64_t*, chainid) X(const int64_t*, basefee) \
  X(const uint8_t*, code) X(const int32_t*, code_len) X(const uint8_t*, is_jumpdest)   \
  X(const int64_t*, code_hash)                                                         \
  X(const int32_t*, t_class) X(const int32_t*, t_stack_in) X(const int32_t*, t_stack_out) \
  X(const int32_t*, t_d_sp) X(const uint8_t*, t_pushes) X(const int32_t*, t_push_width) \
  X(const uint8_t*, t_is_valid) X(const int64_t*, t_gas_min) X(const int64_t*, t_gas_max) \
  X(const int64_t*, t_empty_keccak)                                                    \
  X(int32_t*, op) X(uint8_t*, run) X(int32_t*, old_pc) X(const uint8_t*, skip)          \
  X(int32_t*, n_running)

// dims, in this order: P, S (stack), M (memory), CD, RD, K (storage
// slots), A (accounts), LS (log slots), IC (init code), MC (max code),
// C (contracts)
#define EVM_DIMS(X) X(P) X(S) X(M) X(CD) X(RD) X(K) X(A) X(LS) X(IC) X(MC) X(C)

struct Frame {
#define EVM_DECL(T, name) T name;
  EVM_PTR_FIELDS(EVM_DECL)
#undef EVM_DECL
#define EVM_DECL_DIM(name) int name;
  EVM_DIMS(EVM_DECL_DIM)
#undef EVM_DECL_DIM
};

inline Frame frame_from(const uint64_t* ptrs, const int* dims) {
  Frame f;
  int i = 0;
#define EVM_SET(T, name) f.name = (T)(uintptr_t)ptrs[i++];
  EVM_PTR_FIELDS(EVM_SET)
#undef EVM_SET
  i = 0;
#define EVM_SET_DIM(name) f.name = dims[i++];
  EVM_DIMS(EVM_SET_DIM)
#undef EVM_SET_DIM
  return f;
}

// what the prologue hands to dispatch and epilogue
struct Step {
  int op;
  bool run;
  int32_t old_pc;
};

// ---------------------------------------------------------------------------
// helpers: int64 with two's-complement wrap, floor division, traps
// ---------------------------------------------------------------------------

__device__ inline int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ inline int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ inline int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ inline int64_t floordiv(int64_t x, int64_t d) {  // d > 0
  int64_t q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}
__device__ inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ inline int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ inline void trap(const Frame& f, int p, bool m, int code) {
  if (!m) return;
  f.error[p] = 1;
  if (f.err_code[p] == 0) f.err_code[p] = code;
}

__device__ inline void load_word(const int64_t* base, int64_t row, uint32_t* w) {
  load(base + 8 * row, w);
}
__device__ inline void store_word(int64_t* base, int64_t row, const uint32_t* w) {
  store(base + 8 * row, w);
}

// stack slot i from the top, the index clipped into the stack
__device__ inline void peek(const Frame& f, int p, int sp, int i, uint32_t* w) {
  int idx = sp - 1 - i;
  idx = idx < 0 ? 0 : (idx > f.S - 1 ? f.S - 1 : idx);
  load_word(f.stack, (int64_t)p * f.S + idx, w);
}

__device__ inline bool exec_init(const Frame& f, int p) {
  return f.init_depth[p] > 0 && f.depth[p] == f.init_depth[p];
}

__device__ inline int clamp_cid(const Frame& f, int64_t c) {
  return (int)(c < 0 ? 0 : (c > f.C - 1 ? f.C - 1 : c));
}

// memory byte at a wrapped int64 index, 0 outside [0, M)
__device__ inline uint32_t mem_byte(const Frame& f, int p, int64_t idx) {
  return (idx >= 0 && idx < f.M) ? f.memory[(int64_t)p * f.M + idx] : 0u;
}

// 32 bytes at off (zero outside [0, M)), the first `n` kept, as a word
__device__ inline void mem_word(const Frame& f, int p, int64_t off, int64_t n, uint32_t* w) {
  fill8(w, 0u);
  for (int k = 0; k < 32; ++k) {
    if (!(k < n)) continue;
    uint32_t b = mem_byte(f, p, wadd(off, k));
    int sig = 31 - k;
    w[sig >> 2] |= b << (8 * (sig & 3));
  }
}

// code byte of this lane's frame at a wrapped index (0 past the frame's
// code): init code in a constructor frame, else the corpus image
__device__ inline uint32_t code_byte(const Frame& f, int p, bool ei, int64_t idx) {
  if (ei) {
    return (idx >= 0 && idx < f.init_len[p] && idx < f.IC)
               ? f.init_code[(int64_t)p * f.IC + idx] : 0u;
  }
  int cid = clamp_cid(f, f.contract_id[p]);
  return (idx >= 0 && idx < f.code_len[cid] && idx < f.MC)
             ? f.code[(int64_t)cid * f.MC + idx] : 0u;
}

__device__ inline int64_t mem_cost(int64_t w) { return 3 * w + floordiv(w * w, 512); }

// charge memory expansion up to end_bytes; traps OOB_MEM past the cap
// (the lane is still expanded to the cap and charged for it)
__device__ inline bool expand_memory(const Frame& f, int p, bool m, int64_t end_bytes) {
  if (!m) return false;
  int64_t end = end_bytes < 0 ? 0 : end_bytes;
  bool oob = end > f.M;
  int64_t words = (imin(end, f.M) + 31) / 32;
  int64_t mw = f.mem_words[p];
  int64_t nw = imax(mw, words);
  int64_t delta = mem_cost(nw) - mem_cost(mw);
  f.mem_words[p] = (int32_t)nw;
  f.gas_min[p] = wadd(f.gas_min[p], delta);
  f.gas_max[p] = wadd(f.gas_max[p], delta);
  trap(f, p, oob, TRAP_OOB_MEM);
  return oob;
}

__device__ inline void charge(const Frame& f, int p, bool m, int64_t amount) {
  if (!m) return;
  f.gas_min[p] = wadd(f.gas_min[p], amount);
  f.gas_max[p] = wadd(f.gas_max[p], amount);
}

// (found, slot) of the account holding addr; slot 0 when none
__device__ inline bool acct_lookup(const Frame& f, int p, const uint32_t* addr, int* slot) {
  for (int k = 0; k < f.A; ++k) {
    int64_t row = (int64_t)p * f.A + k;
    if (!f.acct_used[row]) continue;
    uint32_t w[8];
    load_word(f.acct_addr, row, w);
    if (eq8(w, addr)) {
      *slot = k;
      return true;
    }
  }
  *slot = 0;
  return false;
}

__device__ inline int clamp_acct(const Frame& f, int64_t s) {
  return (int)(s < 0 ? 0 : (s > f.A - 1 ? f.A - 1 : s));
}

// ---------------------------------------------------------------------------
// prologue: fetch, INVALID then STACK traps, static gas
// ---------------------------------------------------------------------------

__device__ inline Step lane_prologue(const Frame& f, int p) {
  Step s;
  int32_t pc = f.pc[p];
  s.old_pc = pc;
  bool running = f.active[p] && !f.halted[p] && !f.error[p];
  bool ei = exec_init(f, p);
  int op_raw;
  bool in_code;
  if (ei) {
    int64_t i = pc < 0 ? 0 : (pc > f.IC - 1 ? f.IC - 1 : pc);
    op_raw = f.init_code[(int64_t)p * f.IC + i];
    in_code = pc < f.init_len[p];
  } else {
    int cid = clamp_cid(f, f.contract_id[p]);
    int64_t i = pc < 0 ? 0 : (pc > f.MC - 1 ? f.MC - 1 : pc);
    op_raw = f.code[(int64_t)cid * f.MC + i];
    in_code = pc < f.code_len[cid];
  }
  int op = (running && in_code) ? op_raw : 0;  // off the end = STOP
  int sin = f.t_stack_in[op], sout = f.t_stack_out[op];
  bool valid = f.t_is_valid[op];
  int sp = f.sp[p];
  bool invalid = running && !valid;
  bool stack_bad = running && valid && ((sp - f.sp_base[p] < sin) || (sp - sin + sout > f.S));
  trap(f, p, invalid, TRAP_INVALID_OP);
  trap(f, p, stack_bad, TRAP_STACK);
  s.run = running && !invalid && !stack_bad;
  if (s.run) {
    f.gas_min[p] = wadd(f.gas_min[p], f.t_gas_min[op]);
    f.gas_max[p] = wadd(f.gas_max[p], f.t_gas_max[op]);
  }
  s.op = op;
  return s;
}

// ---------------------------------------------------------------------------
// class handlers: each writes the fields its class changes and returns
// the word the shared writeback pushes (r) and whether the push is kept
// ---------------------------------------------------------------------------

struct Out {
  uint32_t r[8];
  bool ok;
  // SWAP's second write port
  bool w2;
  int w2_idx;
  uint32_t w2_val[8];
};

__device__ inline void h_stack(const Frame& f, int p, int op, int sp, int32_t old_pc, Out& o) {
  bool is_push = op >= 0x5F && op <= 0x7F;
  bool is_dup = op >= 0x80 && op <= 0x8F;
  bool is_swap = op >= 0x90 && op <= 0x9F;
  if (is_push) {
    int width = op - 0x5F;
    bool ei = exec_init(f, p);
    fill8(o.r, 0u);
    for (int j = 0; j < width; ++j) {
      uint32_t b = code_byte(f, p, ei, (int64_t)old_pc + 1 + j);
      int sig = width - 1 - j;
      o.r[sig >> 2] |= b << (8 * (sig & 3));
    }
  } else if (is_dup) {
    peek(f, p, sp, op - 0x80, o.r);
  } else if (op == 0x58) {  // PC
    from_i64(old_pc, o.r);
  } else if (op == 0x59) {  // MSIZE
    from_i64((int64_t)f.mem_words[p] * 32, o.r);
  } else if (is_swap) {
    int n = op - 0x8F;
    peek(f, p, sp, n, o.r);
    peek(f, p, sp, 0, o.w2_val);
    o.w2 = true;
    o.w2_idx = sp - 1 - n;
  } else {  // GAS (POP and JUMPDEST push nothing)
    from_i64(imax(wsub(f.gas_limit[p], f.gas_max[p]), 0), o.r);
  }
}

__device__ inline void h_alu(const Frame& f, int p, int op, int sp, Out& o) {
  uint32_t a[8], b[8];
  peek(f, p, sp, 0, a);
  peek(f, p, sp, 1, b);
  uint32_t* r = o.r;
  fill8(r, 0u);
  switch (op) {
    case 0x01: add_n(a, b, r, 8); break;
    case 0x03: sub8(a, b, r); break;
    case 0x10: r[0] = lt8(a, b); break;
    case 0x11: r[0] = lt8(b, a); break;
    case 0x12: r[0] = slt8(a, b); break;
    case 0x13: r[0] = slt8(b, a); break;
    case 0x14: r[0] = eq8(a, b); break;
    case 0x15: r[0] = is_zero8(a); break;
    case 0x16: for (int i = 0; i < 8; ++i) r[i] = a[i] & b[i]; break;
    case 0x17: for (int i = 0; i < 8; ++i) r[i] = a[i] | b[i]; break;
    case 0x18: for (int i = 0; i < 8; ++i) r[i] = a[i] ^ b[i]; break;
    case 0x19: for (int i = 0; i < 8; ++i) r[i] = ~a[i]; break;
    case 0x0B: signextend8(a, b, r); break;
    case 0x1A: byte8(a, b, r); break;
    case 0x1B: shl_word(a, b, r); break;
    case 0x1C: shr_word(a, b, r); break;
    case 0x1D: sar_word(a, b, r); break;
    default: add_n(a, b, r, 8); break;
  }
}

__device__ inline void h_divmod(const Frame& f, int p, int op, int sp, Out& o) {
  uint32_t a[8], b[8], aa[8], ab[8], q[8], rem[8];
  peek(f, p, sp, 0, a);
  peek(f, p, sp, 1, b);
  bool sgn = op == 0x05 || op == 0x07;  // SDIV SMOD
  bool na = abs_signed8(a, aa);
  bool nb = abs_signed8(b, ab);
  divmod8(sgn ? aa : a, sgn ? ab : b, q, rem);
  bool is_div = op == 0x04 || op == 0x05;
  if (is_div) {
    if (sgn && na != nb) neg8(q, o.r); else copy8(o.r, q);
  } else {
    if (sgn && na) neg8(rem, o.r); else copy8(o.r, rem);
  }
  if (is_zero8(b)) fill8(o.r, 0u);
}

__device__ inline void h_modarith(const Frame& f, int p, int op, int sp, Out& o) {
  uint32_t a[8], b[8], n[8], wide[16];
  peek(f, p, sp, 0, a);
  peek(f, p, sp, 1, b);
  peek(f, p, sp, 2, n);
  if (op == 0x08) {  // ADDMOD: the 257-bit sum
    for (int i = 8; i < 16; ++i) wide[i] = 0u;
    wide[8] = add_n(a, b, wide, 8) ? 1u : 0u;
  } else {  // MULMOD
    mul_low(a, 8, b, 8, wide, 16);
  }
  mod_wide16(wide, n, o.r);
}

__device__ inline void h_exp(const Frame& f, int p, int sp, bool m, Out& o) {
  uint32_t base[8], e[8];
  peek(f, p, sp, 0, base);
  peek(f, p, sp, 1, e);
  exp8(base, e, o.r);
  // 50 gas per significant exponent byte
  charge(f, p, m, 50 * (int64_t)((top_bit8(e) + 8) / 8));
}

__device__ inline void h_sha3(const Frame& f, int p, int sp, bool m, Out& o) {
  uint32_t w[8];
  peek(f, p, sp, 0, w);
  int64_t off = to_i64_sat(w);
  peek(f, p, sp, 1, w);
  int64_t ln = to_i64_sat(w);
  int max_hash = MAX_HASH_BYTES < f.M ? MAX_HASH_BYTES : f.M;
  bool too_long = m && ln > max_hash;
  bool oob = expand_memory(f, p, m && ln > 0, wadd(off, ln));
  o.ok = m && !too_long && !oob;
  if (o.ok) {
    // the lane's row, whole words (8-byte aligned: kernels.EvmStep checks
    // the field, and M % 32 == 0); bytes at negative offsets read as 0
    int len = (int)(ln < 0 ? 0 : ln);  // <= max_hash here
    keccak::keccak256<false>(keccak::Window{f.memory + (int64_t)p * f.M, 0, f.M, off}, len,
                             max_hash, o.r);
  }
  charge(f, p, o.ok, wmul(6, floordiv(wadd(ln, 31), 32)));
  trap(f, p, too_long, TRAP_HASH_LIMIT);
}

__device__ inline void h_env(const Frame& f, int p, int op, int sp, Out& o) {
  uint32_t a[8];
  peek(f, p, sp, 0, a);
  uint32_t* r = o.r;
  fill8(r, 0u);
  int64_t lane8 = (int64_t)p;  // row of the [P, 8] fields
  switch (op) {
    case 0x30:  // ADDRESS
      load_word(f.acct_addr, lane8 * f.A + clamp_acct(f, f.cur_acct[p]), r);
      break;
    case 0x31: {  // BALANCE
      int slot;
      if (acct_lookup(f, p, a, &slot)) load_word(f.acct_bal, lane8 * f.A + slot, r);
      break;
    }
    case 0x32: load_word(f.origin, lane8, r); break;
    case 0x33: load_word(f.caller_addr, lane8, r); break;
    case 0x34: load_word(f.callvalue, lane8, r); break;
    case 0x35: {  // CALLDATALOAD
      int64_t off = to_i64_sat(a);
      for (int k = 0; k < 32; ++k) {
        int64_t i = wadd(off, k);
        uint32_t b = (i >= 0 && i < f.calldata_len[p] && i < f.CD)
                         ? f.calldata[lane8 * f.CD + i] : 0u;
        int sig = 31 - k;
        r[sig >> 2] |= b << (8 * (sig & 3));
      }
      break;
    }
    case 0x36: from_i64(f.calldata_len[p], r); break;
    case 0x38:  // CODESIZE
      from_i64(exec_init(f, p) ? f.init_len[p]
                               : f.code_len[clamp_cid(f, f.contract_id[p])], r);
      break;
    case 0x3A: load_word(f.gasprice, lane8, r); break;
    case 0x3B:    // EXTCODESIZE
    case 0x3F: {  // EXTCODEHASH
      int slot;
      bool found = acct_lookup(f, p, a, &slot);
      int ext = f.acct_code[lane8 * f.A + slot];
      if (found && ext >= 0) {
        int cid = clamp_cid(f, ext);
        if (op == 0x3B) from_i64(f.code_len[cid], r); else load_word(f.code_hash, cid, r);
      } else if (found && ext == -1 && op == 0x3F) {
        load(f.t_empty_keccak, r);
      }
      break;
    }
    case 0x3D: from_i64(f.returndata_len[p], r); break;
    case 0x40: break;  // BLOCKHASH stub
    case 0x41: load_word(f.coinbase, lane8, r); break;
    case 0x42: load_word(f.timestamp, lane8, r); break;
    case 0x43: load_word(f.number, lane8, r); break;
    case 0x44: load_word(f.prevrandao, lane8, r); break;
    case 0x45: load_word(f.blk_gaslimit, lane8, r); break;
    case 0x46: load_word(f.chainid, lane8, r); break;
    case 0x47:  // SELFBALANCE
      load_word(f.acct_bal, lane8 * f.A + clamp_acct(f, f.cur_acct[p]), r);
      break;
    case 0x48: load_word(f.basefee, lane8, r); break;
    default:
      load_word(f.acct_addr, lane8 * f.A + clamp_acct(f, f.cur_acct[p]), r);
      break;
  }
}

__device__ inline void h_copy(const Frame& f, int p, int op, int sp, bool m) {
  bool is_ext = op == 0x3C;  // EXTCODECOPY: (addr, dst, src, len)
  uint32_t w[8];
  peek(f, p, sp, is_ext ? 1 : 0, w);
  int64_t dst = to_i64_sat(w);
  peek(f, p, sp, is_ext ? 2 : 1, w);
  int64_t src = to_i64_sat(w);
  peek(f, p, sp, is_ext ? 3 : 2, w);
  int64_t ln = to_i64_sat(w);
  int64_t end = wadd(dst, ln);
  bool oob = expand_memory(f, p, m && ln > 0, end);
  bool ok = m && !oob;
  if (ok) {
    bool ei = exec_init(f, p);
    int ext_cid = 0;
    int64_t ext_limit = 0;
    if (is_ext) {
      uint32_t a[8];
      int slot;
      peek(f, p, sp, 0, a);
      bool found = acct_lookup(f, p, a, &slot);
      int ec = f.acct_code[(int64_t)p * f.A + slot];
      ext_cid = clamp_cid(f, ec);
      ext_limit = (found && ec >= 0) ? f.code_len[ext_cid] : 0;
    }
    // the positions j with dst <= j < dst + ln (wrapped), inside memory
    int64_t lo = imax(dst, 0), hi = imin(end, f.M);
    uint8_t* mem = f.memory + (int64_t)p * f.M;
    for (int64_t j = lo; j < hi; ++j) {
      int64_t si = wadd(wsub(j, dst), src);
      uint32_t b = 0u;
      if (op == 0x37) {  // CALLDATACOPY
        b = (si >= 0 && si < f.calldata_len[p] && si < f.CD)
                ? f.calldata[(int64_t)p * f.CD + si] : 0u;
      } else if (op == 0x39) {  // CODECOPY
        b = code_byte(f, p, ei, si);
      } else if (op == 0x3E) {  // RETURNDATACOPY
        b = (si >= 0 && si < f.returndata_len[p] && si < f.RD)
                ? f.returndata[(int64_t)p * f.RD + si] : 0u;
      } else if (is_ext) {
        b = (si >= 0 && si < ext_limit && si < f.MC)
                ? f.code[(int64_t)ext_cid * f.MC + si] : 0u;
      }
      mem[j] = (uint8_t)b;
    }
  }
  charge(f, p, ok, wmul(3, floordiv(wadd(ln, 31), 32)));
}

__device__ inline void h_mem(const Frame& f, int p, int op, int sp, bool m, Out& o) {
  uint32_t w[8], val[8];
  peek(f, p, sp, 0, w);
  int64_t off = to_i64_sat(w);
  peek(f, p, sp, 1, val);
  bool store8 = op == 0x53;
  bool oob = expand_memory(f, p, m, wadd(off, store8 ? 1 : 32));
  o.ok = m && !oob;
  mem_word(f, p, off, 32, o.r);  // MLOAD reads before any write
  if (!o.ok) return;
  uint8_t* mem = f.memory + (int64_t)p * f.M;
  if (op == 0x52) {  // MSTORE: big-endian bytes of val
    for (int k = 0; k < 32; ++k) {
      int64_t i = wadd(off, k);
      int sig = 31 - k;
      if (i >= 0 && i < f.M) mem[i] = (uint8_t)(val[sig >> 2] >> (8 * (sig & 3)));
    }
  } else if (store8) {
    if (off >= 0 && off < f.M) mem[off] = (uint8_t)(val[0] & 0xFFu);
  }
}

__device__ inline void h_storage(const Frame& f, int p, int op, int sp, bool m, Out& o) {
  uint32_t key[8], val[8];
  peek(f, p, sp, 0, key);
  peek(f, p, sp, 1, val);
  bool is_store = op == 0x55;
  bool static_viol = m && is_store && f.is_static[p];
  m = m && !static_viol;
  int32_t acct = f.cur_acct[p];
  // lookup scoped to cur_acct; the sum of several matches wraps per limb
  bool hit = false, has_free = false;
  int hit_slot = 0, free_slot = 0;
  fill8(o.r, 0u);
  for (int k = 0; k < f.K; ++k) {
    int64_t row = (int64_t)p * f.K + k;
    bool used = f.st_used[row];
    if (!used && !has_free) {
      has_free = true;
      free_slot = k;
    }
    if (!used || f.st_acct[row] != acct) continue;
    uint32_t kw[8];
    load_word(f.st_keys, row, kw);
    if (!eq8(kw, key)) continue;
    if (!hit) hit_slot = k;
    hit = true;
    uint32_t vw[8];
    load_word(f.st_vals, row, vw);
    for (int i = 0; i < 8; ++i) o.r[i] += vw[i];
  }
  bool m_store = m && is_store;
  bool overflow = m_store && !hit && !has_free;
  if (m_store && !overflow) {
    int64_t row = (int64_t)p * f.K + (hit ? hit_slot : free_slot);
    store_word(f.st_keys, row, key);
    store_word(f.st_vals, row, val);
    f.st_used[row] = 1;
    f.st_written[row] = 1;
    f.st_acct[row] = acct;
  }
  trap(f, p, overflow, TRAP_STORAGE_SLOTS);
  trap(f, p, static_viol, TRAP_STATIC_WRITE);
  o.ok = m && !is_store;
}

__device__ inline void h_jump(const Frame& f, int p, int op, int sp, int32_t old_pc, bool m) {
  if (!m) return;
  uint32_t dw[8], cond[8];
  peek(f, p, sp, 0, dw);
  peek(f, p, sp, 1, cond);
  int64_t dest = to_i64_sat(dw);
  bool valid;
  if (exec_init(f, p)) {
    int64_t i = dest < 0 ? 0 : (dest > f.IC - 1 ? f.IC - 1 : dest);
    valid = dest < f.IC && f.init_jd[(int64_t)p * f.IC + i];
  } else {
    int cid = clamp_cid(f, f.contract_id[p]);
    int64_t i = dest < 0 ? 0 : (dest > f.MC - 1 ? f.MC - 1 : dest);
    valid = dest < f.MC && f.is_jumpdest[(int64_t)cid * f.MC + i];
  }
  bool taken = !is_zero8(cond) || op != 0x57;
  bool bad = taken && !valid;
  if (!bad) f.pc[p] = taken ? (int32_t)dest : old_pc + 1;
  trap(f, p, bad, TRAP_BAD_JUMP);
}

__device__ inline void h_halt(const Frame& f, int p, int op, int sp, bool m) {
  bool is_return = op == 0xF3, is_revert = op == 0xFD;
  bool is_invalid = op == 0xFE, is_sd = op == 0xFF;
  bool static_viol = m && is_sd && f.is_static[p];
  m = m && !static_viol;
  bool has_data = is_return || is_revert;
  uint32_t w[8];
  peek(f, p, sp, 0, w);
  int64_t off = to_i64_sat(w);
  peek(f, p, sp, 1, w);
  int64_t ln = to_i64_sat(w);
  bool oob = expand_memory(f, p, m && has_data && ln > 0, wadd(off, ln));
  int32_t cap_len = (int32_t)(ln < 0 ? 0 : (ln > f.RD ? f.RD : ln));
  if (m && has_data && !oob) {
    uint8_t* rv = f.retval + (int64_t)p * f.RD;
    for (int j = 0; j < f.RD; ++j) rv[j] = j < cap_len ? (uint8_t)mem_byte(f, p, wadd(off, j)) : 0;
    f.retval_len[p] = cap_len;
  }
  if (m && is_invalid) {  // INVALID consumes all remaining gas
    f.gas_min[p] = f.gas_limit[p];
    f.gas_max[p] = f.gas_limit[p];
  }
  trap(f, p, m && is_invalid, TRAP_INVALID_OP);
  trap(f, p, static_viol, TRAP_STATIC_WRITE);
  if (m && !is_invalid) f.halted[p] = 1;
  if (m && is_revert) f.reverted[p] = 1;
  if (m && is_sd) f.selfdestructed[p] = 1;
}

__device__ inline void h_log(const Frame& f, int p, int op, int sp, int32_t old_pc, bool m) {
  bool static_viol = m && f.is_static[p];
  m = m && !static_viol;
  uint32_t w[8];
  peek(f, p, sp, 0, w);
  int64_t off = to_i64_sat(w);
  peek(f, p, sp, 1, w);
  int64_t ln = to_i64_sat(w);
  expand_memory(f, p, m && ln > 0, wadd(off, ln));
  charge(f, p, m, wmul(8, ln));
  int n_topics = op - 0xA0;
  int32_t nl = f.n_logs[p];
  if (m && nl < f.LS) {
    int64_t row = (int64_t)p * f.LS + (nl > f.LS - 1 ? f.LS - 1 : nl);
    uint32_t topic0[8], data0[8];
    if (n_topics >= 1) peek(f, p, sp, 2, topic0); else fill8(topic0, 0u);
    mem_word(f, p, off, ln, data0);
    f.log_pc[row] = old_pc;
    f.log_cid[row] = f.contract_id[p];
    f.log_ntopics[row] = n_topics;
    store_word(f.log_topic0, row, topic0);
    store_word(f.log_data0, row, data0);
  }
  if (m) f.n_logs[p] = nl + 1;
  trap(f, p, static_viol, TRAP_STATIC_WRITE);
}

// CALL family stub: success = 1, empty returndata
__device__ inline void h_call(const Frame& f, int p, bool m, Out& o) {
  fill8(o.r, 0u);
  o.r[0] = 1u;
  if (m) f.returndata_len[p] = 0;
}

// CREATE/CREATE2 stub: charges the init-code memory, pushes the zero address
__device__ inline void h_create(const Frame& f, int p, int sp, bool m, Out& o) {
  uint32_t w[8];
  peek(f, p, sp, 1, w);
  int64_t off = to_i64_sat(w);
  peek(f, p, sp, 2, w);
  int64_t ln = to_i64_sat(w);
  expand_memory(f, p, m && ln > 0, wadd(off, ln));
  fill8(o.r, 0u);
}

// ---------------------------------------------------------------------------
// dispatch: the lane's class handler, then the shared two-port writeback
// ---------------------------------------------------------------------------

__device__ inline void lane_dispatch(const Frame& f, int p, const Step& s, bool skip) {
  bool run = s.run && !skip;
  if (!run) return;
  int op = s.op;
  int sp = f.sp[p];  // pre_sp: handlers never move it
  Out o;
  fill8(o.r, 0u);
  o.ok = true;
  o.w2 = false;
  o.w2_idx = 0;
  switch (f.t_class[op]) {
    case CLS_STACK: h_stack(f, p, op, sp, s.old_pc, o); break;
    case CLS_ALU: h_alu(f, p, op, sp, o); break;
    case CLS_MUL: {
      uint32_t a[8], b[8];
      peek(f, p, sp, 0, a);
      peek(f, p, sp, 1, b);
      mul_low(a, 8, b, 8, o.r, 8);
      break;
    }
    case CLS_DIVMOD: h_divmod(f, p, op, sp, o); break;
    case CLS_MODARITH: h_modarith(f, p, op, sp, o); break;
    case CLS_EXP: h_exp(f, p, sp, true, o); break;
    case CLS_SHA3: h_sha3(f, p, sp, true, o); break;
    case CLS_ENV: h_env(f, p, op, sp, o); break;
    case CLS_COPY: h_copy(f, p, op, sp, true); break;
    case CLS_MEM: h_mem(f, p, op, sp, true, o); break;
    case CLS_STORAGE: h_storage(f, p, op, sp, true, o); break;
    case CLS_JUMP: h_jump(f, p, op, sp, s.old_pc, true); break;
    case CLS_HALT: h_halt(f, p, op, sp, true); break;
    case CLS_LOG: h_log(f, p, op, sp, s.old_pc, true); break;
    case CLS_CALL: h_call(f, p, true, o); break;
    case CLS_CREATE: h_create(f, p, sp, true, o); break;
    default: break;
  }
  int64_t base = (int64_t)p * f.S;
  if (f.t_pushes[op] && o.ok) {
    int w1 = sp - f.t_stack_in[op] + f.t_stack_out[op] - 1;
    if (w1 >= 0 && w1 < f.S) store_word(f.stack, base + w1, o.r);
  }
  if (o.w2 && o.w2_idx >= 0 && o.w2_idx < f.S) store_word(f.stack, base + o.w2_idx, o.w2_val);
  f.sp[p] = sp + f.t_d_sp[op];
}

// ---------------------------------------------------------------------------
// epilogue: pc advance, pc_hold reset, n_steps, iprof, OOG
// ---------------------------------------------------------------------------

__device__ inline void lane_epilogue(const Frame& f, int p, const Step& s) {
  int op = s.op;
  bool adv = s.run && f.t_class[op] != CLS_JUMP && !f.halted[p] && !f.error[p] && !f.pc_hold[p];
  if (adv) f.pc[p] = s.old_pc + 1 + f.t_push_width[op];
  // every lane, as the plain epilogue: only the symbolic handlers of the
  // same superstep set the flag, so between supersteps it is 0 on every
  // lane and a step on a lane that does not run changes nothing
  f.pc_hold[p] = 0;
  if (s.run) {
    f.n_steps[p] += 1;
    if (f.op_hist) f.op_hist[(int64_t)p * 256 + op] += 1;
  }
  trap(f, p, s.run && f.gas_min[p] > f.gas_limit[p], TRAP_OOG);
}

// ---------------------------------------------------------------------------
// the four entry points' per-lane bodies (evm_step.cu launches them; the
// CPU tests loop them over the lanes of a host build)
// ---------------------------------------------------------------------------

__device__ inline Step given_step(const Frame& f, int p) {
  Step s;
  s.op = f.op[p];
  s.run = f.run[p];
  s.old_pc = f.old_pc[p];
  return s;
}

__device__ inline void entry_prologue(const Frame& f, int p) {
  Step s = lane_prologue(f, p);
  f.op[p] = s.op;
  f.run[p] = s.run;
  f.old_pc[p] = s.old_pc;
}

__device__ inline void entry_dispatch(const Frame& f, int p) {
  lane_dispatch(f, p, given_step(f, p), f.skip != nullptr && f.skip[p]);
}

__device__ inline void entry_epilogue(const Frame& f, int p) {
  lane_epilogue(f, p, given_step(f, p));
}

// -> whether the lane still runs after the step (the kernel counts them
// into n_running)
__device__ inline bool entry_superstep(const Frame& f, int p) {
  Step s = lane_prologue(f, p);
  lane_dispatch(f, p, s, false);
  lane_epilogue(f, p, s);
  return f.active[p] && !f.halted[p] && !f.error[p];
}

}  // namespace evm
