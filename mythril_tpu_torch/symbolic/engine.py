"""The symbolic superstep: concrete dispatch + sym-id overlay + forking.

PyTorch counterpart of the single-frame core of the JAX package's
``symbolic/engine.py``:

- lanes whose current opcode touches symbolic control/addresses are
  *claimed* out of the concrete dispatch and handled by sym-aware
  handlers (storage, jumps, symbolic-offset memory ops);
- everything else runs the concrete handler unchanged, and a vectorized
  overlay keeps ``stack_sym``/``mem_sym`` in sync and appends tape nodes
  (kernel K3 on the card, see :func:`append_node`);
- a symbolic JUMPI records a fork request; :func:`expand_forks` performs
  masked lane duplication + prefix-sum compaction into free lanes.

Call frames are not part of this engine: CALL/CALLCODE/DELEGATECALL/
STATICCALL and CREATE/CREATE2 (and with them precompiles and sub-frame
returns) are refused — the analysis front door rejects such bytecode
before any device work, and :func:`sym_superstep` raises if a lane still
reaches one.

Where the JAX code wraps a handler in ``lax.cond(any(mask))`` /
``narrow_cond``, this code reads the predicates back to the host (one
transfer for all of them per superstep) and runs the handler only when
its JAX cond would have been taken — the same results, without the
TPU-specific boundary machinery.

Over-approximation policy (unchanged): wherever byte-exact symbolic
tracking is not worth the shapes, the result is a fresh unconstrained
HAVOC leaf — never a wrong value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LimitsConfig, DEFAULT_LIMITS
from ..core import interpreter as ci
from ..core.frontier import Env, Corpus, Trap, CODE_UNKNOWN, first_true
from ..ops import u256
from .ops import SymOp, FreeKind, TX_STRIDE, BAL_STRIDE
from .state import SymFrontier, SymSpec, tape_row_hash, hash_bits

I32 = torch.int32
I64 = torch.int64
M32 = u256.MASK32


class UnsupportedOperation(RuntimeError):
    """A lane reached an operation this engine does not implement."""


# EVM opcode -> SymOp for plain binary/unary value ops (0 = no mapping)
def _binop_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.int32)
    m = {
        0x01: SymOp.ADD, 0x02: SymOp.MUL, 0x03: SymOp.SUB, 0x04: SymOp.DIV,
        0x05: SymOp.SDIV, 0x06: SymOp.MOD, 0x07: SymOp.SMOD, 0x0A: SymOp.EXP,
        0x0B: SymOp.SIGNEXTEND, 0x10: SymOp.LT, 0x11: SymOp.GT,
        0x12: SymOp.SLT, 0x13: SymOp.SGT, 0x14: SymOp.EQ, 0x15: SymOp.ISZERO,
        0x16: SymOp.AND, 0x17: SymOp.OR, 0x18: SymOp.XOR, 0x19: SymOp.NOT,
        0x1A: SymOp.BYTE, 0x1B: SymOp.SHL, 0x1C: SymOp.SHR, 0x1D: SymOp.SAR,
    }
    for k, v in m.items():
        t[k] = int(v)
    return t


_BINOP = _binop_table()
_BINOP_T: dict = {}


def _binop(op):
    key = str(op.device)
    if key not in _BINOP_T:
        _BINOP_T[key] = torch.as_tensor(_BINOP, device=op.device)
    return _BINOP_T[key][op.long()]


# ---------------------------------------------------------------------------
# Tape + sym-stack helpers
# ---------------------------------------------------------------------------


def _peek_sym(sf: SymFrontier, i) -> torch.Tensor:
    S = sf.stack_sym.shape[1]
    idx = torch.clamp(sf.base.sp - 1 - i, 0, S - 1).long()
    return sf.stack_sym[ci._lanes(idx), idx]


def _set_sym_slot(stack_sym, pos, val, mask):
    S = stack_sym.shape[1]
    return ci._write_slot(stack_sym, torch.where(mask & (pos >= 0), pos, S), val)


def _take1(arr, idx):
    """arr[P, N] gathered at per-lane idx[P] (clipped)."""
    idx = torch.clamp(idx, 0, arr.shape[1] - 1).long()
    return arr[ci._lanes(idx), idx]


def append_node_plain(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                      op, a, b, imm, mask):
    """Plain version of K3 (same in-place contract): returns (ids,
    overflow) and updates the tape tensors in place."""
    P, T = tape_op.shape
    h = tape_row_hash(op, a, b, imm)
    hb = hash_bits(h)
    live = torch.arange(T, device=op.device)[None, :] < tape_len[:, None]
    match = live & (tape_hash == hb[:, None])
    hit0 = torch.any(match, dim=1)
    hit_id = first_true(match, dim=1)
    lanes = ci._lanes(op)
    hl = hit_id.long()
    hit = (hit0 & (tape_op[lanes, hl] == op) & (tape_a[lanes, hl] == a)
           & (tape_b[lanes, hl] == b) & torch.all(tape_imm[lanes, hl] == imm, dim=-1))
    overflow = mask & ~hit & (tape_len >= T)
    write = mask & ~hit & ~overflow
    ids = torch.where(mask, torch.where(hit, hit_id, torch.where(write, tape_len, 0)), 0)
    # write slot: the lane's tape_len, or (no write) the row it already
    # holds at index 0 rewritten with itself
    widx = torch.where(write, tape_len, 0).long()
    w1 = write[:, None]
    tape_op[lanes, widx] = torch.where(write, op, tape_op[lanes, widx])
    tape_a[lanes, widx] = torch.where(write, a, tape_a[lanes, widx])
    tape_b[lanes, widx] = torch.where(write, b, tape_b[lanes, widx])
    tape_imm[lanes, widx] = torch.where(w1, imm, tape_imm[lanes, widx])
    tape_hash[lanes, widx] = torch.where(write, hb, tape_hash[lanes, widx])
    tape_len += write.to(I32)
    return ids, overflow


def append_node(sf: SymFrontier, mask, op, a, b, imm=None):
    """Hash-consed tape append. op/a/b int or i32[P]; imm [P,8] or None.
    Returns (sf, ids) — id per lane (0 where ~mask). Overflow traps the
    lane with ``TAPE_LIMIT``.

    Kernel K3 on a CUDA frontier, :func:`append_node_plain` on a CPU one.
    Both update the tape tensors IN PLACE (the JAX function returned a
    new tape): callers never keep an older frontier's tape alive across
    an append, and ``expand_forks`` gathers a fresh tape for its copies."""
    P, T = sf.tape_op.shape
    dev = sf.tape_op.device

    def lanes_of(x):
        if isinstance(x, torch.Tensor):
            return x.to(I32).expand(P).contiguous()
        return torch.full((P,), int(x), dtype=I32, device=dev)

    op, a, b = lanes_of(op), lanes_of(a), lanes_of(b)
    imm = (torch.zeros((P, 8), dtype=I64, device=dev) if imm is None
           else imm.to(I64).expand(P, 8).contiguous())
    args = (sf.tape_op, sf.tape_a, sf.tape_b, sf.tape_imm, sf.tape_hash, sf.tape_len,
            op, a, b, imm, mask.contiguous())
    if sf.tape_op.is_cuda:
        from ..kernels import tape_append

        ids, overflow = tape_append(*args)
    elif not bool(mask.any()):
        # nothing to append (the common case for most of the overlay's
        # appends): ids 0, no write, no trap — reading the mask costs
        # nothing on the CPU, unlike a device sync
        return sf, torch.zeros(P, dtype=I32, device=dev)
    else:
        ids, overflow = append_node_plain(*args)
    return sf.replace(base=sf.base.trap(overflow, Trap.TAPE_LIMIT)), ids


def _sym_or_const(sf: SymFrontier, mask, sym, limbs):
    """Operand id: existing sym, id 0 for concrete zero, CONST node else."""
    need = mask & (sym == 0) & ~u256.is_zero(limbs)
    sf, cid = append_node(sf, need, int(SymOp.CONST), 0, 0, limbs)
    return sf, torch.where(sym != 0, sym, cid)


def _havoc(sf: SymFrontier, mask):
    """Fresh unconstrained leaf per lane (unique via per-lane counter)."""
    sf2, ids = append_node(sf, mask, int(SymOp.FREE), int(FreeKind.HAVOC), sf.havoc_cnt)
    return sf2.replace(havoc_cnt=sf2.havoc_cnt + mask.to(I32)), ids


def _event_slot(counter, mask, length: int):
    """onehot[P, L] of the next free event slot where `mask`."""
    idx = torch.clamp(counter, max=length - 1)
    rec = mask & (counter < length)
    return (torch.arange(length, device=counter.device)[None, :] == idx[:, None]) & rec[:, None]


def _lookup_constraint(sf: SymFrontier, node):
    """Is `node` already asserted on the path? -> (known, sign)."""
    C = sf.con_node.shape[1]
    live = torch.arange(C, device=node.device)[None, :] < sf.con_len[:, None]
    m = live & (sf.con_node == node[:, None]) & (node[:, None] != 0)
    known = torch.any(m, dim=1)
    sign = _take1(sf.con_sign, first_true(m, dim=1))
    return known, known & sign


def _append_constraint(sf: SymFrontier, mask, node, sign, pc):
    C = sf.con_node.shape[1]
    overflow = mask & (sf.con_len >= C)
    write = mask & ~overflow
    widx = torch.where(write, torch.clamp(sf.con_len, max=C), C)
    sign = torch.as_tensor(sign, device=mask.device).expand(mask.shape)
    return sf.replace(
        con_node=ci._write_slot(sf.con_node, widx, node),
        con_sign=ci._write_slot(sf.con_sign, widx, sign),
        con_pc=ci._write_slot(sf.con_pc, widx, pc),
        con_len=sf.con_len + write.to(I32),
        base=sf.base.trap(overflow, Trap.CONSTRAINT_LIMIT),
    )


# ---------------------------------------------------------------------------
# Claimed handlers (their lanes were skipped by the concrete dispatch, so
# stack/sp are still pre-instruction)
# ---------------------------------------------------------------------------


def _h_sym_storage(sf: SymFrontier, spec: SymSpec, op, m):
    """SLOAD/SSTORE with (possibly symbolic) keys and values: concrete
    keys match by limb equality, symbolic keys by tape node id, plus the
    numeric alias probe (a symbolic key whose known-bits domain is fully
    determined is demoted to its value). Returns (sf, aux) — the SLOAD
    result rides aux to the shared writeback in :func:`sym_superstep`."""
    f = sf.base
    key = ci._peek(f, 0)
    key_sym = _peek_sym(sf, 0)
    val = ci._peek(f, 1)
    val_sym = _peek_sym(sf, 1)
    is_store = op == 0x55
    static_viol = m & is_store & f.static
    m = m & ~static_viol
    sf = sf.replace(base=f.trap(static_viol, Trap.STATIC_WRITE))
    f = sf.base

    in_acct = f.st_acct == f.cur_acct[:, None]
    T = sf.tape_op.shape[1]
    lanes = ci._lanes(key_sym)
    if spec.alias_probe:
        kidx = torch.clamp(key_sym, 0, T - 1).long()
        key_kbm = sf.kb_m[lanes, kidx]
        key_kbv = sf.kb_v[lanes, kidx]
        key_known = ((key_sym != 0) & (key_sym < sf.prop_len)
                     & torch.all(key_kbm == M32, dim=-1))
        key_num = torch.where(key_known[:, None], key_kbv, key)
        ent_sym = sf.st_key_sym
        eidx = torch.clamp(ent_sym, 0, T - 1).long()
        ent_kbm = sf.kb_m[lanes[:, None], eidx]
        ent_known = ((ent_sym != 0) & (ent_sym < sf.prop_len[:, None])
                     & torch.all(ent_kbm == M32, dim=-1))
        ent_kbv = sf.kb_v[lanes[:, None], eidx]
        ent_num = torch.where(ent_known[:, :, None], ent_kbv, f.st_keys)
    else:
        key_known = torch.zeros_like(key_sym, dtype=torch.bool)
        key_num = key
        ent_known = torch.zeros_like(sf.st_key_sym, dtype=torch.bool)
        ent_num = f.st_keys
    key_def = (key_sym == 0) | key_known
    eff_key_sym = torch.where(key_known, 0, key_sym)
    ent_def = (sf.st_key_sym == 0) | ent_known

    conc = (key_def[:, None] & ent_def
            & torch.all(ent_num == key_num[:, None, :], dim=-1))
    symm = (key_sym[:, None] != 0) & (sf.st_key_sym == key_sym[:, None])
    match = f.st_used & in_acct & (conc | symm)
    # a VALUE hit requires a value-bearing entry (st_seq > 0)
    match_val = match & (sf.st_seq > 0)
    hit = torch.any(match_val, dim=1)
    prior_hit = torch.any(match_val & ~f.st_written, dim=1)
    sf = sf.replace(dep_read=sf.dep_read | (m & ~is_store & prior_hit))
    # the latest-written matching slot (max st_seq, first on ties)
    sel = torch.argmax(torch.where(match, sf.st_seq, -1), dim=1).to(I32)
    sl = sel.long()
    cur = torch.where(hit[:, None], f.st_vals[lanes, sl], 0)
    cur_sym = torch.where(hit, sf.st_val_sym[lanes, sl], 0).to(I32)

    miss_load = m & ~is_store & ~hit
    A = f.acct_used.shape[1]
    if spec.storage:
        sf, leaf = append_node(
            sf, miss_load, int(SymOp.FREE), int(FreeKind.STORAGE),
            eff_key_sym * A + f.cur_acct,
            torch.where((eff_key_sym == 0)[:, None], key_num, 0),
        )
    else:
        leaf = torch.zeros_like(key_sym)
    f = sf.base
    loaded = torch.where(hit[:, None], cur, 0)
    loaded_sym = torch.where(hit, cur_sym, leaf)

    widx, overflow = ci.storage_alloc(f, torch.any(match, dim=1), sel, m & is_store)
    store_m = m & is_store
    first_after_call = store_m & (sf.n_mut_calls > 0) & (sf.sstore_after_call_pc < 0)
    key_op = _take1(sf.tape_op, key_sym)
    key_is_hash = key_op == int(SymOp.KECCAK)
    first_arb = store_m & (eff_key_sym != 0) & ~key_is_hash & (sf.arb_key_pc < 0)
    return sf.replace(
        base=f.replace(
            st_keys=ci._write_slot(f.st_keys, widx, key_num),
            st_vals=ci._write_slot(f.st_vals, widx, val),
            st_used=ci._write_slot(f.st_used, widx, True),
            st_written=ci._write_slot(f.st_written, widx, True),
            st_acct=ci._write_slot(f.st_acct, widx, f.cur_acct),
        ).trap(overflow, Trap.STORAGE_SLOTS),
        st_key_sym=ci._write_slot(sf.st_key_sym, widx, eff_key_sym),
        st_val_sym=ci._write_slot(sf.st_val_sym, widx, val_sym),
        st_seq=ci._write_slot(sf.st_seq, widx, sf.st_seq_ctr + 1),
        st_seq_ctr=sf.st_seq_ctr + store_m.to(I32),
        sstore_after_call_pc=torch.where(first_after_call, f.pc, sf.sstore_after_call_pc),
        sstore_ac_cid=torch.where(first_after_call, f.contract_id, sf.sstore_ac_cid),
        arb_key_node=torch.where(first_arb, key_sym, sf.arb_key_node),
        arb_key_pc=torch.where(first_arb, f.pc, sf.arb_key_pc),
        arb_key_cid=torch.where(first_arb, f.contract_id, sf.arb_key_cid),
    ), {"r": loaded, "r_sym": loaded_sym, "w": m & ~is_store}


def _h_sym_jump(sf: SymFrontier, corpus: Corpus, op, m, old_pc, known, ksign):
    """JUMP/JUMPI with symbolic dest and/or condition: an unresolved
    symbolic condition with a valid concrete dest records a fork request
    and continues on the fallthrough with the negated condition; a
    symbolic dest on a (possibly) taken branch is recorded for SWC-127."""
    f = sf.base
    dest_w = ci._peek(f, 0)
    dest_sym = _peek_sym(sf, 0)
    cond = ci._peek(f, 1)
    cond_sym = _peek_sym(sf, 1)
    is_jumpi = op == 0x57

    dest, valid_dest = ci.validate_jump_dest(f, corpus, dest_w)
    valid_dest = valid_dest & (dest_sym == 0)

    cond_is_sym = is_jumpi & (cond_sym != 0)
    resolved = ~is_jumpi | ~cond_is_sym | known
    taken_res = torch.where(is_jumpi, torch.where(cond_is_sym, ksign, ~u256.is_zero(cond)),
                            torch.ones_like(is_jumpi))

    m_res = m & resolved
    m_fork = m & ~resolved
    sym_taken = m_res & taken_res & (dest_sym != 0)
    conc_taken = m_res & taken_res & (dest_sym == 0)
    bad = conc_taken & ~valid_dest
    sym_unres = m_fork & (dest_sym != 0)
    con_ok = sf.con_len < sf.con_node.shape[1]
    fork_ok = m_fork & valid_dest & con_ok
    sf = _append_constraint(sf, m_fork, cond_sym, False, old_pc)

    f = sf.base
    new_pc = torch.where(m_res & conc_taken, dest.to(I32), old_pc + 1)
    move = (m_res & ~bad & ~sym_taken) | m_fork
    d_sp = torch.where(is_jumpi, 2, 1).to(I32)
    rec = sym_taken | sym_unres
    return sf.replace(
        base=f.replace(
            pc=torch.where(move, new_pc, f.pc),
            sp=torch.where(m, f.sp - d_sp, f.sp),
            halted=f.halted | sym_taken,
        ).trap(bad, Trap.BAD_JUMP),
        sym_jump_dest=torch.where(rec, dest_sym, sf.sym_jump_dest),
        sym_jump_pc=torch.where(rec, old_pc, sf.sym_jump_pc),
        sym_jump_cid=torch.where(rec, f.contract_id, sf.sym_jump_cid),
        fork_req=sf.fork_req | fork_ok,
        fork_dest=torch.where(fork_ok, dest.to(I32), sf.fork_dest),
    )


def _note_backjump(sf: SymFrontier, mask, src, dest, loop_bound: int) -> SymFrontier:
    """Count taken BACKWARD jumps per (lane, contract, source pc, target);
    retire lanes whose revisit count exceeds ``loop_bound`` (the
    bounded-loops policy). A miss on a full table reuses the coldest slot."""
    if loop_bound <= 0:
        return sf
    P, LBS = sf.lb_key.shape
    key = ((sf.base.contract_id.to(I64) * 32768 + dest.to(I64)) * 32768 + src.to(I64))
    live = torch.arange(LBS, device=key.device)[None, :] < sf.lb_len[:, None]
    match = live & (sf.lb_key == key[:, None])
    hit = torch.any(match, dim=1)
    hit_slot = first_true(match, dim=1)
    has_free = sf.lb_len < LBS
    cold = torch.argmin(sf.lb_cnt, dim=1).to(I32)
    slot = torch.where(hit, hit_slot,
                       torch.where(has_free, torch.clamp(sf.lb_len, max=LBS - 1), cold))
    cur = _take1(sf.lb_cnt, slot)
    cnt = torch.where(hit, cur + 1, 1)
    idx = torch.where(mask, slot, LBS)
    return sf.replace(
        lb_key=ci._write_slot(sf.lb_key, idx, key),
        lb_cnt=ci._write_slot(sf.lb_cnt, idx, cnt),
        lb_len=sf.lb_len + (mask & ~hit & has_free).to(I32),
        base=sf.base.trap(mask & (cnt > loop_bound), Trap.LOOP_BOUND),
    )


def _h_sym_claimed_misc(sf: SymFrontier, op, m_memoff, m_sha3off, m_copyoff,
                        m_haltoff, m_logoff) -> SymFrontier:
    """Symbolic-offset memory/copy/sha3/halt/log ops: stack bookkeeping +
    havoc over-approximation."""
    f = sf.base
    is_load = op == 0x51
    static_viol = m_logoff & f.static
    m_logoff = m_logoff & ~static_viol
    sf = sf.replace(base=f.trap(static_viol, Trap.STATIC_WRITE))
    f = sf.base
    any_m = m_memoff | m_sha3off | m_copyoff | m_haltoff | m_logoff

    need_hv = (m_memoff & is_load) | m_sha3off
    sf, hv = _havoc(sf, need_hv)
    f = sf.base

    stack_sym = _set_sym_slot(sf.stack_sym, f.sp - 1, hv, m_memoff & is_load)
    stack_sym = _set_sym_slot(stack_sym, f.sp - 2, hv, m_sha3off)

    tb = ci._tab(op)
    opl = op.long()
    d_sp = tb.STACK_IN[opl] - tb.STACK_OUT[opl]
    is_revert = op == 0xFD
    has_data_halt = (op == 0xF3) | is_revert
    LS = f.log_pc.shape[1]
    wl = torch.where(m_logoff & (f.n_logs < LS), torch.clamp(f.n_logs, max=LS - 1), LS)
    n_topics = op - 0xA0
    topic0 = ci._peek(f, 2)
    return sf.replace(
        base=f.replace(
            sp=torch.where(any_m, f.sp - d_sp, f.sp),
            halted=f.halted | (m_haltoff & has_data_halt),
            reverted=f.reverted | (m_haltoff & is_revert),
            retval_len=torch.where(m_haltoff, 0, f.retval_len),
            n_logs=f.n_logs + m_logoff.to(I32),
            log_pc=ci._write_slot(f.log_pc, wl, f.pc),
            log_cid=ci._write_slot(f.log_cid, wl, f.contract_id),
            log_ntopics=ci._write_slot(f.log_ntopics, wl, n_topics),
            log_topic0=ci._write_slot(
                f.log_topic0, wl, torch.where((n_topics >= 1)[:, None], topic0, 0)),
        ),
        log_topic0_sym=ci._write_slot(
            sf.log_topic0_sym, wl, torch.where(n_topics >= 1, _peek_sym(sf, 2), 0)),
        log_data0_sym=ci._write_slot(sf.log_data0_sym, wl, -1),
        stack_sym=stack_sym,
        mem_havoc=sf.mem_havoc | (m_memoff & ~is_load) | m_copyoff,
        rv_havoc=sf.rv_havoc | m_haltoff,
    )


# ---------------------------------------------------------------------------
# Overlay: sym-id bookkeeping for concretely-dispatched lanes
# ---------------------------------------------------------------------------


def _take_word_sym(mem_sym, w):
    return _take1(mem_sym, w)


def _set_word_sym(mem_sym, w, val, mask):
    W = mem_sym.shape[1]
    return ci._write_slot(mem_sym, torch.where(mask & (w >= 0) & (w < W), w, W), val)


def _overlay(sf: SymFrontier, env: Env, spec: SymSpec, op, m, cls, pre_sp,
             pre_stack_sym, a, s, limits: LimitsConfig) -> SymFrontier:
    """Mirror the concrete handlers' stack movements on the sym-id plane
    and append tape nodes where symbolic operands flowed in. Uses the
    PRE-dispatch stack/syms (`a` = operand limbs, `s` = operand sym ids)."""
    f = sf.base
    stack_sym = sf.stack_sym
    tb = ci._tab(op)
    sin = tb.STACK_IN[op.long()]
    S = stack_sym.shape[1]
    P = op.shape[0]
    dev = op.device

    # ---- CLS_STACK: push/dup/swap/pc/msize/gas ----
    m_stk = m & (cls == ci.CLS_STACK)
    is_push = (op >= 0x5F) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    pushes0 = is_push | (op == 0x58) | (op == 0x59) | (op == 0x5A)
    dup_n = torch.where(is_dup, op - 0x7F, 1)
    dup_sym = _take1(pre_stack_sym, pre_sp - dup_n)
    stack_sym = _set_sym_slot(stack_sym, pre_sp, torch.zeros_like(dup_sym), m_stk & pushes0)
    stack_sym = _set_sym_slot(stack_sym, pre_sp, dup_sym, m_stk & is_dup)
    swap_n = torch.where(is_swap, op - 0x8F, 1)
    deep_sym = _take1(pre_stack_sym, pre_sp - 1 - swap_n)
    stack_sym = _set_sym_slot(stack_sym, pre_sp - 1, deep_sym, m_stk & is_swap)
    stack_sym = _set_sym_slot(stack_sym, pre_sp - 1 - swap_n, s[0], m_stk & is_swap)
    sf = sf.replace(stack_sym=stack_sym)

    # ---- value binops/unaries (ALU/MUL/DIVMOD/EXP classes) ----
    m_bin = m & ((cls == ci.CLS_ALU) | (cls == ci.CLS_MUL) | (cls == ci.CLS_DIVMOD)
                 | (cls == ci.CLS_EXP))
    node_op = _binop(op)
    is_unary = (op == 0x15) | (op == 0x19)  # ISZERO NOT
    any_sym = (s[0] != 0) | (~is_unary & (s[1] != 0))
    m_node = m_bin & any_sym & (node_op != 0)
    sf, aid = _sym_or_const(sf, m_node, s[0], a[0])
    sf, bid = _sym_or_const(sf, m_node & ~is_unary, s[1], a[1])
    bid = torch.where(is_unary, 0, bid)
    sf, r_bin = append_node(sf, m_node, node_op, aid, bid)

    # symbolic ADD/SUB/MUL/EXP events for the IntegerArithmetics module
    is_arith = (op == 0x01) | (op == 0x02) | (op == 0x03) | (op == 0x0A)
    m_ar = m_node & is_arith
    ar_onehot = _event_slot(sf.n_arith, m_ar, sf.arith_op.shape[1])
    old_pc_arr = sf.base.pc  # prologue left pc at the instruction
    sf = sf.replace(
        n_arith=sf.n_arith + m_ar.to(I32),
        arith_op=torch.where(ar_onehot, op[:, None], sf.arith_op),
        arith_a=torch.where(ar_onehot, aid[:, None], sf.arith_a),
        arith_b=torch.where(ar_onehot, bid[:, None], sf.arith_b),
        arith_r=torch.where(ar_onehot, r_bin[:, None], sf.arith_r),
        arith_pc=torch.where(ar_onehot, old_pc_arr[:, None], sf.arith_pc),
        arith_cid=torch.where(ar_onehot, sf.base.contract_id[:, None], sf.arith_cid),
    )

    # ---- CLS_MODARITH: symbolic addmod/mulmod -> havoc ----
    m_mod = m & (cls == ci.CLS_MODARITH)
    m_mod_sym = m_mod & ((s[0] != 0) | (s[1] != 0) | (s[2] != 0))

    # ---- CLS_ENV: leaves (tx-scoped identity; dedup hits the tx-0 seeds) ----
    m_env = m & (cls == ci.CLS_ENV)
    is_cdload = op == 0x35
    off64 = u256.to_u64_saturating(a[0])
    CD = limits.calldata_bytes
    beyond = off64 >= CD
    txb = sf.tx_id
    at_top = sf.base.depth == 0

    kind = torch.full_like(op, -1)
    bsel = torch.zeros_like(op)

    def leaf(enabled: bool, sel, k: int, bval):
        nonlocal kind, bsel
        if not enabled:
            return
        kind = torch.where(sel, k, kind)
        bsel = torch.where(sel, torch.as_tensor(bval, device=dev).to(I32), bsel)

    leaf(spec.caller, (op == 0x33) & at_top, int(FreeKind.CALLER), txb)
    leaf(spec.callvalue, (op == 0x34) & at_top, int(FreeKind.CALLVALUE), txb)
    leaf(spec.calldata, (op == 0x36) & at_top, int(FreeKind.CALLDATASIZE), txb)
    leaf(spec.calldata, is_cdload & (s[0] == 0) & ~beyond & at_top,
         int(FreeKind.CALLDATA_WORD), (txb.to(I64) * TX_STRIDE + off64).to(I32))
    leaf(True, op == 0x32, int(FreeKind.ORIGIN), 0)
    leaf(spec.block_env, op == 0x42, int(FreeKind.TIMESTAMP), 0)
    leaf(spec.block_env, op == 0x43, int(FreeKind.NUMBER), 0)
    leaf(spec.block_env, op == 0x44, int(FreeKind.PREVRANDAO), 0)
    leaf(spec.block_env, op == 0x3A, int(FreeKind.GASPRICE), 0)
    is_balance = op == 0x31
    known_acct, acct_slot = sf.base.acct_lookup(a[0])
    known_bal = is_balance & known_acct & (s[0] == 0)
    epoch_b = sf.bal_epoch * BAL_STRIDE
    leaf(spec.block_env, op == 0x47, int(FreeKind.BALANCE), epoch_b + sf.base.cur_acct)
    leaf(spec.block_env, known_bal, int(FreeKind.BALANCE), epoch_b + acct_slot)
    leaf(True, (op == 0x3D) & sf.retdata_sym, int(FreeKind.RETDATASIZE),
         torch.clamp(sf.n_calls - 1, min=0))

    need_leaf = m_env & (kind >= 0)
    sf, env_leaf = append_node(sf, need_leaf, int(SymOp.FREE), kind, bsel)

    unknown_addr = (s[0] != 0) | ~known_acct
    code_unknown = known_acct & (
        sf.base.acct_field(sf.base.acct_code, acct_slot) == CODE_UNKNOWN)
    if spec.calldata:
        cd_beyond_window = is_cdload & (s[0] == 0) & beyond & at_top
    else:
        cd_beyond_window = torch.zeros_like(is_cdload)
    env_hv_need = m_env & (
        (is_cdload & (s[0] != 0))
        | cd_beyond_window
        | (is_balance & unknown_addr)
        | (op == 0x40)  # BLOCKHASH
        | (((op == 0x3B) | (op == 0x3F)) & (unknown_addr | code_unknown))
    )
    sub = ~at_top
    cv_sub = m_env & (op == 0x34) & sub
    CDW = sf.cd_sym.shape[1]
    cw = torch.div(off64, 32, rounding_mode="floor").to(I32)
    cd_al = (off64 % 32) == 0

    def _cd_sym_at(w):
        v = _take1(sf.cd_sym, w)
        return torch.where((w >= 0) & (w < CDW), v, 0)

    cda = _cd_sym_at(cw)
    cdb = _cd_sym_at(cw + 1)
    cd_sub = m_env & is_cdload & sub & (s[0] == 0)
    hv_cd_need = cd_sub & (sf.cd_havoc | (~cd_al & ((cda != 0) | (cdb != 0))))

    env_hv_need = env_hv_need | hv_cd_need
    sf, env_hv = _havoc(sf, env_hv_need)
    cl_sub = m_env & (op == 0x33) & sub & (sf.caller_sym != 0)
    r_env = torch.where(need_leaf, env_leaf, 0)
    r_env = torch.where(cv_sub, sf.callvalue_sym, r_env)
    r_env = torch.where(cl_sub, sf.caller_sym, r_env)
    r_env = torch.where(cd_sub & cd_al & ~sf.cd_havoc, cda, r_env)
    r_env = torch.where(env_hv_need, env_hv, r_env)
    sf = sf.replace(origin_read=sf.origin_read | (m_env & (op == 0x32)))

    # ---- CLS_SHA3 (concrete args): keccak chain over the hashed window ----
    m_sha = m & (cls == ci.CLS_SHA3)
    ln64 = u256.to_u64_saturating(a[1])
    w0 = torch.div(off64, 32, rounding_mode="floor").to(I32)
    NCW = (ci.MAX_HASH_BYTES + 31 + 31) // 32
    nw = torch.clamp(torch.div(off64 % 32 + ln64 + 31, 32, rounding_mode="floor"),
                     0, NCW).to(I32)
    wsyms = [_take_word_sym(sf.mem_sym, w0 + k) for k in range(NCW)]
    in_win = [(k < nw) for k in range(NCW)]
    any_w_sym = torch.zeros_like(m_sha)
    for k in range(NCW):
        any_w_sym = any_w_sym | (in_win[k] & (wsyms[k] != 0))
    fits_chain = (off64 % 32 + ln64) <= 32 * NCW
    m_hvsha = m_sha & (ln64 > 0) & (sf.mem_havoc | (any_w_sym & ~fits_chain))
    m_chain = m_sha & any_w_sym & ~sf.mem_havoc & fits_chain
    sf, sha_hv = _havoc(sf, m_hvsha)
    seed_imm = torch.zeros((P, 8), dtype=I64, device=dev)
    seed_imm[:, 0] = torch.clamp(ln64, 0, 2**31)
    seed_imm[:, 1] = off64 % 32
    sf, chain = append_node(sf, m_chain, int(SymOp.KECCAK_SEED), 0, 0, seed_imm)
    M = f.memory.shape[1]
    for k in range(NCW):
        mk = m_chain & in_win[k]
        w_conc = ci._be_bytes_to_word(
            ci._gather_bytes(sf.base.memory, (w0 + k).to(I64) * 32, 32,
                             torch.full_like(off64, M)))
        imm_k = torch.where((wsyms[k] == 0)[:, None], w_conc, 0)
        sf, chain2 = append_node(sf, mk, int(SymOp.KECCAK_ABS), chain, wsyms[k], imm_k)
        chain = torch.where(mk, chain2, chain)
    sf, dig = append_node(sf, m_chain, int(SymOp.KECCAK), chain, 0)
    r_sha = torch.where(m_hvsha, sha_hv, torch.where(m_chain, dig, 0))

    # ---- CLS_MEM (concrete offsets) ----
    m_mem = m & (cls == ci.CLS_MEM)
    is_load = op == 0x51
    is_store8 = op == 0x53
    aligned = (off64 % 32) == 0
    wm = torch.div(off64, 32, rounding_mode="floor").to(I32)
    wsym_a = _take_word_sym(sf.mem_sym, wm)
    wsym_b = _take_word_sym(sf.mem_sym, wm + 1)
    load_sym_needed = m_mem & is_load & (
        (aligned & ((wsym_a != 0) | sf.mem_havoc))
        | (~aligned & ((wsym_a != 0) | (wsym_b != 0) | sf.mem_havoc)))
    hv_load_need = load_sym_needed & (~aligned | sf.mem_havoc)
    st_mask = m_mem & ~is_load
    un_any = st_mask & ~is_store8 & ~aligned & (
        (s[1] != 0) | (wsym_a != 0) | (wsym_b != 0) | sf.mem_havoc)
    sf, hv_a = _havoc(sf, hv_load_need | un_any)
    r_mload = torch.where(load_sym_needed,
                          torch.where(aligned & ~sf.mem_havoc, wsym_a, hv_a), 0)
    mstore_aligned = st_mask & ~is_store8 & aligned
    mem_sym = _set_word_sym(sf.mem_sym, wm, s[1], mstore_aligned)
    sf, hv_b = _havoc(sf, un_any)
    mem_sym = _set_word_sym(mem_sym, wm, hv_a, un_any)
    mem_sym = _set_word_sym(mem_sym, wm + 1, hv_b, un_any)
    m8_any = st_mask & is_store8 & ((s[1] != 0) | (wsym_a != 0) | sf.mem_havoc)
    sf, hv_c = _havoc(sf, m8_any)
    mem_sym = _set_word_sym(mem_sym, wm, hv_c, m8_any)
    sf = sf.replace(mem_sym=mem_sym)

    # ---- CLS_COPY (concrete args) ----
    m_cp = m & (cls == ci.CLS_COPY)
    is_ext = op == 0x3C
    dst64 = torch.where(is_ext, u256.to_u64_saturating(a[1]), off64)
    cln64 = u256.to_u64_saturating(torch.where(is_ext[:, None], a[3], a[2]))
    is_cdcopy = op == 0x37
    is_rdcopy = op == 0x3E
    cd_symbolic = torch.where(
        at_top, torch.full_like(sf.cd_havoc, bool(spec.calldata)),
        sf.cd_havoc | torch.any(sf.cd_sym != 0, dim=1))
    cd_havoc = m_cp & (cln64 > 0) & (
        (is_cdcopy & cd_symbolic) | (is_rdcopy & sf.retdata_sym))
    ext_unknown = is_ext & code_unknown
    conc_src = (m_cp & ~is_cdcopy & ~(is_rdcopy & sf.retdata_sym)
                & (cln64 > 0) & ~ext_unknown)
    W = sf.mem_sym.shape[1]
    wids = torch.arange(W, device=dev)[None, :]
    fdiv = lambda x: torch.div(x, 32, rounding_mode="floor")
    full_lo = fdiv(dst64 + 31)[:, None]
    full_hi = fdiv(dst64 + cln64)[:, None]
    full_cover = (wids >= full_lo) & (wids < full_hi) & conc_src[:, None]
    mem_sym2 = torch.where(full_cover, 0, sf.mem_sym)
    edge_lo = fdiv(dst64)[:, None]
    edge_hi = fdiv(dst64 + cln64)[:, None]
    edge = ((wids == edge_lo) | (wids == edge_hi)) & ~full_cover & conc_src[:, None]
    edge_dirty = torch.any(edge & (sf.mem_sym != 0), dim=1)
    sf = sf.replace(
        mem_sym=mem_sym2,
        mem_havoc=sf.mem_havoc | cd_havoc | (conc_src & edge_dirty)
        | (m_cp & ext_unknown & (cln64 > 0)),
    )

    # ---- CLS_HALT: capture return-payload syms; SELFDESTRUCT beneficiary ----
    m_halt = m & (cls == ci.CLS_HALT)
    has_data = (op == 0xF3) | (op == 0xFD)
    rv_words = sf.rv_sym.shape[1]
    cap_ok = m_halt & has_data & aligned & ~sf.mem_havoc
    rv_cols = []
    for k in range(rv_words):
        in_rv = (k * 32) < ln64
        rv_cols.append(torch.where(cap_ok & in_rv, _take_word_sym(sf.mem_sym, wm + k),
                                   sf.rv_sym[:, k]))
    rv_sym = torch.stack(rv_cols, dim=1)
    is_sd = op == 0xFF
    is_inv = op == 0xFE
    first_inv = m_halt & is_inv & (sf.inv_pc < 0)
    first_sd = m_halt & is_sd & (sf.sd_pc < 0)

    # SELFDESTRUCT balance sweep: a concrete beneficiary in the account
    # table is credited and the executing account zeroed
    fb = sf.base
    m_sd = m_halt & is_sd
    ben_found, ben_slot = fb.acct_lookup(a[0])
    sweep = m_sd & (s[0] == 0) & ben_found & (ben_slot != fb.cur_acct)
    A_sd = fb.acct_used.shape[1]
    ben_bal = fb.acct_field(fb.acct_bal, ben_slot)
    self_bal = fb.self_balance
    acct_bal_sd = ci._write_slot(fb.acct_bal, torch.where(sweep, ben_slot, A_sd),
                                 u256.add(ben_bal, self_bal))
    acct_bal_sd = ci._write_slot(acct_bal_sd, torch.where(m_sd, fb.cur_acct, A_sd),
                                 torch.zeros_like(self_bal))
    sf = sf.replace(base=fb.replace(acct_bal=acct_bal_sd),
                    bal_epoch=sf.bal_epoch + m_sd.to(I32))

    sf = sf.replace(
        rv_sym=rv_sym,
        sd_to_sym=torch.where(m_halt & is_sd, s[0], sf.sd_to_sym),
        sd_to=torch.where((m_halt & is_sd)[:, None], a[0], sf.sd_to),
        sd_pc=torch.where(first_sd, sf.base.pc, sf.sd_pc),
        sd_cid=torch.where(first_sd, sf.base.contract_id, sf.sd_cid),
        inv_pc=torch.where(first_inv, sf.base.pc, sf.inv_pc),
        inv_cid=torch.where(first_inv, sf.base.contract_id, sf.inv_cid),
    )

    # ---- CLS_LOG: sym overlay of the record the concrete handler wrote ----
    m_log = m & (cls == ci.CLS_LOG)
    LS = sf.base.log_pc.shape[1]
    log_idx = sf.base.n_logs - 1
    wl = torch.where(m_log & (log_idx >= 0) & (log_idx < LS), log_idx, LS)
    d0_sym = torch.where(aligned & ~sf.mem_havoc, wsym_a, -1)
    d0_sym = torch.where(u256.to_u64_saturating(a[1]) == 0, 0, d0_sym)
    log_nt = op - 0xA0
    sf = sf.replace(
        log_topic0_sym=ci._write_slot(sf.log_topic0_sym, wl,
                                      torch.where(log_nt >= 1, s[2], 0)),
        log_data0_sym=ci._write_slot(sf.log_data0_sym, wl, d0_sym),
    )

    # ---- write result syms into the result slot (clears stale ids) ----
    r = torch.zeros_like(op)
    r = torch.where(m_node, r_bin, r)
    r = torch.where(m_env, r_env, r)
    r = torch.where(m_sha, r_sha, r)
    r = torch.where(m_mem & is_load, r_mload, r)
    sf, hv_mod = _havoc(sf, m_mod_sym)
    r = torch.where(m_mod_sym, hv_mod, r)
    writes_result = m_bin | m_mod | m_env | m_sha | (m_mem & is_load)
    return sf.replace(
        stack_sym=_set_sym_slot(sf.stack_sym, pre_sp - sin, r, writes_result))


# ---------------------------------------------------------------------------
# Superstep / forking / run loop
# ---------------------------------------------------------------------------

# host-read predicate slots of sym_superstep (one transfer per superstep)
_P_STORAGE, _P_JUMP, _P_CALLISH, _P_MISC, _P_FRAMES = 16, 17, 18, 19, 20


def sym_superstep(sf: SymFrontier, env: Env, corpus: Corpus,
                  spec: SymSpec = SymSpec(),
                  limits: LimitsConfig = DEFAULT_LIMITS) -> SymFrontier:
    """Advance every running lane by one instruction, symbolically."""
    if limits.gas_schedule == "berlin":
        raise UnsupportedOperation("the berlin gas schedule is not supported by this engine")
    f, op, run, old_pc = ci.prologue(sf.base, corpus)
    sf = sf.replace(base=f)
    tb = ci._tab(op)
    cls = tb.CLASS[op.long()]
    pre_sp = f.sp
    pre_stack_sym = sf.stack_sym
    a = [ci._peek(f, i) for i in range(4)]
    s = [_peek_sym(sf, i) for i in range(7)]

    is_jumpi = op == 0x57
    known, ksign = _lookup_constraint(sf, s[1])
    claim_jump = run & (cls == ci.CLS_JUMP) & ((s[0] != 0) | (is_jumpi & (s[1] != 0)))
    claim_storage = run & (cls == ci.CLS_STORAGE)
    claim_callish = run & ((cls == ci.CLS_CALL) | (cls == ci.CLS_CREATE))
    claim_memoff = run & (cls == ci.CLS_MEM) & (s[0] != 0)
    claim_sha3off = run & (cls == ci.CLS_SHA3) & ((s[0] != 0) | (s[1] != 0))
    is_ext = op == 0x3C
    claim_copyoff = run & (cls == ci.CLS_COPY) & (
        (s[0] != 0) | (s[1] != 0) | (s[2] != 0) | (is_ext & (s[3] != 0)))
    has_data_halt = (op == 0xF3) | (op == 0xFD)
    claim_haltoff = run & (cls == ci.CLS_HALT) & has_data_halt & ((s[0] != 0) | (s[1] != 0))
    claim_logoff = run & (cls == ci.CLS_LOG) & ((s[0] != 0) | (s[1] != 0))
    misc = claim_memoff | claim_sha3off | claim_copyoff | claim_haltoff | claim_logoff
    claimed = claim_jump | claim_storage | claim_callish | misc

    # every cond predicate of this superstep in ONE device->host read
    preds = ci.host_list(torch.cat([
        ci.class_present(op, run & ~claimed),
        torch.stack([claim_storage.any(), claim_jump.any(), claim_callish.any(),
                     misc.any(), (sf.base.depth > 0).any()])]))
    if preds[_P_CALLISH] or preds[_P_FRAMES]:
        raise UnsupportedOperation(
            "a lane reached CALL/CALLCODE/DELEGATECALL/STATICCALL/CREATE/CREATE2: "
            "call frames are not supported by this engine")

    f = ci.dispatch(sf.base, env, corpus, op, run, old_pc, skip=claimed,
                    present=preds[:ci.N_CLASSES])
    sf = sf.replace(base=f)
    sf = _overlay(sf, env, spec, op, run & ~claimed, cls, pre_sp,
                  pre_stack_sym, a, s, limits)

    if preds[_P_STORAGE]:
        sf, st_aux = _h_sym_storage(sf, spec, op, claim_storage)
        # shared claimed writeback: the SLOAD result lands here, and sp for
        # all storage-claimed lanes advances by the arity table
        fb = sf.base
        sf = sf.replace(
            base=fb.replace(
                stack=ci._set_slot(fb.stack, fb.sp - 1, st_aux["r"], st_aux["w"]),
                sp=torch.where(claim_storage, fb.sp + tb.D_SP[op.long()], fb.sp),
            ),
            stack_sym=_set_sym_slot(sf.stack_sym, fb.sp - 1, st_aux["r_sym"], st_aux["w"]),
        )
    if preds[_P_JUMP]:
        sf = _h_sym_jump(sf, corpus, op, claim_jump, old_pc, known, ksign)
    if preds[_P_MISC]:
        sf = _h_sym_claimed_misc(sf, op, claim_memoff, claim_sha3off, claim_copyoff,
                                 claim_haltoff, claim_logoff)

    # bounded loops: any jump that landed at-or-before its own pc (the
    # fork-taken copies are counted in expand_forks)
    fb = sf.base
    back = run & (cls == ci.CLS_JUMP) & ~fb.halted & ~fb.error & (fb.pc <= old_pc)
    sf = _note_backjump(sf, back, old_pc, fb.pc, limits.loop_bound)
    # no lane can end a sub-frame here (none is ever pushed), so the JAX
    # engine's pop_frames step has nothing to do
    return sf.replace(base=ci.epilogue(sf.base, op, run, old_pc))


def between_txs(sf: SymFrontier, require_mutation: bool = True,
                new_contract_id=None,
                dependency_prune: bool = True,
                first_message_tx: int = 0) -> SymFrontier:
    """Advance surviving lanes to the next symbolic transaction: a lane
    proceeds iff it halted normally AND mutated storage (MutationPruner)
    and, after the first message call, read a prior tx's write
    (DependencyPruner). Per-tx machine state resets; storage, the tape and
    path constraints carry over; per-tx event records reset."""
    from ..core.frontier import ACCT_ATTACKER, ATTACKER_ADDRESS

    b = sf.base
    P = sf.n_lanes
    go = b.active & b.halted & ~b.error & ~b.reverted & ~b.selfdestructed
    if require_mutation:
        go = go & torch.any(b.st_written, dim=1)
    if dependency_prune:
        go = go & ((sf.tx_id <= first_message_tx) | sf.dep_read)
    if new_contract_id is None:
        new_home = b.home_contract
    else:
        new_home = torch.as_tensor(new_contract_id, dtype=b.home_contract.dtype,
                                   device=b.pc.device).expand(P)
    attacker = u256.word(ATTACKER_ADDRESS, b.pc.device).expand(P, 8)
    g1 = go[:, None]
    g2 = go[:, None, None]
    A = b.warm_acct.shape[1]
    aids = torch.arange(A, device=b.pc.device)[None, :]
    z = torch.zeros_like
    return sf.replace(
        base=b.replace(
            active=go,
            halted=z(b.halted),
            err_code=z(b.err_code),
            reverted=z(b.reverted),
            pc=torch.where(go, 0, b.pc),
            stack=torch.where(g2, 0, b.stack),
            sp=torch.where(go, 0, b.sp),
            depth=torch.where(go, 0, b.depth),
            sp_base=torch.where(go, 0, b.sp_base),
            static=torch.where(go, False, b.static),
            cur_acct=torch.where(go, b.home_acct, b.cur_acct),
            home_contract=torch.where(go, new_home, b.home_contract),
            contract_id=torch.where(go, new_home, b.contract_id),
            caller_addr=torch.where(g1, attacker, b.caller_addr),
            callvalue=torch.where(g1, 0, b.callvalue),
            memory=torch.where(g1, 0, b.memory),
            mem_words=torch.where(go, 0, b.mem_words),
            gas_min=torch.where(go, 0, b.gas_min),
            gas_max=torch.where(go, 0, b.gas_max),
            calldata_len=torch.where(go, b.calldata.shape[1], b.calldata_len),
            returndata_len=torch.where(go, 0, b.returndata_len),
            retval_len=torch.where(go, 0, b.retval_len),
            n_logs=torch.where(go, 0, b.n_logs),
            log_pc=torch.where(g1, 0, b.log_pc),
            log_cid=torch.where(g1, 0, b.log_cid),
            log_ntopics=torch.where(g1, 0, b.log_ntopics),
            log_topic0=torch.where(g2, 0, b.log_topic0),
            log_data0=torch.where(g2, 0, b.log_data0),
            st_written=torch.where(g1, False, b.st_written),
            init_depth=torch.where(go, 0, b.init_depth),
            init_len=torch.where(go, 0, b.init_len),
            warm_acct=torch.where(g1, (aids == ACCT_ATTACKER) | (aids == b.home_acct[:, None]),
                                  b.warm_acct),
            st_warm=torch.where(g1, False, b.st_warm),
        ),
        stack_sym=torch.where(g1, 0, sf.stack_sym),
        mem_sym=torch.where(g1, 0, sf.mem_sym),
        mem_havoc=torch.where(go, False, sf.mem_havoc),
        retdata_sym=torch.where(go, False, sf.retdata_sym),
        rv_sym=torch.where(g1, 0, sf.rv_sym),
        rv_havoc=torch.where(go, False, sf.rv_havoc),
        cd_from_mem=torch.where(go, False, sf.cd_from_mem),
        cd_havoc=torch.where(go, False, sf.cd_havoc),
        cd_sym=torch.where(g1, 0, sf.cd_sym),
        callvalue_sym=torch.where(go, 0, sf.callvalue_sym),
        caller_sym=torch.where(go, 0, sf.caller_sym),
        bal_epoch=sf.bal_epoch + go.to(I32),
        sub_revert_pc=torch.where(go, -1, sf.sub_revert_pc),
        sub_revert_cid=torch.where(go, 0, sf.sub_revert_cid),
        tx_id=torch.where(go, sf.tx_id + 1, sf.tx_id),
        sym_jump_dest=torch.where(go, 0, sf.sym_jump_dest),
        sym_jump_pc=torch.where(go, -1, sf.sym_jump_pc),
        sym_jump_cid=torch.where(go, 0, sf.sym_jump_cid),
        n_calls=z(sf.n_calls),
        n_mut_calls=z(sf.n_mut_calls),
        call_op=torch.where(g1, 0, sf.call_op),
        call_to=torch.where(g2, 0, sf.call_to),
        call_to_sym=torch.where(g1, 0, sf.call_to_sym),
        call_value=torch.where(g2, 0, sf.call_value),
        call_value_sym=torch.where(g1, 0, sf.call_value_sym),
        call_pc=torch.where(g1, 0, sf.call_pc),
        call_cid=torch.where(g1, 0, sf.call_cid),
        log_topic0_sym=torch.where(g1, 0, sf.log_topic0_sym),
        log_data0_sym=torch.where(g1, 0, sf.log_data0_sym),
        origin_read=torch.where(go, False, sf.origin_read),
        inv_pc=torch.where(go, -1, sf.inv_pc),
        inv_cid=torch.where(go, 0, sf.inv_cid),
        sstore_after_call_pc=torch.where(go, -1, sf.sstore_after_call_pc),
        sstore_ac_cid=torch.where(go, 0, sf.sstore_ac_cid),
        arb_key_node=torch.where(go, 0, sf.arb_key_node),
        arb_key_pc=torch.where(go, -1, sf.arb_key_pc),
        arb_key_cid=torch.where(go, 0, sf.arb_key_cid),
        dropped_forks=z(sf.dropped_forks),
        call_enum=z(sf.call_enum),
        fork_cslot=torch.full_like(sf.fork_cslot, -1),
        n_arith=z(sf.n_arith),
        arith_op=torch.where(g1, 0, sf.arith_op),
        arith_a=torch.where(g1, 0, sf.arith_a),
        arith_b=torch.where(g1, 0, sf.arith_b),
        arith_r=torch.where(g1, 0, sf.arith_r),
        arith_pc=torch.where(g1, 0, sf.arith_pc),
        arith_cid=torch.where(g1, 0, sf.arith_cid),
        killed_infeasible=z(sf.killed_infeasible),
        lb_key=torch.where(g1, -1, sf.lb_key),
        lb_cnt=torch.where(g1, 0, sf.lb_cnt),
        lb_len=torch.where(go, 0, sf.lb_len),
        dep_read=torch.where(go, False, sf.dep_read),
    )


def plan_fork_map(req, free):
    """The packed, fifo fork source->destination mapping of the JAX
    ``plan_fork_map`` (single block): free slot j with free-rank t copies
    from the t-th requesting lane in lane order. Returns ``(src [P],
    is_copy [P], slot [P])`` — ``slot == P`` marks a starved request."""
    P = req.shape[0]
    dev = req.device
    loc = torch.arange(P, dtype=I32, device=dev)
    req_i = req.to(I32)
    rank = torch.cumsum(req_i, 0, dtype=I32) - req_i
    n_free = free.to(I32).sum()
    # requesters in lane order; P pads the tail (never gathered: free_rank
    # < n_admit <= n_req keeps the index in range)
    order = torch.sort(torch.where(req, loc, P), stable=True).values
    n_req = req_i.sum()
    n_admit = torch.minimum(n_free, n_req)
    free_i = free.to(I32)
    free_rank = torch.cumsum(free_i, 0, dtype=I32) - free_i
    is_copy = free & (free_rank < n_admit)
    src_i = order[torch.clamp(free_rank, 0, P - 1).long()]
    src = torch.where(is_copy, src_i, loc)
    slot = torch.where(req & (rank < n_free), 0, P).to(I32)
    return src, is_copy, slot


def _gather_lanes(x, src):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x[src]


def expand_forks(sf: SymFrontier, loop_bound: int = 0,
                 defer_starved: bool = False) -> SymFrontier:
    """Materialize fork requests: copy each forking lane into a free lane,
    point the copy at the jump target, and flip its final path-condition
    sign to "taken". Forks beyond capacity are counted in
    ``dropped_forks``, or with ``defer_starved`` un-execute their branch
    decision and retry next superstep. One block (``fork_block=0``),
    ``fifo`` admission, the ``packed`` mapping."""
    P = sf.n_lanes
    req = sf.fork_req & sf.base.active
    free = ~sf.base.active
    src, is_copy, slot = plan_fork_map(req, free)
    srcl = src.long()

    def gather_struct(st):
        import dataclasses

        kw = {}
        for fl in dataclasses.fields(st):
            v = getattr(st, fl.name)
            if fl.name == "base":
                kw[fl.name] = gather_struct(v)
            else:
                kw[fl.name] = _gather_lanes(v, srcl)
        return type(st)(**kw)

    new = gather_struct(sf)
    b = new.base
    C = new.con_sign.shape[1]
    last = ((torch.arange(C, device=src.device)[None, :] == (new.con_len - 1)[:, None])
            & is_copy[:, None])
    starved = req & (slot == P)
    n_dropped = torch.zeros(P, dtype=I32, device=src.device) if defer_starved \
        else starved.to(I32)
    dropped = torch.where(is_copy, 0, new.dropped_forks) + n_dropped
    back_copy = is_copy & (new.fork_dest < b.pc)
    cs = new.fork_cslot
    S = b.stack.shape[1]
    cidx = torch.where(is_copy & (cs >= 0) & (cs < S), cs, S)
    stack_c = ci._write_slot(b.stack, cidx, new.fork_cval)
    stack_sym_c = ci._write_slot(new.stack_sym, cidx, 0)

    is_cf = cs >= 0  # call-enumeration fork (never raised by this engine)
    if defer_starved:
        pc_new = torch.where(is_copy, new.fork_dest,
                             torch.where(starved & ~is_cf, b.pc - 1, b.pc))
        sp_new = torch.where(starved & ~is_cf, b.sp + 2, b.sp)
        con_len_new = new.con_len - starved.to(I32)
        g_undo = torch.where(starved & ~is_cf, 10, 0).to(b.gas_min.dtype)
        b = b.replace(gas_min=b.gas_min - g_undo, gas_max=b.gas_max - g_undo)
        call_enum_new = torch.where(is_copy, 0, new.call_enum - (starved & is_cf).to(I32))
        fork_req_new = starved
    else:
        pc_new = torch.where(is_copy, new.fork_dest, b.pc)
        sp_new = b.sp
        con_len_new = new.con_len
        call_enum_new = torch.where(is_copy, 0, new.call_enum)
        fork_req_new = torch.zeros_like(new.fork_req)
    new = new.replace(
        base=b.replace(pc=pc_new, sp=sp_new, active=b.active | is_copy, stack=stack_c),
        stack_sym=stack_sym_c,
        con_sign=torch.where(last, True, new.con_sign),
        con_len=con_len_new,
        fork_req=fork_req_new,
        fork_cslot=torch.full_like(new.fork_cslot, -1),
        fork_cval=torch.zeros_like(new.fork_cval),
        call_enum=call_enum_new,
        dropped_forks=dropped,
        dropped_total=new.dropped_total + n_dropped.sum(dtype=I32),
    )
    return _note_backjump(new, back_copy, b.pc - 1, new.fork_dest, loop_bound)


def rebalance_parked(sf: SymFrontier):
    """The JAX ``rebalance_parked`` moves a parked lane only into ANOTHER
    block with >= 2 free slots, and only when its own block has none.
    With one block (``fork_block=0``, the only layout of this engine) the
    lane's own block is the best block: it either has a free slot (the
    lane is skipped) or has none (then the best block has < 2 and the
    lane is skipped too). So it moves nothing, and this returns
    ``(sf, 0)`` without reading the frontier."""
    return sf, 0


# lanes run by every superstep so far and the supersteps themselves (read
# from the loop's own per-step check, so they cost no extra sync). With
# ENGINE_STATS["timing"] set, each stage of the loop is also timed on the
# host clock between device synchronizations (a measurement mode: the
# extra syncs slow the loop down).
ENGINE_STATS = {"lane_steps": 0, "supersteps": 0, "timing": False,
                "superstep_s": 0.0, "forks_s": 0.0, "propagate_s": 0.0}


def _stage(key, fn, *args):
    if not ENGINE_STATS["timing"]:
        return fn(*args)
    import time

    dev = args[0].tape_op.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ENGINE_STATS[key] += time.perf_counter() - t0
    return out


def sym_run(sf: SymFrontier, env: Env, corpus: Corpus,
            spec: SymSpec = SymSpec(),
            limits: LimitsConfig = DEFAULT_LIMITS,
            max_steps: int = 256,
            propagate_every=None,
            track_coverage: bool = False,
            defer_starved: bool = False):
    """Run the symbolic engine until quiescence or ``max_steps``
    supersteps (the JAX ``_sym_run_impl`` with ``fork_block=0``, ``fifo``
    and the ``packed`` fork map). ``propagate_every`` > 0 interleaves
    feasibility sweeps; None uses ``limits.propagate_every``; the cadence
    counts from this call's first step. With ``track_coverage`` a
    ``bool[C, MAX_CODE]`` visited-pc bitmap is returned too.

    The JAX ``while_loop``'s ``any(running)`` condition is one host read
    per step (of the running-lane count), the fork-expansion cond one more."""
    from .propagate import kill_infeasible

    if propagate_every is None:
        propagate_every = limits.propagate_every
    C, MC = corpus.code.shape
    # row C of the bitmap takes the lanes that write nowhere
    visited = torch.zeros((C + 1, MC), dtype=torch.bool, device=sf.tape_op.device)
    for i in range(max_steps):
        n_running = ci.host_list(sf.base.running.sum())
        if not n_running:
            break
        ENGINE_STATS["lane_steps"] += n_running
        ENGINE_STATS["supersteps"] += 1
        if track_coverage:
            b = sf.base
            run = b.running & ~b.exec_init
            cid = torch.where(run, b.contract_id, C).long()
            pc = torch.clamp(b.pc, 0, MC - 1).long()
            visited[cid, pc] = True
        sf = _stage("superstep_s", sym_superstep, sf, env, corpus, spec, limits)
        if ci.host_bool(torch.any(sf.fork_req & sf.base.active)):
            sf = _stage("forks_s", expand_forks, sf, limits.loop_bound, defer_starved)
        if propagate_every and (i % propagate_every) == propagate_every - 1:
            sf = _stage("propagate_s", kill_infeasible, sf)
    if track_coverage:
        return sf, visited[:C]
    return sf
