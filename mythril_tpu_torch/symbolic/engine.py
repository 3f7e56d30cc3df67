"""The symbolic superstep: concrete dispatch + sym-id overlay + forking.

PyTorch counterpart of the JAX package's ``symbolic/engine.py`` (the
``packed`` fork map, every fork policy and block size, both gas
schedules, the instruction profiler):

- lanes whose current opcode touches symbolic control/addresses are
  *claimed* out of the concrete dispatch and handled by sym-aware
  handlers (storage, jumps, symbolic-offset memory ops);
- everything else runs the concrete handler unchanged, and a vectorized
  overlay keeps ``stack_sym``/``mem_sym`` in sync and appends tape nodes
  (kernel K3 on the card, see :func:`append_node`);
- a symbolic JUMPI records a fork request; :func:`expand_forks` copies
  requesting lanes into free lanes of their fork block in the policy's
  order (in place, inside ``sym_run``: kernel K7 on the card plans, copies
  the rows and fixes them up, :func:`expand_forks_inplace`; the plain
  functional gather :func:`expand_forks_plain` is its reference); starved
  lanes park and move
  between blocks at chunk seams (:func:`rebalance_parked`) or in the loop
  (:func:`migrate_parked_device`);
- the berlin schedule adds EIP-2929 cold surcharges around dispatch
  (:func:`_berlin_gas_pre`/:func:`_berlin_gas_post`);
- CALL/CALLCODE/DELEGATECALL/STATICCALL push real sub-frames (or run a
  precompile 0x1-0x9: SHA-256 and MODEXP on kernels K4/K5, ecrecover and
  the other natives through one host round trip); CREATE/CREATE2 run the
  init code in a constructor frame; :func:`pop_frames` returns ended
  frames to their callers with rollback on failure.

Where the JAX code wraps a handler in ``lax.cond(any(mask))`` /
``narrow_cond``, this code reads the predicates back to the host (one
transfer for all of them per superstep, plus one in a superstep that may
run a precompile or push a constructor frame) and runs the handler only
when its JAX cond would have been taken — the same results, without the
TPU-specific boundary machinery.

Over-approximation policy (unchanged): wherever byte-exact symbolic
tracking is not worth the shapes, the result is a fresh unconstrained
HAVOC leaf — never a wrong value.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..config import LimitsConfig, DEFAULT_LIMITS
from ..core import interpreter as ci
from ..core.frontier import Env, Corpus, Trap, CODE_UNKNOWN, KILL_TRAPS, first_true
from ..ops import u256
from .ops import SymOp, FreeKind, TX_STRIDE, BAL_STRIDE
from .state import SymFrontier, SymSpec, tape_row_hash, hash_bits

I32 = torch.int32
I64 = torch.int64
M32 = u256.MASK32


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

    Kernel K3 on a CUDA frontier (through the loop's descriptor inside
    ``sym_run``, see :func:`_loop_k3`), :func:`append_node_plain` on a CPU
    one. Both update the tape tensors IN PLACE (the JAX function returned
    a new tape): ``sym_run`` and ``sym_superstep`` copy the tape once on
    entry (:func:`own_loop_fields`), so their caller's frontier keeps
    its tape; a fork expansion copies a copy lane's tape rows in place."""
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

        ids, overflow = tape_append(*args, k3=_K3.get())
    elif not bool(mask.any()):
        # nothing to append (the common case for most of the overlay's
        # appends): ids 0, no write, no trap — reading the mask costs
        # nothing on the CPU, unlike a device sync
        return sf, torch.zeros(P, dtype=I32, device=dev)
    else:
        ids, overflow = append_node_plain(*args)
    return sf.replace(base=sf.base.trap(overflow, Trap.TAPE_LIMIT)), ids


def append_group_plain(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                       op, a, b, a_src, b_src, imm, mask):
    """Plain version of K3's group entry point, and the definition of its
    meaning: R sequential :func:`append_node_plain` calls, one per column
    of the ``[P, R]`` inputs (``imm`` ``[P, R, 8]``). Row r's operand is
    the literal ``a[:, r]`` unless ``a_src[:, r]`` names an earlier row s
    (0 <= s < r): then it is row s's output, which is the row's id where
    ``mask[:, s]`` is set (0 on overflow) and its resolved ``a`` where not.
    Returns (outputs int32[P, R], overflow bool[P]: any row overflowed)
    and updates the tape tensors in place.

    A row no lane appends is skipped (the call would change nothing), and
    a source all lanes share (the call sites' row constants) is resolved
    without a gather: a few host reads up front, which cost nothing on
    the CPU."""
    P, R = op.shape
    lanes = ci._lanes(tape_len)
    on = mask.any(dim=0).tolist()
    shared = [[f if same else None for f, same in zip(src[0].tolist(),
                                                      (src == src[:1]).all(dim=0).tolist())]
              for src in (a_src, b_src)]
    outs = []
    overflow = torch.zeros(P, dtype=torch.bool, device=op.device)

    def resolve(lit, src, s, r):
        if s is not None:
            return outs[s] if 0 <= s < r else lit
        if r == 0:
            return lit
        prev = torch.stack(outs, dim=1)[lanes, torch.clamp(src, 0, r - 1).long()]
        return torch.where((src >= 0) & (src < r), prev, lit)

    for r in range(R):
        ar = resolve(a[:, r], a_src[:, r], shared[0][r], r)
        br = resolve(b[:, r], b_src[:, r], shared[1][r], r)
        if on[r]:
            m = mask[:, r]
            ids, ovf = append_node_plain(tape_op, tape_a, tape_b, tape_imm, tape_hash, tape_len,
                                         op[:, r], ar, br, imm[:, r], m)
            overflow |= ovf
            ar = torch.where(m, ids, ar)
        outs.append(ar)
    return torch.stack(outs, dim=1), overflow


def append_group(sf: SymFrontier, mask, op, a, b, a_src, b_src, imm):
    """R hash-consed appends per lane in one call, in order, with operands
    that may be earlier rows' outputs (:func:`append_group_plain` defines
    the meaning; all inputs ``[P, R]``, ``imm`` ``[P, R, 8]``). Returns
    (sf, outputs int32[P, R]); an overflow in any row traps the lane with
    ``TAPE_LIMIT`` once, as the rows' sequential traps would (the first
    cause is kept, and every row's is TAPE_LIMIT). K3's group entry point
    on a CUDA frontier, one launch; the plain version on a CPU one."""
    args = (sf.tape_op, sf.tape_a, sf.tape_b, sf.tape_imm, sf.tape_hash, sf.tape_len,
            op, a, b, a_src, b_src, imm, mask)
    if sf.tape_op.is_cuda:
        from ..kernels import tape_append_group

        out, overflow = tape_append_group(*args, k3=_K3.get())
    else:
        out, overflow = append_group_plain(*args)
    return sf.replace(base=sf.base.trap(overflow, Trap.TAPE_LIMIT)), out


_GROUP_ROWS: dict = {}


def _group_rows(values, P: int, dev):
    """int32[P, R] whose column r holds ``values[r]`` on every lane: the
    row constants of the two group call sites (ops, operand sources),
    made once per width and device."""
    key = (tuple(values), P, str(dev))
    if key not in _GROUP_ROWS:
        _GROUP_ROWS[key] = torch.tensor(values, dtype=I32, device=dev).expand(
            P, len(values)).contiguous()
    return _GROUP_ROWS[key]


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


# ---------------------------------------------------------------------------
# Call frames: CALL family, precompiles, CREATE/CREATE2, frame returns
# ---------------------------------------------------------------------------


def _fr_set(arr, d, val, mask):
    """arr[P, D, ...]; arr[lane, d[lane]] = val[lane] where mask. A new
    tensor that owns its memory (the snapshot copies ``val``)."""
    Dn = arr.shape[1]
    return ci._write_slot(arr, torch.where(mask & (d >= 0), d, Dn), val)


def _fr_get(arr, d):
    """arr[P, D, ...] gathered at per-lane depth index d (a copy)."""
    idx = torch.clamp(d, 0, arr.shape[1] - 1).long()
    return arr[ci._lanes(idx), idx]


def _record_call_event(sf: SymFrontier, m, op, old_pc, to, to_sym, value,
                       value_sym) -> SymFrontier:
    """Append to the bounded per-tx call log (detection-module feed)."""
    CL = sf.call_to.shape[1]
    onehot = _event_slot(sf.n_calls, m, CL)
    return sf.replace(
        n_calls=sf.n_calls + m.to(I32),
        n_mut_calls=sf.n_mut_calls + (
            m & ((op == 0xF1) | (op == 0xF2) | (op == 0xF4))).to(I32),
        call_to=torch.where(onehot[:, :, None], to[:, None, :], sf.call_to),
        call_to_sym=torch.where(onehot, to_sym[:, None], sf.call_to_sym),
        call_value=torch.where(onehot[:, :, None], value[:, None, :], sf.call_value),
        call_value_sym=torch.where(onehot, value_sym[:, None], sf.call_value_sym),
        call_op=torch.where(onehot, op[:, None], sf.call_op),
        call_pc=torch.where(onehot, old_pc[:, None], sf.call_pc),
        call_cid=torch.where(onehot, sf.base.contract_id[:, None], sf.call_cid),
    )


def _one_word(P, dev):
    w = torch.zeros((P, 8), dtype=I64, device=dev)
    w[:, 0] = 1
    return w


def _frame_push(f, sf: SymFrontier, d, mi, old_pc, ret_sp, ret_off, ret_len,
                pre_transfer_bal, create_slot):
    """The caller snapshot both frame kinds push at depth ``d``: the
    base fields (returned as a replace-dict) and the sym overlay fields."""
    base = dict(
        fr_gas_limit=_fr_set(f.fr_gas_limit, d, f.gas_limit, mi),
        fr_warm_acct=_fr_set(f.fr_warm_acct, d, f.warm_acct, mi),
        fr_st_warm=_fr_set(f.fr_st_warm, d, f.st_warm, mi),
        fr_ret_pc=_fr_set(f.fr_ret_pc, d, old_pc, mi),
        fr_sp=_fr_set(f.fr_sp, d, ret_sp, mi),
        fr_sp_base=_fr_set(f.fr_sp_base, d, f.sp_base, mi),
        fr_static=_fr_set(f.fr_static, d, f.static, mi),
        fr_cur_acct=_fr_set(f.fr_cur_acct, d, f.cur_acct, mi),
        fr_contract_id=_fr_set(f.fr_contract_id, d, f.contract_id, mi),
        fr_caller_addr=_fr_set(f.fr_caller_addr, d, f.caller_addr, mi),
        fr_callvalue=_fr_set(f.fr_callvalue, d, f.callvalue, mi),
        fr_memory=_fr_set(f.fr_memory, d, f.memory, mi),
        fr_mem_words=_fr_set(f.fr_mem_words, d, f.mem_words, mi),
        fr_calldata=_fr_set(f.fr_calldata, d, f.calldata, mi),
        fr_calldata_len=_fr_set(f.fr_calldata_len, d, f.calldata_len, mi),
        fr_ret_off=_fr_set(f.fr_ret_off, d, ret_off, mi),
        fr_ret_len=_fr_set(f.fr_ret_len, d, ret_len, mi),
        fr_gas_min=_fr_set(f.fr_gas_min, d, f.gas_min, mi),
        fr_gas_max=_fr_set(f.fr_gas_max, d, f.gas_max, mi),
        fr_st_keys=_fr_set(f.fr_st_keys, d, f.st_keys, mi),
        fr_st_vals=_fr_set(f.fr_st_vals, d, f.st_vals, mi),
        fr_st_used=_fr_set(f.fr_st_used, d, f.st_used, mi),
        fr_st_written=_fr_set(f.fr_st_written, d, f.st_written, mi),
        fr_st_acct=_fr_set(f.fr_st_acct, d, f.st_acct, mi),
        fr_acct_bal=_fr_set(f.fr_acct_bal, d, pre_transfer_bal, mi),
        fr_create_slot=_fr_set(f.fr_create_slot, d, create_slot, mi),
    )
    sym = dict(
        fr_caller_sym=_fr_set(sf.fr_caller_sym, d, sf.caller_sym, mi),
        fr_mem_sym=_fr_set(sf.fr_mem_sym, d, sf.mem_sym, mi),
        fr_mem_havoc=_fr_set(sf.fr_mem_havoc, d, sf.mem_havoc, mi),
        fr_cd_from_mem=_fr_set(sf.fr_cd_from_mem, d, sf.cd_from_mem, mi),
        fr_cd_havoc=_fr_set(sf.fr_cd_havoc, d, sf.cd_havoc, mi),
        fr_cd_sym=_fr_set(sf.fr_cd_sym, d, sf.cd_sym, mi),
        fr_callvalue_sym=_fr_set(sf.fr_callvalue_sym, d, sf.callvalue_sym, mi),
        fr_st_val_sym=_fr_set(sf.fr_st_val_sym, d, sf.st_val_sym, mi),
        fr_st_key_sym=_fr_set(sf.fr_st_key_sym, d, sf.st_key_sym, mi),
        fr_st_seq=_fr_set(sf.fr_st_seq, d, sf.st_seq, mi),
    )
    return base, sym


def _h_sym_call(sf: SymFrontier, op, m, old_pc, spec: SymSpec,
                maybe_pre: bool, berlin: bool = False) -> SymFrontier:
    """CALL / CALLCODE / DELEGATECALL / STATICCALL with real sub-frames
    (the JAX ``_h_sym_call``). Per lane: **internal** (a concrete callee
    with code in the corpus, concrete windows and value, depth headroom)
    pushes a frame; **eoa** (a known codeless account) is a value
    transfer with success 1; a symbolic callee enumerates the account
    table one candidate per superstep (a call-enumeration fork); a
    precompile 0x1-0x9 runs in :func:`_apply_precompiles`; everything
    else is **external**: havoc the return value and output memory.
    ``maybe_pre`` is the host-read flag that some claimed lane targets a
    concrete low address (else no lane can be a precompile call)."""
    f = sf.base
    P = f.n_lanes
    dev = op.device
    has_value = (op == 0xF1) | (op == 0xF2)  # CALL, CALLCODE
    is_call = op == 0xF1
    is_deleg = op == 0xF4
    is_static_op = op == 0xFA
    tb = ci._tab(op)
    sin = tb.STACK_IN[op.long()]
    D = f.fr_ret_pc.shape[1]
    CD = f.calldata.shape[1]
    CDW = sf.cd_sym.shape[1]
    M = f.memory.shape[1]

    # --- operand fetch (gas, to, [value], argsOff, argsLen, retOff, retLen)
    to = ci._peek(f, 1)
    to_sym = _peek_sym(sf, 1)
    value = torch.where(has_value[:, None], ci._peek(f, 2), 0)
    value_sym = torch.where(has_value, _peek_sym(sf, 2), 0)
    base_i = torch.where(has_value, 3, 2).to(I32)
    a_off_w, a_off_s = ci._peek(f, base_i), _peek_sym(sf, base_i)
    a_len_w, a_len_s = ci._peek(f, base_i + 1), _peek_sym(sf, base_i + 1)
    r_off_w, r_off_s = ci._peek(f, base_i + 2), _peek_sym(sf, base_i + 2)
    r_len_w, r_len_s = ci._peek(f, base_i + 3), _peek_sym(sf, base_i + 3)
    a_off = u256.to_u64_saturating(a_off_w)
    a_len = u256.to_u64_saturating(a_len_w)
    r_off = u256.to_u64_saturating(r_off_w)
    r_len = u256.to_u64_saturating(r_len_w)

    # CALL with nonzero (possibly) value inside STATICCALL: exceptional halt
    static_viol = m & is_call & f.static & ((value_sym != 0) | ~u256.is_zero(value))
    sf = sf.replace(base=f.trap(static_viol, Trap.STATIC_WRITE))
    f = sf.base
    m = m & ~static_viol

    # --- classification
    conc_windows = (a_off_s == 0) & (a_len_s == 0) & (r_off_s == 0) & (r_len_s == 0)
    found, slot = f.acct_lookup(to)
    callee_code = f.acct_field(f.acct_code, slot)
    value_conc = value_sym == 0
    # precompiles 0x1-0x9: concrete low address, concrete windows
    hi_zero = torch.all(to[:, 1:] == 0, dim=1)
    pid = torch.where((to_sym == 0) & hi_zero, to[:, 0].to(I32), 0)
    RD_cap = f.returndata.shape[1]
    pre = m & (pid >= 1) & (pid <= 9) & conc_windows & (a_len <= min(M, PRE_IN_CAP))
    # identity output = input: if it cannot fit the returndata buffer the
    # concrete result would truncate — demote to external havoc
    pre = pre & ~((pid == 4) & (a_len > RD_cap))
    resolvable = (m & (to_sym == 0) & found & conc_windows & value_conc
                  & (f.depth < D) & (a_len <= CD))
    internal = resolvable & (callee_code >= 0)
    eoa = resolvable & (callee_code == -1)  # CODE_UNKNOWN (-2) -> external

    # --- symbolic-callee enumeration: fork ONE candidate account per
    # superstep (the copy re-executes this CALL with the target slot
    # concretized, expand_forks); the staying lane accumulates
    # to != addr_k and falls to the external path once the table is done
    A_n = f.acct_used.shape[1]
    enumable = (m & (to_sym != 0) & conc_windows & value_conc
                & (f.depth < D) & (a_len <= CD))
    k_cand = torch.clamp(sf.call_enum, 0, A_n - 1)
    cand_valid = sf.call_enum < A_n
    slot_used = _take1(f.acct_used, k_cand)
    enum_spawn = enumable & cand_valid & slot_used & (sf.con_len < sf.con_node.shape[1])
    enum_skip = enumable & cand_valid & ~slot_used
    enum_done = enumable & ~enum_spawn & ~enum_skip
    enum_hold = enum_spawn | enum_skip
    cand_addr = f.acct_field(f.acct_addr, k_cand)
    sf, caddr_id = append_node(sf, enum_spawn, int(SymOp.CONST), 0, 0, cand_addr)
    sf, eq_id = append_node(sf, enum_spawn, int(SymOp.EQ), to_sym, caddr_id)
    sf = _append_constraint(sf, enum_spawn, eq_id, False, old_pc)
    sf = sf.replace(
        call_enum=torch.where(enum_hold, sf.call_enum + 1,
                              torch.where(enum_done, 0, sf.call_enum)),
        fork_req=sf.fork_req | enum_spawn,
        fork_dest=torch.where(enum_spawn, old_pc, sf.fork_dest),
        fork_cslot=torch.where(enum_spawn, f.sp - 2, sf.fork_cslot),
        fork_cval=torch.where(enum_spawn[:, None], cand_addr, sf.fork_cval),
    )
    f = sf.base

    # a parked lane re-executes this CALL next superstep: the prologue's
    # charge must not accumulate once per retry. The static table charges
    # the worst case; a concretely known case is refined to exact gas.
    opl = op.long()
    nonzero_val = has_value & value_conc & ~u256.is_zero(value)
    zero_val = has_value & value_conc & ~nonzero_val
    refund = torch.where(is_call & zero_val, 9000 + 25000, 0)
    refund = torch.where(is_call & nonzero_val & found & (to_sym == 0), 25000, refund)
    refund = torch.where((op == 0xF2) & zero_val, 9000, refund)
    gmin_t, gmax_t = ((tb.GAS_MIN_BERLIN, tb.GAS_MAX_BERLIN) if berlin
                      else (tb.GAS_MIN, tb.GAS_MAX))
    ext_cold = 0
    if berlin:
        # a symbolic target that exhausted enumeration resolves here
        # (external havoc) without ever paying its cold-account surcharge
        from ..disassembler.opcodes import G_COLD_ACCOUNT, G_WARM_ACCESS

        ext_sym = m & ~internal & ~eoa & ~pre & ~enum_hold & (to_sym != 0)
        ext_cold = torch.where(ext_sym, G_COLD_ACCOUNT - G_WARM_ACCESS, 0)
    f = f.replace(
        gas_min=f.gas_min - torch.where(enum_hold, gmin_t[opl], 0),
        gas_max=f.gas_max + ext_cold - torch.where(enum_hold, gmax_t[opl],
                                                   torch.where(m, refund, 0)),
    )
    if f.op_hist is not None:
        # iprof: a parked enumeration superstep is bookkeeping, not an
        # executed instance; net out epilogue's +1
        f = f.replace(op_hist=ci.hist_add(f.op_hist, op, -enum_hold.to(I32)))
    sf = sf.replace(base=f)

    external = m & ~internal & ~eoa & ~pre & ~enum_hold

    # memory expansion for the arg/ret windows (charged at call time)
    f, oob_a = ci._expand_memory(f, (internal | eoa | pre) & (a_len > 0), a_off + a_len)
    f, oob_r = ci._expand_memory(f, (internal | eoa | pre) & (r_len > 0), r_off + r_len)
    sf = sf.replace(base=f)
    oob = oob_a | oob_r
    internal = internal & ~oob
    eoa = eoa & ~oob
    pre = pre & ~oob

    # --- value transfer feasibility (concrete value; payer = executing acct)
    payer_bal = f.self_balance
    wants_value = has_value & ~u256.is_zero(value)
    insufficient = (internal | eoa) & wants_value & u256.lt(payer_bal, value)
    fail0 = insufficient  # push success=0, no frame, no transfer
    internal_go = internal & ~insufficient
    eoa_ok = eoa & ~insufficient
    # CALLCODE sends value to self (net zero); only plain CALL moves funds
    transfer = (internal_go | eoa_ok) & is_call & wants_value & (slot != f.cur_acct)
    # the rollback snapshot is PRE-transfer: a reverting call undoes it
    pre_transfer_bal = f.acct_bal
    payee_bal = f.acct_field(f.acct_bal, slot)
    payer_new = u256.sub(payer_bal, value)
    payee_new = u256.add(payee_bal, value)
    A = f.acct_used.shape[1]
    aids = torch.arange(A, device=dev)[None, :]
    payer_oh = (aids == f.cur_acct[:, None]) & transfer[:, None]
    payee_oh = (aids == slot[:, None]) & transfer[:, None]
    acct_bal = torch.where(payer_oh[:, :, None], payer_new[:, None, :], f.acct_bal)
    acct_bal = torch.where(payee_oh[:, :, None], payee_new[:, None, :], acct_bal)
    f = f.replace(acct_bal=acct_bal)
    # BALANCE reads after a transfer must not share leaves with reads before
    sf = sf.replace(base=f, bal_epoch=sf.bal_epoch + transfer.to(I32))

    # --- event record (a lane still enumerating records when it resolves)
    sf = _record_call_event(sf, m & ~enum_hold, op, old_pc, to, to_sym, value, value_sym)
    f = sf.base

    # --- external fallback: havoc retval + output region
    havoc_mem = external & ((r_len_s != 0) | ~u256.is_zero(r_len_w))
    sf, rv = append_node(sf, external, int(SymOp.FREE), int(FreeKind.RETVAL),
                         torch.clamp(sf.n_calls - 1, min=0))
    f = sf.base

    # DELEGATECALL msg.sender symbol for a top-frame push: the current
    # transaction's CALLER leaf
    deleg_caller = torch.zeros_like(to_sym)
    if spec.caller:
        need_dc = internal_go & is_deleg & (f.depth == 0)
        sf, deleg_caller = append_node(sf, need_dc, int(SymOp.FREE),
                                       int(FreeKind.CALLER), sf.tx_id)
        f = sf.base

    # --- push the result word for the non-frame paths
    dest_slot = f.sp - sin
    m_push = external | eoa_ok | fail0 | pre
    res_w = torch.where((eoa_ok | pre)[:, None], _one_word(P, dev), 0)
    stack = ci._set_slot(f.stack, dest_slot, res_w, m_push)
    res_sym = torch.where(external, rv, 0)
    stack_sym = _set_sym_slot(sf.stack_sym, dest_slot, res_sym, m_push)

    # --- frame push for internal calls. EIP-150: the callee runs under
    # used + min(gas operand, 63/64 of what remains); a symbolic gas
    # operand forwards the cap
    d = f.depth
    mi = internal_go
    gas_op = u256.to_u64_saturating(ci._peek(f, 0))
    gas_op_sym = _peek_sym(sf, 0)
    remaining = torch.clamp(f.gas_limit - f.gas_max, min=0)
    fwd_cap = remaining - torch.div(remaining, 64, rounding_mode="floor")
    fwd = torch.where(gas_op_sym == 0, torch.minimum(gas_op, fwd_cap), fwd_cap)
    base_kw, sym_kw = _frame_push(
        f, sf, d, mi, old_pc, f.sp - sin, r_off, r_len, pre_transfer_bal,
        torch.full((P,), -1, dtype=I32, device=dev))
    _count_frames("pushed", mi)

    # callee calldata: bytes of the caller's memory window
    callee_cd = ci._gather_bytes(f.memory, a_off, CD, torch.full_like(a_off, M))
    callee_cd = torch.where(torch.arange(CD, device=dev)[None, :] < a_len[:, None],
                            callee_cd, 0)
    # per-word syms: aligned windows map the caller's mem_sym; a partial
    # tail word or unaligned offset with symbolic content havocs the whole
    # frame calldata (coarse, sound)
    aligned_a = (a_off % 32) == 0
    w0 = torch.div(a_off, 32, rounding_mode="floor").to(I32)
    W = sf.mem_sym.shape[1]
    wids = torch.arange(W, device=dev)[None, :]
    win_lo = torch.div(a_off, 32, rounding_mode="floor")[:, None]
    win_hi = torch.div(a_off + a_len + 31, 32, rounding_mode="floor")[:, None]
    any_sym_window = torch.any((wids >= win_lo) & (wids < win_hi) & (sf.mem_sym != 0), dim=1)
    tail_partial = (a_len % 32) != 0
    tail_sym = tail_partial & (_take_word_sym(
        sf.mem_sym, w0 + torch.div(a_len, 32, rounding_mode="floor").to(I32)) != 0)
    cd_havoc_new = sf.mem_havoc | (~aligned_a & any_sym_window) | (aligned_a & tail_sym)
    cd_cols = []
    for w in range(CDW):
        full_cover = aligned_a & ((32 * (w + 1)) <= a_len)
        src = _take_word_sym(sf.mem_sym, w0 + w)
        cd_cols.append(torch.where(mi & full_cover & ~cd_havoc_new, src, 0))
    cd_sym_new = torch.stack(cd_cols, dim=1).to(sf.cd_sym.dtype)

    new_caller = torch.where(is_deleg[:, None], f.caller_addr, f.self_address)
    new_value = torch.where(is_deleg[:, None], f.callvalue,
                            torch.where(has_value[:, None], value, 0))
    new_value_sym = torch.where(is_deleg, sf.callvalue_sym, 0)
    # a DELEGATECALL frame inherits the caller frame's msg.sender symbol
    eff_caller_sym = sf.caller_sym
    if spec.caller:
        eff_caller_sym = torch.where(f.depth == 0, deleg_caller, eff_caller_sym)
    new_caller_sym = torch.where(is_deleg, eff_caller_sym, 0)
    keep_acct = is_deleg | (op == 0xF2)  # DELEGATECALL/CALLCODE keep storage ctx

    f2 = f.replace(
        **base_kw,
        gas_limit=torch.where(mi, f.gas_max + fwd, f.gas_limit),
        pc=torch.where(mi, 0, f.pc),
        # enum lanes stay parked on this CALL (one candidate per superstep)
        pc_hold=f.pc_hold | mi | enum_hold,
        sp=torch.where(mi | m_push, f.sp - sin + m_push.to(I32), f.sp),
        sp_base=torch.where(mi, f.sp - sin, f.sp_base),
        depth=torch.where(mi, f.depth + 1, f.depth),
        contract_id=torch.where(mi, callee_code, f.contract_id),
        cur_acct=torch.where(mi, torch.where(keep_acct, f.cur_acct, slot), f.cur_acct),
        caller_addr=torch.where(mi[:, None], new_caller, f.caller_addr),
        callvalue=torch.where(mi[:, None], new_value, f.callvalue),
        static=f.static | (mi & is_static_op),
        memory=torch.where(mi[:, None], 0, f.memory),
        mem_words=torch.where(mi, 0, f.mem_words),
        calldata=torch.where(mi[:, None], callee_cd, f.calldata),
        calldata_len=torch.where(mi, torch.clamp(a_len, 0, CD).to(I32), f.calldata_len),
        returndata_len=torch.where(mi | m_push, 0, f.returndata_len),
        stack=stack,
    )
    sf = sf.replace(
        **sym_kw,
        base=f2,
        stack_sym=stack_sym,
        mem_sym=torch.where(mi[:, None], 0, sf.mem_sym),
        mem_havoc=torch.where(mi, False, sf.mem_havoc | havoc_mem),
        retdata_sym=torch.where(mi | eoa_ok | fail0, False, sf.retdata_sym | external),
        cd_from_mem=sf.cd_from_mem | mi,
        cd_havoc=torch.where(mi, cd_havoc_new, sf.cd_havoc),
        cd_sym=torch.where(mi[:, None], cd_sym_new, sf.cd_sym),
        callvalue_sym=torch.where(mi, new_value_sym, sf.callvalue_sym),
        caller_sym=torch.where(mi, new_caller_sym, sf.caller_sym),
    )
    # precompile outputs land after the common bookkeeping so they can
    # override the pushed-result defaults for their lanes
    if maybe_pre:
        sf = _apply_precompiles(sf, pre, pid, a_off, a_len, r_off, r_len)
    return sf


CREATE_ADDR_BASE = 0xC0DE00000000  # fresh pseudo-addresses for CREATE results

PRE_IN_CAP = 448  # precompile input window cap (modexp header + 3 x 32-byte
# operands = 192; a 2-pair ECPAIRING check is 384; sha256/identity accept
# up to this; longer inputs fall to the external-havoc path)


def _be_window_word(buf, start, width, INW: int):
    """u256 word from `width[P]` big-endian bytes at `start[P]` of buf[P,INW]
    (right-aligned: value = int.from_bytes(buf[start:start+width]))."""
    s = start.to(I64) + width.to(I64) - 32
    raw = ci._gather_bytes(buf, s, 32, torch.full_like(s, INW))
    k = torch.arange(32, device=buf.device)[None, :]
    valid = (s[:, None] + k) >= start[:, None].to(I64)
    return ci._be_bytes_to_word(torch.where(valid, raw, 0))


def _host_precompiles(inp, pid, a_len, m_ecr_h, m_host_h):
    """The one masked device->host->device round trip for ecrecover
    (ops/secp256k1) and ripemd160/bn128/blake2f (ops/natives_host).
    Returns device tensors (ecr_bytes u8[P,32], ecr_ok, nat_bytes
    u8[P,64], nat_len i32[P], nat_ok)."""
    from ..ops.natives_host import natives_batch
    from ..ops.secp256k1 import ecrecover_batch

    P = inp.shape[0]
    dev = inp.device
    lanes = np.nonzero(m_ecr_h | m_host_h)[0]
    idx = torch.as_tensor(lanes, device=dev)
    inp_h = inp[idx].cpu().numpy()
    pid_h = pid[idx].cpu().numpy()
    alen_h = a_len[idx].cpu().numpy()
    ecr_b = np.zeros((P, 32), dtype=np.uint8)
    ecr_k = np.zeros(P, dtype=bool)
    e_sel = m_ecr_h[lanes]
    for i, addr in zip(lanes[e_sel], ecrecover_batch(inp_h[e_sel, :128])):
        if addr is not None:
            ecr_b[i] = np.frombuffer(addr.to_bytes(32, "big"), np.uint8)
            ecr_k[i] = True
    nat_b = np.zeros((P, 64), dtype=np.uint8)
    nat_n = np.zeros(P, dtype=np.int32)
    nat_k = np.zeros(P, dtype=bool)
    nb, nn, nk = natives_batch(inp_h, pid_h, alen_h, m_host_h[lanes])
    nat_b[lanes], nat_n[lanes], nat_k[lanes] = nb, nn, nk
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(ecr_b), t(ecr_k), t(nat_b), t(nat_n), t(nat_k)


def _compacted(mask_h, fn, P, dev, *args):
    """fn over the lanes of the host mask only; zeros elsewhere."""
    idx = torch.as_tensor(np.nonzero(mask_h)[0], device=dev)
    out = torch.zeros((P, 8), dtype=I64, device=dev)
    out[idx] = fn(*(a[idx] for a in args))
    return out


def _apply_precompiles(sf: SymFrontier, pre, pid, a_off, a_len, r_off,
                       r_len) -> SymFrontier:
    """Execute precompile calls 0x1-0x9 for the `pre` lanes (the JAX
    ``_apply_precompiles``): 0x2 sha256 (kernel K4, over the lane mask in
    place on the card) and 0x5 modexp (kernel K5) on the device, on the
    lanes that need them only; 0x4
    identity a byte copy; 0x1 ecrecover and 0x3/0x6-0x9 through one
    masked host round trip. Symbolic input bytes demote every concrete
    case to an uninterpreted leaf; a malformed input fails the call.

    The JAX code gates each branch on ``lax.cond(any(mask))``; here the
    masks come back to the host in one read, and that read also returns
    at once when no lane is a precompile call. (The host natives are
    always available here: the JAX ``host_callbacks_supported()`` gate
    is True on every runtime this package runs on.)"""
    from ..ops.natives_host import BLAKE2F_MAX_ROUNDS
    from ..ops.sha256 import sha256_device, sha256_lanes

    f = sf.base
    P, M = f.memory.shape
    dev = f.memory.device
    RD = f.returndata.shape[1]
    INW = min(M, PRE_IN_CAP)  # static input gather width (pre <= this)
    W = sf.mem_sym.shape[1]
    fdiv = lambda x: torch.div(x, 32, rounding_mode="floor")

    wids = torch.arange(W, device=dev)[None, :]
    win_lo = fdiv(a_off)[:, None]
    win_hi = fdiv(a_off + a_len + 31)[:, None]
    sym_in = (sf.mem_havoc | torch.any(
        (wids >= win_lo) & (wids < win_hi) & (sf.mem_sym != 0), dim=1)) & (a_len > 0)

    inp = ci._gather_bytes(f.memory, a_off, INW, torch.full_like(a_off, M))
    inp = torch.where(torch.arange(INW, device=dev)[None, :] < a_len[:, None], inp, 0)

    conc = pre & ~sym_in
    m_sha = conc & (pid == 2)
    m_id = conc & (pid == 4)
    m_ecr = conc & (pid == 1)

    # modexp header: three 32-byte big-endian lengths; the u64 -> i64 read
    # makes a huge header negative, which must fail the window check
    blen = u256.to_u64_saturating(ci._be_bytes_to_word(inp[:, 0:32]))
    elen = u256.to_u64_saturating(ci._be_bytes_to_word(inp[:, 32:64]))
    mlen = u256.to_u64_saturating(ci._be_bytes_to_word(inp[:, 64:96]))
    fits = ((blen >= 0) & (blen <= 32) & (elen >= 0) & (elen <= 32)
            & (mlen >= 0) & (mlen <= 32) & (96 + blen + elen + mlen <= a_len))
    m_mod = conc & (pid == 5) & fits
    # blake2f rounds word (first 4 input bytes): an attacker-size count
    # routes to the leaf, not the host
    inp64 = inp.to(I64)
    rounds = (inp64[:, 0] << 24) | (inp64[:, 1] << 16) | (inp64[:, 2] << 8) | inp64[:, 3]
    m_host = conc & ((pid == 3) | (pid == 6) | (pid == 7) | (pid == 8)
                     | ((pid == 9) & (rounds <= BLAKE2F_MAX_ROUNDS)))
    if RD < 64:  # tiny test shapes: no room for the 64-byte outputs
        m_host = m_host & (pid == 3)
    m_leaf = pre & ~m_sha & ~m_id & ~m_mod & ~m_ecr & ~m_host

    # every branch predicate (and the lanes it selects) in ONE host read
    ci.HOST_SYNCS["count"] += 1
    pre_h, sha_h, mod_h, ecr_h, host_h = torch.stack(
        [pre, m_sha, m_mod, m_ecr, m_host]).cpu().numpy()
    if not pre_h.any():
        return sf

    if ecr_h.any() or host_h.any():
        ecr_bytes, ecr_ok, nat_bytes, nat_len, nat_ok = _host_precompiles(
            inp, pid, a_len, ecr_h, host_h)
    else:
        ecr_bytes = torch.zeros((P, 32), dtype=torch.uint8, device=dev)
        ecr_ok = torch.zeros(P, dtype=torch.bool, device=dev)
        nat_bytes = torch.zeros((P, 64), dtype=torch.uint8, device=dev)
        nat_len = torch.zeros(P, dtype=I32, device=dev)
        nat_ok = torch.zeros(P, dtype=torch.bool, device=dev)
    m_hok = m_host & nat_ok
    m_hfail = m_host & ~nat_ok

    sha_w = torch.zeros((P, 8), dtype=I64, device=dev)
    if sha_h.any():
        sha_len = torch.clamp(a_len, 0, INW).to(I32)
        # on the card one K4 launch over the lane mask, in place in the
        # input window (no index, gather or scatter for its few lanes)
        sha_w = (sha256_lanes(inp, sha_len, m_sha) if inp.is_cuda
                 else _compacted(sha_h, sha256_device, P, dev, inp, sha_len))
    mod_w = torch.zeros((P, 8), dtype=I64, device=dev)
    if mod_h.any():
        b_w = _be_window_word(inp, torch.full_like(blen, 96), blen, INW)
        e_w = _be_window_word(inp, 96 + blen, elen, INW)
        m_w = _be_window_word(inp, 96 + blen + elen, mlen, INW)
        mod_w = _compacted(mod_h, u256.modexp, P, dev, b_w, e_w, m_w)

    # precompile gas: per-native schedules (modexp the EIP-2565 floor only)
    words = torch.div(a_len + 31, 32, rounding_mode="floor")
    cost = [3000, 60 + 12 * words, 600 + 120 * words, 15 + 3 * words, 200, 150, 6000,
            45000 + 34000 * torch.div(a_len, 192, rounding_mode="floor"), rounds]
    pcost = torch.zeros_like(words)
    for k in range(9, 0, -1):
        pcost = torch.where(pid == k, torch.as_tensor(cost[k - 1], device=dev).to(I64), pcost)
    f = ci._charge(f, pre, pcost)
    sf = sf.replace(base=f)

    # leaf result node (hash-consed per call site via the call index)
    kind = torch.where(pid == 1, int(FreeKind.ECRECOVER), int(FreeKind.PRECOMPILE))
    sf, leaf = append_node(sf, m_leaf, int(SymOp.FREE), kind,
                           torch.clamp(sf.n_calls - 1, min=0))
    f = sf.base

    # output byte image (concrete cases) + logical output length
    out_len = torch.where(pid == 4, torch.clamp(a_len, max=RD),
                          torch.where(pid == 5, mlen,
                                      torch.where((pid == 6) | (pid == 7) | (pid == 9),
                                                  64, 32))).to(I64)
    out_len = torch.where(m_ecr, torch.where(ecr_ok, 32, 0), out_len)
    out_len = torch.where(m_host, torch.where(nat_ok, nat_len, 0).to(I64), out_len)
    padRD = lambda x: (torch.nn.functional.pad(x, (0, RD - x.shape[1])) if x.shape[1] <= RD
                       else x[:, :RD])
    out = torch.where(m_id[:, None], padRD(inp), 0).to(torch.uint8)
    sha_bytes = ci._word_to_be_bytes(sha_w)
    mod_be = ci._word_to_be_bytes(mod_w)
    # modexp output is the result right-aligned in mlen bytes
    kk = torch.arange(RD, dtype=I64, device=dev)[None, :]
    mod_src = torch.clamp(32 - mlen[:, None] + kk, 0, 31)
    mod_bytes = torch.gather(padRD(mod_be), 1, mod_src)
    head = kk < 32
    out = torch.where(m_sha[:, None] & head, padRD(sha_bytes), out)
    out = torch.where(m_mod[:, None] & (kk < mlen[:, None]), mod_bytes, out)
    out = torch.where((m_ecr & ecr_ok)[:, None] & head, padRD(ecr_bytes), out)
    out = torch.where(m_hok[:, None] & (kk < nat_len[:, None].to(I64)), padRD(nat_bytes), out)

    # returndata buffer + memory window write
    conc_res = m_sha | m_id | m_mod | m_ecr | m_hok
    n_out = torch.clamp(out_len, 0, RD).to(I32)
    returndata = torch.where(pre[:, None], out, f.returndata)
    returndata = torch.where(
        pre[:, None] & (torch.arange(RD, device=dev)[None, :] >= n_out[:, None]), 0,
        returndata).to(torch.uint8)
    n_mem = torch.minimum(out_len, r_len)
    jpos = torch.arange(M, dtype=I64, device=dev)[None, :]
    in_win = (jpos >= r_off[:, None]) & (jpos < (r_off + n_mem)[:, None])
    src = ci._take_per_lane(out, jpos - r_off[:, None], n_mem)
    memory = torch.where(in_win & conc_res[:, None], src, f.memory).to(torch.uint8)

    # sym overlay of the output window: concrete results clear covered
    # words (edge words with stale syms -> havoc); a leaf lands on a
    # single aligned word, anything wider/unaligned havocs
    full_lo = fdiv(r_off + 31)[:, None]
    full_hi = fdiv(r_off + n_mem)[:, None]
    covered = (wids >= full_lo) & (wids < full_hi) & conc_res[:, None]
    mem_sym = torch.where(covered, 0, sf.mem_sym)
    edge = (((wids == fdiv(r_off)[:, None]) | (wids == full_hi))
            & ~covered & conc_res[:, None] & (n_mem[:, None] > 0))
    edge_dirty = torch.any(edge & (sf.mem_sym != 0), dim=1)
    leaf_word_ok = m_leaf & ((r_off % 32) == 0) & (r_len >= 32) & (out_len == 32)
    mem_sym = _set_word_sym(mem_sym, fdiv(r_off).to(I32), leaf, leaf_word_ok)
    mem_havoc = sf.mem_havoc | (conc_res & edge_dirty) | (m_leaf & (r_len > 0) & ~leaf_word_ok)

    # a malformed input FAILS the call: the pushed success word becomes 0
    stack = ci._set_slot(f.stack, f.sp - 1, torch.zeros((P, 8), dtype=I64, device=dev),
                         m_hfail)
    return sf.replace(
        base=f.replace(memory=memory, returndata=returndata, stack=stack,
                       returndata_len=torch.where(pre, n_out, f.returndata_len)),
        mem_sym=mem_sym,
        mem_havoc=mem_havoc,
        retdata_sym=torch.where(pre, m_leaf, sf.retdata_sym),
    )


def _init_jumpdest_scan(code: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Jumpdest map of init-code rows u8[n, IC]: a byte is a valid
    JUMPDEST iff it is 0x5B and not inside a PUSH immediate. An exact host
    pass (the JAX ``_init_jumpdest_scan`` is a sequential loop over the
    whole buffer; as a device loop it would be thousands of launches)."""
    n, IC = code.shape
    jd = np.zeros((n, IC), dtype=bool)
    for r in range(n):
        row = code[r]
        i, end = 0, min(int(length[r]), IC)
        while i < end:
            b = int(row[i])
            if b == 0x5B:
                jd[r, i] = True
            elif 0x60 <= b <= 0x7F:
                i += b - 0x5F
            i += 1
    return jd


def _h_sym_create(sf: SymFrontier, op, m, old_pc) -> SymFrontier:
    """CREATE/CREATE2 (the JAX ``_h_sym_create``): a lane whose init
    window is concrete (bytes, offset, length, value, CREATE2 salt) pushes
    a frame that executes the init code from a per-lane buffer; storage
    writes land on the fresh account, RETURN's payload is matched against
    the corpus at pop, REVERT rolls back. Otherwise a fresh CODE_UNKNOWN
    account is registered and its address pushed (constructor skipped)."""
    f = sf.base
    P = f.n_lanes
    dev = op.device
    static_viol = m & f.static
    sf = sf.replace(base=f.trap(static_viol, Trap.STATIC_WRITE))
    f = sf.base
    m = m & ~static_viol
    sin = ci._tab(op).STACK_IN[op.long()]
    is_c2 = op == 0xF5
    value = ci._peek(f, 0)
    value_sym = _peek_sym(sf, 0)
    off = u256.to_u64_saturating(ci._peek(f, 1))
    ln = u256.to_u64_saturating(ci._peek(f, 2))
    off_s, ln_s = _peek_sym(sf, 1), _peek_sym(sf, 2)
    salt = torch.where(is_c2[:, None], ci._peek(f, 3), 0)
    salt_sym = torch.where(is_c2, _peek_sym(sf, 3), 0)
    f, _ = ci._expand_memory(f, m & (ln > 0), off + ln)
    sf = sf.replace(base=f)
    sf = _record_call_event(sf, m, op, old_pc, torch.zeros_like(value),
                            torch.zeros_like(value_sym), value, value_sym)
    f = sf.base

    # concrete-value feasibility (a symbolic value moves nothing)
    value_conc = value_sym == 0
    wants = m & value_conc & ~u256.is_zero(value)
    payer_bal = f.self_balance
    insufficient = wants & u256.lt(payer_bal, value)
    ok = m & ~insufficient

    # register the new account in a free slot; a full table skips it
    A = f.acct_used.shape[1]
    free = ~f.acct_used
    has_free = torch.any(free, dim=1)
    slot = first_true(free, dim=1)
    reg = ok & has_free
    addr_w = u256.from_u64_scalar(CREATE_ADDR_BASE + sf.create_cnt.to(I64))
    sidx = torch.where(reg, slot, A)
    acct_addr = ci._write_slot(f.acct_addr, sidx, addr_w)
    init_bal = torch.where((wants & ~insufficient)[:, None], value, 0)
    acct_bal = ci._write_slot(f.acct_bal, sidx, init_bal)
    # CODE_UNKNOWN, not EOA: calls to it must havoc, never succeed
    acct_code = ci._write_slot(f.acct_code, sidx, CODE_UNKNOWN)
    acct_used = ci._write_slot(f.acct_used, sidx, True)
    pay_idx = torch.where(reg & wants, f.cur_acct, A)
    acct_bal = ci._write_slot(acct_bal, pay_idx, u256.sub(payer_bal, value))

    # frame-execution eligibility
    IC = f.init_code.shape[1]
    D = f.fr_ret_pc.shape[1]
    W = sf.mem_sym.shape[1]
    wids = torch.arange(W, device=dev)[None, :]
    fdiv = lambda x: torch.div(x, 32, rounding_mode="floor")
    win_sym = (sf.mem_havoc | torch.any(
        (wids >= fdiv(off)[:, None]) & (wids < fdiv(off + ln + 31)[:, None])
        & (sf.mem_sym != 0), dim=1)) & (ln > 0)
    want_frame = (reg & (off_s == 0) & (ln_s == 0) & (salt_sym == 0) & ~win_sym
                  & (ln > 0) & (ln <= IC) & (f.depth < D) & (f.init_depth == 0))

    dest_slot = f.sp - sin
    m_push = m & ~want_frame  # frame lanes get their result at pop_frames
    res_w = torch.where(ok[:, None], addr_w, 0)
    stack = ci._set_slot(f.stack, dest_slot, res_w, m_push)
    pre_transfer_bal = f.acct_bal
    sf = sf.replace(
        base=f.replace(
            stack=stack,
            sp=torch.where(m_push, f.sp - sin + 1, f.sp),
            returndata_len=torch.where(m_push, 0, f.returndata_len),
            acct_addr=acct_addr, acct_bal=acct_bal,
            acct_code=acct_code, acct_used=acct_used,
        ),
        stack_sym=_set_sym_slot(sf.stack_sym, dest_slot,
                                torch.zeros((P,), dtype=I32, device=dev), m_push),
        retdata_sym=torch.where(m_push, False, sf.retdata_sym),
        create_cnt=sf.create_cnt + m.to(I32),
        bal_epoch=sf.bal_epoch + (reg & wants).to(I32),
    )
    # the JAX lax.cond(any(want_frame)): the mask comes back to the host,
    # which also scans the frame lanes' init code for jump destinations
    ci.HOST_SYNCS["count"] += 1
    want_h = want_frame.cpu().numpy()
    if not want_h.any():
        return sf
    return _push_create_frame(sf, want_frame, want_h, is_c2, slot, sin, off, ln, salt,
                              value, old_pc, pre_transfer_bal)


def _push_create_frame(sf: SymFrontier, mi, mi_h, is_c2, slot, sin, off, ln, salt,
                       value, old_pc, pre_transfer_bal) -> SymFrontier:
    """Push the constructor frame for ``mi`` lanes: the child executes the
    init bytes copied from the caller's memory (``exec_init`` fetch), with
    ``cur_acct`` = the new account, empty calldata and the endowment as
    callvalue. CREATE2 lanes overwrite the registered fresh address with
    keccak(0xff ++ deployer ++ salt ++ keccak(init))[12:] (kernel K2)."""
    from ..ops.keccak import keccak256_device

    f = sf.base
    P, M = f.memory.shape
    dev = f.memory.device
    IC = f.init_code.shape[1]
    d = f.depth

    init_code = ci._gather_bytes(f.memory, off, IC, torch.full_like(off, M))
    init_code = torch.where(torch.arange(IC, device=dev)[None, :] < ln[:, None], init_code, 0)
    init_code = torch.where(mi[:, None], init_code, f.init_code).to(torch.uint8)
    lanes = np.nonzero(mi_h)[0]
    idx = torch.as_tensor(lanes, device=dev)
    jd = _init_jumpdest_scan(init_code[idx].cpu().numpy(), ln[idx].cpu().numpy())
    init_jd = f.init_jd.clone()
    init_jd[idx] = torch.as_tensor(jd, device=dev)

    inner = keccak256_device(init_code, torch.clamp(ln, 0, IC).to(I32))
    buf = torch.cat([torch.full((P, 1), 0xFF, dtype=torch.uint8, device=dev),
                     ci._word_to_be_bytes(f.self_address)[:, 12:32],
                     ci._word_to_be_bytes(salt), ci._word_to_be_bytes(inner)], dim=1)
    c2_addr = keccak256_device(buf, torch.full((P,), 85, dtype=I32, device=dev))
    c2_addr = torch.cat([c2_addr[:, :5], torch.zeros_like(c2_addr[:, 5:])], dim=1)
    do_c2 = mi & is_c2
    acct_addr = ci._write_slot(f.acct_addr, torch.where(do_c2, slot, f.acct_used.shape[1]),
                               c2_addr)

    # CREATE forwards all-but-one-64th (EIP-150; no gas operand)
    remaining = torch.clamp(f.gas_limit - f.gas_max, min=0)
    fwd = remaining - torch.div(remaining, 64, rounding_mode="floor")
    base_kw, sym_kw = _frame_push(f, sf, d, mi, old_pc, f.sp - sin, torch.zeros_like(off),
                                  torch.zeros_like(ln), pre_transfer_bal, slot)
    _count_frames("pushed", mi)
    f2 = f.replace(
        **base_kw,
        acct_addr=acct_addr,
        gas_limit=torch.where(mi, f.gas_max + fwd, f.gas_limit),
        pc=torch.where(mi, 0, f.pc),
        pc_hold=f.pc_hold | mi,
        sp=torch.where(mi, f.sp - sin, f.sp),
        sp_base=torch.where(mi, f.sp - sin, f.sp_base),
        depth=torch.where(mi, f.depth + 1, f.depth),
        cur_acct=torch.where(mi, slot, f.cur_acct),
        caller_addr=torch.where(mi[:, None], f.self_address, f.caller_addr),
        callvalue=torch.where(mi[:, None], value, f.callvalue),
        memory=torch.where(mi[:, None], 0, f.memory),
        mem_words=torch.where(mi, 0, f.mem_words),
        calldata=torch.where(mi[:, None], 0, f.calldata),
        calldata_len=torch.where(mi, 0, f.calldata_len),
        returndata_len=torch.where(mi, 0, f.returndata_len),
        init_code=init_code,
        init_len=torch.where(mi, ln.to(I32), f.init_len),
        init_jd=init_jd,
        init_depth=torch.where(mi, f.depth + 1, f.init_depth),
    )
    return sf.replace(
        **sym_kw,
        base=f2,
        mem_sym=torch.where(mi[:, None], 0, sf.mem_sym),
        mem_havoc=torch.where(mi, False, sf.mem_havoc),
        cd_from_mem=sf.cd_from_mem | mi,
        cd_havoc=torch.where(mi, False, sf.cd_havoc),
        cd_sym=torch.where(mi[:, None], 0, sf.cd_sym),
        callvalue_sym=torch.where(mi, 0, sf.callvalue_sym),
        caller_sym=torch.where(mi, 0, sf.caller_sym),
    )


def pop_frames(sf: SymFrontier, corpus: Corpus, maybe_init: bool = True) -> SymFrontier:
    """Return control to the caller for every lane whose sub-frame ended
    (the JAX ``pop_frames``). EVM halts inside the callee (revert,
    invalid, bad jump, OOG, stack) become success=0 with storage/balance
    rollback; engine-capacity traps kill the whole lane. A lane whose
    frame did not end is left exactly as it was, so running this on a
    superset of the ending lanes is exact. ``maybe_init`` False (no lane
    is inside a constructor frame) skips the corpus match of deployed
    images, which could then select no lane."""
    f = sf.base
    P, M = f.memory.shape
    dev = f.memory.device
    ended = f.active & (f.depth > 0) & (f.halted | f.error)
    is_kill = torch.zeros_like(f.error)
    for c in KILL_TRAPS:
        is_kill = is_kill | (f.err_code == c)
    mp = ended & ~(f.error & is_kill)
    success = mp & f.halted & ~f.reverted & ~f.error
    fail = mp & (f.error | f.reverted)
    _count_frames("popped", mp)
    d = torch.clamp(f.depth - 1, min=0)
    # constructor frames: fr_create_slot >= 0 marks the account being built
    cslot = _fr_get(f.fr_create_slot, d)
    is_initp = mp & (cslot >= 0)

    ret_pc = _fr_get(f.fr_ret_pc, d)
    csp = _fr_get(f.fr_sp, d)
    r_off = _fr_get(f.fr_ret_off, d)
    r_len = _fr_get(f.fr_ret_len, d)

    # caller memory restore + returndata write (REVERT carries data too;
    # an exceptional halt returns nothing)
    has_rd = mp & ~f.error
    memory = torch.where(mp[:, None], _fr_get(f.fr_memory, d), f.memory)
    n_rd = torch.minimum(r_len, f.retval_len.to(I64))
    jpos = torch.arange(M, dtype=I64, device=dev)[None, :]
    in_win = (jpos >= r_off[:, None]) & (jpos < (r_off + n_rd)[:, None])
    src = ci._take_per_lane(f.retval, jpos - r_off[:, None], n_rd)
    memory = torch.where(in_win & has_rd[:, None], src, memory).to(torch.uint8)

    # sym overlay: restore the caller's, then map the returndata words
    fdiv = lambda x: torch.div(x, 32, rounding_mode="floor")
    mem_sym = torch.where(mp[:, None], _fr_get(sf.fr_mem_sym, d), sf.mem_sym)
    mem_havoc = torch.where(mp, _fr_get(sf.fr_mem_havoc, d), sf.mem_havoc)
    roff_al = (r_off % 32) == 0
    RDW = sf.rv_sym.shape[1]
    rdw = torch.arange(RDW, device=dev)[None, :]
    rv_words_sym = torch.any((rdw * 32 < n_rd[:, None]) & (sf.rv_sym != 0), dim=1)
    rv_unknown = sf.rv_havoc | rv_words_sym
    # aligned full words map exactly; anything messier havocs coarse
    clean_map = has_rd & roff_al & ~sf.rv_havoc
    for k in range(RDW):
        full = (32 * (k + 1)) <= n_rd
        mem_sym = _set_word_sym(mem_sym, fdiv(r_off).to(I32) + k, sf.rv_sym[:, k],
                                clean_map & full)
    tail_sym_rd = ((n_rd % 32) != 0) & torch.any(
        (rdw == fdiv(n_rd)[:, None]) & (sf.rv_sym != 0), dim=1)
    mem_havoc = mem_havoc | (has_rd & (
        (sf.rv_havoc & (r_len > 0)) | (~roff_al & rv_words_sym) | (roff_al & tail_sym_rd)))

    # storage + balance rollback on failure (each snapshot gathered is a copy)
    def roll(cur, snap):
        return torch.where(fail.reshape((P,) + (1,) * (cur.dim() - 1)), snap, cur)

    st_keys = roll(f.st_keys, _fr_get(f.fr_st_keys, d))
    st_vals = roll(f.st_vals, _fr_get(f.fr_st_vals, d))
    st_used = roll(f.st_used, _fr_get(f.fr_st_used, d))
    st_written = roll(f.st_written, _fr_get(f.fr_st_written, d))
    st_acct = roll(f.st_acct, _fr_get(f.fr_st_acct, d))
    acct_bal = roll(f.acct_bal, _fr_get(f.fr_acct_bal, d))
    st_val_sym = roll(sf.st_val_sym, _fr_get(sf.fr_st_val_sym, d))
    st_key_sym = roll(sf.st_key_sym, _fr_get(sf.fr_st_key_sym, d))
    st_seq = roll(sf.st_seq, _fr_get(sf.fr_st_seq, d))
    warm_acct = roll(f.warm_acct, _fr_get(f.fr_warm_acct, d))
    st_warm = roll(f.st_warm, _fr_get(f.fr_st_warm, d))
    # gas: an EXCEPTIONAL halt burns the whole forwarded allowance; a
    # REVERT returns the unused remainder
    fwd = f.gas_limit - _fr_get(f.fr_gas_max, d)
    fail_exc = mp & f.error
    gas_min = torch.where(fail_exc, _fr_get(f.fr_gas_min, d) + fwd, f.gas_min)
    gas_max = torch.where(fail_exc, _fr_get(f.fr_gas_max, d) + fwd, f.gas_max)
    gas_limit = torch.where(mp, _fr_get(f.fr_gas_limit, d), f.gas_limit)

    # success flag pushed at the caller's post-args sp; a constructor frame
    # pushes the CHILD ADDRESS instead (0 on failure)
    child_addr = f.acct_field(f.acct_addr, torch.clamp(cslot, min=0))
    res_w = torch.where(success[:, None],
                        torch.where(is_initp[:, None], child_addr, _one_word(P, dev)), 0)
    stack = ci._set_slot(f.stack, csp, res_w, mp)
    stack_sym = _set_sym_slot(sf.stack_sym, csp, torch.zeros((P,), dtype=I32, device=dev), mp)

    # constructor epilogue: a failed constructor unregisters the account
    A = f.acct_used.shape[1]
    acct_used_p = ci._write_slot(
        f.acct_used, torch.where(is_initp & fail, torch.clamp(cslot, min=0), A), False)
    acct_code_p = f.acct_code
    if maybe_init:
        # the deployed image is concrete bytes in `retval`: byte-compare it
        # against every corpus image. A match makes the child callable;
        # empty code -> EOA-like; no match or a symbolic byte -> CODE_UNKNOWN
        rl = f.retval_len
        RD = f.retval.shape[1]
        MC = corpus.code.shape[1]
        Wn = min(RD, MC)
        eq = (torch.all(f.retval[:, None, :Wn] == corpus.code[None, :, :Wn], dim=2)
              & (rl[:, None] == corpus.code_len[None, :])
              & (corpus.code_len[None, :] <= RD)
              & (corpus.code_len[None, :] > 0))
        hit = torch.any(eq, dim=1) & ~rv_unknown
        resolved = torch.where(hit, first_true(eq, dim=1),
                               torch.where((rl == 0) & ~rv_unknown, -1, CODE_UNKNOWN))
        cidx = torch.where(is_initp & success, torch.clamp(cslot, min=0), A)
        acct_code_p = ci._write_slot(f.acct_code, cidx, resolved)

    # a successful CREATE leaves EMPTY returndata in the caller
    has_rd = has_rd & ~(is_initp & success)
    Dn = f.fr_create_slot.shape[1]
    base = f.replace(
        pc=torch.where(mp, ret_pc + 1, f.pc),
        sp=torch.where(mp, csp + 1, f.sp),
        sp_base=torch.where(mp, _fr_get(f.fr_sp_base, d), f.sp_base),
        depth=torch.where(mp, d, f.depth),
        init_depth=torch.where(is_initp, 0, f.init_depth),
        acct_used=acct_used_p,
        acct_code=acct_code_p,
        fr_create_slot=ci._write_slot(f.fr_create_slot, torch.where(is_initp, d, Dn), -1),
        static=torch.where(mp, _fr_get(f.fr_static, d), f.static),
        cur_acct=torch.where(mp, _fr_get(f.fr_cur_acct, d), f.cur_acct),
        contract_id=torch.where(mp, _fr_get(f.fr_contract_id, d), f.contract_id),
        caller_addr=torch.where(mp[:, None], _fr_get(f.fr_caller_addr, d), f.caller_addr),
        callvalue=torch.where(mp[:, None], _fr_get(f.fr_callvalue, d), f.callvalue),
        memory=memory,
        mem_words=torch.where(mp, _fr_get(f.fr_mem_words, d), f.mem_words),
        calldata=torch.where(mp[:, None], _fr_get(f.fr_calldata, d), f.calldata),
        calldata_len=torch.where(mp, _fr_get(f.fr_calldata_len, d), f.calldata_len),
        returndata=torch.where((mp & has_rd)[:, None], f.retval, f.returndata),
        returndata_len=torch.where(mp, torch.where(has_rd, f.retval_len, 0),
                                   f.returndata_len),
        retval_len=torch.where(mp, 0, f.retval_len),
        stack=stack,
        st_keys=st_keys, st_vals=st_vals, st_used=st_used,
        st_written=st_written, st_acct=st_acct, acct_bal=acct_bal,
        warm_acct=warm_acct, st_warm=st_warm,
        gas_min=gas_min, gas_max=gas_max, gas_limit=gas_limit,
        halted=f.halted & ~mp,
        reverted=f.reverted & ~mp,
        error=f.error & ~mp,
        err_code=torch.where(mp, 0, f.err_code),
    )
    # only a genuine REVERT (require()-style) feeds SWC-123
    first_rev = fail & f.reverted & ~f.error & (sf.sub_revert_pc < 0)
    return sf.replace(
        base=base,
        stack_sym=stack_sym,
        mem_sym=mem_sym,
        mem_havoc=mem_havoc,
        retdata_sym=torch.where(mp, has_rd & rv_unknown, sf.retdata_sym),
        rv_sym=torch.where(mp[:, None], 0, sf.rv_sym),
        rv_havoc=torch.where(mp, False, sf.rv_havoc),
        cd_from_mem=torch.where(mp, _fr_get(sf.fr_cd_from_mem, d), sf.cd_from_mem),
        cd_havoc=torch.where(mp, _fr_get(sf.fr_cd_havoc, d), sf.cd_havoc),
        cd_sym=torch.where(mp[:, None], _fr_get(sf.fr_cd_sym, d), sf.cd_sym),
        callvalue_sym=torch.where(mp, _fr_get(sf.fr_callvalue_sym, d), sf.callvalue_sym),
        caller_sym=torch.where(mp, _fr_get(sf.fr_caller_sym, d), sf.caller_sym),
        # a failed value call rolled the balance table back — another change
        bal_epoch=sf.bal_epoch + fail.to(I32),
        st_val_sym=st_val_sym,
        st_key_sym=st_key_sym,
        st_seq=st_seq,
        sub_revert_pc=torch.where(first_rev, ret_pc, sf.sub_revert_pc),
        sub_revert_cid=torch.where(first_rev, _fr_get(f.fr_contract_id, d),
                                   sf.sub_revert_cid),
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
    # one group: a CONST row for each concrete nonzero operand (the JAX
    # engine's _sym_or_const), then the node on the two rows' outputs. A CONST
    # row's literal a is the operand's sym id (0 where the row appends, and
    # 0 for a unary op's b), so its output is the operand's id either way
    need_a = m_node & (s[0] == 0) & ~u256.is_zero(a[0])
    need_b = m_node & ~is_unary & (s[1] == 0) & ~u256.is_zero(a[1])
    const = int(SymOp.CONST)
    sf, out = append_group(
        sf, torch.stack([need_a, need_b, m_node], dim=1),
        torch.cat([_group_rows([const, const], P, dev), node_op[:, None]], dim=1),
        torch.stack([s[0], torch.where(is_unary, 0, s[1]), torch.zeros_like(s[0])], dim=1),
        _group_rows([0, 0, 0], P, dev), _group_rows([-1, -1, 0], P, dev),
        _group_rows([-1, -1, 1], P, dev),
        torch.stack([a[0], a[1], torch.zeros_like(a[0])], dim=1))
    aid, bid, r_bin = out.unbind(dim=1)

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
    M = f.memory.shape[1]
    imm_rows = [seed_imm]
    for k in range(NCW):
        w_conc = ci._be_bytes_to_word(
            ci._gather_bytes(sf.base.memory, (w0 + k).to(I64) * 32, 32,
                             torch.full_like(off64, M)))
        imm_rows.append(torch.where((wsyms[k] == 0)[:, None], w_conc, 0))
    imm_rows.append(torch.zeros_like(seed_imm))
    # one group: the seed, an absorb row per word of the window (its a the
    # chain so far: the previous row's output, which a row the window does
    # not reach passes on), the digest
    zero = torch.zeros_like(wsyms[0])
    rows = NCW + 2
    sf, chain = append_group(
        sf, torch.stack([m_chain, *(m_chain & in_win[k] for k in range(NCW)), m_chain], dim=1),
        _group_rows([int(SymOp.KECCAK_SEED)] + [int(SymOp.KECCAK_ABS)] * NCW
                    + [int(SymOp.KECCAK)], P, dev),
        _group_rows([0] * rows, P, dev), torch.stack([zero, *wsyms, zero], dim=1),
        _group_rows([-1] + list(range(NCW + 1)), P, dev), _group_rows([-1] * rows, P, dev),
        torch.stack(imm_rows, dim=1))
    dig = chain[:, -1]
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

def _berlin_gas_pre(sf: SymFrontier, op, run, a, s) -> SymFrontier:
    """EIP-2929 cold surcharges, charged to the executing frame before
    dispatch (the JAX ``_berlin_gas_pre``). Storage keys resolve against
    the cache's per-tx ``st_warm`` bits, addresses against the account
    table's ``warm_acct``; a symbolic key or address, or one outside the
    table, cannot be tracked and lands in ``gas_max`` only. Account-op
    targets are marked warm here, storage keys after dispatch."""
    from ..disassembler.opcodes import G_COLD_ACCOUNT, G_COLD_SLOAD, G_WARM_ACCESS

    f = sf.base
    # the static berlin table already charged the WARM base; the cold
    # surcharge is the difference
    SUR_SLOAD = G_COLD_SLOAD - G_WARM_ACCESS
    SUR_ACCT = G_COLD_ACCOUNT - G_WARM_ACCESS
    lanes = torch.arange(f.n_lanes, device=op.device)

    # storage: SLOAD/SSTORE (key = operand 0)
    m_st = run & ((op == 0x54) | (op == 0x55))
    key_conc = s[0] == 0
    hit, _, slot = ci._storage_lookup(f, a[0])
    K = f.st_warm.shape[1]
    warm_bit = f.st_warm[lanes, torch.clamp(slot, 0, K - 1).long()]
    st_cold = ~(hit & warm_bit)
    st_sur_max = torch.where(m_st, SUR_SLOAD, 0).to(I64)
    st_sur_min = torch.where(m_st & key_conc & st_cold, SUR_SLOAD, 0).to(I64)
    st_sur_max = torch.where(m_st & key_conc & ~st_cold, 0, st_sur_max)

    # account access: BALANCE/EXTCODESIZE/EXTCODECOPY/EXTCODEHASH and
    # SELFDESTRUCT (operand 0), the CALL family (operand 1)
    m_acct0 = run & ((op == 0x31) | (op == 0x3B) | (op == 0x3C) | (op == 0x3F) | (op == 0xFF))
    m_call = run & (ci._tab(op).CLASS[op.long()] == ci.CLS_CALL)
    addr_w = torch.where(m_call[:, None], a[1], a[0])
    addr_sym = torch.where(m_call, s[1], s[0])
    m_addr = m_acct0 | m_call
    found, aslot = f.acct_lookup(addr_w)
    A = f.warm_acct.shape[1]
    awarm = found & f.warm_acct[lanes, torch.clamp(aslot, 0, A - 1).long()]
    addr_conc = addr_sym == 0
    tracked = addr_conc & found
    # a symbolic CALL target pays when its enumeration fork resolves it (or
    # in the call handler's external fallback); the other address ops run
    # once, so a symbolic address charges cold into gas_max now
    ac_sur_min = torch.where(m_addr & tracked & ~awarm, SUR_ACCT, 0).to(I64)
    ac_sur_max = torch.where((m_addr & addr_conc & (~found | ~awarm)) | (m_acct0 & ~addr_conc),
                             SUR_ACCT, 0).to(I64)
    aidx = torch.where(m_addr & tracked, aslot, A)
    warm_acct = ci._write_slot(f.warm_acct, aidx, True)
    return sf.replace(base=f.replace(
        gas_min=f.gas_min + st_sur_min + ac_sur_min,
        gas_max=f.gas_max + st_sur_max + ac_sur_max,
        warm_acct=warm_acct,
    ))


def _berlin_gas_post(sf: SymFrontier, op, run, key_w, key_s) -> SymFrontier:
    """Post-dispatch storage warm marking (the JAX ``_berlin_gas_post``):
    the touched key's cache entry gets its per-tx warm bit; a concrete
    SLOAD miss allocates a (key, 0, unwritten) entry so the next access
    is provably warm."""
    f = sf.base
    m_st = run & ((op == 0x54) | (op == 0x55)) & (key_s == 0) & ~f.error
    hit, _, slot = ci._storage_lookup(f, key_w)
    need_alloc = m_st & ~hit & (op == 0x54)
    widx, overflow = ci.storage_alloc(f, hit, slot, need_alloc)
    st_keys = ci._write_slot(f.st_keys, widx, key_w)
    st_used = ci._write_slot(f.st_used, widx, True)
    st_acct = ci._write_slot(f.st_acct, widx, f.cur_acct)
    # a full cache simply loses warm tracking (overcharges later, sound)
    K = f.st_warm.shape[1]
    midx = torch.where(m_st & hit, slot, torch.where(need_alloc & ~overflow, widx, K))
    st_warm = ci._write_slot(f.st_warm, torch.clamp(midx, 0, K), True)
    return sf.replace(base=f.replace(st_keys=st_keys, st_used=st_used, st_acct=st_acct,
                                     st_warm=st_warm))


# host-read predicate slots of sym_superstep (one transfer per superstep;
# on the CPU the 16 class-present flags of the plain dispatch come first)
_P_STORAGE, _P_JUMP, _P_CALL, _P_CREATE, _P_MISC, _P_PRE, _P_FRAMES, _P_INIT = range(8)


# the running ``sym_run`` loop's K3 descriptor (``kernels.TapeAppend``);
# None outside a loop and on the CPU. A context variable and not a
# parameter: the loop's appends are spread over the overlay and a dozen
# handlers, and it is set and reset by the loop that owns the tape
_K3 = contextvars.ContextVar("k3", default=None)


@contextlib.contextmanager
def _loop_k3(device: torch.device):
    """K3's descriptor for a loop on ``device`` when it is the card, for
    the loop's appends to reach through ``_K3``: the tape is checked and
    marshaled at the first append and again only where the loop replaces
    it. It takes the device, not the frontier: the generator's frame would
    keep the loop's first frontier alive to its end."""
    k3 = None
    if device.type == "cuda":
        from ..kernels import TapeAppend

        k3 = TapeAppend.on_card(device)
    token = _K3.set(k3)
    try:
        yield
    finally:
        _K3.reset(token)


# the fields a superstep writes in place besides K10's
# (``kernels.EVM_WRITES``): K3 and its plain version append to the tape
_TAPE_FIELDS = ("tape_op", "tape_a", "tape_b", "tape_imm", "tape_hash", "tape_len")


def own_loop_fields(sf: SymFrontier, k10, forks: bool = False) -> SymFrontier:
    """``sf`` with fresh copies of every field a loop over it writes in
    place, so that the tensors the caller holds stay as they were: the
    tape (K3 appends in place, and so does its plain version) and on the
    card (a descriptor ``k10``) the fields K10 writes; when the loop
    ``forks``, every field a fork expansion writes
    (:func:`own_fork_fields`: K7 and its plain version copy rows of every
    lane-axis field in place, and K6 sweeps the domains in place)."""
    if forks:
        from ..kernels import EVM_WRITES

        sf = own_fork_fields(sf, EVM_WRITES["superstep"] if k10 is not None else ())
    else:
        sf = sf.replace(**{k: getattr(sf, k).clone() for k in _TAPE_FIELDS})
    if k10 is not None:
        from ..kernels import own_evm_fields

        sf = sf.replace(base=own_evm_fields(sf.base))
    return sf


def sym_superstep(sf: SymFrontier, env: Env, corpus: Corpus,
                  spec: SymSpec = SymSpec(),
                  limits: LimitsConfig = DEFAULT_LIMITS) -> SymFrontier:
    """Advance every running lane by one instruction, symbolically. The
    input is never changed: what the step writes in place is copied once
    first (:func:`own_loop_fields`)."""
    k10 = ci.k10_for(sf.base, limits.gas_schedule == "berlin")
    return _sym_superstep(own_loop_fields(sf, k10), env, corpus, spec, limits, k10)


def _sym_superstep(sf: SymFrontier, env: Env, corpus: Corpus, spec: SymSpec,
                   limits: LimitsConfig, k10) -> SymFrontier:
    """:func:`sym_superstep` on a frontier whose in-place fields the caller
    owns; ``k10`` is its K10 descriptor (None: the plain versions), and the
    three K10 launches run in place on ``sf.base``.

    In place, K10's dispatch and epilogue change the tensors of
    ``sf.base``. The reads of ``f``, ``sf.base`` and ``b0`` between the
    prologue and the epilogue:
    - before dispatch: ``ci._peek(f, i)`` gathers into new tensors;
      ``_berlin_gas_pre`` replaces the gas fields with new tensors;
      ``b0.active``, ``depth`` and ``init_depth``, which K10 does not
      write, go into ``in_frame`` and the predicates;
    - after dispatch: ``_overlay``, the claimed handlers,
      ``_berlin_gas_post`` and ``fb`` read ``sf.base``, the dispatched
      frontier, and want its written values, as when dispatch wrote
      copies;
    - two pre-write values are read after the write, so they are copies:
      ``old_pc``, the prologue's copy of the pre-step pc (the plain
      prologue returns the input's pc, which nothing then writes), which
      ``_h_sym_jump``, ``_h_sym_call``, ``_h_sym_create``,
      ``_note_backjump`` and the epilogue read after dispatch (JUMP) and
      the epilogue move ``pc``; and ``pre_sp``, taken before dispatch
      moves ``sp``, for ``_overlay``.
    ``op``, ``run`` and ``old_pc`` live in the descriptor until the next
    prologue; nothing here keeps them past the epilogue (each use makes a
    new tensor)."""
    berlin = limits.gas_schedule == "berlin"
    f, op, run, old_pc = ci.prologue(sf.base, corpus, berlin=berlin, k10=k10)
    sf = sf.replace(base=f)
    tb = ci._tab(op)
    cls = tb.CLASS[op.long()]
    pre_sp = f.sp.clone()
    pre_stack_sym = sf.stack_sym
    a = [ci._peek(f, i) for i in range(4)]
    s = [_peek_sym(sf, i) for i in range(7)]
    if berlin:
        sf = _berlin_gas_pre(sf, op, run, a, s)

    is_jumpi = op == 0x57
    known, ksign = _lookup_constraint(sf, s[1])
    claim_jump = run & (cls == ci.CLS_JUMP) & ((s[0] != 0) | (is_jumpi & (s[1] != 0)))
    claim_storage = run & (cls == ci.CLS_STORAGE)
    claim_call = run & (cls == ci.CLS_CALL)
    claim_create = run & (cls == ci.CLS_CREATE)
    claim_memoff = run & (cls == ci.CLS_MEM) & (s[0] != 0)
    claim_sha3off = run & (cls == ci.CLS_SHA3) & ((s[0] != 0) | (s[1] != 0))
    is_ext = op == 0x3C
    claim_copyoff = run & (cls == ci.CLS_COPY) & (
        (s[0] != 0) | (s[1] != 0) | (s[2] != 0) | (is_ext & (s[3] != 0)))
    has_data_halt = (op == 0xF3) | (op == 0xFD)
    claim_haltoff = run & (cls == ci.CLS_HALT) & has_data_halt & ((s[0] != 0) | (s[1] != 0))
    claim_logoff = run & (cls == ci.CLS_LOG) & ((s[0] != 0) | (s[1] != 0))
    misc = claim_memoff | claim_sha3off | claim_copyoff | claim_haltoff | claim_logoff
    claimed = claim_jump | claim_storage | claim_call | claim_create | misc
    # a precompile call needs a concrete target below 10: lanes without one
    # cannot reach _apply_precompiles
    maybe_pre = claim_call & (s[1] == 0) & torch.all(a[1][:, 1:] == 0, dim=1) & \
        (a[1][:, 0] >= 1) & (a[1][:, 0] <= 9)
    # only a lane inside a sub-frame can end one this superstep (a frame
    # pushed now starts running); only a lane inside a constructor frame
    # can return a deployed image
    b0 = sf.base
    in_frame = b0.active & (b0.depth > 0)

    # every cond predicate of this superstep in ONE device->host read; the
    # concrete dispatch of K10 needs no class-present flags
    head = [] if k10 is not None else [ci.class_present(op, run & ~claimed)]
    preds = ci.host_list(torch.cat([
        *head,
        torch.stack([claim_storage.any(), claim_jump.any(), claim_call.any(),
                     claim_create.any(), misc.any(), maybe_pre.any(), in_frame.any(),
                     (in_frame & (b0.init_depth > 0)).any()])]))
    present, preds = (None, preds) if k10 is not None else (preds[:ci.N_CLASSES],
                                                            preds[ci.N_CLASSES:])

    f = ci.dispatch(sf.base, env, corpus, op, run, old_pc, skip=claimed, present=present,
                    k10=k10)
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
    if preds[_P_CALL]:
        sf = _h_sym_call(sf, op, claim_call, old_pc, spec, bool(preds[_P_PRE]), berlin)
    if preds[_P_CREATE]:
        sf = _h_sym_create(sf, op, claim_create, old_pc)
    if preds[_P_MISC]:
        sf = _h_sym_claimed_misc(sf, op, claim_memoff, claim_sha3off, claim_copyoff,
                                 claim_haltoff, claim_logoff)

    if berlin:
        sf = _berlin_gas_post(sf, op, run, a[0], s[0])

    # bounded loops: any jump that landed at-or-before its own pc (the
    # fork-taken copies are counted in expand_forks)
    fb = sf.base
    back = run & (cls == ci.CLS_JUMP) & ~fb.halted & ~fb.error & (fb.pc <= old_pc)
    sf = _note_backjump(sf, back, old_pc, fb.pc, limits.loop_bound)
    sf = sf.replace(base=ci.epilogue(sf.base, op, run, old_pc, k10=k10))
    # sub-frames that halted (or failed) this step return to their caller;
    # pop_frames leaves every other lane as it was, so the pre-step
    # "some lane is in a sub-frame" flag gates it exactly
    if preds[_P_FRAMES]:
        sf = pop_frames(sf, corpus, maybe_init=bool(preds[_P_INIT]))
    return sf


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


# rows of K7's plan outputs (kernels/csrc/fork_expand.cuh), shared with
# their plain version
O_SRC, O_SLOT, O_PC, O_SP, O_CON_LEN, O_LAST, O_CIDX, O_CALL_ENUM, O_DROPPED = range(9)
B_COPY, B_FORK_REQ, B_STARVED, B_BACK = range(4)


def fork_ksent(B: int) -> int:
    """The packed-key sentinel of the JAX ``plan_fork_map``: the key budget
    that keeps ``key * B + lane`` inside int32."""
    return min(1 << 16, (2 ** 31 - 1 - (B - 1)) // B)


def _policy_key(policy: str, con_len, fork_dest, contract_id, visited, n_con: int):
    """Per-lane admission key of a fork policy (JAX ``expand_forks``),
    int64[P]; lower admits first."""
    depth = con_len.to(I64)
    if policy == "fifo":
        return torch.zeros_like(depth)
    if policy in ("shallow", "beam"):
        return depth
    if policy == "deep":
        return n_con - depth
    if policy in ("weighted", "random"):
        # the shared counter-free (lane, target, depth) hash, in u32
        lanes = torch.arange(depth.shape[0], dtype=I64, device=depth.device)
        h = (lanes * 2654435761 + (fork_dest.to(I64) & M32) * 40503
             + (depth & M32) * 131) & M32
        h = (h >> 16) ^ h
        if policy == "weighted":
            return ((h & 1023) * (depth + 1)) % 65536
        return h & 0x7FFF
    if policy == "coverage":
        if visited is None:
            return torch.zeros_like(depth)
        r = torch.clamp(contract_id, 0, visited.shape[0] - 1).long()
        c = torch.clamp(fork_dest, 0, visited.shape[1] - 1).long()
        return visited[r, c].to(I64)
    raise ValueError(f"unknown fork_policy: {policy}")


def fork_plan_plain(active, fork_req, con_len, fork_dest, contract_id, pc, sp,
                    dropped_forks, fork_cslot, call_enum, visited, *, block: int,
                    policy: str, n_con: int, n_stack: int, defer: bool):
    """Plain version of K7's plan: the JAX packed ``plan_fork_map`` for
    every policy over fork blocks of ``block`` lanes, and the values of
    the per-lane fix-ups that follow the row copy, read from each lane's
    source. Returns K7's (``int32[9, P]``, ``bool[4, P]``) rows
    (``O_*``/``B_*``)."""
    P = active.shape[0]
    B = block
    G = P // B
    ksent = fork_ksent(B)
    dev = active.device
    loc = torch.arange(B, dtype=I64, device=dev)[None, :]
    req = fork_req & active
    free = ~active
    req2, free2 = req.reshape(G, B), free.reshape(G, B)
    key = _policy_key(policy, con_len, fork_dest, contract_id, visited, n_con).reshape(G, B)
    # one sort of the packed (key, lane) composites gives the admission
    # order; a lane's sorted position is its rank
    ukey = torch.where(req2, torch.clamp(key, max=ksent - 1), ksent) * B + loc
    skey = torch.sort(ukey, dim=1).values
    rank = torch.searchsorted(skey, ukey)
    n_free = free2.sum(dim=1, keepdim=True)
    n_req = req2.sum(dim=1, keepdim=True)
    n_adm = torch.clamp(n_free, max=max(1, B // 4)) if policy == "beam" else n_free
    n_admit = torch.minimum(n_adm, n_req)
    free_rank = torch.cumsum(free2.to(I64), dim=1) - free2.to(I64)
    is_copy2 = free2 & (free_rank < n_admit)
    src_i = torch.gather(skey % B, 1, torch.clamp(free_rank, 0, B - 1))
    src2 = torch.where(is_copy2, src_i, loc) + torch.arange(G, device=dev)[:, None] * B
    src = src2.reshape(P)
    is_copy = is_copy2.reshape(P)
    slot = torch.where(req2 & (rank < n_adm), 0, P).reshape(P)
    starved = req & (slot == P)
    cs = fork_cslot[src]
    is_cf = cs >= 0
    pc_s, dest_s, cl_s = pc[src], fork_dest[src], con_len[src]
    pc_new = torch.where(is_copy, dest_s, pc_s)
    sp_new, cl_new = sp[src], cl_s
    ce_new = torch.where(is_copy, 0, call_enum[src])
    n_dropped = torch.zeros_like(starved) if defer else starved
    if defer:
        un_jump = starved & ~is_cf
        pc_new = torch.where(un_jump, pc_s - 1, pc_new)
        sp_new = torch.where(un_jump, sp_new + 2, sp_new)
        cl_new = cl_new - starved.to(I32)
        ce_new = ce_new - (starved & is_cf).to(I32)
    out_i = torch.stack([
        src, slot, pc_new, sp_new, cl_new, torch.where(is_copy, cl_s - 1, -1),
        torch.where(is_copy & is_cf & (cs < n_stack), cs, n_stack), ce_new,
        torch.where(is_copy, 0, dropped_forks[src]) + n_dropped.to(I32)]).to(I32)
    out_b = torch.stack([is_copy, starved & defer, starved, is_copy & (dest_s < pc_s)])
    return out_i, out_b


def _gather_lanes(x, src):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x[src]


def _gather_struct(st, src):
    """Every lane-axis leaf of a TensorStruct gathered by ``src``; scalar
    run totals pass through."""
    import dataclasses

    kw = {}
    for fl in dataclasses.fields(st):
        v = getattr(st, fl.name)
        kw[fl.name] = _gather_struct(v, src) if fl.name == "base" else _gather_lanes(v, src)
    return type(st)(**kw)


def _fork_args(sf, fork_block, fork_policy, defer_starved, visited):
    """``fork_plan_plain``'s arguments for a frontier, and the block size."""
    P = sf.n_lanes
    if fork_block > 0 and P % fork_block != 0:
        raise ValueError(f"fork_block {fork_block} must divide P={P}")
    B = fork_block if fork_block > 0 else P
    b0 = sf.base
    args = (b0.active, sf.fork_req, sf.con_len, sf.fork_dest, b0.contract_id, b0.pc,
            b0.sp, sf.dropped_forks, sf.fork_cslot, sf.call_enum, visited)
    kw = dict(block=B, policy=fork_policy, n_con=sf.con_node.shape[1],
              n_stack=b0.stack.shape[1], defer=defer_starved)
    return B, args, kw


def expand_forks_plain(sf: SymFrontier, loop_bound: int = 0, fork_block: int = 0,
                       fork_policy: str = "fifo", defer_starved: bool = False,
                       visited=None) -> SymFrontier:
    """The plain functional fork expansion (the JAX ``expand_forks``, on
    any device): the fork map of :func:`fork_plan_plain`, a gather of
    every lane-axis field by it into a new frontier, and the fix-ups. The
    reference the in-place route (K7 on the card) is held to."""
    B, args, kw = _fork_args(sf, fork_block, fork_policy, defer_starved, visited)
    out_i, out_b = fork_plan_plain(*args, **kw)
    is_copy, starved = out_b[B_COPY], out_b[B_STARVED]
    b0 = sf.base

    # the iprof residual sidecar is lane-independent: keep it out of the
    # lane gather
    resid = b0.op_resid
    if resid is not None:
        sf = sf.replace(base=b0.replace(op_resid=None))
    new = _gather_struct(sf, out_i[O_SRC].long())
    b = new.base
    src_pc = b.pc - 1
    C = new.con_sign.shape[1]
    last = torch.arange(C, device=b.pc.device)[None, :] == out_i[O_LAST][:, None]
    cidx = out_i[O_CIDX]
    stack_c = ci._write_slot(b.stack, cidx, new.fork_cval)
    stack_sym_c = ci._write_slot(new.stack_sym, cidx, 0)
    hist = b.op_hist
    if defer_starved:
        # the retried JUMPI re-pays its static charge next superstep (10 =
        # G_HIGH); CALL retries refund inside the call handler itself
        un_jump = starved & (new.fork_cslot < 0)
        g_undo = torch.where(un_jump, 10, 0).to(b.gas_min.dtype)
        b = b.replace(gas_min=b.gas_min - g_undo, gas_max=b.gas_max - g_undo)
        if hist is not None:
            # iprof: the un-executed JUMPI (0x57) re-runs next superstep
            hist = hist.clone()
            hist[:, 0x57] -= un_jump.to(I32)
    if hist is not None:
        # a fork copy starts with an empty histogram; the recycled slot's
        # unharvested counts move to the residual sidecar
        resid = resid + torch.where(is_copy[:, None], b0.op_hist, 0).sum(0, dtype=I32)
        hist = torch.where(is_copy[:, None], 0, hist)
    new = new.replace(
        base=b.replace(pc=out_i[O_PC], sp=out_i[O_SP], active=b.active | is_copy,
                       stack=stack_c, op_hist=hist, op_resid=resid),
        stack_sym=stack_sym_c,
        con_sign=torch.where(last, True, new.con_sign),
        con_len=out_i[O_CON_LEN],
        fork_req=out_b[B_FORK_REQ],
        fork_cslot=torch.full_like(new.fork_cslot, -1),
        fork_cval=torch.zeros_like(new.fork_cval),
        call_enum=out_i[O_CALL_ENUM],
        dropped_forks=out_i[O_DROPPED],
        dropped_total=new.dropped_total + (0 if defer_starved else starved.sum(dtype=I32)),
    )
    return _note_backjump(new, out_b[B_BACK], src_pc, new.fork_dest, loop_bound)


def own_fork_fields(sf: SymFrontier, skip=()) -> SymFrontier:
    """``sf`` with fresh, contiguous copies of every field a fork expansion
    writes in place (``kernels.fork_rows``, the profiler's rows and sidecar
    and the run total of dropped forks), but the base fields named in
    ``skip``."""
    from ..kernels import FORK_EXTRA_PATHS, fork_rows

    own = {"base": {}, "sf": {}}
    for path in FORK_EXTRA_PATHS + tuple(fork_rows(sf)):
        owner, _, name = path.rpartition(".")
        t = getattr(sf.base if owner else sf, name)
        if t is not None and not (owner and name in skip):
            own["base" if owner else "sf"][name] = t.clone(memory_format=torch.contiguous_format)
    return sf.replace(base=sf.base.replace(**own["base"]), **own["sf"])


def _expand_plain_inplace(sf: SymFrontier, loop_bound: int, fork_block: int,
                          fork_policy: str, defer_starved: bool, visited, paths):
    """The in-place route's plain version: :func:`fork_plan_plain`, each
    copy lane's row of every field in ``paths`` from its source, then the
    fix-ups, each lane's from its own (copied) row, as K7 makes them."""
    _, args, kw = _fork_args(sf, fork_block, fork_policy, defer_starved, visited)
    out_i, out_b = fork_plan_plain(*args, **kw)
    is_copy, starved = out_b[B_COPY], out_b[B_STARVED]
    dst = torch.nonzero(is_copy).flatten()
    src = out_i[O_SRC][dst].long()
    b = sf.base
    for path in paths:
        owner, _, name = path.rpartition(".")
        t = getattr(b if owner else sf, name)
        t[dst] = t[src]
    # what the fix-ups read of a lane's row before they write it
    cslot, pc_old = sf.fork_cslot.clone(), b.pc.clone()
    cidx, last = out_i[O_CIDX].long(), out_i[O_LAST].long()
    w = torch.nonzero((cidx >= 0) & (cidx < b.stack.shape[1])).flatten()
    b.stack[w, cidx[w]] = sf.fork_cval[w]
    sf.stack_sym[w, cidx[w]] = 0
    w = torch.nonzero((last >= 0) & (last < sf.con_sign.shape[1])).flatten()
    sf.con_sign[w, last[w]] = True
    hist = b.op_hist
    if defer_starved:
        un_jump = starved & (cslot < 0)
        g_undo = torch.where(un_jump, 10, 0).to(b.gas_min.dtype)
        b.gas_min.sub_(g_undo)
        b.gas_max.sub_(g_undo)
        if hist is not None:
            hist[:, 0x57] -= un_jump.to(I32)
    if hist is not None:
        b.op_resid.add_(hist[dst].sum(0, dtype=I32))
        hist[dst] = 0
    for t, row in ((b.pc, O_PC), (b.sp, O_SP), (sf.con_len, O_CON_LEN),
                   (sf.call_enum, O_CALL_ENUM), (sf.dropped_forks, O_DROPPED)):
        t.copy_(out_i[row])
    b.active |= is_copy
    sf.fork_req.copy_(out_b[B_FORK_REQ])
    sf.fork_cslot.fill_(-1)
    sf.fork_cval.zero_()
    if not defer_starved:
        sf.dropped_total.add_(starved.sum(dtype=I32))
    if loop_bound > 0:
        new = _note_backjump(sf, out_b[B_BACK], pc_old - 1, sf.fork_dest, loop_bound)
        for k in ("lb_key", "lb_cnt", "lb_len"):
            getattr(sf, k).copy_(getattr(new, k))
        b.error.copy_(new.base.error)
        b.err_code.copy_(new.base.err_code)
    return sf


def expand_forks_inplace(sf: SymFrontier, loop_bound: int = 0, fork_block: int = 0,
                         fork_policy: str = "fifo", defer_starved: bool = False,
                         visited=None, k7=None) -> SymFrontier:
    """:func:`expand_forks` in place on the fields of ``sf``, which the
    caller owns (``sym_run`` owns them from its entry,
    :func:`own_loop_fields`): K7 on the card (one checked call through
    the descriptor ``k7``, ``kernels.ForkExpand``, which the loop builds
    once), its plain version on the CPU. ``k7`` None: a descriptor of its
    own. -> ``sf``, the same tensors but where the descriptor made a
    non-contiguous field contiguous."""
    if k7 is None:
        from ..kernels import ForkExpand

        k7 = ForkExpand.for_frontier(sf)
    B, _, _ = _fork_args(sf, fork_block, fork_policy, defer_starved, visited)
    if sf.base.pc.is_cuda:
        from ..kernels import fork_plan

        return fork_plan(sf, block=B, policy=fork_policy, defer=defer_starved,
                         loop_bound=loop_bound, visited=visited, k7=k7)
    sf = k7.bind(sf)
    return _expand_plain_inplace(sf, loop_bound, B, fork_policy, defer_starved, visited,
                                 k7.rows)


def expand_forks(sf: SymFrontier, loop_bound: int = 0, fork_block: int = 0,
                 fork_policy: str = "fifo", defer_starved: bool = False,
                 visited=None) -> SymFrontier:
    """Materialize fork requests: copy each forking lane into a free lane
    of its fork block, point the copy at the jump target, and flip its
    final path-condition sign to "taken". Forks beyond capacity are
    counted in ``dropped_forks``, or with ``defer_starved`` un-execute
    their branch decision and retry next superstep.

    ``fork_block`` confines copies to blocks of that many lanes (0 = one
    block of P); ``fork_policy`` (fifo, shallow, deep, random, weighted,
    coverage, beam) orders admission when free slots run short;
    ``visited`` (``bool[C, MC]``) feeds the coverage policy.

    The input is never changed: the fields are copied first
    (:func:`own_fork_fields`) and the copy expanded in place
    (:func:`expand_forks_inplace`: kernel K7 on the card, its plain
    version on the CPU)."""
    return expand_forks_inplace(own_fork_fields(sf), loop_bound, fork_block, fork_policy,
                                defer_starved, visited)


def _detach_resid(sf: SymFrontier):
    resid = sf.base.op_resid
    if resid is not None:
        sf = sf.replace(base=sf.base.replace(op_resid=None))
    return sf, resid


def _move_lanes(sf: SymFrontier, src, dst):
    """Every lane-axis leaf with lanes ``src`` copied onto lanes ``dst``."""
    import dataclasses

    def move(st):
        kw = {}
        for fl in dataclasses.fields(st):
            v = getattr(st, fl.name)
            if fl.name == "base":
                v = move(v)
            elif isinstance(v, torch.Tensor) and v.dim() > 0:
                v = v.clone()
                v[dst] = v[src]
            kw[fl.name] = v
        return type(st)(**kw)

    return move(sf)


def rebalance_parked(sf: SymFrontier, fork_block: int = 0, active=None, fork_req=None):
    """Move persistently starved fork-requesting lanes into other blocks'
    free slots (the JAX ``rebalance_parked``): planned on the host at the
    chunk seam from ``active``/``fork_req`` (host copies a caller already
    holds, else read here), applied as one device move per leaf. A parked
    lane whose own block has no free slot goes to the block with the most
    free slots, if that has at least two. Returns ``(sf, n_moved)``."""
    if active is None:
        active = sf.base.active.cpu().numpy()
    if fork_req is None:
        fork_req = sf.fork_req.cpu().numpy()
    parked = np.asarray(fork_req) & np.asarray(active)
    if not parked.any():
        return sf, 0
    P = parked.shape[0]
    B = fork_block if fork_block > 0 else P
    G = P // B
    free = ~np.asarray(active)
    free_cnt = free.reshape(G, B).sum(axis=1)
    free_lists = [list(np.where(free.reshape(G, B)[g])[0] + g * B) for g in range(G)]
    src_idx, dst_idx = [], []
    for lane in np.where(parked)[0]:
        g = lane // B
        if free_cnt[g] > 0:
            continue  # the local retry will succeed on its own
        g2 = int(np.argmax(free_cnt))
        if free_cnt[g2] < 2:
            continue  # no global headroom for (lane + its fork)
        dst = free_lists[g2].pop()
        free_cnt[g2] -= 1
        src_idx.append(int(lane))
        dst_idx.append(int(dst))
        # the vacated slot serves the source block's remaining requests
        free_cnt[g] += 1
        free_lists[g].append(int(lane))
    if not src_idx:
        return sf, 0
    dev = sf.base.pc.device
    src = torch.as_tensor(src_idx, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst_idx, dtype=torch.long, device=dev)
    old_hist = sf.base.op_hist
    sf, resid = _detach_resid(sf)
    new = _move_lanes(sf, src, dst)
    b = new.base
    active_t = b.active.clone()
    active_t[src] = False
    hist = b.op_hist
    if hist is not None:
        # iprof: the moved rows travel with their lanes; the vacated rows
        # zero and the destinations' earlier rows go to the sidecar
        resid = resid + old_hist[dst].sum(0, dtype=I32)
        hist[src] = 0
    fork_req_t = new.fork_req.clone()
    fork_req_t[src] = False
    return new.replace(base=b.replace(active=active_t, op_hist=hist, op_resid=resid),
                       fork_req=fork_req_t), len(src_idx)


def migrate_parked_device(sf: SymFrontier, fork_block: int, mig_cap: int = 8) -> SymFrontier:
    """In-loop cross-block migration of starved fork-requesting lanes (the
    JAX ``migrate_parked_device``): a parked lane whose block has no free
    slot moves, through a compact ``[G, MIG]`` buffer, to a block with at
    least two free slots (freer blocks fill first); at most ``mig_cap``
    lanes leave or enter a block per call. The moved lane keeps its fork
    request; its old slot deactivates. Plain PyTorch, no host read."""
    P = sf.n_lanes
    B = fork_block if fork_block > 0 else P
    G = P // B
    if G <= 1:
        return sf
    MIG = max(1, min(mig_cap, B // 2))
    NF = G * MIG
    dev = sf.base.pc.device
    old_hist = sf.base.op_hist
    sf, resid = _detach_resid(sf)
    ab = sf.base.active.reshape(G, B)
    stb = (sf.fork_req & sf.base.active).reshape(G, B)
    freeb = ~ab
    fc = freeb.sum(dim=1, dtype=I32)
    expb = stb & (fc == 0)[:, None]
    r_exp = torch.cumsum(expb.to(I32), dim=1, dtype=I32) - 1
    sel = expb & (r_exp < MIG)
    n_exp = torch.clamp(expb.sum(dim=1, dtype=I32), max=MIG)
    hit = sel[:, :, None] & (r_exp[:, :, None] == torch.arange(MIG, device=dev)[None, None, :])
    exp_idx = torch.where(hit.any(dim=1), first_true(hit, dim=1), B)  # [G, MIG]
    cap = torch.clamp(fc - 1, 0, MIG)
    order = torch.sort(-fc, stable=True).indices
    cap_sorted = cap[order]
    ioff_sorted = torch.cumsum(cap_sorted, 0, dtype=I32) - cap_sorted
    ioff = torch.zeros(G, dtype=I32, device=dev)
    ioff[order] = ioff_sorted
    total_cap = cap.sum(dtype=I32)
    eoff = torch.cumsum(n_exp, 0, dtype=I32) - n_exp
    total_exp = n_exp.sum(dtype=I32)
    M = torch.minimum(total_exp, total_cap)
    grank = eoff[:, None] + torch.arange(MIG, dtype=I32, device=dev)[None, :]
    valid_e = torch.arange(MIG, device=dev)[None, :] < n_exp[:, None]
    flat_ids = torch.arange(NF, dtype=I32, device=dev).reshape(G, MIG)
    src_of_rank = torch.full((NF + 1,), NF, dtype=I32, device=dev)
    src_of_rank[torch.where(valid_e, grank, NF).reshape(-1).long()] = flat_ids.reshape(-1)
    src_of_rank = src_of_rank[:NF]
    r_free = torch.cumsum(freeb.to(I32), dim=1, dtype=I32) - 1
    imp_take = torch.clamp(M - ioff, min=0)
    imp_take = torch.minimum(imp_take, cap)
    is_imp = freeb & (r_free < imp_take[:, None])
    q = ioff[:, None] + r_free
    srcflat = src_of_rank[torch.clamp(q, 0, NF - 1).long()]
    srcflat = torch.where(is_imp, srcflat, 0).long()
    exported = sel & ((eoff[:, None] + r_exp) < M)
    imp_flat = is_imp.reshape(P)
    # the buffer's lane ids: block g, slot j <- lane g*B + exp_idx (clipped)
    buf_lane = (torch.clamp(exp_idx, 0, B - 1)
                + torch.arange(G, device=dev)[:, None] * B).reshape(NF).long()
    src_lane = buf_lane[srcflat.reshape(P)]
    src_lane = torch.where(imp_flat, src_lane, torch.arange(P, device=dev))
    new = _gather_struct(sf, src_lane)
    vac = exported.reshape(P)
    b = new.base.replace(active=new.base.active & ~vac)
    if b.op_hist is not None:
        resid = resid + torch.where(imp_flat[:, None], old_hist, 0).sum(0, dtype=I32)
        b = b.replace(op_hist=torch.where(vac[:, None], 0, b.op_hist))
    return new.replace(base=b.replace(op_resid=resid), fork_req=new.fork_req & ~vac)


# lanes run by every superstep so far, the supersteps and the feasibility
# sweeps (read from the loop's own per-step check, so they cost no extra
# sync). With
# ENGINE_STATS["timing"] set, each stage of the loop is also timed on the
# host clock between device synchronizations (a measurement mode: the
# extra syncs slow the loop down).
ENGINE_STATS = {"lane_steps": 0, "supersteps": 0, "sweeps": 0, "timing": False,
                "superstep_s": 0.0, "forks_s": 0.0, "propagate_s": 0.0}
# sub-frames pushed (CALL family and constructor frames) and returned; the
# sums stay on the device (no sync) until a caller reads them with int()
FRAME_STATS = {"pushed": 0, "popped": 0}


def _count_frames(key, mask):
    FRAME_STATS[key] = FRAME_STATS[key] + mask.sum()


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
            fork_block: int = 0,
            track_coverage: bool = False,
            fork_policy: str = "fifo",
            defer_starved: bool = False,
            migrate_every: int = 0):
    """Run the symbolic engine until quiescence or ``max_steps``
    supersteps (the JAX ``_sym_run_impl`` with the ``packed`` fork map).
    ``propagate_every`` > 0 interleaves feasibility sweeps; None uses
    ``limits.propagate_every``; the cadence counts from this call's first
    step. ``fork_block`` confines fork copies to lane blocks and
    ``fork_policy`` orders their admission (:func:`expand_forks`; the
    coverage policy reads this call's visited bitmap when
    ``track_coverage`` is on). ``migrate_every`` > 0 with
    ``defer_starved`` and several blocks runs
    :func:`migrate_parked_device` every that many supersteps. With
    ``track_coverage`` a ``bool[C, MAX_CODE]`` visited-pc bitmap is
    returned too.

    The JAX ``while_loop``'s ``any(running)`` condition is one host read
    per step (of the running-lane count), the fork-expansion cond one
    more, and the migration cond one more on its cadence.

    The input is never changed. What the loop writes in place is copied
    once, on entry (:func:`own_loop_fields`: every field, since a fork
    expansion copies rows of each), and K10's, K3's and K7's descriptors
    are built once: every superstep of the call then runs K10 in place on
    those copies (see :func:`_sym_superstep`), K3 appends to a tape
    marshaled once (:func:`_loop_k3`), and each fork expansion runs in
    place (:func:`expand_forks_inplace`), so the tensors the other
    descriptors point at stay the same. The frontier the caller passed —
    the wrapper's between chunks, a saved checkpoint, a batch the campaign
    retries — keeps its tensors as they were."""
    from .propagate import kill_infeasible

    if propagate_every is None:
        propagate_every = limits.propagate_every
    from ..kernels import ForkExpand

    k10 = ci.k10_for(sf.base, limits.gas_schedule == "berlin")
    sf = own_loop_fields(sf, k10, forks=True)
    k7 = ForkExpand.for_frontier(sf)
    P = sf.n_lanes
    C, MC = corpus.code.shape
    # row C of the bitmap takes the lanes that write nowhere
    visited = torch.zeros((C + 1, MC), dtype=torch.bool, device=sf.tape_op.device)
    migrate = migrate_every > 0 and defer_starved and 0 < fork_block < P
    with _loop_k3(sf.tape_op.device):
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
            sf = _stage("superstep_s", _sym_superstep, sf, env, corpus, spec, limits, k10)
            if ci.host_bool(torch.any(sf.fork_req & sf.base.active)):
                sf = _stage("forks_s", expand_forks_inplace, sf, limits.loop_bound,
                            fork_block, fork_policy, defer_starved,
                            visited[:C] if track_coverage else None, k7)
            if propagate_every and (i % propagate_every) == propagate_every - 1:
                ENGINE_STATS["sweeps"] += 1
                sf = _stage("propagate_s", kill_infeasible, sf)
            if migrate and (i % migrate_every) == migrate_every - 1:
                # fire only when some exhausted block starves AND some block
                # has room for a lane and its fork
                occ = sf.base.active.reshape(-1, fork_block).sum(dim=1)
                starving = (sf.fork_req & sf.base.active).reshape(-1, fork_block).any(dim=1)
                if ci.host_bool(torch.any(starving & (occ == fork_block))
                                & torch.any(occ <= fork_block - 2)):
                    sf = migrate_parked_device(sf, fork_block)
    if track_coverage:
        return sf, visited[:C]
    return sf
