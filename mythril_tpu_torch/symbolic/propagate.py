"""Batched feasibility propagation: unsigned-interval + known-bits
abstract interpretation over the per-lane SSA tapes (plain PyTorch).

Counterpart of the JAX package's ``symbolic/propagate.py``: one forward
pass assigns every new tape node an unsigned interval [lo, hi] and a
known-bits pair (mask, value); a path constraint ``(node, sign)`` is
contradicted when either domain proves the node can't be nonzero
(sign=true) or can't be zero (sign=false), and such lanes are killed.
Both domains only over-approximate, so a kill is always correct.

The pass is incremental: lane p walks its nodes [prop_len[p],
tape_len[p]). On the card the sweep and the constraint check are kernel
K6 (``kernels/csrc/propagate_sweep.cu``): one warp per lane, its new
nodes in windows of 32 taken in dependency rounds, in place on the
domain tensors, with no host read. On the CPU the plain version
below runs the JAX loop: max-new-nodes lock-step iterations over all
lanes (that count read once per sweep).
"""

from __future__ import annotations

import torch

from ..ops import u256
from .ops import SymOp, FreeKind
from .state import SymFrontier

I32 = torch.int32
I64 = torch.int64
M32 = u256.MASK32


def _bound_2exp(ref, bits: int):
    """Inclusive upper bound 2^bits - 1 as limbs, shaped like ref."""
    full, rem = bits // 32, bits % 32
    vals = [M32 if limb < full else ((1 << rem) - 1 if limb == full and rem else 0)
            for limb in range(8)]
    return torch.as_tensor(vals, dtype=I64, device=ref.device).expand_as(ref)


def _const_word(ref, value: int):
    return u256.word(value, ref.device).expand_as(ref)


def _sel(op, code: int):
    return (op == int(code))[:, None]


def _node_domains(op, a_id, b_id, imm, la, ha, lb, hb, ka, va, kb, vb):
    """Interval and known-bits transfer for one node per lane."""
    top_lo = torch.zeros_like(la)
    top_hi = torch.full_like(ha, M32)
    zero = top_lo
    r_lo, r_hi = top_lo, top_hi
    is_const = op == int(SymOp.CONST)
    r_lo = torch.where(is_const[:, None], imm, r_lo)
    r_hi = torch.where(is_const[:, None], imm, r_hi)
    is_free = op == int(SymOp.FREE)
    kind = a_id  # FREE stores kind in a
    addr_hi = _bound_2exp(ha, 160)
    small_hi = _bound_2exp(ha, 64)
    is_addr = ((kind == int(FreeKind.CALLER)) | (kind == int(FreeKind.ORIGIN)))[:, None]
    is_small = ((kind == int(FreeKind.CALLDATASIZE)) | (kind == int(FreeKind.TIMESTAMP))
                | (kind == int(FreeKind.NUMBER)))[:, None]
    free_hi = torch.where(is_addr, addr_hi, top_hi)
    free_hi = torch.where(is_small, small_hi, free_hi)
    r_lo = torch.where(is_free[:, None], 0, r_lo)
    r_hi = torch.where(is_free[:, None], free_hi, r_hi)

    sing_a = torch.all(la == ha, dim=-1)
    sing_b = torch.all(lb == hb, dim=-1)
    b_all_zero = u256.is_zero(hb)

    # ADD: exact unless the hi sum wraps
    s_lo, _ = u256.add_carry(la, lb)
    s_hi, c_hi = u256.add_carry(ha, hb)
    add_exact = ~c_hi
    r_lo = torch.where(_sel(op, SymOp.ADD), torch.where(add_exact[:, None], s_lo, 0), r_lo)
    r_hi = torch.where(_sel(op, SymOp.ADD), torch.where(add_exact[:, None], s_hi, top_hi), r_hi)

    # SUB: exact when a surely >= b
    no_wrap = u256.gte(la, hb)
    d_lo = u256.sub(la, hb)
    d_hi = u256.sub(ha, lb)
    r_lo = torch.where(_sel(op, SymOp.SUB), torch.where(no_wrap[:, None], d_lo, 0), r_lo)
    r_hi = torch.where(_sel(op, SymOp.SUB), torch.where(no_wrap[:, None], d_hi, top_hi), r_hi)

    # MUL: exact when hi*hi fits 256 bits
    wide = u256.mul_wide(ha, hb)
    fits = torch.all(wide[:, 8:] == 0, dim=-1)
    m_lo = u256.mul(la, lb)
    m_hi = wide[:, :8]
    r_lo = torch.where(_sel(op, SymOp.MUL), torch.where(fits[:, None], m_lo, 0), r_lo)
    r_hi = torch.where(_sel(op, SymOp.MUL), torch.where(fits[:, None], m_hi, top_hi), r_hi)

    # DIV: result <= a_hi
    r_lo = torch.where(_sel(op, SymOp.DIV), 0, r_lo)
    r_hi = torch.where(_sel(op, SymOp.DIV), ha, r_hi)

    # MOD: < b_hi (and <= a_hi); b identically 0 -> result 0
    one = _const_word(hb, 1)
    b_minus_1 = u256.sub(hb, one)
    mod_cap = torch.where(u256.lt(ha, b_minus_1)[:, None], ha, b_minus_1)
    mod_hi = torch.where(b_all_zero[:, None], 0, mod_cap)
    r_lo = torch.where(_sel(op, SymOp.MOD), 0, r_lo)
    r_hi = torch.where(_sel(op, SymOp.MOD), mod_hi, r_hi)

    # AND: <= min(a_hi, b_hi)
    and_hi = torch.where(u256.lt(ha, hb)[:, None], ha, hb)
    r_lo = torch.where(_sel(op, SymOp.AND), 0, r_lo)
    r_hi = torch.where(_sel(op, SymOp.AND), and_hi, r_hi)

    # OR: >= max(a_lo, b_lo)
    or_lo = torch.where(u256.gt(la, lb)[:, None], la, lb)
    r_lo = torch.where(_sel(op, SymOp.OR), or_lo, r_lo)

    # NOT: exact complement flip
    r_lo = torch.where(_sel(op, SymOp.NOT), u256.bit_not(ha), r_lo)
    r_hi = torch.where(_sel(op, SymOp.NOT), u256.bit_not(la), r_hi)

    # BYTE: [0, 255]
    byte_hi = _const_word(ha, 255)
    r_lo = torch.where(_sel(op, SymOp.BYTE), 0, r_lo)
    r_hi = torch.where(_sel(op, SymOp.BYTE), byte_hi, r_hi)

    # SHR by singleton shift: exact; else [0, value_hi]
    shr_lo = torch.where(sing_a[:, None], u256.shr(la, lb), 0)
    shr_hi = torch.where(sing_a[:, None], u256.shr(la, hb), hb)
    r_lo = torch.where(_sel(op, SymOp.SHR), shr_lo, r_lo)
    r_hi = torch.where(_sel(op, SymOp.SHR), shr_hi, r_hi)

    # SHL by singleton shift: exact when hi<<k doesn't lose bits
    c256 = _const_word(la, 256)
    k_small = sing_a & u256.lt(la, c256)
    shifted_hi = u256.shl(la, hb)
    back = u256.shr(la, shifted_hi)
    shl_ok = k_small & u256.eq(back, hb)
    r_lo = torch.where(_sel(op, SymOp.SHL), torch.where(shl_ok[:, None], u256.shl(la, lb), 0),
                       r_lo)
    r_hi = torch.where(_sel(op, SymOp.SHL), torch.where(shl_ok[:, None], shifted_hi, top_hi),
                       r_hi)

    # boolean producers: result in [0,1], sharpened when decidable
    t_one = one

    def bool_iv(surely_true, surely_false):
        return (torch.where(surely_true[:, None], t_one, zero),
                torch.where(surely_false[:, None], zero, t_one))

    blo, bhi = bool_iv(u256.lt(ha, lb), u256.gte(la, hb))
    r_lo = torch.where(_sel(op, SymOp.LT), blo, r_lo)
    r_hi = torch.where(_sel(op, SymOp.LT), bhi, r_hi)
    blo, bhi = bool_iv(u256.gt(la, hb), u256.lte(ha, lb))
    r_lo = torch.where(_sel(op, SymOp.GT), blo, r_lo)
    r_hi = torch.where(_sel(op, SymOp.GT), bhi, r_hi)
    eq_t = sing_a & sing_b & u256.eq(la, lb)
    eq_f = u256.lt(ha, lb) | u256.lt(hb, la)
    blo, bhi = bool_iv(eq_t, eq_f)
    r_lo = torch.where(_sel(op, SymOp.EQ), blo, r_lo)
    r_hi = torch.where(_sel(op, SymOp.EQ), bhi, r_hi)
    blo, bhi = bool_iv(u256.is_zero(ha), ~u256.is_zero(la))
    r_lo = torch.where(_sel(op, SymOp.ISZERO), blo, r_lo)
    r_hi = torch.where(_sel(op, SymOp.ISZERO), bhi, r_hi)
    undecided = torch.zeros_like(sing_a)
    blo, bhi = bool_iv(undecided, undecided)
    slt_sgt = ((op == int(SymOp.SLT)) | (op == int(SymOp.SGT)))[:, None]
    r_lo = torch.where(slt_sgt, blo, r_lo)
    r_hi = torch.where(slt_sgt, bhi, r_hi)

    # --- known-bits transfer (default: nothing known) ---
    all1 = top_hi
    rm = torch.where(is_const[:, None], all1, zero)
    rv = torch.where(is_const[:, None], imm, zero)
    free_km = torch.where(is_addr, u256.bit_not(addr_hi), zero)
    free_km = torch.where(is_small, u256.bit_not(small_hi), free_km)
    rm = torch.where(is_free[:, None], free_km, rm)

    nva, nvb = u256.bit_not(va), u256.bit_not(vb)
    and_m = (ka & kb) | (ka & nva) | (kb & nvb)
    rm = torch.where(_sel(op, SymOp.AND), and_m, rm)
    rv = torch.where(_sel(op, SymOp.AND), va & vb & and_m, rv)
    or_m = (ka & kb) | (ka & va) | (kb & vb)
    rm = torch.where(_sel(op, SymOp.OR), or_m, rm)
    rv = torch.where(_sel(op, SymOp.OR), (va | vb) & or_m, rv)
    rm = torch.where(_sel(op, SymOp.XOR), ka & kb, rm)
    rv = torch.where(_sel(op, SymOp.XOR), (va ^ vb) & ka & kb, rv)
    rm = torch.where(_sel(op, SymOp.NOT), ka, rm)
    rv = torch.where(_sel(op, SymOp.NOT), nva & ka, rv)

    # shifts by a singleton amount (tape operand order: a = shift, b = value)
    shift_conc = sing_a & u256.lt(la, c256)
    ones_shr = u256.shr(la, all1)
    ones_shl = u256.shl(la, all1)
    shr_m = u256.shr(la, kb) | u256.bit_not(ones_shr)
    shl_m = u256.shl(la, kb) | u256.bit_not(ones_shl)
    is_shr_c = ((op == int(SymOp.SHR)) & shift_conc)[:, None]
    is_shl_c = ((op == int(SymOp.SHL)) & shift_conc)[:, None]
    rm = torch.where(is_shr_c, shr_m, rm)
    rv = torch.where(is_shr_c, u256.shr(la, vb), rv)
    rm = torch.where(is_shl_c, shl_m, rm)
    rv = torch.where(is_shl_c, u256.shl(la, vb), rv)

    is_bool = ((op == int(SymOp.LT)) | (op == int(SymOp.GT)) | (op == int(SymOp.SLT))
               | (op == int(SymOp.SGT)) | (op == int(SymOp.EQ))
               | (op == int(SymOp.ISZERO)))[:, None]
    not_one = u256.bit_not(t_one)
    diff = (va ^ vb) & ka & kb
    kb_ne = ~u256.is_zero(diff)
    a_full = torch.all(ka == M32, dim=-1)
    b_full = torch.all(kb == M32, dim=-1)
    kb_eq = a_full & b_full & u256.is_zero(va ^ vb)
    isz_nz = ~u256.is_zero(va & ka)
    isz_z = a_full & u256.is_zero(va)
    rm = torch.where(is_bool, not_one, rm)
    rv = torch.where(is_bool, 0, rv)
    is_eq = op == int(SymOp.EQ)
    is_isz = op == int(SymOp.ISZERO)
    dec = (is_eq & (kb_ne | kb_eq)) | (is_isz & (isz_nz | isz_z))
    dec_one = (is_eq & kb_eq) | (is_isz & isz_z)
    rm = torch.where(dec[:, None], all1, rm)
    rv = torch.where(dec_one[:, None], t_one, rv)
    return r_lo, r_hi, rm, rv


def propagate_feasibility(sf: SymFrontier):
    """INCREMENTAL forward pass over every lane's tape. Returns ``(sf,
    infeasible)``: the frontier with updated domain tensors + ``prop_len``,
    and the per-lane infeasibility verdict. A CUDA frontier goes to K6,
    which updates the domain tensors and ``prop_len`` in place; a CPU
    frontier to :func:`propagate_feasibility_plain`."""
    if sf.tape_op.is_cuda:
        from ..kernels import propagate_sweep

        infeasible = propagate_sweep(
            sf.tape_op, sf.tape_a, sf.tape_b, sf.tape_imm, sf.tape_len, sf.prop_len,
            sf.iv_lo, sf.iv_hi, sf.kb_m, sf.kb_v, sf.con_node, sf.con_sign, sf.con_len)
        return sf, infeasible
    return propagate_feasibility_plain(sf)


def propagate_feasibility_plain(sf: SymFrontier):
    """Plain version of K6: the same pass as lock-step PyTorch over all
    lanes, on new domain tensors."""
    from ..core.interpreter import host_list

    P, T = sf.tape_op.shape
    lo, hi, km, kv = sf.iv_lo.clone(), sf.iv_hi.clone(), sf.kb_m.clone(), sf.kb_v.clone()
    lanes = torch.arange(P, device=lo.device)
    base_idx = torch.clamp(sf.prop_len, min=1)
    stop = host_list(torch.max(sf.tape_len - base_idx))
    for j in range(max(0, stop)):
        idx = base_idx + j
        ci = torch.clamp(idx, 0, T - 1).long()
        op = sf.tape_op[lanes, ci]
        a_id = sf.tape_a[lanes, ci]
        b_id = sf.tape_b[lanes, ci]
        imm = sf.tape_imm[lanes, ci]
        ai = torch.clamp(a_id, 0, T - 1).long()
        bi = torch.clamp(b_id, 0, T - 1).long()
        r_lo, r_hi, rm, rv = _node_domains(
            op, a_id, b_id, imm, lo[lanes, ai], hi[lanes, ai], lo[lanes, bi], hi[lanes, bi],
            km[lanes, ai], kv[lanes, ai], km[lanes, bi], kv[lanes, bi])
        live = ((idx >= 1) & (idx < sf.tape_len) & (op != int(SymOp.NULL)))[:, None]
        lo[lanes, ci] = torch.where(live, r_lo, lo[lanes, ci])
        hi[lanes, ci] = torch.where(live, r_hi, hi[lanes, ci])
        km[lanes, ci] = torch.where(live, rm, km[lanes, ci])
        kv[lanes, ci] = torch.where(live, rv, kv[lanes, ci])
    sf = sf.replace(iv_lo=lo, iv_hi=hi, kb_m=km, kb_v=kv,
                    prop_len=torch.maximum(sf.prop_len, sf.tape_len))

    # constraint check (either domain may contradict)
    C = sf.con_node.shape[1]
    con_live = torch.arange(C, device=lo.device)[None, :] < sf.con_len[:, None]
    node = torch.clamp(sf.con_node, 0, T - 1).long()
    n_lo = lo[lanes[:, None], node]
    n_hi = hi[lanes[:, None], node]
    n_km = km[lanes[:, None], node]
    n_kv = kv[lanes[:, None], node]
    cant_be_nonzero = torch.all(n_hi == 0, dim=-1) | (
        torch.all(n_km == M32, dim=-1) & torch.all(n_kv == 0, dim=-1))
    cant_be_zero = ~torch.all(n_lo == 0, dim=-1) | torch.any((n_kv & n_km) != 0, dim=-1)
    contradicted = con_live & (sf.con_node != 0) & torch.where(
        sf.con_sign, cant_be_nonzero, cant_be_zero)
    return sf, torch.any(contradicted, dim=1)


def kill_infeasible(sf: SymFrontier) -> SymFrontier:
    """Deactivate lanes whose path condition is provably unsatisfiable."""
    sf, inf = propagate_feasibility(sf)
    inf = inf & sf.base.active & ~sf.base.error
    return sf.replace(
        base=sf.base.replace(active=sf.base.active & ~inf),
        fork_req=sf.fork_req & ~inf,
        killed_infeasible=sf.killed_infeasible | inf,
        killed_total=sf.killed_total + inf.sum(dtype=I32),
    )
