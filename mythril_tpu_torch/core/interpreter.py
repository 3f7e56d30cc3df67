"""Vectorized concrete EVM superstep over a PyTorch frontier.

Counterpart of the JAX package's ``core/interpreter.py``. A frontier on a
CUDA device goes through kernel K10 (``kernels/csrc/evm_step.cu``): one
thread per lane runs the lane's own step, in place on fields the caller
owns, and :func:`run` makes one fused launch per superstep and one host
read every ``RUN_READ_EVERY``. A frontier on the CPU goes
through the plain versions here (``prologue_plain``, ``dispatch_plain``,
``epilogue_plain``, ``superstep_plain``, ``run_plain``), which
``chip_smoke.py`` also calls by name on the card to hold K10 to them.
Their arithmetic and SHA3 stay plain PyTorch on every device (``ops/u256``,
``keccak256_plain``), so that reference shares no code with the kernel.

The plain versions run handlers on the WHOLE frontier with a lane mask;
every update is ``torch.where(mask, new, old)``. Dispatch is per opcode
*class*: the JAX code puts each class behind ``lax.cond(any(mask))``;
here the presence of every class is read back to the host in ONE
transfer per superstep (:func:`dispatch_plain`) and only present classes
run.

TPU-only forms of the JAX code are dropped, their results kept: slot
writes use per-lane indexing (``_use_scatter``'s CPU branch), handlers run
directly instead of through ``narrow_cond``, and the ``while_loop`` of
:func:`run_plain` is a Python loop with one host check per step.

CALL/CREATE are stubbed at this layer (success push), as in the JAX code;
the symbolic engine refuses them (see ``symbolic/engine.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..disassembler import opcodes as oc
from ..ops import u256
from ..ops.keccak import keccak256_plain
from .frontier import Frontier, Env, Corpus, Trap, first_true

I64 = torch.int64
I32 = torch.int32
U8 = torch.uint8

# ---------------------------------------------------------------------------
# Opcode classes (dispatch granularity)
# ---------------------------------------------------------------------------

CLS_STACK, CLS_ALU, CLS_MUL, CLS_DIVMOD, CLS_MODARITH, CLS_EXP, CLS_SHA3, CLS_ENV, \
    CLS_COPY, CLS_MEM, CLS_STORAGE, CLS_JUMP, CLS_HALT, CLS_LOG, CLS_CALL, CLS_CREATE = range(16)

N_CLASSES = 16


def _build_class_table() -> np.ndarray:
    t = np.full(256, CLS_HALT, dtype=np.int32)  # invalid opcodes -> filtered by IS_VALID

    def s(codes, cls):
        for c in codes:
            t[c] = cls

    s([0x50, 0x58, 0x59, 0x5A, 0x5B] + list(range(0x5F, 0xA0)), CLS_STACK)
    s([0x01, 0x03, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19,
       0x0B, 0x1A, 0x1B, 0x1C, 0x1D], CLS_ALU)
    s([0x02], CLS_MUL)
    s([0x04, 0x05, 0x06, 0x07], CLS_DIVMOD)
    s([0x08, 0x09], CLS_MODARITH)
    s([0x0A], CLS_EXP)
    s([0x20], CLS_SHA3)
    s([0x30, 0x31, 0x32, 0x33, 0x34, 0x35, 0x36, 0x38, 0x3A, 0x3B, 0x3D, 0x3F,
       0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48], CLS_ENV)
    s([0x37, 0x39, 0x3C, 0x3E], CLS_COPY)
    s([0x51, 0x52, 0x53], CLS_MEM)
    s([0x54, 0x55], CLS_STORAGE)
    s([0x56, 0x57], CLS_JUMP)
    s([0x00, 0xF3, 0xFD, 0xFE, 0xFF], CLS_HALT)
    s(list(range(0xA0, 0xA5)), CLS_LOG)
    s([0xF1, 0xF2, 0xF4, 0xFA], CLS_CALL)
    s([0xF0, 0xF5], CLS_CREATE)
    return t


CLASS_TABLE = _build_class_table()

# keccak256(b"") — EXTCODEHASH of an existing account without code
_EMPTY_KECCAK_INT = 0xC5D2460186F7233C927E7DB2DCC703C0E500B653CA82273B7BFAD8045D85A470


class Tables:
    """The opcode metadata tables, on one device (cached per device)."""

    _cache: dict = {}

    def __init__(self, device):
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        self.STACK_IN = t(oc.STACK_IN, I32)
        self.STACK_OUT = t(oc.STACK_OUT, I32)
        self.PUSHES = t(oc.STACK_OUT > 0, torch.bool)
        self.D_SP = t(oc.STACK_OUT - oc.STACK_IN, I32)
        self.GAS_MIN = t(oc.GAS_MIN, I64)
        self.GAS_MAX = t(oc.GAS_MAX, I64)
        self.GAS_MIN_BERLIN = t(oc.GAS_MIN_BERLIN, I64)
        self.GAS_MAX_BERLIN = t(oc.GAS_MAX_BERLIN, I64)
        self.PUSH_WIDTH = t(oc.PUSH_WIDTH, I32)
        self.IS_VALID = t(oc.IS_VALID, torch.bool)
        self.CLASS = t(CLASS_TABLE, I32)
        self.EMPTY_KECCAK = u256.word(_EMPTY_KECCAK_INT, device)

    @classmethod
    def on(cls, device) -> "Tables":
        key = str(device)
        if key not in cls._cache:
            cls._cache[key] = Tables(device)
        return cls._cache[key]


def _tab(x) -> Tables:
    return Tables.on(x.device)


# ---------------------------------------------------------------------------
# Gather / write helpers. JAX semantics the code copies: gathers clip
# their indices; `.at[].set(mode="drop")` with an index past the end
# writes nowhere.
# ---------------------------------------------------------------------------


def _lanes(x):
    return torch.arange(x.shape[0], device=x.device)


def _peek(f: Frontier, i) -> torch.Tensor:
    """Stack slot i from the top (i int or i32[P]); [P, 8]."""
    idx = torch.clamp(f.sp - 1 - i, 0, f.max_stack - 1).long()
    return f.stack[_lanes(f.stack), idx]


def _write_slot(arr, widx, val):
    """arr[P, K, ...] with arr[lane, widx[lane]] = val[lane]; widx outside
    [0, K) writes nowhere. ``val`` may be scalar, [P] or [P, ...].
    Returns a new tensor (the frontier is functional, as in JAX)."""
    P, K = arr.shape[0], arr.shape[1]
    widx = widx.long()
    valid = (widx >= 0) & (widx < K)
    idx = torch.where(valid, widx, 0)
    lanes = _lanes(arr)
    tail = arr.shape[2:]
    val = torch.as_tensor(val, device=arr.device).to(arr.dtype).expand((P,) + tail)
    old = arr[lanes, idx]
    new = torch.where(valid.reshape((P,) + (1,) * len(tail)), val, old)
    out = arr.clone()
    out[lanes, idx] = new
    return out


def _set_slot(stack, pos, val, mask):
    """stack[P,S,8] with stack[lane, pos[lane]] = val[lane] where mask;
    pos outside [0, S) writes nowhere."""
    S = stack.shape[1]
    idx = torch.where(mask & (pos >= 0), pos, S)
    return _write_slot(stack, idx, val)


def _word_to_be_bytes(val) -> torch.Tensor:
    """u256 limbs [P,8] -> big-endian bytes u8[P,32] (byte 0 most significant)."""
    k = torch.arange(32, device=val.device)
    limb = (31 - k) // 4
    shift = 8 * ((31 - k) % 4)
    return ((val[:, limb] >> shift) & 0xFF).to(U8)


def _be_bytes_to_word(b) -> torch.Tensor:
    """big-endian bytes [P,32] -> u256 limbs [P,8]."""
    b = b.to(I64).reshape(b.shape[:-1] + (8, 4)).flip(-2)
    w = 1 << (8 * (3 - torch.arange(4, device=b.device)))
    return torch.sum(b * w, dim=-1)


def _gather_bytes(buf, start, n_static: int, limit):
    """buf[P, L]; read n_static bytes from per-lane offset start,
    zero-filled past `limit` (per-lane logical length). Returns u8[P, n]."""
    idx = start[:, None].to(I64) + torch.arange(n_static, device=buf.device)[None, :]
    L = buf.shape[1]
    vals = torch.gather(buf, 1, torch.clamp(idx, 0, L - 1))
    ok = (idx >= 0) & (idx < limit[:, None].to(I64)) & (idx < L)
    return torch.where(ok, vals, 0)


def _take_code(code, cid, idx, limit):
    """corpus.code[cid[P], idx[P, N]] with zero fill past limit[P] (the
    [P, MAX_CODE] row gather of the JAX code, without materializing it)."""
    L = code.shape[1]
    vals = code[cid.long()[:, None], torch.clamp(idx, 0, L - 1)]
    ok = (idx >= 0) & (idx < limit[:, None].to(I64)) & (idx < L)
    return torch.where(ok, vals, 0)


def _scatter_bytes(memory, start, vals, n_static: int, mask):
    """memory[P,M]; write vals[P,n] at per-lane offset start where mask.
    Out-of-range bytes land in a padding column that is dropped."""
    P, M = memory.shape
    idx = start[:, None].to(I64) + torch.arange(n_static, device=memory.device)[None, :]
    idx = torch.where(mask[:, None] & (idx >= 0) & (idx < M), idx, M)
    out = torch.cat([memory, torch.zeros(P, 1, dtype=memory.dtype, device=memory.device)], 1)
    out.scatter_(1, idx, vals.to(memory.dtype).expand(P, n_static))
    return out[:, :M].contiguous()


# ---------------------------------------------------------------------------
# Memory expansion (EVM yellow-paper cost: 3w + w^2/512)
# ---------------------------------------------------------------------------


def _mem_cost(words):
    w = words.to(I64)
    return 3 * w + torch.div(w * w, 512, rounding_mode="floor")


def _expand_memory(f: Frontier, mask, end_bytes) -> Tuple[Frontier, torch.Tensor]:
    """Charge expansion to end_bytes (i64[P]); flags error past the cap."""
    M = f.memory.shape[1]
    end = torch.clamp(end_bytes.to(I64), min=0)
    oob = mask & (end > M)
    words = torch.div(torch.clamp(end, 0, M) + 31, 32, rounding_mode="floor")
    mw = f.mem_words.to(I64)
    new_words = torch.where(mask, torch.maximum(mw, words), mw)
    delta = _mem_cost(new_words) - _mem_cost(mw)
    return (
        f.replace(
            mem_words=new_words.to(I32),
            gas_min=f.gas_min + torch.where(mask, delta, 0),
            gas_max=f.gas_max + torch.where(mask, delta, 0),
        ).trap(oob, Trap.OOB_MEM),
        oob,
    )


def _charge(f: Frontier, mask, amount) -> Frontier:
    amt = torch.where(mask, amount.to(I64), 0)
    return f.replace(gas_min=f.gas_min + amt, gas_max=f.gas_max + amt)


def _fdiv(x, d):
    return torch.div(x, d, rounding_mode="floor")


def _is_op(op, code):
    return (op == code)[:, None]


# ---------------------------------------------------------------------------
# Class handlers — each: (f, env, corpus, op, mask, old_pc) -> (f, aux).
# Handlers do not write ``stack`` or ``sp``: value classes return their
# result word in aux["r"] and the shared writeback in ``dispatch`` lands
# it at ``sp - sin + sout - 1``; aux["ok"] vetoes the write for lanes that
# trapped inside the handler; SWAP has a second write port (w2_*).
# ---------------------------------------------------------------------------


def _h_stack(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    is_push = (op >= 0x5F) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)

    # PUSH immediate: big-endian `width` bytes following pc
    width = torch.where(is_push, op - 0x5F, 0)
    start = (old_pc + 1).to(I64)[:, None] + torch.arange(32, device=op.device)[None, :]
    raw = _take_code(corpus.code, f.contract_id, start, corpus.code_len[f.contract_id.long()])
    ei = f.exec_init
    raw_ini = _gather_bytes(f.init_code, old_pc + 1, 32, f.init_len)
    raw = torch.where(ei[:, None], raw_ini, raw)
    j = torch.arange(32, device=op.device)
    sig = width[:, None] - 1 - j[None, :]  # byte significance; <0 = beyond width
    in_range = sig >= 0
    sigc = torch.clamp(sig, 0, 255)
    limb_idx = _fdiv(sigc, 4)
    shift = 8 * (sigc % 4)
    contrib = torch.where(in_range, raw.to(I64) << shift, 0)
    onehot = limb_idx[:, :, None] == torch.arange(8, device=op.device)[None, None, :]
    push_val = torch.sum(torch.where(onehot, contrib[:, :, None], 0), dim=1)

    dup_n = torch.where(is_dup, op - 0x7F, 1)
    dup_val = _peek(f, dup_n - 1)
    pc_val = u256.from_u64_scalar(old_pc)
    msize_val = u256.from_u64_scalar(f.mem_words.to(I64) * 32)
    gas_val = u256.from_u64_scalar(torch.clamp(f.gas_limit - f.gas_max, min=0))

    swap_n = torch.where(is_swap, op - 0x8F, 1)
    top = _peek(f, 0)
    deep = _peek(f, swap_n)

    val = torch.where(
        is_push[:, None], push_val,
        torch.where(is_dup[:, None], dup_val,
                    torch.where(_is_op(op, 0x58), pc_val,
                                torch.where(_is_op(op, 0x59), msize_val,
                                            torch.where(is_swap[:, None], deep, gas_val)))))
    return f, {
        "r": val,
        "w2_idx": f.sp - 1 - swap_n,
        "w2_val": top,
        "w2_mask": m & is_swap,
    }


def _h_alu(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    a = _peek(f, 0)
    b = _peek(f, 1)
    bw = u256.bool_to_word
    r = u256.add(a, b)
    r = torch.where(_is_op(op, 0x03), u256.sub(a, b), r)
    r = torch.where(_is_op(op, 0x10), bw(u256.lt(a, b)), r)
    r = torch.where(_is_op(op, 0x11), bw(u256.gt(a, b)), r)
    r = torch.where(_is_op(op, 0x12), bw(u256.slt(a, b)), r)
    r = torch.where(_is_op(op, 0x13), bw(u256.sgt(a, b)), r)
    r = torch.where(_is_op(op, 0x14), bw(u256.eq(a, b)), r)
    r = torch.where(_is_op(op, 0x15), bw(u256.is_zero(a)), r)
    r = torch.where(_is_op(op, 0x16), a & b, r)
    r = torch.where(_is_op(op, 0x17), a | b, r)
    r = torch.where(_is_op(op, 0x18), a ^ b, r)
    r = torch.where(_is_op(op, 0x19), u256.bit_not(a), r)
    r = torch.where(_is_op(op, 0x0B), u256.signextend(a, b), r)
    r = torch.where(_is_op(op, 0x1A), u256.byte_op(a, b), r)
    r = torch.where(_is_op(op, 0x1B), u256.shl(a, b), r)
    r = torch.where(_is_op(op, 0x1C), u256.shr(a, b), r)
    r = torch.where(_is_op(op, 0x1D), u256.sar(a, b), r)
    return f, {"r": r}


def _h_mul(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    return f, {"r": u256.mul(_peek(f, 0), _peek(f, 1))}


def _h_divmod(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    """DIV/SDIV/MOD/SMOD: one shared unsigned division on operands whose
    signs are stripped here and put back on the quotient/remainder
    afterwards."""
    a, b = _peek(f, 0), _peek(f, 1)
    signed = (op == 0x05) | (op == 0x07)  # SDIV SMOD
    aa, na = u256.abs_signed(a)
    ab, nb = u256.abs_signed(b)
    da = torch.where(signed[:, None], aa, a)
    db = torch.where(signed[:, None], ab, b)
    q, rem = u256.divmod_u(da, db)
    q_signed = torch.where((na != nb)[:, None], u256.neg(q), q)
    rem_signed = torch.where(na[:, None], u256.neg(rem), rem)
    bz = u256.is_zero(b)[:, None]
    is_div = (op == 0x04) | (op == 0x05)
    r = torch.where(
        is_div[:, None],
        torch.where(signed[:, None], q_signed, q),
        torch.where(signed[:, None], rem_signed, rem),
    )
    return f, {"r": torch.where(bz, 0, r)}


def _h_modarith(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    a, b, n = _peek(f, 0), _peek(f, 1), _peek(f, 2)
    is_add = op == 0x08
    wide_mul = u256.mul_wide(a, b)
    s, carry = u256.add_carry(a, b)
    wide_add = torch.cat([s, carry.to(I64)[:, None], torch.zeros_like(s)[:, :7]], dim=-1)
    wide = torch.where(is_add[:, None], wide_add, wide_mul)
    return f, {"r": u256._mod_wide(wide, n)}


def _h_exp(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    base, e = _peek(f, 0), _peek(f, 1)
    r = u256.exp(base, e)
    # dynamic gas: 50 per significant exponent byte
    nz = _word_to_be_bytes(e) != 0
    first_nz = first_true(nz, dim=1).to(I64)
    any_nz = torch.any(nz, dim=1)
    n_bytes = torch.where(any_nz, 32 - first_nz, 0)
    f = _charge(f, m, 50 * n_bytes)
    return f, {"r": r}


MAX_HASH_BYTES = 200  # SHA3 input cap (mapping keys need 64; see LimitsConfig)


def _h_sha3(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    off = u256.to_u64_saturating(_peek(f, 0))
    ln = u256.to_u64_saturating(_peek(f, 1))
    H = f.memory.shape[1]
    max_hash = min(MAX_HASH_BYTES, H)
    too_long = m & (ln > max_hash)
    f, oob = _expand_memory(f, m & (ln > 0), off + ln)
    ok = m & ~too_long & ~oob
    data = _gather_bytes(f.memory, off, max_hash, torch.full_like(off, H))
    data = torch.where(torch.arange(max_hash, device=off.device)[None, :] < ln[:, None], data, 0)
    digest = keccak256_plain(data.to(U8).contiguous(), torch.clamp(ln, 0, max_hash).to(I32))
    words = _fdiv(ln + 31, 32)
    f = _charge(f, ok, 6 * words)
    return f.trap(too_long, Trap.HASH_LIMIT), {"r": digest, "ok": ok}


def _h_env(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    a = _peek(f, 0)
    cid = f.contract_id.long()
    code_len = torch.where(f.exec_init, f.init_len, corpus.code_len[cid])

    cd_load = _be_bytes_to_word(
        _gather_bytes(f.calldata, u256.to_u64_saturating(a), 32, f.calldata_len))
    self_addr = f.self_address
    found, slot = f.acct_lookup(a)
    acct_bal = f.acct_field(f.acct_bal, slot)
    balance_val = torch.where(found[:, None], acct_bal, 0)
    ext_code = f.acct_field(f.acct_code, slot)
    C = corpus.code_len.shape[0]
    ext_len = torch.where(found & (ext_code >= 0),
                          corpus.code_len[torch.clamp(ext_code, 0, C - 1).long()], 0)
    extsize = u256.from_u64_scalar(ext_len)

    r = self_addr
    r = torch.where(_is_op(op, 0x31), balance_val, r)
    r = torch.where(_is_op(op, 0x32), env.origin, r)
    r = torch.where(_is_op(op, 0x33), f.caller_addr, r)
    r = torch.where(_is_op(op, 0x34), f.callvalue, r)
    r = torch.where(_is_op(op, 0x35), cd_load, r)
    r = torch.where(_is_op(op, 0x36), u256.from_u64_scalar(f.calldata_len), r)
    r = torch.where(_is_op(op, 0x38), u256.from_u64_scalar(code_len), r)
    r = torch.where(_is_op(op, 0x3A), env.gasprice, r)
    r = torch.where(_is_op(op, 0x3B), extsize, r)
    r = torch.where(_is_op(op, 0x3D), u256.from_u64_scalar(f.returndata_len), r)
    ext_hash = corpus.code_hash[torch.clamp(ext_code, 0, C - 1).long()]
    ehash = torch.where((found & (ext_code >= 0))[:, None], ext_hash, 0)
    ehash = torch.where((found & (ext_code == -1))[:, None],
                        _tab(op).EMPTY_KECCAK[None, :], ehash)
    r = torch.where(_is_op(op, 0x3F), ehash, r)
    r = torch.where(_is_op(op, 0x40), torch.zeros_like(r), r)  # BLOCKHASH stub
    r = torch.where(_is_op(op, 0x41), env.coinbase, r)
    r = torch.where(_is_op(op, 0x42), env.timestamp, r)
    r = torch.where(_is_op(op, 0x43), env.number, r)
    r = torch.where(_is_op(op, 0x44), env.prevrandao, r)
    r = torch.where(_is_op(op, 0x45), env.blk_gaslimit, r)
    r = torch.where(_is_op(op, 0x46), env.chainid, r)
    r = torch.where(_is_op(op, 0x47), f.self_balance, r)
    r = torch.where(_is_op(op, 0x48), env.basefee, r)
    return f, {"r": r}


def _take_per_lane(buf, idx, limit):
    """buf[P,L]; gather per-lane idx[P,N] with zero fill past limit[P]."""
    L = buf.shape[1]
    vals = torch.gather(buf, 1, torch.clamp(idx, 0, L - 1))
    ok = (idx >= 0) & (idx < limit[:, None]) & (idx < L)
    return torch.where(ok, vals, 0)


def _h_copy(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    is_ext = op == 0x3C  # EXTCODECOPY: (addr, dst, src, len)
    dst = torch.where(is_ext[:, None], _peek(f, 1), _peek(f, 0))
    src = torch.where(is_ext[:, None], _peek(f, 2), _peek(f, 1))
    ln = torch.where(is_ext[:, None], _peek(f, 3), _peek(f, 2))
    dst64 = u256.to_u64_saturating(dst)
    src64 = u256.to_u64_saturating(src)
    ln64 = u256.to_u64_saturating(ln)

    f, oob = _expand_memory(f, m & (ln64 > 0), dst64 + ln64)
    ok = m & ~oob

    P, M = f.memory.shape
    jpos = torch.arange(M, device=op.device)[None, :]
    in_window = (jpos >= dst64[:, None]) & (jpos < (dst64 + ln64)[:, None])
    sidx = jpos - dst64[:, None] + src64[:, None]

    cid = f.contract_id.long()
    cd = _take_per_lane(f.calldata, sidx, f.calldata_len.to(I64))
    code = _take_code(corpus.code, f.contract_id, sidx, corpus.code_len[cid])
    code = torch.where(f.exec_init[:, None],
                       _take_per_lane(f.init_code, sidx, f.init_len.to(I64)), code)
    rd = _take_per_lane(f.returndata, sidx, f.returndata_len.to(I64))
    found, slot = f.acct_lookup(_peek(f, 0))
    ext_cid = f.acct_field(f.acct_code, slot)
    have_ext = found & (ext_cid >= 0)
    C = corpus.code.shape[0]
    ext_cidc = torch.clamp(ext_cid, 0, C - 1)
    ext_limit = torch.where(have_ext, corpus.code_len[ext_cidc.long()], 0)
    ext = _take_code(corpus.code, ext_cidc, sidx, ext_limit)
    srcb = torch.where(_is_op(op, 0x37), cd,
                       torch.where(_is_op(op, 0x39), code,
                                   torch.where(_is_op(op, 0x3E), rd,
                                               torch.where(_is_op(op, 0x3C), ext, 0))))
    memory = torch.where(in_window & ok[:, None], srcb, f.memory)
    words = _fdiv(ln64 + 31, 32)
    f = _charge(f, ok, 3 * words)
    return f.replace(memory=memory.to(U8)), {}


def _h_mem(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    off = u256.to_u64_saturating(_peek(f, 0))
    val = _peek(f, 1)
    is_store8 = op == 0x53
    end = torch.where(is_store8, off + 1, off + 32)
    f, oob = _expand_memory(f, m, end)
    ok = m & ~oob
    M = f.memory.shape[1]
    loaded = _be_bytes_to_word(_gather_bytes(f.memory, off, 32, torch.full_like(off, M)))
    bytes32 = _word_to_be_bytes(val)
    mem = _scatter_bytes(f.memory, off, bytes32, 32, ok & (op == 0x52))
    low_byte = (val[:, 0] & 0xFF).to(U8)[:, None]
    mem = _scatter_bytes(mem, off, low_byte, 1, ok & is_store8)
    return f.replace(memory=mem), {"r": loaded, "ok": ok}


def _storage_lookup(f: Frontier, key):
    """(hit bool[P], value [P,8], hit_slot i32[P]) scoped to ``cur_acct``."""
    match = (f.st_used & (f.st_acct == f.cur_acct[:, None])
             & torch.all(f.st_keys == key[:, None, :], dim=-1))
    hit = torch.any(match, dim=1)
    slot = first_true(match, dim=1)
    # the JAX sum wraps in u32 when several entries match
    val = torch.sum(torch.where(match[:, :, None], f.st_vals, 0), dim=1) & u256.MASK32
    return hit, val, slot


def storage_alloc(f: Frontier, hit, hit_slot, m_store):
    """Matching-or-first-free slot for an SSTORE under `m_store`.
    Returns (widx i32[P] — K = no write — and overflow bool[P])."""
    free = ~f.st_used
    has_free = torch.any(free, dim=1)
    free_slot = first_true(free, dim=1)
    target = torch.where(hit, hit_slot, free_slot)
    overflow = m_store & ~hit & ~has_free
    wmask = m_store & ~overflow
    K = f.st_used.shape[1]
    widx = torch.where(wmask, target, K).to(I32)
    return widx, overflow


def validate_jump_dest(f: Frontier, corpus: Corpus, dest_w):
    """(dest i64[P], valid bool[P]): saturating target + JUMPDEST check."""
    dest = u256.to_u64_saturating(dest_w)
    MC = corpus.code.shape[1]
    idx = torch.clamp(dest, 0, MC - 1)
    valid = (dest < MC) & corpus.is_jumpdest[f.contract_id.long(), idx]
    IC = f.init_jd.shape[1]
    valid_ini = (dest < IC) & f.init_jd[_lanes(dest), torch.clamp(dest, 0, IC - 1)]
    return dest, torch.where(f.exec_init, valid_ini, valid)


def _h_storage(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    key = _peek(f, 0)
    val = _peek(f, 1)
    is_store = op == 0x55
    static_viol = m & is_store & f.static
    m = m & ~static_viol
    hit, cur, slot = _storage_lookup(f, key)
    loaded = torch.where(hit[:, None], cur, 0)
    widx, overflow = storage_alloc(f, hit, slot, m & is_store)
    return f.replace(
        st_keys=_write_slot(f.st_keys, widx, key),
        st_vals=_write_slot(f.st_vals, widx, val),
        st_used=_write_slot(f.st_used, widx, True),
        st_written=_write_slot(f.st_written, widx, True),
        st_acct=_write_slot(f.st_acct, widx, f.cur_acct),
    ).trap(overflow, Trap.STORAGE_SLOTS).trap(static_viol, Trap.STATIC_WRITE), {
        "r": loaded, "ok": m & ~is_store,
    }


def _h_jump(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    dest_w = _peek(f, 0)
    cond = _peek(f, 1)
    is_jumpi = op == 0x57
    dest, valid_dest = validate_jump_dest(f, corpus, dest_w)
    taken = ~u256.is_zero(cond) | ~is_jumpi
    bad = m & taken & ~valid_dest
    new_pc = torch.where(taken, dest.to(I32), old_pc + 1)
    pc = torch.where(m & ~bad, new_pc, f.pc)
    return f.replace(pc=pc).trap(bad, Trap.BAD_JUMP), {}


def _h_halt(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    is_return = op == 0xF3
    is_revert = op == 0xFD
    is_invalid = op == 0xFE
    is_sd = op == 0xFF
    static_viol = m & is_sd & f.static
    m = m & ~static_viol
    has_data = is_return | is_revert

    off = u256.to_u64_saturating(_peek(f, 0))
    ln = u256.to_u64_saturating(_peek(f, 1))
    f, oob = _expand_memory(f, m & has_data & (ln > 0), off + ln)
    RD = f.retval.shape[1]
    cap_len = torch.clamp(ln, 0, RD).to(I32)
    data = _gather_bytes(f.memory, off, RD, torch.full_like(off, f.memory.shape[1]))
    data = torch.where(torch.arange(RD, device=op.device)[None, :] < cap_len[:, None], data, 0)
    wmask = m & has_data & ~oob
    retval = torch.where(wmask[:, None], data, f.retval)
    retval_len = torch.where(wmask, cap_len, f.retval_len)

    # INVALID consumes all remaining gas
    gas_min = torch.where(m & is_invalid, f.gas_limit, f.gas_min)
    gas_max = torch.where(m & is_invalid, f.gas_limit, f.gas_max)

    return f.trap(m & is_invalid, Trap.INVALID_OP).trap(
        static_viol, Trap.STATIC_WRITE
    ).replace(
        halted=f.halted | (m & ~is_invalid),
        reverted=f.reverted | (m & is_revert),
        selfdestructed=f.selfdestructed | (m & is_sd),
        retval=retval,
        retval_len=retval_len,
        gas_min=gas_min,
        gas_max=gas_max,
    ), {}


def _h_log(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    static_viol = m & f.static
    m = m & ~static_viol
    off = u256.to_u64_saturating(_peek(f, 0))
    ln = u256.to_u64_saturating(_peek(f, 1))
    f, _ = _expand_memory(f, m & (ln > 0), off + ln)
    f = _charge(f, m, 8 * ln)
    LS = f.log_pc.shape[1]
    n_topics = op - 0xA0
    topic0 = _peek(f, 2)
    raw0 = _gather_bytes(f.memory, off, 32, torch.full_like(off, f.memory.shape[1]))
    raw0 = torch.where(torch.arange(32, device=op.device)[None, :] < ln[:, None], raw0, 0)
    data0 = _be_bytes_to_word(raw0)
    widx = torch.where(m & (f.n_logs < LS), torch.clamp(f.n_logs, max=LS - 1), LS)
    return f.replace(
        n_logs=torch.where(m, f.n_logs + 1, f.n_logs),
        log_pc=_write_slot(f.log_pc, widx, old_pc),
        log_cid=_write_slot(f.log_cid, widx, f.contract_id),
        log_ntopics=_write_slot(f.log_ntopics, widx, n_topics),
        log_topic0=_write_slot(f.log_topic0, widx,
                               torch.where((n_topics >= 1)[:, None], topic0, 0)),
        log_data0=_write_slot(f.log_data0, widx, data0),
    ).trap(static_viol, Trap.STATIC_WRITE), {}


def _h_call(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    """CALL family stub: success=1, empty returndata."""
    one = torch.zeros_like(_peek(f, 0))
    one[:, 0] = 1
    return f.replace(returndata_len=torch.where(m, 0, f.returndata_len)), {"r": one}


def _h_create(f: Frontier, env: Env, corpus: Corpus, op, m, old_pc):
    """CREATE/CREATE2 stub: pushes the zero address."""
    zero = torch.zeros_like(_peek(f, 0))
    off = u256.to_u64_saturating(_peek(f, 1))
    ln = u256.to_u64_saturating(_peek(f, 2))
    f, _ = _expand_memory(f, m & (ln > 0), off + ln)
    return f, {"r": zero}


_HANDLERS = [
    _h_stack, _h_alu, _h_mul, _h_divmod, _h_modarith, _h_exp, _h_sha3, _h_env,
    _h_copy, _h_mem, _h_storage, _h_jump, _h_halt, _h_log, _h_call, _h_create,
]

# aux outputs each class hands to the shared writeback
AUX_KEYS = {
    CLS_STACK: ("r", "w2_idx", "w2_val", "w2_mask"),
    CLS_ALU: ("r",), CLS_MUL: ("r",), CLS_DIVMOD: ("r",), CLS_MODARITH: ("r",),
    CLS_EXP: ("r",), CLS_SHA3: ("r", "ok"), CLS_ENV: ("r",), CLS_COPY: (),
    CLS_MEM: ("r", "ok"), CLS_STORAGE: ("r", "ok"), CLS_JUMP: (), CLS_HALT: (),
    CLS_LOG: (), CLS_CALL: ("r",), CLS_CREATE: ("r",),
}

# ---------------------------------------------------------------------------
# Host syncs: every read of a device predicate back to the host (one per
# `present` vector in dispatch, one per loop check, ...) is counted here
# so a run can report syncs per superstep.
# ---------------------------------------------------------------------------

HOST_SYNCS = {"count": 0}


def host_list(t: torch.Tensor) -> list:
    """Device -> host read of a small predicate tensor (counted)."""
    HOST_SYNCS["count"] += 1
    return t.tolist()


def host_bool(t: torch.Tensor) -> bool:
    HOST_SYNCS["count"] += 1
    return bool(t.item())


# ---------------------------------------------------------------------------
# Superstep
# ---------------------------------------------------------------------------


def prologue_plain(f: Frontier, corpus: Corpus, berlin: bool = False):
    """Plain version of K10's prologue: fetch + validate the next
    instruction for every running lane. Returns ``(f, op, run, old_pc)``.
    ``berlin`` charges the EIP-2929 WARM base costs; the symbolic engine
    adds the cold surcharges."""
    tb = _tab(f.pc)
    running = f.running
    MC = corpus.code.shape[1]
    cid = f.contract_id.long()
    pc_idx = torch.clamp(f.pc, 0, MC - 1).long()
    op_raw = corpus.code[cid, pc_idx].to(I32)
    in_code = f.pc < corpus.code_len[cid]
    ei = f.exec_init
    IC = f.init_code.shape[1]
    op_ini = f.init_code[_lanes(f.pc), torch.clamp(f.pc, 0, IC - 1).long()].to(I32)
    op_raw = torch.where(ei, op_ini, op_raw)
    in_code = torch.where(ei, f.pc < f.init_len, in_code)
    op = torch.where(running & in_code, op_raw, 0)  # off-end = STOP

    opl = op.long()
    sin = tb.STACK_IN[opl]
    sout = tb.STACK_OUT[opl]
    valid = tb.IS_VALID[opl]
    invalid = running & ~valid
    stack_bad = running & valid & ((f.sp - f.sp_base < sin) | (f.sp - sin + sout > f.max_stack))
    f = f.trap(invalid, Trap.INVALID_OP).trap(stack_bad, Trap.STACK)
    run = running & ~invalid & ~stack_bad
    gmin, gmax = (tb.GAS_MIN_BERLIN, tb.GAS_MAX_BERLIN) if berlin else (tb.GAS_MIN, tb.GAS_MAX)
    f = f.replace(
        gas_min=f.gas_min + torch.where(run, gmin[opl], 0),
        gas_max=f.gas_max + torch.where(run, gmax[opl], 0),
    )
    return f, op, run, f.pc


def class_present(op, run):
    """bool[16]: which opcode classes some running lane executes."""
    cls = _tab(op).CLASS[op.long()]
    return torch.any((cls[:, None] == torch.arange(N_CLASSES, device=op.device)[None, :])
                     & run[:, None], dim=0)


def dispatch_plain(f: Frontier, env: Env, corpus: Corpus, op, run, old_pc,
                   skip=None, present=None) -> Frontier:
    """Plain version of K10's dispatch: run the present classes'
    handlers, then write the stack once.
    ``skip`` masks lanes out (the symbolic engine claims them);
    ``present`` is the host list of class-present flags when the caller
    already read it back (else it is read here: one host sync)."""
    tb = _tab(op)
    cls = tb.CLASS[op.long()]
    if skip is not None:
        run = run & ~skip
    if present is None:
        present = host_list(class_present(op, run))
    P = f.pc.shape[0]
    pre_sp = f.sp
    val = torch.zeros((P, 8), dtype=I64, device=op.device)
    veto = torch.zeros(P, dtype=torch.bool, device=op.device)
    w2_idx = torch.zeros(P, dtype=I32, device=op.device)
    w2_val = val
    w2_mask = veto
    for cid, handler in enumerate(_HANDLERS):
        if not present[cid]:
            continue
        mask = run & (cls == cid)
        f, aux = handler(f, env, corpus, op, mask, old_pc)
        akeys = AUX_KEYS[cid]
        if "r" in akeys:
            val = torch.where(mask[:, None], aux["r"], val)
        if "ok" in akeys:
            veto = veto | (mask & ~aux["ok"])
        if "w2_mask" in akeys:
            w2_idx, w2_val, w2_mask = aux["w2_idx"], aux["w2_val"], aux["w2_mask"]
    opl = op.long()
    w1_mask = run & tb.PUSHES[opl] & ~veto
    w1_idx = pre_sp - tb.STACK_IN[opl] + tb.STACK_OUT[opl] - 1
    stack = _set_slot(f.stack, w1_idx, val, w1_mask)
    stack = _set_slot(stack, w2_idx, w2_val, w2_mask)
    sp = torch.where(run, pre_sp + tb.D_SP[opl], pre_sp)
    return f.replace(stack=stack, sp=sp)


def hist_add(hist, op, delta):
    """hist[P, 256] + delta[P] at column op[P] (a new tensor)."""
    out = hist.clone()
    out[_lanes(op), op.long()] += delta
    return out


def epilogue_plain(f: Frontier, op, run, old_pc) -> Frontier:
    """Plain version of K10's epilogue: default pc advance + out-of-gas
    trap after the handlers ran."""
    tb = _tab(op)
    opl = op.long()
    cls = tb.CLASS[opl]
    advanced = run & (cls != CLS_JUMP) & ~f.halted & ~f.error & ~f.pc_hold
    next_pc = old_pc + 1 + tb.PUSH_WIDTH[opl]
    f = f.replace(
        pc=torch.where(advanced, next_pc, f.pc),
        pc_hold=torch.zeros_like(f.pc_hold),
        n_steps=f.n_steps + run.to(I32),
    )
    if f.op_hist is not None:  # iprof: one masked histogram update per step
        f = f.replace(op_hist=hist_add(f.op_hist, op, run.to(I32)))
    oog = run & (f.gas_min > f.gas_limit)
    return f.trap(oog, Trap.OOG)


def superstep_plain(f: Frontier, env: Env, corpus: Corpus) -> Frontier:
    """Plain version of K10's fused superstep: advance every running lane
    by one instruction."""
    f, op, run, old_pc = prologue_plain(f, corpus)
    f = dispatch_plain(f, env, corpus, op, run, old_pc)
    return epilogue_plain(f, op, run, old_pc)


def run_plain(f: Frontier, env: Env, corpus: Corpus, max_steps: int = 256) -> Frontier:
    """Plain version of :func:`run`: one host check per step."""
    for _ in range(max_steps):
        if not host_bool(torch.any(f.running)):
            break
        f = superstep_plain(f, env, corpus)
    return f


# ---------------------------------------------------------------------------
# Entry points: K10 for a frontier on a CUDA device, the plain versions for
# one on the CPU. K10 writes in place, on fields its caller owns
# (``kernels.EVM_WRITES``): a loop owns once — :func:`run` here and
# ``sym_run`` copy the fields K10 writes on entry and hand every launch
# their descriptor ``k10`` (``kernels.EvmStep``) — and a call without a
# descriptor copies the fields it writes first. So a tensor a caller still
# holds is never changed. Given a descriptor, these run K10 whatever the
# device (its library decides: the nvcc build, or the CPU tests' host build).
# ---------------------------------------------------------------------------

#: :func:`run` reads the count of running lanes once every this many
#: supersteps. A read drains the launch queue and costs about as much as
#: a superstep; the launches after the last lane stops (at most this many
#: less one) change nothing and cost a few microseconds each. Sixteen
#: balances the two near sqrt(2 x supersteps x read/launch) for the ~60
#: supersteps of the ERC-20 transfer run (chip_smoke.py phase 10).
RUN_READ_EVERY = 16


def k10_for(f: Frontier, berlin: bool = False):
    """K10's launch descriptor for a loop over ``f`` on the card; None on
    the CPU, where the plain versions run."""
    if not f.pc.is_cuda:
        return None
    from ..kernels import EvmStep

    return EvmStep.on_card(f.pc.device, berlin)


def prologue(f: Frontier, corpus: Corpus, berlin: bool = False, k10=None):
    """Fetch + validate the next instruction for every running lane.
    Returns ``(f, op, run, old_pc)``; ``old_pc`` is the pre-step pc
    (with K10 a copy in the descriptor's buffer)."""
    if k10 is not None or f.pc.is_cuda:
        from ..kernels import evm_prologue

        return evm_prologue(f, corpus, berlin, k10)
    return prologue_plain(f, corpus, berlin)


def dispatch(f: Frontier, env: Env, corpus: Corpus, op, run, old_pc,
             skip=None, present=None, k10=None) -> Frontier:
    """Each running lane not under ``skip`` executes its instruction.
    ``present`` (the host list of class-present flags) serves the plain
    version only; K10 needs none."""
    if k10 is not None or f.pc.is_cuda:
        from ..kernels import evm_dispatch

        return evm_dispatch(f, env, corpus, op, run, old_pc, skip, k10)
    return dispatch_plain(f, env, corpus, op, run, old_pc, skip, present)


def epilogue(f: Frontier, op, run, old_pc, k10=None) -> Frontier:
    """Default pc advance + out-of-gas trap after the handlers ran."""
    if k10 is not None or f.pc.is_cuda:
        from ..kernels import evm_epilogue

        return evm_epilogue(f, op, run, old_pc, k10)
    return epilogue_plain(f, op, run, old_pc)


def superstep(f: Frontier, env: Env, corpus: Corpus) -> Frontier:
    """Advance every running lane by one instruction (one fused K10
    launch on the card, on copies of the fields it writes)."""
    if f.pc.is_cuda:
        from ..kernels import evm_superstep

        return evm_superstep(f, env, corpus)
    return superstep_plain(f, env, corpus)


def run(f: Frontier, env: Env, corpus: Corpus, max_steps: int = 256) -> Frontier:
    """Run until every lane halts/errors or max_steps supersteps elapse;
    the input is never changed. On the card: the fields a step writes are
    copied once and the descriptor built once, then each superstep is one
    in-place fused K10 launch, and the device's count of running lanes is
    read once every ``RUN_READ_EVERY`` launches (and once before the
    first, so that a frontier with nothing to run is returned as it was).
    The launches after the last lane stops change nothing."""
    k10 = k10_for(f)
    if k10 is None:
        return run_plain(f, env, corpus, max_steps)
    from ..kernels import own_evm_fields

    if max_steps <= 0 or not host_bool(torch.any(f.running)):
        return f
    f = own_evm_fields(f)
    k10.bind("superstep", f, env, corpus)
    for i in range(1, max_steps + 1):
        k10.launch("superstep")
        if i % RUN_READ_EVERY == 0 and i < max_steps and not host_bool(k10.n_running[0]):
            break
    return f
