"""SymFrontier: the concrete frontier plus the symbolic overlay.

PyTorch counterpart of the JAX package's ``symbolic/state.py``, with the
same field names. Concrete limb tensors stay authoritative for concrete
values; a parallel "sym id" overlay marks which slots hold symbolic
expressions (id != 0 -> the value is that tape node). The tape is a
per-lane SSA array of (op, a, b, imm) rows, hash-consed through
``tape_hash`` (see :func:`tape_row_hash` and ``engine.append_node``).

Carriers: u32 limbs in int64 (``tape_imm``, ``iv_*``, ``kb_*``, ...);
``tape_hash`` holds each u32 fingerprint's bit pattern in an int32 — the
hash-cons scan only compares it for equality, and the 4-byte carrier
keeps the scan (kernel K3's bound) at P x T x 4 bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from ..config import LimitsConfig, DEFAULT_LIMITS
from ..core.frontier import Frontier, TensorStruct, _leaf_from_numpy, make_frontier
from .ops import WELL_KNOWN, N_WELL_KNOWN

I32 = torch.int32
M32 = 0xFFFFFFFF
_MULT = (0x27D4EB2F, 0x165667B1, 0xD6E8FEB9, 0xA3D8A6E3,
         0x83B58237, 0xCC9E2D51, 0x1B873593, 0xE6546B65)


def _mul32(x, m: int):
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a constant m, formed
    from 16-bit halves of m so no intermediate leaves int64."""
    return ((x * (m & 0xFFFF)) + (((x * (m >> 16)) & 0xFFFF) << 16)) & M32


def tape_row_hash(op, a, b, imm):
    """u32 fingerprint of one tape row (op, a, b, imm[..., 8]), as int64
    values in [0, 2^32) — bit-identical to the JAX package's function.
    ``op``/``a``/``b`` are int32 (negative values hash as their u32 bit
    pattern); ``imm`` holds u32 limbs in the int64 carrier."""
    op = op.to(torch.int64) & M32
    a = a.to(torch.int64) & M32
    b = b.to(torch.int64) & M32
    h = _mul32(op, 0x9E3779B1) ^ _mul32(a, 0x85EBCA6B) ^ _mul32(b, 0xC2B2AE35)
    s = torch.zeros_like(h)
    for i, m in enumerate(_MULT):
        s = s + _mul32(imm[..., i], m)
    h = h ^ (s & M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    return h ^ (h >> 15)


def hash_bits(h):
    """A u32 fingerprint (int64 in [0, 2^32)) as its int32 bit pattern."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(I32)


@dataclass(frozen=True)
class SymSpec:
    """Static choice of which inputs are symbolic (the JAX ``SymSpec``
    without the device-mesh fields, which have no use here)."""

    calldata: bool = True
    callvalue: bool = True
    caller: bool = False
    storage: bool = True
    block_env: bool = True
    alias_probe: bool = True


@dataclass
class SymFrontier(TensorStruct):
    base: Frontier
    # --- overlay: sym ids (0 = concrete) ---
    stack_sym: torch.Tensor   # i32[P, S]
    mem_sym: torch.Tensor     # i32[P, M/32]
    mem_havoc: torch.Tensor   # bool[P]
    retdata_sym: torch.Tensor  # bool[P]
    st_val_sym: torch.Tensor  # i32[P, K]
    st_key_sym: torch.Tensor  # i32[P, K]
    st_seq: torch.Tensor      # i32[P, K]
    st_seq_ctr: torch.Tensor  # i32[P]
    rv_sym: torch.Tensor      # i32[P, RD/32]
    rv_havoc: torch.Tensor    # bool[P]
    # --- sub-call frame overlay ---
    cd_from_mem: torch.Tensor  # bool[P]
    cd_havoc: torch.Tensor    # bool[P]
    cd_sym: torch.Tensor      # i32[P, CD/32]
    callvalue_sym: torch.Tensor  # i32[P]
    caller_sym: torch.Tensor  # i32[P]
    bal_epoch: torch.Tensor   # i32[P]
    fr_mem_sym: torch.Tensor  # i32[P, D, M/32]
    fr_mem_havoc: torch.Tensor  # bool[P, D]
    fr_cd_from_mem: torch.Tensor  # bool[P, D]
    fr_cd_havoc: torch.Tensor  # bool[P, D]
    fr_cd_sym: torch.Tensor   # i32[P, D, CD/32]
    fr_callvalue_sym: torch.Tensor  # i32[P, D]
    fr_caller_sym: torch.Tensor  # i32[P, D]
    fr_st_val_sym: torch.Tensor  # i32[P, D, K]
    fr_st_key_sym: torch.Tensor  # i32[P, D, K]
    fr_st_seq: torch.Tensor      # i32[P, D, K]
    sub_revert_pc: torch.Tensor  # i32[P]
    sub_revert_cid: torch.Tensor  # i32[P]
    # --- SSA tape ---
    tape_op: torch.Tensor     # i32[P, T]
    tape_a: torch.Tensor      # i32[P, T]
    tape_b: torch.Tensor      # i32[P, T]
    tape_imm: torch.Tensor    # u32[P, T, 8]
    tape_hash: torch.Tensor   # u32[P, T] row fingerprint (int32 bit pattern)
    tape_len: torch.Tensor    # i32[P]
    havoc_cnt: torch.Tensor   # i32[P]
    create_cnt: torch.Tensor  # i32[P]
    # --- persistent abstract domains (incremental propagation) ---
    iv_lo: torch.Tensor       # u32[P, T, 8]
    iv_hi: torch.Tensor       # u32[P, T, 8]
    kb_m: torch.Tensor        # u32[P, T, 8]
    kb_v: torch.Tensor        # u32[P, T, 8]
    prop_len: torch.Tensor    # i32[P]
    # --- path condition ---
    tx_id: torch.Tensor       # i32[P]
    con_node: torch.Tensor    # i32[P, C]
    con_sign: torch.Tensor    # bool[P, C]
    con_pc: torch.Tensor      # i32[P, C]
    con_len: torch.Tensor     # i32[P]
    killed_infeasible: torch.Tensor  # bool[P]
    killed_total: torch.Tensor  # i32[]
    # --- bounded-loops policy ---
    lb_key: torch.Tensor      # i64[P, LBS]
    lb_cnt: torch.Tensor      # i32[P, LBS]
    lb_len: torch.Tensor      # i32[P]
    # --- dependency pruner ---
    dep_read: torch.Tensor    # bool[P]
    # --- fork plumbing ---
    fork_req: torch.Tensor    # bool[P]
    fork_dest: torch.Tensor   # i32[P]
    dropped_forks: torch.Tensor  # i32[P]
    dropped_total: torch.Tensor  # i32[]
    call_enum: torch.Tensor   # i32[P]
    fork_cslot: torch.Tensor  # i32[P]
    fork_cval: torch.Tensor   # u32[P, 8]
    # --- detection-facing event records ---
    sym_jump_dest: torch.Tensor  # i32[P]
    sym_jump_pc: torch.Tensor    # i32[P]
    sym_jump_cid: torch.Tensor   # i32[P]
    n_calls: torch.Tensor     # i32[P]
    n_mut_calls: torch.Tensor  # i32[P]
    call_to: torch.Tensor     # u32[P, CL, 8]
    call_to_sym: torch.Tensor  # i32[P, CL]
    call_value: torch.Tensor  # u32[P, CL, 8]
    call_value_sym: torch.Tensor  # i32[P, CL]
    call_op: torch.Tensor     # i32[P, CL]
    call_pc: torch.Tensor     # i32[P, CL]
    call_cid: torch.Tensor    # i32[P, CL]
    log_topic0_sym: torch.Tensor  # i32[P, LS]
    log_data0_sym: torch.Tensor   # i32[P, LS]
    sd_to_sym: torch.Tensor   # i32[P]
    sd_to: torch.Tensor       # u32[P, 8]
    sd_pc: torch.Tensor       # i32[P]
    sd_cid: torch.Tensor      # i32[P]
    origin_read: torch.Tensor  # bool[P]
    inv_pc: torch.Tensor      # i32[P]
    inv_cid: torch.Tensor     # i32[P]
    sstore_after_call_pc: torch.Tensor  # i32[P]
    sstore_ac_cid: torch.Tensor  # i32[P]
    arb_key_node: torch.Tensor  # i32[P]
    arb_key_pc: torch.Tensor    # i32[P]
    arb_key_cid: torch.Tensor   # i32[P]
    n_arith: torch.Tensor     # i32[P]
    arith_op: torch.Tensor    # i32[P, AL]
    arith_a: torch.Tensor     # i32[P, AL]
    arith_b: torch.Tensor     # i32[P, AL]
    arith_r: torch.Tensor     # i32[P, AL]
    arith_pc: torch.Tensor    # i32[P, AL]
    arith_cid: torch.Tensor   # i32[P, AL]

    _U32 = frozenset({"tape_imm", "iv_lo", "iv_hi", "kb_m", "kb_v", "fork_cval",
                      "call_to", "call_value", "sd_to"})
    _U32BITS = frozenset({"tape_hash"})
    _NESTED = {"base": Frontier}

    @property
    def n_lanes(self) -> int:
        return self.base.pc.shape[0]

    @property
    def device(self):
        return self.base.pc.device

    @property
    def tape_cap(self) -> int:
        return self.tape_op.shape[1]


def make_sym_frontier(
    n_lanes: int,
    limits: LimitsConfig = DEFAULT_LIMITS,
    contract_id=None,
    gas_limit: int = 10_000_000,
    active=None,
    calldata=None,
    calldata_len=None,
    device="cpu",
    **world_kw,
) -> SymFrontier:
    """Fresh frontier with the well-known leaves pre-seeded on every tape
    (same layout as the JAX package's ``make_sym_frontier``)."""
    P = n_lanes
    L = limits
    if calldata_len is None:
        calldata_len = np.full(P, L.calldata_bytes, dtype=np.int32)
    base = make_frontier(
        P, L, contract_id=contract_id, gas_limit=gas_limit, active=active,
        calldata=calldata, calldata_len=calldata_len, device=device, **world_kw,
    )
    T, C, K, S = L.tape_len, L.max_constraints, L.storage_slots, L.max_stack
    CL = L.call_log
    rows = WELL_KNOWN(L.calldata_bytes)
    n_wk = N_WELL_KNOWN(L.calldata_bytes)
    assert n_wk <= T, "tape too small for well-known leaves"
    t_op = np.zeros((P, T), dtype=np.int32)
    t_a = np.zeros((P, T), dtype=np.int32)
    t_b = np.zeros((P, T), dtype=np.int32)
    for i, (op, kind, idx) in enumerate(rows, start=1):
        t_op[:, i] = op
        t_a[:, i] = kind
        t_b[:, i] = idx
    imm0 = torch.zeros((1, T, 8), dtype=torch.int64)
    h = tape_row_hash(torch.as_tensor(t_op[:1]), torch.as_tensor(t_a[:1]),
                      torch.as_tensor(t_b[:1]), imm0)
    t_hash = np.broadcast_to(h.numpy().astype(np.uint32), (P, T))

    z = lambda *s, dt=np.int32: np.zeros(s, dtype=dt)
    D = L.call_depth
    CDW = L.calldata_bytes // 32
    W = L.mem_bytes // 32
    AL = L.arith_log
    LS = L.log_slots
    kb_m = np.zeros((P, T, 8), dtype=np.uint32)
    kb_m[:, 0] = 0xFFFFFFFF
    leaves = dict(
        stack_sym=z(P, S), mem_sym=z(P, W), mem_havoc=z(P, dt=bool),
        retdata_sym=z(P, dt=bool), st_val_sym=z(P, K), st_key_sym=z(P, K),
        st_seq=z(P, K), st_seq_ctr=z(P), rv_sym=z(P, L.returndata_bytes // 32),
        rv_havoc=z(P, dt=bool), cd_from_mem=z(P, dt=bool), cd_havoc=z(P, dt=bool),
        cd_sym=z(P, CDW), callvalue_sym=z(P), caller_sym=z(P), bal_epoch=z(P),
        fr_mem_sym=z(P, D, W), fr_mem_havoc=z(P, D, dt=bool),
        fr_cd_from_mem=z(P, D, dt=bool), fr_cd_havoc=z(P, D, dt=bool),
        fr_cd_sym=z(P, D, CDW), fr_callvalue_sym=z(P, D), fr_caller_sym=z(P, D),
        fr_st_val_sym=z(P, D, K), fr_st_key_sym=z(P, D, K), fr_st_seq=z(P, D, K),
        sub_revert_pc=np.full(P, -1, dtype=np.int32), sub_revert_cid=z(P),
        tape_op=t_op, tape_a=t_a, tape_b=t_b,
        tape_imm=np.zeros((P, T, 8), dtype=np.uint32), tape_hash=t_hash,
        tape_len=np.full(P, n_wk, dtype=np.int32), havoc_cnt=z(P), create_cnt=z(P),
        iv_lo=np.zeros((P, T, 8), dtype=np.uint32),
        iv_hi=np.zeros((P, T, 8), dtype=np.uint32),
        kb_m=kb_m, kb_v=np.zeros((P, T, 8), dtype=np.uint32),
        prop_len=np.ones(P, dtype=np.int32),  # node 0 pre-seeded ([0,0], known)
        tx_id=z(P), con_node=z(P, C), con_sign=z(P, C, dt=bool), con_pc=z(P, C),
        con_len=z(P), killed_infeasible=z(P, dt=bool),
        killed_total=np.zeros((), dtype=np.int32),
        lb_key=np.full((P, L.loop_slots), -1, dtype=np.int64),
        lb_cnt=z(P, L.loop_slots), lb_len=z(P), dep_read=z(P, dt=bool),
        fork_req=z(P, dt=bool), fork_dest=z(P), dropped_forks=z(P),
        dropped_total=np.zeros((), dtype=np.int32), call_enum=z(P),
        fork_cslot=np.full(P, -1, dtype=np.int32),
        fork_cval=np.zeros((P, 8), dtype=np.uint32),
        sym_jump_dest=z(P), sym_jump_pc=np.full(P, -1, dtype=np.int32),
        sym_jump_cid=z(P), n_calls=z(P), n_mut_calls=z(P),
        call_to=np.zeros((P, CL, 8), dtype=np.uint32), call_to_sym=z(P, CL),
        call_value=np.zeros((P, CL, 8), dtype=np.uint32), call_value_sym=z(P, CL),
        call_op=z(P, CL), call_pc=z(P, CL), call_cid=z(P, CL),
        log_topic0_sym=z(P, LS), log_data0_sym=z(P, LS), sd_to_sym=z(P),
        sd_to=np.zeros((P, 8), dtype=np.uint32),
        sd_pc=np.full(P, -1, dtype=np.int32), sd_cid=z(P), origin_read=z(P, dt=bool),
        inv_pc=np.full(P, -1, dtype=np.int32), inv_cid=z(P),
        sstore_after_call_pc=np.full(P, -1, dtype=np.int32), sstore_ac_cid=z(P),
        arb_key_node=z(P), arb_key_pc=np.full(P, -1, dtype=np.int32), arb_key_cid=z(P),
        n_arith=z(P), arith_op=z(P, AL), arith_a=z(P, AL), arith_b=z(P, AL),
        arith_r=z(P, AL), arith_pc=z(P, AL), arith_cid=z(P, AL),
    )
    out = {"base": base}
    for name, v in leaves.items():
        out[name] = _leaf_from_numpy(v, SymFrontier._kind(name), device)
    return SymFrontier(**out)
