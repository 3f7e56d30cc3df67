"""The SoA frontier: all machine state for P lanes as fixed-shape tensors.

PyTorch counterpart of the JAX package's ``core/frontier.py``: the same
dataclasses with the same field names, shapes and (at the numpy seam)
dtypes. A lane is one (contract, path) pair; masks
(``active``/``halted``/``error``) play the role of work-list membership.

Carriers: u32 limb fields ride in int64 (see ``ops/u256.py``); byte
fields are uint8; everything else keeps its JAX dtype. ``to_numpy()``
returns the same dataclass holding numpy arrays with the JAX package's
dtypes (u32 limbs as ``uint32``) — the form the host side (detection
modules, tape extraction, the solver) reads — and ``from_numpy()`` takes
such leaves (or a JAX frontier's leaves through ``np.asarray``) back onto
a device.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import LimitsConfig, DEFAULT_LIMITS
from ..ops import u256


class Trap:
    """Error causes (first one wins, recorded in ``Frontier.err_code``)."""

    NONE = 0
    STACK = 1            # stack under/overflow vs max_stack cap
    INVALID_OP = 2       # undefined opcode (incl. INVALID 0xFE)
    BAD_JUMP = 3         # jump target not a JUMPDEST
    OOB_MEM = 4          # memory access past mem_bytes cap
    STORAGE_SLOTS = 5    # storage associative cache full
    HASH_LIMIT = 6       # SHA3 input longer than max_hash_bytes
    OOG = 7              # out of gas
    TAPE_LIMIT = 8       # symbolic tape full
    CONSTRAINT_LIMIT = 9  # path-condition slots full
    STATIC_WRITE = 10    # state modification inside a STATICCALL frame
    ACCOUNTS_FULL = 11   # world-state account table full
    LOOP_BOUND = 12      # retired by the bounded-loops policy


TRAP_NAMES = {
    Trap.STACK: "stack_cap",
    Trap.INVALID_OP: "invalid_opcode",
    Trap.BAD_JUMP: "bad_jump",
    Trap.OOB_MEM: "memory_cap",
    Trap.STORAGE_SLOTS: "storage_cap",
    Trap.HASH_LIMIT: "hash_size_cap",
    Trap.OOG: "out_of_gas",
    Trap.TAPE_LIMIT: "tape_cap",
    Trap.CONSTRAINT_LIMIT: "constraint_cap",
    Trap.STATIC_WRITE: "static_write",
    Trap.ACCOUNTS_FULL: "accounts_cap",
    Trap.LOOP_BOUND: "loop_bound",
}

# trap codes that are capacity artifacts of this engine (coverage loss)
CAP_TRAPS = (Trap.STACK, Trap.OOB_MEM, Trap.STORAGE_SLOTS, Trap.HASH_LIMIT,
             Trap.TAPE_LIMIT, Trap.CONSTRAINT_LIMIT, Trap.ACCOUNTS_FULL)
KILL_TRAPS = CAP_TRAPS + (Trap.LOOP_BOUND,)

ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
CREATOR_ADDRESS = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE

# account-table slot convention: 0 = attacker EOA, 1 = creator EOA,
# 2+i = corpus contract i (when the corpus fits max_accounts; otherwise
# slot 2 holds the lane's own contract only)
ACCT_ATTACKER = 0
ACCT_CREATOR = 1
ACCT_CONTRACT0 = 2

# acct_code sentinel: the account has code, but not in the corpus
CODE_UNKNOWN = -2


def contract_address(i: int) -> int:
    """Deterministic default address of corpus contract i."""
    return 0xAFFE + 0x10000 * i


# ---------------------------------------------------------------------------
# numpy seam
# ---------------------------------------------------------------------------


def _leaf_to_numpy(x, kind):
    if x is None:
        return None
    # an owned copy: on the CPU `.numpy()` would share memory with a tensor
    # the engine later updates in place (the tape, see engine.append_node)
    a = (x.detach().to("cpu", copy=True).numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x))
    if kind == "u32":
        return a.astype(np.uint32)
    if kind == "u32bits":
        return a.astype(np.int32).view(np.uint32)
    return a


_NP_TO_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _leaf_from_numpy(x, kind, device):
    if x is None:
        return None
    a = np.array(x, order="C")  # own, writable, C-contiguous (JAX views are read-only)
    if kind == "u32":
        a = a.astype(np.int64)
    elif kind == "u32bits":
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(a, dtype=_NP_TO_TORCH[a.dtype], device=device)


class TensorStruct:
    """Dataclass mix-in: functional ``replace`` plus the numpy seam.
    ``_U32`` names the u32 limb fields (int64 carriers), ``_U32BITS`` the
    u32 fields carried as int32 bit patterns, ``_NESTED`` the fields that
    are themselves TensorStructs."""

    _U32: frozenset = frozenset()
    _U32BITS: frozenset = frozenset()
    _NESTED: dict = {}

    def replace(self, **kw):
        """A shallow copy with ``kw`` fields swapped (``dataclasses.replace``
        without re-running ``__init__`` over every field)."""
        out = copy.copy(self)
        out.__dict__.update(kw)
        return out

    @classmethod
    def _kind(cls, name):
        if name in cls._U32:
            return "u32"
        if name in cls._U32BITS:
            return "u32bits"
        return None

    def to_numpy(self):
        """The same dataclass with numpy leaves in the JAX package's dtypes."""
        kw = {}
        for fl in dataclasses.fields(self):
            v = getattr(self, fl.name)
            if fl.name in self._NESTED:
                kw[fl.name] = v.to_numpy()
            else:
                kw[fl.name] = _leaf_to_numpy(v, self._kind(fl.name))
        return type(self)(**kw)

    @classmethod
    def from_numpy(cls, src, device="cpu"):
        """Build from an object (or dict) holding every field by name —
        numpy arrays, or anything ``np.asarray`` accepts."""
        get = src.get if isinstance(src, dict) else (lambda n: getattr(src, n))
        kw = {}
        for fl in dataclasses.fields(cls):
            v = get(fl.name)
            if fl.name in cls._NESTED:
                kw[fl.name] = cls._NESTED[fl.name].from_numpy(v, device)
            else:
                kw[fl.name] = _leaf_from_numpy(v, cls._kind(fl.name), device)
        return cls(**kw)


def first_true(mask, dim: int = -1):
    """Index of the first True along ``dim`` (0 when none), as int32 —
    ``jnp.argmax`` over a bool array."""
    return torch.argmax(mask.to(torch.int32), dim=dim).to(torch.int32)


@dataclass
class Frontier(TensorStruct):
    # --- control ---
    active: torch.Tensor  # bool[P]
    halted: torch.Tensor  # bool[P]
    error: torch.Tensor  # bool[P]
    err_code: torch.Tensor  # i32[P]
    reverted: torch.Tensor  # bool[P]
    pc: torch.Tensor  # i32[P]
    contract_id: torch.Tensor  # i32[P]
    # --- call-frame context ---
    depth: torch.Tensor  # i32[P]
    sp_base: torch.Tensor  # i32[P]
    static: torch.Tensor  # bool[P]
    cur_acct: torch.Tensor  # i32[P]
    home_acct: torch.Tensor  # i32[P]
    home_contract: torch.Tensor  # i32[P]
    caller_addr: torch.Tensor  # u32[P, 8]
    callvalue: torch.Tensor  # u32[P, 8]
    pc_hold: torch.Tensor  # bool[P]
    # --- saved caller frames ---
    fr_ret_pc: torch.Tensor  # i32[P, D]
    fr_sp: torch.Tensor  # i32[P, D]
    fr_sp_base: torch.Tensor  # i32[P, D]
    fr_static: torch.Tensor  # bool[P, D]
    fr_cur_acct: torch.Tensor  # i32[P, D]
    fr_contract_id: torch.Tensor  # i32[P, D]
    fr_caller_addr: torch.Tensor  # u32[P, D, 8]
    fr_callvalue: torch.Tensor  # u32[P, D, 8]
    fr_memory: torch.Tensor  # u8[P, D, M]
    fr_mem_words: torch.Tensor  # i32[P, D]
    fr_calldata: torch.Tensor  # u8[P, D, CD]
    fr_calldata_len: torch.Tensor  # i32[P, D]
    fr_ret_off: torch.Tensor  # i64[P, D]
    fr_ret_len: torch.Tensor  # i64[P, D]
    fr_gas_min: torch.Tensor  # i64[P, D]
    fr_gas_max: torch.Tensor  # i64[P, D]
    fr_st_keys: torch.Tensor  # u32[P, D, K, 8]
    fr_st_vals: torch.Tensor  # u32[P, D, K, 8]
    fr_st_used: torch.Tensor  # bool[P, D, K]
    fr_st_written: torch.Tensor  # bool[P, D, K]
    fr_st_acct: torch.Tensor  # i32[P, D, K]
    fr_acct_bal: torch.Tensor  # u32[P, D, A, 8]
    fr_create_slot: torch.Tensor  # i32[P, D]
    fr_gas_limit: torch.Tensor  # i64[P, D]
    # --- EIP-2929 warm sets ---
    warm_acct: torch.Tensor  # bool[P, A]
    st_warm: torch.Tensor  # bool[P, K]
    fr_warm_acct: torch.Tensor  # bool[P, D, A]
    fr_st_warm: torch.Tensor  # bool[P, D, K]
    # --- in-tx CREATE init-code execution ---
    init_code: torch.Tensor  # u8[P, IC]
    init_len: torch.Tensor  # i32[P]
    init_jd: torch.Tensor  # bool[P, IC]
    init_depth: torch.Tensor  # i32[P]
    # --- per-lane world state ---
    acct_addr: torch.Tensor  # u32[P, A, 8]
    acct_code: torch.Tensor  # i32[P, A]
    acct_bal: torch.Tensor  # u32[P, A, 8]
    acct_used: torch.Tensor  # bool[P, A]
    # --- stack ---
    stack: torch.Tensor  # u32[P, S, 8]
    sp: torch.Tensor  # i32[P]
    # --- memory ---
    memory: torch.Tensor  # u8[P, M]
    mem_words: torch.Tensor  # i32[P]
    # --- gas used (min/max accounting) ---
    gas_min: torch.Tensor  # i64[P]
    gas_max: torch.Tensor  # i64[P]
    gas_limit: torch.Tensor  # i64[P]
    # --- storage associative cache ---
    st_keys: torch.Tensor  # u32[P, K, 8]
    st_vals: torch.Tensor  # u32[P, K, 8]
    st_used: torch.Tensor  # bool[P, K]
    st_written: torch.Tensor  # bool[P, K]
    st_acct: torch.Tensor  # i32[P, K]
    # --- calldata / returndata ---
    calldata: torch.Tensor  # u8[P, CD]
    calldata_len: torch.Tensor  # i32[P]
    returndata: torch.Tensor  # u8[P, RD]
    returndata_len: torch.Tensor  # i32[P]
    retval: torch.Tensor  # u8[P, RD]
    retval_len: torch.Tensor  # i32[P]
    # --- events ---
    n_logs: torch.Tensor  # i32[P]
    log_pc: torch.Tensor  # i32[P, LS]
    log_cid: torch.Tensor  # i32[P, LS]
    log_ntopics: torch.Tensor  # i32[P, LS]
    log_topic0: torch.Tensor  # u32[P, LS, 8]
    log_data0: torch.Tensor  # u32[P, LS, 8]
    selfdestructed: torch.Tensor  # bool[P]
    # --- metrics ---
    n_steps: torch.Tensor  # i32[P]
    # the instruction profiler (--enable-iprof): per-lane executed-opcode
    # histograms i32[P, 256] and the residual sidecar i32[256] that takes
    # the rows slot recycling or lane movement would orphan; None when off
    # (attach with `attach_iprof`)
    op_hist: Optional[torch.Tensor] = None
    op_resid: Optional[torch.Tensor] = None

    _U32 = frozenset({
        "caller_addr", "callvalue", "fr_caller_addr", "fr_callvalue",
        "fr_st_keys", "fr_st_vals", "fr_acct_bal", "acct_addr", "acct_bal",
        "stack", "st_keys", "st_vals", "log_topic0", "log_data0"})

    @property
    def n_lanes(self) -> int:
        return self.pc.shape[0]

    def attach_iprof(self) -> "Frontier":
        """Enable the instruction profiler (zeroed histograms + sidecar)."""
        return self.replace(
            op_hist=torch.zeros((self.n_lanes, 256), dtype=torch.int32, device=self.pc.device),
            op_resid=torch.zeros(256, dtype=torch.int32, device=self.pc.device))

    @property
    def device(self):
        return self.pc.device

    @property
    def max_stack(self) -> int:
        return self.stack.shape[1]

    @property
    def running(self):
        """Lanes that still execute: active and not halted/errored."""
        return self.active & ~self.halted & ~self.error

    @property
    def exec_init(self):
        """Lanes whose current frame executes CREATE init code."""
        return (self.init_depth > 0) & (self.depth == self.init_depth)

    def trap(self, mask, code: int) -> "Frontier":
        """Set the error flag under ``mask``, attributing the FIRST cause."""
        return self.replace(
            error=self.error | mask,
            err_code=torch.where(mask & (self.err_code == 0),
                                 torch.full_like(self.err_code, code), self.err_code),
        )

    # --- world-state helpers ---

    def acct_field(self, arr, slot):
        """Per-lane gather arr[P, A, ...] at account slot[P]."""
        idx = torch.clamp(slot, 0, arr.shape[1] - 1).long()
        return arr[torch.arange(arr.shape[0], device=arr.device), idx]

    @property
    def self_address(self):
        return self.acct_field(self.acct_addr, self.cur_acct)

    @property
    def self_balance(self):
        return self.acct_field(self.acct_bal, self.cur_acct)

    def acct_lookup(self, addr) -> tuple:
        """(found bool[P], slot i32[P]) of the account holding ``addr``."""
        match = self.acct_used & torch.all(self.acct_addr == addr[:, None, :], dim=-1)
        return torch.any(match, dim=1), first_true(match, dim=1)


@dataclass
class Env(TensorStruct):
    """Tx-global execution environment; u256 limb tensors [P, 8]."""

    origin: torch.Tensor
    gasprice: torch.Tensor
    coinbase: torch.Tensor
    timestamp: torch.Tensor
    number: torch.Tensor
    prevrandao: torch.Tensor
    blk_gaslimit: torch.Tensor
    chainid: torch.Tensor
    basefee: torch.Tensor

    _U32 = frozenset({"origin", "gasprice", "coinbase", "timestamp", "number",
                      "prevrandao", "blk_gaslimit", "chainid", "basefee"})


@dataclass
class Corpus(TensorStruct):
    """Shared contract images (one per contract, lanes index via contract_id)."""

    code: torch.Tensor  # u8[C, MAX_CODE]
    code_len: torch.Tensor  # i32[C]
    is_jumpdest: torch.Tensor  # bool[C, MAX_CODE]
    code_hash: torch.Tensor  # u32[C, 8] keccak256 of each image

    _U32 = frozenset({"code_hash"})

    @staticmethod
    def from_images(images, device="cpu") -> "Corpus":
        from ..ops.keccak import keccak256_host_int

        hashes = np.stack([
            u256.from_int(keccak256_host_int(
                bytes(np.asarray(im.code[:im.code_len], dtype=np.uint8))))
            for im in images])
        return Corpus.from_numpy(dict(
            code=np.stack([im.code for im in images]).astype(np.uint8),
            code_len=np.array([im.code_len for im in images], dtype=np.int32),
            is_jumpdest=np.stack([im.is_jumpdest for im in images]).astype(bool),
            code_hash=hashes,
        ), device)


def make_frontier(
    n_lanes: int,
    limits: LimitsConfig = DEFAULT_LIMITS,
    contract_id=None,
    calldata: Optional[np.ndarray] = None,
    calldata_len=None,
    gas_limit: int = 10_000_000,
    active=None,
    n_contracts: int = 1,
    contract_addrs: Optional[Sequence[int]] = None,
    caller: int = ATTACKER_ADDRESS,
    callvalue: int = 0,
    balance: int = 10**18,
    attacker_balance: int = 10**20,
    device="cpu",
) -> Frontier:
    """Fresh frontier with a seeded per-lane world state (same layout as
    the JAX package's ``make_frontier``); built in numpy, then moved to
    ``device`` in one pass."""
    P = n_lanes
    L = limits
    A = L.max_accounts
    D = L.call_depth
    K = L.storage_slots
    contract_id = (np.zeros(P, dtype=np.int32) if contract_id is None
                   else np.broadcast_to(np.asarray(contract_id, dtype=np.int32), (P,)))
    if calldata is None:
        calldata = np.zeros((P, L.calldata_bytes), dtype=np.uint8)
    else:
        calldata = np.asarray(calldata, dtype=np.uint8)
        assert calldata.shape == (P, L.calldata_bytes)
    calldata_len = (np.zeros(P, dtype=np.int32) if calldata_len is None
                    else np.broadcast_to(np.asarray(calldata_len, dtype=np.int32), (P,)))
    active = (np.ones(P, dtype=bool) if active is None
              else np.broadcast_to(np.asarray(active, dtype=bool), (P,)))
    if contract_addrs is None:
        contract_addrs = [contract_address(i) for i in range(n_contracts)]
    C = len(contract_addrs)

    addr = np.zeros((P, A, 8), dtype=np.uint32)
    code = np.full((P, A), -1, dtype=np.int32)
    bal = np.zeros((P, A, 8), dtype=np.uint32)
    used = np.zeros((P, A), dtype=bool)
    addr[:, ACCT_ATTACKER] = u256.from_int(ATTACKER_ADDRESS)
    bal[:, ACCT_ATTACKER] = u256.from_int(attacker_balance)
    used[:, ACCT_ATTACKER] = True
    addr[:, ACCT_CREATOR] = u256.from_int(CREATOR_ADDRESS)
    bal[:, ACCT_CREATOR] = u256.from_int(attacker_balance)
    used[:, ACCT_CREATOR] = True
    if ACCT_CONTRACT0 + C <= A:
        for i, a in enumerate(contract_addrs):
            addr[:, ACCT_CONTRACT0 + i] = u256.from_int(a)
            code[:, ACCT_CONTRACT0 + i] = i
            bal[:, ACCT_CONTRACT0 + i] = u256.from_int(balance)
            used[:, ACCT_CONTRACT0 + i] = True
        cur_acct = (ACCT_CONTRACT0 + contract_id).astype(np.int32)
    else:
        for lane in range(P):
            i = int(contract_id[lane])
            addr[lane, ACCT_CONTRACT0] = u256.from_int(contract_addrs[i])
            code[lane, ACCT_CONTRACT0] = i
            bal[lane, ACCT_CONTRACT0] = u256.from_int(balance)
            used[lane, ACCT_CONTRACT0] = True
        cur_acct = np.full(P, ACCT_CONTRACT0, dtype=np.int32)

    def w(v: int):
        return np.broadcast_to(u256.from_int(v), (P, 8))

    z = lambda *s, dt=np.int32: np.zeros(s, dtype=dt)
    z8 = lambda *s: np.zeros(s + (8,), dtype=np.uint32)
    warm = np.zeros((P, A), dtype=bool)
    warm[np.arange(P), ACCT_ATTACKER] = True
    warm[np.arange(P), cur_acct] = True
    leaves = dict(
        active=active, halted=z(P, dt=bool), error=z(P, dt=bool),
        err_code=z(P), reverted=z(P, dt=bool), pc=z(P),
        contract_id=contract_id, depth=z(P), sp_base=z(P),
        static=z(P, dt=bool), cur_acct=cur_acct, home_acct=cur_acct,
        home_contract=contract_id, caller_addr=w(caller), callvalue=w(callvalue),
        pc_hold=z(P, dt=bool),
        fr_ret_pc=z(P, D), fr_sp=z(P, D), fr_sp_base=z(P, D),
        fr_static=z(P, D, dt=bool), fr_cur_acct=z(P, D), fr_contract_id=z(P, D),
        fr_caller_addr=z8(P, D), fr_callvalue=z8(P, D),
        fr_memory=z(P, D, L.mem_bytes, dt=np.uint8), fr_mem_words=z(P, D),
        fr_calldata=z(P, D, L.calldata_bytes, dt=np.uint8), fr_calldata_len=z(P, D),
        fr_ret_off=z(P, D, dt=np.int64), fr_ret_len=z(P, D, dt=np.int64),
        fr_gas_min=z(P, D, dt=np.int64), fr_gas_max=z(P, D, dt=np.int64),
        fr_st_keys=z8(P, D, K), fr_st_vals=z8(P, D, K),
        fr_st_used=z(P, D, K, dt=bool), fr_st_written=z(P, D, K, dt=bool),
        fr_st_acct=z(P, D, K), fr_acct_bal=z8(P, D, A),
        fr_create_slot=np.full((P, D), -1, dtype=np.int32),
        fr_gas_limit=z(P, D, dt=np.int64),
        warm_acct=warm, st_warm=z(P, K, dt=bool),
        fr_warm_acct=z(P, D, A, dt=bool), fr_st_warm=z(P, D, K, dt=bool),
        init_code=z(P, L.init_code_bytes, dt=np.uint8), init_len=z(P),
        init_jd=z(P, L.init_code_bytes, dt=bool), init_depth=z(P),
        acct_addr=addr, acct_code=code, acct_bal=bal, acct_used=used,
        stack=z8(P, L.max_stack), sp=z(P),
        memory=z(P, L.mem_bytes, dt=np.uint8), mem_words=z(P),
        gas_min=z(P, dt=np.int64), gas_max=z(P, dt=np.int64),
        gas_limit=np.full(P, gas_limit, dtype=np.int64),
        st_keys=z8(P, K), st_vals=z8(P, K), st_used=z(P, K, dt=bool),
        st_written=z(P, K, dt=bool), st_acct=z(P, K),
        calldata=calldata, calldata_len=calldata_len,
        returndata=z(P, L.returndata_bytes, dt=np.uint8), returndata_len=z(P),
        retval=z(P, L.returndata_bytes, dt=np.uint8), retval_len=z(P),
        n_logs=z(P), log_pc=z(P, L.log_slots), log_cid=z(P, L.log_slots),
        log_ntopics=z(P, L.log_slots), log_topic0=z8(P, L.log_slots),
        log_data0=z8(P, L.log_slots), selfdestructed=z(P, dt=bool),
        n_steps=z(P), op_hist=None, op_resid=None,
    )
    return Frontier.from_numpy(leaves, device)


def make_env(
    n_lanes: int,
    origin: int = ATTACKER_ADDRESS,
    timestamp: int = 1_700_000_000,
    number: int = 17_000_000,
    chainid: int = 1,
    device="cpu",
) -> Env:
    P = n_lanes

    def w(v: int):
        return np.broadcast_to(u256.from_int(v), (P, 8))

    return Env.from_numpy(dict(
        origin=w(origin), gasprice=w(10**9), coinbase=w(0xC01BA5E),
        timestamp=w(timestamp), number=w(number), prevrandao=w(0x123456789ABCDEF),
        blk_gaslimit=w(30_000_000), chainid=w(chainid), basefee=w(10**9),
    ), device)
