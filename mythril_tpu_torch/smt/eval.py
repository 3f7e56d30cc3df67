"""Exact evaluation of a HostTape under a candidate assignment.

The semantic ground truth for the solver: plain Python ints with EVM
wrap-around semantics, real keccak for hash chains (so witnesses agree
with what concrete re-execution would produce — the reference gets this
via Z3 models + its KeccakFunctionManager linking ⚠unv).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..ops.keccak import keccak256_host_int
from ..symbolic.ops import SymOp, FreeKind

M256 = (1 << 256) - 1
SIGN = 1 << 255

# Reference's well-known actors (mythril/laser/ethereum/transaction ⚠unv):
# concrete attacker/creator addresses used when the caller isn't symbolic.
ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
CREATOR_ADDRESS = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE


def _s(x: int) -> int:
    return x - (1 << 256) if x & SIGN else x


TX_STRIDE = 1 << 16  # leaf b-encoding: b = tx_id * TX_STRIDE + byte offset


@dataclass
class TxInput:
    """One transaction's attacker-chosen inputs."""

    calldata: bytearray = field(default_factory=lambda: bytearray(256))
    calldatasize: Optional[int] = None  # None -> len(calldata)
    caller: int = ATTACKER_ADDRESS
    callvalue: int = 0

    def copy(self) -> "TxInput":
        return TxInput(bytearray(self.calldata), self.calldatasize,
                       self.caller, self.callvalue)

    def read_word(self, off: int) -> int:
        """32-byte big-endian read, zero-padded past the effective
        calldatasize — matching concrete CALLDATALOAD so a sat witness
        can't diverge from replay on short-calldata paths."""
        size = self.calldatasize if self.calldatasize is not None else len(self.calldata)
        size = max(0, min(size, len(self.calldata)))
        w = bytes(self.calldata[off : off + 32])[: max(0, size - off)]
        w = w + b"\x00" * (32 - len(w))
        return int.from_bytes(w, "big")

    def write_word(self, off: int, value: int) -> None:
        need = off + 32
        if len(self.calldata) < need:
            self.calldata.extend(b"\x00" * (need - len(self.calldata)))
        self.calldata[off : off + 32] = (value & M256).to_bytes(32, "big")


@dataclass
class Assignment:
    """Candidate model: per-transaction inputs + global scalar vars.

    Calldata leaves are byte windows over the owning tx's byte array, so
    overlapping leaves (offset 0 vs offset 4) stay mutually consistent by
    construction. Single-tx call sites can keep using the tx-0 proxy
    properties (calldata/caller/callvalue/calldatasize)."""

    txs: List["TxInput"] = field(default_factory=lambda: [TxInput()])
    scalars: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # STORAGE/RETVAL/HAVOC/RETDATASIZE leaves keyed by node id
    by_node: Dict[int, int] = field(default_factory=dict)

    def tx(self, i: int) -> "TxInput":
        while len(self.txs) <= i:
            self.txs.append(TxInput())
        return self.txs[i]

    def copy(self) -> "Assignment":
        return Assignment(
            txs=[t.copy() for t in self.txs],
            scalars=dict(self.scalars),
            by_node=dict(self.by_node),
        )

    # --- tx-0 proxies (single-tx API compatibility) ---
    @property
    def calldata(self) -> bytearray:
        return self.tx(0).calldata

    @property
    def calldatasize(self) -> Optional[int]:
        return self.tx(0).calldatasize

    @calldatasize.setter
    def calldatasize(self, v) -> None:
        self.tx(0).calldatasize = v

    @property
    def caller(self) -> int:
        return self.tx(0).caller

    @caller.setter
    def caller(self, v) -> None:
        self.tx(0).caller = v

    @property
    def callvalue(self) -> int:
        return self.tx(0).callvalue

    @callvalue.setter
    def callvalue(self, v) -> None:
        self.tx(0).callvalue = v

    def read_calldata_word(self, off: int, tx: int = 0) -> int:
        return self.tx(tx).read_word(off)

    def write_calldata_word(self, off: int, value: int, tx: int = 0) -> None:
        self.tx(tx).write_word(off, value)


#: FreeKinds whose values live in ``Assignment.by_node`` (keyed by node
#: id, not by (kind, index)). SINGLE source of truth — the assigner
#: (solver._assign_leaf), the evaluator (_free_value) and the
#: independence partitioner (solver._leaf_keys) all key off this tuple.
BY_NODE_KINDS = (
    int(FreeKind.STORAGE), int(FreeKind.RETVAL), int(FreeKind.HAVOC),
    int(FreeKind.RETDATASIZE), int(FreeKind.BLOCKHASH),
    int(FreeKind.ECRECOVER), int(FreeKind.PRECOMPILE),
)


def _free_value(node_id: int, kind: int, index: int, asn: Assignment) -> int:
    if kind == int(FreeKind.CALLDATA_WORD):
        return asn.tx(index // TX_STRIDE).read_word(index % TX_STRIDE)
    if kind == int(FreeKind.CALLER):
        return asn.tx(index).caller
    if kind == int(FreeKind.ORIGIN):
        return asn.scalars.get((kind, index), asn.caller)
    if kind == int(FreeKind.CALLVALUE):
        return asn.tx(index).callvalue
    if kind == int(FreeKind.CALLDATASIZE):
        t = asn.tx(index)
        return t.calldatasize if t.calldatasize is not None else len(t.calldata)
    if kind in BY_NODE_KINDS:
        return asn.by_node.get(node_id, 0)
    # block-env leaves default to plausible mainnet-ish values
    defaults = {
        int(FreeKind.TIMESTAMP): 1_700_000_000,
        int(FreeKind.NUMBER): 17_000_000,
        int(FreeKind.BALANCE): 10**18,
        int(FreeKind.GASPRICE): 10**9,
        int(FreeKind.PREVRANDAO): 0x123456789ABCDEF,
    }
    return asn.scalars.get((kind, index), defaults.get(kind, 0))


def _packed_tape(tape):
    """ctypes-ready arrays for the native evaluator, cached on the tape
    object (nodes are append-only; a length change invalidates)."""
    import ctypes

    nodes = tape.nodes
    n = len(nodes)
    cached = getattr(tape, "_native_pack", None)
    if cached is not None and cached[0] == n:
        return cached
    op = (ctypes.c_int32 * n)()
    a = (ctypes.c_int32 * n)()
    b = (ctypes.c_int32 * n)()
    imm = bytearray(n * 32)
    leaves = []
    FREE = int(SymOp.FREE)
    for i, nd in enumerate(nodes):
        op[i], a[i], b[i] = nd.op, nd.a, nd.b
        if nd.imm:
            imm[i * 32:(i + 1) * 32] = (nd.imm & M256).to_bytes(32, "big")
        if nd.op == FREE:
            leaves.append(i)
    pack = (n, op, a, b, bytes(imm), tuple(leaves))
    try:
        tape._native_pack = pack  # HostTape is a plain dataclass
    except Exception:
        pass
    return pack


def _evaluate_native(tape, asn: Assignment, lib) -> Optional[List[int]]:
    import ctypes

    n, op, a, b, imm, leaves = _packed_tape(tape)
    vals = bytearray(n * 32)
    for i in leaves:
        nd = tape.nodes[i]
        v = _free_value(i, nd.a, nd.b, asn) & M256
        if v:
            vals[i * 32:(i + 1) * 32] = v.to_bytes(32, "big")
    buf = (ctypes.c_uint8 * len(vals)).from_buffer(vals)
    rc = lib.tape_eval(n, op, a, b, imm,
                       ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    mv = memoryview(vals)
    return [int.from_bytes(mv[i * 32:(i + 1) * 32], "big") for i in range(n)]


def evaluate(tape, asn: Assignment) -> List[int]:
    """Value of every node under `asn` (keccak chains evaluated exactly).
    Returns vals[id]; chain-carrier nodes (SEED/ABS) hold 0.

    Dispatches to the native (C) evaluator when available — the witness
    search calls this hundreds of times per query; the Python big-int
    loop below is the semantic reference and the fallback
    (``MYTHRIL_NO_NATIVE=1``)."""
    from ..native import tape_eval_lib

    lib = tape_eval_lib()
    if lib is not None:
        out = _evaluate_native(tape, asn, lib)
        if out is not None:
            return out
    return _evaluate_py(tape, asn)


def _evaluate_py(tape, asn: Assignment) -> List[int]:
    n = len(tape.nodes)
    vals = [0] * n
    # chain id -> (bytes-so-far, declared_len, start_offset_in_first_word)
    chains: Dict[int, Tuple[bytes, int, int]] = {}

    for i in range(1, n):
        nd = tape.nodes[i]
        op = nd.op
        if op == int(SymOp.NULL):
            continue
        if op == int(SymOp.CONST):
            vals[i] = nd.imm & M256
            continue
        if op == int(SymOp.FREE):
            vals[i] = _free_value(i, nd.a, nd.b, asn) & M256
            continue
        if op == int(SymOp.KECCAK_SEED):
            ln = nd.imm & 0xFFFFFFFF
            r = (nd.imm >> 32) & 0xFFFFFFFF
            chains[i] = (b"", ln, r)
            continue
        if op == int(SymOp.KECCAK_ABS):
            prev = chains.get(nd.a, (b"", 0, 0))
            word = vals[nd.b] if nd.b else (nd.imm & M256)
            chains[i] = (prev[0] + word.to_bytes(32, "big"), prev[1], prev[2])
            continue
        if op == int(SymOp.KECCAK):
            data, ln, r = chains.get(nd.a, (b"", 0, 0))
            vals[i] = keccak256_host_int(data[r : r + ln])
            continue

        a = vals[nd.a]
        b = vals[nd.b]
        if op == int(SymOp.ADD):
            vals[i] = (a + b) & M256
        elif op == int(SymOp.SUB):
            vals[i] = (a - b) & M256
        elif op == int(SymOp.MUL):
            vals[i] = (a * b) & M256
        elif op == int(SymOp.DIV):
            vals[i] = a // b if b else 0
        elif op == int(SymOp.SDIV):
            sa, sb = _s(a), _s(b)
            vals[i] = (abs(sa) // abs(sb) * (1 if (sa < 0) == (sb < 0) else -1)) & M256 if sb else 0
        elif op == int(SymOp.MOD):
            vals[i] = a % b if b else 0
        elif op == int(SymOp.SMOD):
            sa, sb = _s(a), _s(b)
            vals[i] = ((abs(sa) % abs(sb)) * (1 if sa >= 0 else -1)) & M256 if sb else 0
        elif op == int(SymOp.EXP):
            vals[i] = pow(a, b, 1 << 256)
        elif op == int(SymOp.SIGNEXTEND):
            if a < 31:
                bit = 8 * a + 7
                if b & (1 << bit):
                    vals[i] = (b | (M256 ^ ((1 << (bit + 1)) - 1))) & M256
                else:
                    vals[i] = b & ((1 << (bit + 1)) - 1)
            else:
                vals[i] = b
        elif op == int(SymOp.LT):
            vals[i] = int(a < b)
        elif op == int(SymOp.GT):
            vals[i] = int(a > b)
        elif op == int(SymOp.SLT):
            vals[i] = int(_s(a) < _s(b))
        elif op == int(SymOp.SGT):
            vals[i] = int(_s(a) > _s(b))
        elif op == int(SymOp.EQ):
            vals[i] = int(a == b)
        elif op == int(SymOp.ISZERO):
            vals[i] = int(a == 0)
        elif op == int(SymOp.AND):
            vals[i] = a & b
        elif op == int(SymOp.OR):
            vals[i] = a | b
        elif op == int(SymOp.XOR):
            vals[i] = a ^ b
        elif op == int(SymOp.NOT):
            vals[i] = a ^ M256
        elif op == int(SymOp.BYTE):
            vals[i] = (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0
        elif op == int(SymOp.SHL):
            vals[i] = (b << a) & M256 if a < 256 else 0
        elif op == int(SymOp.SHR):
            vals[i] = b >> a if a < 256 else 0
        elif op == int(SymOp.SAR):
            if a >= 256:
                vals[i] = M256 if b & SIGN else 0
            else:
                vals[i] = (_s(b) >> a) & M256
        else:
            vals[i] = 0
    return vals
