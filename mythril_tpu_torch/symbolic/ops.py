"""Tape node opcodes and free-variable kinds.

The tape is the device-resident analog of the reference's Z3 AST
(``mythril/laser/smt/bitvec.py`` ⚠unv): each node is
``(op, a, b, imm)`` where ``a``/``b`` are earlier node ids (SSA) and
``imm`` is a u256 payload (constants, concrete keys). Node id 0 is the
reserved concrete-zero/null node; stack slots carry a parallel sym-id of 0
to mean "concrete, value lives in the limb arrays".
"""

from __future__ import annotations

from enum import IntEnum


class SymOp(IntEnum):
    NULL = 0        # id-0 sentinel / unused slot
    CONST = 1       # imm = value
    FREE = 2        # a = FreeKind, b = index, imm = aux (e.g. storage key)
    # arithmetic (a ∘ b)
    ADD = 3
    SUB = 4
    MUL = 5
    DIV = 6
    SDIV = 7
    MOD = 8
    SMOD = 9
    EXP = 10
    SIGNEXTEND = 11
    # comparisons (result is 0/1 word)
    LT = 12
    GT = 13
    SLT = 14
    SGT = 15
    EQ = 16
    ISZERO = 17     # unary: a
    # bitwise
    AND = 18
    OR = 19
    XOR = 20
    NOT = 21        # unary: a
    BYTE = 22       # a = index expr, b = word
    SHL = 23        # a = shift, b = value   (EVM operand order)
    SHR = 24
    SAR = 25
    # keccak chain: digest = KECCAK(absorb(...absorb(KECCAK_SEED, w0)..., wn))
    KECCAK_SEED = 26  # imm = byte length
    KECCAK_ABS = 27   # a = chain, b = absorbed word id (imm = concrete word)
    KECCAK = 28       # a = final chain node -> 256-bit digest


class FreeKind(IntEnum):
    """Leaf variable kinds (the model-search variable space)."""

    CALLER = 0
    CALLVALUE = 1
    CALLDATASIZE = 2
    CALLDATA_WORD = 3   # b = BYTE offset of the 32-byte read window

    ORIGIN = 4
    TIMESTAMP = 5
    NUMBER = 6
    BALANCE = 7
    GASPRICE = 8
    STORAGE = 9         # initial storage value; imm = concrete key, a = key node id
    RETVAL = 10         # return value of external call; b = call index
    RETDATA_WORD = 11   # word of external call returndata; b = call idx * 64 + word
    HAVOC = 12          # unconstrained havoc (unaligned/symbolic-offset reads)
    PREVRANDAO = 13
    BLOCKHASH = 14
    RETDATASIZE = 15    # returndata size of an external call; b = call index
    ECRECOVER = 16      # uninterpreted ecrecover result; b = call index
    # (the reference also models ecrecover as an uninterpreted function on
    # symbolic inputs — natives.py ⚠unv; NOT attacker-controlled taint)
    PRECOMPILE = 17     # other unmodeled precompile output; b = call index


# Multi-transaction leaf identity: tx-scoped leaves encode the transaction
# index in `b` — calldata words as b = tx_id * TX_STRIDE + byte_offset,
# caller/callvalue/calldatasize as b = tx_id. Tx 0 therefore has b == the
# plain offset/0, which is exactly what the pre-seeded rows below carry, so
# hash-consing dedups first-tx reads onto the seeds. ORIGIN and the block
# environment stay global (b = 0) across the sequence.
TX_STRIDE = 1 << 16

# BALANCE leaves are keyed b = bal_epoch * BAL_STRIDE + account slot: the
# epoch versions the leaf across concrete balance-table changes (see
# SymFrontier.bal_epoch). Must exceed LimitsConfig.max_accounts.
BAL_STRIDE = 256

# Well-known leaves pre-seeded on the tape at fixed ids so the hot paths
# (CALLDATALOAD, CALLER, CALLVALUE) never need an append. Layout:
#   id 0              NULL (concrete zero)
#   id 1..N           the list below, then calldata words
_WK_BASE = [
    FreeKind.CALLER,
    FreeKind.CALLVALUE,
    FreeKind.CALLDATASIZE,
    FreeKind.ORIGIN,
    FreeKind.TIMESTAMP,
    FreeKind.NUMBER,
    FreeKind.BALANCE,
    FreeKind.GASPRICE,
    FreeKind.PREVRANDAO,
]

WK_CALLER = 1
WK_CALLVALUE = 2
WK_CALLDATASIZE = 3
WK_ORIGIN = 4
WK_TIMESTAMP = 5
WK_NUMBER = 6
WK_BALANCE = 7
WK_GASPRICE = 8
WK_PREVRANDAO = 9
# Calldata leaves are keyed by BYTE offset, matching how solc-compiled code
# actually reads calldata: the selector word at offset 0, then ABI argument
# words at offsets 4 + 32*i. WK_CALLDATA0 is the offset-0 leaf; argument i
# lives at id WK_CALLDATA0 + 1 + i. Leaves overlap byte-wise (offset 0 and
# offset 4 share bytes 4..31); the model search resolves them over one
# shared calldata byte array, the propagation treats them as independent
# (sound, merely less precise).
WK_CALLDATA0 = 10


def calldata_arg_offsets(calldata_bytes: int):
    """Byte offsets of the pre-seeded calldata leaves: 0, 4, 36, 68, ..."""
    offs = [0]
    o = 4
    while o + 32 <= calldata_bytes:
        offs.append(o)
        o += 32
    return offs


def WELL_KNOWN(calldata_bytes: int):
    """[(op, kind, index)] rows for tape slots 1..N in order."""
    rows = [(int(SymOp.FREE), int(k), 0) for k in _WK_BASE]
    for off in calldata_arg_offsets(calldata_bytes):
        rows.append((int(SymOp.FREE), int(FreeKind.CALLDATA_WORD), off))
    return rows


def N_WELL_KNOWN(calldata_bytes: int) -> int:
    return 1 + len(_WK_BASE) + len(calldata_arg_offsets(calldata_bytes))
