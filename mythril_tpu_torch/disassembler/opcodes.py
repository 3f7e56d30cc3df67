"""EVM opcode metadata (through Shanghai: PUSH0) + dense device tables.

Counterpart of the reference's ``mythril/laser/ethereum/instruction_data.py``
(⚠unv, SURVEY.md §2 "Gas/opcode metadata"): per-opcode mnemonic, stack
in/out arity, and (min, max) static gas. Dynamic gas components (memory
expansion, copy cost, cold/warm access, SSTORE cases) are accounted in the
interpreter, as in the reference's ``StateTransition`` decorator +
per-handler logic.

The TPU-first addition: everything is also exported as dense ``uint``
tables of length 256 indexed by the opcode byte (``STACK_IN``, ``STACK_OUT``,
``GAS_MIN``, ``GAS_MAX``, ``PUSH_WIDTH``, ``IS_VALID``, ``CLASS_ID``), so a
vmapped interpreter reads metadata with a single gather instead of Python
dict dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class OpInfo:
    opcode: int
    name: str
    stack_in: int
    stack_out: int
    gas_min: int
    gas_max: int
    push_width: int = 0  # bytes of immediate data (PUSH1..32); PUSH0 is 0


# Gas figures follow the Istanbul-era schedule the reference models
# (min, max) pairs where the cost is state-dependent.
_G_ZERO = 0
_G_BASE = 2
_G_VERYLOW = 3
_G_LOW = 5
_G_MID = 8
_G_HIGH = 10
_G_SLOAD = 800
_G_BALANCE = 700
_G_EXTCODE = 700
_G_EXTCODEHASH = 700
_G_CALL = 700
_G_CREATE = 32000
_G_JUMPDEST = 1
_G_SSTORE_MIN = 5000  # dirty/no-op floor modeled as min
_G_SSTORE_MAX = 20000  # fresh slot write
_G_LOG = 375
_G_LOGDATA = 8  # per byte — dynamic
_G_SELFDESTRUCT_MIN = 5000
_G_SELFDESTRUCT_MAX = 30000  # + new-account surcharge
_G_CALL_MAX = _G_CALL + 9000 + 25000  # value transfer + new account


def _ops() -> Dict[int, OpInfo]:
    t: Dict[int, OpInfo] = {}

    def op(code, name, sin, sout, gmin, gmax=None, push=0):
        t[code] = OpInfo(code, name, sin, sout, gmin, gmax if gmax is not None else gmin, push)

    op(0x00, "STOP", 0, 0, _G_ZERO)
    op(0x01, "ADD", 2, 1, _G_VERYLOW)
    op(0x02, "MUL", 2, 1, _G_LOW)
    op(0x03, "SUB", 2, 1, _G_VERYLOW)
    op(0x04, "DIV", 2, 1, _G_LOW)
    op(0x05, "SDIV", 2, 1, _G_LOW)
    op(0x06, "MOD", 2, 1, _G_LOW)
    op(0x07, "SMOD", 2, 1, _G_LOW)
    op(0x08, "ADDMOD", 3, 1, _G_MID)
    op(0x09, "MULMOD", 3, 1, _G_MID)
    op(0x0A, "EXP", 2, 1, _G_HIGH, _G_HIGH + 50 * 32)  # + 50/byte of exponent
    op(0x0B, "SIGNEXTEND", 2, 1, _G_LOW)

    op(0x10, "LT", 2, 1, _G_VERYLOW)
    op(0x11, "GT", 2, 1, _G_VERYLOW)
    op(0x12, "SLT", 2, 1, _G_VERYLOW)
    op(0x13, "SGT", 2, 1, _G_VERYLOW)
    op(0x14, "EQ", 2, 1, _G_VERYLOW)
    op(0x15, "ISZERO", 1, 1, _G_VERYLOW)
    op(0x16, "AND", 2, 1, _G_VERYLOW)
    op(0x17, "OR", 2, 1, _G_VERYLOW)
    op(0x18, "XOR", 2, 1, _G_VERYLOW)
    op(0x19, "NOT", 1, 1, _G_VERYLOW)
    op(0x1A, "BYTE", 2, 1, _G_VERYLOW)
    op(0x1B, "SHL", 2, 1, _G_VERYLOW)
    op(0x1C, "SHR", 2, 1, _G_VERYLOW)
    op(0x1D, "SAR", 2, 1, _G_VERYLOW)

    op(0x20, "SHA3", 2, 1, 30, 30 + 6 * 32)  # + 6/word — dynamic

    op(0x30, "ADDRESS", 0, 1, _G_BASE)
    op(0x31, "BALANCE", 1, 1, _G_BALANCE)
    op(0x32, "ORIGIN", 0, 1, _G_BASE)
    op(0x33, "CALLER", 0, 1, _G_BASE)
    op(0x34, "CALLVALUE", 0, 1, _G_BASE)
    op(0x35, "CALLDATALOAD", 1, 1, _G_VERYLOW)
    op(0x36, "CALLDATASIZE", 0, 1, _G_BASE)
    op(0x37, "CALLDATACOPY", 3, 0, _G_VERYLOW, _G_VERYLOW + 3 * 768)
    op(0x38, "CODESIZE", 0, 1, _G_BASE)
    op(0x39, "CODECOPY", 3, 0, _G_VERYLOW, _G_VERYLOW + 3 * 768)
    op(0x3A, "GASPRICE", 0, 1, _G_BASE)
    op(0x3B, "EXTCODESIZE", 1, 1, _G_EXTCODE)
    op(0x3C, "EXTCODECOPY", 4, 0, _G_EXTCODE, _G_EXTCODE + 3 * 768)
    op(0x3D, "RETURNDATASIZE", 0, 1, _G_BASE)
    op(0x3E, "RETURNDATACOPY", 3, 0, _G_VERYLOW, _G_VERYLOW + 3 * 768)
    op(0x3F, "EXTCODEHASH", 1, 1, _G_EXTCODEHASH)

    op(0x40, "BLOCKHASH", 1, 1, 20)
    op(0x41, "COINBASE", 0, 1, _G_BASE)
    op(0x42, "TIMESTAMP", 0, 1, _G_BASE)
    op(0x43, "NUMBER", 0, 1, _G_BASE)
    op(0x44, "PREVRANDAO", 0, 1, _G_BASE)  # a.k.a. DIFFICULTY
    op(0x45, "GASLIMIT", 0, 1, _G_BASE)
    op(0x46, "CHAINID", 0, 1, _G_BASE)
    op(0x47, "SELFBALANCE", 0, 1, _G_LOW)
    op(0x48, "BASEFEE", 0, 1, _G_BASE)

    op(0x50, "POP", 1, 0, _G_BASE)
    op(0x51, "MLOAD", 1, 1, _G_VERYLOW)
    op(0x52, "MSTORE", 2, 0, _G_VERYLOW)
    op(0x53, "MSTORE8", 2, 0, _G_VERYLOW)
    op(0x54, "SLOAD", 1, 1, _G_SLOAD)
    op(0x55, "SSTORE", 2, 0, _G_SSTORE_MIN, _G_SSTORE_MAX)
    op(0x56, "JUMP", 1, 0, _G_MID)
    op(0x57, "JUMPI", 2, 0, _G_HIGH)
    op(0x58, "PC", 0, 1, _G_BASE)
    op(0x59, "MSIZE", 0, 1, _G_BASE)
    op(0x5A, "GAS", 0, 1, _G_BASE)
    op(0x5B, "JUMPDEST", 0, 0, _G_JUMPDEST)
    op(0x5F, "PUSH0", 0, 1, _G_BASE)

    for n in range(1, 33):
        op(0x5F + n, f"PUSH{n}", 0, 1, _G_VERYLOW, push=n)
    for n in range(1, 17):
        op(0x7F + n, f"DUP{n}", n, n + 1, _G_VERYLOW)
    for n in range(1, 17):
        op(0x8F + n, f"SWAP{n}", n + 1, n + 1, _G_VERYLOW)
    for n in range(0, 5):
        op(0xA0 + n, f"LOG{n}", 2 + n, 0, _G_LOG * (n + 1), _G_LOG * (n + 1) + _G_LOGDATA * 256)

    op(0xF0, "CREATE", 3, 1, _G_CREATE)
    op(0xF1, "CALL", 7, 1, _G_CALL, _G_CALL_MAX)
    op(0xF2, "CALLCODE", 7, 1, _G_CALL, _G_CALL + 9000)
    op(0xF3, "RETURN", 2, 0, _G_ZERO)
    op(0xF4, "DELEGATECALL", 6, 1, _G_CALL)
    op(0xF5, "CREATE2", 4, 1, _G_CREATE, _G_CREATE + 6 * 768)
    op(0xFA, "STATICCALL", 6, 1, _G_CALL)
    op(0xFD, "REVERT", 2, 0, _G_ZERO)
    op(0xFE, "INVALID", 0, 0, _G_ZERO)
    op(0xFF, "SELFDESTRUCT", 1, 0, _G_SELFDESTRUCT_MIN, _G_SELFDESTRUCT_MAX)
    return t


OPCODES: Dict[int, OpInfo] = _ops()
_BY_NAME: Dict[str, OpInfo] = {v.name: v for v in OPCODES.values()}
_BY_NAME["DIFFICULTY"] = OPCODES[0x44]
_BY_NAME["KECCAK256"] = OPCODES[0x20]


def opcode_by_name(name: str) -> OpInfo:
    return _BY_NAME[name.upper()]


def name_of(opcode: int) -> str:
    info = OPCODES.get(opcode)
    return info.name if info else f"UNKNOWN_0x{opcode:02x}"


# ---------------------------------------------------------------------------
# Dense device tables (numpy; interpreter wraps them in jnp once)
# ---------------------------------------------------------------------------

STACK_IN = np.zeros(256, dtype=np.int32)
STACK_OUT = np.zeros(256, dtype=np.int32)
GAS_MIN = np.zeros(256, dtype=np.int64)
GAS_MAX = np.zeros(256, dtype=np.int64)
PUSH_WIDTH = np.zeros(256, dtype=np.int32)
IS_VALID = np.zeros(256, dtype=bool)
for _code, _info in OPCODES.items():
    STACK_IN[_code] = _info.stack_in
    STACK_OUT[_code] = _info.stack_out
    GAS_MIN[_code] = _info.gas_min
    GAS_MAX[_code] = _info.gas_max
    PUSH_WIDTH[_code] = _info.push_width
    IS_VALID[_code] = True

# EIP-2929 (Berlin) static tables: state-access opcodes carry their WARM
# cost here; the symbolic engine adds the cold surcharge dynamically from
# its per-lane warm sets (see engine._berlin_gas_fixup). Reference keeps
# an Istanbul-era schedule (SURVEY §2 "Gas/opcode metadata"); the rebuild
# supports both via LimitsConfig.gas_schedule.
G_WARM_ACCESS = 100
G_COLD_SLOAD = 2100
G_COLD_ACCOUNT = 2600

GAS_MIN_BERLIN = GAS_MIN.copy()
GAS_MAX_BERLIN = GAS_MAX.copy()
for _c in (0x31, 0x3B, 0x3C, 0x3F):  # BALANCE EXTCODESIZE EXTCODECOPY EXTCODEHASH
    GAS_MIN_BERLIN[_c] = GAS_MIN[_c] - _G_EXTCODE + G_WARM_ACCESS
    GAS_MAX_BERLIN[_c] = GAS_MAX[_c] - _G_EXTCODE + G_WARM_ACCESS
GAS_MIN_BERLIN[0x54] = G_WARM_ACCESS                 # SLOAD
GAS_MAX_BERLIN[0x54] = G_WARM_ACCESS
GAS_MIN_BERLIN[0x55] = 100                           # SSTORE warm dirty
GAS_MAX_BERLIN[0x55] = 20000                         # fresh slot write
for _c in (0xF1, 0xF2, 0xF4, 0xFA):                  # CALL family
    GAS_MIN_BERLIN[_c] = GAS_MIN[_c] - _G_CALL + G_WARM_ACCESS
    GAS_MAX_BERLIN[_c] = GAS_MAX[_c] - _G_CALL + G_WARM_ACCESS
GAS_MIN_BERLIN[0xFF] = G_WARM_ACCESS + 4900          # SELFDESTRUCT (5000 kept)
GAS_MAX_BERLIN[0xFF] = GAS_MAX[0xFF]

# Halting / control metadata for the interpreter & CFG builder
HALTS = np.zeros(256, dtype=bool)  # STOP RETURN REVERT INVALID SELFDESTRUCT
for _c in (0x00, 0xF3, 0xFD, 0xFE, 0xFF):
    HALTS[_c] = True
IS_JUMP = np.zeros(256, dtype=bool)
IS_JUMP[0x56] = True
IS_JUMPI = np.zeros(256, dtype=bool)
IS_JUMPI[0x57] = True
IS_CALL = np.zeros(256, dtype=bool)  # CALL-family (sub-transaction boundary)
for _c in (0xF1, 0xF2, 0xF4, 0xFA):
    IS_CALL[_c] = True
IS_CREATE = np.zeros(256, dtype=bool)
for _c in (0xF0, 0xF5):
    IS_CREATE[_c] = True
# Invalid opcodes consume all gas (modeled as HALTS + error flag in interp).
