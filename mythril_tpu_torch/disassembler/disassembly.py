"""Bytecode -> instruction list + device-ready contract image.

Counterpart of the reference's ``mythril/disassembler/{asm,disassembly}.py``
(⚠unv, SURVEY.md §2): linear-sweep disassembly, JUMPDEST mapping (excluding
push immediates), function-selector extraction from the dispatcher prologue,
and EASM rendering.

TPU-first addition: :class:`ContractImage` packs a contract into fixed-shape
arrays (padded code bytes + jumpdest/is-code bitmaps) so a whole corpus
stacks into ``u8[N_CONTRACTS, MAX_CODE]`` and ships to the device once.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Dict, Tuple

import numpy as np

from .opcodes import OPCODES, PUSH_WIDTH, name_of


def _to_bytes(code) -> bytes:
    if isinstance(code, (bytes, bytearray)):
        return bytes(code)
    s = str(code).strip()
    if s.startswith(("0x", "0X")):
        s = s[2:]
    s = re.sub(r"\s", "", s)
    # solc appends a non-hex metadata marker in some outputs; keep strict here
    if len(s) % 2:
        s = s[:-1]
    return bytes.fromhex(s)


@dataclass(frozen=True)
class EvmInstruction:
    """One decoded instruction (reference: ``EvmInstruction`` in asm.py ⚠unv)."""

    address: int
    opcode: int
    name: str
    argument: Optional[bytes] = None  # push immediate, if any

    @property
    def arg_int(self) -> Optional[int]:
        return int.from_bytes(self.argument, "big") if self.argument is not None else None

    def as_easm(self) -> str:
        if self.argument is not None:
            return f"{self.address:04x} {self.name} 0x{self.argument.hex()}"
        return f"{self.address:04x} {self.name}"


def disassemble(code) -> List[EvmInstruction]:
    """Linear-sweep disassembly (reference: ``asm.disassemble`` ⚠unv)."""
    raw = _to_bytes(code)
    out: List[EvmInstruction] = []
    pc = 0
    n = len(raw)
    while pc < n:
        op = raw[pc]
        width = int(PUSH_WIDTH[op])
        if width:
            arg = raw[pc + 1 : pc + 1 + width]
            # trailing truncated push: pad with zeros like every EVM client
            arg = arg + b"\x00" * (width - len(arg))
            out.append(EvmInstruction(pc, op, name_of(op), arg))
            pc += 1 + width
        else:
            out.append(EvmInstruction(pc, op, name_of(op)))
            pc += 1
    return out


@dataclass
class ContractImage:
    """Fixed-shape device image of one contract.

    ``code`` is zero-padded (0x00 = STOP, the correct EVM semantics for
    running off the end of code). ``is_jumpdest[i]`` is true iff byte i is a
    0x5b that is *not* inside a push immediate. ``is_code`` marks real
    opcode positions (false inside immediates).
    """

    code: np.ndarray  # u8[max_code]
    code_len: int
    is_jumpdest: np.ndarray  # bool[max_code]
    is_code: np.ndarray  # bool[max_code]

    @staticmethod
    def from_bytecode(code, max_code: int) -> "ContractImage":
        raw = _to_bytes(code)
        if len(raw) > max_code:
            raise ValueError(f"bytecode length {len(raw)} exceeds max_code {max_code}")
        buf = np.zeros(max_code, dtype=np.uint8)
        buf[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        is_code = np.zeros(max_code, dtype=bool)
        is_jumpdest = np.zeros(max_code, dtype=bool)
        pc = 0
        while pc < len(raw):
            is_code[pc] = True
            op = raw[pc]
            if op == 0x5B:
                is_jumpdest[pc] = True
            pc += 1 + int(PUSH_WIDTH[op])
        return ContractImage(buf, len(raw), is_jumpdest, is_code)


_DISPATCH_RE_DOC = """Function-selector extraction pattern.

The solc dispatcher prologue compares the calldata selector against each
function hash:  DUP1 PUSH4 <sel> EQ PUSH<n> <dest> JUMPI   (or with the
selector pushed first). We scan the instruction list for PUSH4 followed
within a few instructions by EQ and a JUMPI whose destination was pushed.
(reference: ``disassembly.get_function_info`` / signature DB wiring ⚠unv)
"""


def extract_function_entries(instrs: List[EvmInstruction]) -> Dict[str, int]:
    """selector hex ('0x...') -> jumpdest address of the function body."""
    entries: Dict[str, int] = {}
    for i, ins in enumerate(instrs):
        if ins.name != "PUSH4" or ins.argument is None:
            continue
        window = instrs[i + 1 : i + 5]
        names = [w.name for w in window]
        if "EQ" not in names:
            continue
        dest = None
        for w in window:
            if w.name.startswith("PUSH") and w.name not in ("PUSH4",) and w.argument is not None:
                dest = w.arg_int
            if w.name == "JUMPI" and dest is not None:
                entries[f"0x{ins.argument.hex()}"] = dest
                break
    return entries


class Disassembly:
    """Host-side disassembly view (reference: ``Disassembly`` ⚠unv).

    Holds the instruction list, jumpdest map, and extracted function
    selectors; renders EASM. The device-side twin is :class:`ContractImage`.
    """

    def __init__(self, code, enable_online_lookup: bool = False):
        self.bytecode = _to_bytes(code)
        self.instruction_list = disassemble(self.bytecode)
        self.func_hashes = extract_function_entries(self.instruction_list)
        self.addr_to_func: Dict[int, str] = {v: k for k, v in self.func_hashes.items()}
        self.jumpdests = {i.address for i in self.instruction_list if i.name == "JUMPDEST"}
        self._addr_index = {ins.address: idx for idx, ins in enumerate(self.instruction_list)}

    def get_easm(self) -> str:
        return "\n".join(i.as_easm() for i in self.instruction_list) + "\n"

    def instruction_at(self, address: int) -> Optional[EvmInstruction]:
        idx = self._addr_index.get(address)
        return self.instruction_list[idx] if idx is not None else None

    def image(self, max_code: int) -> ContractImage:
        return ContractImage.from_bytecode(self.bytecode, max_code)

    def __len__(self):
        return len(self.instruction_list)
