"""What this package's engine runs, and the refusal of what it does not.

The PyTorch engine covers single-frame symbolic execution: bytecode that
contains a CALL-family or CREATE opcode needs call frames, precompiles
and sub-frame returns, which are not ported yet. Such bytecode is found
by a pre-scan with the disassembler and refused before any device work.
"""

from __future__ import annotations

from typing import Sequence

from .disassembler.disassembly import Disassembly

# CREATE, CALL, CALLCODE, DELEGATECALL, CREATE2, STATICCALL
FRAME_OPCODES = {0xF0: "CREATE", 0xF1: "CALL", 0xF2: "CALLCODE",
                 0xF4: "DELEGATECALL", 0xF5: "CREATE2", 0xFA: "STATICCALL"}


class UnsupportedConfiguration(ValueError):
    """The request needs a part of the analyzer this package lacks."""


def frame_opcodes_in(code: bytes) -> list:
    """(address, mnemonic) of every CALL-family/CREATE instruction."""
    return [(ins.address, FRAME_OPCODES[ins.opcode])
            for ins in Disassembly(code).instruction_list
            if ins.opcode in FRAME_OPCODES]


def check_bytecodes_supported(bytecodes: Sequence[bytes], names: Sequence[str]) -> None:
    for code, name in zip(bytecodes, names):
        found = frame_opcodes_in(code)
        if found:
            where = ", ".join(f"{m} at {a}" for a, m in found[:4])
            raise UnsupportedConfiguration(
                f"{name}: bytecode contains {where}"
                f"{' ...' if len(found) > 4 else ''}; call frames and contract "
                "creation (CALL/CALLCODE/DELEGATECALL/STATICCALL/CREATE/CREATE2) "
                "are not supported by the PyTorch engine yet")
