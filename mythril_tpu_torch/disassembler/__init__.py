"""Disassembler layer: bytecode -> instruction metadata + device arrays.

TPU-native counterpart of the reference's ``mythril/disassembler/`` and
``mythril/laser/ethereum/instruction_data.py`` (⚠unv, SURVEY.md §2): the
same opcode metadata, but exported additionally as dense uint tables
indexed by opcode byte so the vmapped interpreter can gather
stack-arity/gas/push-width without Python dispatch.
"""

from .opcodes import OPCODES, OpInfo, opcode_by_name  # noqa: F401
from .disassembly import Disassembly, disassemble, ContractImage  # noqa: F401
