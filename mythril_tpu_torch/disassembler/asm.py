"""Tiny two-pass EVM assembler with label support.

Counterpart of the reference's ``mythril/disassembler/asm.py`` (⚠unv,
SURVEY.md §2 "Disassembler") going the other direction: we need to *author*
representative bytecode in-repo because the image carries no ``solc``
binary. Used by ``bench.py``, sample contracts, and tests.

Token forms accepted by :func:`assemble`:

- ``"ADD"`` — opcode by name (case-insensitive)
- ``int`` — PUSH with the minimal width holding the value
- ``("pushN", value)`` — explicit ``PUSHN`` with ``value``
- ``("label", "name")`` — define a jump label at the current offset
- ``("ref", "name")`` — ``PUSH2`` of the label's final offset
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from .opcodes import opcode_by_name

Token = Union[str, int, Tuple[str, Union[int, str]]]


def _min_push_width(value: int) -> int:
    if value == 0:
        return 1
    return max(1, (value.bit_length() + 7) // 8)


def assemble(*tokens: Token) -> bytes:
    """Assemble tokens into bytecode; two passes to resolve label refs."""
    # pass 1: lay out, recording label defs and 2-byte ref placeholders
    out = bytearray()
    labels: Dict[str, int] = {}
    refs: List[Tuple[int, str]] = []  # (patch offset, label)
    for t in tokens:
        if isinstance(t, str):
            out.append(opcode_by_name(t).opcode)
        elif isinstance(t, int):
            w = _min_push_width(t)
            if t < 0 or w > 32:
                raise ValueError(f"push value out of range: {t!r}")
            out.append(0x5F + w)
            out.extend(t.to_bytes(w, "big"))
        elif isinstance(t, tuple) and t[0] == "label":
            labels[t[1]] = len(out)
            out.append(opcode_by_name("JUMPDEST").opcode)
        elif isinstance(t, tuple) and t[0] == "ref":
            out.append(0x61)  # PUSH2
            refs.append((len(out), t[1]))
            out.extend(b"\x00\x00")
        elif isinstance(t, tuple) and t[0].lower().startswith("push"):
            n = int(t[0][4:])
            if not 0 <= n <= 32:
                raise ValueError(f"bad push width: {t!r}")
            out.append(0x5F + n)
            out.extend(int(t[1]).to_bytes(n, "big"))
        else:
            raise ValueError(f"bad asm token: {t!r}")
    # pass 2: patch refs
    for off, name in refs:
        out[off : off + 2] = labels[name].to_bytes(2, "big")
    return bytes(out)


def selector_prologue() -> List[Token]:
    """Dispatcher prologue fragment: leaves the 4-byte selector on stack."""
    return [0, "CALLDATALOAD", (1 << 224), "SWAP1", "DIV"]


def mapping_key(slot: int) -> List[Token]:
    """Solidity mapping-slot idiom: top-of-stack key ->
    keccak(key . slot). Shared by the in-repo fixtures (erc20_like,
    config-4, realworld) so the storage-layout convention lives in ONE
    place."""
    return [0, "MSTORE", slot, 32, "MSTORE", 64, 0, "SHA3"]


def erc20_like() -> bytes:
    """A hand-written token contract exercising the representative opcode
    mix (dispatcher, keccak mapping keys, storage, branches, arithmetic).

    Storage layout: balances[addr] at keccak(addr . 0x00), totalSupply at
    slot 1. Functions:
      0xa9059cbb transfer(address,uint256)
      0x70a08231 balanceOf(address)
      0x18160ddd totalSupply()
    Fallback reverts. The reference's bench fixture would be a
    solc-compiled OpenZeppelin ERC-20 (BASELINE config 1); this is the
    no-solc stand-in with the same structural profile.
    """

    mapkey = mapping_key

    return assemble(
        # -- dispatcher --
        *selector_prologue(),
        "DUP1", 0xA9059CBB, "EQ", ("ref", "transfer"), "JUMPI",
        "DUP1", 0x70A08231, "EQ", ("ref", "balanceOf"), "JUMPI",
        "DUP1", 0x18160DDD, "EQ", ("ref", "totalSupply"), "JUMPI",
        0, 0, "REVERT",
        # -- transfer(to, amount) --
        ("label", "transfer"),
        "POP",
        4, "CALLDATALOAD",            # to
        36, "CALLDATALOAD",           # amount   [to, amount]
        "CALLER", *mapkey(0),         # keccak(caller.0)        [to, amount, fromKey]
        "DUP1", "SLOAD",              # [to, amount, fromKey, fromBal]
        "DUP3", "DUP2", "LT",         # fromBal < amount ?
        ("ref", "insufficient"), "JUMPI",
        "DUP3", "SWAP1", "SUB",       # newFromBal = fromBal - amount
        "SWAP1", "SSTORE",            # balances[from] = newFromBal  [to, amount]
        "SWAP1", *mapkey(0),          # keccak(to.0)   [amount, toKey]
        "DUP1", "SLOAD",              # [amount, toKey, toBal]
        "DUP3", "ADD",                # toBal + amount
        "SWAP1", "SSTORE",            # balances[to] = ...   [amount]
        "POP",
        1, 0, "MSTORE", 32, 0, "RETURN",
        ("label", "insufficient"),
        0, 0, "REVERT",
        # -- balanceOf(addr) --
        ("label", "balanceOf"),
        "POP",
        4, "CALLDATALOAD", *mapkey(0), "SLOAD",
        0, "MSTORE", 32, 0, "RETURN",
        # -- totalSupply() --
        ("label", "totalSupply"),
        "POP",
        1, "SLOAD", 0, "MSTORE", 32, 0, "RETURN",
    )


def abi_call(selector4: int, *args: int) -> bytes:
    """Build calldata: 4-byte selector + 32-byte big-endian args."""
    out = selector4.to_bytes(4, "big")
    for a in args:
        out += int(a).to_bytes(32, "big")
    return out
