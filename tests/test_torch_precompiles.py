"""Precompiles 0x1-0x9 on the CPU: the PyTorch analyzer against the JAX
package, exactly.

- the programs of ``test_precompiles.py`` (sha256, identity, modexp,
  concrete, invalid and symbolic ecrecover, ripemd160, bn128
  add/invalid/pairing, blake2f) as one batch through ``sym_run``: the
  frontier, returndata included, field for field against the JAX
  engine's, and the stored results against hashlib / the host natives.
  The batch also holds ``test_torch_frames``'s CALL/CREATE programs, so
  the two modules share one JAX engine compile (``torch_port_batch``);
- ``sha256_plain`` (the plain version of kernel K4) against the JAX
  ``sha256_device`` and hashlib at the padding boundaries;
- ``modexp_plain`` (the plain version of kernel K5) against the JAX
  ``modexp`` and Python's ``pow`` on edge cases.

The PyTorch and JAX work runs in child processes (``torch_port_child``),
the two at the same time.
"""

import hashlib

import numpy as np
import pytest

import torch_port_batch
from mythril_tpu_torch.disassembler.asm import assemble

LANES = 8  # per program
SHA_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 448]
M256 = (1 << 256) - 1
MODEXP_CASES = [(3, 5, 0), (3, 0, 1), (0, 0, 1), (5, 0, 7), (0, 5, 7), (M256, M256, M256),
                (M256, M256, M256 - 1), (2, M256, 1 << 255), (2, M256, (1 << 255) + 1),
                (12345, M256, 1), (M256, 2, 3), ((1 << 255) + 1, 3, (1 << 255) - 19),
                (2, 10, 1 << 200), (9, M256, 1 << 100), (7, 1, 2), (1 << 200, 1 << 70, 97)]

_ECR_HASH = 0x456E9AEA5E197A1F1AF7A3E85A3212FA4049A3BA34C2289B4C860FC0B0C64EF3
_ECR_V = 28
_ECR_R = 0x9242685BF161793CC25603C231BC2F568EB630EA16AA137D2664AC8038825608
_ECR_S = 0x4F8AE3BD7535248D0BD448298CC2E2071E56992D0774DC340C368AE950852ADA
_ECR_ADDR = 0x7156526FBD7A3C72969B54F64E42C10FBB768C8A


def call_pre(addr, args=(0, 0), ret=(0, 32)):
    return [ret[1], ret[0], args[1], args[0], 0, addr, ("push2", 0xFFFF), "CALL"]


def _mstore_words(data: bytes, base: int = 0):
    ops = []
    for i in range(0, len(data), 32):
        w = int.from_bytes(data[i:i + 32].ljust(32, b"\x00"), "big")
        ops += [("push32", w), base + i, "MSTORE"]
    return ops


def _g2_calldata(pt) -> bytes:
    x, y = pt
    return (x.c1.to_bytes(32, "big") + x.c0.to_bytes(32, "big")
            + y.c1.to_bytes(32, "big") + y.c0.to_bytes(32, "big"))


def _blake2f_input():
    from mythril_tpu_torch.ops.blake2 import IV

    h = list(IV)
    h[0] ^= 0x01010040
    return ((12).to_bytes(4, "big") + b"".join(x.to_bytes(8, "little") for x in h)
            + b"abc".ljust(128, b"\x00") + (3).to_bytes(8, "little")
            + (0).to_bytes(8, "little") + b"\x01")


def programs():
    """name -> bytecode: the precompile programs of test_precompiles.py."""
    from mythril_tpu_torch.ops import bn128 as bn

    g1b = bn._write_g1(bn.G1)
    pairing = g1b + _g2_calldata(bn.G2) + bn._write_g1(bn._pt_neg(bn.G1)) + _g2_calldata(bn.G2)
    return {
        "sha256": assemble(42, 0, "MSTORE", *call_pre(2, (0, 32), (32, 32)), 1, "SSTORE",
                           32, "MLOAD", 2, "SSTORE", "STOP"),
        "identity": assemble(0x1234, 0, "MSTORE", *call_pre(4, (0, 32), (64, 32)), "POP",
                             64, "MLOAD", 1, "SSTORE", "STOP"),
        "modexp": assemble(32, 0, "MSTORE", 32, 32, "MSTORE", 32, 64, "MSTORE",
                           3, 96, "MSTORE", 5, 128, "MSTORE", 100, 160, "MSTORE",
                           *call_pre(5, (0, 192), (192, 32)), "POP", ("push1", 192), "MLOAD",
                           1, "SSTORE", "STOP"),
        "ecrecover_symbolic": assemble(0, "CALLDATALOAD", 0, "MSTORE",
                                       *call_pre(1, (0, 128), (0, 32)), "POP", 0, "MLOAD", 1,
                                       "SSTORE", "STOP"),
        "ecrecover_invalid": assemble(*call_pre(1, (0, 128), (0, 32)), "POP", 0, "MLOAD", 1,
                                      "SSTORE", "STOP"),
        "ecrecover_vector": assemble(("push32", _ECR_HASH), 0, "MSTORE", _ECR_V, 32, "MSTORE",
                                     ("push32", _ECR_R), 64, "MSTORE", ("push32", _ECR_S), 96,
                                     "MSTORE", *call_pre(1, (0, 128), (128, 32)), 1, "SSTORE",
                                     ("push1", 128), "MLOAD", 2, "SSTORE", "STOP"),
        "ripemd_symbolic": assemble(0, "CALLDATALOAD", 0, "MSTORE",
                                    *call_pre(3, (0, 32), (0, 32)), "POP", 0, "MLOAD",
                                    ("ref", "nz"), "JUMPI", 1, 0, "SSTORE", "STOP",
                                    ("label", "nz"), 2, 0, "SSTORE", "STOP"),
        "ripemd": assemble(42, 0, "MSTORE", *call_pre(3, (0, 32), (32, 32)), 1, "SSTORE",
                           32, "MLOAD", 2, "SSTORE", "STOP"),
        "bn128_add": assemble(*_mstore_words(g1b + g1b), *call_pre(6, (0, 128), (128, 64)),
                              1, "SSTORE", ("push1", 128), "MLOAD", 2, "SSTORE",
                              ("push1", 160), "MLOAD", 3, "SSTORE", "STOP"),
        "bn128_invalid": assemble(1, 0, "MSTORE", 1, 32, "MSTORE",
                                  *call_pre(6, (0, 128), (128, 64)), 1, "SSTORE",
                                  "RETURNDATASIZE", 2, "SSTORE", ("push1", 128), "MLOAD", 3,
                                  "SSTORE", "STOP"),
        "bn128_pairing": assemble(*_mstore_words(pairing),
                                  *call_pre(8, (0, len(pairing)), (384, 32)), 1, "SSTORE",
                                  ("push2", 384), "MLOAD", 2, "SSTORE", "STOP"),
        # a modexp header length past 2^64 reads as -1 and must fail the
        # operand-window check (leaf path), in both packages
        "modexp_huge_header": assemble(("push32", 1 << 255), 0, "MSTORE", 32, 32, "MSTORE",
                                       32, 64, "MSTORE", *call_pre(5, (0, 192), (192, 32)),
                                       1, "SSTORE", ("push1", 192), "MLOAD", 2, "SSTORE",
                                       "STOP"),
        "blake2f": assemble(*_mstore_words(_blake2f_input()), *call_pre(9, (0, 213), (224, 64)),
                            1, "SSTORE", ("push1", 224), "MLOAD", 2, "SSTORE",
                            ("push2", 256), "MLOAD", 3, "SSTORE", "STOP"),
    }


def expected_storage():
    """name -> {slot: value} the precompiles must produce on lane 0."""
    from mythril_tpu_torch.ops import bn128 as bn
    from mythril_tpu_torch.ops.blake2 import blake2f_precompile

    word = (42).to_bytes(32, "big")
    g1b = bn._write_g1(bn.G1)
    add = bn.ecadd(g1b + g1b)
    b2 = blake2f_precompile(_blake2f_input())
    i = lambda b: int.from_bytes(b, "big")
    return {
        "sha256": {1: 1, 2: i(hashlib.sha256(word).digest())},
        "identity": {1: 0x1234},
        "modexp": {1: 43},
        "ecrecover_invalid": {1: 0},
        "ecrecover_vector": {1: 1, 2: _ECR_ADDR},
        "ripemd": {1: 1, 2: i(hashlib.new("ripemd160", word).digest())},
        "bn128_add": {1: 1, 2: i(add[:32]), 3: i(add[32:])},
        "bn128_invalid": {1: 0, 2: 0, 3: 0},
        "bn128_pairing": {1: 1, 2: 1},
        "blake2f": {1: 1, 2: i(b2[:32]), 3: i(b2[32:])},
    }


def precompile_images():
    return [code for _, code in sorted(programs().items())]


def sha_inputs():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (len(SHA_LENGTHS), 448), dtype=np.uint8)
    for k, n in enumerate(SHA_LENGTHS):
        data[k, n:] = 0
    return data, np.array(SHA_LENGTHS, dtype=np.int32)


def _limbs(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _int(limbs) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(limbs))


def modexp_inputs():
    return tuple(np.array([_limbs(c[k]) for c in MODEXP_CASES], dtype=np.uint32)
                 for k in range(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_port_batch.runs(tmp_path_factory)


def _lane(prog_index):
    """The seeded lane of a precompile program in the shared batch."""
    return torch_port_batch.layout()[4] + prog_index * LANES


def _cid(prog_index):
    return torch_port_batch.layout()[3] + prog_index


def test_jax_reference_runs_the_host_natives(runs):
    # the port always takes the host round trip; the reference must too
    assert runs[0]["cb_ok"] is True


@pytest.mark.parametrize("group", ["base", "sym"])
def test_batch_frontier_matches_jax_field_for_field(runs, group):
    want, got = runs[0]["batch"], runs[1]["batch"]
    lanes = ~torch_port_batch.frame_lanes(want)
    assert lanes.sum() >= len(programs())
    assert torch_port_batch.mismatched_fields(want, got, group, lanes) == []


def test_batch_returndata_matches_jax(runs):
    want, got = runs[0]["batch"], runs[1]["batch"]
    for k in ("base.returndata", "base.returndata_len", "retdata_sym"):
        assert np.array_equal(got[k], want[k]), k


def _lane0_storage(leaves, prog_index):
    lane = _lane(prog_index)
    used = leaves["base.st_used"][lane]
    return {_int(leaves["base.st_keys"][lane, k]): _int(leaves["base.st_vals"][lane, k])
            for k in range(used.shape[0]) if used[k]}


CONCRETE = ["blake2f", "bn128_add", "bn128_invalid", "bn128_pairing", "ecrecover_invalid",
            "ecrecover_vector", "identity", "modexp", "ripemd", "sha256"]


def test_every_concrete_program_has_an_expectation():
    assert sorted(expected_storage()) == CONCRETE


@pytest.mark.parametrize("name", CONCRETE)
def test_precompile_result(runs, name):
    idx = sorted(programs()).index(name)
    st = _lane0_storage(runs[1]["batch"], idx)
    assert {k: st.get(k) for k in expected_storage()[name]} == expected_storage()[name]


def test_symbolic_inputs_give_leaves(runs):
    got = runs[1]["batch"]
    lane = _lane(sorted(programs()).index("ecrecover_symbolic"))
    assert (got["st_val_sym"][lane][got["base.st_used"][lane]] != 0).any()
    lane = _lane(sorted(programs()).index("modexp_huge_header"))
    assert (got["st_val_sym"][lane][got["base.st_used"][lane]] != 0).any()
    idx = sorted(programs()).index("ripemd_symbolic")
    # both sides of the branch on the havocked digest (the fork copy lands
    # in the first free lane, wherever it is)
    assert (got["base.active"] & (got["base.contract_id"] == _cid(idx))).sum() == 2


def test_sha256_plain_matches_jax_device(runs):
    assert np.array_equal(runs[1]["sha"], runs[0]["sha"])


@pytest.mark.parametrize("k", range(len(SHA_LENGTHS)))
def test_sha256_plain_matches_hashlib(runs, k):
    data, lens = sha_inputs()
    want = int.from_bytes(hashlib.sha256(bytes(data[k, :lens[k]])).digest(), "big")
    assert _int(runs[1]["sha"][k]) == want


def test_modexp_plain_matches_jax(runs):
    assert np.array_equal(runs[1]["modexp"], runs[0]["modexp"])


@pytest.mark.parametrize("k", range(len(MODEXP_CASES)))
def test_modexp_plain_matches_pow(runs, k):
    b, e, m = MODEXP_CASES[k]
    assert _int(runs[1]["modexp"][k]) == (pow(b, e, m) if m else 0)
