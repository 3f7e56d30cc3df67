"""Smoke run of the PyTorch/CUDA analyzer on one NVIDIA card.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels (K1-K9) from ``mythril_tpu_torch/
   kernels/csrc`` with nvcc, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card
   (K1-K4 and K6-K9 at the main path's width, P = 2048 lanes; K5 on 64
   lanes of edge and random operands), seeded random inputs plus edge
   cases; bit-for-bit equality is required, and K4/K5/K8/K9 also against
   hashlib / Python's ints. K6 on random tapes holding every op and on
   the frontier of a real batch just before a sweep; K7 for each policy
   at fork blocks of 64 lanes and of P. Times each kernel, its plain
   version and the bound the card's rates put on the same work;
4. goldens: the 20 golden fixtures at the goldens' settings (test
   limits, 16 lanes, 192 steps), the real-world batch and BASELINE
   config 4 at their tests' limits, issue for issue against
   ``tests/fixtures/goldens``;
5. analyze: ``analyze -o json`` at the CLI defaults (64 lanes, 512
   steps, -t 2) — the main path — against the JAX reports pinned in
   ``tests/fixtures/torch_port/*_default.json``: (a) the realworld ERC-20
   and ERC-721 runtimes; (b) the 2-of-3 multisig (CALL) and the
   precompile fixture with ``--creation-code`` (SHA-256 and MODEXP in its
   constructor: K4 and K5 must launch there). Launch counts are zeroed
   just before each part and read just after;
6. frames at full width through ``SymExecWrapper``: BASELINE config 4
   (caller -> router -> vault, creation tx + 2 message txs, default
   limits, 64 lanes per contract, 512 steps) and the 4-contract
   real-world batch (EIP-1167 proxy, ERC-20, ERC-721, multisig; -t 2),
   against pinned JAX reports; wall time, supersteps, host syncs, frames
   pushed and popped, K4/K5 launches;
7. batch: 32 contracts (16 x ERC-20, 16 x ERC-721) x 64 lanes = 2048
   lanes, default limits, 512 steps, -t 2, then the detection modules;
   wall time, lane-steps/s, contracts/s, host syncs, peak memory;
9. fork strategies, fork blocks, berlin, iprof, checkpoints at full
   width, against JAX reports pinned in ``tests/fixtures/torch_port/``:
   ``analyze`` of the arith fixture (MUL, EXP, MULMOD, ADDMOD) with each
   of the six strategies, bfs with ``--enable-iprof`` (the profile table
   too); the berlin gas schedule; the arith/ERC-20/ERC-721/multisig batch in fork
   blocks of 64 lanes with spill and in-loop migration; a checkpointed
   run resumed mid-transaction from its npz. K8/K9 must launch on the
   arith runs, K7 on every run, and K6 once per feasibility sweep;
8. profile (measurement only, after the counted runs): the engine's
   loop stages timed between synchronizations, and a torch.profiler
   window (16 supersteps of the batch) for the device's busy share and
   its top kernels.

Prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
P_MAIN = 2048  # 32 contracts x 64 lanes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 67e12    # non-tensor 32-bit rate used for integer work

# phase-6 batch: the campaign default of 32 contracts x 64 lanes
BATCH_CONTRACTS = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not available"
    except (OSError, subprocess.SubprocessError):
        return "not available"


# ---------------------------------------------------------------------------
# fixtures (tests/test_goldens.py's fixtures, built with this package's
# assembler; the other fixtures are read from tests/fixtures)
# ---------------------------------------------------------------------------


def golden_fixtures():
    from mythril_tpu_torch.disassembler.asm import assemble

    fx = {}

    def add(name, *tokens):
        fx[name] = assemble(*tokens)

    add("swc106_killable", 4, "CALLDATALOAD", "SELFDESTRUCT")
    add("swc106_guarded",
        "CALLER", ("push20", 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE),
        "EQ", ("ref", "ok"), "JUMPI", 0, 0, "REVERT",
        ("label", "ok"), "CALLER", "SELFDESTRUCT")
    add("swc127_arbitrary_jump", 0, "CALLDATALOAD", "JUMP", ("label", "x"), "STOP")
    add("swc127_static_jump", ("ref", "x"), "JUMP", ("label", "x"),
        ("push1", 1), ("push1", 0), "SSTORE", "STOP")
    add("swc115_origin_auth",
        "ORIGIN", ("push3", 0xC0FFEE), "EQ", ("ref", "a"), "JUMPI", 0, 0, "REVERT",
        ("label", "a"), 1, 0, "SSTORE", "STOP")
    add("swc115_caller_auth",
        "CALLER", ("push3", 0xC0FFEE), "EQ", ("ref", "a"), "JUMPI", 0, 0, "REVERT",
        ("label", "a"), 1, 0, "SSTORE", "STOP")
    add("swc101_add_overflow", 0, "SLOAD", 4, "CALLDATALOAD", "ADD", 0, "SSTORE", "STOP")
    add("swc101_guarded_add",
        4, "CALLDATALOAD", ("push1", 100), "SWAP1", "GT", ("ref", "bad"), "JUMPI",
        0, "SLOAD", 4, "CALLDATALOAD", "ADD", 0, "SSTORE", "STOP",
        ("label", "bad"), 0, 0, "REVERT")
    add("swc110_assert_fail", 4, "CALLDATALOAD", ("ref", "ok"), "JUMPI",
        "INVALID", ("label", "ok"), 1, 0, "SSTORE", "STOP")
    add("swc110_dead_invalid", 0, ("ref", "bad"), "JUMPI",
        1, 0, "SSTORE", "STOP", ("label", "bad"), "INVALID")
    add("swc124_arbitrary_write", 36, "CALLDATALOAD", 4, "CALLDATALOAD", "SSTORE", "STOP")
    add("swc124_fixed_write", 36, "CALLDATALOAD", 5, "SSTORE", "STOP")
    add("swc111_origin_read", "ORIGIN", 0, "SSTORE", "STOP")
    add("clean_store", 4, "CALLDATALOAD", 1, "SSTORE", "STOP")
    add("swc105_drain",
        0, 0, 0, 0, 36, "CALLDATALOAD", 4, "CALLDATALOAD", ("push2", 0xFFFF), "CALL",
        "POP", "STOP")
    add("swc104_checked",
        0, 0, 0, 0, 0, 4, "CALLDATALOAD", ("push2", 0xFFFF), "CALL",
        ("ref", "ok"), "JUMPI", 0, 0, "REVERT", ("label", "ok"), "STOP")
    add("swc112_deleg_user",
        0, 0, 0, 0, 4, "CALLDATALOAD", ("push2", 0xFFFF), "DELEGATECALL", "POP", "STOP")
    add("swc116_timestamp",
        "TIMESTAMP", ("push4", 0x5F5E1000), "GT", ("ref", "w"), "JUMPI", "STOP",
        ("label", "w"), 0, 0, 0, 0, 1, "CALLER", ("push2", 0xFFFF), "CALL", "POP", "STOP")
    add("swc107_sstore_after_call",
        0, 0, 0, 0, 0, 4, "CALLDATALOAD", ("push2", 0xFFFF), "CALL",
        "POP", 1, 0, "SSTORE", "STOP")
    add("swc113_multi_send",
        0, 0, 0, 0, 1, 4, "CALLDATALOAD", ("push2", 0xFFFF), "CALL", "POP",
        0, 0, 0, 0, 1, 36, "CALLDATALOAD", ("push2", 0xFFFF), "CALL", "POP", "STOP")
    return fx


def issue_key(d):
    return {"contract": d["contract"], "swc-id": d["swc-id"], "address": d["address"],
            "title": d["title"], "severity": d["severity"]}


def sorted_keys(issues):
    return sorted((issue_key(d) for d in issues),
                  key=lambda d: (d["swc-id"], d["address"], d["title"]))


def fixture_path(*parts) -> str:
    return os.path.join(ROOT, "tests", "fixtures", *parts)


def read_hex(path: str) -> bytes:
    with open(path) as fh:
        return bytes.fromhex(fh.read().strip().removeprefix("0x"))


def realworld(name: str) -> bytes:
    return read_hex(fixture_path("realworld", f"{name}.bin-runtime"))


def load_json(*parts):
    with open(fixture_path(*parts)) as fh:
        return json.load(fh)


# the real-world batch and BASELINE config 4 (tests/realworld_fixture.py,
# tests/config4_fixture.py), in corpus order; test_torch_isolation holds
# them equal to tests/torch_port_fixtures.py's, whose reports are pinned
REALWORLD = [("Eip1167Proxy", "eip1167proxy"), ("Erc20Full", "erc20full"),
             ("Erc721", "erc721"), ("Multisig2of3", "multisig2of3")]
CONFIG4 = ["Caller", "Router", "Vault"]
COVERAGE_KEYS = ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
                 "lanes_errored", "instruction_coverage_pct")


STRATEGIES = ("bfs", "dfs", "naive-random", "weighted-random", "coverage", "beam")


def realworld_system():
    return [(n, realworld(f)) for n, f in REALWORLD]


def arith_code() -> bytes:
    return read_hex(fixture_path("torch_port", "arith.bin-runtime"))


def forkblock_system():
    """The fork-block batch: arith beside three of the real-world runtimes."""
    rw = dict(realworld_system())
    return [("Arith", arith_code())] + [(n, rw[n]) for n in
                                        ("Erc20Full", "Erc721", "Multisig2of3")]


def config4_system():
    return [(n, read_hex(fixture_path("config4", f"{n.lower()}.bin")),
             read_hex(fixture_path("config4", f"{n.lower()}.bin-runtime"))) for n in CONFIG4]


def by_contract(issues):
    return sorted((issue_key(d) for d in issues),
                  key=lambda d: (d["contract"], d["swc-id"], d["address"], d["title"]))


def check_report(what, issues, coverage, want):
    """Issues (any order) and the coverage keys against a pinned report."""
    if by_contract(issues) != by_contract(want["issues"]):
        fail(f"{what}: issues {by_contract(issues)} != {by_contract(want['issues'])}")
    for k in COVERAGE_KEYS:
        if coverage[k] != want["coverage"][k]:
            fail(f"{what}: coverage {k} {coverage[k]} != {want['coverage'][k]}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(x, y) -> int:
    import torch

    if tuple(x.shape) != tuple(y.shape):
        return -1
    return int(torch.max(torch.abs(x.to(torch.int64) - y.to(torch.int64))).item()) \
        if x.numel() else 0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def longdiv_ops(x: int, m: int) -> int:
    """32-bit operations a schoolbook long division of x by m needs over
    32-bit limbs (Knuth's algorithm D): per quotient limb one estimate
    (~10 operations) and one multiply-subtract row over m's limbs (4 a
    limb). m = 0 needs none. This counts the function, not a kernel's
    own method (bit-serial steps, Barrett's reciprocal)."""
    if m == 0:
        return 0
    n = (m.bit_length() + 31) // 32
    q = max(0, (x.bit_length() + 31) // 32 - n + 1)
    return q * (4 * n + 10)


def square_multiply_steps(e: int) -> int:
    """Products of a left-to-right square-and-multiply for exponent e."""
    return max(0, e.bit_length() - 1 + bin(e).count("1") - 1)


def words_tensor(vals, dev):
    import torch
    from mythril_tpu_torch.ops import u256

    return torch.as_tensor(u256.from_ints(vals).astype(np.int64), device=dev)


def check_k1(dev, rng):
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    M = (1 << 256) - 1
    edge = [0, 1, 2, 1 << 255, M, M - 1, (1 << 255) - 1, (1 << 128) + 7]
    rand = [int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
            for _ in range(2 * P_MAIN)]
    a_vals = edge + rand[:P_MAIN - len(edge)]
    b_vals = [0, 0, 3, M, M, 1, (1 << 255), 0] + rand[P_MAIN:2 * P_MAIN - 8]
    # SDIV overflow: -2^255 / -1
    a_vals[-1], b_vals[-1] = 1 << 255, M
    a, b = words_tensor(a_vals, dev), words_tensor(b_vals, dev)
    q, r = kernels.divmod_u256(a, b)
    qp, rp = u256.divmod_u_plain(a, b)
    err = max(max_abs_err(q, qp), max_abs_err(r, rp))
    # the signed wrapper routes through the kernel on the card; its plain
    # counterpart strips and restores signs around the plain division
    sd = u256.sdiv(a, b)
    aa, na = u256.abs_signed(a)
    ab, nb = u256.abs_signed(b)
    qa, _ = u256.divmod_u_plain(aa, ab)
    sdp = torch.where(u256.is_zero(b)[:, None], 0,
                      torch.where((na != nb)[:, None], u256.neg(qa), qa))
    err = max(err, max_abs_err(sd, sdp))
    # python ints as the final word on a sample
    for i in list(range(8)) + [P_MAIN - 1]:
        x, y = a_vals[i], b_vals[i]
        want = (x // y, x % y) if y else (0, 0)
        got = (u256.to_int(q[i].cpu().numpy()), u256.to_int(r[i].cpu().numpy()))
        if got != want:
            fail(f"K1 lane {i}: {got} != {want}")
    ms = time_ms(lambda: kernels.divmod_u256(a, b), 50)
    plain_ms = time_ms(lambda: u256.divmod_u_plain(a, b), 2)
    nbytes = 4 * P_MAIN * 8 * 8  # a, b in; q, r out (int64 carriers)
    ops = sum(longdiv_ops(x, y) for x, y in zip(a_vals, b_vals))
    return dict(name="divmod_u256", source="mythril_tpu_torch/kernels/csrc/u256_divmod.cu",
                replaces="mythril_tpu/ops/u256.py:310", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


def check_k2(dev, rng):
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import keccak

    L = 200
    data = rng.integers(0, 256, (P_MAIN, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, P_MAIN).astype(np.int32)
    lens[:8] = [0, 1, 135, 136, 200, 64, 32, 137]
    for i, n in enumerate(lens):
        data[i, n:] = 0
    d = torch.as_tensor(data, device=dev)
    n = torch.as_tensor(lens, device=dev)
    out = kernels.keccak256(d, n)
    plain = keccak.keccak256_plain(d, n)
    err = max_abs_err(out, plain)
    from mythril_tpu_torch.ops import u256

    for i in range(8):
        want = keccak.keccak256_host_int(bytes(data[i, :lens[i]]))
        if u256.to_int(out[i].cpu().numpy()) != want:
            fail(f"K2 lane {i} (len {lens[i]}) disagrees with the host keccak")
    ms = time_ms(lambda: kernels.keccak256(d, n), 50)
    plain_ms = time_ms(lambda: keccak.keccak256_plain(d, n), 3)
    blocks = int(np.sum(lens // 136 + 1))
    nbytes = P_MAIN * L + P_MAIN * 4 + P_MAIN * 8 * 8
    ops = blocks * 24 * 200 * 2  # ~200 64-bit ops per round, 2 x 32-bit each
    return dict(name="keccak256", source="mythril_tpu_torch/kernels/csrc/keccak256.cu",
                replaces="mythril_tpu/ops/keccak.py:140", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


def check_k3(dev, rng):
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import append_node_plain
    from mythril_tpu_torch.symbolic.state import tape_row_hash, hash_bits

    T = DEFAULT_LIMITS.tape_len
    P = P_MAIN
    op = rng.integers(1, 29, (P, T)).astype(np.int32)
    a = rng.integers(0, 64, (P, T)).astype(np.int32)
    b = rng.integers(0, 64, (P, T)).astype(np.int32)
    imm = np.zeros((P, T, 8), dtype=np.int64)
    imm[:, :, 0] = rng.integers(0, 4, (P, T))
    tlen = rng.integers(14, T + 1, P).astype(np.int32)
    tlen[:4] = T  # full tapes: overflow unless the row is already there
    t_op, t_a, t_b, t_imm = (torch.as_tensor(x, device=dev) for x in (op, a, b, imm))
    t_hash = hash_bits(tape_row_hash(t_op, t_a, t_b, t_imm))
    # new rows: half copy an existing live row (dedup hits), half are fresh
    pick = rng.integers(0, 14, P)
    q_op = op[np.arange(P), pick].copy()
    q_a = a[np.arange(P), pick].copy()
    q_b = b[np.arange(P), pick].copy()
    q_imm = imm[np.arange(P), pick].copy()
    fresh = rng.random(P) < 0.5
    q_op[fresh] = 29
    q_a[fresh] = rng.integers(0, 1 << 20, int(fresh.sum()))
    # hash collisions: a live row carries the new row's fingerprint but
    # other content -> the first match fails verification (missed dedup)
    hq = hash_bits(tape_row_hash(torch.as_tensor(q_op), torch.as_tensor(q_a),
                                 torch.as_tensor(q_b), torch.as_tensor(q_imm)))
    coll = np.arange(8, 24)
    t_hash[coll, 2] = hq[coll].to(dev)
    mask = rng.random(P) < 0.8
    mask[:8] = True
    inputs = [torch.as_tensor(x, device=dev) for x in (q_op, q_a, q_b, q_imm, mask)]
    base = [t_op, t_a, t_b, t_imm, t_hash, torch.as_tensor(tlen, device=dev)]

    def fresh_tape():
        return [x.clone() for x in base]

    tk, tp = fresh_tape(), fresh_tape()
    ids_k, ovf_k = kernels.tape_append(*tk, *inputs)
    ids_p, ovf_p = append_node_plain(*tp, *inputs)
    err = max(max_abs_err(ids_k, ids_p), max_abs_err(ovf_k, ovf_p),
              *(max_abs_err(x, y) for x, y in zip(tk, tp)))
    if not bool(ovf_k.any()) or not bool((ids_k[~inputs[4]] == 0).all()):
        fail("K3 edge cases (overflow, masked lanes) did not show")
    # timed on one tape: after the first launch every masked row is present,
    # so the timed launches are dedup hits (or overflows) — the bound below
    # counts the scan those steady-state launches need
    ids_s, _ = append_node_plain(*tp, *inputs)
    tk = fresh_tape()
    ms = time_ms(lambda: kernels.tape_append(*tk, *inputs), 50)
    tp = fresh_tape()
    plain_ms = time_ms(lambda: append_node_plain(*tp, *inputs), 10)
    # bytes: the fingerprints the scan reads up to the first match (or the
    # whole live tape), the verified row, the inputs and outputs
    tl_s = tp[5]
    hit_rows = torch.where(ids_s > 0, ids_s + 1, tl_s)
    scanned = int(torch.where(inputs[4], hit_rows, 0).sum().item()) * 4
    nbytes = scanned + P * (3 * 4 + 64 + 4) * 2 + P * (3 * 4 + 64 + 1 + 4 + 1)
    return dict(name="tape_append", source="mythril_tpu_torch/kernels/csrc/tape_append.cu",
                replaces="mythril_tpu/symbolic/engine.py:84", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=0)


def check_k4(dev, rng):
    import hashlib

    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import sha256, u256

    N = 448  # the precompile input window (PRE_IN_CAP)
    data = rng.integers(0, 256, (P_MAIN, N), dtype=np.uint8)
    lens = rng.integers(0, N + 1, P_MAIN).astype(np.int32)
    edge = [0, 1, 55, 56, 63, 64, 119, 120, 448]
    lens[:len(edge)] = edge
    for i, n in enumerate(lens):
        data[i, n:] = 0
    import torch

    d = torch.as_tensor(data, device=dev)
    n = torch.as_tensor(lens, device=dev)
    out = kernels.sha256(d, n)
    plain = sha256.sha256_plain(d, n)
    err = max_abs_err(out, plain)
    got = out.cpu().numpy()
    for i in range(P_MAIN):
        want = int.from_bytes(hashlib.sha256(bytes(data[i, :lens[i]])).digest(), "big")
        if u256.to_int(got[i]) != want:
            fail(f"K4 lane {i} (len {lens[i]}) disagrees with hashlib")
    ms = time_ms(lambda: kernels.sha256(d, n), 50)
    plain_ms = time_ms(lambda: sha256.sha256_plain(d, n), 2)
    blocks = int(np.sum((lens.astype(np.int64) + 9 + 63) // 64))
    # each lane's own message bytes and its length in, its digest out
    # (int64 carriers)
    nbytes = int(np.sum(lens)) + P_MAIN * 4 + P_MAIN * 8 * 8
    ops = blocks * 2400  # ~2,400 32-bit operations per 64-byte block
    return dict(name="sha256", source="mythril_tpu_torch/kernels/csrc/sha256.cu",
                replaces="mythril_tpu/ops/sha256.py:46", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


MODEXP_LANES = 64


def modexp_cases(rng):
    """(base, e, m) for K5: edge cases, then seeded random operands."""
    M = (1 << 256) - 1
    cases = [(3, 5, 0), (3, 0, 1), (0, 0, 1), (5, 0, 7), (0, 5, 7), (M, M, M),
             (M, M, M - 1), (2, M, 1 << 255), (2, M, (1 << 255) + 1), (12345, M, 1),
             (M, 2, 3), ((1 << 255) + 1, 3, (1 << 255) - 19), (2, 10, 1 << 200),
             (9, M, 1 << 100)]
    while len(cases) < MODEXP_LANES:
        b, e, m = (int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
                   for _ in range(3))
        cases.append((b, e, m))
    return cases


def modexp_ops(cases) -> int:
    """32-bit operations base^e mod m needs for these operands: base mod
    m, then per square-and-multiply step a product of two residues of m's
    n limbs (n^2 multiply-adds, 4 operations each) and its remainder, a
    long division with n + 1 quotient limbs."""
    ops = 0
    for b, e, m in cases:
        if m:
            n = (m.bit_length() + 31) // 32
            ops += longdiv_ops(b, m) + square_multiply_steps(e) * (
                4 * n * n + (n + 1) * (4 * n + 10))
    return ops


def check_k5(dev, rng):
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    cases = modexp_cases(rng)
    b, e, m = (words_tensor([c[i] for c in cases], dev) for i in range(3))
    out = kernels.modexp_u256(b, e, m)
    plain = u256.modexp_plain(b, e, m)
    err = max_abs_err(out, plain)
    got = out.cpu().numpy()
    for i, (x, y, z) in enumerate(cases):
        if u256.to_int(got[i]) != (pow(x, y, z) if z else 0):
            fail(f"K5 lane {i} disagrees with pow")
    ms = time_ms(lambda: kernels.modexp_u256(b, e, m), 10)
    plain_ms = time_ms(lambda: u256.modexp_plain(b, e, m), 1)
    nbytes = 4 * MODEXP_LANES * 8 * 8
    return dict(name="modexp_u256", source="mythril_tpu_torch/kernels/csrc/u256_modexp.cu",
                replaces="mythril_tpu/ops/u256.py:408", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=modexp_ops(cases))


def product_words(rng):
    """(a, b, m, e) python ints for K8/K9 at P = 2048: edge words first
    (m in {0, 1, 2^256 - 1}, e in {0, 1, 2^255, 2^256 - 1}), then seeded
    random words of random widths."""
    M = (1 << 256) - 1
    edge_ab = [0, 1, 2, M, M - 1, 1 << 255, (1 << 128) - 1, 10]
    edge_m = [0, 1, M, 0, 1, M, 7, (1 << 255) + 19]
    edge_e = [0, 1, 1 << 255, M, 0, 1, 1 << 255, M]

    def rand(n):
        return [int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
                for _ in range(n)]

    n = P_MAIN - len(edge_ab)
    return (edge_ab + rand(n), edge_ab[::-1] + rand(n), edge_m + rand(n), edge_e + rand(n))


def check_k8(dev, rng):
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    a_v, b_v, _, _ = product_words(rng)
    a, b = words_tensor(a_v, dev), words_tensor(b_v, dev)
    lo = kernels.mul_u256(a, b, "low")
    wide = kernels.mul_u256(a, b, "wide")
    err = max(max_abs_err(lo, u256.mul_plain(a, b)), max_abs_err(wide, u256.mul_wide_plain(a, b)))
    M = (1 << 256) - 1
    got_lo = u256.to_ints(lo)
    got_wide = [x | (y << 256) for x, y in zip(u256.to_ints(wide[:, :8]),
                                               u256.to_ints(wide[:, 8:]))]
    for i, (x, y) in enumerate(zip(a_v, b_v)):
        if got_lo[i] != (x * y) & M or got_wide[i] != x * y:
            fail(f"K8 lane {i} disagrees with Python ints")
    ms = time_ms(lambda: kernels.mul_u256(a, b, "low"), 50)
    plain_ms = time_ms(lambda: u256.mul_plain(a, b), 10)
    print(f"[3] mul_u256 wide: {time_ms(lambda: kernels.mul_u256(a, b, 'wide'), 50):.4f} ms",
          flush=True)
    # a, b in and the low product out (int64 carriers); 64 multiply-adds
    # of 4 operations per lane
    return dict(name="mul_u256", source="mythril_tpu_torch/kernels/csrc/u256_mul.cu",
                replaces="mythril_tpu/ops/u256.py:261", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=P_MAIN * 3 * 64, ops=P_MAIN * 64 * 4)


def check_k9(dev, rng):
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    a_v, b_v, m_v, e_v = product_words(rng)
    a, b, m, e = (words_tensor(v, dev) for v in (a_v, b_v, m_v, e_v))
    wide = u256.mul_wide_plain(a, b)
    r = kernels.mod_wide_u256(wide, m)
    err_mod = max_abs_err(r, u256._mod_wide_plain(wide, m))
    x = kernels.exp_u256(a, e)
    err_exp = max_abs_err(x, u256.exp_plain(a, e))
    got_r, got_x = u256.to_ints(r), u256.to_ints(x)
    for i in range(P_MAIN):
        if got_r[i] != ((a_v[i] * b_v[i]) % m_v[i] if m_v[i] else 0):
            fail(f"K9 mod_wide lane {i} disagrees with Python ints")
        if i < 64 and got_x[i] != pow(a_v[i], e_v[i], 1 << 256):
            fail(f"K9 exp lane {i} disagrees with Python ints")
    # ADDMOD's 9-limb sums through the same entry point
    s, c = u256.add_carry(a, b)
    wide_add = torch.cat([s, c.to(s.dtype)[:, None]], dim=1)
    err_mod = max(err_mod, max_abs_err(u256._mod_wide(wide_add, m),
                                       u256._mod_wide_plain(wide_add, m)))
    ms_mod = time_ms(lambda: kernels.mod_wide_u256(wide, m), 20)
    plain_mod = time_ms(lambda: u256._mod_wide_plain(wide, m), 1)
    ms_exp = time_ms(lambda: kernels.exp_u256(a, e), 20)
    plain_exp = time_ms(lambda: u256.exp_plain(a, e), 1)
    # the remainder of each lane's 512-bit product by its m; EXP's low
    # products (36 multiply-adds of 4 operations each)
    mod_ops = sum(longdiv_ops(x * y, z) for x, y, z in zip(a_v, b_v, m_v))
    exp_ops = sum(square_multiply_steps(v) for v in e_v) * 36 * 4
    src = "mythril_tpu_torch/kernels/csrc/u256_mulmod_exp.cu"
    return [dict(name="mod_wide_u256", source=src, replaces="mythril_tpu/ops/u256.py:372",
                 max_abs_err=err_mod, ms=ms_mod, plain_ms=plain_mod,
                 nbytes=P_MAIN * (128 + 64 + 64), ops=mod_ops),
            dict(name="exp_u256", source=src, replaces="mythril_tpu/ops/u256.py:436",
                 max_abs_err=err_exp, ms=ms_exp, plain_ms=plain_exp,
                 nbytes=P_MAIN * 3 * 64, ops=exp_ops)]


def sweep_snapshot(dev):
    """A real frontier just before a sweep: the 32-contract batch (16 x
    ERC-20, 16 x arith) after 20 supersteps with no sweep, at the default
    limits (P = 2048, T = 512, 128 constraint slots)."""
    import torch
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.core import Corpus, make_env
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.symbolic import SymSpec, make_sym_frontier, sym_run

    codes = [realworld("erc20full"), read_hex(fixture_path("torch_port", "arith.bin-runtime"))]
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, DEFAULT_LIMITS.max_code)
                                 for c in codes], dev)
    cid = np.repeat(np.arange(P_MAIN // 64, dtype=np.int32) % 2, 64)
    active = np.zeros(P_MAIN, dtype=bool)
    active[::64] = True
    sf = make_sym_frontier(P_MAIN, DEFAULT_LIMITS, contract_id=cid, active=active,
                           n_contracts=2, device=dev)
    sf = sym_run(sf, make_env(P_MAIN, device=dev), corpus, SymSpec(), DEFAULT_LIMITS,
                 max_steps=20, propagate_every=0)
    torch.cuda.synchronize()
    return sf


def random_tapes(dev, rng):
    """Random tapes holding every op at P = 2048, T = 512 (random starting
    domains, prop_len and constraints), as a SymFrontier on the card."""
    import torch
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic import make_sym_frontier

    L = DEFAULT_LIMITS
    P, T, C = P_MAIN, L.tape_len, L.max_constraints
    op = rng.integers(0, 29, (P, T)).astype(np.int32)
    op[rng.random((P, T)) < 0.3] = 1  # CONST
    span = (np.arange(T) + 3)[None, :]
    a = (rng.random((P, T)) * span).astype(np.int32) - 1
    b = (rng.random((P, T)) * span).astype(np.int32) - 1
    free = op == 2
    a[free] = rng.integers(0, 18, int(free.sum()))

    def words(shape):
        w = rng.integers(0, 1 << 32, shape + (8,), dtype=np.int64)
        kind = rng.integers(0, 5, shape)
        w[kind == 0] = 0
        w[kind == 1, 1:] = 0
        w[kind == 1, 0] = rng.integers(0, 300, shape)[kind == 1]
        w[kind == 2, 2:] = 0
        w[kind == 3] = 0xFFFFFFFF
        return w

    km = words((P, T))
    tlen = rng.integers(1, T + 1, P).astype(np.int32)
    t = lambda x: torch.as_tensor(x, device=dev)
    sf = make_sym_frontier(P, L, device=dev)
    return sf.replace(
        tape_op=t(op), tape_a=t(a), tape_b=t(b), tape_imm=t(words((P, T))), tape_len=t(tlen),
        prop_len=t(np.minimum(rng.integers(0, T, P), tlen).astype(np.int32)),
        iv_lo=t(words((P, T))), iv_hi=t(words((P, T))), kb_m=t(km),
        kb_v=t(words((P, T)) & km), con_len=t(rng.integers(0, 6, P).astype(np.int32)),
        con_node=t(rng.integers(-1, T + 2, (P, C)).astype(np.int32)),
        con_sign=t(rng.random((P, C)) < 0.5))


# domains each transfer reads of its first and its second operand, by
# SymOp code (bits: 1 iv_lo, 2 iv_hi, 4 kb_m, 8 kb_v; symbolic/propagate.py
# _node_domains); CONST, FREE, BYTE, the signed compares and the ops with
# no transfer read none
LO, HI, KM, KV = 1, 2, 4, 8
SWEEP_READS = {3: (LO | HI, LO | HI), 4: (LO | HI, LO | HI), 5: (LO | HI, LO | HI),
               6: (HI, 0), 8: (HI, HI), 12: (LO | HI, LO | HI), 13: (LO | HI, LO | HI),
               16: (15, 15), 17: (15, 0), 18: (HI | KM | KV, HI | KM | KV),
               19: (LO | KM | KV, LO | KM | KV), 20: (KM | KV, KM | KV), 21: (15, 0),
               23: (LO | HI, 15), 24: (LO | HI, 15)}
# 32-bit operations of each transfer: limb adds, subtractions and
# compares ~3 a limb, products 4 a multiply-add, shifts ~4 a limb
SWEEP_OPS = {2: 8, 3: 56, 4: 64, 5: 408, 8: 48, 12: 32, 13: 32, 16: 96, 17: 48, 18: 72,
             19: 64, 20: 32, 21: 32, 23: 192, 24: 192}


def sweep_work(sf, pl0, done):
    """(bytes, 32-bit operations) the sweep needs on these inputs: per new
    node its op, the operand ids and imm its op uses, the operand domains
    its transfer reads that no earlier node of the walk wrote (each read
    once), and its four domains written; per lane its lengths and flag;
    the constraints up to the first contradicted one (as ``done``, the
    swept domains, says) with the domains of old nodes they test."""
    P, T = sf.tape_op.shape
    op, a, b = (x.cpu().numpy() for x in (sf.tape_op, sf.tape_a, sf.tape_b))
    tlen, start = sf.tape_len.cpu().numpy(), np.maximum(pl0.cpu().numpy(), 1)
    idx = np.arange(T)[None, :]
    new = (idx >= start[:, None]) & (idx < tlen[:, None])
    live = new & (op != 0)
    ra, rb, cost = (np.zeros(32, np.int64) for _ in range(3))
    for code, (x, y) in SWEEP_READS.items():
        ra[code], rb[code] = x, y
    for code, n in SWEEP_OPS.items():
        cost[code] = n
    na, nb = np.where(live, ra[op], 0), np.where(live, rb[op], 0)
    nbytes = 4 * int(new.sum()) + 64 * int((live & (op == 1)).sum()) + 256 * int(live.sum())
    nbytes += 4 * int(((na != 0) | (live & (op == 2))).sum()) + 4 * int((nb != 0).sum())
    rows = np.broadcast_to(np.arange(P)[:, None], (P, T))
    need = np.zeros((P, T), np.int64)
    for ids, nd in ((a, na), (b, nb)):
        ci = np.clip(ids, 0, T - 1)
        walked = live[rows, ci] & (ci < idx)
        np.bitwise_or.at(need, (rows, ci), np.where(walked, 0, nd))
    C = sf.con_node.shape[1]
    cn, cs = sf.con_node.cpu().numpy(), sf.con_sign.cpu().numpy()
    node = np.clip(cn, 0, T - 1)
    crow = np.broadcast_to(np.arange(P)[:, None], (P, C))
    lo, hi, km, kv = (x.cpu().numpy()[crow, node]
                      for x in (done.iv_lo, done.iv_hi, done.kb_m, done.kb_v))
    cant_nz = (hi == 0).all(-1) | ((km == 0xFFFFFFFF).all(-1) & (kv == 0).all(-1))
    cant_z = ~(lo == 0).all(-1) | ((kv & km) != 0).any(-1)
    con_live = np.arange(C)[None, :] < sf.con_len.cpu().numpy()[:, None]
    dead = con_live & (cn != 0) & np.where(cs, cant_nz, cant_z)
    seen = con_live & (np.cumsum(dead, axis=1) - dead == 0)
    tested = seen & (cn != 0)
    old = tested & ~live[crow, node]
    np.bitwise_or.at(need, (crow[old], node[old]), np.where(cs, HI | KM | KV, LO | KM | KV)[old])
    bits = np.array([bin(i).count("1") for i in range(16)])
    nbytes += 5 * int(seen.sum()) + 64 * int(bits[need].sum()) + 17 * P
    ops = int(cost[op][live].sum()) + 40 * int(tested.sum())
    return nbytes, ops


def _sweep_args(sf):
    return [sf.tape_op, sf.tape_a, sf.tape_b, sf.tape_imm, sf.tape_len, sf.prop_len.clone(),
            sf.iv_lo.clone(), sf.iv_hi.clone(), sf.kb_m.clone(), sf.kb_v.clone(),
            sf.con_node, sf.con_sign, sf.con_len]


def check_k6(dev, rng):
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.symbolic.propagate import propagate_feasibility_plain

    err = 0
    for what, sf in (("random tapes", random_tapes(dev, rng)),
                     ("batch snapshot", sweep_snapshot(dev))):
        args = _sweep_args(sf)
        inf = kernels.propagate_sweep(*args)
        want, inf_p = propagate_feasibility_plain(sf)
        e = max(max_abs_err(inf, inf_p), max_abs_err(args[5], want.prop_len),
                *(max_abs_err(x, getattr(want, k)) for x, k in
                  zip(args[6:10], ("iv_lo", "iv_hi", "kb_m", "kb_v"))))
        new = int(torch.clamp(sf.tape_len - torch.clamp(sf.prop_len, min=1), min=0).sum())
        print(f"[3] propagate_sweep {what}: max_abs_err {e}, {new} new nodes, "
              f"{int(inf.sum())} infeasible lanes", flush=True)
        err = max(err, e)
    # timed on random tapes (every lane walks its new nodes each launch)
    sf_r = random_tapes(dev, rng)
    args = _sweep_args(sf_r)
    pl0 = sf_r.prop_len.clone()

    def launch():
        args[5].copy_(pl0)
        kernels.propagate_sweep(*args)

    ms = time_ms(launch, 10)
    # the plain sweep takes seconds here: one timed call, no warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    done, _ = propagate_feasibility_plain(sf_r)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    nbytes, ops = sweep_work(sf_r, pl0, done)
    return dict(name="propagate_sweep", source="mythril_tpu_torch/kernels/csrc/propagate_sweep.cu",
                replaces="mythril_tpu/symbolic/propagate.py:57", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


def fork_inputs(dev, rng, n_con, n_stack, max_code):
    import torch

    P = P_MAIN
    t = lambda x: torch.as_tensor(x, device=dev)
    return [t(rng.random(P) < 0.6), t(rng.random(P) < 0.7),
            t(rng.integers(1, n_con + 1, P).astype(np.int32)),
            t(rng.integers(-2, 3000, P).astype(np.int32)),
            t(rng.integers(0, 32, P).astype(np.int32)),
            t(rng.integers(1, 3000, P).astype(np.int32)),
            t(rng.integers(2, n_stack - 2, P).astype(np.int32)),
            t(rng.integers(0, 3, P).astype(np.int32)),
            t(np.where(rng.random(P) < 0.3, rng.integers(-1, n_stack + 2, P), -1)
              .astype(np.int32)),
            t(rng.integers(0, 4, P).astype(np.int32)),
            t(rng.random((32, max_code)) < 0.5)]


def check_k7(dev, rng):
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import fork_plan_plain

    L = DEFAULT_LIMITS
    args = fork_inputs(dev, rng, L.max_constraints, L.max_stack, 4096)
    err = 0
    times = {}
    for policy in kernels.FORK_POLICIES:
        for block in (64, P_MAIN):
            for defer in (False, True):
                kw = dict(block=block, policy=policy, n_con=L.max_constraints,
                          n_stack=L.max_stack, defer=defer)
                oi, ob = kernels.fork_plan(*args, **kw)
                pi, pb = fork_plan_plain(*args, **kw)
                err = max(err, max_abs_err(oi, pi), max_abs_err(ob, pb))
            times[policy, block] = time_ms(lambda: kernels.fork_plan(*args, **kw), 20)
    print("[3] fork_plan ms (policy, block): " + ", ".join(
        f"{p}/{b} {t:.4f}" for (p, b), t in times.items()), flush=True)
    kw = dict(block=P_MAIN, policy="weighted", n_con=L.max_constraints, n_stack=L.max_stack,
              defer=True)
    plain_ms = time_ms(lambda: fork_plan_plain(*args, **kw), 5)
    # bytes: per lane 2 flags and 8 int32 in, 9 int32 and 4 flags out;
    # operations: the bitonic network's compare-exchanges (~4 each)
    lg = P_MAIN.bit_length() - 1
    ops = (P_MAIN // 2) * lg * (lg + 1) // 2 * 4
    return dict(name="fork_plan", source="mythril_tpu_torch/kernels/csrc/fork_plan.cu",
                replaces="mythril_tpu/symbolic/engine.py:2502", max_abs_err=err,
                ms=times["weighted", P_MAIN], plain_ms=plain_ms,
                nbytes=P_MAIN * (2 + 8 * 4 + 9 * 4 + 4), ops=ops)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[1] device {kind} x{count}; nvidia-smi: {card}", flush=True)
    t_start = time.monotonic()

    from mythril_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    # phase 2: build
    secs = kernels.build(verbose="--verbose" in sys.argv)
    print(f"[2] kernels built in {secs:.1f} s", flush=True)

    # phase 3: kernels against their plain versions
    rng = np.random.default_rng(20261017)
    results = [check_k1(dev, rng), check_k2(dev, rng), check_k3(dev, rng),
               check_k4(dev, rng), check_k5(dev, rng), check_k6(dev, rng),
               check_k7(dev, rng), check_k8(dev, rng), *check_k9(dev, rng)]
    for r in results:
        if r["max_abs_err"] != 0:
            fail(f"{r['name']}: kernel disagrees with its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
        print(f"[3] {r['name']}: bit-exact; {r['ms']:.4f} ms kernel, "
              f"{r['plain_ms']:.3f} ms plain", flush=True)
    if "--kernels" in sys.argv:
        launches = {}
    else:
        launches = run_paths(dev)
    line = []
    for r in results:
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / INT32_OPS_PER_S * 1e3
        line.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches.get(r["name"], 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    print(f"[*] total {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def counted(run):
    """Drive one path with every launch count zeroed just before it;
    -> (its result, the counts read just after it)."""
    import torch
    from mythril_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def cli_json(argv):
    """``analyze ... -o json`` on the card -> (report, stderr, stats)."""
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.interfaces.cli import main as cli_main
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    syncs0 = ci.HOST_SYNCS["count"]
    steps0, sweeps0 = ENGINE_STATS["supersteps"], ENGINE_STATS["sweeps"]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(["analyze", *argv, "-o", "json"])
    if rc != 0:
        fail(f"analyze {argv}: rc {rc}\n{err.getvalue()[-2000:]}")
    n_steps = ENGINE_STATS["supersteps"] - steps0
    n_syncs = ci.HOST_SYNCS["count"] - syncs0
    stats = {"wall_s": time.monotonic() - t0, "supersteps": n_steps, "host_syncs": n_syncs,
             "host_syncs_per_superstep": n_syncs / max(1, n_steps),
             "sweeps": ENGINE_STATS["sweeps"] - sweeps0}
    return json.loads(out.getvalue()), err.getvalue(), stats


def run_cli(name: str, argv, pin=None, phase="5"):
    """``analyze ... -o json`` at the CLI defaults on the card, held to
    the pinned JAX report ``tests/fixtures/torch_port/<pin>`` (default
    ``<name>_default.json``). Returns (stderr, stats)."""
    got, err, stats = cli_json(argv)
    check_report(f"analyze {name}", got["issues"], got["coverage"],
                 load_json("torch_port", pin or f"{name}_default.json"))
    print(f"[{phase}] analyze {name}: {len(got['issues'])} issue(s), report equal; "
          f"{stats['wall_s']:.2f} s wall, {stats['supersteps']} supersteps, "
          f"{stats['host_syncs']} host syncs ({stats['host_syncs_per_superstep']:.2f} per "
          f"superstep), {stats['sweeps']} sweeps", flush=True)
    return err, stats


def run_paths(dev) -> dict:
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import DEFAULT_LIMITS, TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS, FRAME_STATS

    # phase 4: goldens on the card
    t0 = time.monotonic()
    fixtures = golden_fixtures()
    for name, code in sorted(fixtures.items()):
        sym = SymExecWrapper([code], limits=TEST_LIMITS, lanes_per_contract=16,
                             max_steps=192, device=dev)
        got = sorted_keys(i.as_dict() for i in fire_lasers(sym.ctx).issues)
        want = load_json("goldens", f"{name}.json")
        if got != want:
            fail(f"golden {name}: {got} != {want}")
    system = realworld_system()
    sym = SymExecWrapper([c for _, c in system], contract_names=[n for n, _ in system],
                         limits=dataclasses.replace(TEST_LIMITS, max_accounts=8, call_depth=3,
                                                    max_code=1024),
                         lanes_per_contract=16, max_steps=192, transaction_count=2, device=dev)
    report = fire_lasers(sym)
    want = load_json("goldens", "realworld.json")
    got = {"issues": by_contract(i.as_dict() for i in report.issues),
           "coverage": {k: report.coverage.get(k) for k in want["coverage"]}}
    if got != want:
        fail(f"golden realworld: {got} != {want}")
    system = config4_system()
    sym = SymExecWrapper([r for _, _, r in system], contract_names=[n for n, _, _ in system],
                         creation_bytecodes=[c for _, c, _ in system],
                         limits=dataclasses.replace(TEST_LIMITS, call_depth=4, max_accounts=6),
                         lanes_per_contract=16, max_steps=192, transaction_count=2, device=dev)
    got = by_contract(i.as_dict() for i in fire_lasers(sym).issues)
    if got != load_json("goldens", "config4.json"):
        fail(f"golden config4: {got}")
    print(f"[4] {len(fixtures)} goldens, realworld and config4 equal on the card "
          f"({time.monotonic() - t0:.1f} s)", flush=True)

    # phase 5: the main path, analyze at the CLI defaults; (a) is the
    # first slice's path, (b) this slice's (CALL, creation, precompiles).
    # Each run has its own counts, zeroed just before it and read just after
    creation, runtime = (fixture_path("torch_port", f"precompiles.{x}")
                         for x in ("bin", "bin-runtime"))
    parts = {
        "a": [("erc20full", ["-f", fixture_path("realworld", "erc20full.bin-runtime")]),
              ("erc721", ["-f", fixture_path("realworld", "erc721.bin-runtime")])],
        "b": [("multisig2of3", ["-f", fixture_path("realworld", "multisig2of3.bin-runtime"),
                                "-t", "2"]),
              ("precompiles", ["-f", runtime, "--creation-code", creation])],
    }
    need = {"a": ("divmod_u256", "keccak256", "tape_append"),
            "b": ("sha256", "modexp_u256", "tape_append")}
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for part, runs in parts.items():
        part_counts = dict.fromkeys(kernels.KERNELS, 0)
        for name, argv in runs:
            _, counts = counted(lambda: run_cli(name, argv))
            print(f"[5{part}] {name} launches {counts}", flush=True)
            if name == "precompiles":
                for k in ("sha256", "modexp_u256"):
                    if counts[k] <= 0:
                        fail(f"analyze precompiles: kernel {k} was not launched")
            for k, n in counts.items():
                part_counts[k] += n
                launches[k] += n
        for k in need[part]:
            if part_counts[k] <= 0:
                fail(f"kernel {k} was not launched on the main path ({part})")

    # phase 6: frames at full width (creation tx + call depth 3; the
    # 4-contract real-world batch)
    kw = dict(limits=DEFAULT_LIMITS, lanes_per_contract=64, max_steps=512,
              transaction_count=2, device=dev)
    runs6 = {
        "config4": lambda: SymExecWrapper(
            [r for _, _, r in config4_system()], contract_names=CONFIG4,
            creation_bytecodes=[c for _, c, _ in config4_system()], **kw),
        "realworld4": lambda: SymExecWrapper(
            [c for _, c in realworld_system()], contract_names=[n for n, _ in REALWORLD], **kw),
    }
    for name, build in runs6.items():
        FRAME_STATS.update(pushed=0, popped=0)
        syncs0 = ci.HOST_SYNCS["count"]
        steps0 = ENGINE_STATS["supersteps"]
        t0 = time.monotonic()
        sym, counts = counted(build)
        t_engine = time.monotonic() - t0
        report = fire_lasers(sym)
        wall = time.monotonic() - t0
        check_report(name, [i.as_dict() for i in report.issues], report.coverage,
                     load_json("torch_port", f"{name}_default.json"))
        n_steps = ENGINE_STATS["supersteps"] - steps0
        n_syncs = ci.HOST_SYNCS["count"] - syncs0
        stats = {"wall_s": wall, "engine_s": t_engine, "supersteps": n_steps,
                 "host_syncs": n_syncs, "host_syncs_per_superstep": n_syncs / max(1, n_steps),
                 "frames_pushed": int(FRAME_STATS["pushed"]),
                 "frames_popped": int(FRAME_STATS["popped"]), "issues": len(report.issues),
                 "launches": counts}
        print(f"[6] {name} equals the pinned JAX report; {json.dumps(stats)}", flush=True)
        # config4's caller -> router -> vault chain runs in real frames (the
        # real-world batch's calls have symbolic targets or windows and take
        # the enumeration and external paths, as in the JAX engine)
        if name == "config4" and stats["frames_pushed"] <= 0:
            fail(f"{name}: no sub-frame was pushed")
        if counts["tape_append"] <= 0:
            fail(f"{name}: kernel tape_append was not launched")
        for k, n in counts.items():
            launches[k] += n

    # phase 7: the campaign-width batch
    codes = [realworld("erc20full")] * BATCH_CONTRACTS + [realworld("erc721")] * BATCH_CONTRACTS
    names = [f"erc20full_{i}" for i in range(BATCH_CONTRACTS)] + \
        [f"erc721_{i}" for i in range(BATCH_CONTRACTS)]
    torch.cuda.reset_peak_memory_stats()
    syncs0 = ci.HOST_SYNCS["count"]
    steps0 = ENGINE_STATS["lane_steps"]
    supersteps0 = ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    sym, batch_launches = counted(lambda: SymExecWrapper(
        codes, contract_names=names, limits=DEFAULT_LIMITS, lanes_per_contract=64,
        max_steps=512, transaction_count=2, device=dev))
    t_engine = time.monotonic() - t0
    report = fire_lasers(sym)
    wall = time.monotonic() - t0
    lane_steps = ENGINE_STATS["lane_steps"] - steps0
    stats = {
        "lanes": int(sym.sf.n_lanes), "wall_s": wall, "engine_s": t_engine,
        "detect_s": wall - t_engine, "lane_steps": lane_steps,
        "lane_steps_per_s": lane_steps / t_engine,
        "supersteps": ENGINE_STATS["supersteps"] - supersteps0,
        "contracts_per_s": len(codes) / wall,
        "host_syncs": ci.HOST_SYNCS["count"] - syncs0,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "issues": len(report.issues), "launches": batch_launches,
        "surviving_paths": report.coverage.get("surviving_paths"),
    }
    print(f"[7] batch {json.dumps(stats)}", flush=True)
    for k in ("divmod_u256", "keccak256", "tape_append"):
        if batch_launches[k] <= 0:
            fail(f"kernel {k} was not launched in the batch")
    want20 = {(d["swc-id"], d["address"]) for d in json.load(open(os.path.join(
        ROOT, "tests", "fixtures", "torch_port", "erc20full_default.json")))["issues"]}
    got = {(i.swc_id, i.address) for i in report.issues if i.contract.startswith("erc20")}
    if got != want20:
        fail(f"batch: erc20 issues {got} != {want20}")
    for k, n in run_policies(dev).items():
        launches[k] += n
    profile_paths(dev, codes, names)
    return launches


def require_launches(what, counts, sweeps, kernels_needed):
    """Each named kernel launched, and K6 exactly once per sweep."""
    for k in kernels_needed:
        if counts[k] <= 0:
            fail(f"{what}: kernel {k} was not launched")
    if counts["propagate_sweep"] != sweeps:
        fail(f"{what}: {counts['propagate_sweep']} K6 launches for {sweeps} sweeps")
    print(f"[9] {what} launches K6 {counts['propagate_sweep']} (= sweeps), "
          f"K7 {counts['fork_plan']}, K8 {counts['mul_u256']}, "
          f"K9 {counts['mod_wide_u256']} mod_wide / {counts['exp_u256']} exp", flush=True)


ARITH_KERNELS = ("fork_plan", "mul_u256", "mod_wide_u256", "exp_u256", "tape_append")


def wrapper_run(what, build, pin, keys=COVERAGE_KEYS):
    """A ``SymExecWrapper`` run on the card held to a pinned JAX report;
    -> (counts, sweeps, stats)."""
    from mythril_tpu_torch.analysis import fire_lasers
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    syncs0 = ci.HOST_SYNCS["count"]
    steps0, sweeps0 = ENGINE_STATS["supersteps"], ENGINE_STATS["sweeps"]
    t0 = time.monotonic()
    sym, counts = counted(build)
    t_engine = time.monotonic() - t0
    report = fire_lasers(sym)
    want = load_json("torch_port", pin)
    if by_contract(i.as_dict() for i in report.issues) != by_contract(want["issues"]):
        fail(f"{what}: issues differ from {pin}")
    for k in keys:
        if report.coverage[k] != want["coverage"][k]:
            fail(f"{what}: coverage {k} {report.coverage[k]} != {want['coverage'][k]}")
    n_steps = ENGINE_STATS["supersteps"] - steps0
    n_syncs = ci.HOST_SYNCS["count"] - syncs0
    stats = {"wall_s": time.monotonic() - t0, "engine_s": t_engine, "supersteps": n_steps,
             "host_syncs": n_syncs, "host_syncs_per_superstep": n_syncs / max(1, n_steps),
             "issues": len(report.issues), "rebalanced": report.coverage.get("rebalanced_lanes")}
    print(f"[9] {what} equals {pin}; {json.dumps(stats)}", flush=True)
    return sym, counts, ENGINE_STATS["sweeps"] - sweeps0


def run_policies(dev) -> dict:
    """Phase 9: the fork strategies, fork blocks, berlin, the profiler and
    checkpoints at full width (64 lanes per contract, 512 steps, -t 2),
    each run's launch counts zeroed just before it and read just after."""
    import tempfile

    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import SymExecWrapper
    from mythril_tpu_torch.config import DEFAULT_LIMITS

    launches = dict.fromkeys(kernels.KERNELS, 0)

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    arith = fixture_path("torch_port", "arith.bin-runtime")
    for strategy in STRATEGIES:
        # the bfs run also keeps the instruction profile (its report is the
        # same with or without it)
        iprof = ["--enable-iprof"] if strategy == "bfs" else []
        (err, stats), counts = counted(lambda: run_cli(
            f"arith --strategy {strategy} {' '.join(iprof)}",
            ["-f", arith, "--strategy", strategy, *iprof], pin=f"arith_{strategy}.json",
            phase="9"))
        require_launches(f"arith {strategy}", counts, stats["sweeps"], ARITH_KERNELS)
        add(counts)
        if iprof:
            table = err[err.find("Instruction profile"):].strip()
            with open(fixture_path("torch_port", "arith_iprof.txt")) as fh:
                if table != fh.read().strip():
                    fail(f"iprof table differs from the JAX one:\n{table}")
            print(f"[9] iprof table equals the JAX table ({len(table.splitlines()) - 3} "
                  "opcodes)", flush=True)

    kw = dict(lanes_per_contract=64, max_steps=512, transaction_count=2, device=dev)
    berlin = dataclasses.replace(DEFAULT_LIMITS, gas_schedule="berlin")
    _, counts, sweeps = wrapper_run("arith berlin", lambda: SymExecWrapper(
        [arith_code()], contract_names=["MAIN"], limits=berlin, **kw), "arith_berlin.json")
    require_launches("arith berlin", counts, sweeps, ARITH_KERNELS)
    add(counts)
    system = forkblock_system()
    _, counts, sweeps = wrapper_run("fork-block batch", lambda: SymExecWrapper(
        [c for _, c in system], contract_names=[n for n, _ in system],
        limits=DEFAULT_LIMITS, fork_block=64, **kw), "forkblock4_default.json")
    require_launches("fork-block batch", counts, sweeps, ARITH_KERNELS + ("keccak256",))
    add(counts)

    # checkpoints: a one-transaction run saves at every 16-step seam; the
    # rotated copy (the second-to-last seam) resumes mid-transaction
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck_kw = dict(kw, transaction_count=1, deadline_chunk_steps=16)
    _, counts = counted(lambda: SymExecWrapper([arith_code()], contract_names=["MAIN"],
                                               limits=DEFAULT_LIMITS, checkpoint_dir=ck,
                                               **ck_kw))
    add(counts)
    mid = os.path.join(ck, "frontier.npz.1")
    if not os.path.exists(mid):
        fail("checkpointed run left no rotated checkpoint")
    _, counts, sweeps = wrapper_run(
        "arith resumed from its checkpoint", lambda: SymExecWrapper(
            [arith_code()], contract_names=["MAIN"], limits=DEFAULT_LIMITS, resume_from=mid,
            deadline_chunk_steps=16, **kw), "arith_bfs.json",
        keys=("lanes", "surviving_paths", "dropped_forks", "killed_infeasible", "lanes_errored"))
    require_launches("arith resumed", counts, sweeps, ("fork_plan", "tape_append"))
    add(counts)
    return launches


def profile_paths(dev, codes, names) -> None:
    """Phase 8, a measurement mode outside the counted runs: (a) the
    analyze engine of erc20full with each loop stage timed between device
    synchronizations; (b) a torch.profiler window over the batch's first
    16 supersteps for the device's busy share and the top kernels (the
    profiler's event processing is slow, so the window stays short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.analysis import SymExecWrapper
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    ENGINE_STATS.update(timing=True, superstep_s=0.0, forks_s=0.0, propagate_s=0.0)
    steps0 = ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    SymExecWrapper([realworld("erc20full")], limits=DEFAULT_LIMITS, lanes_per_contract=64,
                   max_steps=512, transaction_count=2, device=dev)
    torch.cuda.synchronize()
    stages = {k: round(ENGINE_STATS[k], 3) for k in ("superstep_s", "forks_s", "propagate_s")}
    ENGINE_STATS["timing"] = False
    print(f"[8] erc20full engine stages (synchronized): {json.dumps(stages)}, "
          f"engine {time.monotonic() - t0:.2f} s, "
          f"{ENGINE_STATS['supersteps'] - steps0} supersteps", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        SymExecWrapper(codes, contract_names=names, limits=DEFAULT_LIMITS,
                       lanes_per_contract=64, max_steps=16, transaction_count=1, device=dev)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = prof.key_averages()
    busy_us = sum(dev_us(e) for e in events)
    n_kernels = sum(e.count for e in events if dev_us(e) > 0)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    print(f"[8] batch window (16 supersteps, profiled): wall {wall:.2f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{n_kernels} device ops", flush=True)
    for e in top:
        print(f"[8]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<7} {e.key[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
