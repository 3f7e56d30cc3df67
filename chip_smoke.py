"""Smoke run of the PyTorch/CUDA analyzer on one NVIDIA card.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels (K1-K5) from ``mythril_tpu_torch/
   kernels/csrc`` with nvcc, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card
   (K1-K4 at the main path's width, P = 2048 lanes; K5 on 64 lanes of
   edge and random operands), seeded random inputs plus edge cases;
   bit-for-bit equality is required, and K4/K5 also against hashlib /
   Python's ``pow``. Times each kernel, its plain version and the bound
   the card's rates put on the same work;
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


def realworld_system():
    return [(n, realworld(f)) for n, f in REALWORLD]


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
    ops = P_MAIN * 256 * 8 * 3   # 256 steps x 8 limbs x (shift, compare, subtract)
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
    """32-bit operations K5 does for these operands: mu (258 shift-
    compare-subtract steps over 9 limbs) plus, per product-reduce, ~190
    multiply-adds (4 operations each) and ~50 limb shifts/subtractions."""
    per_mulmod = 4 * (64 + 81 + 45) + 4 * 50
    ops = 0
    for _, e, m in cases:
        if m:
            ops += 258 * 27 + per_mulmod * (e.bit_length() + bin(e).count("1"))
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
               check_k4(dev, rng), check_k5(dev, rng)]
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


def run_cli(name: str, argv) -> None:
    """``analyze ... -o json`` at the CLI defaults on the card, held to
    the pinned JAX report ``tests/fixtures/torch_port/<name>_default.json``."""
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.interfaces.cli import main as cli_main
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    buf = io.StringIO()
    t0 = time.monotonic()
    syncs0 = ci.HOST_SYNCS["count"]
    steps0 = ENGINE_STATS["supersteps"]
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["analyze", *argv, "-o", "json"])
    wall = time.monotonic() - t0
    if rc != 0:
        fail(f"analyze {name}: rc {rc}")
    got = json.loads(buf.getvalue())
    check_report(f"analyze {name}", got["issues"], got["coverage"],
                 load_json("torch_port", f"{name}_default.json"))
    n_syncs = ci.HOST_SYNCS["count"] - syncs0
    n_steps = ENGINE_STATS["supersteps"] - steps0
    print(f"[5] analyze {name}: {len(got['issues'])} issue(s), report equal; "
          f"{wall:.2f} s wall, {n_steps} supersteps, {n_syncs} host syncs "
          f"({n_syncs / max(1, n_steps):.2f} per superstep)", flush=True)


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
    profile_paths(dev, codes, names)
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
