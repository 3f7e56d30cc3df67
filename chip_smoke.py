"""Smoke run of the PyTorch/CUDA analyzer on one NVIDIA card.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels (K1-K3) from ``mythril_tpu_torch/
   kernels/csrc`` with nvcc, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's width (P = 2048 lanes), seeded random inputs plus edge
   cases; bit-for-bit equality is required. Times each kernel, its plain
   version and the bound the card's rates put on the same work;
4. goldens: the 14 CALL-free golden fixtures at the goldens' settings
   (test limits, 16 lanes, 192 steps) on the card, issue for issue
   against ``tests/fixtures/goldens``;
5. analyze: ``analyze -o json`` at the CLI defaults (64 lanes, 512 steps,
   -t 2) on the realworld ERC-20 and ERC-721 runtimes — the main path —
   against ``tests/fixtures/torch_port/*_default.json``; kernel launch
   counts are zeroed just before and read just after;
6. batch: 32 contracts (16 x ERC-20, 16 x ERC-721) x 64 lanes = 2048
   lanes, default limits, 512 steps, -t 2, then the detection modules;
   wall time, lane-steps/s, contracts/s, host syncs, peak memory;
7. profile (measurement only, after the counted runs): the engine's
   loop stages timed between synchronizations, and a torch.profiler
   window (16 supersteps of the batch) for the device's busy share and
   its top kernels.

Prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# fixtures (the CALL-free subset of tests/test_goldens.py's fixtures, built
# with this package's assembler)
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
    return fx


def issue_key(d):
    return {"contract": d["contract"], "swc-id": d["swc-id"], "address": d["address"],
            "title": d["title"], "severity": d["severity"]}


def sorted_keys(issues):
    return sorted((issue_key(d) for d in issues),
                  key=lambda d: (d["swc-id"], d["address"], d["title"]))


def realworld(name: str) -> bytes:
    with open(os.path.join(ROOT, "tests", "fixtures", "realworld", f"{name}.bin-runtime")) as fh:
        return bytes.fromhex(fh.read().strip().removeprefix("0x"))


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
    results = [check_k1(dev, rng), check_k2(dev, rng), check_k3(dev, rng)]
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


def run_paths(dev) -> dict:
    import contextlib
    import io

    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import DEFAULT_LIMITS, TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.interfaces.cli import main as cli_main
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    # phase 4: goldens on the card
    t0 = time.monotonic()
    for name, code in sorted(golden_fixtures().items()):
        sym = SymExecWrapper([code], limits=TEST_LIMITS, lanes_per_contract=16,
                             max_steps=192, device=dev)
        got = sorted_keys(i.as_dict() for i in fire_lasers(sym.ctx).issues)
        with open(os.path.join(ROOT, "tests", "fixtures", "goldens", f"{name}.json")) as fh:
            want = json.load(fh)
        if got != want:
            fail(f"golden {name}: {got} != {want}")
    print(f"[4] 14 goldens equal on the card ({time.monotonic() - t0:.1f} s)", flush=True)

    # phase 5: the main path, analyze at the CLI defaults
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    for name in ("erc20full", "erc721"):
        path = os.path.join(ROOT, "tests", "fixtures", "realworld", f"{name}.bin-runtime")
        buf = io.StringIO()
        t0 = time.monotonic()
        syncs0 = ci.HOST_SYNCS["count"]
        steps0 = ENGINE_STATS["supersteps"]
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["analyze", "-f", path, "-o", "json"])
        wall = time.monotonic() - t0
        if rc != 0:
            fail(f"analyze {name}: rc {rc}")
        got = json.loads(buf.getvalue())
        with open(os.path.join(ROOT, "tests", "fixtures", "torch_port",
                               f"{name}_default.json")) as fh:
            want = json.load(fh)
        if sorted_keys(got["issues"]) != sorted_keys(want["issues"]):
            fail(f"analyze {name}: issues {got['issues']} != {want['issues']}")
        for k in ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
                  "lanes_errored", "instruction_coverage_pct"):
            if got["coverage"][k] != want["coverage"][k]:
                fail(f"analyze {name}: coverage {k} {got['coverage'][k]} != "
                     f"{want['coverage'][k]}")
        n_syncs = ci.HOST_SYNCS["count"] - syncs0
        n_steps = ENGINE_STATS["supersteps"] - steps0
        print(f"[5] analyze {name}: {len(got['issues'])} issue(s), coverage equal; "
              f"{wall:.2f} s wall, {n_steps} supersteps, {n_syncs} host syncs "
              f"({n_syncs / max(1, n_steps):.2f} per superstep)", flush=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[5] main-path launches {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # phase 6: the campaign-width batch
    codes = [realworld("erc20full")] * BATCH_CONTRACTS + [realworld("erc721")] * BATCH_CONTRACTS
    names = [f"erc20full_{i}" for i in range(BATCH_CONTRACTS)] + \
        [f"erc721_{i}" for i in range(BATCH_CONTRACTS)]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    syncs0 = ci.HOST_SYNCS["count"]
    steps0 = ENGINE_STATS["lane_steps"]
    supersteps0 = ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    sym = SymExecWrapper(codes, contract_names=names, limits=DEFAULT_LIMITS,
                         lanes_per_contract=64, max_steps=512, transaction_count=2,
                         device=dev)
    torch.cuda.synchronize()
    t_engine = time.monotonic() - t0
    report = fire_lasers(sym)
    wall = time.monotonic() - t0
    lane_steps = ENGINE_STATS["lane_steps"] - steps0
    batch_launches = kernels.launch_counts()
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
    print(f"[6] batch {json.dumps(stats)}", flush=True)
    for k, n in batch_launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched in the batch")
    want20 = {(d["swc-id"], d["address"]) for d in json.load(open(os.path.join(
        ROOT, "tests", "fixtures", "torch_port", "erc20full_default.json")))["issues"]}
    got = {(i.swc_id, i.address) for i in report.issues if i.contract.startswith("erc20")}
    if got != want20:
        fail(f"batch: erc20 issues {got} != {want20}")
    profile_paths(dev, codes, names)
    return launches


def profile_paths(dev, codes, names) -> None:
    """Phase 7, a measurement mode outside the counted runs: (a) the
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
    print(f"[7] erc20full engine stages (synchronized): {json.dumps(stages)}, "
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
    print(f"[7] batch window (16 supersteps, profiled): wall {wall:.2f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{n_kernels} device ops", flush=True)
    for e in top:
        print(f"[7]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<7} {e.key[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
