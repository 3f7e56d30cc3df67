"""Smoke run of the PyTorch/CUDA analyzer on one NVIDIA card.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --kernels  # build + kernel checks only
    python3 chip_smoke.py --campaign # build + the campaign phase only
    python3 chip_smoke.py --parent-k6 SRC ...  # also time another tree's K1, K2, K4-K6, K9, K10

Phases, each fatal on failure:

1. device: the card's name and power limit (``nvidia-smi``); exits
   non-zero without CUDA;
2. build: compiles the CUDA kernels (K1-K10) from ``mythril_tpu_torch/
   kernels/csrc`` with nvcc, in parallel, or reuses the libraries an
   earlier process built from the same sources (the stamp in
   ``kernels/_build``);
3. kernels: each kernel against its plain PyTorch version on the card
   (K1-K4 and K6-K9 at the main path's width, P = 2048 lanes; K5 at the
   main path's compacted shape, one lane, and on 64 lanes of edge and
   random operands), seeded random inputs plus edge cases; bit-for-bit
   equality is required, and K1/K2/K4/K5/K8/K9 also against the host
   keccak, hashlib or Python's ints. K1 and K9 also on the rare branches
   of their division core and EXP's fast paths (``DIVMOD_CASES``,
   ``MODWIDE_CASES``, ``EXP_CASES``: the add-back, the digit cap, the
   second-limb correction, one-limb divisors, k e = 255 and 256, ...).
   K2 also on CREATE2's 85-byte rows, in place and one byte off an
   aligned start; K4 through its lane mask and off a 16-byte boundary,
   and timed on the precompile path at ``K4_PATH_LANES`` lanes (the
   masked launch against the compacted route before it). ptxas's
   register and spill lines for K1-K7, K9 and K10 (K1, K2, K4, K5 and K9
   must have no stack frame and no spill, K10 no spill and no frame
   above ``K10_MAX_STACK`` bytes). K3's
   group entry point against R sequential plain appends on its edge
   cases (``group_cases``: the SHA3 chain
   masked off mid-chain, the binary op's CONST, CONST and node, rows
   repeating earlier rows of their group, a forged fingerprint
   collision, random sources, masked-off lanes, overflows mid-group).
   K6 on random tapes holding every op (self and forward references,
   clipped ids) and on the frontier of a real batch just before a sweep;
   with ``--parent-k6 SRC`` also another tree's propagate_sweep.cu (say
   the parent commit's, unpacked in an ignored directory) and the
   u256_modexp.cu, u256_divmod.cu, u256_mulmod_exp.cu, keccak256.cu,
   sha256.cu and evm_step.cu beside it, built here and timed on the same
   inputs in turns with this tree's K6, K5, K1, K9 (mod_wide, exp), K2,
   K4 (the whole batch and the precompile path) and K10 (the ERC-20 run
   and the stress dispatch by opcode class). K7, the whole fork expansion in
   place through its descriptor, against the plain functional route
   (``expand_forks_plain``) over every leaf of a P = 2048 frontier (every
   field random rows, bounded-loops tables the copies hit), for each
   policy at fork blocks of 64 lanes and of P, defer on and off, with the
   profiler and the loop bound, and once without either. K10 (the concrete EVM step)
   against ``superstep_plain`` / ``prologue_plain`` / ``dispatch_plain``
   / ``epilogue_plain`` (whose arithmetic and SHA3 are plain PyTorch on
   the card too) over every frontier field, each entry point through its
   launch descriptor in place on fields owned once, over consecutive
   steps: the vmtests batch stepped to quiescence, a seeded random-opcode
   stress batch of 4096 lanes (edge words of every class, every trap)
   under both gas schedules with the profiler on and a random ``skip``
   mask, the fused entry point's count of running lanes, ``sha3_batch``'s
   SHA3 windows (every offset mod 8, windows ending at the row's last
   byte, offsets below the row; the digests also against the host
   keccak), each entry point once standalone (its input unchanged), and
   the ERC-20 transfer run.
   Times each kernel, its plain version and the bound the card's rates
   put on the same work; K3 and K6 also on the device alone (K3 through
   the loop's tape descriptor, as the engine calls it); K10 also through
   the wrapper, on the device
   alone, its bind, the standalone copying path, a sweep of block sizes
   and the stress dispatch by opcode class;
4. goldens: the 20 golden fixtures at the goldens' settings (test
   limits, 16 lanes, 192 steps), the real-world batch and BASELINE
   config 4 at their tests' limits, issue for issue against
   ``tests/fixtures/goldens``;
5. analyze: ``analyze -o json`` at the CLI defaults (64 lanes, 512
   steps, -t 2) — the main path — against the JAX reports pinned in
   ``tests/fixtures/torch_port/*_default.json``: (a) the realworld ERC-20
   and ERC-721 runtimes; (b) the 2-of-3 multisig (CALL) and the
   precompile fixture with ``--creation-code`` (SHA-256 and MODEXP in its
   constructor: K4 and K5 must launch there). K10's prologue, dispatch
   and epilogue must launch on every analyze (the concrete MUL, DIV, EXP,
   MULMOD and SHA3 run inside K10, so K1, K2, K8 and K9 no longer do),
   and both of K3's entry points; an erc20full analyze may take at most
   ``K3_ERC20FULL_MAX`` K3 launches. Launch counts are zeroed just before
   each part and read just after;
6. frames at full width through ``SymExecWrapper``: BASELINE config 4
   (caller -> router -> vault, creation tx + 2 message txs, default
   limits, 64 lanes per contract, 512 steps) and the 4-contract
   real-world batch (EIP-1167 proxy, ERC-20, ERC-721, multisig; -t 2),
   against pinned JAX reports; wall time, supersteps, host syncs, frames
   pushed and popped, K4/K5 launches;
7. batch: 32 contracts (16 x ERC-20, 16 x ERC-721) x 64 lanes = 2048
   lanes, default limits, 512 steps, -t 2, then the detection modules;
   wall time, lane-steps/s, contracts/s, host syncs, peak memory; one
   launch of each K10 split entry point per superstep. Then the batch
   again under the held-input check: the frontier passed to each
   ``sym_run`` call is copied to the host first and must equal, field for
   field, what the caller still holds after it; K10's fields are copied
   once per call; the issues equal the pin;
9. fork strategies, fork blocks, berlin, iprof, checkpoints at full
   width, against JAX reports pinned in ``tests/fixtures/torch_port/``:
   ``analyze`` of the arith fixture (MUL, EXP, MULMOD, ADDMOD) with each
   of the six strategies, bfs at the CLI defaults with
   ``--enable-iprof`` (the profile table too), the other five at 256
   steps and one transaction (``ARITH_SHORT_ARGS``); the berlin gas
   schedule at that depth; the arith/ERC-20/ERC-721/multisig batch in fork
   blocks of 64 lanes with spill and in-loop migration; a checkpointed
   run resumed mid-transaction from its npz. K10 and K7 must launch on
   every run, and K6 once per feasibility sweep;
8. profile (measurement only, after the counted runs): the engine's
   loop stages timed between synchronizations for erc20full and (in its
   phase-9 run) arith bfs; the device ops of a fork expansion through
   the loop's entry point (torch.profiler over expansions in a row: at
   most 3 kernel launches and 10 other device ops an expansion); and a
   torch.profiler window (16 supersteps of the batch) for the device's
   busy share and its top kernels; the EXP lanes K10's dispatch runs, by
   ``exp8``'s path (``exp_paths``), in phase 7's held-input run, phase
   9's five short strategies and its checkpointed arith run, and the
   unpipelined campaign;
10. concrete path, run first after the kernel checks: ``run`` on the
   ERC-20 transfer workload (4096 lanes, default limits, 256 steps), one
   fused K10 launch a superstep in place on fields copied once, the
   device's count of running lanes read every ``RUN_READ_EVERY`` launches;
   every lane halts without error or revert after the step count the
   reference EVM pins, the frontier equals ``run_plain``'s and the input
   is unchanged. ms per superstep, lane-steps/s and host syncs per
   superstep;
11. campaign, after phase 7: ``analyze --corpus`` of 96 contracts (the
   repo's runtimes repeated: real-world, the port's fixtures, the
   goldens) in 3 batches of 32 contracts x 32 lanes, 256 steps, one
   transaction, default limits — unpipelined (with ``--init-timeout``),
   pipelined, killed after batch 1 (a raise from the heartbeat) and
   resumed from its checkpoint,
   and with an OOM injected on batch 2 walked down the ladder
   (``halve-lanes,halve-batch``). Each run equals the JAX
   ``CorpusCampaign`` pinned in ``tests/fixtures/torch_port/
   campaign_default.json`` (issues of every contract, paths, quarantine,
   statuses, ladder events, solver counts) and launches K10, K3 (both
   entry points, the count printed), K6 and K7; contracts/s, seconds per
   batch, host syncs; the unpipelined run
   under the held-input check of phase 7. A second process must reuse
   the kernel build.

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
# phase 9's depth for the five strategies after bfs and for berlin (bfs
# keeps the CLI defaults): 256 steps, one transaction
ARITH_SHORT_ARGS = ("--max-steps", "256", "-t", "1")


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
# phase 11: the corpus campaign. tests/torch_port_fixtures.py pins the JAX
# package's CorpusCampaign on this corpus with these arguments
# (tests/fixtures/torch_port/campaign_default.json)
# ---------------------------------------------------------------------------

CAMPAIGN_CONTRACTS = 96  # 3 full batches
# the campaign's own defaults: 32 contracts x 32 lanes, 256 steps, 1 tx
CAMPAIGN_ARGS = ("--batch-size", "32", "--lanes-per-contract", "32", "--max-steps", "256",
                 "-t", "1")
# batch 2 runs out of memory twice, so the ladder takes both of its rungs
CAMPAIGN_OOM = ("--fault-inject", "oom:batch=2:times=2", "--oom-ladder",
                "halve-lanes,halve-batch")
CAMPAIGN_EVENT_KEYS = ("kind", "detail", "batch", "step", "lanes", "width")


def campaign_corpus():
    """The repo's runtimes (real-world, the port's fixtures, the goldens),
    repeated in a fixed order to CAMPAIGN_CONTRACTS; the names sort in
    corpus order."""
    base = []
    for d in ("realworld", "torch_port"):
        base += [(f[:-len(".bin-runtime")], read_hex(fixture_path(d, f)))
                 for f in sorted(os.listdir(fixture_path(d))) if f.endswith(".bin-runtime")]
    base += sorted(golden_fixtures().items())
    return [(f"c{i:03d}_{base[i % len(base)][0]}", base[i % len(base)][1])
            for i in range(CAMPAIGN_CONTRACTS)]


def write_corpus(path: str, contracts) -> None:
    for name, code in contracts:
        with open(os.path.join(path, f"{name}.hex"), "w") as fh:
            fh.write(code.hex())


def campaign_doc(d: dict) -> dict:
    """What a campaign run is held to: every contract's issues (in
    order), the campaign's path coverage (``paths_total``,
    ``dropped_forks``), the resilience outcome (quarantine list, retries,
    per-batch statuses) with its events (the ladder's steps), and the
    solver's verdict counts. Timings, the solver's cache counts (its
    cache lives as long as the process, so they depend on the runs before)
    and the card's ``device_init`` event are left out; the JAX package's
    name of the tier rung (``cpu``) reads as the port's (``next-tier``)."""
    def rung(s):
        return "next-tier" if s == "cpu" else s

    return {
        **{k: d[k] for k in ("contracts", "batches", "issues", "paths_total",
                             "dropped_forks", "quarantined", "retries")},
        "batch_status": [s.replace("ok-degraded:cpu", "ok-degraded:next-tier")
                         for s in d["batch_status"]],
        "events": [{k: rung(e[k]) if k == "step" else e[k]
                    for k in CAMPAIGN_EVENT_KEYS if k in e}
                   for e in d["backend_events"] if e["kind"] != "device_init"],
        "solver": {k: d["solver"].get(k) for k in ("attempts", "sat", "unsat", "unknown")},
        "issues_detail": d.get("issues_detail"),
    }


# ---------------------------------------------------------------------------
# K10 inputs: the vmtests batch and a seeded random-opcode stress batch
# (tests/test_torch_evm_step.py builds the same batches at the test limits)
# ---------------------------------------------------------------------------

W256 = (1 << 256) - 1


def vmtests_batch(limits, device="cpu"):
    """(frontier, env, corpus): every VM vector of tests/fixtures/
    vmtests.json, one lane each, at its own gas limit."""
    from mythril_tpu_torch.core import Corpus, make_env, make_frontier
    from mythril_tpu_torch.disassembler import ContractImage

    doc = load_json("vmtests.json")
    names = sorted(doc["tests"])
    codes = [bytes.fromhex(doc["tests"][n]["exec"]["code"]) for n in names]
    P = len(names)
    calldata = np.zeros((P, limits.calldata_bytes), np.uint8)
    cd_len = np.zeros(P, np.int32)
    for i, n in enumerate(names):
        blob = bytes.fromhex(doc["tests"][n]["exec"].get("data", ""))
        calldata[i, :len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        cd_len[i] = len(blob)
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, limits.max_code)
                                 for c in codes], device)
    f = make_frontier(P, limits, contract_id=np.arange(P, dtype=np.int32), calldata=calldata,
                      calldata_len=cd_len, gas_limit=doc["gasLimit"], n_contracts=P,
                      device=device)
    return f, make_env(P, device=device), corpus


def _edge_cases(M, S):
    """(opcode, stack words top first, lane tweaks) for the scripted lanes
    of the stress batch: the edge words of each class and every trap."""
    big = 1 << 64
    sat = big - 1  # saturates to 2^64 - 1 = -1 in the int64 offsets
    return [
        (0x05, [1 << 255, W256], {}), (0x04, [5, 0], {}), (0x06, [5, 0], {}),
        (0x07, [W256, 3], {}), (0x07, [3, W256], {}), (0x05, [W256 - 6, 3], {}),
        (0x1B, [256, 1], {}), (0x1B, [big, 1], {}), (0x1B, [255, 1], {}),
        (0x1C, [300, W256], {}), (0x1C, [1, W256], {}), (0x1D, [256, 1 << 255], {}),
        (0x1D, [255, 1 << 255], {}), (0x1D, [0, 1 << 255], {}), (0x1D, [4, 1 << 254], {}),
        (0x1D, [1, 1 << 255], {}), (0x1D, [33, W256 - 5], {}), (0x1B, [1, W256], {}),
        (0x1C, [32, W256], {}),
        (0x1A, [32, W256], {}), (0x1A, [31, 0x1FF], {}), (0x1A, [1 << 70, 5], {}),
        (0x0B, [31, 1 << 255], {}), (0x0B, [30, 0x80 << 240], {}), (0x0B, [0, 0x80], {}),
        (0x0B, [big, 5], {}), (0x0B, [0, 0x7F], {}), (0x12, [W256, 1], {}),
        (0x13, [W256, 1], {}), (0x19, [5], {}), (0x03, [0, 1], {}), (0x01, [W256, 2], {}),
        (0x20, [0, 300], {}), (0x20, [sat, 1], {}), (0x20, [M - 10, 64], {}),
        (0x20, [0, 0], {}), (0x20, [5, 200], {}), (0x20, [big, 5], {}), (0x20, [3, big], {}),
        (0x20, [0, 136], {}), (0x20, [7, 135], {}), (0x20, [1 << 63, 1 << 63], {}),
        # SHA3 at every offset mod 8 (K10 lines the row's words up) and
        # windows that end at the row's last byte or start before the row
        *[(0x20, [8 + sh, n], {}) for sh in range(8) for n in (33, 137)],
        *[(0x20, [M - n, n], {}) for n in (1, 8, 13, 136, 137, 199, 200)],
        (0x20, [sat, 9], {}), (0x20, [1 << 63, 5], {}),
        (0x37, [sat, 0, 5], {}), (0x37, [0, sat, 8], {}), (0x37, [10, 0, sat], {}),
        (0x37, [M - 3, 0, 8], {}), (0x37, [4, 2, 40], {}), (0x37, [1 << 63, 0, 1 << 63], {}),
        (0x37, [M - 8, 0, 8], {}), (0x39, [M - 1, 0, 1], {}), (0x3E, [M - 8, 0, 8], {}),
        (0x39, [0, 0, 40], {}), (0x39, [2, 1 << 63, 9], {}), (0x39, [0, 0, 64], {"init": True}),
        (0x3E, [1, 3, 50], {}), (0x3C, [0xAFFE, 0, 0, 70], {}), (0x3C, [0xBEEF, 8, 0, 10], {}),
        (0x51, [sat], {}), (0x51, [M - 32], {}), (0x51, [M - 31], {}), (0x52, [M - 32, W256], {}),
        (0x52, [M - 31, 7], {}), (0x52, [sat, 0x1234], {}), (0x53, [M - 1, 0x1FF], {}),
        (0x53, [sat, 0xAB], {}), (0x53, [M, 1], {}),
        (0x0A, [2, 255], {}), (0x0A, [3, W256], {}), (0x0A, [0, 0], {}), (0x0A, [W256, 2], {}),
        (0x09, [W256, W256, 0], {}), (0x09, [W256, W256, 7], {}), (0x08, [W256, W256, W256 - 1], {}),
        (0x08, [1, 2, 0], {}), (0x09, [1 << 255, 3, (1 << 255) + 19], {}),
        (0xF3, [0, 300], {}), (0xFD, [sat, 2], {}), (0xF3, [M - 4, 8], {}), (0xF3, [0, 0], {}),
        (0xFD, [5, 7], {}), (0x00, [], {}), (0xFE, [], {}), (0xFF, [1], {"static": True}),
        (0xFF, [1], {}),
        (0xA2, [0, 32, 7, 9], {}), (0xA0, [3, 40], {}), (0xA1, [0, 8, 5], {"n_logs": "full"}),
        (0xA1, [sat, 2, 5], {}), (0xA0, [0, 4], {"static": True}),
        (0x56, ["jd"], {}), (0x57, [3, 1], {}), (0x57, [3, 0], {}), (0x56, [sat], {}),
        (0x57, ["jd", 5], {}), (0x56, ["jd"], {"init": True}),
        (0x54, [1], {}), (0x55, [1, 99], {}), (0x55, [2, 5], {"static": True}),
        (0x55, [W256, 5], {"storage": "full"}), (0x55, [1, 6], {"storage": "full"}),
        (0xF1, [0xFFFF, 1, 0, 0, 0, 0, 0], {}), (0xFA, [0xFFFF, 1, 0, 0, 0, 0], {}),
        (0xF0, [0, 0, 40], {}), (0xF5, [0, M - 2, 40, 1], {}),
        (0x5A, [], {}), (0x58, [], {}), (0x59, [], {}), (0x8F, list(range(1, 17)), {}),
        (0x9F, list(range(1, 18)), {}), (0x80, [9], {}), (0x50, [3], {}), (0x5B, [], {}),
        (0x5F, [], {}), (0x31, [0xAFFE], {}), (0x31, [0x1234], {}), (0x3B, [0xAFFE], {}),
        (0x3B, [0xBEEF], {}), (0x3F, [0xAFFE], {}), (0x3F, [0xBEEF], {}), (0x3F, [0xC0DE], {}),
        (0x3F, [0x1234], {}), (0x35, [sat], {}), (0x35, [2], {}), (0x35, [1 << 63], {}),
        (0x36, [], {}), (0x38, [], {"init": True}), (0x38, [], {}), (0x3D, [], {}),
        (0x47, [], {}), (0x30, [], {}), (0x33, [], {}), (0x34, [], {}), (0x40, [1], {}),
        (0x46, [], {}), (0x48, [], {}),
        (0x01, [1], {"sp": 1}), (0x60, [], {"sp": S}), (0x80, [], {"sp": S}),
        (0x01, [1, 2], {"oog": True}), (0x20, [0, 64], {"oog": True}), (0x0C, [], {}),
        (0x01, [1, 2], {"pc_hold": True}), (0x56, ["jd"], {"pc_hold": True}),
    ]


def evm_stress_batch(P, limits, rng, device="cpu"):
    """(frontier, env, corpus): a seeded random-opcode stress batch of P
    lanes for K10. The first lanes are scripted (``_edge_cases``: each
    class's edge words — division by zero, SDIV overflow, shifts >= 256,
    BYTE >= 32, SIGNEXTEND >= 31, offsets near 2^64, copy lengths that
    wrap, SHA3 past the hash cap — and every trap: stack under- and
    overflow, OOG, static writes, full storage and log slots); the rest
    run random code over random stacks, memory, storage, accounts,
    constructor frames and trap states. The instruction profiler is on."""
    from mythril_tpu_torch.core import Corpus, make_env, make_frontier
    from mythril_tpu_torch.core.frontier import Frontier
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.ops import u256

    L = limits
    S, M, K, A, LS, IC = (L.max_stack, L.mem_bytes, L.storage_slots, L.max_accounts,
                          L.log_slots, L.init_code_bytes)
    cases = _edge_cases(M, S)
    # corpus: 0 = the script (each edge opcode once, a JUMPDEST at 3, a
    # PUSH32 cut by the end of code), 1..7 = random code dense in
    # JUMPDESTs and PUSHes
    script = bytearray([0x5B] * 4)
    case_pc = []
    for op, _, _ in cases:
        case_pc.append(len(script))
        script.append(op)
    script += bytes([0x7F, 0xAB, 0xCD])
    codes = [bytes(script)]
    for _ in range(7):
        n = int(rng.integers(40, 300))
        b = rng.integers(0, 256, n).astype(np.uint8)
        b[rng.random(n) < 0.1] = 0x5B
        codes.append(b.tobytes())
    C = len(codes)
    images = [ContractImage.from_bytecode(c, L.max_code) for c in codes]
    corpus = Corpus.from_images(images, device)
    n_case = len(cases)
    cid = rng.integers(1, C, P).astype(np.int32)
    cid[:n_case] = 0
    calldata = rng.integers(0, 256, (P, L.calldata_bytes)).astype(np.uint8)
    cd_len = rng.integers(0, L.calldata_bytes + 1, P).astype(np.int32)
    f = make_frontier(P, L, contract_id=cid, calldata=calldata, calldata_len=cd_len,
                      n_contracts=C).attach_iprof().to_numpy()

    def word(v):
        return u256.from_int(int(v))

    pool = [0, 1, 2, 3, 31, 32, 33, 64, 255, 256, 257, 1 << 63, (1 << 64) - 1, 1 << 64,
            1 << 128, 1 << 255, W256, W256 - 1, (1 << 255) - 1, 0xAFFE, 0xBEEF, 0xC0DE,
            0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF, M - 32, M - 1, M, 100, 4, 5, 7]
    pool_w = np.stack([word(v) for v in pool])
    rand_w = rng.integers(0, 1 << 32, (P, S, 8), dtype=np.int64).astype(np.uint32)
    pick = rng.integers(0, len(pool), (P, S))
    use_pool = rng.random((P, S)) < 0.7
    stack = np.where(use_pool[..., None], pool_w[pick], rand_w)
    small = rng.random((P, S)) < 0.4
    stack[small] = 0
    stack[small, 0] = rng.integers(0, 80, int(small.sum()))
    f.stack = stack.astype(np.uint32)
    f.sp = rng.integers(0, S + 1, P).astype(np.int32)
    f.sp_base = np.where(rng.random(P) < 0.2, rng.integers(0, 4, P), 0).astype(np.int32)
    f.sp_base = np.minimum(f.sp_base, f.sp).astype(np.int32)
    f.pc = np.array([int(rng.integers(0, len(codes[c]) + 3)) for c in cid], dtype=np.int32)
    f.memory = rng.integers(0, 256, (P, M)).astype(np.uint8)
    f.mem_words = rng.integers(0, M // 32 + 1, P).astype(np.int32)
    f.gas_min = rng.integers(0, 50_000, P).astype(np.int64)
    f.gas_max = f.gas_min + rng.integers(0, 5_000, P)
    f.gas_limit = np.where(rng.random(P) < 0.2, f.gas_min + rng.integers(0, 40, P),
                           10_000_000).astype(np.int64)
    # storage: keys from a small set (hits), scoped to this or another account
    f.st_used = rng.random((P, K)) < 0.5
    f.st_keys = pool_w[rng.integers(0, 8, (P, K))].astype(np.uint32)
    f.st_vals = rng.integers(0, 1 << 32, (P, K, 8), dtype=np.int64).astype(np.uint32)
    f.st_acct = (f.cur_acct[:, None] + (rng.random((P, K)) < 0.2)).astype(np.int32)
    f.st_written = rng.random((P, K)) < 0.5
    f.static = rng.random(P) < 0.2
    # accounts: a codeless one (0xBEEF), one with code outside the corpus
    # (0xC0DE), the rest as make_frontier seeded them
    f.acct_addr[:, A - 1] = word(0xBEEF)
    f.acct_code[:, A - 1] = -1
    f.acct_used[:, A - 1] = True
    f.acct_bal[:, A - 1] = word(12345)
    if A > 4:
        f.acct_addr[:, A - 2] = word(0xC0DE)
        f.acct_code[:, A - 2] = -2
        f.acct_used[:, A - 2] = True
    rd = L.returndata_bytes
    f.returndata = rng.integers(0, 256, (P, rd)).astype(np.uint8)
    f.returndata_len = rng.integers(0, rd + 1, P).astype(np.int32)
    f.retval = rng.integers(0, 256, (P, rd)).astype(np.uint8)
    f.retval_len = rng.integers(0, rd + 1, P).astype(np.int32)
    f.n_logs = rng.integers(0, LS + 2, P).astype(np.int32)
    f.pc_hold = rng.random(P) < 0.1
    f.n_steps = rng.integers(0, 100, P).astype(np.int32)
    f.op_hist = rng.integers(0, 5, (P, 256)).astype(np.int32)
    # constructor frames: init code in the frame's own buffer
    init = rng.random(P) < 0.15
    f.depth = np.where(init, 1, f.depth).astype(np.int32)
    f.init_depth = np.where(init, 1, 0).astype(np.int32)
    f.init_code = rng.integers(0, 256, (P, IC)).astype(np.uint8)
    f.init_len = rng.integers(0, IC + 1, P).astype(np.int32)
    f.init_jd = rng.random((P, IC)) < 0.3
    f.pc = np.where(init, rng.integers(0, IC + 2, P), f.pc).astype(np.int32)
    # lanes that do not run: inactive, halted, errored
    state = rng.random(P)
    f.active = state >= 0.03
    f.halted = (state >= 0.03) & (state < 0.06)
    f.error = (state >= 0.06) & (state < 0.09)
    f.err_code = np.where(f.error, rng.integers(1, 13, P), 0).astype(np.int32)
    # the scripted lanes
    jd = 3
    for i, (op, words, tw) in enumerate(cases):
        f.active[i], f.halted[i], f.error[i], f.err_code[i] = True, False, False, 0
        f.pc_hold[i] = tw.get("pc_hold", False)
        f.static[i] = tw.get("static", False)
        f.depth[i] = f.init_depth[i] = 0
        f.pc[i] = case_pc[i]
        if tw.get("init"):
            f.depth[i] = f.init_depth[i] = 1
            f.init_code[i, :] = 0
            f.init_code[i, 0] = op
            f.init_code[i, 1:3] = 0x5B
            f.init_jd[i, :] = False
            f.init_jd[i, 2] = True
            f.init_len[i] = 80
            f.pc[i] = 0
        sp = tw.get("sp", len(words) + 2)
        f.sp[i], f.sp_base[i] = sp, 0
        for k, v in enumerate(words):
            v = (2 if tw.get("init") else jd) if v == "jd" else v
            f.stack[i, sp - 1 - k] = word(v)
        if tw.get("oog"):
            f.gas_limit[i] = f.gas_max[i] = f.gas_min[i]
        if tw.get("n_logs") == "full":
            f.n_logs[i] = LS
        if tw.get("storage") == "full":
            f.st_used[i] = True
            f.st_acct[i] = f.cur_acct[i]
            f.st_keys[i] = np.stack([word(0x5000 + k) for k in range(K)])
        elif op in (0x54, 0x55):
            f.st_keys[i, 0], f.st_used[i, 0], f.st_acct[i, 0] = word(1), True, f.cur_acct[i]
    f = Frontier.from_numpy(f, device)
    return f, make_env(P, device=device), corpus


def sha3_windows(M):
    """(offset, length) of the SHA3 lanes of ``sha3_batch``: every offset
    mod 8 at lengths around the 8-byte word and the 136-byte block, the
    same lengths ending at the row's last byte, and offsets that saturate
    below the row (bytes there read as 0)."""
    lens = (0, 1, 7, 8, 9, 31, 32, 33, 64, 135, 136, 137, 199, 200)
    return ([(40 + sh, n) for sh in range(8) for n in lens]
            + [(M - n, n) for n in lens if n]
            + [((1 << 64) - 1, n) for n in (1, 5, 9, 200)] + [(1 << 63, 5)])


def sha3_batch(limits, rng, device="cpu"):
    """(frontier, env, corpus, windows): one lane per ``sha3_windows``
    window, each about to run SHA3 (the corpus is SHA3, STOP) over a
    random memory row."""
    from mythril_tpu_torch.core import Corpus, make_env, make_frontier
    from mythril_tpu_torch.core.frontier import Frontier
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.ops import u256

    M = limits.mem_bytes
    windows = sha3_windows(M)
    P = len(windows)
    corpus = Corpus.from_images([ContractImage.from_bytecode(bytes([0x20, 0x00]),
                                                             limits.max_code)], device)
    f = make_frontier(P, limits, contract_id=np.zeros(P, np.int32), n_contracts=1).to_numpy()
    f.memory = rng.integers(0, 256, (P, M)).astype(np.uint8)
    f.mem_words = np.full(P, M // 32, np.int32)
    for i, (off, n) in enumerate(windows):
        f.stack[i, 0] = u256.from_int(n)
        f.stack[i, 1] = u256.from_int(off)
    f.sp = np.full(P, 2, np.int32)
    return Frontier.from_numpy(f, device), make_env(P, device=device), corpus, windows


def sha3_digests(memory, windows) -> list:
    """The keccak-256 each ``sha3_batch`` lane must push: its window of the
    lane's memory row (``memory`` a numpy array), bytes outside the row
    read as 0, the offset an int64 as the step reads it."""
    from mythril_tpu_torch.ops import keccak

    M = memory.shape[1]
    out = []
    for row, (off, n) in zip(memory, windows):
        off = off - (1 << 64) if off >> 63 else off
        data = bytes(int(row[off + k]) if 0 <= off + k < M else 0 for k in range(n))
        out.append(keccak.keccak256_host_int(data))
    return out


def frontier_errs(got, want) -> dict:
    """max_abs_err of every frontier field (-1 for a shape or presence
    mismatch)."""
    out = {}
    for fl in dataclasses.fields(want):
        a, b = getattr(got, fl.name), getattr(want, fl.name)
        if a is None or b is None:
            out[fl.name] = 0 if a is None and b is None else -1
        else:
            out[fl.name] = max_abs_err(a, b)
    return out


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


def device_us(e) -> float:
    """Self device time (us) of a torch.profiler ``key_averages`` entry."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def kernel_device_ms(fn, kernel: str, reps: int = 1) -> float:
    """Mean device time (ms) of one launch of the CUDA kernel whose name
    holds ``kernel`` over ``reps`` calls of ``fn``, from a torch.profiler
    trace: the host work of each call (a wrapper's marshaling, which the
    event times above include while the card idles) is left out; nan
    when the trace shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    n, us = sum(e.count for e in events), sum(device_us(e) for e in events)
    return us / n / 1e3 if n and us else float("nan")


def kernels_device_ms(fn, kernels, reps: int = 1) -> dict:
    """:func:`kernel_device_ms` of several kernels from one trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for k in kernels:
        events = [e for e in prof.key_averages() if f"{k}_kernel" in e.key]
        n, us = sum(e.count for e in events), sum(device_us(e) for e in events)
        out[k] = us / n / 1e3 if n and us else float("nan")
    return out


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


# exp8's paths (u256.cuh), in the order it tries them: the four exact
# fast paths, then the general chain
EXP_PATHS = ("e_zero", "base_01", "pow2", "even_big", "chain")


def exp_path(base: int, e: int) -> str:
    """The path ``exp8`` takes for (base, e)."""
    if e == 0:
        return "e_zero"
    if base <= 1:
        return "base_01"
    low = (base & -base).bit_length() - 1
    if low == base.bit_length() - 1:
        return "pow2"
    if low > 0 and low * e >= 256:
        return "even_big"
    return "chain"


def exp_ops(base: int, e: int) -> int:
    """32-bit operations base ** e mod 2^256 needs: none where the result
    follows from the operands' bits (``exp_path`` not "chain"), else a
    left-to-right square-and-multiply whose squarings take 20 multiply-adds
    (the 16 products below the diagonal, doubled, and 4 squares) and whose
    multiplies take 36, 4 operations each."""
    if exp_path(base, e) != "chain":
        return 0
    return ((e.bit_length() - 1) * 20 + (bin(e).count("1") - 1) * 36) * 4


def exp_path_index(base, e):
    """``exp_path`` of every lane of [P, 8] words (int64 carriers of
    32-bit limbs) as an index into EXP_PATHS, on the words' device, with
    no host read."""
    import torch

    nz = base != 0
    low_limb = nz.int().argmax(1)
    limb = base.gather(1, low_limb[:, None])[:, 0]
    low = low_limb * 32 + torch.log2((limb & -limb).clamp(min=1).double()).long()
    pow2 = (nz.sum(1) == 1) & ((limb & (limb - 1)) == 0)
    e_small = (e[:, 1:] == 0).all(1) & (e[:, 0] < 256)
    paths = ((e == 0).all(1), (base[:, 1:] == 0).all(1) & (base[:, 0] <= 1), pow2,
             (low > 0) & (~e_small | (low * e[:, 0] >= 256)))
    idx = torch.full_like(low, len(EXP_PATHS) - 1)
    for i in reversed(range(len(paths))):
        idx = torch.where(paths[i], i, idx)
    return idx


@contextlib.contextmanager
def exp_paths(what):
    """Count, by ``exp8``'s path, the EXP lanes that K10's dispatch runs
    inside the block (their operands read on the device before each
    launch, one host read at the end) and print the counts."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.core import interpreter as ci

    dispatch = kernels.evm_dispatch
    counts = []

    def counting(f, env, corpus, op, run, old_pc, skip=None, k10=None):
        lanes = run & (ci.Tables.on(op.device).CLASS[op.long()] == ci.CLS_EXP)
        if skip is not None:
            lanes = lanes & ~skip
        idx = exp_path_index(ci._peek(f, 0), ci._peek(f, 1))
        counts.append(torch.zeros(len(EXP_PATHS), dtype=torch.int64, device=op.device)
                      .index_add_(0, idx, lanes.long()))
        return dispatch(f, env, corpus, op, run, old_pc, skip, k10)

    kernels.evm_dispatch = counting
    try:
        yield
    finally:
        kernels.evm_dispatch = dispatch
    got = dict(zip(EXP_PATHS, torch.stack(counts).sum(0).tolist() if counts
                   else [0] * len(EXP_PATHS)))
    print(f"[8] EXP lanes through K10 by exp8's path, {what}: {json.dumps(got)}", flush=True)


def words_tensor(vals, dev):
    import torch
    from mythril_tpu_torch.ops import u256

    return torch.as_tensor(u256.from_ints(vals).astype(np.int64), device=dev)


# The rare branches of the division core (u256.cuh `divrem`: Knuth's
# algorithm D over 32-bit limbs) and EXP's fast paths, each case with the
# branch it reaches; tests/test_torch_u256_host.py's model of the
# algorithm asserts that it does. K1: (name, x, d, branch); K9's
# mod_wide: (name, a, b, m, "mulmod" or "addmod", branch), the 512-bit
# product or 257-bit sum reduced mod m; K9's exp: (name, base, e, path).
# "digits" is the general digit loop with no rare branch.
ADDBACK = ((0x7fffffff_80000000_00000000_00000000, 0x80000000_00000000_00000001),
           (0x00000001_80000000_00000000_00000003, 0x20000000_00000000_00000001))
CAP = (0x800000007ffffffe0000000166dfe717c1731339, 0x80000000ffffffff)
CORR1 = (0x150df4e6d437d39a55e41634fffffffe, 0x80000001ffffffff)
CORR2 = (0x7b0b1d225c4efd221b995374, 0x80000001ffffffff)
DIVMOD_CASES = (
    ("div_by_zero", 5, 0, "zero"),
    ("zero_by_zero", 0, 0, "zero"),
    ("max_by_zero", W256, 0, "zero"),
    ("x_below_d", 7, 1 << 200, "below"),
    ("zero_by_d", 0, 12345, "below"),
    ("x_equals_d", (1 << 200) + 99, (1 << 200) + 99, "digits"),
    ("exact_multiple", ((1 << 130) + 3) * 0xFFFF_FFFF_0000_0001, (1 << 130) + 3, "digits"),
    ("one_limb", W256, 7, "one_limb"),
    ("one_limb_max", W256, 0xFFFFFFFF, "one_limb"),
    ("one_limb_top_bit", 1 << 255, 0x80000000, "one_limb"),
    ("by_one", (1 << 255) + 12345, 1, "one_limb"),
    ("selector_prologue", (0xa9059cbb << 224) | 12345, 1 << 224, "digits"),
    ("top_limb_1", W256, (1 << 224) + 12345, "digits"),
    ("top_limb_ffffffff", W256, (0xFFFFFFFF << 224) | 12345, "digits"),
    ("max_by_max", W256, W256, "digits"),
    ("sdiv_overflow_unsigned", 1 << 255, W256, "below"),
    ("cap", CAP[0], CAP[1], "cap"),
    ("second_limb_once", CORR1[0], CORR1[1], "corr1"),
    ("second_limb_twice", CORR2[0], CORR2[1], "corr2"),
    ("addback_a", ADDBACK[0][0], ADDBACK[0][1], "addback"),
    ("addback_b", ADDBACK[1][0], ADDBACK[1][1], "addback"),
    ("addback_a_2^128", ADDBACK[0][0] << 128, ADDBACK[0][1] << 128, "addback"),
    ("addback_b_2^128", ADDBACK[1][0] << 128, ADDBACK[1][1] << 128, "addback"),
)
MODWIDE_CASES = (
    ("mulmod_m_zero", W256, W256, 0, "mulmod", "zero"),
    ("mulmod_m_one", W256, 3, 1, "mulmod", "one_limb"),
    ("mulmod_below", 3, 5, 1 << 200, "mulmod", "below"),
    ("mulmod_one_limb", W256, W256 - 1, 0xFFFFFFFB, "mulmod", "one_limb"),
    ("mulmod_max_squared_by_max", W256, W256, W256, "mulmod", "addback"),
    ("mulmod_top_limb_1", W256, W256, (1 << 224) + 1, "mulmod", "digits"),
    ("mulmod_top_limb_ffffffff", W256, 1 << 255, (0xFFFFFFFF << 224) | 7, "mulmod", "digits"),
    ("mulmod_cap", CAP[0], 1, CAP[1], "mulmod", "cap"),
    ("mulmod_second_limb_twice", CORR2[0], 1, CORR2[1], "mulmod", "corr2"),
    ("mulmod_addback_a", ADDBACK[0][0], 1, ADDBACK[0][1], "mulmod", "addback"),
    ("mulmod_addback_b", ADDBACK[1][0], 1, ADDBACK[1][1], "mulmod", "addback"),
    ("mulmod_addback_a_2^128", ADDBACK[0][0] << 128, 1 << 128, ADDBACK[0][1] << 128, "mulmod",
     "addback"),
    ("mulmod_addback_b_2^128", ADDBACK[1][0] << 128, 1 << 128, ADDBACK[1][1] << 128, "mulmod",
     "addback"),
    ("addmod_carry", W256, W256, W256 - 1, "addmod", "digits"),
    ("addmod_carry_small_m", W256, 2, 10, "addmod", "one_limb"),
    ("addmod_m_zero", W256, W256, 0, "addmod", "zero"),
)
EXP_CASES = (
    ("zero_to_zero", 0, 0, "e_zero"),
    ("max_to_zero", W256, 0, "e_zero"),
    ("zero_base", 0, 5, "base_01"),
    ("one_base", 1, W256, "base_01"),
    ("two_to_255", 2, 255, "pow2"),
    ("two_to_256", 2, 256, "pow2"),
    ("two_to_2^32_plus_1", 2, (1 << 32) + 1, "pow2"),
    ("2^85_to_3", 1 << 85, 3, "pow2"),
    ("2^64_to_4", 1 << 64, 4, "pow2"),
    ("0x100_to_31", 0x100, 31, "pow2"),
    ("0x100_to_32", 0x100, 32, "pow2"),
    ("2^255_to_1", 1 << 255, 1, "pow2"),
    ("six_to_255", 6, 255, "chain"),
    ("six_to_256", 6, 256, "even_big"),
    ("twelve_to_128", 12, 128, "even_big"),
    ("twelve_to_127", 12, 127, "chain"),
    ("ten_to_2^200", 10, 1 << 200, "even_big"),
    ("ten_to_18", 10, 18, "chain"),
    ("three_to_max", 3, W256, "chain"),
    ("max_to_max", W256, W256, "chain"),
    ("odd_to_256_bit", 0x1234567890abcdef_fedcba0987654321_0f1e2d3c4b5a6978_1357913579135791,
     (1 << 255) + 0xdeadbeef, "chain"),
    ("max_to_one", W256, 1, "chain"),
    # the chain's 2-bit windows: digits 1, 2 and 3, and a top window of
    # one bit in a higher limb above windows of 0
    ("seven_to_0b11011", 7, 0b11011, "chain"),
    ("three_to_2^32", 3, 1 << 32, "chain"),
)


def u256_call(fn, dev, ins, out_shapes):
    """One launch of a K1 or K9 entry point ``fn`` of a loaded library (the
    parent tree's, under ``--parent-k6``) on PyTorch's current stream ->
    its outputs, allocated here."""
    import torch

    outs = [torch.empty(s, dtype=torch.int64, device=dev) for s in out_shapes]
    err = fn(*(t.data_ptr() for t in ins + outs), ins[0].shape[0],
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        fail(f"parent kernel launch failed with CUDA error {err}")
    return outs


def turns(name, kernel, this, old, reps, dev_reps=20) -> dict:
    """``this`` and the parent tree's ``old`` timed on the same inputs in
    turns (parent, this, this, parent; CUDA events), and on the device
    alone (torch.profiler) -> printed and returned."""
    t = [time_ms(f, reps) for f in (old, this, this, old)]
    d = [kernel_device_ms(f, kernel, dev_reps) for f in (old, this)]
    print(f"[3] {name}, the parent's and this tree's on the same inputs in turns (parent, this, "
          f"this, parent): {' / '.join(f'{x:.4f}' for x in t)} ms; on the device parent "
          f"{d[0]:.4f}, this {d[1]:.4f} ms", flush=True)
    return dict(turns=t, parent_device_ms=d[0], device_ms=d[1])


def check_k1(dev, rng, parent_lib=None):
    """K1 at P = 2048: edge words, the rare branches of the division core
    (``DIVMOD_CASES``) and seeded random words, against its plain version
    and Python's ints; SDIV through it against the plain signed division;
    with ``--parent-k6 SRC`` timed against the parent tree's K1 in turns."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    M = (1 << 256) - 1
    edge = [0, 1, 2, 1 << 255, M, M - 1, (1 << 255) - 1, (1 << 128) + 7]
    cases = [c[1:3] for c in DIVMOD_CASES]
    rand = [int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256))
            for _ in range(2 * P_MAIN)]
    n = P_MAIN - len(edge) - len(cases)
    a_vals = edge + [x for x, _ in cases] + rand[:n]
    b_vals = [0, 0, 3, M, M, 1, (1 << 255), 0] + [d for _, d in cases] + rand[P_MAIN:P_MAIN + n]
    # SDIV overflow: -2^255 / -1
    a_vals[-1], b_vals[-1] = 1 << 255, M
    a, b = words_tensor(a_vals, dev), words_tensor(b_vals, dev)
    q, r = kernels.divmod_u256(a, b)
    qp, rp = u256.divmod_u(a, b)
    err = max(max_abs_err(q, qp), max_abs_err(r, rp))
    # SDIV as the step does it: signs stripped around the kernel's unsigned
    # division and put back, against the plain signed division
    aa, na = u256.abs_signed(a)
    ab, nb = u256.abs_signed(b)
    qa, _ = kernels.divmod_u256(aa, ab)
    sd = torch.where(u256.is_zero(b)[:, None], 0,
                     torch.where((na != nb)[:, None], u256.neg(qa), qa))
    err = max(err, max_abs_err(sd, u256.sdiv(a, b)))
    # python ints as the final word on every lane
    for i, (x, y, gq, gr) in enumerate(zip(a_vals, b_vals, u256.to_ints(q), u256.to_ints(r))):
        if (gq, gr) != ((x // y, x % y) if y else (0, 0)):
            fail(f"K1 lane {i} ({x}, {y}) disagrees with Python ints")
    this = lambda: kernels.divmod_u256(a, b)
    ms = time_ms(this, 50)
    print(f"[3] divmod_u256: {len(cases)} rare-branch cases bit-exact; {ms:.4f} ms, device "
          f"{kernel_device_ms(this, 'divmod_u256_kernel', 20):.4f} ms", flush=True)
    if parent_lib is not None:
        old = lambda: u256_call(parent_lib.divmod_u256, dev, [a, b], [a.shape, a.shape])
        if any(not torch.equal(x, y) for x, y in zip(old(), (q, r))):
            fail("K1: the parent's K1 disagrees")
        turns("divmod_u256", "divmod_u256_kernel", this, old, 50)
    plain_ms = time_ms(lambda: u256.divmod_u(a, b), 2)
    nbytes = 4 * P_MAIN * 8 * 8  # a, b in; q, r out (int64 carriers)
    ops = sum(longdiv_ops(x, y) for x, y in zip(a_vals, b_vals))
    return dict(name="divmod_u256", source="mythril_tpu_torch/kernels/csrc/u256_divmod.cu",
                replaces="mythril_tpu/ops/u256.py:310", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


def check_k2(dev, rng, parent_lib=None):
    """K2 at P = 2048, L = 200 (random lengths and the padding edges,
    random bytes past each message) and on CREATE2's 85-byte rows (rows
    that start mid-word, the buffer's last word straddling its end, and the
    same rows in a buffer one byte past an aligned start), against its
    plain version and the host keccak; with ``--parent-k6 SRC`` timed
    against the parent tree's K2 in turns."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import keccak, u256

    L = 200
    data = rng.integers(0, 256, (P_MAIN, L), dtype=np.uint8)
    lens = rng.integers(0, L + 1, P_MAIN).astype(np.int32)
    edge = [0, 1, 31, 32, 135, 136, 137, 199, 200, 64]
    lens[:len(edge)] = edge
    d = torch.as_tensor(data, device=dev)
    n = torch.as_tensor(lens, device=dev)
    out = kernels.keccak256(d, n)
    err = max_abs_err(out, keccak.keccak256_plain(d, n))
    # CREATE2's rows (0xff ++ deployer ++ salt ++ keccak(init)): 85 bytes
    xr = np.random.default_rng(20261019)
    c2 = xr.integers(0, 256, (P_MAIN, 85), dtype=np.uint8)
    c2_lens = np.full(P_MAIN, 85, np.int32)
    c2_lens[:6] = [0, 1, 7, 8, 9, 84]
    d2, n2 = torch.as_tensor(c2, device=dev), torch.as_tensor(c2_lens, device=dev)
    buf = torch.zeros(P_MAIN * 85 + 16, dtype=torch.uint8, device=dev)
    shifted = buf[1:1 + P_MAIN * 85].view(P_MAIN, 85)
    shifted.copy_(d2)
    out2 = kernels.keccak256(d2, n2)
    err = max(err, max_abs_err(out2, keccak.keccak256_plain(d2, n2)),
              max_abs_err(kernels.keccak256(shifted, n2), out2))
    got, got2 = out.cpu().numpy(), out2.cpu().numpy()
    for i in range(64):
        for rows, ln, g, what in ((data, lens, got, "L=200"), (c2, c2_lens, got2, "CREATE2")):
            if u256.to_int(g[i]) != keccak.keccak256_host_int(bytes(rows[i, :ln[i]])):
                fail(f"K2 {what} lane {i} (len {ln[i]}) disagrees with the host keccak")
    this = lambda: kernels.keccak256(d, n)
    ms = time_ms(this, 50)
    print(f"[3] keccak256: L=200 and CREATE2's 85-byte rows (aligned and shifted) bit-exact; "
          f"{ms:.4f} ms, device {kernel_device_ms(this, 'keccak256_kernel', 20):.4f} ms; "
          f"CREATE2 rows device "
          f"{kernel_device_ms(lambda: kernels.keccak256(d2, n2), 'keccak256_kernel', 20):.4f} ms",
          flush=True)
    if parent_lib is not None:
        stream = torch.cuda.current_stream(dev).cuda_stream
        old = lambda: kernels.keccak256_call(parent_lib.keccak256, stream, d, n)
        if not torch.equal(old(), out):
            fail("K2: the parent's K2 disagrees")
        turns("keccak256", "keccak256_kernel", this, old, 50)
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
    # counts the scan those steady-state launches need. As the engine's
    # loop calls it: through a descriptor bound to the tape once
    ids_s, _ = append_node_plain(*tp, *inputs)
    tk = fresh_tape()
    k3 = kernels.TapeAppend.on_card(dev)
    ms = time_ms(lambda: kernels.tape_append(*tk, *inputs, k3=k3), 50)
    standalone_ms = time_ms(lambda: kernels.tape_append(*tk, *inputs), 50)
    device_ms = kernel_device_ms(lambda: kernels.tape_append(*tk, *inputs, k3=k3),
                                 "append_kernel", 20)
    print(f"[3] tape_append: {ms:.4f} ms through the loop's descriptor, {standalone_ms:.4f} "
          f"ms with a descriptor of its own, {device_ms:.4f} ms on the device", flush=True)
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


def group_tape(dev, rng, P, T):
    """A random tape for K3's group checks: row 0 the null row, lengths in
    [14, T - 2), lanes 0 and 1 two rows short of full (a group of fresh
    rows overflows in its middle). -> [tape_op, tape_a, tape_b, tape_imm,
    tape_hash, tape_len] on ``dev``."""
    import torch
    from mythril_tpu_torch.symbolic.state import tape_row_hash, hash_bits

    op = rng.integers(1, 29, (P, T)).astype(np.int32)
    a = rng.integers(0, 64, (P, T)).astype(np.int32)
    b = rng.integers(0, 64, (P, T)).astype(np.int32)
    imm = np.zeros((P, T, 8), dtype=np.int64)
    imm[:, :, 0] = rng.integers(0, 4, (P, T))
    op[:, 0] = a[:, 0] = b[:, 0] = 0
    imm[:, 0] = 0
    tlen = rng.integers(14, T - 2, P).astype(np.int32)
    tlen[:2] = T - 2
    tape = [torch.as_tensor(x, device=dev) for x in (op, a, b, imm)]
    return tape + [hash_bits(tape_row_hash(*tape)), torch.as_tensor(tlen, device=dev)]


def group_cases(dev, rng, tape):
    """K3's group edge cases on a tape of :func:`group_tape`: a list of
    (name, tape, [op, a, b, a_src, b_src, imm, mask]), ``[P, R]`` tensors
    (imm ``[P, R, 8]``) on ``dev``, each case on a copy of the tape:

    - chain: the engine's SHA3 chain (seed, 8 absorbs on the chain so far,
      digest), with rows masked off mid-chain (windows shorter than 8
      words) and lanes with no chain;
    - binop: the engine's CONST, CONST, node, with unary lanes and zero
      constants;
    - repeat: rows that repeat an earlier row of their group, literally
      and through the same reference, and a row already on the tape;
    - collision: a live row of some lanes carries the fingerprint of the
      group's first row with other content (a missed dedup);
    - random: 16 rows of few distinct values, random masks, sources in and
      out of [0, r) (an out-of-range source takes the literal).

    In every case lanes 2 and 3 append nothing, and lanes 0 and 1 append
    their rows, which overflow mid-group unless a row happens to be on
    the random tape already."""
    import torch
    from mythril_tpu_torch.symbolic.ops import SymOp
    from mythril_tpu_torch.symbolic.state import tape_row_hash, hash_bits

    P, T = tape[0].shape
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def words(shape, p_zero=0.0):
        w = rng.integers(0, 1 << 32, shape + (8,), dtype=np.int64)
        w[rng.random(shape) < p_zero] = 0
        return w

    def case(name, op, a, b, a_src, b_src, imm, mask, case_tape=None):
        mask = mask.copy()
        mask[:2] = True
        mask[2:4] = False
        return (name, [x.clone() for x in (case_tape or tape)],
                [t(op.astype(np.int32)), t(a.astype(np.int32)), t(b.astype(np.int32)),
                 t(a_src.astype(np.int32)), t(b_src.astype(np.int32)), t(imm), t(mask)])

    rows = lambda vals: np.broadcast_to(np.asarray(vals, np.int32), (P, len(vals)))
    cases = []
    # chain
    R, ncw = 10, 8
    m_chain = rng.random(P) < 0.85
    nw = rng.integers(0, ncw + 1, P)
    m_chain[:2], nw[:2] = True, ncw
    mask = np.zeros((P, R), bool)
    mask[:, 0] = mask[:, -1] = m_chain
    mask[:, 1:-1] = m_chain[:, None] & (np.arange(ncw)[None, :] < nw[:, None])
    b = np.zeros((P, R), np.int32)
    b[:, 1:-1] = rng.integers(1, 40, (P, ncw)) * (rng.random((P, ncw)) < 0.5)
    imm = np.zeros((P, R, 8), np.int64)
    imm[:, 0, 0] = rng.integers(1, 201, P)
    imm[:, 0, 1] = rng.integers(0, 32, P)
    imm[:, 1:-1] = np.where((b[:, 1:-1] == 0)[..., None], words((P, ncw)), 0)
    cases.append(case("chain", rows([int(SymOp.KECCAK_SEED)] + [int(SymOp.KECCAK_ABS)] * ncw
                                    + [int(SymOp.KECCAK)]), np.zeros((P, R)), b,
                      rows([-1] + list(range(ncw + 1))), rows([-1] * R), imm, mask))
    # binop
    node = rng.choice([3, 4, 5, 6, 12, 16, 17, 18, 21], P)
    unary = np.isin(node, [17, 21])
    s0 = rng.integers(1, 40, P) * (rng.random(P) < 0.5)
    s1 = rng.integers(1, 40, P) * (rng.random(P) < 0.5)
    a0, a1 = words((P,), 0.3), words((P,), 0.3)
    m_node = rng.random(P) < 0.85
    m_node[:2] = True
    need_a = m_node & (s0 == 0) & a0.any(axis=1)
    need_b = m_node & ~unary & (s1 == 0) & a1.any(axis=1)
    cases.append(case(
        "binop", np.stack([np.ones(P), np.ones(P), node], 1),
        np.stack([s0, np.where(unary, 0, s1), np.zeros(P)], 1), np.zeros((P, 3)),
        rows([-1, -1, 0]), rows([-1, -1, 1]), np.stack([a0, a1, np.zeros_like(a0)], 1),
        np.stack([need_a, need_b, m_node], 1)))
    # repeat: rows 1 and 3 repeat rows 0 and 2, row 4 a live row of the tape
    R = 6
    t_op, t_a, t_b, t_imm = (x.cpu().numpy() for x in tape[:4])
    old = rng.integers(1, 14, P)
    lanes = np.arange(P)
    op = rows([29, 29, 30, 30, 0, 31]).copy()
    a = np.stack([rng.integers(0, 1 << 20, P)] * 2 + [np.zeros(P)] * 2
                 + [t_a[lanes, old], np.zeros(P)], 1)
    b = np.stack([rng.integers(0, 64, P)] * 2 + [rng.integers(0, 64, P)] * 2
                 + [t_b[lanes, old], np.zeros(P)], 1)
    op[:, 4] = t_op[lanes, old]
    imm = np.zeros((P, R, 8), np.int64)
    imm[:, 0] = imm[:, 1] = words((P,))
    imm[:, 2] = imm[:, 3] = words((P,))
    imm[:, 4] = t_imm[lanes, old]
    cases.append(case("repeat", op, a, b, rows([-1, -1, 0, 1, -1, 3]),
                      rows([-1, -1, -1, -1, -1, 4]), imm, rng.random((P, R)) < 0.9))
    # collision: row 5 of lanes 4 .. P/2 carries row 0's fingerprint
    R = 4
    op = rows([29, 30, 31, 29]).copy()
    a = rng.integers(0, 1 << 20, (P, R))
    b = rng.integers(0, 64, (P, R))
    imm = words((P, R), 0.5)
    forged = [x.clone() for x in tape]
    h0 = hash_bits(tape_row_hash(*(torch.as_tensor(x) for x in (op[:, 0], a[:, 0], b[:, 0],
                                                                 imm[:, 0]))))
    forged[4][4:P // 2, 5] = h0[4:P // 2].to(dev)
    cases.append(case("collision", op, a, b, rows([-1] * R), rows([-1] * R), imm,
                      rng.random((P, R)) < 0.9, forged))
    # random
    R = 16
    imm = np.zeros((P, R, 8), np.int64)
    imm[:, :, 0] = rng.integers(0, 2, (P, R))
    cases.append(case("random", rng.integers(29, 32, (P, R)), rng.integers(0, 4, (P, R)),
                      rng.integers(0, 4, (P, R)), rng.integers(-2, R + 2, (P, R)),
                      rng.integers(-2, R + 2, (P, R)), imm, rng.random((P, R)) < 0.7))
    return cases


def check_k3_group(dev, rng):
    """K3's group entry point against its plain version (R sequential
    plain appends) on every case of :func:`group_cases` at P = 2048, T =
    512; timed on the chain (the SHA3 chain's 10 rows, the main path's
    larger group) through a descriptor bound once."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import append_group_plain

    P, T = P_MAIN, DEFAULT_LIMITS.tape_len
    base = group_tape(dev, rng, P, T)
    err, chain = 0, None
    for name, tape, inputs in group_cases(dev, rng, base):
        tk, tp = [x.clone() for x in tape], [x.clone() for x in tape]
        out_k, ovf_k = kernels.tape_append_group(*tk, *inputs)
        out_p, ovf_p = append_group_plain(*tp, *inputs)
        e = max(max_abs_err(out_k, out_p), max_abs_err(ovf_k, ovf_p),
                *(max_abs_err(x, y) for x, y in zip(tk, tp)))
        mask = inputs[6]
        # lanes 0 and 1 overflow unless a row of theirs happens to be on the
        # random tape already
        if not (bool(ovf_k[:2].any()) and not bool(ovf_k[2:4].any())
                and bool((tk[5][2:4] == tape[5][2:4]).all())):
            fail(f"K3 group {name}: an overflow of lane 0 or 1, or nothing appended on "
                 "the masked-off lanes 2 and 3, did not show")
        print(f"[3] tape_append_group {name}: max_abs_err {e}; R = {mask.shape[1]}, "
              f"{int(mask.sum())} rows masked in, {int((tk[5] - tape[5]).sum())} appended, "
              f"{int(ovf_k.sum())} lanes overflowed", flush=True)
        err = max(err, e)
        if name == "chain":
            chain = (tape, inputs)
    # timed on one tape (after the first launch every row is a dedup hit or
    # an overflow), as the engine's loop calls it: a descriptor bound once
    tape, inputs = chain
    tk, tp = [x.clone() for x in tape], [x.clone() for x in tape]
    append_group_plain(*tp, *inputs)
    out_s, _ = append_group_plain(*tp, *inputs)
    k3 = kernels.TapeAppend.on_card(dev)
    ms = time_ms(lambda: kernels.tape_append_group(*tk, *inputs, k3=k3), 50)
    device_ms = kernel_device_ms(lambda: kernels.tape_append_group(*tk, *inputs, k3=k3),
                                 "group_kernel", 20)
    print(f"[3] tape_append_group chain: {ms:.4f} ms through the loop's descriptor, "
          f"{device_ms:.4f} ms on the device ({inputs[0].shape[1]} rows a lane)", flush=True)
    plain_ms = time_ms(lambda: append_group_plain(*tp, *inputs), 5)
    # bytes: per masked-in row the fingerprints its scan reads up to the
    # first match (or the live tape), the verified row; per row the inputs
    # and the output; per lane its length and flag
    mask = inputs[6]
    hit_rows = torch.where(out_s > 0, out_s + 1, tp[5][:, None])
    scanned = int(torch.where(mask, hit_rows, 0).sum().item()) * 4
    nbytes = (scanned + int(mask.sum()) * (3 * 4 + 64)
              + mask.numel() * (5 * 4 + 64 + 1 + 4) + P * (4 + 1))
    return dict(name="tape_append_group", source="mythril_tpu_torch/kernels/csrc/tape_append.cu",
                replaces="mythril_tpu/symbolic/engine.py:84", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=0)


def k4_takes_mask(path) -> bool:
    """Whether the K4 source at ``path`` has the lane mask in its C entry
    point (the parent tree's K4 before it had one argument less)."""
    import re

    with open(path) as fh:
        entry = re.search(r'extern "C" int sha256\(([^)]*)\)', fh.read())
    return entry is not None and "mask" in entry.group(1)


def parent_sha256(lib, dev):
    """The parent tree's K4 as ``fn(data, length) -> int64[P, 8]``: its C
    entry point with the lane mask (passed none) or, before it had one
    (``lib.masked`` False: ``k4_takes_mask``), ``sha256(data, len, out,
    P, N, stream)``."""
    import ctypes

    import torch
    from mythril_tpu_torch import kernels

    stream = torch.cuda.current_stream(dev).cuda_stream
    if lib.masked:
        return lambda data, length: kernels.sha256_call(lib.sha256, stream, data, length)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sha256.argtypes, lib.sha256.restype = [vp, vp, vp, ci, ci, vp], ci

    def call(data, length):
        out = torch.empty((data.shape[0], 8), dtype=torch.int64, device=dev)
        if lib.sha256(data.data_ptr(), length.data_ptr(), out.data_ptr(), data.shape[0],
                      data.shape[1], stream):
            fail("the parent's K4 launch failed")
        return out

    return call


# lanes K4 is timed at on the precompile path: the engine's few lanes
K4_PATH_LANES = (1, 4)


def check_k4(dev, rng, parent_lib=None):
    """K4 at P = 2048 over the 448-byte precompile window (random lengths
    and the padding edges, random bytes past each message) against its
    plain version and hashlib; its lane mask (the engine's entry point)
    against the plain version on the selected lanes; the same rows shifted
    off a 16-byte boundary (the body's byte-wise reads). Times the whole
    batch and the precompile path at ``K4_PATH_LANES`` lanes of it: the
    masked launch the engine makes now beside the compacted route it made
    before (index, gather, launch, zeros, scatter: ``engine._compacted``),
    each with events and on the device. With ``--parent-k6 SRC`` the
    parent tree's K4 in turns, on the whole batch and through the
    compacted route."""
    import hashlib

    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import sha256, u256
    from mythril_tpu_torch.symbolic import engine

    N = 448  # the precompile input window (PRE_IN_CAP)
    data = rng.integers(0, 256, (P_MAIN, N), dtype=np.uint8)
    lens = rng.integers(0, N + 1, P_MAIN).astype(np.int32)
    edge = [0, 1, 55, 56, 63, 64, 119, 120, 447, 448]
    lens[:len(edge)] = edge
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
    xr = np.random.default_rng(20261020)
    mask = torch.as_tensor(xr.random(P_MAIN) < 0.3, device=dev)
    masked = torch.where(mask[:, None], plain, 0)
    buf = torch.zeros(P_MAIN * N + 16, dtype=torch.uint8, device=dev)
    shifted = buf[4:4 + P_MAIN * N].view(P_MAIN, N)
    shifted.copy_(d)
    err = max(err, max_abs_err(kernels.sha256(d, n, mask), masked),
              max_abs_err(sha256.sha256_lanes(d, n, mask), masked),
              max_abs_err(kernels.sha256(shifted, n), plain))
    this = lambda: kernels.sha256(d, n)
    ms = time_ms(this, 50)
    print(f"[3] sha256: {P_MAIN} lanes, the lane mask and the shifted rows bit-exact; "
          f"{ms:.4f} ms, device {kernel_device_ms(this, 'sha256_kernel', 20):.4f} ms", flush=True)
    old_fn = None if parent_lib is None else parent_sha256(parent_lib, dev)
    if old_fn is not None:
        if not torch.equal(old_fn(d, n), out):
            fail("K4: the parent's K4 disagrees")
        turns("sha256", "sha256_kernel", this, lambda: old_fn(d, n), 50)
    for k in K4_PATH_LANES:
        lanes = np.sort(xr.choice(P_MAIN, k, replace=False))
        sel = np.zeros(P_MAIN, bool)
        sel[lanes] = True
        m = torch.as_tensor(sel, device=dev)
        want = torch.where(m[:, None], plain, 0)
        routes = {"masked": lambda: sha256.sha256_lanes(d, n, m),
                  "compacted": lambda: engine._compacted(sel, sha256.sha256_device, P_MAIN, dev,
                                                         d, n)}
        if old_fn is not None:
            routes["compacted, the parent's K4"] = lambda: engine._compacted(
                sel, old_fn, P_MAIN, dev, d, n)
        for name, fn in routes.items():
            if not torch.equal(fn(), want):
                fail(f"K4 at {k} lane(s), {name}: disagrees with the plain version")
        t = {name: (time_ms(fn, 50), kernel_device_ms(fn, "sha256_kernel", 20))
             for name, fn in routes.items()}
        print(f"[3] sha256 on the precompile path at {k} lane(s) of {P_MAIN} (lengths "
              f"{lens[lanes].tolist()}): " + "; ".join(
                  f"{name} {a:.4f} ms, device {b:.4f} ms" for name, (a, b) in t.items()),
              flush=True)
        if old_fn is not None:
            turns(f"sha256 path at {k} lane(s) (this: masked; parent: compacted)",
                  "sha256_kernel", routes["masked"], routes["compacted, the parent's K4"], 50)
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
             (9, M, 1 << 100),
             # a table build that needs Barrett's third correction
             (115493631320220615308982905887737156535199793741578743490086311965284643747319,
              5, 57896044618658097711785492504343953926751871052829057858986680950883660023585)]
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


def check_k5(dev, rng, parent_lib=None):
    """K5 at the main path's compacted shape (one lane, a full-width
    exponent and modulus) and at 64 lanes of edge and random operands,
    against its plain version and Python's pow; timed at both, and with
    ``--parent-k6 SRC`` against the parent tree's K5 on the same inputs in
    turns (parent, this, this, parent)."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    cases = modexp_cases(rng)
    sizes = {1: [cases[6]], MODEXP_LANES: cases}
    err, out = 0, {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n, cs in sizes.items():
        b, e, m = (words_tensor([c[i] for c in cs], dev) for i in range(3))
        got = kernels.modexp_u256(b, e, m)
        err = max(err, max_abs_err(got, u256.modexp_plain(b, e, m)))
        host = got.cpu().numpy()
        for i, (x, y, z) in enumerate(cs):
            if u256.to_int(host[i]) != (pow(x, y, z) if z else 0):
                fail(f"K5 at {n} lanes: lane {i} disagrees with pow")
        this = lambda: kernels.modexp_u256(b, e, m)
        out[n] = dict(ms=time_ms(this, 10), device_ms=kernel_device_ms(this, "modexp_kernel", 5),
                      bound_ms=modexp_ops(cs) / INT32_OPS_PER_S * 1e3)
        if parent_lib is not None:
            old = lambda: kernels.modexp_call(parent_lib.modexp_u256, stream, b, e, m)
            if not torch.equal(old(), got):
                fail(f"K5 at {n} lanes: the parent's K5 disagrees")
            out[n]["turns"] = [time_ms(f, 10) for f in (old, this, this, old)]
            out[n]["parent_device_ms"] = kernel_device_ms(old, "modexp_kernel", 5)
        print(f"[3] modexp_u256 at {n} lane(s): bit-exact to modexp_plain and pow; "
              f"{json.dumps(out[n])}", flush=True)
    b, e, m = (words_tensor([c[i] for c in cases], dev) for i in range(3))
    plain_ms = time_ms(lambda: u256.modexp_plain(b, e, m), 1)
    nbytes = 4 * MODEXP_LANES * 8 * 8
    return dict(name="modexp_u256", source="mythril_tpu_torch/kernels/csrc/u256_modexp.cu",
                replaces="mythril_tpu/ops/u256.py:408", max_abs_err=err,
                ms=out[MODEXP_LANES]["ms"], plain_ms=plain_ms, nbytes=nbytes,
                ops=modexp_ops(cases))


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
    err = max(max_abs_err(lo, u256.mul(a, b)), max_abs_err(wide, u256.mul_wide(a, b)))
    M = (1 << 256) - 1
    got_lo = u256.to_ints(lo)
    got_wide = [x | (y << 256) for x, y in zip(u256.to_ints(wide[:, :8]),
                                               u256.to_ints(wide[:, 8:]))]
    for i, (x, y) in enumerate(zip(a_v, b_v)):
        if got_lo[i] != (x * y) & M or got_wide[i] != x * y:
            fail(f"K8 lane {i} disagrees with Python ints")
    ms = time_ms(lambda: kernels.mul_u256(a, b, "low"), 50)
    plain_ms = time_ms(lambda: u256.mul(a, b), 10)
    print(f"[3] mul_u256 wide: {time_ms(lambda: kernels.mul_u256(a, b, 'wide'), 50):.4f} ms",
          flush=True)
    # a, b in and the low product out (int64 carriers); 64 multiply-adds
    # of 4 operations per lane
    return dict(name="mul_u256", source="mythril_tpu_torch/kernels/csrc/u256_mul.cu",
                replaces="mythril_tpu/ops/u256.py:261", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=P_MAIN * 3 * 64, ops=P_MAIN * 64 * 4)


def check_k9(dev, rng, parent_lib=None):
    """K9's mod_wide (MULMOD's 512-bit products and ADDMOD's 257-bit sums)
    and exp at P = 2048: K8's edge and random words, with the rare
    branches of the division core and EXP's fast paths and their
    neighbours (``MODWIDE_CASES``, ``EXP_CASES``) in the last lanes,
    against the plain versions and Python's ints; with ``--parent-k6 SRC``
    both timed against the parent tree's K9 in turns."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.ops import u256

    a_v, b_v, m_v, e_v = product_words(rng)
    ncase = len(MODWIDE_CASES)
    a_v[-ncase:] = [c[1] for c in MODWIDE_CASES]
    b_v[-ncase:] = [c[2] for c in MODWIDE_CASES]
    m_v[-ncase:] = [c[3] for c in MODWIDE_CASES]
    add_lanes = [P_MAIN - ncase + i for i, c in enumerate(MODWIDE_CASES) if c[4] == "addmod"]
    x_v = list(a_v)
    x_v[-len(EXP_CASES):] = [c[1] for c in EXP_CASES]
    e_v[-len(EXP_CASES):] = [c[2] for c in EXP_CASES]
    a, b, m, e, x0 = (words_tensor(v, dev) for v in (a_v, b_v, m_v, e_v, x_v))
    wide = u256.mul_wide(a, b)
    # the ADDMOD cases' lanes take the 257-bit sum
    s, c = u256.add_carry(a, b)
    wide_add = torch.cat([s, c.to(s.dtype)[:, None], torch.zeros_like(s)[:, :7]], dim=1)
    lanes = torch.tensor(add_lanes, device=dev)
    wide[lanes] = wide_add[lanes]
    r = kernels.mod_wide_u256(wide, m)
    err_mod = max_abs_err(r, u256._mod_wide(wide, m))
    x = kernels.exp_u256(x0, e)
    err_exp = max_abs_err(x, u256.exp(x0, e))
    got_r, got_x = u256.to_ints(r), u256.to_ints(x)
    for i in range(P_MAIN):
        w = a_v[i] + b_v[i] if i in add_lanes else a_v[i] * b_v[i]
        if got_r[i] != (w % m_v[i] if m_v[i] else 0):
            fail(f"K9 mod_wide lane {i} disagrees with Python ints")
        if got_x[i] != pow(x_v[i], e_v[i], 1 << 256):
            fail(f"K9 exp lane {i} disagrees with Python ints")
    # ADDMOD's 9-limb sums of every lane through the same entry point
    err_mod = max(err_mod, max_abs_err(kernels.mod_wide_u256(wide_add, m),
                                       u256._mod_wide(wide_add, m)))
    this_mod = lambda: kernels.mod_wide_u256(wide, m)
    this_exp = lambda: kernels.exp_u256(x0, e)
    ms_mod, ms_exp = time_ms(this_mod, 20), time_ms(this_exp, 20)
    print(f"[3] mod_wide_u256 / exp_u256: {ncase} / {len(EXP_CASES)} rare-branch cases "
          f"bit-exact; {ms_mod:.4f} / {ms_exp:.4f} ms, device "
          f"{kernel_device_ms(this_mod, 'mod_wide_kernel', 20):.4f} / "
          f"{kernel_device_ms(this_exp, 'exp_kernel', 20):.4f} ms", flush=True)
    if parent_lib is not None:
        old_mod = lambda: u256_call(parent_lib.u256_mod_wide, dev, [wide, m], [m.shape])[0]
        old_exp = lambda: u256_call(parent_lib.u256_exp, dev, [x0, e], [e.shape])[0]
        if not torch.equal(old_mod(), r) or not torch.equal(old_exp(), x):
            fail("K9: the parent's K9 disagrees")
        turns("mod_wide_u256", "mod_wide_kernel", this_mod, old_mod, 20)
        turns("exp_u256", "exp_kernel", this_exp, old_exp, 20)
    plain_mod = time_ms(lambda: u256._mod_wide(wide, m), 1)
    plain_exp = time_ms(lambda: u256.exp(x0, e), 1)
    # the remainder of each lane's 512-bit product (or 257-bit sum) by its
    # m; each lane's EXP as much as its operands need (``exp_ops``)
    mod_ops = sum(longdiv_ops(x + y if i in add_lanes else x * y, z)
                  for i, (x, y, z) in enumerate(zip(a_v, b_v, m_v)))
    ops_exp = sum(exp_ops(b, v) for b, v in zip(x_v, e_v))
    paths = [exp_path(b, v) for b, v in zip(x_v, e_v)]
    got_paths = exp_path_index(x0, e).tolist()
    if [EXP_PATHS[i] for i in got_paths] != paths:
        fail("exp_path_index disagrees with exp_path on K9's exp lanes")
    # the earlier count (every lane a full chain of 36-product steps),
    # printed beside the bound for comparison only
    ops_pr4 = sum(square_multiply_steps(v) for v in e_v) * 36 * 4
    print(f"[3] exp_u256 lanes by exp8's path: "
          f"{json.dumps({p: paths.count(p) for p in EXP_PATHS})}; operations bound "
          f"{ops_exp / INT32_OPS_PER_S * 1e3:.7f} ms (full-chain count: "
          f"{ops_pr4 / INT32_OPS_PER_S * 1e3:.7f} ms)", flush=True)
    src = "mythril_tpu_torch/kernels/csrc/u256_mulmod_exp.cu"
    return [dict(name="mod_wide_u256", source=src, replaces="mythril_tpu/ops/u256.py:372",
                 max_abs_err=err_mod, ms=ms_mod, plain_ms=plain_mod,
                 nbytes=P_MAIN * (128 + 64 + 64), ops=mod_ops),
            dict(name="exp_u256", source=src, replaces="mythril_tpu/ops/u256.py:436",
                 max_abs_err=err_exp, ms=ms_exp, plain_ms=plain_exp,
                 nbytes=P_MAIN * 3 * 64, ops=ops_exp)]


def sweep_snapshot(dev):
    """A real frontier just before a sweep: the 32-contract batch (16 x
    ERC-20, 16 x arith) after 20 supersteps with no sweep, at the default
    limits (P = 2048, T = 512, 128 constraint slots). -> (sym frontier,
    env, corpus)."""
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
    env = make_env(P_MAIN, device=dev)
    sf = sym_run(sf, env, corpus, SymSpec(), DEFAULT_LIMITS, max_steps=20, propagate_every=0)
    torch.cuda.synchronize()
    return sf, env, corpus


def random_tapes(dev, rng, P=P_MAIN, limits=None):
    """Random tapes holding every op at P lanes (default P = 2048, the
    default limits: T = 512), with random starting domains, prop_len and
    constraints, as a SymFrontier on ``dev``. Operands are drawn from
    [-1, idx + 2]: self and forward references and clipped ids occur."""
    import torch
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic import make_sym_frontier

    L = limits or DEFAULT_LIMITS
    T, C = L.tape_len, L.max_constraints
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


# the libraries whose ptxas lines phase 3 prints
PTXAS_SOURCES = ("propagate_sweep", "tape_append", "u256_modexp", "fork_plan", "u256_divmod",
                 "u256_mulmod_exp", "keccak256", "sha256", "evm_step")
# a parent tree's libraries built beside this tree's under --parent-k6
PARENT_SOURCES = ("propagate_sweep", "u256_modexp", "u256_divmod", "u256_mulmod_exp",
                  "keccak256", "sha256", "evm_step")
# the kernels that must have no stack frame and no spill
NO_STACK = (("K1", "u256_divmod"), ("K2", "keccak256"), ("K4", "sha256"), ("K5", "u256_modexp"),
            ("K9", "u256_mulmod_exp"))
# the most stack K10's entry points may have (bytes): the frame its handlers need
K10_MAX_STACK = 240


def ptxas_frames(lines) -> dict:
    """{function: (stack frame, spill stores, spill loads) bytes} from
    ptxas's lines."""
    import re

    out, fn = {}, None
    for ln in lines:
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        elif "stack frame" in ln and fn:
            out[fn] = tuple(int(x) for x in re.findall(r"(\d+) bytes", ln))
            fn = None
    return out


def ptxas_builds(parent_src=None):
    """This tree's K1-K7, K9 and K10 sources and, with ``--parent-k6 SRC``,
    the parent tree's K6 (SRC, in a copy of that tree's ``csrc/``) and its
    K5, K1, K9, K2, K4 and K10 (``u256_modexp.cu``, ``u256_divmod.cu``,
    ``u256_mulmod_exp.cu``, ``keccak256.cu``, ``sha256.cu``,
    ``evm_step.cu`` beside it), built with nvcc and ``-Xptxas=-v`` into a
    temporary directory, all at once. ptxas must report no stack frame and
    no spill for K1, K2, K4, K5 and K9 (``NO_STACK``), and for K10's entry
    points no spill and no frame above ``K10_MAX_STACK`` bytes. Prints
    ptxas's register and spill lines. -> {parent build: its library}."""
    import ctypes
    import tempfile

    from mythril_tpu_torch import kernels

    nvcc = kernels._nvcc()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    csrc = os.path.join(ROOT, "mythril_tpu_torch", "kernels", "csrc")
    srcs = {name: os.path.join(csrc, f"{name}.cu") for name in PTXAS_SOURCES}
    if parent_src:
        pdir = os.path.dirname(os.path.abspath(parent_src))
        for name in PARENT_SOURCES:
            srcs[f"parent {name}"] = os.path.join(pdir, f"{name}.cu")
    procs = {name: subprocess.Popen(
        [nvcc, "-Xptxas=-v", *kernels.NVCC_FLAGS, "-o",
         os.path.join(tmp, name.replace(" ", "_") + ".so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, src in srcs.items()}
    logs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc {srcs[name]}:\n{out[-3000:]}")
        logs[name] = [ln.strip() for ln in out.splitlines()
                      if "entry function" in ln or "Function properties" in ln or "spill" in ln
                      or "Used" in ln]
        for ln in logs[name]:
            print(f"[3] ptxas {name}: {ln}", flush=True)
    for k, name in NO_STACK:
        frames = ptxas_frames(logs[name])
        if not frames or any(f != (0, 0, 0) for f in frames.values()):
            fail(f"{k}: ptxas reports a stack frame or spills: {frames}")
    k10 = ptxas_frames(logs["evm_step"])
    if not k10 or any(st or ld for _, st, ld in k10.values()):
        fail(f"K10: ptxas reports spills (stack frame, spill stores, spill loads): {k10}")
    if any(frame > K10_MAX_STACK for frame, _, _ in k10.values()):
        fail(f"K10: a stack frame above {K10_MAX_STACK} bytes: {k10}")

    def bind_parent_sha256(lib):
        lib.masked = k4_takes_mask(srcs["parent sha256"])
        if lib.masked:
            kernels.bind_sha256(lib)

    binders = {"propagate_sweep": kernels.bind_propagate_sweep, "u256_modexp": kernels.bind_modexp,
               "u256_divmod": kernels.bind_divmod, "u256_mulmod_exp": kernels.bind_mulmod_exp,
               "keccak256": kernels.bind_keccak256, "sha256": bind_parent_sha256,
               "evm_step": kernels.bind_evm_step}
    libs = {}
    for name in srcs:
        if name.startswith("parent "):
            lib = ctypes.CDLL(os.path.join(tmp, name.replace(" ", "_") + ".so"))
            binders[name[len("parent "):]](lib)
            libs[name] = lib
    return libs


def argv_value(flag: str):
    """The value after ``flag`` on the command line, or None."""
    return sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv[:-1] else None


def check_k6(dev, rng, parent_lib=None):
    """K6 against its plain version on random tapes and on a real
    frontier; timed on both, and with ``--parent-k6 SRC`` against the
    parent tree's K6 on the same inputs in turns (parent, this, this,
    parent)."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.symbolic.propagate import propagate_feasibility_plain

    err = 0
    tapes = {"random tapes": random_tapes(dev, rng), "batch snapshot": sweep_snapshot(dev)[0]}
    for what, sf in tapes.items():
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

    def launcher(sf, fn=None):
        args = _sweep_args(sf)
        pl0 = sf.prop_len.clone()
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch():
            args[5].copy_(pl0)  # every lane walks its new nodes each launch
            if fn is None:
                kernels.propagate_sweep(*args)
            else:
                kernels.sweep_call(fn, stream, *args)
        return launch

    if parent_lib is not None:
        for what, sf in tapes.items():
            this, old = launcher(sf), launcher(sf, parent_lib.propagate_sweep)
            turns = [time_ms(f, 10) for f in (old, this, this, old)]
            dev_ms = [kernel_device_ms(f, "sweep_kernel", 5) for f in (old, this)]
            print(f"[3] propagate_sweep {what}, the parent's K6 and this one on the same "
                  f"inputs in turns (parent, this, this, parent): "
                  f"{' / '.join(f'{x:.4f}' for x in turns)} ms; on the device parent "
                  f"{dev_ms[0]:.4f}, this {dev_ms[1]:.4f} ms", flush=True)
    # timed on random tapes (every lane walks its new nodes each launch)
    sf_r = random_tapes(dev, rng)
    launch = launcher(sf_r)
    ms = time_ms(launch, 10)
    snap_ms = time_ms(launcher(tapes["batch snapshot"]), 10)
    device_ms = kernel_device_ms(launch, "sweep_kernel", 5)
    print(f"[3] propagate_sweep: random tapes {ms:.4f} ms ({device_ms:.4f} on the device), "
          f"batch snapshot {snap_ms:.4f} ms", flush=True)
    # the plain sweep takes seconds here: one timed call, no warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pl0 = sf_r.prop_len.clone()
    start.record()
    done, _ = propagate_feasibility_plain(sf_r)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    nbytes, ops = sweep_work(sf_r, pl0, done)
    return dict(name="propagate_sweep", source="mythril_tpu_torch/kernels/csrc/propagate_sweep.cu",
                replaces="mythril_tpu/symbolic/propagate.py:57", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=nbytes, ops=ops)


def fork_frontier(dev, rng, P=None, limits=None):
    """A frontier mid-superstep for K7 at P lanes (default limits, the
    profiler attached): every lane-axis field seeded random bits, then
    live and free lanes, fork requests (JUMPI and call-enumeration),
    depths, parked counters, profiler rows, bounded-loops tables (a third
    of the lanes already hold the entry their copy will hit, counts up
    past the bound) and a coverage bitmap. -> (frontier, visited)."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic import make_sym_frontier

    L = limits or DEFAULT_LIMITS
    P = P or P_MAIN
    sf = make_sym_frontier(P, L, device=dev)
    sf = sf.replace(base=sf.base.attach_iprof())
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    for path in kernels.fork_rows(sf):
        t = kernels.fork_field(sf, path)
        if t.dtype == torch.bool:
            t.copy_(torch.rand(t.shape, generator=g, device=dev) < 0.5)
        else:
            hi = {torch.uint8: 256, torch.int32: 1 << 31}.get(t.dtype, 1 << 32)
            t.copy_(torch.randint(0, hi, t.shape, generator=g, device=dev, dtype=t.dtype))
    C, S, LBS = L.max_constraints, L.max_stack, L.loop_slots
    t = lambda x: torch.as_tensor(x, device=dev)
    pc = rng.integers(1, 3000, P).astype(np.int32)
    dest = rng.integers(-2, 3000, P).astype(np.int32)
    cid = rng.integers(0, 32, P).astype(np.int32)
    lb_len = rng.integers(0, LBS + 1, P).astype(np.int32)
    lb_key = rng.integers(0, 1 << 40, (P, LBS))
    lb_cnt = rng.integers(0, L.loop_bound + 2, (P, LBS)).astype(np.int32)
    hit = (rng.random(P) < 0.33) & (lb_len > 0)
    slot = (rng.random(P) * np.maximum(lb_len, 1)).astype(np.int64)
    lanes = np.nonzero(hit)[0]
    lb_key[lanes, slot[lanes]] = ((cid.astype(np.int64) * 32768 + dest) * 32768 + pc - 1)[lanes]
    b = sf.base
    base = dict(active=t(rng.random(P) < 0.6), pc=t(pc), contract_id=t(cid),
                sp=t(rng.integers(2, S - 2, P).astype(np.int32)),
                error=t(rng.random(P) < 0.05),
                err_code=t(np.where(rng.random(P) < 0.05, 3, 0).astype(np.int32)),
                gas_min=t(rng.integers(0, 1 << 40, P)),
                gas_max=t(rng.integers(1 << 40, 1 << 41, P)),
                op_hist=t(rng.integers(0, 50, (P, 256)).astype(np.int32)),
                op_resid=t(rng.integers(0, 9, 256).astype(np.int32)))
    rest = dict(fork_req=t(rng.random(P) < 0.7),
                con_len=t(rng.integers(1, C + 1, P).astype(np.int32)),
                fork_dest=t(dest), dropped_forks=t(rng.integers(0, 3, P).astype(np.int32)),
                fork_cslot=t(np.where(rng.random(P) < 0.3, rng.integers(-1, S + 2, P), -1)
                             .astype(np.int32)),
                fork_cval=t(rng.integers(0, 1 << 32, (P, 8))),
                call_enum=t(rng.integers(0, 4, P).astype(np.int32)),
                lb_key=t(lb_key), lb_cnt=t(lb_cnt), lb_len=t(lb_len))
    for k, v in base.items():
        getattr(b, k).copy_(v)
    for k, v in rest.items():
        getattr(sf, k).copy_(v)
    return sf, t(rng.random((32, 4096)) < 0.5)


def leaf_errs(got, want) -> dict:
    """max_abs_err of every tensor of two frontiers, by field path."""
    g, w = tensor_leaves(got), tensor_leaves(want)
    if set(g) != set(w):
        return {k: -1 for k in set(g) ^ set(w)}
    return {k: max_abs_err(g[k], w[k]) for k in w}


def restore(dst, src):
    """Every field K7 writes of ``dst`` set back to ``src``'s, in place."""
    from mythril_tpu_torch import kernels

    for path in kernels.FORK_EXTRA_PATHS + tuple(kernels.fork_rows(dst)):
        t = kernels.fork_field(dst, path)
        if t is not None:
            t.copy_(kernels.fork_field(src, path))


def check_k7(dev, rng):
    """K7, the whole in-place fork expansion through its descriptor, held
    field for field (every leaf) to the plain functional route on a
    P = 2048 frontier, for each policy, fork blocks of 64 lanes and of P,
    defer on and off, with the profiler and the bounded-loops policy; and
    once without either. Timed through the descriptor, each expansion on
    the frontier restored, and on the device alone."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import expand_forks_plain, own_fork_fields

    L = DEFAULT_LIMITS
    sf, vis = fork_frontier(dev, rng)
    k7 = kernels.ForkExpand.on_card(dev)
    err, copies = 0, []
    cases = [(policy, block, defer, L.loop_bound, True) for policy in kernels.FORK_POLICIES
             for block in (64, P_MAIN) for defer in (False, True)]
    cases.append(("fifo", P_MAIN, False, 0, False))
    for policy, block, defer, lb, iprof in cases:
        src = sf if iprof else sf.replace(base=sf.base.replace(op_hist=None, op_resid=None))
        got = k7.expand(own_fork_fields(src), block=block, policy=policy, defer=defer,
                        loop_bound=lb, visited=vis)
        copies.append(int(k7.count[0]))
        errs = leaf_errs(got, expand_forks_plain(src, lb, block, policy, defer, vis))
        bad = {k: v for k, v in errs.items() if v}
        if bad:
            print(f"[3] fork_plan {policy}/{block}/defer={defer}/loop_bound={lb}/iprof={iprof}: "
                  f"leaves differ from the plain route: {bad}", flush=True)
        err = max(err, *errs.values())
    print(f"[3] fork_plan: {len(cases)} cases, {len(tensor_leaves(sf))} leaves each, copies "
          f"{min(copies)}-{max(copies)}, every leaf equal to the plain functional route"
          if not err else "[3] fork_plan: leaves differ", flush=True)
    kw = dict(block=P_MAIN, policy="weighted", defer=True, loop_bound=L.loop_bound, visited=vis)
    own = k7.bind(own_fork_fields(sf))

    def expand():
        k7.expand(own, **kw)

    times = []
    for _ in range(11):
        restore(own, sf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        expand()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = sum(times[1:]) / len(times[1:])
    n_copies = int(k7.count[0])

    def restored():
        restore(own, sf)
        expand()

    dev_ms = kernels_device_ms(restored, ("fork_plan", "fork_copy", "fork_fix"), 5)
    plain_ms = time_ms(lambda: expand_forks_plain(sf, L.loop_bound, P_MAIN, "weighted", True,
                                                  vis), 3)
    row = sum(kernels.fork_field(sf, p)[0].nbytes for p in k7.rows) + sf.base.op_hist[0].nbytes
    print(f"[3] fork_plan (weighted, block P, defer, loop bound, profiler): {ms:.4f} ms an "
          f"expansion through the descriptor, device {json.dumps(dev_ms)}; {n_copies} copies of "
          f"{row} B rows; plain functional route {plain_ms:.3f} ms", flush=True)
    # bitonic compare-exchanges (~4 operations each)
    lg = P_MAIN.bit_length() - 1
    ops = (P_MAIN // 2) * lg * (lg + 1) // 2 * 4
    return dict(name="fork_plan", source="mythril_tpu_torch/kernels/csrc/fork_plan.cu",
                replaces="mythril_tpu/symbolic/engine.py:2605", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, nbytes=P_MAIN * (2 + 8 * 4 + 9 * 4 + 4) + 2 * n_copies * row,
                ops=ops)


def expansion_ops(dev) -> dict:
    """Phase 8: device ops a fork expansion makes through the loop's entry
    point (``expand_forks_inplace`` with the loop's descriptor bound),
    from a torch.profiler trace of several expansions in a row on one
    owned P = 2048 frontier: K7's kernel launches and every other device
    op, each op name counted at most ceil(count / expansions) times an
    expansion."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.symbolic.engine import expand_forks_inplace, own_fork_fields

    sf, vis = fork_frontier(dev, np.random.default_rng(20261019))
    k7 = kernels.ForkExpand.on_card(dev)
    own = own_fork_fields(sf)
    n = 16
    args = (DEFAULT_LIMITS.loop_bound, 64, "coverage", True, vis, k7)
    own = expand_forks_inplace(own, *args)
    torch.cuda.synchronize()
    # the profiler's first steps are warm-up (a trace without them missed
    # the first expansions' launches), one expansion a step; a trace that
    # comes back with no device activity at all (one taken late in a long
    # process once did) is taken again
    warm = 2
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warm, active=n, repeat=1)) as prof:
            for _ in range(warm + n):
                own = expand_forks_inplace(own, *args)
                torch.cuda.synchronize()
                prof.step()
        # device ops by name over the n traced expansions (the step ranges
        # are host-side); a name seen at most n times runs at most once an
        # expansion (the trace can miss an event at the window's start)
        ops = {e.key: e.count for e in prof.key_averages()
               if device_us(e) > 0 and not e.key.startswith("ProfilerStep")}
        per = {k: -(-c // n) for k, c in ops.items()}
        ours = sum(v for k, v in per.items() if k.startswith("fork_") and "_kernel" in k)
        if ours:
            break
    out = {"launches": ours, "other": sum(per.values()) - ours, "ops": ops, "trace": attempt}
    print(f"[8] fork expansion (the loop's entry point, P = {P_MAIN}, {n} in a row): "
          f"{json.dumps(out)}", flush=True)
    if not ours:
        fail("fork expansion: three traces showed no launch of K7")
    if out["launches"] > 3 or out["other"] > 10:
        fail(f"fork expansion: {out['launches']} kernel launches and {out['other']} other device "
             "ops an expansion (at most 3 and 10)")
    return out


# K10's lanes at the concrete path's width (bench.py's P)
P_K10 = 4096
K10_SOURCE = "mythril_tpu_torch/kernels/csrc/evm_step.cu"
K10_REPLACES = {"evm_prologue": "mythril_tpu/core/interpreter.py:744",
                "evm_dispatch": "mythril_tpu/core/interpreter.py:951",
                "evm_epilogue": "mythril_tpu/core/interpreter.py:1053",
                "evm_superstep": "mythril_tpu/core/interpreter.py:1072"}


def step_bytes(f, op, run) -> int:
    """Bytes one EVM step must move for these lanes (int64 carriers: 64
    bytes a word): per running lane its control fields (65 read, 29
    written), its operand and result words, the PUSH immediate, and what
    its class touches — the SHA3 input, the MLOAD/MSTORE word, a copy's
    window (source read, memory written), RETURN/REVERT's data and retval
    row, a LOG slot, the storage slots scanned (used flags, then account
    and key of each used one) and written, the account table a lookup
    scans, an env word, the JUMPDEST bit; 8 bytes per other lane."""
    import torch
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.ops import u256

    tb = ci.Tables.on(op.device)
    opl = op.long()
    cls = tb.CLASS[opl]
    M, RD = f.memory.shape[1], f.retval.shape[1]
    K, A = f.st_used.shape[1], f.acct_used.shape[1]

    def ln(i):
        return torch.clamp(u256.to_u64_saturating(ci._peek(f, i)), min=0)

    n = 94 + 64 * (tb.STACK_IN[opl] + tb.STACK_OUT[opl]).to(torch.int64) + tb.PUSH_WIDTH[opl]
    lookup = 65 * A + 64
    ext = (op == 0x31) | (op == 0x3B) | (op == 0x3F)
    cp_len = torch.clamp(torch.where(op == 0x3C, ln(3), ln(2)), max=M)
    data = (op == 0xF3) | (op == 0xFD)
    by_cls = {
        ci.CLS_SHA3: torch.clamp(ln(1), max=200),
        ci.CLS_MEM: torch.where(op == 0x53, 1, 32),
        ci.CLS_COPY: 2 * cp_len + torch.where(op == 0x3C, lookup, 0),
        ci.CLS_HALT: torch.where(data, torch.clamp(ln(1), max=RD) + RD + 4, 0),
        ci.CLS_LOG: torch.full_like(n, 32 + 140),
        ci.CLS_STORAGE: K + 68 * f.st_used.sum(1) + torch.where(op == 0x55, 134, 64),
        ci.CLS_ENV: torch.where(ext, lookup, 64),
        ci.CLS_JUMP: torch.ones_like(n),
    }
    extra = torch.zeros_like(n)
    for c, v in by_cls.items():
        extra = torch.where(cls == c, v, extra)
    return int(torch.where(run, n + extra, 8).sum())


def step_ops(f, op, run) -> int:
    """32-bit integer operations of this step's arithmetic lanes (the
    rest is byte movement): DIV/MOD and ADDMOD/MULMOD a schoolbook long
    division (``longdiv_ops``), MUL 64 multiply-adds, EXP what its
    operands need (``exp_ops``), SHA3 ~200 64-bit operations per round
    per absorbed block, 4 operations each."""
    import torch
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.ops import u256

    cls = ci.Tables.on(op.device).CLASS[op.long()]
    lanes = torch.nonzero(run & ((cls == ci.CLS_MUL) | (cls == ci.CLS_DIVMOD) |
                                 (cls == ci.CLS_MODARITH) | (cls == ci.CLS_EXP) |
                                 (cls == ci.CLS_SHA3))).flatten()
    if lanes.numel() == 0:
        return 0
    w = [u256.to_ints(ci._peek(f, i)[lanes]) for i in range(3)]
    ops = 0
    for j, (c, o) in enumerate(zip(cls[lanes].tolist(), op[lanes].tolist())):
        a, b, m = w[0][j], w[1][j], w[2][j]
        if c == ci.CLS_MUL:
            ops += 64 * 4
        elif c == ci.CLS_DIVMOD:
            sa = o in (0x05, 0x07)
            aa = (W256 + 1 - a) & W256 if sa and a >> 255 else a
            bb = (W256 + 1 - b) & W256 if sa and b >> 255 else b
            ops += longdiv_ops(aa, bb)
        elif c == ci.CLS_MODARITH:
            ops += longdiv_ops(a + b if o == 0x08 else a * b, m)
        elif c == ci.CLS_EXP:
            ops += exp_ops(a, b)
        elif b <= 200:  # SHA3 past the cap hashes nothing
            ops += (b // 136 + 1) * 24 * 200 * 2
    return ops


def split_step(k10, g, env, corpus, skip=None):
    """One split step in place through the descriptor ``k10``, as the
    symbolic superstep launches it -> (op, run, old_pc)."""
    from mythril_tpu_torch import kernels

    _, op, run, old_pc = kernels.evm_prologue(g, corpus, k10.berlin, k10)
    kernels.evm_dispatch(g, env, corpus, op, run, old_pc, skip, k10)
    kernels.evm_epilogue(g, op, run, old_pc, k10)
    return op, run, old_pc


# consecutive in-place steps of the stress batch
STRESS_STEPS = 3
# threads per block K10 is measured at (PERF.md's sweep)
K10_THREADS = (32, 64, 128, 256)
K10_SPLIT = ("evm_prologue", "evm_dispatch", "evm_epilogue")


def check_k10(dev, rng, parent_lib=None):
    """K10 against its plain versions on the card, every frontier field
    with max_abs_err 0, each entry point through a descriptor in place on
    fields owned once (as ``run`` and ``sym_run`` launch it), over
    consecutive steps: the vmtests batch stepped to quiescence (iprof on),
    fused and split; the stress batch at P_K10 lanes under both gas
    schedules, split (a random skip mask each step) and fused, with the
    fused entry point's count of running lanes; each entry point once
    standalone (on copies: its input must stay as it was); the ERC-20
    transfer workload at P_K10 run in place to its end. The plain versions'
    arithmetic and SHA3 are plain PyTorch on the card too, so they share
    no device code with K10.

    Times: the fused entry point over the ERC-20 run (P = 4096), the split
    ones over consecutive steps of a real symbolic frontier at P_MAIN —
    CUDA events around each wrapper call (its bind included), the kernel
    alone (torch.profiler), the descriptor's bind with nothing changed and
    inside a real ``sym_run`` — beside standalone launches (copies of the
    written fields and a full marshal every launch, the launch path before
    the descriptor).
    Then the block-size sweep and the stress dispatch's device time per
    opcode class. With ``--parent-k6 SRC`` the parent tree's K10 on the
    same inputs in turns: the fused entry point over the ERC-20 run and
    the stress dispatch by class, on the device."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.ops import u256
    from mythril_tpu_torch.workloads import erc20_transfer_workload

    L = DEFAULT_LIMITS
    EvmStep = kernels.EvmStep
    err = dict.fromkeys(K10_REPLACES, 0)

    def note(name, got, want, what):
        errs = frontier_errs(got, want)
        bad = {k: e for k, e in errs.items() if e != 0}
        if bad:
            print(f"[3] {name} {what}: fields differ from the plain version: {bad}", flush=True)
            err[name] = max(err[name], max(abs(e) for e in bad.values()), 1)

    def note_step(name, got, want, what):
        for x, y, k in zip(got, want, ("op", "run", "old_pc")):
            if not torch.equal(x, y):
                print(f"[3] {name} {what}: {k} differs", flush=True)
                err[name] = max(err[name], 1)

    def note_count(k10, want, what):
        if int(k10.n_running[0]) != int(want.running.sum()):
            print(f"[3] evm_superstep {what}: n_running {int(k10.n_running[0])} != "
                  f"{int(want.running.sum())} running lanes", flush=True)
            err["evm_superstep"] = max(err["evm_superstep"], 1)

    def split_checked(k10, g, h, env, corpus, skip, what):
        """One in-place split step of ``g`` against the plain step of
        ``h`` -> the plain step's frontier."""
        fp, op, run, old_pc = ci.prologue_plain(h, corpus, k10.berlin)
        _, kop, krun, kpc = kernels.evm_prologue(g, corpus, k10.berlin, k10)
        note("evm_prologue", g, fp, what)
        note_step("evm_prologue", (kop, krun, kpc), (op, run, old_pc), what)
        dp = ci.dispatch_plain(fp, env, corpus, op, run, old_pc, skip=skip)
        kernels.evm_dispatch(g, env, corpus, kop, krun, kpc, skip, k10)
        note("evm_dispatch", g, dp, what)
        ep = ci.epilogue_plain(dp, op, run, old_pc)
        kernels.evm_epilogue(g, kop, krun, kpc, k10)
        note("evm_epilogue", g, ep, what)
        return ep

    def fused_checked(k10, g, h, env, corpus, what):
        fp, op, run, old_pc = ci.prologue_plain(h, corpus, k10.berlin)
        want = ci.epilogue_plain(ci.dispatch_plain(fp, env, corpus, op, run, old_pc),
                                 op, run, old_pc)
        kernels.evm_superstep(g, env, corpus, k10.berlin, k10)
        note("evm_superstep", g, want, what)
        note_count(k10, want, what)
        return want

    # the vmtests batch, step by step to quiescence: fused and split, each
    # in place on fields owned once
    f, env, corpus = vmtests_batch(L, dev)
    f = f.attach_iprof()
    kf, ks = EvmStep.on_card(dev), EvmStep.on_card(dev)
    gf, gs = kernels.own_evm_fields(f), kernels.own_evm_fields(f)
    hf = hs = f
    steps = 0
    while bool(hf.running.any()):
        hf = fused_checked(kf, gf, hf, env, corpus, f"vmtests step {steps}")
        hs = split_checked(ks, gs, hs, env, corpus, None, f"vmtests step {steps}")
        steps += 1
    print(f"[3] evm vmtests: {steps} consecutive in-place steps, fused and split", flush=True)

    # the stress batch: STRESS_STEPS consecutive steps in place, both
    # schedules, split (a random skip mask) and fused
    f, env, corpus = evm_stress_batch(P_K10, L, rng, dev)
    for berlin in (False, True):
        ks, kf = EvmStep.on_card(dev, berlin), EvmStep.on_card(dev, berlin)
        gs, gf = kernels.own_evm_fields(f), kernels.own_evm_fields(f)
        hs = hf = f
        for step in range(STRESS_STEPS):
            what = f"stress step {step} berlin={berlin}"
            skip = torch.as_tensor(rng.random(P_K10) < 0.3, device=dev)
            hs = split_checked(ks, gs, hs, env, corpus, skip, what)
            hf = fused_checked(kf, gf, hf, env, corpus, what)
    classes = set(ci.CLASS_TABLE[ci.prologue_plain(f, corpus)[1].cpu().numpy()].tolist())
    print(f"[3] evm stress: {P_K10} lanes, {STRESS_STEPS} in-place steps x 2 schedules, split "
          f"and fused; classes in the first step {sorted(classes)}; trap codes after "
          f"{sorted(set(hs.err_code.cpu().tolist()))}", flush=True)

    # SHA3 over windows at every offset mod 8, ending at the row's last
    # byte and starting below the row: fused and split against the plain
    # step, and the pushed digests against the host keccak
    fw, envw, corpw, windows = sha3_batch(L, np.random.default_rng(20261021), dev)
    want = fused_checked(EvmStep.on_card(dev), kernels.own_evm_fields(fw), fw, envw, corpw,
                         "SHA3 windows")
    split_checked(EvmStep.on_card(dev), kernels.own_evm_fields(fw), fw, envw, corpw, None,
                  "SHA3 windows")
    pushed = [u256.to_int(r) for r in want.stack[:, 0].cpu().numpy()]
    if bool(want.error.any()) or pushed != sha3_digests(fw.memory.cpu().numpy(), windows):
        fail("K10: a SHA3 window's digest differs from the host keccak")
    print(f"[3] evm SHA3 windows: {len(windows)} lanes (every offset mod 8, windows ending at "
          f"the row's last byte, offsets below the row), fused and split, equal the plain step "
          f"and the host keccak", flush=True)

    # each entry point standalone, on copies: the input stays as it was
    fp, op, run, old_pc = ci.prologue_plain(f, corpus)
    skip = torch.as_tensor(rng.random(P_K10) < 0.3, device=dev)
    dp = ci.dispatch_plain(fp, env, corpus, op, run, old_pc, skip=skip)
    ep = ci.epilogue_plain(dp, op, run, old_pc)
    for name, fn, f_in, want in (
            ("evm_prologue", lambda x: kernels.evm_prologue(x, corpus)[0], f, fp),
            ("evm_dispatch", lambda x: kernels.evm_dispatch(x, env, corpus, op, run, old_pc,
                                                            skip), fp, dp),
            ("evm_epilogue", lambda x: kernels.evm_epilogue(x, op, run, old_pc), dp, ep)):
        before = {k: v.clone() for k, v in vars(f_in).items() if isinstance(v, torch.Tensor)}
        note(name, fn(f_in), want, "standalone")
        changed = [k for k, v in before.items() if not torch.equal(v, getattr(f_in, k))]
        if changed:
            print(f"[3] {name} standalone changed its input: {changed}", flush=True)
            err[name] = max(err[name], 1)

    # the ERC-20 run at P_K10: in place through one descriptor, as `run`
    # launches it (bind once, then bare launches) and through the wrapper
    pin = load_json("torch_port", "erc20_transfer_steps.json")
    n_steps = pin["n_steps"]
    _, f0, env0, corpus0 = erc20_transfer_workload(P_K10, L, device=dev)

    stream = torch.cuda.current_stream(dev).cuda_stream

    def fused_run(mode, lib=None):
        """-> (frontier, ms per superstep): ``bare`` binds once and
        launches; ``wrapper`` calls evm_superstep with the descriptor;
        ``marshal`` with a new descriptor each launch (a full
        marshal); ``copies`` standalone (a copy and a marshal a launch).
        ``lib``: another build of K10 (the parent tree's), ``bare`` only."""
        g = kernels.own_evm_fields(f0)
        k = EvmStep.on_card(dev) if lib is None else EvmStep(lib, stream, dev)
        k.bind("superstep", g, env0, corpus0)
        launch = {"bare": lambda: k.launch("superstep"),
                  "wrapper": lambda: kernels.evm_superstep(g, env0, corpus0, k10=k),
                  "marshal": lambda: kernels.evm_superstep(g, env0, corpus0,
                                                           k10=EvmStep.on_card(dev)),
                  "copies": None}[mode]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_steps):
            if launch is None:
                g = kernels.evm_superstep(g, env0, corpus0)
            else:
                launch()
        end.record()
        torch.cuda.synchronize()
        return g, start.elapsed_time(end) / n_steps

    fused_run("wrapper")  # warm-up
    fused = {m: [fused_run(m)[1] for _ in range(3)] for m in ("bare", "wrapper", "marshal",
                                                             "copies")}
    g, plain_total = f0, 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        g = ci.superstep_plain(g, env0, corpus0)
    end.record()
    torch.cuda.synchronize()
    plain_total = start.elapsed_time(end)
    note("evm_superstep", fused_run("bare")[0], g, "ERC-20 run")
    nbytes = nops = 0
    h = f0
    for _ in range(n_steps):  # the work of each step, from its inputs
        _, op, run, _ = ci.prologue_plain(h, corpus0)
        nbytes += step_bytes(h, op, run)
        nops += step_ops(h, op, run)
        h = ci.superstep_plain(h, env0, corpus0)
    dev_ms = kernel_device_ms(lambda: fused_run("bare"), "evm_superstep_kernel")
    mean = {m: sum(t) / len(t) for m, t in fused.items()}
    print(f"[3] evm_superstep ERC-20 run: {P_K10} lanes, {n_steps} in-place launches; ms per "
          f"launch (CUDA events, 3 runs each): bare "
          f"{', '.join(f'{t:.4f}' for t in fused['bare'])}; through the wrapper "
          f"{', '.join(f'{t:.4f}' for t in fused['wrapper'])}; a new descriptor each launch "
          f"{mean['marshal']:.4f}; standalone with copies {mean['copies']:.4f}; "
          f"device {dev_ms:.4f} (torch.profiler); plain {plain_total / n_steps:.3f}",
          flush=True)
    if parent_lib is not None:
        if any(e != 0 for e in frontier_errs(fused_run("bare", parent_lib)[0], g).values()):
            fail("K10: the parent's K10 disagrees on the ERC-20 run")
        run_ms = [kernel_device_ms(lambda: fused_run("bare", lib), "evm_superstep_kernel")
                  for lib in (parent_lib, None, None, parent_lib)]
        print(f"[3] evm_superstep ERC-20 run on the device, the parent's K10 and this one in "
              f"turns (parent, this, this, parent): {' / '.join(f'{t:.4f}' for t in run_ms)} ms "
              f"a launch", flush=True)
    out = [dict(name="evm_superstep", max_abs_err=err["evm_superstep"], ms=mean["wrapper"],
                plain_ms=plain_total / n_steps, nbytes=nbytes / n_steps, ops=nops / n_steps)]

    # the split entry points at P_MAIN on a real symbolic frontier (the
    # batch before a sweep), consecutive steps in place through one
    # descriptor, as sym_run launches them
    sf, env2, corpus2 = sweep_snapshot(dev)
    b0 = sf.base
    k = EvmStep.on_card(dev)
    g = kernels.own_evm_fields(b0)
    fp, op, run, old_pc = ci.prologue_plain(b0, corpus2)
    dp = ci.dispatch_plain(fp, env2, corpus2, op, run, old_pc)

    def lane_bytes(entry):
        # the per-lane fields an entry point writes; iprof's histogram
        # row counts the one counter a step bumps
        fs = [getattr(b0, x) for x in kernels.EVM_WRITES[entry] if getattr(b0, x) is not None]
        return sum(t.element_size() if t.dim() == 1 else 4 for t in fs) * P_MAIN

    split_step(k, g, env2, corpus2)  # fills the descriptor's op/run/old_pc
    calls = {
        "evm_prologue": (lambda: kernels.evm_prologue(g, corpus2, False, k),
                         lambda: kernels.evm_prologue(g, corpus2),
                         lambda: ci.prologue_plain(b0, corpus2), "prologue",
                         2 * lane_bytes("prologue") + P_MAIN * 40, 0),
        "evm_dispatch": (lambda: kernels.evm_dispatch(g, env2, corpus2, k.op, k.run, k.old_pc,
                                                      None, k),
                         lambda: kernels.evm_dispatch(g, env2, corpus2, k.op, k.run, k.old_pc),
                         lambda: ci.dispatch_plain(fp, env2, corpus2, op, run, old_pc),
                         "dispatch", step_bytes(fp, op, run), step_ops(fp, op, run)),
        "evm_epilogue": (lambda: kernels.evm_epilogue(g, k.op, k.run, k.old_pc, k),
                         lambda: kernels.evm_epilogue(g, k.op, k.run, k.old_pc),
                         lambda: ci.epilogue_plain(dp, op, run, old_pc), "epilogue",
                         2 * lane_bytes("epilogue") + P_MAIN * 20, 0),
    }
    three = time_ms(lambda: split_step(k, g, env2, corpus2), 50)
    dev3 = kernels_device_ms(lambda: split_step(k, g, env2, corpus2), K10_SPLIT, 20)
    bind_us = {}
    for name, entry, args in (("evm_prologue", "prologue", (None, corpus2)),
                              ("evm_dispatch", "dispatch", (env2, corpus2, k.op, k.run,
                                                            k.old_pc)),
                              ("evm_epilogue", "epilogue", (None, None, k.op, k.run,
                                                            k.old_pc))):
        t0 = time.perf_counter()
        for _ in range(1000):
            k.bind(entry, g, *args)
        bind_us[name] = (time.perf_counter() - t0) * 1e3
    print(f"[3] K10 split at P={P_MAIN} (a real symbolic frontier, in place through one "
          f"descriptor): the three launches {three:.4f} ms a superstep (CUDA events); device "
          f"{', '.join(f'{n} {dev3[n]:.4f}' for n in K10_SPLIT)} ms a launch (torch.profiler); "
          f"bind with nothing changed {', '.join(f'{n} {bind_us[n]:.2f}' for n in K10_SPLIT)} "
          f"us", flush=True)
    for name, (kern, old, plain, entry, nb, no) in calls.items():
        ms = time_ms(kern, 50)
        old_ms = time_ms(old, 20)
        copy_ms = time_ms(lambda: kernels.own_evm_fields(g, entry), 20)
        print(f"[3] {name} at P={P_MAIN}: {ms:.4f} ms a launch through the descriptor "
              f"(events, bind included), device {dev3[name]:.4f} ms; standalone "
              f"(copies of its {entry} fields and a full marshal each launch) {old_ms:.4f} ms, "
              f"the copies alone {copy_ms:.4f} ms", flush=True)
        out.append(dict(name=name, max_abs_err=err[name], ms=ms, plain_ms=time_ms(plain, 3),
                        nbytes=nb, ops=no))

    # the descriptor inside a real sym_run: the bind of each launch after
    # the engine's handlers replaced fields
    from mythril_tpu_torch.symbolic import SymSpec, sym_run

    binds = {"s": [], "slots": 0}
    bind = EvmStep.bind

    def timed_bind(self, *a, **kw):
        # the tensors a bind lets go of are freed after the timed window:
        # the engine replaced them, and they would be freed anyway
        n0, old = self.refreshed, list(getattr(self, "_held", ()))
        t0 = time.perf_counter()
        bind(self, *a, **kw)
        binds["s"].append(time.perf_counter() - t0)
        binds["slots"] += self.refreshed - n0
        del old

    EvmStep.bind = timed_bind
    try:
        sym_run(sf, env2, corpus2, SymSpec(), L, max_steps=16, propagate_every=0)
        torch.cuda.synchronize()
    finally:
        EvmStep.bind = bind
    n = max(1, len(binds["s"]))
    print(f"[3] K10 bind inside sym_run at P={P_MAIN} (16 supersteps): {len(binds['s'])} binds, "
          f"median {sorted(binds['s'])[n // 2] * 1e6:.2f} us, mean {sum(binds['s']) / n * 1e6:.2f} "
          f"us, {binds['slots'] / n:.1f} slots re-marshaled each", flush=True)

    # block sizes: the split entry points at P_MAIN, the fused one at P_K10,
    # each size from the same state (a fresh copy of the snapshot; the ERC-20
    # run from its start)
    sweep = {}
    default = kernels.evm_block_threads(K10_THREADS[0])
    try:
        for t in K10_THREADS:
            kernels.evm_block_threads(t)
            ks, gs = EvmStep.on_card(dev), kernels.own_evm_fields(b0)
            sweep[t] = kernels_device_ms(lambda: split_step(ks, gs, env2, corpus2), K10_SPLIT,
                                         20)
            sweep[t]["evm_superstep"] = kernel_device_ms(lambda: fused_run("bare"),
                                                         "evm_superstep_kernel")
    finally:
        kernels.evm_block_threads(default)
    print(f"[3] K10 block sizes (device ms a launch; split at P={P_MAIN}, fused at P={P_K10}; "
          f"the build's default {default}): " + "; ".join(
              f"{t}: " + ", ".join(f"{n} {v:.4f}" for n, v in sweep[t].items()) for t in sweep),
          flush=True)

    # the stress dispatch's device time by opcode class (each class's lanes
    # alone, the others under skip), on copies each launch; with a parent
    # tree, its K10 and this one in turns (parent, this, this, parent)
    fp, op, run, old_pc = ci.prologue_plain(f, corpus)
    cls = ci.Tables.on(dev).CLASS[op.long()]
    k_this = EvmStep.on_card(dev)
    k_old = None if parent_lib is None else EvmStep(parent_lib, stream, dev)

    def dispatch(k, skip):
        return lambda: kernels.evm_step_call("dispatch", k, kernels.own_evm_fields(fp, "dispatch"),
                                             env, corpus, op=op, run=run, old_pc=old_pc,
                                             skip=skip)[0]

    if k_old is not None and any(e != 0 for e in frontier_errs(dispatch(k_old, None)(),
                                                               dispatch(k_this, None)()).values()):
        fail("K10: the parent's K10 disagrees on the stress dispatch")
    order = (k_this,) if k_old is None else (k_old, k_this, k_this, k_old)
    classes = [("all", run)] + [(CLASS_NAMES[c], run & (cls == c)) for c in range(ci.N_CLASSES)]
    per = {}
    for name, lanes in classes:
        if bool(lanes.any()):
            skip = None if name == "all" else ~lanes
            per[name] = (int(lanes.sum()), [kernel_device_ms(dispatch(k, skip),
                                                             "evm_dispatch_kernel", 5)
                                            for k in order])
    print(f"[3] stress dispatch at P={P_K10} by class (running lanes, device ms a launch"
          + (")" if k_old is None else "; the parent's K10 and this one in turns: parent, this, "
             "this, parent)") + ": " + "; ".join(
              f"{n} {c} {' / '.join(f'{x:.4f}' for x in ms)}" for n, (c, ms) in per.items()),
          flush=True)

    for o in out:
        o.update(source=K10_SOURCE, replaces=K10_REPLACES[o["name"]])
    return out


CLASS_NAMES = ("STACK", "ALU", "MUL", "DIVMOD", "MODARITH", "EXP", "SHA3", "ENV", "COPY", "MEM",
               "STORAGE", "JUMP", "HALT", "LOG", "CALL", "CREATE")


def run_concrete(dev) -> dict:
    """Phase 10: the concrete path. ``run`` (one fused K10 launch a
    superstep, in place on fields copied once, the device's count of
    running lanes read every ``RUN_READ_EVERY`` launches) on the ERC-20
    transfer workload at P_K10 lanes, default limits, 256 steps: every
    lane halts without error or revert after the step count the reference
    EVM gives it (tests/fixtures/torch_port/erc20_transfer_steps.json), the
    frontier equals the plain ``run_plain``'s on the card, its input is
    left as it was, the fields were copied once, and the host read the
    device at most 1/RUN_READ_EVERY + 0.02 times a launch. Then five more
    runs for the time."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.workloads import erc20_transfer_workload

    pin = load_json("torch_port", "erc20_transfer_steps.json")
    if pin["P"] != P_K10:
        fail(f"erc20_transfer_steps.json pins {pin['P']} lanes, not {P_K10}")
    _, f, env, corpus = erc20_transfer_workload(P_K10, DEFAULT_LIMITS, device=dev)
    before = {k: v.clone() for k, v in vars(f).items() if isinstance(v, torch.Tensor)}
    torch.cuda.synchronize()
    syncs0, own0 = ci.HOST_SYNCS["count"], kernels.own_evm_fields.calls
    t0 = time.monotonic()
    end, counts = counted(lambda: ci.run(f, env, corpus, max_steps=pin["max_steps"]))
    wall = time.monotonic() - t0
    n_syncs = ci.HOST_SYNCS["count"] - syncs0
    copies = kernels.own_evm_fields.calls - own0
    supersteps = counts["evm_superstep"]
    if not (bool(end.halted.all()) and not bool(end.error.any())
            and not bool(end.reverted.any())):
        fail("concrete run: a lane did not halt cleanly")
    if end.n_steps.cpu().tolist() != [pin["n_steps"]] * P_K10:
        fail("concrete run: per-lane step counts differ from the reference EVM's")
    if supersteps <= 0:
        fail("concrete run: kernel evm_superstep was not launched")
    others = {k: n for k, n in counts.items() if n and k != "evm_superstep"}
    plain = ci.run_plain(f, env, corpus, max_steps=pin["max_steps"])
    bad = {k: e for k, e in frontier_errs(end, plain).items() if e != 0}
    if bad:
        fail(f"concrete run: the frontier differs from run_plain's: {bad}")
    changed = [k for k, v in before.items() if not torch.equal(v, getattr(f, k))]
    if changed:
        fail(f"concrete run: its input changed: {changed}")
    if copies != 1:
        fail(f"concrete run: own_evm_fields ran {copies} times, not once")
    if n_syncs / supersteps > 1 / ci.RUN_READ_EVERY + 0.02:
        fail(f"concrete run: {n_syncs} host reads for {supersteps} launches")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        ci.run(f, env, corpus, max_steps=pin["max_steps"])
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t1)
    med = sorted(walls)[len(walls) // 2]
    lane_steps = int(end.n_steps.sum())
    stats = {"lanes": P_K10, "steps": pin["n_steps"], "launches": supersteps,
             "read_every": ci.RUN_READ_EVERY, "first_wall_s": wall, "walls_s": walls,
             "wall_s": med, "ms_per_step": med * 1e3 / pin["n_steps"],
             "ms_per_launch": med * 1e3 / supersteps, "lane_steps": lane_steps,
             "lane_steps_per_s": lane_steps / med, "host_syncs": n_syncs,
             "host_syncs_per_superstep": n_syncs / supersteps, "field_copies": copies,
             "other_launches": others}
    print(f"[10] concrete run (ERC-20 transfer): every lane halted, step counts equal the "
          f"reference EVM's, frontier equals run_plain's, input unchanged; "
          f"{json.dumps(stats)}", flush=True)
    return counts


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
    print(f"[2] kernels {kernels.BUILD_MODE} in {secs:.1f} s; card {card}", flush=True)
    if "--campaign" in sys.argv:
        run_campaign(dev, card)
        print(f"[*] total {time.monotonic() - t_start:.1f} s", flush=True)
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": count}}))
        return 0

    # phase 3: kernels against their plain versions
    parents = ptxas_builds(argv_value("--parent-k6"))
    rng = np.random.default_rng(20261017)
    results = [check_k1(dev, rng, parents.get("parent u256_divmod")),
               check_k2(dev, rng, parents.get("parent keccak256")),
               check_k3(dev, rng), check_k3_group(dev, np.random.default_rng(20261018)),
               check_k4(dev, rng, parents.get("parent sha256")),
               check_k5(dev, rng, parents.get("parent u256_modexp")),
               check_k6(dev, rng, parents.get("parent propagate_sweep")),
               check_k7(dev, rng), check_k8(dev, rng),
               *check_k9(dev, rng, parents.get("parent u256_mulmod_exp")),
               *check_k10(dev, rng, parents.get("parent evm_step"))]
    for r in results:
        if r["max_abs_err"] != 0:
            fail(f"{r['name']}: kernel disagrees with its plain version "
                 f"(max_abs_err {r['max_abs_err']})")
        print(f"[3] {r['name']}: bit-exact; {r['ms']:.4f} ms kernel, "
              f"{r['plain_ms']:.3f} ms plain", flush=True)
    # phase 8's trace of a fork expansion, taken here, early in the process:
    # a trace late in a long process once came back empty
    expansion_ops(dev)
    if "--kernels" in sys.argv:
        launches = {}
    else:
        launches = run_paths(dev, card)
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


def tensor_leaves(x, prefix=""):
    """Every tensor of a frontier (its base's too) by field path."""
    import torch

    out = {}
    for fl in dataclasses.fields(x):
        v = getattr(x, fl.name)
        if dataclasses.is_dataclass(v):
            out.update(tensor_leaves(v, f"{prefix}{fl.name}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + fl.name] = v
    return out


@contextlib.contextmanager
def held_inputs(what):
    """The held-input check around the wrapper's ``sym_run``: the frontier
    passed to each call (each chunk of the wrapper's loop) is copied to the
    host before the call, and after it the tensors the caller still holds
    must equal that copy, field for field. Yields counts: calls, fields
    held, and (after the block) the field copies ``own_evm_fields`` made,
    one per call."""
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import symbolic as wrapper

    inner = wrapper.sym_run
    stats = {"calls": 0, "fields": 0}

    def checked(sf, *a, **kw):
        saved = {k: t.cpu() for k, t in tensor_leaves(sf).items()}
        out = inner(sf, *a, **kw)
        changed = [k for k, t in tensor_leaves(sf).items() if not torch.equal(t.cpu(), saved[k])]
        if changed:
            fail(f"{what}: sym_run changed the frontier its caller holds: {changed}")
        stats["calls"] += 1
        stats["fields"] = len(saved)
        return out

    wrapper.sym_run = checked
    own0 = kernels.own_evm_fields.calls
    try:
        yield stats
    finally:
        wrapper.sym_run = inner
        stats["field_copies"] = kernels.own_evm_fields.calls - own0
    if stats["calls"] <= 0 or stats["field_copies"] != stats["calls"]:
        fail(f"{what}: {stats['field_copies']} copies of K10's fields for {stats['calls']} "
             "sym_run calls (one each, none inside the superstep loop)")
    print(f"[*] {what}: held-input check passed over {stats['calls']} sym_run calls "
          f"({stats['fields']} fields each); K10's fields copied once per call", flush=True)


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


def run_paths(dev, card) -> dict:
    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import DEFAULT_LIMITS, TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS, FRAME_STATS

    # phase 10 first (the concrete path; fails fast)
    concrete = run_concrete(dev)

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
    need = {"a": K10_SYM + K3, "b": K10_SYM + ("sha256", "modexp_u256") + K3}
    launches = dict(concrete)
    for part, runs in parts.items():
        part_counts = dict.fromkeys(kernels.KERNELS, 0)
        for name, argv in runs:
            _, counts = counted(lambda: run_cli(name, argv))
            print(f"[5{part}] {name} launches {counts}", flush=True)
            k3_launches(f"[5{part}] analyze {name}", counts,
                        K3_ERC20FULL_MAX if name == "erc20full" else None)
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
        for k in K10_SYM + K3:
            if counts[k] <= 0:
                fail(f"{name}: kernel {k} was not launched")
        for k, n in counts.items():
            launches[k] += n

    # phase 7: the campaign-width batch
    codes = [realworld("erc20full")] * BATCH_CONTRACTS + [realworld("erc721")] * BATCH_CONTRACTS
    names = [f"erc20full_{i}" for i in range(BATCH_CONTRACTS)] + \
        [f"erc721_{i}" for i in range(BATCH_CONTRACTS)]
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    syncs0 = ci.HOST_SYNCS["count"]
    steps0 = ENGINE_STATS["lane_steps"]
    supersteps0 = ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    sym, batch_launches = counted(lambda: SymExecWrapper(
        codes, contract_names=names, limits=DEFAULT_LIMITS, lanes_per_contract=64,
        max_steps=512, transaction_count=2, device=dev))
    t_engine = time.monotonic() - t0
    engine_peak = torch.cuda.max_memory_allocated()
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
        # what earlier phases left allocated, and the peak of the engine alone
        "allocated_before": allocated0, "engine_max_memory_allocated": engine_peak,
        "issues": len(report.issues), "launches": batch_launches,
        "surviving_paths": report.coverage.get("surviving_paths"),
    }
    print(f"[7] batch {json.dumps(stats)}", flush=True)
    for k in K10_SYM + K3:
        if batch_launches[k] <= 0:
            fail(f"kernel {k} was not launched in the batch")
    if {batch_launches[k] for k in K10_SYM} != {stats["supersteps"]}:
        fail(f"batch: K10's split launches {[batch_launches[k] for k in K10_SYM]} are not one "
             f"each per superstep ({stats['supersteps']})")
    want20 = {(d["swc-id"], d["address"]) for d in json.load(open(os.path.join(
        ROOT, "tests", "fixtures", "torch_port", "erc20full_default.json")))["issues"]}
    got = {(i.swc_id, i.address) for i in report.issues if i.contract.startswith("erc20")}
    if got != want20:
        fail(f"batch: erc20 issues {got} != {want20}")
    # the same batch again under the held-input check (not timed), its EXP
    # lanes counted by exp8's path
    with held_inputs("batch"), exp_paths("the phase-7 batch (erc20full, erc721)"):
        sym_h = SymExecWrapper(codes, contract_names=names, limits=DEFAULT_LIMITS,
                               lanes_per_contract=64, max_steps=512, transaction_count=2,
                               device=dev)
    got_h = {(i.swc_id, i.address) for i in fire_lasers(sym_h).issues
             if i.contract.startswith("erc20")}
    if got_h != want20 or len(sym_h.sf.base.pc) != stats["lanes"]:
        fail(f"batch under the held-input check: erc20 issues {got_h} != {want20}")
    for k, n in run_campaign(dev, card).items():
        launches[k] += n
    for k, n in run_policies(dev).items():
        launches[k] += n
    profile_paths(dev, codes, names)
    return launches


CAMPAIGN_KERNELS = ("evm_prologue", "evm_dispatch", "evm_epilogue", "tape_append",
                    "tape_append_group", "propagate_sweep", "fork_plan")


def campaign_cli(corpus_dir, extra):
    """``analyze --corpus DIR -o json`` on the card with CAMPAIGN_ARGS ->
    (result JSON, stats). The pipeline's counters say how many host-phase
    seconds ran behind the device phases and how long the device phases
    waited for a host phase."""
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.interfaces.cli import main as cli_main
    from mythril_tpu_torch.obs import metrics as obs_metrics
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    pipe = {k: obs_metrics.REGISTRY.counter(f"pipeline_{k}_seconds_total")
            for k in ("host_hidden", "device_waits_host")}
    pipe0 = {k: c.value for k, c in pipe.items()}
    out, err = io.StringIO(), io.StringIO()
    syncs0, steps0 = ci.HOST_SYNCS["count"], ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(["analyze", "--corpus", corpus_dir, *CAMPAIGN_ARGS, *extra, "-o", "json"])
    if rc != 0:
        fail(f"campaign {extra}: rc {rc}\n{err.getvalue()[-2000:]}")
    doc = json.loads(out.getvalue())
    n_steps = ENGINE_STATS["supersteps"] - steps0
    n_syncs = ci.HOST_SYNCS["count"] - syncs0
    stats = {"wall_s": time.monotonic() - t0, "batches": doc["batches"],
             "s_per_batch": doc["wall_sec"] / max(1, doc["batches"]),
             "contracts_per_s": doc["contracts_per_sec"],
             "contracts_per_s_steady": doc["contracts_per_sec_steady"],
             "supersteps": n_steps, "host_syncs": n_syncs,
             "host_syncs_per_superstep": n_syncs / max(1, n_steps),
             "batch_status": doc["batch_status"],
             **{f"pipeline_{k}_s": c.value - pipe0[k] for k, c in pipe.items()}}
    return doc, stats


def run_campaign(dev, card) -> dict:
    """Phase 11: ``analyze --corpus`` of CAMPAIGN_CONTRACTS contracts on
    the card — unpipelined, pipelined, killed after batch 1 (a raise from
    the heartbeat) and resumed from its checkpoint, and with an OOM on
    batch 2 walked down the ladder. Each run's launch counts are zeroed
    just before it and read just after; each run equals its JAX pin and
    the port's runs equal each other where the pins do. Then a second
    process must reuse the kernel build."""
    import tempfile

    import torch
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.mythril import campaign as cmod
    from mythril_tpu_torch.resilience import InjectedKill

    pins = load_json("torch_port", "campaign_default.json")
    corpus_dir = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    write_corpus(corpus_dir, campaign_corpus())
    launches = dict.fromkeys(kernels.KERNELS, 0)
    docs = {}

    def one(what, extra, pin):
        (doc, stats), counts = counted(lambda: campaign_cli(corpus_dir, extra))
        got, want = campaign_doc(doc), campaign_doc(pins[pin])
        if got != want:
            bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            fail(f"campaign {what}: differs from the JAX pin {pin}: {str(bad)[:3000]}")
        for k in CAMPAIGN_KERNELS:
            if counts[k] <= 0:
                fail(f"campaign {what}: kernel {k} was not launched")
        init = [e for e in doc["backend_events"] if e["kind"] == "device_init"]
        if not init:
            fail(f"campaign {what}: no device_init event")
        stats["device_init"] = init[-1]["detail"]
        for k, n in counts.items():
            launches[k] += n
        docs[what] = got
        print(f"[11] campaign {what}: equals the JAX pin ({pin}); {json.dumps(stats)}; "
              f"launches {counts}; card {card}", flush=True)
        k3_launches(f"[11] campaign {what}", counts)

    with held_inputs("campaign unpipelined"), exp_paths("the unpipelined campaign"):
        one("unpipelined", ["--no-pipeline", "--init-timeout", "300"], "plain")
    one("pipelined", [], "plain")

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_campaign_ckpt_")
    ck_args = ["--checkpoint-every", "1", "--checkpoint-dir", ckpt, "--heartbeat", "0"]
    beat = cmod.CorpusCampaign._heartbeat

    def beat_then_kill(self, done, total, res, last_out):
        beat(self, done, total, res, last_out)
        if done == 2:
            raise InjectedKill("killed after batch 1")

    cmod.CorpusCampaign._heartbeat = beat_then_kill
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        campaign_cli(corpus_dir, ck_args)
        fail("campaign: the run to be killed ran to its end")
    except InjectedKill:
        pass
    finally:
        cmod.CorpusCampaign._heartbeat = beat
        torch.cuda.synchronize()
        for k, n in kernels.launch_counts().items():
            launches[k] += n
    if not os.path.exists(os.path.join(ckpt, "campaign.json")):
        fail("campaign: the killed run left no checkpoint")
    print(f"[11] campaign killed after batch 1 with a checkpoint; card {card}", flush=True)
    one("resumed", ck_args, "plain")
    one("oom ladder", list(CAMPAIGN_OOM), "oom")
    if not docs["pipelined"] == docs["unpipelined"] == docs["resumed"]:
        fail("campaign: the pipelined, unpipelined and resumed runs differ")

    probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
             "from mythril_tpu_torch import kernels; kernels.build(); "
             "print(json.dumps({'mode': kernels.BUILD_MODE, 's': kernels.BUILD_SECONDS}))")
    r = subprocess.run([sys.executable, "-c", probe, ROOT], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        fail(f"second process: rc {r.returncode}\n{r.stderr[-2000:]}")
    second = json.loads(r.stdout.strip().splitlines()[-1])
    if second["mode"] != "reused":
        fail(f"second process: kernels {second['mode']}, not reused")
    print(f"[11] kernel build: this process {kernels.BUILD_MODE} in "
          f"{kernels.BUILD_SECONDS:.3f} s, a second process {second['mode']} in "
          f"{second['s']:.3f} s; card {card}", flush=True)
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
          f"K9 {counts['mod_wide_u256']} mod_wide / {counts['exp_u256']} exp, "
          f"K10 {counts['evm_dispatch']} dispatch", flush=True)


# the symbolic superstep's concrete step on the card (K10's split entry
# points); the concrete MUL/DIV/EXP/MULMOD/SHA3 run inside K10, so K1, K2,
# K8 and K9 no longer launch on an analyze
K10_SYM = ("evm_prologue", "evm_dispatch", "evm_epilogue")
# K3's entry points: the overlay's SHA3 chain and binary ops append in
# groups, the havocs and the claimed handlers one row at a time
K3 = ("tape_append", "tape_append_group")
ARITH_KERNELS = K10_SYM + ("fork_plan",) + K3
# K3 launches an erc20full analyze may take at the CLI defaults (4,306
# before the group entry point; ~10 a superstep over 214 supersteps with it)
K3_ERC20FULL_MAX = 2500


def k3_launches(what, counts, limit=None):
    """Print a run's K3 launches; fail above ``limit``."""
    n = counts["tape_append"] + counts["tape_append_group"]
    print(f"{what}: K3 launches {n} ({counts['tape_append']} single-row, "
          f"{counts['tape_append_group']} group)", flush=True)
    if limit is not None and n > limit:
        fail(f"{what}: {n} K3 launches, more than {limit}")


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
    checkpoints at full width (64 lanes per contract; 512 steps, -t 2, but
    the five strategies after bfs and berlin at ARITH_SHORT_ARGS), each
    run's launch counts zeroed just before it and read just after."""
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
        # the bfs run, at the CLI defaults, also keeps the instruction
        # profile (its report is the same with or without it) and times
        # the engine's loop stages between synchronizations (phase 8's
        # arith numbers); the other strategies run at ARITH_SHORT_ARGS' depth
        iprof = ["--enable-iprof"] if strategy == "bfs" else []
        depth = [] if strategy == "bfs" else list(ARITH_SHORT_ARGS)
        pin = f"arith_{strategy}.json" if strategy == "bfs" else f"arith_{strategy}_short.json"
        # the EXP lanes counted by exp8's path, but not in bfs's run, whose
        # loop stages phase 8 times
        count = contextlib.nullcontext() if strategy == "bfs" else exp_paths(
            f"arith --strategy {strategy} {' '.join(depth)}")
        with timed_stages(f"arith --strategy {strategy}" if strategy == "bfs" else None), count:
            (err, stats), counts = counted(lambda: run_cli(
                f"arith --strategy {strategy} {' '.join(iprof + depth)}",
                ["-f", arith, "--strategy", strategy, *iprof, *depth], pin=pin, phase="9"))
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
    short = dict(kw, max_steps=int(ARITH_SHORT_ARGS[1]), transaction_count=int(ARITH_SHORT_ARGS[3]))
    _, counts, sweeps = wrapper_run("arith berlin", lambda: SymExecWrapper(
        [arith_code()], contract_names=["MAIN"], limits=berlin, **short),
        "arith_berlin_short.json")
    require_launches("arith berlin", counts, sweeps, ARITH_KERNELS)
    add(counts)
    system = forkblock_system()
    _, counts, sweeps = wrapper_run("fork-block batch", lambda: SymExecWrapper(
        [c for _, c in system], contract_names=[n for n, _ in system],
        limits=DEFAULT_LIMITS, fork_block=64, **kw), "forkblock4_default.json")
    require_launches("fork-block batch", counts, sweeps, ARITH_KERNELS)
    add(counts)

    # checkpoints: a one-transaction run saves at every 16-step seam; the
    # rotated copy (the second-to-last seam) resumes mid-transaction
    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ck_kw = dict(kw, transaction_count=1, deadline_chunk_steps=16)
    with exp_paths("arith bfs, 512 steps, 1 tx (the checkpointed run)"):
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
    require_launches("arith resumed", counts, sweeps, ARITH_KERNELS)
    add(counts)
    return launches


@contextlib.contextmanager
def timed_stages(what):
    """Time the engine's loop stages (superstep, forks, propagation)
    between device synchronizations over the block and print them as
    phase 8's numbers for ``what``; None: no timing."""
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    if what is None:
        yield
        return
    ENGINE_STATS.update(timing=True, superstep_s=0.0, forks_s=0.0, propagate_s=0.0)
    steps0 = ENGINE_STATS["supersteps"]
    t0 = time.monotonic()
    try:
        yield
    finally:
        ENGINE_STATS["timing"] = False
    stages = {k: round(ENGINE_STATS[k], 3) for k in ("superstep_s", "forks_s", "propagate_s")}
    print(f"[8] {what} engine stages (synchronized): {json.dumps(stages)}, "
          f"{time.monotonic() - t0:.2f} s, {ENGINE_STATS['supersteps'] - steps0} supersteps",
          flush=True)


def profile_paths(dev, codes, names) -> None:
    """Phase 8, a measurement mode outside the counted runs: (a) the
    analyze engine of erc20full with each loop stage timed between device
    synchronizations (arith bfs's are timed in its phase-9 run, and the
    device ops of a fork expansion traced after phase 3); (b) a
    torch.profiler window over the batch's first 16 supersteps for the
    device's busy share and the top kernels (the profiler's event
    processing is slow, so the window stays short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.analysis import SymExecWrapper
    from mythril_tpu_torch.config import DEFAULT_LIMITS

    with timed_stages("erc20full"):
        SymExecWrapper([realworld("erc20full")], limits=DEFAULT_LIMITS, lanes_per_contract=64,
                       max_steps=512, transaction_count=2, device=dev)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        SymExecWrapper(codes, contract_names=names, limits=DEFAULT_LIMITS,
                       lanes_per_contract=64, max_steps=16, transaction_count=1, device=dev)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0

    events = prof.key_averages()
    busy_us = sum(device_us(e) for e in events)
    n_kernels = sum(e.count for e in events if device_us(e) > 0)
    top = sorted(events, key=device_us, reverse=True)[:8]
    print(f"[8] batch window (16 supersteps, profiled): wall {wall:.2f} s, device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{n_kernels} device ops", flush=True)
    for e in top:
        print(f"[8]   {device_us(e) / 1e3:9.2f} ms  x{e.count:<7} {e.key[:90]}", flush=True)
    for e in events:
        if "evm_" in e.key and "_kernel" in e.key:
            print(f"[8]   K10 {e.key[:60]}: x{e.count}, {device_us(e) / 1e3:.3f} ms on the "
                  f"device", flush=True)


if __name__ == "__main__":
    sys.exit(main())
