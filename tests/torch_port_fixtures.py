"""The precompile fixture of the PyTorch port's tests and smoke run, and
the script that pins the JAX package's reports for the full-width runs.

``precompiles``: a contract in the solc shape (creation code = the
constructor, then a CODECOPY/RETURN of the runtime image appended to
it), assembled with the port's assembler (there is no solc here).

- The constructor does two precompile-heavy initializations on
  CONCRETE memory, so the calls reach the device kernels (symbolic input
  would drop to the leaf path): the zero-hash ladder of the Eth2 deposit
  contract (``ethereum/consensus-specs``, ``solidity_deposit_contract/
  deposit_contract.sol``: ``zero_hashes[i+1] = sha256(zero_hashes[i] ++
  zero_hashes[i])``, a loop of 4 levels here, within the loop bound of
  the test profile)
  with SHA-256 (0x2), and an RSA-accumulator setup ``A = g ** e1 mod N``,
  ``A = A ** e2 mod N`` with constant 32-byte ``g``, ``e1``, ``e2``,
  ``N`` with MODEXP (0x5).
- The runtime image: ``deposit(bytes32)`` hashes the caller's leaf with
  the stored ladder, ``accumulate(uint256)`` raises the accumulator to a
  caller-chosen exponent, ``claim(bytes32)`` pays out the balance to a
  caller whose preimage hashes to the deposit root.

Files: ``tests/fixtures/torch_port/precompiles.bin`` (creation) and
``precompiles.bin-runtime``.

``arith``: a token sale in the solc shape with real arithmetic, so the
u256 product family runs on the main path: ``buy(n)`` charges an
unchecked ``n * price`` (MUL, an SWC-101 overflow), ``scale(d)`` computes
``amount * 10 ** d`` (EXP), ``fee(a)`` takes ``mulmod(a, 30, 10000)`` and
``addmod(a, fee, 2^255 + 19)`` (MULMOD, ADDMOD). ``tier(x)`` (first in the
dispatcher) branches on six bits of its argument and ``bonus(x)`` (last)
on four, so one lane's 64 + 16 paths saturate the 64 lanes of a
contract, shallow and deep requests compete, and the fork strategies
admit different survivors; the path with all bits set ends in a failing
assertion in each. File:
``tests/fixtures/torch_port/arith.bin-runtime``.

Regenerate the fixtures and the pinned JAX reports with
``JAX_PLATFORMS=cpu python tests/torch_port_fixtures.py`` (the reports
take minutes on a CPU; each runs in its own process).
"""

import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE_DIR = os.path.join(HERE, "fixtures", "torch_port")
GAS = ("push2", 0xFFFF)

SEL_DEPOSIT = 0x2D9A6E3F   # deposit(bytes32)
SEL_ACCUMULATE = 0x4C1F8D1A  # accumulate(uint256)
SEL_CLAIM = 0xBD66528A     # claim(bytes32)

ZERO_HASH_SLOT = 0x100      # zero_hashes[i] at slot 0x100 + i
ACC_SLOT, ROOT_SLOT, TOTAL_SLOT, N_SLOT = 1, 2, 3, 4
LEVELS = 4
RSA_G = 0x3B9ACA07C1D2E3F405162738495A6B7C8D9EAFB0C1D2E3F40516273849AF0E1D
RSA_E1 = 0xF2A1D9C38B7E65443322110FFEEDDCCBBAA998877665544332211000FEDCBA99
RSA_E2 = 0x10001
RSA_N = 0xC4F2D8A1B3E5F7092C4E6A8BADCFE1032547698BADCFE10325476980B1A2C3D5


def _assemble(*tokens):
    sys.path.insert(0, ROOT)
    from mythril_tpu_torch.disassembler.asm import assemble

    return assemble(*tokens)


def _call_pre(addr, args, ret):
    return [ret[1], ret[0], args[1], args[0], 0, addr, GAS, "CALL"]


def _modexp_tokens(base_tokens, exp_tokens, mod_tokens, header=True):
    """MODEXP over 32-byte operands from memory [0, 192) into [192, 224)
    (``header`` False: the three length words are already in memory)."""
    head = [32, 0, "MSTORE", 32, 32, "MSTORE", 32, 64, "MSTORE"] if header else []
    return [*head, *base_tokens, 96, "MSTORE", *exp_tokens, 128, "MSTORE",
            *mod_tokens, 160, "MSTORE",
            *_call_pre(5, (0, 192), (192, 32)), "POP", ("push1", 192), "MLOAD"]


def precompiles_runtime() -> bytes:
    return _assemble(
        0, "CALLDATALOAD", 0xE0, "SHR",
        "DUP1", SEL_DEPOSIT, "EQ", ("ref", "deposit"), "JUMPI",
        "DUP1", SEL_ACCUMULATE, "EQ", ("ref", "accumulate"), "JUMPI",
        "DUP1", SEL_CLAIM, "EQ", ("ref", "claim"), "JUMPI",
        0, 0, "REVERT",
        # deposit(leaf): root = sha256(leaf ++ zero_hashes[1]); total += value
        ("label", "deposit"), "POP",
        4, "CALLDATALOAD", 0, "MSTORE", ("push2", ZERO_HASH_SLOT + 1), "SLOAD", 32, "MSTORE",
        *_call_pre(2, (0, 64), (64, 32)), "POP",
        64, "MLOAD", ROOT_SLOT, "SSTORE",
        "CALLVALUE", TOTAL_SLOT, "SLOAD", "ADD", TOTAL_SLOT, "SSTORE", "STOP",
        # accumulate(e): A = A ** e mod N
        ("label", "accumulate"), "POP",
        *_modexp_tokens([ACC_SLOT, "SLOAD"], [4, "CALLDATALOAD"], [N_SLOT, "SLOAD"]),
        ACC_SLOT, "SSTORE", "STOP",
        # claim(preimage): pay the balance out if sha256(preimage) == root
        ("label", "claim"), "POP",
        4, "CALLDATALOAD", 0, "MSTORE",
        *_call_pre(2, (0, 32), (32, 32)), "POP",
        32, "MLOAD", ROOT_SLOT, "SLOAD", "EQ", ("ref", "pay"), "JUMPI",
        0, 0, "REVERT",
        ("label", "pay"),
        0, 0, 0, 0, "SELFBALANCE", "CALLER", GAS, "CALL", "POP", "STOP",
    )


def _constructor(runtime_len: int, runtime_off: int):
    return [
        "CALLER", 0, "SSTORE",  # owner
        # zero-hash ladder: zero_hashes[i+1] = sha256(zh[i] ++ zh[i]), from
        # a written zero_hashes[0] (an unwritten slot reads symbolic)
        0, ("push2", ZERO_HASH_SLOT), "SSTORE",
        0,
        ("label", "ladder"),
        "DUP1", ("push2", ZERO_HASH_SLOT), "ADD", "SLOAD",
        "DUP1", 0, "MSTORE", 32, "MSTORE",
        *_call_pre(2, (0, 64), (64, 32)), "POP",
        64, "MLOAD", "DUP2", 1, "ADD", ("push2", ZERO_HASH_SLOT), "ADD", "SSTORE",
        1, "ADD", "DUP1", LEVELS, "GT", ("ref", "ladder"), "JUMPI",
        "POP",
        # RSA accumulator: A = (g ** e1 mod N) ** e2 mod N
        ("push32", RSA_N), N_SLOT, "SSTORE",
        *_modexp_tokens([("push32", RSA_G)], [("push32", RSA_E1)], [("push32", RSA_N)]),
        ACC_SLOT, "SSTORE",
        *_modexp_tokens([ACC_SLOT, "SLOAD"], [RSA_E2], [N_SLOT, "SLOAD"], header=False),
        ACC_SLOT, "SSTORE",
        # return the runtime image appended to this code (the solc shape)
        ("push2", runtime_len), "DUP1", ("push2", runtime_off), 0, "CODECOPY",
        0, "RETURN",
    ]


def precompiles_creation() -> bytes:
    runtime = precompiles_runtime()
    ctor_len = len(_assemble(*_constructor(0, 0)))  # fixed-width pushes
    return _assemble(*_constructor(len(runtime), ctor_len)) + runtime


SEL_BUY = 0xD96A094A    # buy(uint256)
SEL_SCALE = 0x2BEC1547  # scale(uint256)
SEL_FEE = 0x39B37AB0    # fee(uint256)
SEL_TIER = 0x6DDA34DB   # tier(uint256)
SEL_BONUS = 0x24749B59  # bonus(uint256)
PRICE_SLOT, SOLD_SLOT, SCALED_SLOT, FEE_SLOT, NET_SLOT, TIER_SLOT, BONUS_SLOT = range(1, 8)
FEE_BPS = 30
FEE_MOD = (1 << 255) + 19


def _bit_tests(name, n_bits):
    """``n_bits`` independent tests of bits of the first argument (2^n
    paths), then a failing assertion (INVALID) on the path with all of
    them set, reached only if every fork copy on the way was admitted."""
    out = []
    for i in range(n_bits):
        out += [4, "CALLDATALOAD", 1 << i, "AND", ("ref", f"{name}{i}"), "JUMPI",
                ("label", f"{name}{i}")]
    mask = (1 << n_bits) - 1
    return out + [4, "CALLDATALOAD", mask, "AND", mask, "EQ", ("ref", f"{name}_all"), "JUMPI"]


def arith_runtime() -> bytes:
    return _assemble(
        0, "CALLDATALOAD", 0xE0, "SHR",
        "DUP1", SEL_TIER, "EQ", ("ref", "tier"), "JUMPI",
        "DUP1", SEL_BUY, "EQ", ("ref", "buy"), "JUMPI",
        "DUP1", SEL_SCALE, "EQ", ("ref", "scale"), "JUMPI",
        "DUP1", SEL_FEE, "EQ", ("ref", "fee"), "JUMPI",
        "DUP1", SEL_BONUS, "EQ", ("ref", "bonus"), "JUMPI",
        0, 0, "REVERT",
        # tier(x): six bit tests, 64 paths (the shallowest fork requests)
        ("label", "tier"), "POP", *_bit_tests("t", 6),
        4, "CALLDATALOAD", TIER_SLOT, "SSTORE", "STOP",
        ("label", "t_all"), "INVALID",
        # buy(n): balances[caller] = n * price (unchecked); sold += n
        ("label", "buy"), "POP",
        PRICE_SLOT, "SLOAD", 4, "CALLDATALOAD", "MUL", "CALLER", "SSTORE",
        4, "CALLDATALOAD", SOLD_SLOT, "SLOAD", "ADD", SOLD_SLOT, "SSTORE", "STOP",
        # scale(d): scaled = amount * 10 ** d
        ("label", "scale"), "POP",
        4, "CALLDATALOAD", 10, "EXP", 36, "CALLDATALOAD", "MUL", SCALED_SLOT, "SSTORE", "STOP",
        # fee(a): fee = mulmod(a, 30, 10000); net = addmod(a, fee, 2^255 + 19)
        ("label", "fee"), "POP",
        ("push2", 10000), FEE_BPS, 4, "CALLDATALOAD", "MULMOD",
        ("push32", FEE_MOD), "DUP2", 4, "CALLDATALOAD", "ADDMOD", NET_SLOT, "SSTORE",
        FEE_SLOT, "SSTORE", "STOP",
        # bonus(x): four bit tests, 16 paths (the deepest fork requests)
        ("label", "bonus"), "POP", *_bit_tests("b", 4),
        4, "CALLDATALOAD", BONUS_SLOT, "SSTORE", "STOP",
        ("label", "b_all"), "INVALID",
    )


def arith_file():
    return os.path.join(FIXTURE_DIR, "arith.bin-runtime")


def precompiles_files():
    return (os.path.join(FIXTURE_DIR, "precompiles.bin"),
            os.path.join(FIXTURE_DIR, "precompiles.bin-runtime"))


def _write_fixture():
    creation_p, runtime_p = precompiles_files()
    with open(creation_p, "w") as fh:
        fh.write(precompiles_creation().hex())
    with open(runtime_p, "w") as fh:
        fh.write(precompiles_runtime().hex())
    with open(arith_file(), "w") as fh:
        fh.write(arith_runtime().hex())


# ---------------------------------------------------------------------------
# the pinned JAX reports of the full-width runs
# ---------------------------------------------------------------------------

REALWORLD = [("Eip1167Proxy", "eip1167proxy"), ("Erc20Full", "erc20full"),
             ("Erc721", "erc721"), ("Multisig2of3", "multisig2of3")]
STRATEGIES = ("bfs", "dfs", "naive-random", "weighted-random", "coverage", "beam")
# the arith test-profile CLI runs of the CPU tests
ARITH_TEST_ARGS = ["--limits-profile", "test", "--lanes-per-contract", "16",
                   "--max-steps", "192"]
# chip_smoke.py's phase 9 runs the five other strategies and berlin at this
# cut depth (the bfs run keeps the CLI defaults)
ARITH_SHORT_ARGS = ["--max-steps", "256", "-t", "1"]
CONFIG4 = ["Caller", "Router", "Vault"]
COVERAGE_KEYS = ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
                 "lanes_errored", "instruction_coverage_pct")


def read_hex(path):
    with open(path) as fh:
        return bytes.fromhex(fh.read().strip().removeprefix("0x"))


def forkblock_system():
    """The fork-block batch: arith beside three of the real-world runtimes."""
    rw = dict(realworld_system())
    return [("Arith", read_hex(arith_file()))] + [(n, rw[n]) for n in
                                                   ("Erc20Full", "Erc721", "Multisig2of3")]


def realworld_system():
    return [(n, read_hex(os.path.join(HERE, "fixtures", "realworld", f"{f}.bin-runtime")))
            for n, f in REALWORLD]


def config4_system():
    d = os.path.join(HERE, "fixtures", "config4")
    return [(n, read_hex(os.path.join(d, f"{n.lower()}.bin")),
             read_hex(os.path.join(d, f"{n.lower()}.bin-runtime"))) for n in CONFIG4]


def wrapper_doc(report) -> dict:
    """The report fields a full-width wrapper run is held to."""
    return {"issues": sorted(
        ({"contract": i.contract, "swc-id": i.swc_id, "address": i.address,
          "title": i.title, "severity": i.severity} for i in report.issues),
        key=lambda d: (d["contract"], d["swc-id"], d["address"], d["title"])),
        "coverage": {k: report.coverage.get(k) for k in COVERAGE_KEYS}}


def _pin_cli(name, argv):
    import subprocess

    res = subprocess.run([sys.executable, "-m", "mythril_tpu", "analyze", *argv, "-o", "json"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    if "--enable-iprof" in argv:
        # the profile table is the last block of stderr (the report is the
        # one without the profiler)
        table = res.stderr[res.stderr.index("Instruction profile"):]
        with open(os.path.join(FIXTURE_DIR, f"{name}.txt"), "w") as fh:
            fh.write(table)
        return
    with open(os.path.join(FIXTURE_DIR, f"{name}.json"), "w") as fh:
        json.dump(json.loads(res.stdout), fh, indent=1, sort_keys=True)


def _pin_wrapper(name):
    sys.path.insert(0, ROOT)
    import mythril_tpu  # noqa: F401
    from mythril_tpu.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu.config import DEFAULT_LIMITS

    kw = dict(limits=DEFAULT_LIMITS, lanes_per_contract=64, max_steps=512,
              transaction_count=2)
    if name == "config4_default":
        system = config4_system()
        sym = SymExecWrapper([r for _, _, r in system], contract_names=[n for n, _, _ in system],
                             creation_bytecodes=[c for _, c, _ in system], **kw)
    elif name in ("arith_berlin", "arith_berlin_short"):
        import dataclasses

        kw["limits"] = dataclasses.replace(DEFAULT_LIMITS, gas_schedule="berlin")
        if name == "arith_berlin_short":
            kw.update(max_steps=int(ARITH_SHORT_ARGS[1]), transaction_count=int(ARITH_SHORT_ARGS[3]))
        sym = SymExecWrapper([read_hex(arith_file())], contract_names=["MAIN"], **kw)
    elif name == "forkblock4_default":
        system = forkblock_system()
        sym = SymExecWrapper([c for _, c in system], contract_names=[n for n, _ in system],
                             fork_block=64, **kw)
    else:
        system = realworld_system()
        sym = SymExecWrapper([c for _, c in system], contract_names=[n for n, _ in system],
                             **kw)
    with open(os.path.join(FIXTURE_DIR, f"{name}.json"), "w") as fh:
        json.dump(wrapper_doc(fire_lasers(sym)), fh, indent=1, sort_keys=True)


ERC20_LANES = 4096  # the concrete path's bench width (bench.py)
ERC20_MAX_STEPS = 256


def _pin_erc20_steps():
    """The step count of every lane of the ERC-20 transfer workload at the
    bench width, from the int-based reference EVM (tests/pyevm_ref.py):
    lane i runs transfer(0x1000 + i, 0) from the bench caller. The
    recipient does not change the path, so every lane takes the same
    count and one is pinned. chip_smoke.py's phase 10 holds the card's
    concrete ``run`` to it."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    from mythril_tpu.disassembler.asm import abi_call, erc20_like
    from mythril_tpu.workloads import BENCH_CALLER, TRANSFER_SELECTOR
    from pyevm_ref import RefEnv, RefEVM

    code = erc20_like()
    res = [RefEVM(code, abi_call(TRANSFER_SELECTOR, 0x1000 + i, 0),
                  env=RefEnv(caller=BENCH_CALLER)).run(ERC20_MAX_STEPS)
           for i in range(ERC20_LANES)]
    steps = {r.steps for r in res}
    if len(steps) != 1:
        raise SystemExit(f"ERC-20 transfer lanes take different step counts: {sorted(steps)}")
    doc = {"P": ERC20_LANES, "max_steps": ERC20_MAX_STEPS, "n_steps": steps.pop(),
           "halted": all(r.halted for r in res), "error": any(r.error for r in res),
           "reverted": any(r.reverted for r in res)}
    with open(os.path.join(FIXTURE_DIR, "erc20_transfer_steps.json"), "w") as fh:
        json.dump(doc, fh)


# ---------------------------------------------------------------------------
# the corpus campaign: the JAX package's CorpusCampaign, pinned for the CPU
# tests (tests/test_torch_campaign.py) and for chip_smoke.py's phase 11
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def smoke():
    """chip_smoke.py, whose corpus, arguments and result normalizer the
    campaign pins share."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CAMPAIGN_TEST_GOLDENS = ("swc106_killable", "swc101_add_overflow", "swc110_assert_fail",
                         "clean_store", "swc105_drain")
# 5 contracts in batches of 2: the last batch is padded
CAMPAIGN_TEST_KW = dict(batch_size=2, lanes_per_contract=8, max_steps=64, transaction_count=1)
CAMPAIGN_TEST_ARGS = ["--batch-size", "2", "--lanes-per-contract", "8", "--max-steps", "64",
                      "-t", "1", "--limits-profile", "test"]
# name -> (fault spec, --oom-ladder, campaign keywords). The hang case comes
# last, when every shape of the plain run has run once in the process (a JAX
# compile would outlast its watchdog). "cpu" is the JAX name of the tier rung
CAMPAIGN_TEST_CASES = {
    "plain": (None, None, {}),
    "plain_serial": (None, None, {"pipeline": False}),
    "raise": ("raise:contract=c002", None, {}),
    "oom": ("oom:batch=1:times=2", "halve-lanes,halve-batch", {}),
    "oom_tier": ("oom:batch=1:times=2", "halve-lanes,cpu", {}),
    "hang": ("hang:batch=1:times=1", None, {"batch_timeout": 6.0}),
}
CAMPAIGN_CLI_ARGS = [*CAMPAIGN_TEST_ARGS, "--fault-inject", "oom:batch=1:times=1",
                     "--max-batch-retries", "1", "--checkpoint-every", "2"]


def campaign_test_corpus():
    fx = smoke().golden_fixtures()
    return [(f"c{i:03d}", fx[n]) for i, n in enumerate(CAMPAIGN_TEST_GOLDENS)]


def campaign_cases(campaign, resilience, limits, tmpdir, **engine_kw):
    """Every case of CAMPAIGN_TEST_CASES, then a run killed at batch 2 and
    resumed from its checkpoint, through ``campaign``/``resilience`` (the
    JAX package's modules or the port's) -> {case: result dict with
    ``issues_detail``}."""
    corpus = campaign_test_corpus()

    def run(fault=None, ladder=None, **kw):
        c = campaign.CorpusCampaign(
            corpus, limits=limits, pipeline=kw.pop("pipeline", True),
            fault_injector=resilience.FaultInjector.from_string(fault),
            oom_ladder=None if ladder is None else resilience.parse_ladder(ladder),
            **CAMPAIGN_TEST_KW, **engine_kw, **kw)
        res = c.run()
        return {**res.as_dict(), "issues_detail": res.issues}

    out = {name: run(fault, ladder, **kw)
           for name, (fault, ladder, kw) in CAMPAIGN_TEST_CASES.items()}
    # the killed run is serial, so that its checkpoints are written before
    # the kill; the resumed run is pipelined
    ckpt = os.path.join(str(tmpdir), "ckpt")
    try:
        run("kill:batch=2", checkpoint_dir=ckpt, pipeline=False)
        raise AssertionError("the run to be killed ran to its end")
    except resilience.InjectedKill:
        pass
    state, _ = campaign.load_json_checkpoint_resilient(os.path.join(ckpt, "campaign.json"))
    out["resume"] = run(checkpoint_dir=ckpt)
    out["resume"]["resumed_at_batch"] = state["next_batch"]
    return out


def _pin_campaign_test():
    """tests/fixtures/torch_port/campaign_test.json: the JAX results of every
    case (whole), their merge, and the JAX CLI's --corpus output."""
    import subprocess
    import tempfile

    sys.path.insert(0, ROOT)
    import mythril_tpu  # noqa: F401
    from mythril_tpu import resilience
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.mythril import campaign

    tmp = tempfile.mkdtemp(prefix="campaign_pin_")
    runs = campaign_cases(campaign, resilience, TEST_LIMITS, tmp)
    corpus_dir = os.path.join(tmp, "corpus")
    os.mkdir(corpus_dir)
    smoke().write_corpus(corpus_dir, campaign_test_corpus())
    cli = subprocess.run([sys.executable, "-m", "mythril_tpu", "analyze", "--corpus", corpus_dir,
                          *CAMPAIGN_CLI_ARGS, "-o", "json"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    doc = {"runs": runs, "merge": campaign.merge_campaigns([runs["plain"], runs["raise"]]),
           "cli": json.loads(cli.stdout)}
    with open(os.path.join(FIXTURE_DIR, "campaign_test.json"), "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)


def _pin_campaign_default():
    """tests/fixtures/torch_port/campaign_default.json: chip_smoke.py's
    phase 11 (its corpus and arguments, default limits) through the JAX
    CorpusCampaign, plain and with its OOM fault (the whole results;
    chip_smoke compares them through ``campaign_doc``)."""
    sys.path.insert(0, ROOT)
    import mythril_tpu  # noqa: F401
    from mythril_tpu.config import DEFAULT_LIMITS
    from mythril_tpu.mythril.campaign import CorpusCampaign
    from mythril_tpu.resilience import FaultInjector, parse_ladder

    sm = smoke()
    args = dict(zip(sm.CAMPAIGN_ARGS[::2], sm.CAMPAIGN_ARGS[1::2]))
    oom = dict(zip(sm.CAMPAIGN_OOM[::2], sm.CAMPAIGN_OOM[1::2]))
    kw = dict(limits=DEFAULT_LIMITS, batch_size=int(args["--batch-size"]),
              lanes_per_contract=int(args["--lanes-per-contract"]),
              max_steps=int(args["--max-steps"]), transaction_count=int(args["-t"]),
              pipeline=True)
    corpus = sm.campaign_corpus()
    from mythril_tpu.fleet import corpus_fingerprint

    doc = {"corpus": corpus_fingerprint(corpus), "args": list(sm.CAMPAIGN_ARGS),
           "oom_args": list(sm.CAMPAIGN_OOM)}
    for name, extra in (("plain", {}), ("oom", dict(
            fault_injector=FaultInjector.from_string(oom["--fault-inject"]),
            oom_ladder=parse_ladder(oom["--oom-ladder"])))):
        res = CorpusCampaign(corpus, **kw, **extra).run()
        doc[name] = {**res.as_dict(), "issues_detail": res.issues}
        print(f"campaign_default {name}: {res.as_dict()['wall_sec']} s", flush=True)
    with open(os.path.join(FIXTURE_DIR, "campaign_default.json"), "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)


def main(names):
    """Pin the named reports (all of them by default), each in its own
    process so they run side by side."""
    import subprocess

    creation_p, runtime_p = precompiles_files()
    rw = os.path.join("tests", "fixtures", "realworld", "multisig2of3.bin-runtime")
    cli = {
        "multisig2of3_default": ["-f", rw, "-t", "2"],
        "precompiles_default": ["-f", runtime_p, "--creation-code", creation_p],
        "precompiles_test": ["-f", runtime_p, "--creation-code", creation_p,
                             "--limits-profile", "test", "--lanes-per-contract", "16",
                             "--max-steps", "384"],
    }
    if names == ["--fixtures-only"]:
        return _write_fixture()
    arith = os.path.join("tests", "fixtures", "torch_port", "arith.bin-runtime")
    for strat in STRATEGIES:
        cli[f"arith_{strat}"] = ["-f", arith, "--strategy", strat]
        cli[f"arith_{strat}_test"] = ["-f", arith, "--strategy", strat, *ARITH_TEST_ARGS]
        cli[f"arith_{strat}_short"] = ["-f", arith, "--strategy", strat, *ARITH_SHORT_ARGS]
    cli["arith_iprof"] = ["-f", arith, "--enable-iprof"]
    cli["arith_iprof_test"] = ["-f", arith, "--enable-iprof", *ARITH_TEST_ARGS]
    if names == ["erc20_transfer_steps"]:
        return _pin_erc20_steps()
    if names == ["campaign_test"]:
        return _pin_campaign_test()
    if names == ["campaign_default"]:
        return _pin_campaign_default()
    if len(names) == 1 and names[0] in cli:
        return _pin_cli(names[0], cli[names[0]])
    if len(names) == 1:
        return _pin_wrapper(names[0])
    _write_fixture()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), n])
             for n in (names or [*cli, "config4_default", "realworld4_default",
                                 "arith_berlin", "arith_berlin_short", "forkblock4_default",
                                 "erc20_transfer_steps", "campaign_test",
                                 "campaign_default"])]
    if any(p.wait() for p in procs):
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
