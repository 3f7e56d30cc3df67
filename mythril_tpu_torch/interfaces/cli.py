"""``myth``-style command line for the PyTorch engine.

Commands: ``analyze`` (``a``), ``campaign-merge``, ``list-detectors``,
``version``. The flags of ``analyze`` are the JAX package's for what this
engine runs, plus ``--device {cuda,cpu}`` (default ``cuda``).
``--creation-code PATH`` runs the constructor transaction first;
``--strategy`` takes the six fork strategies; ``--enable-iprof`` prints
the executed-opcode profile on stderr after the report; ``--plugin-dir
DIR`` loads external plugins. ``--corpus DIR`` runs the corpus campaign
(``mythril/campaign.py``) with its batch, watchdog, fault-injection,
OOM-ladder, pipeline, checkpoint and heartbeat flags;
``--checkpoint-dir`` is the campaign's checkpoint directory, as in the
JAX package: single-contract ``analyze`` writes no checkpoint there.
Flags of parts that are not ported yet (RPC loading, the call-depth
limit, fleet campaigns, engine workers, backend tiers, multi-host
splits, the shared verdict store) are accepted by the parser and refused
with an error before any device work.

Run as ``python -m mythril_tpu_torch <command> ...``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mythril_tpu_torch",
        description="symbolic-execution security analyzer for EVM bytecode (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command")
    a = sub.add_parser("analyze", aliases=["a"], help="symbolically analyze bytecode")
    a.add_argument("-f", "--codefile", metavar="PATH",
                   help="file holding runtime bytecode as hex")
    a.add_argument("-c", "--code", metavar="HEX", help="runtime bytecode as a hex string")
    a.add_argument("--creation-code", metavar="PATH",
                   help="file holding CREATION bytecode as hex; enables the "
                        "constructor transaction")
    a.add_argument("--name", default="MAIN", help="contract display name")
    a.add_argument("-t", "--transaction-count", type=int, default=2,
                   help="number of attacker message-call transactions")
    a.add_argument("-m", "--modules", metavar="LIST",
                   help="comma-separated detection-module allow list")
    a.add_argument("-o", "--outform", choices=["text", "markdown", "json", "jsonv2"],
                   default="text")
    a.add_argument("--max-steps", type=int, default=512,
                   help="superstep budget per transaction")
    a.add_argument("--max-depth", type=int, default=None,
                   help="alias of --max-steps (overrides it when given)")
    a.add_argument("--lanes-per-contract", type=int, default=64,
                   help="frontier lanes (seed + fork headroom) per contract")
    a.add_argument("--loop-bound", type=int, default=None,
                   help="max taken backward jumps per loop target")
    a.add_argument("--solver-iters", type=int, default=400,
                   help="witness-search repair iterations per query")
    a.add_argument("--solver-timeout", type=int, default=None, metavar="MS",
                   help="wall-clock budget per solver query, milliseconds")
    a.add_argument("--parallel-solving", action="store_true",
                   help="run detection modules concurrently")
    a.add_argument("--execution-timeout", type=float, default=None,
                   help="wall-clock budget in seconds for the exploration")
    a.add_argument("--create-timeout", type=float, default=None,
                   help="wall-clock budget in seconds for the CREATION "
                        "transaction (constructor) only")
    a.add_argument("--strategy", default="bfs",
                   choices=["bfs", "dfs", "naive-random", "weighted-random",
                            "coverage", "beam"],
                   help="fork-admission policy when frontier slots run short: "
                        "bfs=fifo, dfs=deepest-first, naive-random=unbiased hash "
                        "order, weighted-random=depth-weighted hash, "
                        "coverage=unvisited-target first, beam=capped shallowest-first")
    a.add_argument("--limits-profile", choices=["default", "test"], default="default",
                   help="frontier shape caps ('test' = the small CI shapes)")
    a.add_argument("--concrete-storage", action="store_true",
                   help="model unknown storage as zero instead of symbolic")
    a.add_argument("--unconstrained-storage", action="store_true",
                   help="model unknown storage as fully symbolic (the default)")
    a.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (default: the CUDA card)")
    a.add_argument("--enable-iprof", action="store_true",
                   help="print a per-opcode executed-instruction profile after the report")
    a.add_argument("--plugin-dir", metavar="DIR",
                   help="load external plugins (detection modules and/or laser "
                        "plugins) from every *.py in DIR")
    a.add_argument("--checkpoint-dir", metavar="DIR",
                   help="campaign checkpoint directory (resume-able; single-contract "
                        "analyze writes none)")
    a.add_argument("--corpus", metavar="DIR",
                   help="campaign mode: analyze every *.hex/*.bin under DIR in "
                        "constant-shape batches, with checkpoint/resume; prints a "
                        "throughput+issues JSON")
    a.add_argument("--batch-size", type=int, default=32,
                   help="contracts per batch (campaign mode)")
    a.add_argument("--batch-timeout", type=float, default=None, metavar="SEC",
                   help="campaign mode: hard wall-clock watchdog per batch — a "
                        "wedged device call becomes a batch failure (retried, "
                        "then bisected to quarantine the poison contract)")
    a.add_argument("--init-timeout", type=float, default=None, metavar="SEC",
                   help="campaign mode: deadline for the card's initialization and "
                        "kernel build (or reuse) before the first batch; on "
                        "failure the campaign stops with an error")
    a.add_argument("--max-batch-retries", type=int, default=1, metavar="N",
                   help="campaign mode: whole-batch re-attempts after a failure "
                        "before bisecting it (default 1)")
    a.add_argument("--fault-inject", metavar="SPEC",
                   help="campaign mode (testing): inject deterministic faults, e.g. "
                        "'raise:contract=c002', 'hang:batch=1', "
                        "'raise:batch=0:times=1', 'kill:batch=2', "
                        "'oom:batch=1:times=2'; ';'-separated specs")
    a.add_argument("--oom-ladder", metavar="LIST", default=None,
                   help="campaign mode: comma-separated degradation rungs walked "
                        "(cumulatively) when a batch runs out of memory, from "
                        "'halve-lanes', 'halve-batch', 'next-tier' (alias 'cpu'; "
                        "the card is the only tier, so it replays the batch at the "
                        "current shape on the card); default: halve-lanes,"
                        "halve-batch; 'none' disables degradation — an OOM then "
                        "falls to retry/bisect")
    a.add_argument("--pipeline", dest="pipeline", action="store_true", default=True,
                   help="campaign mode (default ON): overlap batch i's host phase "
                        "(detection modules + witness search) with batch i+1's "
                        "device execution, and write checkpoints from a background "
                        "thread; results are identical to --no-pipeline and any "
                        "fault drains back to the serial retry/bisect path")
    a.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                   help="campaign mode: strictly serial batches")
    a.add_argument("--solver-workers", type=int, default=1, metavar="N",
                   help="threads for the detection-module/witness-search pool in "
                        "the campaign host phase (N>1 implies --parallel-solving)")
    a.add_argument("--checkpoint-every", type=int, default=1, metavar="N",
                   help="campaign mode: durable checkpoint write every N batches "
                        "(default 1 — a kill at any instant loses at most one "
                        "batch)")
    a.add_argument("--heartbeat", type=float, default=None, metavar="SEC",
                   help="campaign mode: print a one-line progress heartbeat to "
                        "stderr at most every SEC seconds")
    # accepted so that they can be refused with a clear message
    for flag, meta in (("-a", "ADDRESS"), ("--rpc", "URI"), ("--call-depth-limit", "N"),
                       ("--fleet", "DIR"), ("--worker-isolation", "MODE"),
                       ("--backend-tiers", "LIST"), ("--num-hosts", "N"),
                       ("--host-index", "I"), ("--solver-store", "DIR")):
        a.add_argument(flag, metavar=meta, default=None, help="not supported by this engine")
    a.add_argument("--fleet-follow", action="store_true", help="not supported by this engine")
    ld = sub.add_parser("list-detectors", help="list registered detection modules")
    ld.add_argument("--plugin-dir", metavar="DIR", default=None,
                    help="also list the detection modules of the plugins in DIR")
    sub.add_parser("version", help="print version")
    cm = sub.add_parser("campaign-merge",
                        help="merge campaign JSON results into corpus-level metrics")
    cm.add_argument("results", nargs="+", metavar="JSON",
                    help="campaign output files (one per run or host)")
    return p


_CUT_FLAGS = (
    ("a", "-a/--address"),
    ("rpc", "--rpc"),
    ("call_depth_limit", "--call-depth-limit"),
    ("fleet", "--fleet (fleet campaigns)"),
    ("fleet_follow", "--fleet-follow (fleet campaigns)"),
    ("worker_isolation", "--worker-isolation (engine workers)"),
    ("backend_tiers", "--backend-tiers (backend tiers)"),
    ("num_hosts", "--num-hosts (multi-host campaigns)"),
    ("host_index", "--host-index (multi-host campaigns)"),
    ("solver_store", "--solver-store (the shared verdict store)"),
)


def _refuse_cuts(args) -> None:
    for attr, what in _CUT_FLAGS:
        if getattr(args, attr, None):
            print(f"error: {what} is not supported by the PyTorch engine yet",
                  file=sys.stderr)
            raise SystemExit(2)


def _discover_plugins(plugin_dir):
    """Outer plugin discovery (entry points + optional directory); errors
    warn on stderr rather than aborting the analysis."""
    from ..plugin import discover

    disc = discover(plugin_dir=plugin_dir)
    for name, err in disc.errors.items():
        print(f"warning: plugin {name}: {err}", file=sys.stderr)
    return disc.laser_plugins


def _limits_for(args):
    from ..config import DEFAULT_LIMITS, TEST_LIMITS

    return TEST_LIMITS if getattr(args, "limits_profile", None) == "test" else DEFAULT_LIMITS


def _load_contracts(args):
    from ..mythril import MythrilDisassembler

    creation = None
    if args.creation_code:
        with open(args.creation_code) as fh:
            creation = fh.read()
    if args.code:
        return [MythrilDisassembler.load_from_bytecode(args.code, creation_code=creation,
                                                       name=args.name)]
    if args.codefile:
        if args.codefile.endswith(".sol"):
            print("error: solidity sources are not supported by the PyTorch engine; "
                  "pass runtime bytecode", file=sys.stderr)
            raise SystemExit(2)
        return [MythrilDisassembler.load_from_file(
            args.codefile, creation_path=args.creation_code, name=args.name)]
    print("error: provide bytecode via -c/--code or -f/--codefile", file=sys.stderr)
    raise SystemExit(2)


def exec_analyze(args) -> int:
    if args.concrete_storage and args.unconstrained_storage:
        print("error: --concrete-storage conflicts with --unconstrained-storage",
              file=sys.stderr)
        raise SystemExit(2)
    _refuse_cuts(args)
    if args.corpus:
        return _exec_campaign(args)
    if args.checkpoint_dir:
        print("warning: --checkpoint-dir has no effect on single-contract analyze "
              "(it is the campaign's checkpoint directory)", file=sys.stderr)
    from ..mythril import MythrilAnalyzer, MythrilConfig
    from ..symbolic import SymSpec

    contracts = _load_contracts(args)
    cfg = MythrilConfig(
        limits=_limits_for(args),
        transaction_count=args.transaction_count,
        max_steps=(args.max_depth if args.max_depth is not None else args.max_steps),
        lanes_per_contract=args.lanes_per_contract,
        solver_iters=args.solver_iters,
        solver_timeout=(args.solver_timeout / 1000.0
                        if args.solver_timeout is not None else None),
        parallel_solving=args.parallel_solving,
        loop_bound=args.loop_bound,
        execution_timeout=args.execution_timeout,
        create_timeout=args.create_timeout,
        strategy=args.strategy,
        spec=SymSpec(storage=not args.concrete_storage),
        enable_iprof=args.enable_iprof,
        plugins=tuple(_discover_plugins(args.plugin_dir)),
        device=args.device,
    )
    analyzer = MythrilAnalyzer(contracts, cfg)
    modules = args.modules.split(",") if args.modules else None
    report = analyzer.fire_lasers(modules=modules)
    if args.outform == "json":
        print(report.as_json())
    elif args.outform == "jsonv2":
        print(report.as_jsonv2())
    elif args.outform == "markdown":
        print(report.as_markdown())
    else:
        print(report.as_text())
    if args.enable_iprof:
        # a separate channel: the report formats stay the same with or
        # without the profiler
        print(analyzer.sym.iprof_table(), file=sys.stderr)
    return 0


def _exec_campaign(args) -> int:
    """Corpus campaign on the card, supervised by the resilience layer
    (watchdog, OOM ladder, retry, bisect-to-quarantine)."""
    import json

    from ..resilience import FaultInjector, parse_ladder

    try:
        oom_ladder = parse_ladder(args.oom_ladder)
        fault_injector = FaultInjector.from_string(args.fault_inject)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)
    from ..mythril.campaign import CorpusCampaign, DeviceInitError, load_corpus_dir
    from ..symbolic import SymSpec

    if args.create_timeout is not None:
        print("warning: --create-timeout has no effect in campaign mode",
              file=sys.stderr)
    campaign = CorpusCampaign(
        load_corpus_dir(args.corpus),
        batch_size=args.batch_size,
        lanes_per_contract=args.lanes_per_contract,
        limits=_limits_for(args),
        spec=SymSpec(storage=not args.concrete_storage),
        max_steps=(args.max_depth if args.max_depth is not None else args.max_steps),
        solver_timeout=(args.solver_timeout / 1000.0
                        if args.solver_timeout is not None else None),
        solver_iters=args.solver_iters,
        parallel_solving=args.parallel_solving,
        transaction_count=args.transaction_count,
        modules=args.modules.split(",") if args.modules else None,
        checkpoint_dir=args.checkpoint_dir,
        execution_timeout=args.execution_timeout,
        plugins=tuple(_discover_plugins(args.plugin_dir)),
        enable_iprof=args.enable_iprof,
        batch_timeout=args.batch_timeout,
        max_batch_retries=args.max_batch_retries,
        fault_injector=fault_injector,
        oom_ladder=oom_ladder,
        checkpoint_every=args.checkpoint_every,
        heartbeat_every=args.heartbeat,
        pipeline=args.pipeline,
        solver_workers=args.solver_workers,
        device=args.device,
        init_timeout=args.init_timeout,
    )

    def progress(done, total, dt, n_issues):
        print(f"batch {done}/{total}: {dt:.1f}s, {n_issues} issue(s) so far",
              file=sys.stderr)

    try:
        res = campaign.run(progress=progress)
    except DeviceInitError as e:
        print(f"error: the card did not come up: {e}", file=sys.stderr)
        return 2
    out = res.as_dict()
    if args.outform in ("json", "jsonv2"):
        out["issues_detail"] = res.issues
    print(json.dumps(out, indent=1))
    return 0


def exec_campaign_merge(args) -> int:
    """Combine campaign result JSONs. A missing or malformed input is a
    one-line error and a clean nonzero exit, never a traceback."""
    import json
    import os

    from ..mythril.campaign import merge_campaigns

    results = []
    for p in args.results:
        if os.path.isdir(p):
            print(f"error: campaign-merge: {p} is a directory; fleet ledgers are not "
                  "supported by the PyTorch engine yet", file=sys.stderr)
            return 2
        try:
            with open(p) as fh:
                doc = json.load(fh)
        except OSError as e:
            print(f"error: campaign-merge: cannot read {p}: "
                  f"{e.strerror or e}", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: campaign-merge: {p} is not valid JSON ({e})",
                  file=sys.stderr)
            return 2
        if not isinstance(doc, dict):
            print(f"error: campaign-merge: {p}: expected a campaign "
                  "result object", file=sys.stderr)
            return 2
        results.append(doc)
    try:
        merged = merge_campaigns(results)
    except ValueError as e:
        print(f"error: campaign-merge: {e}", file=sys.stderr)
        return 2
    print(json.dumps(merged, indent=1))
    return 0


def exec_list_detectors(args) -> int:
    from ..analysis import ModuleLoader

    _discover_plugins(getattr(args, "plugin_dir", None))
    for m in ModuleLoader().get_detection_modules():
        print(f"{m.name} (SWC-{m.swc_id}): {m.description}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = create_parser()
    args = parser.parse_args(argv)
    if args.command in ("analyze", "a"):
        return exec_analyze(args)
    if args.command == "list-detectors":
        return exec_list_detectors(args)
    if args.command == "campaign-merge":
        return exec_campaign_merge(args)
    if args.command == "version":
        from .. import __version__

        print(f"mythril_tpu_torch {__version__}")
        return 0
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
