"""``myth``-style command line for the PyTorch engine.

Commands: ``analyze`` (``a``), ``list-detectors``, ``version``. The flags
of ``analyze`` are the JAX package's for what this engine runs, plus
``--device {cuda,cpu}`` (default ``cuda``). ``--creation-code PATH``
runs the constructor transaction first; ``--strategy`` takes the six
fork strategies; ``--enable-iprof`` prints the executed-opcode profile
on stderr after the report; ``--plugin-dir DIR`` loads external plugins.
``--checkpoint-dir`` is the campaign's checkpoint directory, as in the
JAX package: single-contract ``analyze`` writes no checkpoint there.
Flags of parts that are not ported yet (corpus
campaigns, RPC loading, the call-depth limit) are accepted by the parser
and refused with an error before any device work.

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
                   help="campaign checkpoint directory (single-contract analyze "
                        "writes none)")
    # accepted so that they can be refused with a clear message
    for flag, meta in (("--corpus", "DIR"), ("-a", "ADDRESS"), ("--rpc", "URI"),
                       ("--call-depth-limit", "N")):
        a.add_argument(flag, metavar=meta, default=None, help="not supported by this engine")
    ld = sub.add_parser("list-detectors", help="list registered detection modules")
    ld.add_argument("--plugin-dir", metavar="DIR", default=None,
                    help="also list the detection modules of the plugins in DIR")
    sub.add_parser("version", help="print version")
    return p


_CUT_FLAGS = (
    ("corpus", "--corpus (campaigns)"),
    ("a", "-a/--address"),
    ("rpc", "--rpc"),
    ("call_depth_limit", "--call-depth-limit"),
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
    if args.command == "version":
        from .. import __version__

        print(f"mythril_tpu_torch {__version__}")
        return 0
    parser.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
