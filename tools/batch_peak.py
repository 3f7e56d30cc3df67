"""Peak device memory of the campaign-width batch's engine, and the
engine's loop stages (superstep, fork expansion, propagation, each timed
between device synchronizations) of that batch and of two analyzes at
the CLI defaults, for the PyTorch port found under a given tree of this
repository, so that two trees (say a commit and its parent, unpacked
with ``git archive`` into an ignored directory) can be compared on one
card in one call:

    python3 tools/batch_peak.py [ROOT]   # ROOT: a tree of the repo, default this one

The batch is ``chip_smoke.py`` phase 7's: 16 ERC-20 and 16 ERC-721
runtimes x 64 lanes (P = 2048), the default limits, 512 steps, two
transactions, through ``SymExecWrapper`` on the card. The analyzes are
``analyze -o json`` of the realworld erc20full runtime and of the arith
fixture (bfs) at the CLI defaults (64 lanes, 512 steps, two
transactions). Prints one JSON line a run: the tree, the run, its stage
seconds, its engine or analyze seconds and supersteps, the card, and for
the batch the bytes allocated before it and its peak
(``torch.cuda.max_memory_allocated``). Exits non-zero without a CUDA
device.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.analysis import SymExecWrapper
    from mythril_tpu_torch.config import DEFAULT_LIMITS
    from mythril_tpu_torch.interfaces.cli import main as cli_main
    from mythril_tpu_torch.symbolic.engine import ENGINE_STATS

    if not kernels.__file__.startswith(root + os.sep):
        print(f"FAIL: imported {kernels.__file__}, not the package under {root}", flush=True)
        return 1
    kernels.build()

    def runtime(name):
        with open(os.path.join(root, "tests", "fixtures", "realworld", f"{name}.bin-runtime")) as fh:
            return bytes.fromhex(fh.read().strip().removeprefix("0x"))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    stage_keys = ("superstep_s", "forks_s", "propagate_s")

    def staged(run):
        """run() with the loop's stages timed -> (stages, seconds, supersteps)."""
        ENGINE_STATS.update(timing=True, **dict.fromkeys(stage_keys, 0.0))
        steps0 = ENGINE_STATS["supersteps"]
        t0 = time.monotonic()
        try:
            run()
            torch.cuda.synchronize()
        finally:
            ENGINE_STATS["timing"] = False
        return ({k: ENGINE_STATS[k] for k in stage_keys}, time.monotonic() - t0,
                ENGINE_STATS["supersteps"] - steps0)

    codes = [runtime("erc20full")] * 16 + [runtime("erc721")] * 16
    names = [f"erc20full_{i}" for i in range(16)] + [f"erc721_{i}" for i in range(16)]
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    stages, secs, steps = staged(lambda: SymExecWrapper(
        codes, contract_names=names, limits=DEFAULT_LIMITS, lanes_per_contract=64,
        max_steps=512, transaction_count=2, device=dev))
    print(json.dumps({"root": root, "run": "batch", "allocated_before": before,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "engine_s": secs, "supersteps": steps, "stages": stages, "card": card}),
          flush=True)
    for run, path in (("erc20full", ("realworld", "erc20full.bin-runtime")),
                      ("arith bfs", ("torch_port", "arith.bin-runtime"))):
        argv = ["analyze", "-f", os.path.join(root, "tests", "fixtures", *path), "-o", "json"]
        with contextlib.redirect_stdout(io.StringIO()):
            stages, secs, steps = staged(lambda: cli_main(argv))
        print(json.dumps({"root": root, "run": run, "analyze_s": secs, "supersteps": steps,
                          "stages": stages, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
