"""Corpus-scale analysis campaign on the card.

PyTorch counterpart of the static (non-fleet) campaign of the JAX
package's ``mythril/campaign.py``: the engine streams fixed-shape
BATCHES of contracts through the analysis pipeline:

- every batch has exactly ``batch_size`` contracts x
  ``lanes_per_contract`` lanes (short batches pad with a STOP stub), so
  every batch of a run is the same engine shape;
- before the first batch the card is initialized and the kernels are
  built (or reused from an earlier process), under ``init_timeout``, so
  that no batch watchdog and no pacing sample times nvcc;
- a durable JSON checkpoint (issues + batch cursor; checksummed,
  rotated) lands every ``checkpoint_every`` batches; resume verifies
  it, falls back to the rotated copy if the newest write was torn, and
  skips completed batches;
- the campaign report carries contracts/s, paths/s, issues, solver
  statistics and the per-batch wall times;
- execution is fault-isolated: each batch runs under an optional
  wall-clock watchdog, an out-of-memory batch walks the degradation
  ladder (halve lanes, then halve the batch width) instead of failing,
  any other failure is retried then BISECTED so poison contracts are
  quarantined one by one; every step is an event in the report;
- with ``pipeline=True`` (the CLI default) batch *i*'s HOST phase
  (detection modules, witness search, report merge) runs on a worker
  thread while batch *i+1*'s DEVICE phase (corpus packing + the engine)
  runs on the main thread, and checkpoints are written by a background
  writer. Results are identical to the serial path (commits stay in
  batch order; one host phase in flight); any fault drains the pipeline
  back to the serial retry/degrade/bisect machinery.

On the card every batch runs the engine's kernels (K10's split entry
points, K3, K6, K7) through their wrappers, with no fallback: a build or
launch failure raises into the same machinery. Not here yet (the
backend-tier, serving and fleet slices): the engine-worker subprocess,
backend tiers, the compile store and prewarm, resident serve batches
and the fleet ledger.

CLI: ``python -m mythril_tpu_torch analyze --corpus DIR``.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import DEFAULT_LIMITS, DEFAULT_RESILIENCE, LimitsConfig
from ..fleet import corpus_fingerprint
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..resilience import (TIER_RUNG, BatchTimeout, DeviceLostError,
                          FaultInjector, ResilienceError,
                          classify_backend_error, run_with_watchdog)
from ..utils.checkpoint import (BackgroundCheckpointWriter,
                                load_json_checkpoint_resilient,
                                save_json_checkpoint)

# no engine (torch) imports at module level: ``campaign-merge`` is dict
# math over result JSONs and must not pay for, or need, the device stack

log = logging.getLogger(__name__)

#: pad contract for short batches: plain STOP (no paths beyond the seed,
#: no issues, negligible lane cost)
_PAD_BYTECODE = b"\x00"


class DeviceInitError(ResilienceError):
    """The card did not initialize, or its kernels did not build, before
    the first batch (within ``init_timeout``). There is no other tier to
    fall back to: the campaign stops before any batch."""


def load_corpus_dir(path: str) -> List[tuple]:
    """(name, runtime bytecode) for every *.hex / *.bin / *.bin-runtime
    file under ``path`` (hex-encoded, 0x prefix optional), sorted for a
    stable batch order."""
    from ..disassembler.disassembly import _to_bytes

    out = []
    for fn in sorted(os.listdir(path)):
        if not fn.endswith((".hex", ".bin", ".bin-runtime")):
            continue
        with open(os.path.join(path, fn)) as fh:
            text = fh.read().strip()
        if not text:
            continue
        out.append((fn.rsplit(".", 1)[0], _to_bytes(text)))
    if not out:
        raise ValueError(f"no *.hex / *.bin corpus files under {path}")
    return out


@dataclass
class CampaignResult:
    contracts: int = 0
    batches: int = 0
    issues: List[Dict] = field(default_factory=list)
    wall_sec: float = 0.0
    paths_total: int = 0
    dropped_forks: int = 0
    solver: Dict = field(default_factory=dict)
    batch_wall: List[float] = field(default_factory=list)
    iprof: Dict[str, int] = field(default_factory=dict)  # opcode -> count
    # fault isolation: poison contracts the campaign lost, batch-level
    # retry count, per-batch outcome markers, and the event log (device
    # init, degradation steps, checkpoint recoveries)
    quarantined: List[Dict] = field(default_factory=list)
    retries: int = 0
    batch_status: List[str] = field(default_factory=list)
    backend_events: List[Dict] = field(default_factory=list)
    # staged solver-portfolio session delta: per-stage attempts/hits/
    # latency + the Z3-avoided headline
    solver_portfolio: Dict = field(default_factory=dict)

    def as_dict(self) -> Dict:
        # rates derive from the per-batch wall times, which the
        # checkpoint persists — a resumed run must not divide an
        # all-batches numerator by a one-session denominator
        total = sum(self.batch_wall)
        steady = self.batch_wall[1:] or self.batch_wall
        per_batch = self.contracts / self.batches if self.batches else 0.0
        steady_rate = (
            round(per_batch * len(steady) / sum(steady), 3)
            if steady and sum(steady) > 0 else 0.0
        )
        return {
            "contracts": self.contracts,
            "batches": self.batches,
            "issues": len(self.issues),
            "wall_sec": round(total, 3),
            "wall_sec_this_session": round(self.wall_sec, 3),
            "contracts_per_sec": round(
                self.contracts / total, 3) if total else 0.0,
            "contracts_per_sec_steady": steady_rate,
            "contracts_per_min": round(
                self.contracts / total * 60.0, 2) if total else 0.0,
            "paths_total": self.paths_total,
            "paths_per_sec": round(
                self.paths_total / total, 1) if total else 0.0,
            "dropped_forks": self.dropped_forks,
            "solver": self.solver,
            # the silent-false-negative channel: share of solver queries
            # that returned neither sat nor unsat
            "solver_unknown_rate": (
                round(self.solver.get("unknown", 0)
                      / self.solver["attempts"], 4)
                if self.solver.get("attempts") else 0.0
            ),
            "quarantined": self.quarantined,
            "retries": self.retries,
            "batch_status": self.batch_status,
            "backend_events": self.backend_events,
            **({"iprof": self.iprof} if self.iprof else {}),
            **({"solver_portfolio": self.solver_portfolio}
               if self.solver_portfolio else {}),
        }


class CorpusCampaign:
    """Stream a contract corpus through the analysis pipeline in
    constant-shape batches with checkpoint/resume, on ``device`` (the
    card unless the caller asks for ``"cpu"``)."""

    def __init__(
        self,
        contracts: Sequence[tuple],            # (name, runtime bytecode)
        batch_size: int = 32,
        lanes_per_contract: int = 32,
        limits: LimitsConfig = DEFAULT_LIMITS,
        spec=None,                             # None = SymSpec()
        max_steps: int = 256,
        transaction_count: int = 1,
        modules: Optional[Sequence[str]] = None,
        checkpoint_dir: Optional[str] = None,
        execution_timeout: Optional[float] = None,
        plugins: Sequence = (),
        enable_iprof: bool = False,
        solver_timeout: Optional[float] = None,
        solver_iters: int = 400,
        parallel_solving: bool = False,
        batch_timeout: Optional[float] = DEFAULT_RESILIENCE.batch_timeout,
        max_batch_retries: int = DEFAULT_RESILIENCE.max_batch_retries,
        fault_injector: Optional[FaultInjector] = None,
        oom_ladder: Optional[Sequence[str]] = None,
        checkpoint_every: int = DEFAULT_RESILIENCE.checkpoint_every,
        heartbeat_every: Optional[float] = None,
        pipeline: bool = False,
        solver_workers: int = 1,
        device="cuda",
        init_timeout: Optional[float] = None,
    ):
        self.contracts = list(contracts)
        # content identity of the corpus: stamped into campaign
        # checkpoints (a resumed run must prove it is analyzing the same
        # contracts, not just the same count)
        self._corpus_fp = corpus_fingerprint(self.contracts)
        self.batch_size = batch_size
        self.lanes_per_contract = lanes_per_contract
        self.limits = limits
        if spec is None:
            from ..symbolic import SymSpec

            spec = SymSpec()
        self.spec = spec
        self.max_steps = max_steps
        self.transaction_count = transaction_count
        self.modules = list(modules) if modules else None
        self.checkpoint_dir = checkpoint_dir
        self.execution_timeout = execution_timeout
        self.plugins = list(plugins)
        self.enable_iprof = enable_iprof
        self.solver_timeout = solver_timeout
        self.solver_iters = solver_iters
        self.parallel_solving = parallel_solving
        self.device = device
        self.init_timeout = init_timeout
        # resilience layer (resilience.py): a hard per-batch wall-clock
        # watchdog, bounded retry, and poison bisection keep one bad
        # contract from taking down a large run
        self.batch_timeout = batch_timeout
        self.max_batch_retries = max(0, int(max_batch_retries))
        self.fault_injector = fault_injector
        # out-of-memory degradation ladder: rung names from
        # resilience.DEGRADE_RUNGS, walked in order, cumulatively; ()
        # disables (an OOM then falls to retry/bisect)
        self.oom_ladder = tuple(DEFAULT_RESILIENCE.oom_ladder
                                if oom_ladder is None else oom_ladder)
        self.checkpoint_every = max(1, int(checkpoint_every))
        # campaign-level structured events (device init, degradation
        # steps, checkpoint recoveries). Every event carries BOTH clocks
        # plus a session token: wall time (`t`) is comparable across
        # resumed sessions but can step; monotonic (`mono`) orders
        # within a session; `session` lets merge_campaigns keep
        # per-session streams contiguous.
        self._events: List[Dict] = []
        self._session = f"{os.getpid():x}-{int(time.time() * 1000):x}"
        # --heartbeat N prints a one-line progress pulse at most every
        # N seconds
        self.heartbeat_every = heartbeat_every
        self._last_ckpt_mono: Optional[float] = None
        self._last_beat: Optional[float] = None
        # depth-1 batch pipeline: overlap batch i's host phase with
        # batch i+1's device phase; checkpoints go through a background
        # writer. Off = the serial path.
        self.pipeline = bool(pipeline)
        self.solver_workers = max(1, int(solver_workers))
        self._ckpt_writer: Optional[BackgroundCheckpointWriter] = None
        # cumulative overlap accounting for the pipeline_occupancy gauge
        self._pipe_host_sec = 0.0
        self._pipe_hidden_sec = 0.0
        # chunk sizes already run, one set per engine shape class (batch
        # width, lanes, step budget, tx count), shared by every wrapper
        # of that class: the deadline pacing and the compile counter
        # skip a size's first run in this process only once
        self._warm_shapes: Dict[tuple, set] = {}
        # portfolio-stats baseline for this run's deltas (heartbeat
        # Z3-avoided %, per-batch solver_portfolio events, the report)
        self._pstats0: Optional[Dict] = None

    # --- checkpointing -------------------------------------------------
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, "campaign.json")

    @property
    def _shard_stamp(self) -> List:
        """Identity of the corpus as persisted in the campaign
        checkpoint, in the JAX package's layout: hosts (1), host index
        (0), corpus length, and the corpus's CONTENT fingerprint — a
        count alone cannot tell "same corpus" from "same size"."""
        return [1, 0, len(self.contracts), self._corpus_fp]

    def _event(self, kind: str, detail: str = "", **kw) -> None:
        # both clocks on purpose: wall (`t`) survives the checkpoint
        # boundary so resumed sessions' events sort globally; monotonic
        # (`mono`) is step-free within a session; `session` disambiguates
        # when wall clocks of two sessions overlap or run backwards
        e = {"kind": kind, "detail": detail[:300],
             "t": round(time.time(), 3),
             "mono": round(time.monotonic(), 3),
             "session": self._session}
        e.update(kw)
        self._events.append(e)
        obs_trace.event(kind, **{k: v for k, v in e.items() if k != "kind"})
        obs_metrics.REGISTRY.counter(f"campaign_{kind}_total").inc()

    def _load_ckpt(self) -> Dict:
        p = self._ckpt_path
        state = None
        if p is not None:
            # verified load with fallback: a torn newest file (kill -9
            # mid-write) degrades to the rotated last-known-good copy —
            # costing at most the batches since that copy, never the run
            state, src = load_json_checkpoint_resilient(p)
            if state is not None and src != p:
                self._event("checkpoint_recovered", detail=src)
            elif state is None and os.path.exists(p + ".corrupt"):
                # newest corrupt (quarantined aside) and nothing
                # rotated: the torn file was the first checkpoint ever,
                # so no completed batch was durably recorded — a fresh
                # start replays only batch 0
                self._event("checkpoint_reset", detail=p)
        if state is not None:
            # a checkpoint of another corpus indexes DIFFERENT contracts:
            # resuming it would silently skip contracts and
            # double-attribute issues. Refuse the resume: set the stale
            # file aside (so the next save's rotation can't clobber the
            # evidence) and start fresh, with the decision on the event
            # record. Pre-fingerprint checkpoints stamped only
            # [num_hosts, host_index, count]; they keep resuming when
            # those three still match.
            shard = state.get("shard")
            want = self._shard_stamp
            ok = (shard is None or shard == want
                  or (isinstance(shard, list) and len(shard) == 3
                      and shard == want[:3]))
            if not ok:
                self._event(
                    "checkpoint_reset",
                    detail=f"{p}: shard config changed (checkpoint "
                           f"{shard}, current {want}); refusing to "
                           "resume a different corpus slice — starting "
                           "fresh")
                for stale in (p, p + ".1"):
                    if os.path.exists(stale):
                        try:
                            os.replace(stale, stale + ".stale")
                        except OSError:
                            pass
                state = None
            else:
                # resilience fields arrived after the first checkpoint
                # schema; an old (or hand-rewound) file resumes cleanly
                for k, v in (("quarantined", []), ("retries", 0),
                             ("batch_status", []), ("backend_events", [])):
                    state.setdefault(k, v)
                return state
        return {"next_batch": 0, "issues": [], "batch_wall": [],
                "paths_total": 0, "dropped_forks": 0, "iprof": {},
                "solver": {},
                "quarantined": [], "retries": 0, "batch_status": [],
                "backend_events": [],
                "shard": self._shard_stamp}

    @staticmethod
    def _snapshot_state(state: Dict) -> Dict:
        """Shallow-copy the mutable containers so the background writer
        serializes a frozen view while the campaign keeps appending to
        the live ``res`` lists. One level suffices: list/dict ELEMENTS
        (issue dicts, event dicts, iprof counts) are append-only — never
        mutated after they land in the state."""
        return {k: (list(v) if isinstance(v, list)
                    else dict(v) if isinstance(v, dict) else v)
                for k, v in state.items()}

    def _save_ckpt(self, state: Dict) -> None:
        p = self._ckpt_path
        if p is None:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        if self._ckpt_writer is not None:
            # pipelined: serialization + fsync move off the commit path.
            # The durability contract is unchanged (the writer uses the
            # same tmp+fsync+rotate+rename writer); _last_ckpt_mono is
            # stamped when the rename lands, so the heartbeat's ckpt-age
            # stays honest.
            def _durable() -> None:
                self._last_ckpt_mono = time.monotonic()

            self._ckpt_writer.submit(self._snapshot_state(state),
                                     on_durable=_durable)
            return
        # checksummed + fsynced + rotated: a crash never corrupts the
        # cursor, and even a torn rename leaves <p>.1 loadable
        save_json_checkpoint(p, state)
        self._last_ckpt_mono = time.monotonic()

    # --- the card ------------------------------------------------------
    def _init_device(self) -> None:
        """Initialize the card and build (or reuse) the kernels before
        the first batch, under ``init_timeout``: the batch watchdog and
        the pacing then never time nvcc. On the CPU there is nothing to
        initialize."""
        import torch

        from ..device import resolve_device

        dev = resolve_device(self.device)
        if dev.type != "cuda":
            return
        from .. import kernels

        def init():
            torch.zeros(1, device=dev)  # creates the CUDA context
            return kernels.build()

        t0 = time.monotonic()
        try:
            run_with_watchdog(init, self.init_timeout, label="device init")
        except Exception as e:  # noqa: BLE001 — no tier to fall back to
            raise DeviceInitError(
                f"{dev}: {type(e).__name__}: {str(e)[:500]}") from e
        self._event("device_init",
                    detail=f"{torch.cuda.get_device_name(dev)}: kernels "
                           f"{kernels.BUILD_MODE} in "
                           f"{kernels.BUILD_SECONDS:.1f}s",
                    seconds=round(time.monotonic() - t0, 3),
                    build=kernels.BUILD_MODE)

    # --- one engine pass -----------------------------------------------
    def _explore_batch(self, bi: int, names: List[str],
                       codes: List[bytes],
                       lanes: Optional[int] = None,
                       width: Optional[int] = None):
        """DEVICE phase of one batch: pad to the batch width and run the
        exploration (SymExecWrapper packs the corpus and drives the
        engine's chunks). Always padded to ``width`` (default
        ``batch_size``) so every attempt at a given rung is one engine
        shape. ``lanes``/``width`` below their defaults are the
        degradation ladder shrinking the working set: the tighter fork
        capacity is absorbed by the engine's park/spill machinery
        (``defer_starved`` + rebalance) instead of dropping paths.
        Returns the finished wrapper for :meth:`_harvest_batch`."""
        from ..analysis import SymExecWrapper

        width = self.batch_size if width is None else width
        lanes = self.lanes_per_contract if lanes is None else lanes
        names = list(names)
        codes = list(codes)
        # constant shape: pad short batches with STOP stubs
        while len(codes) < width:
            names.append(f"_pad_{len(codes)}")
            codes.append(_PAD_BYTECODE)
        return SymExecWrapper(
            codes, contract_names=names, limits=self.limits,
            spec=self.spec,
            lanes_per_contract=lanes,
            max_steps=self.max_steps,
            solver_iters=self.solver_iters,
            solver_timeout=self.solver_timeout,
            transaction_count=self.transaction_count,
            plugins=self.plugins,
            enable_iprof=self.enable_iprof,
            device=self.device,
            warm_shapes=self._warm_set(lanes, width),
        )

    def _shape_key(self, lanes: Optional[int] = None,
                   width: Optional[int] = None) -> tuple:
        """Identity of one engine shape class: every batch with this key
        packs the same frontier shape (the corpus is padded to ``width``
        contracts x ``lanes`` lanes; max_steps and transaction_count are
        fixed). Degrade rungs shrink lanes/width and thus land in their
        own class."""
        return (self.batch_size if width is None else width,
                self.lanes_per_contract if lanes is None else lanes,
                self.max_steps, self.transaction_count)

    def _warm_set(self, lanes: Optional[int] = None,
                  width: Optional[int] = None) -> set:
        return self._warm_shapes.setdefault(self._shape_key(lanes, width),
                                            set())

    def _harvest_batch(self, bi: int, sym) -> Dict:
        """HOST phase of one batch: detection modules + witness search +
        report merge over a finished exploration. Pure host work (the
        frontier was pulled to numpy during the wrapper's per-tx
        harvest), so the pipelined campaign runs it on a worker thread
        while the NEXT batch explores on the device."""
        from ..analysis import fire_lasers

        report = fire_lasers(
            sym, white_list=self.modules,
            parallel=self.parallel_solving or self.solver_workers > 1,
            workers=(self.solver_workers
                     if self.solver_workers > 1 else None))
        cov = sym.coverage
        issues = []
        for issue in report.issues:
            if issue.contract.startswith("_pad_"):
                continue
            d = issue.as_dict()
            d["batch"] = bi
            issues.append(d)
        return {
            "issues": issues,
            "paths": int(cov.get("surviving_paths", 0)),
            "dropped": int(cov.get("dropped_forks", 0)),
            "iprof": dict(sym.iprof) if self.enable_iprof else {},
        }

    def _exec_batch(self, bi: int, names: List[str], codes: List[bytes],
                    lanes: Optional[int] = None,
                    width: Optional[int] = None) -> Dict:
        """Analyze one (padded) batch; returns the batch's partial
        results. Serial composition of the device + host phases — the
        unit of work the watchdog guards and the bisection replays on
        sub-batches. Each phase runs inside its own span."""
        with obs_trace.timer("device_phase", bi=bi, n=len(names)):
            sym = self._explore_batch(bi, names, codes, lanes, width)
        with obs_trace.timer("host_phase", bi=bi):
            return self._harvest_batch(bi, sym)

    # --- fault isolation ----------------------------------------------
    def _guarded_batch(self, bi: int, items: Sequence[tuple],
                       lanes: Optional[int] = None,
                       width: Optional[int] = None) -> Dict:
        """One attempt: fault-injection check + engine pass, under the
        wall-clock watchdog. A wedged device call surfaces as
        BatchTimeout here instead of stalling the run. ``lanes``/
        ``width`` carry the degradation rung."""
        names = [n for n, _ in items]
        codes = [c for _, c in items]

        def work():
            if self.fault_injector is not None:
                self.fault_injector.fire(batch=bi, contracts=names)
            return self._exec_batch(bi, names, codes, lanes=lanes, width=width)

        return run_with_watchdog(work, self.batch_timeout,
                                 label=f"batch {bi}")

    # --- pipelined phases ------------------------------------------------
    def _device_phase(self, bi: int, items: Sequence[tuple]):
        """Pipelined attempt, first half: fault-injection check + corpus
        packing + exploration, under the watchdog (a wedged device call
        surfaces as BatchTimeout instead of stalling BOTH pipeline
        stages). Returns the finished wrapper for the host phase."""
        names = [n for n, _ in items]
        codes = [c for _, c in items]

        def work():
            if self.fault_injector is not None:
                self.fault_injector.fire(batch=bi, contracts=names)
            return self._explore_batch(bi, names, codes)

        return run_with_watchdog(work, self.batch_timeout,
                                 label=f"batch {bi} device")

    def _host_phase_job(self, bi: int, sym, tctx=None):
        """Worker-thread entry: run the host phase inside a span and
        return ``(out, host_dur, done_mono)`` so the commit side can
        account overlap (hidden host seconds) and worker idle. ``tctx``
        re-enters the submitting thread's trace scope (contextvars
        don't cross the pool boundary on their own)."""
        with obs_trace.apply_context(tctx):
            sp = obs_trace.timer("host_phase", bi=bi).start()
            try:
                # under its own watchdog budget: a wedged witness search
                # must not stall the device side forever
                out = run_with_watchdog(lambda: self._harvest_batch(bi, sym),
                                        self.batch_timeout,
                                        label=f"batch {bi} host")
            finally:
                sp.stop()
        return out, sp.dur or 0.0, time.monotonic()

    @staticmethod
    def _fault_reason(e: BaseException) -> str:
        if isinstance(e, BatchTimeout):
            return f"timeout: {e}"
        if isinstance(e, DeviceLostError):
            return f"device-lost: {e}"
        return f"{type(e).__name__}: {str(e)[:200]}"

    def _degrade_batch(self, bi: int, items: Sequence[tuple],
                       first_err: BaseException) -> Tuple[Dict, str]:
        """Walk the out-of-memory ladder until the batch fits.

        Rungs apply cumulatively — halve the per-contract lanes, then
        additionally halve the batch width (the batch replays as
        half-width sub-batches, each padded to the new shape). The tier
        rung replays at the shape the earlier rungs left: the card is
        the only tier, so there is no tier to demote to and no rung
        moves the batch off the card. Every step lands in the report's
        ``backend_events``; a rung that fails with a NON-OOM error
        re-raises immediately (that failure belongs to the retry/bisect
        machinery, not the ladder). Partial sub-batch results are
        discarded on a failed rung so nothing is counted twice when the
        next rung replays the whole batch. Returns ``(results, rung)``
        of the first rung that completed; raises the last OOM when the
        ladder is exhausted."""
        lanes = self.lanes_per_contract
        width = self.batch_size
        err = first_err
        for rung in self.oom_ladder:
            if rung == "halve-lanes":
                lanes = max(1, lanes // 2)
            elif rung == "halve-batch":
                width = max(1, width // 2)
            else:
                assert rung == TIER_RUNG, rung
            self._event("degrade", detail=self._fault_reason(err),
                        batch=bi, step=rung, lanes=lanes, width=width)
            try:
                out = {"issues": [], "paths": 0, "dropped": 0, "iprof": {}}
                for k in range(0, len(items), width):
                    r = self._guarded_batch(bi, items[k:k + width],
                                            lanes=lanes, width=width)
                    out["issues"].extend(r["issues"])
                    out["paths"] += r["paths"]
                    out["dropped"] += r["dropped"]
                    for op, n in r["iprof"].items():
                        out["iprof"][op] = out["iprof"].get(op, 0) + n
                self._event("degrade_ok", batch=bi, step=rung)
                return out, rung
            except Exception as e:  # noqa: BLE001 — triage below
                err = e
                if classify_backend_error(e) != "oom":
                    raise
                log.warning("batch %d still out of memory after %s (%s)",
                            bi, rung, self._fault_reason(e))
        raise err

    def _run_batch_resilient(self, bi: int,
                             items: Sequence[tuple],
                             first_err: Optional[BaseException] = None
                             ) -> Dict:
        """Full batch → degrade (OOM) / retry → bisect to the poison
        contract(s).

        ``first_err`` is the pipeline's drain entry: the pipelined
        device+host attempt already WAS the first attempt (it fired the
        fault injector exactly once, like a serial first attempt), so
        on its failure the pipeline hands the error here and this
        method skips straight to the degrade/retry/bisect tail —
        attempt counts, events, statuses and quarantine decisions stay
        identical to a serial run hitting the same fault.

        A failure classified as out of memory first walks the
        degradation ladder (shrink lanes, then batch width) — capacity
        pressure is absorbed, not answered with an abort. Any other
        failure (timeout, crash, device error) is retried
        ``max_batch_retries`` times — except a classified compile
        failure, where replaying the identical batch cannot succeed —
        then the batch is bisected until the offending contract(s) are
        isolated and quarantined with a reason. InjectedKill (and real
        signals) still blow through uncheckpointed, which is what the
        resume path is for."""
        out = {"issues": [], "paths": 0, "dropped": 0, "iprof": {},
               "quarantined": [], "retries": 0, "status": "ok"}

        def merge(r: Dict) -> None:
            out["issues"].extend(r["issues"])
            out["paths"] += r["paths"]
            out["dropped"] += r["dropped"]
            for k, v in r["iprof"].items():
                out["iprof"][k] = out["iprof"].get(k, 0) + v

        if first_err is None:
            try:
                merge(self._guarded_batch(bi, items))
                return out
            except Exception as e:  # noqa: BLE001 — isolate, don't die
                err = e
                log.warning("batch %d failed (%s)", bi,
                            self._fault_reason(e))
        else:
            err = first_err
            log.warning("batch %d failed pipelined (%s); draining to the "
                        "serial path", bi, self._fault_reason(err))
        kind = classify_backend_error(err)
        if kind == "oom" and self.oom_ladder:
            try:
                degraded, rung = self._degrade_batch(bi, items, err)
                merge(degraded)
                out["status"] = f"ok-degraded:{rung}"
                return out
            except Exception as e:  # noqa: BLE001 — ladder exhausted
                err = e
                log.warning("batch %d degradation exhausted (%s); "
                            "falling back to retry/bisect", bi,
                            self._fault_reason(e))
        # a classified compile failure deterministically reproduces on
        # an identical replay — skip straight to bisection
        retry_budget = 0 if kind == "compile" else self.max_batch_retries
        for _ in range(retry_budget):
            out["retries"] += 1
            try:
                merge(self._guarded_batch(bi, items))
                out["status"] = "ok-retry"
                return out
            except Exception as e:  # noqa: BLE001
                err = e
        # bisect: a failing group splits in half; a failing singleton is
        # the poison — quarantine it and keep going
        groups = [list(items)]
        while groups:
            g = groups.pop()
            try:
                merge(self._guarded_batch(bi, g))
            except Exception as e:  # noqa: BLE001
                if len(g) == 1:
                    out["quarantined"].append({
                        "name": g[0][0],
                        "reason": self._fault_reason(e),
                        "batch": bi,
                    })
                else:
                    mid = len(g) // 2
                    groups.append(g[mid:])
                    groups.append(g[:mid])
        out["status"] = f"quarantined:{len(out['quarantined'])}"
        return out

    def _portfolio_delta(self) -> Dict:
        """This run's solver-portfolio delta."""
        from ..smt import portfolio as smt_portfolio

        return smt_portfolio.stats_delta(
            smt_portfolio.PORTFOLIO_STATS.snapshot(), self._pstats0)

    def _portfolio_event(self, solver_totals: Optional[Dict]) -> None:
        """Emit the cumulative per-stage solver-portfolio counters as
        one trace event (batch-commit cadence)."""
        if not obs_trace.active():
            return
        d = self._portfolio_delta()
        t = solver_totals or {}
        obs_trace.event("solver_portfolio",
                        queries=d["queries"],
                        z3_avoided_pct=d["z3_avoided_pct"],
                        witness_mismatch=d["witness_mismatch"],
                        stages=d["stages"],
                        attempts=t.get("attempts", 0),
                        sat=t.get("sat", 0), unsat=t.get("unsat", 0),
                        unknown=t.get("unknown", 0))

    def _heartbeat(self, done: int, total: int, res: "CampaignResult",
                   last_out: Dict) -> None:
        """One line of live progress on stderr (plus a ``heartbeat``
        event on the trace bus): contracts done, paths/s, frontier
        occupancy, current rung, Z3-avoided %% (the share of solver
        queries the portfolio resolved before the witness search),
        last-checkpoint age."""
        wall = sum(res.batch_wall)
        contracts = min(done * self.batch_size, len(self.contracts))
        pps = res.paths_total / wall if wall else 0.0
        cpm = contracts / wall * 60.0 if wall else 0.0
        obs_metrics.REGISTRY.gauge(
            "campaign_contracts_per_min",
            help="end-to-end analyzed contracts per minute "
                 "(batch walls, campaign scope)").set(round(cpm, 2))
        # occupancy: the engine gauge when telemetry collected it, else
        # a lane-capacity estimate from the last batch
        occ = obs_metrics.REGISTRY.gauge("frontier_occupancy").value
        if not occ:
            cap = max(1, self.batch_size * self.lanes_per_contract)
            occ = min(1.0, last_out.get("paths", 0) / cap)
        rung = res.batch_status[-1] if res.batch_status else "-"
        z3av = self._portfolio_delta()["z3_avoided_pct"]
        age = (time.monotonic() - self._last_ckpt_mono
               if self._last_ckpt_mono is not None else None)
        age_s = f"{age:.1f}s" if age is not None else "never"
        print(f"heartbeat: batch {done}/{total} contracts {contracts}/"
              f"{len(self.contracts)} c/min {cpm:.1f} paths/s {pps:.1f} "
              f"frontier {100.0 * occ:.0f}% rung {rung} "
              f"z3-avoid {z3av:.0f}% "
              f"ckpt-age {age_s}",
              file=sys.stderr, flush=True)
        obs_trace.event("heartbeat", batch=done, batches_total=total,
                        contracts=contracts,
                        contracts_per_min=round(cpm, 2),
                        paths_per_sec=round(pps, 1),
                        occupancy=round(occ, 4), rung=rung,
                        z3_avoided_pct=z3av,
                        ckpt_age=(round(age, 3) if age is not None
                                  else None))

    # --- the pipelined loop --------------------------------------------
    def _run_pipelined(self, start_batch: int, n_batches: int,
                       deadline: Optional[float], commit) -> None:
        """Depth-1 batch pipeline: batch *i*'s host phase (worker
        thread) overlaps batch *i+1*'s device phase (this thread).

        Invariants that keep results identical to the serial loop:

        - at most ONE host phase is in flight, and ``commit`` runs
          strictly in batch order (batch *i* commits before *i+1*'s
          host phase is even submitted);
        - the fault injector fires once per pipelined attempt, in the
          device phase — the same cadence as a serial first attempt;
        - ANY phase failure drains: the outstanding host phase commits
          first, then the failed batch re-enters
          ``_run_batch_resilient`` with ``first_err`` set, so degrade/
          retry/bisect/quarantine decisions replay the serial machinery
          exactly;
        - an ``InjectedKill`` (or real signal) blows through
          uncommitted, exactly like the serial loop — the resume path
          replays what was never durably recorded, nothing twice.

        Stall telemetry: ``pipeline_stall`` spans with
        ``wait=device-waits-host`` (this loop blocked on an unfinished
        host phase — the device sat idle) and ``wait=host-waits-device``
        (the worker sat idle between host phases), plus a
        ``pipeline_occupancy`` gauge = fraction of host-phase seconds
        hidden behind device execution. The per-batch wall is
        ``device_dur + commit_stall`` — the batch's contribution to the
        campaign's wall-clock."""
        from concurrent.futures import ThreadPoolExecutor

        reg = obs_metrics.REGISTRY
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="host-phase")
        inflight: Optional[Dict] = None
        host_idle_since: Optional[float] = None

        def account_overlap(host_dur: float, stall: float) -> None:
            hidden = max(0.0, host_dur - stall)
            self._pipe_host_sec += host_dur
            self._pipe_hidden_sec += hidden
            reg.counter(
                "pipeline_host_hidden_seconds_total",
                help="host-phase seconds overlapped with device "
                     "execution").inc(hidden)
            reg.gauge(
                "pipeline_occupancy",
                help="fraction of host-phase seconds hidden behind "
                     "device execution").set(
                self._pipe_hidden_sec / self._pipe_host_sec
                if self._pipe_host_sec else 0.0)

        def drain_serial(bi: int, items: Sequence[tuple], err,
                         dev_dur: float, t_wall: float, t_mono: float,
                         stall: float = 0.0) -> None:
            """Pipelined attempt failed: replay the serial machinery
            (skipping the already-paid first attempt) and commit."""
            rec = obs_trace.timer("batch_drain", bi=bi).start()
            out = self._run_batch_resilient(bi, items, first_err=err)
            rec.stop()
            dt = dev_dur + stall + (rec.dur or 0.0)
            obs_trace.complete("batch", dt, t_wall=t_wall, mono=t_mono,
                               bi=bi, n=len(items), pipelined=True,
                               drained=True)
            commit(bi, out, dt)

        def commit_inflight(fl: Dict) -> None:
            nonlocal host_idle_since
            bi = fl["bi"]
            wait_sp = obs_trace.timer("pipeline_stall",
                                      wait="device-waits-host",
                                      bi=bi).start()
            try:
                out, host_dur, done_mono = fl["future"].result()
            except Exception as e:  # noqa: BLE001 — drain to serial
                wait_sp.stop()
                host_idle_since = time.monotonic()
                drain_serial(bi, fl["items"], e, fl["dev_dur"],
                             fl["t_wall"], fl["mono"],
                             stall=wait_sp.dur or 0.0)
                return
            stall = wait_sp.stop()
            host_idle_since = done_mono
            # a clean pipelined attempt is a clean first attempt: same
            # resilience envelope _run_batch_resilient gives its own
            # first-try success (no retries, nothing quarantined)
            out = {"issues": out["issues"], "paths": out["paths"],
                   "dropped": out["dropped"], "iprof": out["iprof"],
                   "quarantined": [], "retries": 0, "status": "ok"}
            reg.counter(
                "pipeline_device_waits_host_seconds_total",
                help="device idle: loop blocked on an unfinished host "
                     "phase").inc(stall)
            account_overlap(host_dur, stall)
            dt = fl["dev_dur"] + stall
            obs_trace.complete("batch", dt, t_wall=fl["t_wall"],
                               mono=fl["mono"], bi=bi, n=fl["n"],
                               pipelined=True,
                               device_dur=round(fl["dev_dur"], 6),
                               host_dur=round(host_dur, 6),
                               stall=round(stall, 6))
            commit(bi, out, dt)

        try:
            for bi in range(start_batch, n_batches):
                if deadline is not None and time.monotonic() >= deadline:
                    break
                items = self.contracts[
                    bi * self.batch_size:(bi + 1) * self.batch_size]
                t_wall, t_mono = time.time(), time.monotonic()
                dev_sp = obs_trace.timer("device_phase", bi=bi,
                                         n=len(items)).start()
                sym = None
                first_err: Optional[BaseException] = None
                try:
                    sym = self._device_phase(bi, items)
                except Exception as e:  # noqa: BLE001 — drained below
                    first_err = e
                dev_dur = dev_sp.stop()
                # commit the PREVIOUS batch only now: its host phase ran
                # concurrently with the device phase that just finished
                if inflight is not None:
                    commit_inflight(inflight)
                    inflight = None
                if first_err is not None:
                    drain_serial(bi, items, first_err, dev_dur,
                                 t_wall, t_mono)
                    continue
                now = time.monotonic()
                if host_idle_since is not None:
                    idle = max(0.0, now - host_idle_since)
                    obs_trace.complete("pipeline_stall", idle,
                                       wait="host-waits-device", bi=bi)
                    reg.counter(
                        "pipeline_host_waits_device_seconds_total",
                        help="worker idle between host phases").inc(idle)
                inflight = {"bi": bi, "items": items, "n": len(items),
                            "dev_dur": dev_dur, "t_wall": t_wall,
                            "mono": t_mono,
                            "future": pool.submit(
                                self._host_phase_job, bi, sym,
                                obs_trace.context_snapshot())}
            if inflight is not None:
                commit_inflight(inflight)
                inflight = None
        finally:
            # no blocking wait: on the kill path a future may still be
            # running its (now-moot) host phase; the worker finishes
            # harmlessly and the pool reaps it
            pool.shutdown(wait=False)

    # --- the campaign --------------------------------------------------
    def run(self, progress=None) -> CampaignResult:
        """Run the campaign: initialize the card (and build or reuse the
        kernels) once, then the batches."""
        from ..smt import portfolio as smt_portfolio

        self._pstats0 = smt_portfolio.PORTFOLIO_STATS.snapshot()
        self._init_device()
        res = self._run_static(progress)
        res.solver_portfolio = smt_portfolio.stats_delta(
            smt_portfolio.PORTFOLIO_STATS.snapshot(), self._pstats0)
        return res

    def _run_static(self, progress=None) -> CampaignResult:
        from ..smt.solver import SOLVER_STATS

        t_start = time.monotonic()
        deadline = (None if self.execution_timeout is None
                    else t_start + self.execution_timeout)
        state = self._load_ckpt()
        state.setdefault("shard", self._shard_stamp)
        res = CampaignResult()
        res.issues = list(state["issues"])
        res.batch_wall = list(state["batch_wall"])
        res.paths_total = int(state["paths_total"])
        res.dropped_forks = int(state["dropped_forks"])
        res.iprof = dict(state.get("iprof", {}))
        res.quarantined = list(state.get("quarantined", []))
        res.retries = int(state.get("retries", 0))
        res.batch_status = list(state.get("batch_status", []))
        # events accumulate like solver stats: prior sessions' events
        # come from the checkpoint, this session's from the campaign
        events_prior = list(state.get("backend_events", []))
        # solver stats accumulate ACROSS sessions: the checkpoint carries
        # the totals from prior (killed/resumed) sessions, this session's
        # delta is added per batch — so the final report's sat/unsat/
        # unknown split covers the whole campaign
        solver_prior = dict(state.get("solver", {}))
        stats_at_start = SOLVER_STATS.snapshot()

        def session_events() -> List[Dict]:
            return events_prior + list(self._events)

        n_batches = (len(self.contracts) + self.batch_size - 1) // self.batch_size
        dirty = [False]  # mutable: commit() below flips it
        start_batch = int(state["next_batch"])
        reg = obs_metrics.REGISTRY

        def commit(bi: int, out: Dict, dt: float) -> None:
            """Merge one finished batch into the result + checkpoint
            state. BOTH loops (serial below, pipelined) call this
            strictly in batch order — it is the single accounting
            point, which is what makes a pipelined run's results
            identical to a serial run's."""
            obs_trace.event("batch_status", bi=bi, status=out["status"],
                            dur=round(dt, 6))
            reg.counter("batches_total").inc()
            reg.histogram("batch_seconds",
                          help="per-batch wall time").observe(dt)
            reg.counter("batch_retries_total").inc(out["retries"])
            reg.counter("contracts_quarantined_total").inc(
                len(out["quarantined"]))
            res.issues.extend(out["issues"])
            res.batch_wall.append(dt)
            res.paths_total += out["paths"]
            res.dropped_forks += out["dropped"]
            for name, n in out["iprof"].items():
                res.iprof[name] = res.iprof.get(name, 0) + n
            res.quarantined.extend(out["quarantined"])
            res.retries += out["retries"]
            res.batch_status.append(out["status"])
            # safe to read here even in pipelined mode: solver queries
            # only run in host phases, which are committed in order and
            # never concurrently with this call
            sess = SOLVER_STATS.delta(stats_at_start)
            state.update(next_batch=bi + 1, issues=res.issues,
                         batch_wall=res.batch_wall,
                         paths_total=res.paths_total,
                         dropped_forks=res.dropped_forks,
                         iprof=res.iprof,
                         quarantined=res.quarantined,
                         retries=res.retries,
                         batch_status=res.batch_status,
                         backend_events=session_events(),
                         solver={k: round(solver_prior.get(k, 0) + v, 3)
                                 for k, v in sess.items()})
            # --checkpoint-every N: durable write every N batches (and
            # always after the last); a kill between writes replays at
            # most N batches whose results were never persisted — no
            # contract is ever counted twice
            if (bi + 1 - start_batch) % self.checkpoint_every == 0 \
                    or bi + 1 == n_batches:
                self._save_ckpt(state)
                dirty[0] = False
            else:
                dirty[0] = True
            # solver gauges mirror the accumulated campaign totals
            for k, v in state["solver"].items():
                if isinstance(v, (int, float)):
                    reg.gauge(f"solver_{k}").set(v)
            self._portfolio_event(state["solver"])
            if progress is not None:
                progress(bi + 1, n_batches, dt, len(res.issues))
            if self.heartbeat_every is not None:
                now = time.monotonic()
                if (self._last_beat is None
                        or now - self._last_beat >= self.heartbeat_every):
                    self._last_beat = now
                    self._heartbeat(bi + 1, n_batches, res, out)

        self._ckpt_writer = None
        if self.pipeline and self._ckpt_path is not None:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            self._ckpt_writer = BackgroundCheckpointWriter(self._ckpt_path)
        try:
            if self.pipeline:
                self._run_pipelined(start_batch, n_batches, deadline,
                                    commit)
            else:
                for bi in range(start_batch, n_batches):
                    if (deadline is not None
                            and time.monotonic() >= deadline):
                        break
                    batch = self.contracts[
                        bi * self.batch_size:(bi + 1) * self.batch_size]
                    with obs_trace.timer("batch", bi=bi,
                                         n=len(batch)) as sp:
                        out = self._run_batch_resilient(bi, batch)
                    commit(bi, out, sp.elapsed)
            if dirty[0]:
                # deadline (or loop-exit) with unpersisted batches:
                # flush so the paid work survives the session
                self._save_ckpt(state)
            if self._ckpt_writer is not None:
                # the last submitted snapshot must be durable before the
                # result is reported — close() flushes, then joins
                self._ckpt_writer.close()
                self._ckpt_writer = None
        except BaseException:
            # a (simulated) kill or unhandled fault must NOT flush the
            # queued checkpoint snapshot: a real SIGKILL would not have.
            # An already-started write completes (or tears — the
            # loaders' checksum + rotation fallback covers both).
            if self._ckpt_writer is not None:
                self._ckpt_writer.close(discard_pending=True)
                self._ckpt_writer = None
            raise

        res.batches = len(res.batch_wall)
        res.contracts = min(res.batches * self.batch_size, len(self.contracts))
        res.wall_sec = time.monotonic() - t_start
        res.backend_events = session_events()
        sess = SOLVER_STATS.delta(stats_at_start)
        res.solver = {k: round(solver_prior.get(k, 0) + v, 3)
                      for k, v in sess.items()}
        return res


def merge_campaigns(results: Sequence[Dict]) -> Dict:
    """Combine campaign result dicts (``as_dict()`` shape, with optional
    ``issues_detail``) into corpus-level metrics, as the JAX package
    merges per-host results: hosts run CONCURRENTLY, so the merged
    wall-clock is the slowest input's, and throughput is the total over
    that wall-clock. Fleet results (a ``fleet.units`` list, the JAX
    package's work-unit ledger) need the fleet slice and are refused
    with ``ValueError``."""
    for r in results:
        if isinstance((r.get("fleet") or {}).get("units"), list):
            raise ValueError("fleet results (work-unit ledgers) are not "
                             "supported by the PyTorch engine yet")
    merged: Dict = {
        "hosts": len(results),
        "contracts": sum(r.get("contracts", 0) for r in results),
        "batches": sum(r.get("batches", 0) for r in results),
        "issues": sum(r.get("issues", 0) for r in results),
        "wall_sec": max((r.get("wall_sec", 0.0) for r in results),
                        default=0.0),
        "paths_total": sum(r.get("paths_total", 0) for r in results),
        "dropped_forks": sum(r.get("dropped_forks", 0) for r in results),
        # resilience fields: quarantine entries already carry their
        # input's batch index; concatenation in input order keeps them
        # auditable
        "quarantined": [q for r in results
                        for q in (r.get("quarantined") or [])],
        "retries": sum(r.get("retries", 0) for r in results),
        "batch_status": [s for r in results
                         for s in (r.get("batch_status") or [])],
        # per-session event ordering preserved: sorted() is stable, so
        # events WITHIN one session keep their emission order even where
        # timestamps tie or are missing; events without session/t sort
        # first as one group
        "backend_events": sorted(
            (e for r in results for e in (r.get("backend_events") or [])),
            key=lambda e: (str(e.get("session", "")),
                           float(e.get("t", 0.0))
                           if isinstance(e.get("t", 0.0), (int, float))
                           else 0.0)),
    }
    wall = merged["wall_sec"]
    merged["contracts_per_sec"] = (
        round(merged["contracts"] / wall, 3) if wall else 0.0)
    merged["paths_per_sec"] = (
        round(merged["paths_total"] / wall, 1) if wall else 0.0)
    solver: Dict = {}
    for src in results:
        for k, v in (src.get("solver") or {}).items():
            if isinstance(v, (int, float)):
                solver[k] = solver.get(k, 0) + v
    merged["solver"] = solver
    merged["solver_unknown_rate"] = (
        round(solver.get("unknown", 0) / solver["attempts"], 4)
        if solver.get("attempts") else 0.0)
    iprof: Dict[str, int] = {}
    for src in results:
        for k, v in (src.get("iprof") or {}).items():
            iprof[k] = iprof.get(k, 0) + v
    if iprof:
        merged["iprof"] = iprof
    detail = [i for r in results for i in r.get("issues_detail", [])]
    if detail:
        merged["issues_detail"] = detail
    return merged
