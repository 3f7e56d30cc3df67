"""SymExecWrapper + AnalysisContext: wire the engine to the modules.

PyTorch counterpart of the JAX package's ``analysis/symbolic.py``. The
wrapper builds the corpus + frontier on the device, runs the chunked
``sym_run`` loop per transaction (with ``--execution-timeout`` pacing),
and after each transaction hands the detection modules an
:class:`AnalysisContext` holding a numpy snapshot of the frontier
(``SymFrontier.to_numpy()``) — the host side reads fields by name, as it
does on the JAX frontier.

Supported: single-contract and batched analysis with call frames and
precompiles, creation transactions (``creation_bytecodes``), the six
fork strategies, fork blocks with host-seam rebalancing and in-loop
migration, spill/defer of starved forks, the istanbul and berlin gas
schedules, the instruction profiler, frontier checkpoints with resume,
and laser plugins. Refused before any device work
(``UnsupportedConfiguration``): dynamic loading.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_LIMITS, LimitsConfig
from ..core import Corpus, make_env
from ..core import interpreter as ci
from ..core.frontier import ATTACKER_ADDRESS, CAP_TRAPS, CREATOR_ADDRESS, TRAP_NAMES
from ..device import resolve_device
from ..disassembler import ContractImage
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..smt.eval import Assignment
from ..smt.solver import solve_tape
from ..smt.tape import (HostNode, HostTape, TapeHostCache, extract_tape,
                        intern_node)
from ..symbolic import SymSpec, between_txs, make_sym_frontier, sym_run
from ..symbolic.engine import rebalance_parked
from ..utils.checkpoint import load_frontier_resilient, save_frontier
from ..support import UnsupportedConfiguration

log = logging.getLogger(__name__)


@dataclass
class AnalysisContext:
    """Batched view of one finished exploration, handed to modules."""

    sf: object               # final SymFrontier, numpy leaves (to_numpy)
    corpus: object           # the Corpus, numpy leaves
    limits: LimitsConfig
    contract_names: List[str]
    solver_iters: int = 400
    solver_timeout: Optional[float] = None  # seconds per query (None = off)
    # lanes newly errored during THIS transaction, per trap name (filled by
    # SymExecWrapper; None for standalone contexts, where coverage falls
    # back to reading the snapshot directly)
    trap_counts: Optional[Dict[str, int]] = None
    # exploration of this tx stopped on the wall-clock deadline, not
    # quiescence (reference: --execution-timeout degrade, SURVEY §5.3)
    timed_out: bool = False
    _tapes: Dict[int, HostTape] = field(default_factory=dict)
    _tape_cache: Optional[TapeHostCache] = field(default=None, repr=False)
    _tape_idx: Dict[int, dict] = field(default_factory=dict, repr=False)

    def lanes(self, include_errors: bool = False,
              include_reverted: bool = False) -> np.ndarray:
        """Lane indices that hold surviving paths. Exceptional halts are
        discarded like the reference's VmException states; reverted paths
        are excluded by default — a reverting transaction has no effect,
        so predicates witnessed only on a revert path (e.g. the guard
        branch of a SafeMath add) are not findings. The Exceptions module
        opts into error lanes explicitly."""
        act = np.asarray(self.sf.base.active)
        err = np.asarray(self.sf.base.error)
        rev = np.asarray(self.sf.base.reverted)
        keep = act.copy()
        if not include_errors:
            keep &= ~err
        if not include_reverted:
            keep &= ~rev
        return np.where(keep)[0]

    def tape(self, lane: int) -> HostTape:
        if lane not in self._tapes:
            if self._tape_cache is None:
                self._tape_cache = TapeHostCache(self.sf)
            self._tapes[lane] = extract_tape(self.sf, lane,
                                             cache=self._tape_cache)
        return self._tapes[lane]

    def tape_index(self, lane: int) -> dict:
        """Cached ``node_index`` of the lane's base tape. Callers that
        intern extra nodes must COPY it (``dict(...)``) first — the cached
        index must keep describing the unmutated base tape."""
        if lane not in self._tape_idx:
            from ..smt.tape import node_index

            self._tape_idx[lane] = node_index(self.tape(lane).nodes)
        return self._tape_idx[lane]

    def solve(self, lane: int, extra_constraints=(),
              extra_nodes=()) -> Optional[Assignment]:
        """Witness for the lane's path condition + extra (node, sign)
        constraints. ``extra_nodes`` are INTERNED onto the tape (callers
        still address them as if appended at ``len(tape.nodes)+k`` —
        constraint ids in that range are remapped): a predicate node the
        path already carries shares its id, so an already-asserted
        opposite sign becomes a provable polarity conflict (unsat)
        instead of an exhausted witness search (unknown)."""
        from ..symbolic.ops import SymOp

        base = self.tape(lane)
        nodes = list(base.nodes)
        idx = dict(self.tape_index(lane))
        n0 = len(nodes)
        remap = []
        for n in extra_nodes:
            # an extra node may reference an earlier extra node by its
            # pre-intern (positional) id — but ONLY ops whose operands
            # ARE node ids get remapped: FREE carries (kind, index) and
            # CONST carries payload, either of which can numerically
            # exceed n0 without being a reference
            a, b = n.a, n.b
            if n.op not in (int(SymOp.FREE), int(SymOp.CONST)):
                a = remap[a - n0] if a >= n0 else a
                b = remap[b - n0] if b >= n0 else b
            remap.append(intern_node(nodes, HostNode(n.op, a, b, n.imm), idx))
        cons = list(base.constraints) + [
            (remap[i - n0] if i >= n0 else i, s)
            for i, s in extra_constraints
        ]
        t = HostTape(nodes=nodes, constraints=cons)
        return solve_tape(t, max_iters=self.solver_iters,
                          max_time=self.solver_timeout)

    def contract_of(self, lane: int) -> int:
        return int(np.asarray(self.sf.base.contract_id[lane]))

    def cid_name(self, cid: int) -> str:
        """Display name for a recorded contract id (modules should prefer a
        per-event ``*_cid`` over ``contract_of``: an event recorded inside a
        callee frame belongs to the callee's code, not the lane's home
        contract)."""
        if 0 <= cid < len(self.contract_names):
            return self.contract_names[cid]
        return f"contract_{cid}"

    def contract_name(self, lane: int) -> str:
        return self.cid_name(self.contract_of(lane))

    def tx_sequence(self, asn: Assignment) -> List[dict]:
        """Render a witness as the reference-style concrete tx list (one
        entry per symbolic transaction). All `calldatasize` bytes are
        emitted — trimming zeros would change CALLDATASIZE on replay and
        can flip size-check branches."""
        from ..symbolic.ops import FreeKind

        origin = asn.scalars.get((int(FreeKind.ORIGIN), 0), asn.caller)
        out = []
        for t in asn.txs:
            size = t.calldatasize if t.calldatasize is not None else len(t.calldata)
            size = max(0, min(size, len(t.calldata)))
            out.append({
                "input": "0x" + bytes(t.calldata[:size]).hex(),
                "value": hex(t.callvalue),
                "origin": hex(origin),
                "caller": hex(t.caller),
            })
        return out


def _count_traps(err_code: np.ndarray) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for code, name in TRAP_NAMES.items():
        n = int((err_code == code).sum())
        if n:
            out[name] = n
    return out


def coverage_summary(tx_contexts) -> dict:
    """Lost-coverage accounting over a run's per-tx context snapshots.

    The reference silently discards VmException states; here every loss
    channel is counted so parity claims are auditable (VERDICT.md round-1
    weak #4): lanes errored per trap cause, forks dropped to capacity,
    saturated event logs, and propagation kills.
    """
    final = tx_contexts[-1].sf
    limits = tx_contexts[-1].limits
    errored: dict = {}
    if all(c.trap_counts is not None for c in tx_contexts):
        # per-tx tallies (exact even when expand_forks recycled an errored
        # lane's slot in a later transaction)
        for c in tx_contexts:
            for name, n in c.trap_counts.items():
                errored[name] = errored.get(name, 0) + n
    else:
        errored = _count_traps(np.asarray(final.base.err_code))
    cap_names = {TRAP_NAMES[c] for c in CAP_TRAPS}
    cap_lost = sum(n for name, n in errored.items() if name in cap_names)
    # event logs reset per tx, so saturation counts sum across snapshots
    sat_calls = sum(
        int((np.asarray(c.sf.n_calls) > limits.call_log).sum()) for c in tx_contexts
    )
    sat_arith = sum(
        int((np.asarray(c.sf.n_arith) > limits.arith_log).sum()) for c in tx_contexts
    )
    out = {
        "lanes": int(np.asarray(final.base.active).shape[0]),
        "surviving_paths": int(
            (np.asarray(final.base.active) & ~np.asarray(final.base.error)).sum()
        ),
        "lanes_errored": errored,
        "lanes_lost_to_caps": cap_lost,
        "dropped_forks": int(np.asarray(final.dropped_total)),
        "killed_infeasible": int(np.asarray(final.killed_total)),
        "saturated_call_logs": sat_calls,
        "saturated_arith_logs": sat_arith,
    }
    if any(getattr(c, "timed_out", False) for c in tx_contexts):
        still_running = int((np.asarray(final.base.active)
                             & ~np.asarray(final.base.halted)
                             & ~np.asarray(final.base.error)).sum())
        out["deadline_expired_running"] = still_running
    return out


class SymExecWrapper:
    """Build + run the symbolic exploration for a batch of contracts on
    ``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).

    ``creation_bytecodes`` enables the creation transaction: each lane
    first runs its contract's CREATION bytecode with the CREATOR as
    caller, keeps the constructor's storage writes, then switches to the
    runtime image for the ``transaction_count`` attacker message calls.
    The corpus holds the creation images at ``[0, C)`` and the runtime
    images at ``[C, 2C)``; ``create_timeout`` bounds the constructor run
    alone.

    ``strategy`` picks the fork-admission policy, ``fork_block`` confines
    fork copies to lane blocks (with ``spill``, starved lanes migrate
    between blocks every ``migrate_every`` supersteps and at chunk
    seams), ``enable_iprof`` keeps the executed-opcode profile
    (:attr:`iprof`). ``checkpoint_dir`` saves ``frontier.npz`` at every
    chunk seam; ``resume_from`` (such a file, written by this package or
    the JAX one) restarts the run at the checkpoint's transaction and
    step, and the transactions before it contribute no detection
    context. ``warm_shapes`` is the set of chunk sizes already run in
    this process (a campaign passes one per engine shape class): the
    ``--execution-timeout`` pacing takes no sample from a size's first
    run, which pays the kernel build."""

    def __init__(
        self,
        bytecodes: Sequence[bytes],
        contract_names: Optional[Sequence[str]] = None,
        contract_addrs: Optional[Sequence[int]] = None,
        limits: LimitsConfig = DEFAULT_LIMITS,
        spec: SymSpec = SymSpec(),
        lanes_per_contract: int = 64,
        max_steps: int = 512,
        solver_iters: int = 400,
        solver_timeout: Optional[float] = None,
        transaction_count: int = 1,
        execution_timeout: Optional[float] = None,
        deadline_chunk_steps: int = 64,
        plugins: Sequence = (),
        strategy: str = "bfs",
        spill: bool = True,
        fork_block: int = 0,
        device="cuda",
        creation_bytecodes: Optional[Sequence[bytes]] = None,
        create_timeout: Optional[float] = None,
        checkpoint_dir: Optional[str] = None,
        enable_iprof: bool = False,
        dyn_loader=None,
        migrate_every: int = 8,
        resume_from: Optional[str] = None,
        warm_shapes: Optional[set] = None,
    ):
        from ..plugin.loader import LaserPluginLoader

        # the one cut of this engine is refused here, before any device work
        if dyn_loader is not None:
            raise UnsupportedConfiguration("dynamic loading (--rpc) is not supported by "
                                           "the PyTorch engine yet")
        names = list(contract_names or [f"contract_{i}" for i in range(len(bytecodes))])
        dev = resolve_device(device)
        self.device = dev

        self.plugin_loader = LaserPluginLoader()
        for p in plugins:
            self.plugin_loader.load(p)
        self.limits = limits
        self.spec = spec
        self.max_steps = max_steps
        # reference strategy names -> fork-admission policies (the frontier
        # is breadth-first by construction; the policy decides which forks
        # to admit when slots run short)
        self.fork_policy = {"bfs": "fifo", "dfs": "deep", "shallow": "shallow",
                            "deep": "deep", "fifo": "fifo", "naive-random": "random",
                            "random": "random", "weighted-random": "weighted",
                            "weighted": "weighted", "coverage": "coverage",
                            "beam": "beam"}[strategy]
        self.timed_out = False
        self.checkpoint_dir = checkpoint_dir
        self.spill = spill
        self.fork_block = fork_block
        # in-loop migration only matters with blocked compaction and spill
        self.migrate_every = migrate_every if spill else 0
        self._parked_end = 0
        self._rebalanced = 0
        self._chunk = max(1, deadline_chunk_steps)
        # chunk sizes this process has run already (for a campaign: one
        # set per engine shape class, shared by its batches); the first
        # run of a size pays the kernel build and is not a pacing sample
        self._warm_chunk_shapes = set() if warm_shapes is None else warm_shapes
        self._deadline_at = (None if execution_timeout is None
                             else time.monotonic() + execution_timeout)
        images = [ContractImage.from_bytecode(c, limits.max_code) for c in bytecodes]
        C = len(images)
        with_creation = creation_bytecodes is not None
        if with_creation:
            assert len(creation_bytecodes) == C
            # corpus layout: creation images [0, C), runtime images [C, 2C)
            images = [ContractImage.from_bytecode(c, limits.max_code)
                      for c in creation_bytecodes] + images
            names = [f"{n} (constructor)" for n in names] + names
        runtime_base = C if with_creation else 0
        self.images = images
        self.corpus = Corpus.from_images(images, dev)
        corpus_host = self.corpus.to_numpy()
        self._visited = torch.zeros((len(images), limits.max_code), dtype=torch.bool,
                                    device=dev)
        P = C * lanes_per_contract
        cid0 = np.repeat(np.arange(C, dtype=np.int32), lanes_per_contract)
        active = np.zeros(P, dtype=bool)
        active[::lanes_per_contract] = True  # one seed lane per contract
        sf = make_sym_frontier(
            P, limits, contract_id=cid0, active=active, n_contracts=C,
            contract_addrs=(list(contract_addrs) if contract_addrs is not None else None),
            caller=CREATOR_ADDRESS if with_creation else ATTACKER_ADDRESS, device=dev,
        )
        if with_creation:
            # the account table resolves calls/extcode against RUNTIME images
            b = sf.base
            sf = sf.replace(base=b.replace(
                acct_code=torch.where(b.acct_code >= 0, b.acct_code + C, b.acct_code)))
        # instruction profiler: per-lane histograms ride the frontier and
        # are harvested (with the residual sidecar) at each tx boundary
        self.enable_iprof = enable_iprof
        self._iprof = np.zeros(256, dtype=np.int64)
        if enable_iprof:
            sf = sf.replace(base=sf.base.attach_iprof())
        resume_tx = resume_steps = 0
        if resume_from is not None:
            sf, meta, _ = load_frontier_resilient(resume_from, sf)
            resume_tx, resume_steps = int(meta.get("tx", 0)), int(meta.get("steps_done", 0))
        env = make_env(P, device=dev)
        self.tx_contexts: List[AnalysisContext] = []

        def run_chunk(sf, n, defer):
            sf, vis = sym_run(sf, env, self.corpus, spec, limits, max_steps=n,
                              fork_block=self.fork_block, track_coverage=True,
                              fork_policy=self.fork_policy, defer_starved=defer,
                              migrate_every=self.migrate_every)
            self._visited |= vis
            return sf

        def seam(sf):
            """ONE device->host transfer per chunk boundary, shared by the
            rebalance planner, the gauges and the quiescence check."""
            b = sf.base
            ci.HOST_SYNCS["count"] += 1
            both = torch.stack([b.active, sf.fork_req, b.running]).cpu().numpy()
            return both[0], both[1], both[2]

        def explore(sf, steps_done=0):
            """One transaction's exploration from ``steps_done``, chunked
            (the JAX wrapper's spill/deadline/checkpoint path: chunk,
            chunk//4 and tail sizes). Without spill, deadline and
            checkpoints the whole budget is one call, as in JAX."""
            if (self._deadline_at is None and self.checkpoint_dir is None
                    and not self.spill):
                with obs_trace.span("superstep", tx=self._cur_tx, steps=max_steps):
                    return run_chunk(sf, max_steps, False)
            sec_per_step = 0.0
            q = max(1, self._chunk // 4)
            while steps_done < max_steps:
                n = min(self._chunk, max_steps - steps_done)
                if q < n < self._chunk:
                    n = q
                if (self._deadline_at is not None and sec_per_step
                        and n == self._chunk):
                    remaining = self._deadline_at - time.monotonic()
                    if remaining < sec_per_step * n:
                        n = q
                cold = n not in self._warm_chunk_shapes
                with obs_trace.timer("superstep", tx=self._cur_tx, steps=n,
                                     done=steps_done, cold=cold) as sp:
                    sf = run_chunk(sf, n, self.spill)
                # a size's first run pays the kernel build: not a sample
                if cold:
                    self._warm_chunk_shapes.add(n)
                    obs_metrics.REGISTRY.counter(
                        "engine_compiles_total",
                        help="distinct chunk shapes compiled").inc()
                else:
                    sec_per_step = max(sec_per_step, sp.elapsed / n)
                obs_metrics.REGISTRY.counter("engine_supersteps_total").inc(n)
                steps_done += n
                act_h, freq_h, run_h = seam(sf)
                if self.spill:
                    sf, moved = rebalance_parked(sf, self.fork_block, act_h, freq_h)
                    self._rebalanced += moved
                self.plugin_loader.fire("on_chunk", sf, steps_done)
                if self.checkpoint_dir is not None:
                    self._save_checkpoint(sf, steps_done)
                if not bool(run_h.any()):
                    break
                if (self._deadline_at is not None
                        and time.monotonic() >= self._deadline_at):
                    self.timed_out = True
                    break
            if self.spill:
                # drain: lanes still parked at budget end re-raise their
                # forks for bounded extra chunks
                act_h, freq_h, _ = seam(sf)
                parked = freq_h & act_h
                for _ in range(4):
                    if not parked.any():
                        break
                    if self.timed_out or (self._deadline_at is not None
                                          and time.monotonic() >= self._deadline_at):
                        break
                    sf, moved = rebalance_parked(sf, self.fork_block, act_h, freq_h)
                    self._rebalanced += moved
                    with obs_trace.span("superstep", tx=self._cur_tx,
                                        steps=self._chunk, drain=True):
                        sf = run_chunk(sf, self._chunk, True)
                    act_h, freq_h, _ = seam(sf)
                    parked = freq_h & act_h
                self._parked_end += int(parked.sum())
            return sf

        def run_one_tx(sf, is_last: bool, handoff_kw=None):
            self.plugin_loader.fire("on_tx_start", self._cur_tx, sf)
            sf = explore(sf, resume_steps if self._cur_tx == resume_tx else 0)
            with obs_trace.span("harvest", tx=self._cur_tx):
                host = sf.to_numpy()
                trap_counts = _count_traps(host.base.err_code)
                ctx = AnalysisContext(
                    sf=host, corpus=corpus_host, limits=limits,
                    contract_names=names, solver_iters=solver_iters,
                    solver_timeout=solver_timeout,
                    trap_counts=trap_counts, timed_out=self.timed_out,
                )
                self.tx_contexts.append(ctx)
                if self.enable_iprof:
                    # every lane's row plus the sidecar of orphaned rows
                    self._iprof += (host.base.op_hist.sum(0, dtype=np.int64)
                                    + host.base.op_resid)
                    b = sf.base
                    sf = sf.replace(base=b.replace(op_hist=torch.zeros_like(b.op_hist),
                                                   op_resid=torch.zeros_like(b.op_resid)))
            self.plugin_loader.fire("on_tx_end", ctx)
            if not is_last:
                kw = dict(handoff_kw or {})
                # with a creation tx, the first MESSAGE call is tx_id 1 —
                # the dependency pruner must not retire its paths
                kw.setdefault("first_message_tx", 1 if with_creation else 0)
                sf = between_txs(sf, **kw)
            return sf

        self._cur_tx = 0
        self.plugin_loader.fire("initialize", self)
        if with_creation and resume_tx == 0:
            # --create-timeout narrows the deadline for the constructor run
            # only; hitting it must not cancel the message-call phase
            outer_deadline = self._deadline_at
            if create_timeout is not None:
                cdl = time.monotonic() + create_timeout
                self._deadline_at = cdl if outer_deadline is None else min(outer_deadline, cdl)
            cid_runtime = torch.as_tensor(cid0 + runtime_base, device=dev)
            # a constructor needn't mutate storage for the deploy to count
            sf = run_one_tx(sf, is_last=False, handoff_kw=dict(
                require_mutation=False, new_contract_id=cid_runtime))
            self._cur_tx += 1
            if create_timeout is not None:
                self._deadline_at = outer_deadline
                if self.timed_out and (outer_deadline is None
                                       or time.monotonic() < outer_deadline):
                    self.timed_out = False
        self._cur_tx = max(self._cur_tx, resume_tx)
        first_msg = 1 if with_creation else 0
        for t in range(self._cur_tx - first_msg, transaction_count):
            if self.timed_out:
                break
            if not ci.host_bool(torch.any(sf.base.active)):
                break  # nothing survived: no state left to extend
            sf = run_one_tx(sf, is_last=(t == transaction_count - 1))
            self._cur_tx += 1
        self.sf = sf
        self.ctx = self.tx_contexts[-1]
        self.visited = self._visited.cpu().numpy()
        self.plugin_loader.fire("on_run_end", self)

    def _save_checkpoint(self, sf, steps_done: int) -> None:
        import os

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        save_frontier(os.path.join(self.checkpoint_dir, "frontier.npz"), sf,
                      {"tx": self._cur_tx, "steps_done": steps_done, "dynld_loaded": []})

    @property
    def iprof(self) -> Dict[str, int]:
        """Executed-instruction counts by mnemonic, most-executed first.
        Empty unless ``enable_iprof=True``."""
        from ..disassembler.opcodes import name_of

        out = {name_of(op): int(n) for op, n in enumerate(self._iprof) if n}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def iprof_table(self) -> str:
        """The profile as text: one row per opcode with count and share,
        totals last."""
        prof = self.iprof
        total = sum(prof.values())
        lines = ["Instruction profile (executed instances):",
                 f"{'OPCODE':<14}{'COUNT':>12}{'SHARE':>9}"]
        for name, n in prof.items():
            lines.append(f"{name:<14}{n:>12}{100.0 * n / total:>8.2f}%")
        lines.append(f"{'TOTAL':<14}{total:>12}{100.0:>8.2f}%")
        return "\n".join(lines)

    def instruction_coverage(self) -> Dict[str, float]:
        """Per-contract % of real instructions reached."""
        out = {}
        names = self.tx_contexts[-1].contract_names if self.tx_contexts else []
        for i, img in enumerate(self.images):
            starts = img.is_code
            n = int(starts.sum())
            hit = int((self.visited[i] & starts).sum())
            name = names[i] if i < len(names) else f"contract_{i}"
            out[name] = round(100.0 * hit / n, 1) if n else 100.0
        return out

    @property
    def coverage(self) -> dict:
        cov = coverage_summary(self.tx_contexts)
        cov["instruction_coverage_pct"] = self.instruction_coverage()
        if self.spill:
            cov["dropped_forks"] += self._parked_end
            cov["rebalanced_lanes"] = self._rebalanced
        return cov
