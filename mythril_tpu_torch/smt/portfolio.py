"""Staged solver portfolio: refute → model-probe → verdict store →
in-process LRU → witness search.

This is the front door every solver query in the process goes through
(``solver.solve_tape_ex`` delegates here) — the piece that turns the
full witness search (this repo's host-Z3 analog, the expensive slow
path) from the default into the rare last resort:

  1. **lru**     — the PR 4 solve memo, re-keyed on the CANONICAL
                   constraint hash (``smt/canon.py``) so alpha-renamed
                   repeats from cloned bytecode hit; entries hold
                   canonical-coordinate witnesses that are rehydrated
                   and re-verified per hit;
  2. **refute**  — structural unsat proof (``smt/refute.py``'s
                   forced-value propagation over the tape the device
                   produced): proven UNSAT without any search;
  3. **probe**   — model probe via exact tape evaluation
                   (``smt/eval.py``, the native evaluator): if the
                   seed assignment already satisfies every constraint
                   the query is SAT for free — the dominant case for
                   the default-path constraints cloned dispatchers
                   emit. Identical output to what the search's own
                   fast path would return, just counted as its stage;
  4. **store**   — the durable cross-campaign verdict store
                   (``smt/vstore.py``) shared by fleet workers and
                   repeat campaigns; sat witnesses are rehydrated
                   through the canonical leaf numbering and verified
                   by exact evaluation before being served;
  5. **search**  — the full partitioned inversion + randomized-repair
                   witness search (``smt/solver.py``). Its decided
                   verdicts are what the store persists.

Per-stage attempt/hit/latency lands in ``PORTFOLIO_STATS`` (snapshot/
delta like ``SolverStatistics``) and on the PR 3 metrics registry
(``solver_queries_total``, ``solver_queries_stage_<stage>_total``,
``solver_hits_stage_<stage>_total``, ``solver_stage_seconds_<stage>``)
— the serve daemon's ``/metrics`` exposes them verbatim, the campaign
heartbeat derives its Z3-avoided %% from them, and
``tools/trace_report.py`` section 8 renders the ladder.

Result-parity contract (tested): with the store cold, warm, or
disabled, issue output is byte-identical — a warm hit serves exactly
the witness the deterministic search would have recomputed, and every
sat witness served from any cache is re-verified against the querying
tape before use (a failed verification falls through to the next
stage, counted in ``solver_witness_mismatch_total``).

What is never cached anywhere durable: ``unknown`` (a budget property,
not a query property), wall-clock-expired queries, and ``base``-seeded
queries (the seed assignment is an input the canonical hash does not
cover — they run refute → probe → search only).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import solver as _sv
from .canon import (CanonicalQuery, canonical_query, witness_from_doc,
                    witness_ok, witness_to_doc)
from .eval import Assignment, evaluate
from .refute import refute_tape
from .tape import HostTape
from .vstore import VerdictStore

#: ladder order (also the reporting order everywhere)
STAGES = ("lru", "refute", "probe", "store", "search")


class PortfolioStats:
    """Process-wide per-stage counters (attempts / hits / per-verdict
    hit split / wall time). Snapshot/delta-style like
    ``solver.SolverStatistics`` so campaigns report per-session deltas
    while the singleton accumulates for the daemon's lifetime."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.queries = 0
        self.witness_mismatch = 0
        self.stages: Dict[str, Dict[str, float]] = {
            s: {"attempts": 0, "hits": 0, "sat": 0, "unsat": 0,
                "time_sec": 0.0}
            for s in STAGES}

    def query(self) -> None:
        with self._lock:
            self.queries += 1

    def attempt(self, stage: str) -> None:
        with self._lock:
            self.stages[stage]["attempts"] += 1

    def hit(self, stage: str, verdict: str) -> None:
        with self._lock:
            st = self.stages[stage]
            st["hits"] += 1
            if verdict in ("sat", "unsat"):
                st[verdict] += 1

    def add_time(self, stage: str, dt: float) -> None:
        with self._lock:
            self.stages[stage]["time_sec"] += dt

    def mismatch(self) -> None:
        with self._lock:
            self.witness_mismatch += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "queries": self.queries,
                "witness_mismatch": self.witness_mismatch,
                "stages": {s: dict(v) for s, v in self.stages.items()},
            }


def stats_delta(now: Dict, since: Optional[Dict] = None) -> Dict:
    """``now - since`` over :meth:`PortfolioStats.snapshot` dicts, with
    the derived headline: the share of queries resolved BEFORE the
    search stage (the Z3-avoided rate)."""
    z = {"queries": 0, "witness_mismatch": 0, "stages": {}}
    since = since or z
    out: Dict = {
        "queries": now["queries"] - since.get("queries", 0),
        "witness_mismatch": (now["witness_mismatch"]
                             - since.get("witness_mismatch", 0)),
        "stages": {},
    }
    for s in STAGES:
        a = now["stages"].get(s, {})
        b = (since.get("stages") or {}).get(s, {})
        out["stages"][s] = {
            k: round(a.get(k, 0) - b.get(k, 0), 6)
            for k in ("attempts", "hits", "sat", "unsat", "time_sec")}
    q = out["queries"]
    searched = out["stages"]["search"]["attempts"]
    out["z3_avoided_pct"] = (round(100.0 * (1.0 - searched / q), 2)
                             if q else 0.0)
    return out


def z3_avoided_pct(now: Dict, since: Optional[Dict] = None) -> float:
    return stats_delta(now, since)["z3_avoided_pct"]


#: the process singleton (mirrors solver.SOLVER_STATS)
PORTFOLIO_STATS = PortfolioStats()


# --- the shared verdict store (process-global, like the LRU) -----------

_STORE: Optional[VerdictStore] = None
_STORE_LOCK = threading.Lock()


def set_store(store) -> Optional[VerdictStore]:
    """Install the process-wide verdict store (a directory path, a
    VerdictStore, or None to disable) and return the PREVIOUS one so
    scoped users (a campaign run) can restore it. Also pre-registers
    the portfolio metrics so a scrape before the first query already
    sees the counter names."""
    global _STORE
    with _STORE_LOCK:
        prev = _STORE
        if store is None:
            _STORE = None
        elif isinstance(store, VerdictStore):
            _STORE = store
        else:
            _STORE = VerdictStore(str(store))
    register_metrics()
    return prev


def get_store() -> Optional[VerdictStore]:
    return _STORE


def register_metrics() -> None:
    """Create the portfolio's registry entries at zero (idempotent):
    the serve ``/metrics`` surface should list the ladder even before
    the first query arrives."""
    reg = obs_metrics.REGISTRY
    reg.counter("solver_queries_total",
                help="solver queries entering the staged portfolio")
    reg.counter("solver_witness_mismatch_total",
                help="cached sat witnesses that failed re-verification "
                     "and fell through to the next stage")
    for s in STAGES:
        reg.counter(f"solver_queries_stage_{s}_total",
                    help=f"queries that reached the {s} stage")
        reg.counter(f"solver_hits_stage_{s}_total",
                    help=f"queries resolved by the {s} stage")


# --- internals ---------------------------------------------------------

def _stage_begin(stage: str) -> float:
    PORTFOLIO_STATS.attempt(stage)
    obs_metrics.REGISTRY.counter(
        f"solver_queries_stage_{stage}_total").inc()
    return time.perf_counter()


def _stage_end(stage: str, t0: float,
               verdict: Optional[str] = None) -> None:
    dt = time.perf_counter() - t0
    PORTFOLIO_STATS.add_time(stage, dt)
    obs_metrics.REGISTRY.histogram(
        f"solver_stage_seconds_{stage}",
        help=f"wall time spent in the {stage} stage").observe(dt)
    if verdict is not None:
        PORTFOLIO_STATS.hit(stage, verdict)
        obs_metrics.REGISTRY.counter(
            f"solver_hits_stage_{stage}_total").inc()
        # one instant event per DECIDED query (not per attempted
        # stage): carries the ambient trace_id, so a request's trace
        # shows which ladder stage settled each of its queries —
        # volume-bounded by queries, not stages
        if obs_trace.active():
            obs_trace.event("solver_stage", stage=stage,
                            dur=round(dt, 6), verdict=verdict)


def _lru_get(key):
    with _sv._SOLVE_CACHE_LOCK:
        hit = _sv._SOLVE_CACHE.get(key)
        if hit is not None:
            # a hit is a *use*: refresh recency so the corpus's hot
            # recurring queries stay resident while one-offs age out
            _sv._SOLVE_CACHE.move_to_end(key)
    return hit


def _lru_put(key, verdict: str, doc: Optional[Dict]) -> None:
    with _sv._SOLVE_CACHE_LOCK:
        _sv._SOLVE_CACHE[key] = (verdict, doc)
        _sv._SOLVE_CACHE.move_to_end(key)
        _sv._cache_evict_locked()


def _serve_sat(tape: HostTape, canon: CanonicalQuery, stage: str,
               t0: float, doc: Optional[Dict]) -> Optional[Assignment]:
    """Rehydrate + verify a cached sat witness; None (with the
    mismatch counters ticked) means fall through to the next stage."""
    asn = witness_from_doc(tape, canon, doc) if doc is not None else None
    if asn is not None and witness_ok(tape, asn):
        _stage_end(stage, t0, "sat")
        return asn
    PORTFOLIO_STATS.mismatch()
    obs_metrics.REGISTRY.counter("solver_witness_mismatch_total").inc()
    _stage_end(stage, t0)
    return None


def solve_query(tape: HostTape, seed: int = 0, max_iters: int = 400,
                base: Optional[Assignment] = None,
                max_time: Optional[float] = None
                ) -> Tuple[str, Optional[Assignment]]:
    """Run one query down the stage ladder. Same signature and verdict
    semantics as the pre-portfolio ``solve_tape_ex`` (which now
    delegates here)."""
    t_query = time.perf_counter()
    deadline = None if max_time is None else t_query + max_time
    PORTFOLIO_STATS.query()
    obs_metrics.REGISTRY.counter(
        "solver_queries_total",
        help="solver queries entering the staged portfolio").inc()

    canon: Optional[CanonicalQuery] = None
    key = None
    cacheable_query = base is None  # base is an input the hash misses

    # --- stage 1: in-process LRU (canonical-hash keyed) ---------------
    if cacheable_query and _sv._SOLVE_CACHE_CAP > 0:
        t0 = _stage_begin("lru")
        canon = canonical_query(tape)
        # the search budget stays in the key: `unknown` is cacheable
        # here exactly because a bigger budget is a different key
        key = (canon.digest, seed, max_iters, max_time)
        hit = _lru_get(key)
        if hit is not None:
            verdict, doc = hit
            if verdict == "sat":
                asn = _serve_sat(tape, canon, "lru", t0, doc)
                if asn is not None:
                    _sv.SOLVER_STATS.record(
                        "sat", time.perf_counter() - t_query, cached=True)
                    return "sat", asn
            else:
                _stage_end("lru", t0, verdict)
                _sv.SOLVER_STATS.record(
                    verdict, time.perf_counter() - t_query, cached=True)
                return verdict, None
        else:
            _stage_end("lru", t0)

    verdict: Optional[str] = None
    out: Optional[Assignment] = None
    decided_by = None

    # --- stage 2: structural refutation (proven unsat, no search) -----
    t0 = _stage_begin("refute")
    if refute_tape(tape) is not None:
        _stage_end("refute", t0, "unsat")
        verdict, out, decided_by = "unsat", None, "refute"
    else:
        _stage_end("refute", t0)

    # --- stage 3: model probe (exact evaluation of the seed model) ----
    if verdict is None:
        t0 = _stage_begin("probe")
        probe = base.copy() if base is not None else Assignment()
        vals = evaluate(tape, probe)
        if all(bool(vals[int(n)]) == bool(s) for n, s in tape.constraints):
            _stage_end("probe", t0, "sat")
            verdict, out, decided_by = "sat", probe, "probe"
        else:
            _stage_end("probe", t0)

    # --- stage 4: durable cross-campaign verdict store ----------------
    store = _STORE
    if verdict is None and cacheable_query and store is not None:
        t0 = _stage_begin("store")
        if canon is None:
            canon = canonical_query(tape)
        doc = store.get(canon.digest)
        if doc is not None:
            if doc["verdict"] == "unsat":
                _stage_end("store", t0, "unsat")
                verdict, out, decided_by = "unsat", None, "store"
            else:
                asn = _serve_sat(tape, canon, "store", t0,
                                 doc.get("witness"))
                if asn is not None:
                    verdict, out, decided_by = "sat", asn, "store"
        else:
            _stage_end("store", t0)

    # --- stage 5: the witness search (the host-Z3 slow path) ----------
    if verdict is None:
        t0 = _stage_begin("search")
        verdict, out = _sv._solve_partitioned(tape, seed, max_iters, base,
                                              deadline)
        _stage_end("search", t0,
                   verdict if verdict != "unknown" else None)
        decided_by = "search"

    # --- bookkeeping + cache write-back -------------------------------
    if verdict == "unknown":
        _sv._dump_unknown(tape)
    # a wall-clock expiry is load-dependent, not a property of the
    # query — caching it would poison this key for re-queries issued
    # after contention subsides
    expired = (verdict == "unknown" and deadline is not None
               and time.perf_counter() >= deadline)
    if cacheable_query and not expired and key is not None:
        doc = (witness_to_doc(out, canon)
               if verdict == "sat" and out is not None else None)
        _lru_put(key, verdict, doc)
    if (cacheable_query and store is not None and decided_by == "search"
            and verdict in ("sat", "unsat")):
        # persist only what cost real work to decide: search verdicts.
        # Refute/probe hits re-derive in microseconds and would hit
        # their own (earlier) stage on a warm run anyway — storing
        # them is pure dead weight in the shared dir.
        if canon is None:
            canon = canonical_query(tape)
        try:
            store.put(canon.digest, verdict,
                      witness_to_doc(out, canon)
                      if out is not None else None)
        except OSError:
            pass  # a full/readonly store dir must not fail the query
    _sv.SOLVER_STATS.record(verdict, time.perf_counter() - t_query,
                            cached=(decided_by == "store"))
    return verdict, out


__all__ = ["PORTFOLIO_STATS", "PortfolioStats", "STAGES", "get_store",
           "register_metrics", "set_store", "solve_query", "stats_delta",
           "z3_avoided_pct"]
