"""Witness search: inversion heuristics + randomized repair.

``Solver`` keeps the reference front-door shape
(``laser/smt/solver/solver.py``: add / check / model ⚠unv) but the
engine is different: EVM path conditions are overwhelmingly chains of
(keccak | calldata-window | const) compared through EQ/LT/GT/ISZERO, so a
directed inversion pass (solve EQ(f(leaf), const) by inverting f) settles
the dispatcher/require structure, and a bounded randomized repair loop
mops up the rest. Returns unknown (not unsat) when search fails — same
degrade-to-no-issue semantics as the reference's solver timeout
(SURVEY.md §5.3).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..symbolic.ops import SymOp, FreeKind
from .eval import Assignment, M256, evaluate
from .tape import HostTape


class UnsatError(Exception):
    """No witness found (unsat OR search exhausted — like a Z3 timeout)."""


@dataclass
class SolverStatistics:
    """Run counters for the witness search (reference:
    ``laser/smt/solver/solver_statistics.py`` ⚠unv, SURVEY.md §5.1).
    ``unknown`` is the silent false-negative channel (VERDICT r2 weak #3):
    every query that returns None and therefore drops a candidate finding
    is counted here, so the undecided rate is observable in the report."""

    attempts: int = 0
    sat: int = 0
    unsat: int = 0
    unknown: int = 0
    cache_hits: int = 0
    time_sec: float = 0.0
    partitioned: int = 0  # queries split into >1 independent cluster

    #: class-level (not a dataclass field — snapshot() builds positionally);
    #: only the process singleton records, so sharing one lock is fine
    _lock = threading.Lock()

    def record(self, verdict: str, dt: float, cached: bool = False) -> None:
        # lock, not bare +=: --parallel-solving runs module threads that
        # record concurrently, and a torn read-modify-write would leak
        # counts exactly where the unknown-rate observable matters
        with self._lock:
            self.attempts += 1
            if verdict == "sat":
                self.sat += 1
            elif verdict == "unsat":
                self.unsat += 1
            else:
                self.unknown += 1
            if cached:
                self.cache_hits += 1
            self.time_sec += dt

    def reset(self) -> None:
        self.attempts = self.sat = self.unsat = self.unknown = 0
        self.cache_hits = 0
        self.time_sec = 0.0
        self.partitioned = 0

    def snapshot(self) -> "SolverStatistics":
        return SolverStatistics(self.attempts, self.sat, self.unsat,
                                self.unknown, self.cache_hits, self.time_sec,
                                self.partitioned)

    def delta(self, since: "SolverStatistics") -> dict:
        return {
            "attempts": self.attempts - since.attempts,
            "sat": self.sat - since.sat,
            "unsat": self.unsat - since.unsat,
            "unknown": self.unknown - since.unknown,
            "cache_hits": self.cache_hits - since.cache_hits,
            "partitioned": self.partitioned - since.partitioned,
            "time_sec": round(self.time_sec - since.time_sec, 3),
        }

    def as_dict(self) -> dict:
        return {
            "attempts": self.attempts, "sat": self.sat, "unsat": self.unsat,
            "unknown": self.unknown, "cache_hits": self.cache_hits,
            "partitioned": self.partitioned,
            "time_sec": round(self.time_sec, 3),
        }


#: process-wide statistics (the reference uses a singleton too)
SOLVER_STATS = SolverStatistics()


def _dump_unknown(tape: HostTape) -> None:
    """Residue collection (VERDICT r4 ask #3): with
    ``MYTHRIL_DUMP_UNKNOWN=<dir>`` every query the search gives up on is
    serialized for offline analysis — the evidence base for deciding
    which inverter/refuter extension actually shrinks the unknown rate."""
    import os

    d = os.environ.get("MYTHRIL_DUMP_UNKNOWN")
    if not d:
        return
    try:
        import json
        import uuid

        os.makedirs(d, exist_ok=True)
        doc = {
            "nodes": [[nd.op, nd.a, nd.b, hex(nd.imm)]
                      for nd in tape.nodes],
            "constraints": [[int(n), bool(s)] for n, s in tape.constraints],
        }
        with open(os.path.join(d, f"unknown_{uuid.uuid4().hex[:12]}.json"),
                  "w") as fh:
            json.dump(doc, fh)
    except Exception:  # noqa: BLE001 — diagnostics must never kill a run
        pass


_INTERESTING = (0, 1, 2, 0xFF, 1 << 31, 1 << 128, M256, M256 - 1, 1 << 255)


def _sat_vector(tape: HostTape, vals: List[int]) -> List[bool]:
    return [bool(vals[n]) == sign for n, sign in tape.constraints]


class _Inverter:
    """Solve f(leaf) == target for supported op chains."""

    def __init__(self, tape: HostTape, vals: List[int]):
        self.tape = tape
        self.vals = vals
        # SSA order (children precede parents): one linear bottom-up pass
        # decides free-variable reachability for every node — recursion on
        # the shared DAG would blow up exponentially
        hf = [False] * len(tape.nodes)
        for i, nd in enumerate(tape.nodes):
            if i == 0 or nd.op == int(SymOp.NULL):
                continue
            if nd.op == int(SymOp.FREE):
                hf[i] = True
            elif nd.op not in (int(SymOp.CONST),):
                hf[i] = (nd.a and nd.a < i and hf[nd.a]) or (nd.b and nd.b < i and hf[nd.b])
        self._has_free = hf

    def has_free(self, i: int) -> bool:
        return bool(self._has_free[i]) if 0 <= i < len(self._has_free) else False

    def apply(self, i: int, target: int, asn: Assignment) -> bool:
        """Try to force node i to value `target` by editing `asn`."""
        target &= M256
        nd = self.tape.nodes[i]
        op = nd.op
        if op == int(SymOp.FREE):
            return self._set_leaf(i, nd, target, asn)
        a, b = nd.a, nd.b
        av, bv = self.vals[a] if a else 0, self.vals[b] if b else 0
        a_free, b_free = (a and self.has_free(a)), (b and self.has_free(b))
        if a_free and b_free:
            return False  # both sides free: out of scope for inversion
        if op == int(SymOp.ADD):
            return self.apply(a, target - bv, asn) if a_free else self.apply(b, target - av, asn)
        if op == int(SymOp.SUB):
            return self.apply(a, target + bv, asn) if a_free else self.apply(b, av - target, asn)
        if op == int(SymOp.XOR):
            return self.apply(a, target ^ bv, asn) if a_free else self.apply(b, target ^ av, asn)
        if op == int(SymOp.NOT):
            return self.apply(a, target ^ M256, asn)
        if op == int(SymOp.MUL):
            c, x = (bv, a) if a_free else (av, b)
            if c & 1:  # odd constants are invertible mod 2^256
                inv = pow(c, -1, 1 << 256)
                return self.apply(x, (target * inv) & M256, asn)
            return False
        if op == int(SymOp.DIV) and a_free:
            # a // c == target: pick a = target * c (representative)
            if bv and target * bv <= M256:
                return self.apply(a, target * bv, asn)
            return False
        if op == int(SymOp.SHR) and b_free:
            # b >> k == target
            k = av
            if k < 256 and (target << k) <= M256:
                return self.apply(b, target << k, asn)
            return False
        if op == int(SymOp.SHL) and b_free:
            k = av
            if k < 256 and (target & ((1 << k) - 1)) == 0:
                return self.apply(b, target >> k, asn)
            return False
        if op == int(SymOp.AND) and (a_free != b_free):
            x = a if a_free else b
            mask = bv if a_free else av
            if target & ~mask & M256:
                return False
            return self.apply(x, target, asn)
        if op == int(SymOp.ISZERO):
            if target == 1:
                return self.apply(a, 0, asn)
            if target == 0 and a:
                # need a != 0; try 1 (works for bool-ish and value chains)
                return self.apply(a, 1, asn)
            return False
        if op == int(SymOp.EQ):
            if target == 1:
                return self.apply(a, bv, asn) if a_free else self.apply(b, av, asn)
            if target == 0:
                x, other = (a, bv) if a_free else (b, av)
                return self.apply(x, (other + 1) & M256, asn)
            return False
        if op in (int(SymOp.LT), int(SymOp.GT)):
            lt = op == int(SymOp.LT)
            want_true = target == 1
            const = bv if a_free else av
            x = a if a_free else b
            # strictly-below cases: LT(a<const) wanting true with a free,
            # or GT(const>b) wanting true with b free; the negations allow
            # equality, where `const` itself is a valid choice.
            strictly_below = want_true and (lt == a_free)
            strictly_above = want_true and (lt != a_free)
            if strictly_below:
                if const == 0:
                    return False
                return self.apply(x, const - 1, asn)
            if strictly_above:
                if const == M256:
                    return False
                return self.apply(x, const + 1, asn)
            return self.apply(x, const, asn)  # non-strict: equality suffices
        return False

    def _set_leaf(self, node_id: int, nd, target: int, asn: Assignment) -> bool:
        return _assign_leaf(node_id, nd, target, asn)


def _assign_leaf(node_id: int, nd, target: int, asn: Assignment) -> bool:
    from .eval import TX_STRIDE

    kind = nd.a
    if kind == int(FreeKind.CALLDATA_WORD):
        asn.tx(nd.b // TX_STRIDE).write_word(nd.b % TX_STRIDE, target)
        return True
    if kind == int(FreeKind.CALLER):
        asn.tx(nd.b).caller = target
        return True
    if kind == int(FreeKind.CALLVALUE):
        asn.tx(nd.b).callvalue = target
        return True
    if kind == int(FreeKind.CALLDATASIZE):
        asn.tx(nd.b).calldatasize = target
        return True
    from .eval import BY_NODE_KINDS

    if kind in BY_NODE_KINDS:
        asn.by_node[node_id] = target
        return True
    asn.scalars[(kind, nd.b)] = target
    return True


def _leaf_support(tape: HostTape, root: int) -> List[int]:
    out, seen, stack = [], set(), [root]
    while stack:
        i = stack.pop()
        if i in seen or i <= 0 or i >= len(tape.nodes):
            continue
        seen.add(i)
        nd = tape.nodes[i]
        if nd.op == int(SymOp.FREE):
            out.append(i)
        else:
            stack.extend((nd.a, nd.b))
    return out


# --- independence partitioning (reference: IndependenceSolver,
# ``laser/smt/solver/independence_solver.py`` ⚠unv, SURVEY §2.1 "SMT
# solvers" — "partitions constraint set into independent clusters
# (shared-variable union-find) and solves separately — the reference's
# main solver optimization"). Here independence is computed at the
# ASSIGNMENT-KEY granularity, not the node granularity: two distinct
# CALLDATA_WORD leaves whose 32-byte windows overlap mutate the same
# underlying tx bytes, so they must share a cluster even though their
# node ids differ.

def _leaf_keys(tape: HostTape, leaves: List[int], cds_txs: frozenset) -> set:
    """Assignment-granular variable keys touched by `leaves`. Calldata
    words expand to their byte windows; when tx ``t``'s CALLDATASIZE is
    constrained somewhere (``t in cds_txs``), every calldata read of tx
    ``t`` couples to it (reads zero-pad past the chosen size, see
    ``TxInput.read_word``). ORIGIN aliases CALLER(tx0) — the evaluator
    defaults an unassigned origin to ``asn.caller`` — so ORIGIN leaves
    carry the caller key too."""
    from .eval import BY_NODE_KINDS, TX_STRIDE

    keys = set()
    for i in leaves:
        nd = tape.nodes[i]
        kind, b = nd.a, nd.b
        if kind == int(FreeKind.CALLDATA_WORD):
            tx, off = divmod(b, TX_STRIDE)
            keys.update(("cd", tx, off + k) for k in range(32))
            if tx in cds_txs:
                keys.add((int(FreeKind.CALLDATASIZE), tx))
        elif kind in BY_NODE_KINDS:
            keys.add(("n", i))  # keyed by node id in Assignment.by_node
        elif kind == int(FreeKind.ORIGIN):
            keys.add((kind, b))
            keys.add((int(FreeKind.CALLER), 0))  # default-aliases tx0 caller
        else:
            keys.add((kind, b))  # caller/callvalue/cds/env scalars
    return keys


def partition_constraints(tape: HostTape) -> List[List[int]]:
    """Constraint indices grouped into independent clusters (union-find
    over shared assignment keys). Constraints over no free variables are
    singleton clusters — they evaluate concretely."""
    n = len(tape.constraints)
    if n <= 1:
        return [list(range(n))] if n else []
    supports = [_leaf_support(tape, node) for node, _ in tape.constraints]
    # couple tx t's calldata reads to its CALLDATASIZE only when some
    # constraint actually mentions THAT tx's cds: the tape pre-seeds an
    # (unconstrained) cds node, and an unconstrained cds is never
    # assigned by the search, so reads keep their default zero-padding
    # regardless of cluster order
    cds_txs = frozenset(
        tape.nodes[i].b
        for sup in supports for i in sup
        if tape.nodes[i].a == int(FreeKind.CALLDATASIZE))
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    owner: Dict[tuple, int] = {}
    for j in range(n):
        for k in _leaf_keys(tape, supports[j], cds_txs):
            if k in owner:
                ra, rb = find(j), find(owner[k])
                if ra != rb:
                    parent[rb] = ra
            else:
                owner[k] = j
    clusters: Dict[int, List[int]] = {}
    for j in range(n):
        clusters.setdefault(find(j), []).append(j)
    return list(clusters.values())


def _solve_partitioned(tape: HostTape, seed: int, max_iters: int,
                       base: Optional[Assignment],
                       deadline: Optional[float] = None
                       ) -> Tuple[str, Optional[Assignment]]:
    """Split the query into independent clusters and solve each with the
    FULL search budget (smaller supports decide in far fewer iterations,
    and a miss in one cluster can't thrash another's solved variables).
    Clusters chain through one accumulating assignment — their key sets
    are disjoint, so later solves cannot disturb earlier ones."""
    clusters = partition_constraints(tape)
    if len(clusters) <= 1:
        out = _solve_tape_inner(tape, seed, max_iters, base, deadline)
        return ("sat" if out is not None else "unknown"), out
    with SOLVER_STATS._lock:  # parallel-solving threads race this too
        SOLVER_STATS.partitioned += 1
    asn = base.copy() if base is not None else Assignment()
    for cl in clusters:
        sub = HostTape(nodes=tape.nodes,
                       constraints=[tape.constraints[j] for j in cl])
        res = _solve_tape_inner(sub, seed, max_iters, base=asn,
                                deadline=deadline)
        if res is None:
            # (a cluster over NO free variables can't reach here: a
            # concretely-false closed constraint is proven unsat by
            # refute_tape before partitioning runs)
            return "unknown", None
        asn = res
    # safety net: the merged model must satisfy the WHOLE tape; a
    # violation means a dependence the keys missed — fall back to the
    # unpartitioned search rather than return a bogus model
    vals = evaluate(tape, asn)
    if all(bool(vals[n]) == s for n, s in tape.constraints):
        return "sat", asn
    out = _solve_tape_inner(tape, seed, max_iters, base, deadline)
    return ("sat" if out is not None else "unknown"), out


def _mutate_leaf(tape: HostTape, leaf: int, asn: Assignment, rng: random.Random):
    nd = tape.nodes[leaf]
    v = rng.choice(_INTERESTING) if rng.random() < 0.6 else rng.getrandbits(256)
    _assign_leaf(leaf, nd, v, asn)


#: memoized solve front door (reference: ``support/model.py get_model``'s
#: lru cache ⚠unv, SURVEY §2 "Model cache"). Key = CANONICAL constraint
#: hash (``smt/canon.py`` — alpha-renamed repeats from cloned bytecode
#: share one entry; pre-portfolio this was the raw structural
#: fingerprint, see docs/solver.md) + search budget; a TRUE LRU (hits
#: refresh recency) capped at ``_SOLVE_CACHE_CAP`` so a 10k-contract
#: campaign — whose dispatcher queries recur heavily within a batch but
#: churn across the corpus — keeps the hot working set without growing
#: without bound. Values are ``(verdict, canonical witness doc | None)``
#: — sat witnesses travel in renaming-independent coordinates and are
#: rehydrated + re-verified per hit by ``smt/portfolio.py``. Caching
#: `unknown` is safe because the budget is in the key. The cap is
#: configurable via :func:`set_solve_cache_cap` or the
#: ``MYTHRIL_SOLVE_CACHE_CAP`` env var (0 disables caching); size and
#: eviction totals are published as ``solver_cache_size`` /
#: ``solver_cache_evictions_total`` in the metrics registry.
_SOLVE_CACHE: "OrderedDict[tuple, Tuple[str, Optional[dict]]]" = \
    OrderedDict()
_SOLVE_CACHE_CAP = int(os.environ.get("MYTHRIL_SOLVE_CACHE_CAP", "") or 8192)
_SOLVE_CACHE_LOCK = threading.Lock()


def set_solve_cache_cap(cap: int) -> int:
    """Set the solve-cache entry cap (evicting down immediately);
    returns the previous cap. 0 disables memoization."""
    global _SOLVE_CACHE_CAP
    prev = _SOLVE_CACHE_CAP
    _SOLVE_CACHE_CAP = max(0, int(cap))
    with _SOLVE_CACHE_LOCK:
        _cache_evict_locked()
    return prev


def _cache_evict_locked() -> None:
    """Evict oldest entries down to the cap; callers hold the lock.
    Publishes the size gauge + eviction counter on every mutation."""
    evicted = 0
    while len(_SOLVE_CACHE) > _SOLVE_CACHE_CAP:
        _SOLVE_CACHE.popitem(last=False)
        evicted += 1
    if evicted:
        obs_metrics.REGISTRY.counter(
            "solver_cache_evictions_total",
            help="LRU evictions from the solve memo cache").inc(evicted)
    obs_metrics.REGISTRY.gauge(
        "solver_cache_size",
        help="entries in the solve memo cache").set(len(_SOLVE_CACHE))


def solve_tape_ex(tape: HostTape, seed: int = 0, max_iters: int = 400,
                  base: Optional[Assignment] = None,
                  max_time: Optional[float] = None
                  ) -> Tuple[str, Optional[Assignment]]:
    """(verdict, assignment) with verdict in {"sat", "unsat", "unknown"}.

    Front door over the staged solver portfolio (``smt/portfolio.py``,
    docs/solver.md): canonical-hash LRU → structural refutation →
    model probe → durable cross-campaign verdict store → the witness
    search below. Proven UNSAT is recorded distinctly from
    search-exhausted UNKNOWN in ``SOLVER_STATS`` (VERDICT r3 ask #4);
    per-stage attempt/hit/latency lands in
    ``portfolio.PORTFOLIO_STATS`` and the metrics registry.
    ``base``-seeded queries skip every cache (the seed assignment is an
    input the canonical hash does not cover) and run refute → probe →
    search only. ``max_time`` is a per-query wall-clock budget in
    seconds (reference: ``--solver-timeout`` ms ⚠unv) checked between
    repair iterations; expiry returns unknown — same
    degrade-to-no-issue semantics as an exhausted iteration budget —
    and is never cached."""
    from .portfolio import solve_query

    return solve_query(tape, seed=seed, max_iters=max_iters, base=base,
                       max_time=max_time)


def solve_tape(tape: HostTape, seed: int = 0, max_iters: int = 400,
               base: Optional[Assignment] = None,
               max_time: Optional[float] = None) -> Optional[Assignment]:
    """Find an assignment satisfying every tape constraint, or None."""
    return solve_tape_ex(tape, seed, max_iters, base, max_time)[1]


def _solve_tape_inner(tape: HostTape, seed: int = 0, max_iters: int = 400,
                      base: Optional[Assignment] = None,
                      deadline: Optional[float] = None) -> Optional[Assignment]:
    rng = random.Random(seed)
    asn = base.copy() if base is not None else Assignment()
    vals = evaluate(tape, asn)

    # pass 1: directed inversion, weakest constraints first (EQ before
    # inequalities so dispatcher selectors land before bound nudging)
    order = sorted(
        range(len(tape.constraints)),
        key=lambda j: 0 if tape.nodes[tape.constraints[j][0]].op == int(SymOp.EQ) else 1,
    )
    for j in order:
        node, sign = tape.constraints[j]
        vals = evaluate(tape, asn)
        if bool(vals[node]) == sign:
            continue
        inv = _Inverter(tape, vals)
        inv.apply(node, 1 if sign else 0, asn)

    # pass 2: randomized repair (vals always reflects `asn`)
    vals = evaluate(tape, asn)
    sat = _sat_vector(tape, vals)
    if all(sat):
        return asn
    inv = _Inverter(tape, vals)
    for _ in range(max_iters):
        if deadline is not None and time.perf_counter() >= deadline:
            return None  # budget expired mid-search -> unknown
        unsat_idx = [j for j, ok in enumerate(sat) if not ok]
        if not unsat_idx:
            return asn
        j = rng.choice(unsat_idx)
        node, sign = tape.constraints[j]
        support = _leaf_support(tape, node)
        if not support:
            return None  # constraint over no free vars and unsat: dead
        cand = asn.copy()
        if rng.random() < 0.5:
            inv.vals = vals
            inv.apply(node, 1 if sign else 0, cand)
        else:
            _mutate_leaf(tape, rng.choice(support), cand, rng)
        cvals = evaluate(tape, cand)
        csat = _sat_vector(tape, cvals)
        if sum(csat) >= sum(sat):
            asn, sat, vals = cand, csat, cvals
            if all(sat):
                return asn
    return None


class Solver:
    """Reference-shaped front door: add constraints, check, get model."""

    def __init__(self, tape: HostTape, seed: int = 0, max_iters: int = 400,
                 max_time: Optional[float] = None):
        self.tape = HostTape(nodes=tape.nodes, constraints=list(tape.constraints))
        self.seed = seed
        self.max_iters = max_iters
        self.max_time = max_time
        self._model: Optional[Assignment] = None

    def add(self, node: int, sign: bool = True) -> None:
        self.tape.constraints.append((node, sign))

    def check(self) -> str:
        verdict, self._model = solve_tape_ex(self.tape, self.seed,
                                             self.max_iters,
                                             max_time=self.max_time)
        return verdict

    def model(self) -> Assignment:
        if self._model is None:
            raise UnsatError("no model (check() not sat)")
        return self._model


def solve_lane(sf, lane: int, extra_constraints=(), seed: int = 0,
               max_iters: int = 400, cache=None) -> Optional[Assignment]:
    """Witness for lane `lane`'s path condition + extra (node, sign)
    pairs. Pass a ``TapeHostCache`` when solving many lanes of one
    frontier — the cacheless default bulk-copies the tape arrays per
    call."""
    from .tape import extract_tape

    tape = extract_tape(sf, lane, extra_constraints, cache=cache)
    return solve_tape(tape, seed=seed, max_iters=max_iters)
