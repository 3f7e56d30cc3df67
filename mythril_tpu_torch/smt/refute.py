"""Unsat proofs for host tapes (VERDICT r3 ask #4a/4b).

The witness search (``smt/solver.py``) can only ever answer sat-or-
unknown; every `unknown` is a potential silent false negative. This
module proves the easy majority of genuinely-unsat queries — EVM path
conditions are dominated by dispatcher selector EQs and require()-style
comparisons over injective chains of one free leaf — by FORCED-VALUE
propagation:

- every constraint is reduced (through chains of injective ops: ADD,
  SUB, XOR, NOT, odd MUL, and the boolean EQ/ISZERO structure) to facts
  about a single free LEAF: ``leaf == v``, ``leaf != v``, or an interval
  bound when the leaf is compared bare;
- facts are merged per leaf; any contradiction (two different forced
  values, a forced value that is forbidden or out of bounds, an empty
  interval, or a closed constraint evaluating false) is an UNSAT proof.

This is the analog of the reference's unsat verdicts from Z3
(``laser/smt/solver`` ⚠unv, SURVEY §2.2) for the structural fragment;
anything it cannot decide stays with the randomized search.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from ..symbolic.ops import SymOp, FreeKind
from .eval import Assignment, M256, evaluate
from .tape import HostTape

_INJECTIVE = (int(SymOp.ADD), int(SymOp.SUB), int(SymOp.XOR),
              int(SymOp.NOT), int(SymOp.MUL))


def _free_reach(tape: HostTape):
    hf = [False] * len(tape.nodes)
    for i, nd in enumerate(tape.nodes):
        if i == 0 or nd.op == int(SymOp.NULL):
            continue
        if nd.op == int(SymOp.FREE):
            hf[i] = True
        elif nd.op != int(SymOp.CONST):
            hf[i] = (nd.a and nd.a < i and hf[nd.a]) or \
                    (nd.b and nd.b < i and hf[nd.b])
    return hf


def _reduce_to_leaf(tape, vals, hf, i: int, target: int
                    ) -> Optional[Tuple[int, int]]:
    """Solve f(leaf) == target where f is a chain of INJECTIVE ops with
    exactly one free side per node. Returns (leaf_node, forced_value) or
    None. Injectivity matters: the caller also uses the result negated
    (f(leaf) != target  <=>  leaf != forced_value)."""
    target &= M256
    while True:
        nd = tape.nodes[i]
        if nd.op == int(SymOp.FREE):
            return i, target
        a, b = nd.a, nd.b
        a_free = bool(a) and hf[a]
        b_free = bool(b) and hf[b]
        if a_free and b_free:
            return None
        av = vals[a] if a else 0
        bv = vals[b] if b else 0
        op = nd.op
        if op == int(SymOp.ADD):
            i, target = (a, target - bv) if a_free else (b, target - av)
        elif op == int(SymOp.SUB):
            i, target = (a, target + bv) if a_free else (b, av - target)
        elif op == int(SymOp.XOR):
            i, target = (a, target ^ bv) if a_free else (b, target ^ av)
        elif op == int(SymOp.NOT):
            i, target = a, target ^ M256
        elif op == int(SymOp.MUL):
            c, x = (bv, a) if a_free else (av, b)
            if not (c & 1):
                return None
            i, target = x, target * pow(c, -1, 1 << 256)
        else:
            return None
        target &= M256


class _Facts:
    """Per-leaf merged facts; raises _Conflict on contradiction."""

    def __init__(self):
        self.eq: Dict[int, int] = {}
        self.neq: Dict[int, Set[int]] = {}
        self.lo: Dict[int, int] = {}
        self.hi: Dict[int, int] = {}

    def force(self, leaf: int, v: int) -> bool:
        if leaf in self.eq and self.eq[leaf] != v:
            return False
        if v in self.neq.get(leaf, ()):
            return False
        if not (self.lo.get(leaf, 0) <= v <= self.hi.get(leaf, M256)):
            return False
        self.eq[leaf] = v
        return True

    def forbid(self, leaf: int, v: int) -> bool:
        if self.eq.get(leaf) == v:
            return False
        self.neq.setdefault(leaf, set()).add(v)
        return True

    def bound(self, leaf: int, lo: Optional[int] = None,
              hi: Optional[int] = None) -> bool:
        if lo is not None:
            self.lo[leaf] = max(self.lo.get(leaf, 0), lo)
        if hi is not None:
            self.hi[leaf] = min(self.hi.get(leaf, M256), hi)
        l, h = self.lo.get(leaf, 0), self.hi.get(leaf, M256)
        if l > h:
            return False
        if leaf in self.eq and not (l <= self.eq[leaf] <= h):
            return False
        # a pinched interval whose every value is forbidden is empty
        if h - l < 8 and all(v in self.neq.get(leaf, ())
                             for v in range(l, h + 1)):
            return False
        return True


def refute_tape(tape: HostTape) -> Optional[str]:
    """Return a human-readable unsat reason if the tape's constraint set
    is PROVABLY unsatisfiable, else None (decide nothing)."""
    if not tape.constraints:
        return None
    # direct polarity conflict on one node
    signs: Dict[int, bool] = {}
    for node, sign in tape.constraints:
        if node in signs and signs[node] != bool(sign):
            return f"node {node} asserted both true and false"
        signs[node] = bool(sign)

    hf = _free_reach(tape)
    vals = evaluate(tape, Assignment())
    facts = _Facts()
    for node, sign in tape.constraints:
        if node <= 0 or node >= len(tape.nodes):
            continue
        if not hf[node]:
            # closed constraint: its value is assignment-independent
            if bool(vals[node]) != bool(sign):
                return f"closed constraint at node {node} is false"
            continue
        if not _apply(tape, vals, hf, facts, node, bool(sign)):
            return f"conflicting facts at constraint node {node}"
    return None


def _apply(tape, vals, hf, facts: _Facts, i: int, want: bool) -> bool:
    """Derive leaf facts from `node i must evaluate truthy == want`.
    Returns False ONLY on a proven conflict (unknown structure -> True)."""
    nd = tape.nodes[i]
    op = nd.op
    a, b = nd.a, nd.b
    a_free = bool(a) and hf[a]
    b_free = bool(b) and hf[b]

    if op == int(SymOp.ISZERO):
        # ISZERO(a) truthy <=> a == 0
        red = _reduce_to_leaf(tape, vals, hf, a, 0)
        if red is None:
            return True
        leaf, v = red
        return facts.force(leaf, v) if want else facts.forbid(leaf, v)

    if op == int(SymOp.EQ):
        if a_free and b_free:
            return True
        free, const = (a, vals[b] if b else 0) if a_free else (b, vals[a] if a else 0)
        red = _reduce_to_leaf(tape, vals, hf, free, const)
        if red is None:
            return True
        leaf, v = red
        return facts.force(leaf, v) if want else facts.forbid(leaf, v)

    if op in (int(SymOp.LT), int(SymOp.GT)):
        if a_free and b_free:
            return True
        # interval facts only for a BARE free leaf (arith chains wrap mod
        # 2^256, so monotone reasoning through them would be unsound)
        free, const = (a, vals[b] if b else 0) if a_free else (b, vals[a] if a else 0)
        if tape.nodes[free].op != int(SymOp.FREE):
            return True
        leaf_lt = (op == int(SymOp.LT)) == a_free  # "leaf < const" form?
        if leaf_lt and want:          # leaf < const
            if const == 0:
                return False
            return facts.bound(free, hi=const - 1)
        if leaf_lt and not want:      # leaf >= const
            return facts.bound(free, lo=const)
        if want:                      # leaf > const
            if const == M256:
                return False
            return facts.bound(free, lo=const + 1)
        return facts.bound(free, hi=const)  # leaf <= const

    # a bare free leaf used directly as a branch condition
    if op == int(SymOp.FREE):
        return facts.forbid(i, 0) if want else facts.force(i, 0)

    # AND of two boolean-ish sides asserted true forces both sides
    if op == int(SymOp.AND) and want:
        ok = True
        if a_free:
            ok = ok and _apply(tape, vals, hf, facts, a, True)
        if b_free and ok:
            ok = ok and _apply(tape, vals, hf, facts, b, True)
        return ok

    return True
