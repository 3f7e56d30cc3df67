"""Host-side view of one lane's SSA tape.

Pulls the device arrays for a single lane into plain Python structures so
the solver can walk them without touching JAX. This is the boundary where
the reference would hold Z3 ASTs; here an expression IS its tape row.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..ops import u256
from ..symbolic.ops import SymOp, FreeKind


@dataclass(frozen=True)
class HostNode:
    op: int
    a: int
    b: int
    imm: int  # u256 immediate as a Python int


@dataclass
class HostTape:
    nodes: List[HostNode]           # index = node id; [0] is concrete zero
    constraints: List[Tuple[int, bool]]  # (node id, asserted sign)
    pcs: List[int] = field(default_factory=list)  # branch pc per constraint (may be shorter)


def node_index(nodes: List[HostNode]):
    """Hash index for :func:`intern_node`: node -> FIRST id carrying it
    (HostNode is frozen, hence hashable). Build once per tape, copy per
    mutation batch — turns each intern from an O(n) dataclass-equality
    scan into an O(1) lookup."""
    idx = {}
    for i, nd in enumerate(nodes):
        idx.setdefault(nd, i)
    return idx


def intern_node(nodes: List[HostNode], node: HostNode, index=None) -> int:
    """Id of `node` in `nodes`, appending only when absent — the host
    analog of the device tape's hash-consing. Detection modules MUST
    build attack predicates through this: a predicate that re-creates a
    node the path already asserts (e.g. the LT(a,b) a SafeMath guard
    branched on) then shares its id, so the refuter sees the polarity
    conflict and proves UNSAT instead of burning witness-search budget
    into an `unknown` (round 4: this was every second solver query on
    the ERC-20 workload). Pass the tape's :func:`node_index` when
    interning repeatedly; it is kept in sync with appends."""
    if index is not None:
        hit = index.get(node)
        if hit is None:
            nodes.append(node)
            hit = index[node] = len(nodes) - 1
        return hit
    try:
        return nodes.index(node)
    except ValueError:
        nodes.append(node)
        return len(nodes) - 1


def support(tape: HostTape, root: int):
    """(leaf node ids, FreeKind set) reachable from `root` (iterative)."""
    ids, kinds, seen, stack = [], set(), set(), [root]
    while stack:
        i = stack.pop()
        if i in seen or i <= 0 or i >= len(tape.nodes):
            continue
        seen.add(i)
        nd = tape.nodes[i]
        if nd.op == int(SymOp.FREE):
            ids.append(i)
            kinds.add(nd.a)
        elif nd.op not in (int(SymOp.CONST), int(SymOp.NULL)):
            stack.extend((nd.a, nd.b))
    return ids, kinds


def constraint_support(tape: HostTape):
    """Union of leaf supports over every path constraint."""
    ids, kinds = set(), set()
    for node, _ in tape.constraints:
        i, k = support(tape, node)
        ids.update(i)
        kinds.update(k)
    return ids, kinds


def cone(tape: HostTape, roots, storage_key_div: int = 0) -> set:
    """Node ids in the dependency cone of ``roots`` — the backward
    closure over the DAG (every node whose value can influence any
    root). ``storage_key_div`` is the account-table size ``A`` when the
    caller wants FREE(STORAGE) leaves traversed into their symbolic key
    node (the engine packs ``b = key_sym * A + account_slot``,
    ``symbolic/engine.py`` SLOAD-miss leaf) — which slot a storage read
    hits observably depends on the key, so taint flows through it."""
    nodes = tape.nodes
    n = len(nodes)
    leafish = (int(SymOp.CONST), int(SymOp.NULL), int(SymOp.FREE))
    storage = int(FreeKind.STORAGE)
    seen: set = set()
    stack = [int(r) for r in roots]
    while stack:
        i = stack.pop()
        if i in seen or i <= 0 or i >= n:
            continue
        seen.add(i)
        nd = nodes[i]
        if nd.op not in leafish:
            stack.extend((nd.a, nd.b))
        elif (storage_key_div and nd.op == int(SymOp.FREE)
                and nd.a == storage):
            stack.append(nd.b // storage_key_div)
    return seen


class AnnotationSpace:
    """Reference-parity annotation channel (``laser/smt`` wrappers carry
    an ``annotations`` set propagated through every operation ⚠unv,
    SURVEY.md §2.1 "SMT abstraction layer" — the mechanism taint
    analysis rides on). Here an expression IS its tape row, so the
    channel is a thin view over :func:`cone`: a tag attached at node t
    appears in ``annotations(x)`` exactly when t lies in x's dependency
    cone. Single reachability implementation — sink-semantics fixes in
    ``cone`` apply here automatically."""

    def __init__(self, tape: HostTape, storage_key_div: int = 0):
        self.tape = tape
        self.storage_key_div = storage_key_div
        self._own: dict = {}
        self._cones: dict = {}

    def annotate(self, node: int, tag) -> None:
        self._own.setdefault(int(node), set()).add(tag)

    def _cone_of(self, node: int) -> set:
        c = self._cones.get(node)
        if c is None:
            c = cone(self.tape, [node], self.storage_key_div)
            self._cones[node] = c
        return c

    def annotations(self, node: int) -> frozenset:
        c = self._cone_of(int(node))
        out = set()
        for t, tags in self._own.items():
            if t in c:
                out |= tags
        return frozenset(out)

    def any_sink(self, sinks, tag) -> bool:
        """Does `tag` reach any node id in `sinks`?"""
        c = cone(self.tape, [int(s) for s in sinks], self.storage_key_div)
        return any(tag in tags and t in c for t, tags in self._own.items())


# tx.origin IS the attacker EOA: every symbolic transaction originates
# from the ATTACKER actor (reference: symbolic tx setup constrains origin
# to the attacker/creator pair ⚠unv, SURVEY §3.2), so a value sink keyed
# on ORIGIN is attacker-directed — e.g. the config-4 vault's ``sweep()``
# paying out to tx.origin at call depth 3.
ATTACKER_KINDS = {
    int(FreeKind.CALLDATA_WORD), int(FreeKind.CALLDATASIZE),
    int(FreeKind.CALLVALUE), int(FreeKind.CALLER),
    int(FreeKind.ORIGIN),
}


def attacker_controlled(tape: HostTape, root: int) -> bool:
    """Does `root` depend on tx inputs the attacker chooses?"""
    _, kinds = support(tape, root)
    return bool(kinds & ATTACKER_KINDS)


def keccak_derived(tape: HostTape, root: int) -> bool:
    """Does `root`'s value flow through a KECCAK digest? (A storage key
    that is a hash of something is solidity mapping access, not an
    arbitrary-write primitive.)"""
    seen, stack = set(), [root]
    while stack:
        i = stack.pop()
        if i in seen or i <= 0 or i >= len(tape.nodes):
            continue
        seen.add(i)
        nd = tape.nodes[i]
        if nd.op == int(SymOp.KECCAK):
            return True
        if nd.op not in (int(SymOp.CONST), int(SymOp.NULL), int(SymOp.FREE)):
            stack.extend((nd.a, nd.b))
    return False


class TapeHostCache:
    """One bulk device->host copy of the tape + constraint arrays.

    Per-lane ``extract_tape`` used to slice device arrays element-wise —
    hundreds of device round-trips PER LANE, which measured as ~90% of
    ``fire_lasers`` wall time on a 1024-lane analyze. Build one of these
    per finished frontier and thread it through."""

    def __init__(self, sf):
        self.tape_len = np.asarray(sf.tape_len)
        self.tape_op = np.asarray(sf.tape_op)
        self.tape_a = np.asarray(sf.tape_a)
        self.tape_b = np.asarray(sf.tape_b)
        self.tape_imm = np.asarray(sf.tape_imm)
        self.con_len = np.asarray(sf.con_len)
        self.con_node = np.asarray(sf.con_node)
        self.con_sign = np.asarray(sf.con_sign)
        self.con_pc = np.asarray(sf.con_pc)


def extract_tape(sf, lane: int, extra_constraints=(),
                 cache: "TapeHostCache | None" = None) -> HostTape:
    """Materialize lane `lane` of a SymFrontier as a HostTape."""
    c = cache if cache is not None else TapeHostCache(sf)
    n = int(c.tape_len[lane])
    ops = c.tape_op[lane, :n]
    a = c.tape_a[lane, :n]
    b = c.tape_b[lane, :n]
    imm = c.tape_imm[lane, :n]
    nodes = [
        HostNode(int(ops[i]), int(a[i]), int(b[i]), u256.to_int(imm[i]))
        for i in range(n)
    ]
    cn = int(c.con_len[lane])
    cons = [
        (int(c.con_node[lane, i]), bool(c.con_sign[lane, i]))
        for i in range(cn)
    ]
    pcs = [int(c.con_pc[lane, i]) for i in range(cn)]
    cons.extend(extra_constraints)
    return HostTape(nodes=nodes, constraints=cons, pcs=pcs)
