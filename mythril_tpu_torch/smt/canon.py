"""Structural canonicalization of path-condition sets.

At 10k+ contract scale the corpus is dominated by proxy/clone bytecode,
so most solver queries are alpha-renamed repeats of queries some lane,
worker, or earlier campaign already answered: the same dispatcher EQ,
the same require() comparison, reached through a tape whose NODE IDS
differ (different lane history, different interning order, a dead
subexpression shifting every id). The raw ``(op, a, b, imm)``
fingerprint PR 4's solve memo keyed on sees every such variant as a new
query. This module computes a canonical content hash under which all of
them collapse to one key — the cache key of the in-process LRU and of
the durable cross-campaign verdict store (``smt/vstore.py``), and the
canonical constraint representation the zkEVM constraint-design survey
(arxiv 2510.05376, PAPERS.md) motivates for reusable constraint traces.

What the hash is invariant under:

- **node-id renaming** — hashes are computed structurally, bottom-up
  over the dependency cone of the constraint roots; absolute tape
  positions (and unreachable/dead nodes) never enter the digest;
- **constraint-set reordering** — per-constraint digests are sorted
  (and duplicates dropped: a constraint list is semantically a set)
  before the final digest;
- **commutative operand order** — ADD/MUL/EQ/AND/OR/XOR operands are
  sorted by sub-digest, so ``EQ(x, 5)`` and ``EQ(5, x)`` collide;
- **by-node variable naming** — leaves whose identity IS their node id
  (``eval.BY_NODE_KINDS``: storage/retval/havoc/...) get de-Bruijn-
  style indices assigned by first occurrence in a canonical traversal,
  order-independent across the constraint set.

What it deliberately does NOT abstract (soundness over hit rate):

- leaves with SEMANTIC indices (calldata byte windows, per-tx
  caller/callvalue, block env) keep ``(kind, index)`` verbatim —
  renaming a calldata offset changes which bytes overlap which window,
  which changes satisfiability;
- by-node leaves keep their ``(kind, b, imm)`` payload in the leaf
  label (a storage leaf's packed key/slot is identity, not a name);
- constants are normalized to their 256-bit value but never folded
  through operators — the canonicalizer must not have opinions the
  evaluator doesn't share.

Equal digests therefore imply a leaf bijection making the constraint
sets identical terms — alpha-equivalence — up to digest collision
(blake2b-128 per node, sha256 over the set). The one residual
ambiguity is de-Bruijn numbering across constraints whose round-0
digests tie (mutually symmetric constraints): those may hash UNEQUAL
across orderings — a missed dedupe, never a wrong hit. And because a
stored SAT verdict carries a model, every witness served off this hash
is re-verified against the querying tape by exact evaluation before it
is trusted (``smt/portfolio.py``), so even a digest collision cannot
produce a wrong sat model; unsat reuse leans on the digest alone.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..symbolic.ops import SymOp, FreeKind
from .eval import BY_NODE_KINDS, M256, Assignment, TxInput, evaluate
from .tape import HostTape

_COMMUTATIVE = frozenset((int(SymOp.ADD), int(SymOp.MUL), int(SymOp.EQ),
                          int(SymOp.AND), int(SymOp.OR), int(SymOp.XOR)))
_UNARY = frozenset((int(SymOp.ISZERO), int(SymOp.NOT), int(SymOp.KECCAK)))
_NO_CHILDREN = frozenset((int(SymOp.NULL), int(SymOp.CONST),
                          int(SymOp.FREE), int(SymOp.KECCAK_SEED)))


def _h(*parts) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\x1f")
    return h.digest()


_ZERO = _h("c", 0)


def _leaf_base(nd) -> bytes:
    """Round-0 label of a FREE leaf. By-node leaves drop their node id
    (that is the name being canonicalized away) but keep kind + packed
    payload; everything else keeps its full semantic identity."""
    if nd.a in BY_NODE_KINDS:
        return _h("bn", nd.a, nd.b, nd.imm & M256)
    return _h("ix", nd.a, nd.b, nd.imm & M256)


def _reach(tape: HostTape) -> List[int]:
    """Dependency cone of every constraint root, as a sorted id list
    (children precede parents in SSA order, so a single ascending pass
    can hash bottom-up)."""
    nodes = tape.nodes
    n = len(nodes)
    seen = set()
    stack = [int(r) for r, _ in tape.constraints]
    while stack:
        i = stack.pop()
        if i in seen or i <= 0 or i >= n:
            continue
        seen.add(i)
        nd = nodes[i]
        op = nd.op
        if op in _NO_CHILDREN:
            continue
        if op == int(SymOp.KECCAK_ABS):
            if 0 < nd.a < i:
                stack.append(nd.a)
            if 0 < nd.b < i:
                stack.append(nd.b)
        elif op in _UNARY:
            if 0 < nd.a < i:
                stack.append(nd.a)
        else:
            if 0 < nd.a < i:
                stack.append(nd.a)
            if 0 < nd.b < i:
                stack.append(nd.b)
    return sorted(seen)


def _node_hashes(tape: HostTape, reach: List[int],
                 colors: Optional[Dict[int, bytes]]) -> Dict[int, bytes]:
    """Bottom-up structural digest per reachable node. ``colors``
    overrides the label of numbered by-node leaves (round 1); None
    uses the round-0 base labels throughout."""
    nodes = tape.nodes
    hs: Dict[int, bytes] = {}

    for i in reach:
        nd = nodes[i]
        op = nd.op

        def ch(j, i=i):
            # out-of-SSA refs and id 0 evaluate concretely to zero
            if j <= 0 or j >= i:
                return _ZERO
            return hs.get(j, _ZERO)

        if op == int(SymOp.NULL):
            hs[i] = _ZERO
        elif op == int(SymOp.CONST):
            hs[i] = _h("c", nd.imm & M256)
        elif op == int(SymOp.FREE):
            if colors is not None and i in colors:
                hs[i] = colors[i]
            else:
                hs[i] = _leaf_base(nd)
        elif op == int(SymOp.KECCAK_SEED):
            hs[i] = _h("ks", nd.imm)
        elif op == int(SymOp.KECCAK_ABS):
            # b == 0 means the absorbed word is the concrete imm
            w = ch(nd.b) if nd.b else _h("c", nd.imm & M256)
            hs[i] = _h("ka", ch(nd.a), w)
        elif op in _UNARY:
            hs[i] = _h(op, ch(nd.a))
        elif op in _COMMUTATIVE:
            a, b = ch(nd.a), ch(nd.b)
            if b < a:
                a, b = b, a
            hs[i] = _h(op, a, b)
        else:
            hs[i] = _h(op, ch(nd.a), ch(nd.b))
    return hs


def _number_leaves(tape: HostTape, order: List[int],
                   h0: Dict[int, bytes]) -> Dict[int, int]:
    """De-Bruijn numbering of by-node leaves: first occurrence in a
    canonical DFS over the constraints in ``order``. Traversal order
    within a node is the round-0 digest order used for hashing, so two
    alpha-variants walk their cones in lockstep."""
    nodes = tape.nodes
    var_of: Dict[int, int] = {}
    visited = set()
    for j in order:
        root = tape.constraints[j][0]
        stack = [int(root)]
        while stack:
            i = stack.pop()
            if i in visited or i <= 0 or i >= len(nodes):
                continue
            visited.add(i)
            nd = nodes[i]
            op = nd.op
            if op == int(SymOp.FREE):
                if nd.a in BY_NODE_KINDS and i not in var_of:
                    var_of[i] = len(var_of)
                continue
            if op in _NO_CHILDREN:
                continue
            if op in _UNARY:
                kids = [nd.a]
            elif op == int(SymOp.KECCAK_ABS):
                kids = [nd.a] + ([nd.b] if nd.b else [])
            elif op in _COMMUTATIVE:
                kids = sorted(
                    (k for k in (nd.a, nd.b)),
                    key=lambda k: h0.get(k, _ZERO) if 0 < k < i else _ZERO)
            else:
                kids = [nd.a, nd.b]
            # reversed push => left-to-right pop order
            for k in reversed(kids):
                if 0 < k < i:
                    stack.append(k)
    return var_of


@dataclass
class CanonicalQuery:
    """One query's canonical identity + the leaf-renaming dictionary
    needed to serialize/rehydrate witnesses in canonical coordinates."""

    digest: str                                  # sha256 hex (32 chars)
    var_of_node: Dict[int, int] = field(default_factory=dict)
    node_of_var: Dict[int, int] = field(default_factory=dict)
    n_constraints: int = 0


def canonical_query(tape: HostTape) -> CanonicalQuery:
    """Canonical content hash of the tape's constraint set (see module
    docstring for the invariances), plus the by-node leaf numbering."""
    if not tape.constraints:
        return CanonicalQuery(digest=hashlib.sha256(b"empty")
                              .hexdigest()[:32])
    reach = _reach(tape)
    h0 = _node_hashes(tape, reach, None)
    # canonical constraint order: round-0 digest breaks input order
    order = sorted(
        range(len(tape.constraints)),
        key=lambda j: (h0.get(int(tape.constraints[j][0]), _ZERO),
                       bool(tape.constraints[j][1])))
    var_of = _number_leaves(tape, order, h0)
    if var_of:
        nodes = tape.nodes
        colors = {i: _h("v", g, nodes[i].a, nodes[i].b,
                        nodes[i].imm & M256)
                  for i, g in var_of.items()}
        h1 = _node_hashes(tape, reach, colors)
    else:
        h1 = h0
    tokens = sorted({
        (h1.get(int(n), _ZERO), bool(s)) for n, s in tape.constraints})
    out = hashlib.sha256()
    out.update(str(len(var_of)).encode())
    for t, s in tokens:
        out.update(t)
        out.update(b"1" if s else b"0")
    return CanonicalQuery(
        digest=out.hexdigest()[:32],
        var_of_node=var_of,
        node_of_var={g: i for i, g in var_of.items()},
        n_constraints=len(tokens))


def canonical_digest(tape: HostTape) -> str:
    return canonical_query(tape).digest


# --- witness (de)hydration in canonical coordinates --------------------
#
# A SAT verdict is only reusable across alpha-variants if its model
# travels in renaming-independent coordinates: tx inputs and scalar env
# leaves are already semantic (same keys on every variant), by-node
# values are re-keyed through the de Bruijn numbering. JSON-safe so the
# verdict store can persist it.

def witness_to_doc(asn: Assignment, canon: CanonicalQuery) -> Dict:
    txs = []
    for t in asn.txs:
        txs.append({"cd": bytes(t.calldata).hex(),
                    "cds": t.calldatasize,
                    "cl": int(t.caller), "cv": int(t.callvalue)})
    return {
        "txs": txs,
        "scalars": {f"{int(k)}:{int(i)}": int(v)
                    for (k, i), v in asn.scalars.items()},
        # values whose node has no var id cannot influence the hashed
        # constraint cone; dropping them loses nothing the verifier sees
        "vars": {str(canon.var_of_node[int(n)]): int(v)
                 for n, v in asn.by_node.items()
                 if int(n) in canon.var_of_node},
    }


def witness_from_doc(tape: HostTape, canon: CanonicalQuery,
                     doc: Dict) -> Optional[Assignment]:
    """Rehydrate a canonical witness onto ``tape``'s coordinates, or
    None if the document is malformed. Callers MUST :func:`witness_ok`
    the result before serving it — rehydration trusts nothing."""
    try:
        asn = Assignment(txs=[])
        for t in doc.get("txs") or []:
            cds = t.get("cds")
            asn.txs.append(TxInput(
                bytearray(bytes.fromhex(t["cd"])),
                int(cds) if cds is not None else None,
                int(t["cl"]), int(t["cv"])))
        if not asn.txs:
            asn.txs.append(TxInput())
        for key, v in (doc.get("scalars") or {}).items():
            k, i = key.split(":")
            asn.scalars[(int(k), int(i))] = int(v)
        for g, v in (doc.get("vars") or {}).items():
            node = canon.node_of_var.get(int(g))
            if node is not None:
                asn.by_node[node] = int(v)
        return asn
    except (KeyError, ValueError, TypeError, AttributeError):
        return None


def witness_ok(tape: HostTape, asn: Assignment) -> bool:
    """Exact check: does ``asn`` satisfy EVERY tape constraint? One
    (native-evaluator) pass — the guard that makes hash-keyed sat reuse
    collision-proof."""
    vals = evaluate(tape, asn)
    return all(bool(vals[int(n)]) == bool(s) for n, s in tape.constraints)


__all__ = ["CanonicalQuery", "canonical_digest", "canonical_query",
           "witness_from_doc", "witness_ok", "witness_to_doc"]
