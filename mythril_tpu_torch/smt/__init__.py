"""Host-side satisfiability layer (the ``mythril.laser.smt`` counterpart).

The reference wraps Z3 (``mythril/laser/smt/{bitvec,solver}`` ⚠unv,
SURVEY.md §2); this image has no Z3, so the stack is self-built:

- the EASY majority of checks is decided on-device by
  ``symbolic.propagate`` (interval abstract interpretation);
- the residue — "give me a concrete witness for this path + predicate" —
  is handled here by :class:`Solver`: tape extraction, exact Python
  evaluation (real keccak), constraint-inversion heuristics, and
  randomized repair search. ``check()``/``model()`` keep the reference's
  solver front-door shape (``support/model.py:get_model`` ⚠unv).
"""

from .tape import HostTape, HostNode, extract_tape
from .eval import Assignment, TxInput, evaluate
from .solver import Solver, UnsatError, solve_lane
from .canon import canonical_digest, canonical_query
from .vstore import VerdictStore

__all__ = [
    "HostTape", "HostNode", "extract_tape",
    "Assignment", "TxInput", "evaluate",
    "Solver", "UnsatError", "solve_lane",
    "canonical_digest", "canonical_query", "VerdictStore",
]
