"""Symbolic layer: SSA tape ops, the symbolic frontier, the engine."""

from .ops import SymOp, FreeKind, WELL_KNOWN, N_WELL_KNOWN, calldata_arg_offsets  # noqa: F401
from .state import SymFrontier, make_sym_frontier, SymSpec  # noqa: F401
from .engine import (sym_superstep, sym_run, expand_forks, append_node,  # noqa: F401
                     between_txs)
from .propagate import propagate_feasibility, kill_infeasible  # noqa: F401
