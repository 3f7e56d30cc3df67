"""IntegerArithmetics (SWC-101): overflow/underflow detection.

Reference: ``mythril/analysis/module/modules/integer.py`` (⚠unv,
SURVEY.md §3.3) — on ADD/SUB/MUL the module asserts the no-overflow
predicate's negation and asks the solver for a model. Here the engine
recorded every symbolic ADD/SUB/MUL/EXP as (op, a, b, r, pc) node ids;
the predicate is assembled host-side on the extracted tape:

- ADD overflow  ⇔ (a + b) mod 2^256 < a        -> LT(r, a) == true
- SUB underflow ⇔ a < b                         -> LT(a, b) == true
- MUL overflow  ⇔ b != 0 and (a*b mod 2^256)/b != a
                                                -> ISZERO(b) == false
                                                   and EQ(DIV(r,b), a) == false
- EXP overflow (sufficient condition) ⇔ base > 1 and exponent > 255 —
  then base^exp >= 2^256 must wrap (the reference concretizes via its
  ExponentFunctionManager; this sound subset catches the
  attacker-controlled-exponent pattern without false positives on
  powers that provably fit).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ....symbolic.ops import SymOp
from ....smt.tape import HostNode, HostTape, cone, intern_node
from ....smt.solver import solve_tape
from ...report import Issue
from ..base import DetectionModule, EntryPoint
from ..loader import register_module


@register_module
class IntegerArithmetics(DetectionModule):
    name = "IntegerArithmetics"
    swc_id = "101"
    description = "Checks for integer over/underflows on ADD/SUB/MUL."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["ADD", "SUB", "MUL", "EXP"]

    @staticmethod
    def _lane_sinks(sf, lane: int) -> list:
        """Node ids where a wrapped result becomes an effect the chain
        can observe (reference: the OverUnderflowAnnotation is reported
        only when it reaches an SSTORE/CALL-family/state sink ⚠unv).
        Storage keys/values only — the gate in ``_execute`` is
        permissive on lanes with calls/logs/returns, whose payloads are
        not fully recorded as node ids."""
        out = []
        for arr in (sf.st_val_sym, sf.st_key_sym):
            row = np.asarray(arr[lane])
            out.extend(int(x) for x in row[row > 0])
        return out

    def _execute(self, ctx) -> List[Issue]:
        issues: List[Issue] = []
        sf = ctx.sf
        n_arith = np.asarray(sf.n_arith)
        arith_op = np.asarray(sf.arith_op)
        arith_a = np.asarray(sf.arith_a)
        arith_b = np.asarray(sf.arith_b)
        arith_r = np.asarray(sf.arith_r)
        arith_pc = np.asarray(sf.arith_pc)
        arith_cid = np.asarray(sf.arith_cid)
        retval_len = np.asarray(sf.base.retval_len)
        n_calls = np.asarray(sf.n_calls)
        n_logs = np.asarray(sf.base.n_logs)
        rv_havoc = np.asarray(sf.rv_havoc)
        A = int(sf.base.acct_used.shape[1])
        for lane in ctx.lanes():
            n = int(n_arith[lane])
            if n == 0:
                continue
            # annotation-channel sink gate (reference: the
            # OverUnderflowAnnotation rides expression annotations and is
            # reported only at sinks ⚠unv SURVEY §3.3): the wrapped result
            # must REACH an observable effect — a storage key/value or a
            # path constraint (JUMPI guard; genuinely guarded ops are then
            # proven unsat by the interned predicate, not lost here).
            # The gate only engages on lanes whose EVERY outlet is
            # tracked: a lane that returned data (or a symbolic-offset
            # RETURN, rv_havoc), made any call (argument memory is not
            # recorded as node ids), or emitted any log (only
            # topic0/data0 are recorded) keeps the permissive
            # pre-annotation behavior — the wrapped value may have left
            # through the untracked channel. FREE(STORAGE) leaves
            # traverse into their symbolic key (which slot a read hits
            # depends on the key), via storage_key_div=A.
            base = ctx.tape(lane)
            sink_cone = None
            all_outlets_tracked = (
                int(retval_len[lane]) == 0 and int(n_calls[lane]) == 0
                and int(n_logs[lane]) == 0 and not bool(rv_havoc[lane])
            )
            if all_outlets_tracked:
                sinks = self._lane_sinks(sf, lane)
                sinks.extend(int(nd) for nd, _ in base.constraints)
                if sinks:
                    sink_cone = cone(base, sinks, storage_key_div=A)
            for j in range(min(n, arith_op.shape[1])):
                op = int(arith_op[lane, j])
                pc = int(arith_pc[lane, j])
                cid = int(arith_cid[lane, j])
                if self._seen(cid, pc):
                    continue
                if op not in (0x01, 0x02, 0x03, 0x0A):
                    continue
                a = int(arith_a[lane, j])
                b = int(arith_b[lane, j])
                r = int(arith_r[lane, j])
                if sink_cone is not None and r not in sink_cone:
                    # wrapped value never reaches an effect on this
                    # lane; another lane may still decide this pc
                    self._cache.discard((cid, pc))
                    continue
                nodes = list(base.nodes)
                idx = dict(ctx.tape_index(lane))
                cons = list(base.constraints)
                # predicate nodes are INTERNED onto the path tape: a
                # SafeMath guard asserts the very same LT node, and the
                # shared id lets the refuter prove guarded ops UNSAT
                if op == 0x01:  # ADD
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.LT), r, a, 0), idx), True))
                    word = "overflow"
                elif op == 0x03:  # SUB
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.LT), a, b, 0), idx), True))
                    word = "underflow"
                elif op == 0x02:  # MUL
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.ISZERO), b, 0, 0), idx),
                        False))
                    did = intern_node(nodes, HostNode(int(SymOp.DIV), r, b, 0),
                                      idx)
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.EQ), did, a, 0), idx),
                        False))
                    word = "overflow"
                else:  # 0x0A EXP — sufficient condition: base >= 2 and
                    # exponent > 255 forces base^exp >= 2^256 to wrap.
                    # (The reference concretizes via its
                    # ExponentFunctionManager ⚠unv; this sound subset
                    # catches the unbounded attacker-exponent pattern and
                    # never flags a power that provably fits.)
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.GT), a,
                                        intern_node(nodes, HostNode(
                                            int(SymOp.CONST), 0, 0, 1), idx),
                                        0), idx), True))
                    cons.append((intern_node(
                        nodes, HostNode(int(SymOp.GT), b,
                                        intern_node(nodes, HostNode(
                                            int(SymOp.CONST), 0, 0, 255),
                                            idx), 0), idx), True))
                    word = "overflow"
                asn = solve_tape(HostTape(nodes=nodes, constraints=cons),
                                 max_iters=ctx.solver_iters)
                if asn is None:
                    self._cache.discard((cid, pc))  # other lanes may decide it
                    continue
                issues.append(Issue(
                    swc_id=self.swc_id,
                    title="Integer Arithmetic Bugs",
                    severity="High",
                    address=pc,
                    contract=ctx.cid_name(cid),
                    lane=int(lane),
                    description=(
                        "The arithmetic operation can result in integer "
                        f"{word}. The operands are attacker-controlled and "
                        "the wrapped result flows onward unchecked."
                    ),
                    transaction_sequence=ctx.tx_sequence(asn),
                ))
        return issues
