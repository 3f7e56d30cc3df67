"""Config + loading + analysis front door (the JAX package's
``mythril/orchestration.py`` for runtime bytecode, plus ``device``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from ..analysis import Report, SymExecWrapper, fire_lasers
from ..config import DEFAULT_LIMITS, LimitsConfig
from ..disassembler.disassembly import Disassembly, _to_bytes
from ..symbolic import SymSpec


@dataclass
class MythrilConfig:
    """Analysis-wide knobs; ``device`` is where the engine runs."""

    limits: LimitsConfig = field(
        default_factory=lambda: dataclasses.replace(DEFAULT_LIMITS))
    spec: SymSpec = field(default_factory=SymSpec)
    transaction_count: int = 2
    max_steps: int = 512
    lanes_per_contract: int = 64
    solver_iters: int = 400
    solver_timeout: Optional[float] = None
    loop_bound: Optional[int] = None      # None = limits.loop_bound
    execution_timeout: Optional[float] = None
    parallel_solving: bool = False
    strategy: str = "bfs"
    plugins: tuple = ()
    device: str = "cuda"

    def resolved_limits(self) -> LimitsConfig:
        if self.loop_bound is None:
            return self.limits
        return dataclasses.replace(self.limits, loop_bound=self.loop_bound)


@dataclass
class EVMContract:
    """Runtime bytecode for one contract."""

    code: bytes
    name: str = "MAIN"
    address: Optional[int] = None
    _disassembly: Optional[Disassembly] = field(default=None, repr=False)

    @property
    def disassembly(self) -> Disassembly:
        if self._disassembly is None:
            self._disassembly = Disassembly(self.code)
        return self._disassembly

    def get_easm(self) -> str:
        return self.disassembly.get_easm()


class MythrilDisassembler:
    """Loading front door: hex strings and hex files of runtime bytecode."""

    @staticmethod
    def load_from_bytecode(code, name: str = "MAIN") -> EVMContract:
        return EVMContract(code=_to_bytes(code), name=name)

    @staticmethod
    def load_from_file(path: str, name: Optional[str] = None) -> EVMContract:
        with open(path) as fh:
            return EVMContract(code=_to_bytes(fh.read()),
                               name=name or path.rsplit("/", 1)[-1])


class MythrilAnalyzer:
    """Analysis driver: runs the engine and the detection modules."""

    def __init__(self, contracts: Sequence[EVMContract],
                 config: Optional[MythrilConfig] = None):
        self.contracts = list(contracts)
        self.config = config or MythrilConfig()
        self.sym: Optional[SymExecWrapper] = None

    def fire_lasers(self, modules: Optional[List[str]] = None) -> Report:
        cfg = self.config
        addrs = None
        if any(c.address is not None for c in self.contracts):
            from ..core.frontier import contract_address

            addrs = [c.address if c.address is not None else contract_address(i)
                     for i, c in enumerate(self.contracts)]
        self.sym = SymExecWrapper(
            [c.code for c in self.contracts],
            contract_names=[c.name for c in self.contracts],
            contract_addrs=addrs,
            limits=cfg.resolved_limits(),
            spec=cfg.spec,
            lanes_per_contract=cfg.lanes_per_contract,
            max_steps=cfg.max_steps,
            solver_iters=cfg.solver_iters,
            solver_timeout=cfg.solver_timeout,
            transaction_count=cfg.transaction_count,
            execution_timeout=cfg.execution_timeout,
            strategy=cfg.strategy,
            plugins=cfg.plugins,
            device=cfg.device,
        )
        report = fire_lasers(self.sym, white_list=modules,
                             parallel=cfg.parallel_solving)
        if self.contracts:
            report.contract_name = self.contracts[0].name
        return report
