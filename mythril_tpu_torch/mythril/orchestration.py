"""Config + loading + analysis front door (the JAX package's
``mythril/orchestration.py`` for runtime and optional creation bytecode,
plus ``device``)."""

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
    create_timeout: Optional[float] = None  # seconds for the creation tx
    parallel_solving: bool = False
    strategy: str = "bfs"                 # fork-admission policy (six strategies)
    enable_iprof: bool = False            # per-opcode instruction profiler
    plugins: tuple = ()                   # LaserPlugin instances (plugin/discovery.py)
    device: str = "cuda"

    def resolved_limits(self) -> LimitsConfig:
        if self.loop_bound is None:
            return self.limits
        return dataclasses.replace(self.limits, loop_bound=self.loop_bound)


@dataclass
class EVMContract:
    """Runtime (+ optional creation) bytecode for one contract."""

    code: bytes
    name: str = "MAIN"
    creation_code: Optional[bytes] = None
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
    """Loading front door: hex strings and hex files of runtime (and
    optional creation) bytecode."""

    @staticmethod
    def load_from_bytecode(code, creation_code=None, name: str = "MAIN") -> EVMContract:
        return EVMContract(
            code=_to_bytes(code), name=name,
            creation_code=_to_bytes(creation_code) if creation_code else None)

    @staticmethod
    def load_from_file(path: str, creation_path: Optional[str] = None,
                       name: Optional[str] = None) -> EVMContract:
        def read(p: str) -> bytes:
            with open(p) as fh:
                return _to_bytes(fh.read())

        return EVMContract(
            code=read(path), name=name or path.rsplit("/", 1)[-1],
            creation_code=read(creation_path) if creation_path else None)


class MythrilAnalyzer:
    """Analysis driver: runs the engine and the detection modules."""

    def __init__(self, contracts: Sequence[EVMContract],
                 config: Optional[MythrilConfig] = None):
        self.contracts = list(contracts)
        self.config = config or MythrilConfig()
        self.sym: Optional[SymExecWrapper] = None

    def fire_lasers(self, modules: Optional[List[str]] = None) -> Report:
        cfg = self.config
        creation = [c.creation_code for c in self.contracts]
        with_creation = any(c is not None for c in creation)
        if with_creation:
            # contracts without creation code deploy via an empty-effect
            # constructor (immediate STOP) so the batch stays uniform
            creation = [c if c is not None else b"\x00" for c in creation]
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
            creation_bytecodes=creation if with_creation else None,
            execution_timeout=cfg.execution_timeout,
            create_timeout=cfg.create_timeout,
            strategy=cfg.strategy,
            enable_iprof=cfg.enable_iprof,
            plugins=cfg.plugins,
            device=cfg.device,
        )
        report = fire_lasers(self.sym, white_list=modules,
                             parallel=cfg.parallel_solving)
        if self.contracts:
            report.contract_name = self.contracts[0].name
        return report
