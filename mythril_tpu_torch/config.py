"""Static-shape configuration for the device interpreter.

The reference has no analog — Python objects grow unboundedly
(``MachineState.stack`` is a list, memory a lazy dict ⚠unv, SURVEY.md §2
"State model"). Every dimension is static; these caps define the
frontier array shapes. Lanes that exceed a cap raise a per-lane error flag
(masked trap) rather than crashing the batch — SURVEY.md §5.2.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LimitsConfig:
    """Shape caps for one frontier. All sizes static at trace time."""

    max_stack: int = 256  # EVM allows 1024; solc output stays far below —
    # deep real-world frames trip ~30-60; 256 leaves 4x headroom and any
    # trip is attributed in the report coverage block (Trap.STACK)
    mem_bytes: int = 4096  # byte-addressable memory cap per lane
    calldata_bytes: int = 256  # symbolic tx calldata cap
    returndata_bytes: int = 256
    storage_slots: int = 64  # associative storage-cache entries per lane
    max_accounts: int = 8  # per-lane world-state account slots
    max_code: int = 24576  # EIP-170 runtime-code limit
    max_hash_bytes: int = 200  # SHA3 input cap (mapping keys are 64 bytes)
    log_slots: int = 8  # recorded LOG entries per lane
    tape_len: int = 512  # symbolic SSA tape nodes per lane
    max_constraints: int = 128  # path-condition slots per lane
    call_depth: int = 4  # saved call contexts per lane
    init_code_bytes: int = 1024  # in-tx CREATE/CREATE2 init-code buffer per
    # lane (longer init code falls back to the codeless-account path)
    call_log: int = 16  # recorded external-call events per lane
    arith_log: int = 32  # recorded symbolic-arithmetic events per lane
    propagate_every: int = 8  # supersteps between feasibility sweeps
    loop_bound: int = 8  # max taken backward jumps to one target per lane
    # (0 disables; reference: BoundedLoopsStrategy --loop-bound ⚠unv)
    loop_slots: int = 8  # tracked distinct back-jump targets per lane
    gas_schedule: str = "istanbul"  # "istanbul" (reference-era static
    # table) or "berlin" (EIP-2929 warm/cold access accounting)

    def __post_init__(self):
        assert self.max_stack >= 17  # SWAP16 arity
        assert self.mem_bytes % 32 == 0


DEFAULT_LIMITS = LimitsConfig()


# Small limits for fast unit tests
TEST_LIMITS = LimitsConfig(
    max_stack=32,
    mem_bytes=1024,
    calldata_bytes=128,
    returndata_bytes=128,
    storage_slots=16,
    max_accounts=4,
    max_code=512,
    max_hash_bytes=136,
    log_slots=4,
    tape_len=128,
    max_constraints=32,
    call_depth=2,
    init_code_bytes=256,
    call_log=4,
    arith_log=8,
    propagate_every=4,
    loop_bound=4,
    loop_slots=4,
)


#: the degradation ladder of the card. The card is the port's only tier,
#: so it is the floor: as on the JAX package's floor tier, the ladder
#: ends at batching (halve the lanes, then the batch width) and no rung
#: moves a batch off the card
CARD_OOM_LADDER = ("halve-lanes", "halve-batch")


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-isolation knobs of the corpus campaign (see
    ``resilience.py``). ``batch_timeout`` is off by default (the
    single-contract ``--execution-timeout`` is a budget; the watchdog is
    for unattended campaigns)."""

    batch_timeout: float | None = None  # seconds per campaign batch
    max_batch_retries: int = 1          # re-attempts before bisection
    # RESOURCE_EXHAUSTED degradation ladder, walked in order and
    # cumulatively: shrink the work until the batch fits instead of
    # aborting the run
    oom_ladder: tuple = CARD_OOM_LADDER
    # batches between durable campaign-checkpoint writes (1 = every
    # batch: a kill at any instant loses at most one batch)
    checkpoint_every: int = 1


DEFAULT_RESILIENCE = ResilienceConfig()
