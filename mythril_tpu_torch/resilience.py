"""Fault-isolated campaign execution: watchdog, error triage, fault
injection, the degradation ladder.

PyTorch counterpart of the part of the JAX package's ``resilience.py``
that the corpus campaign uses:

- :func:`run_with_watchdog` — run a callable under a hard wall-clock
  deadline in a worker thread; expiry raises :class:`BatchTimeout`
  instead of stalling the campaign (the stuck thread is abandoned: a
  wedged device call cannot be interrupted from Python);
- :func:`classify_backend_error` — sort a batch failure into the
  recovery path that can cure it, with the card's own markers:
  ``torch.cuda.OutOfMemoryError`` and a kernel launch's allocation
  failure are ``"oom"``, an illegal address or a lost device
  ``"device-lost"``, a kernel that does not build ``"compile"``;
- :class:`FaultInjector` — deterministic fault injection (hang / raise /
  device-lost / kill / oom at a batch index or on a contract name, from
  ``--fault-inject``), so every recovery path is testable on the CPU;
- :func:`parse_ladder` — the ``--oom-ladder`` rungs.

The card is the port's only tier: there is no backend probe, no engine
worker subprocess and no tier to demote to (they come with the
backend-tier slice). The ladder's tier rung, ``next-tier`` (the JAX
spelling ``cpu`` is accepted), therefore behaves as the JAX ladder does
when the terminal tier is the only one: it replays the batch at the
shape the earlier rungs left, on the same device. No rung runs a batch
on the CPU.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

from .config import DEFAULT_RESILIENCE


class ResilienceError(RuntimeError):
    """Base for supervisor-level failures."""


class BatchTimeout(ResilienceError):
    """A watchdogged unit of work exceeded its wall-clock budget."""


class DeviceLostError(ResilienceError):
    """The card went away mid-run (injected or detected)."""


class ResourceExhausted(ResilienceError):
    """Device or host memory exhaustion (injected or classified from a
    backend error). The campaign answers this with the degradation
    ladder: shrink the work, don't abort the run."""


class InjectedKill(BaseException):
    """Simulates SIGKILL mid-batch for kill/resume testing.

    Deliberately a ``BaseException``: the campaign's retry/bisect
    machinery catches ``Exception`` — a simulated kill must blow through
    it uncheckpointed, exactly like a real SIGKILL would.
    """


# --- watchdog ---------------------------------------------------------


def run_with_watchdog(fn: Callable, timeout: Optional[float],
                      label: str = "work"):
    """Run ``fn()`` under a hard wall-clock deadline.

    ``timeout=None`` runs inline (no thread). Otherwise the work runs in
    a daemon thread; if it has not finished after ``timeout`` seconds a
    :class:`BatchTimeout` is raised and the thread is ABANDONED (it dies
    with the process; an injected hang just sleeps). Exceptions from
    ``fn`` (including ``BaseException``s like :class:`InjectedKill`)
    re-raise in the caller.
    """
    if timeout is None:
        return fn()
    box: Dict[str, object] = {}
    done = threading.Event()

    def work():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=work, daemon=True,
                         name=f"watchdog:{label}")
    t.start()
    if not done.wait(timeout):
        raise BatchTimeout(
            f"{label} exceeded {timeout:.1f}s wall-clock budget")
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box.get("value")


# --- backend-error classification -------------------------------------

# message fragments (lowercased) of the card's failures: PyTorch's
# caching allocator ("CUDA out of memory. Tried to allocate ..."), and the
# CUDA runtime's sticky errors after which the context is lost (as
# PyTorch raises them and as ``kernels._raise_on`` names a kernel
# launch's error)
_OOM_MARKERS = ("out of memory", "resource_exhausted", "resource exhausted",
                "failed to allocate")
_DEVICE_LOST_MARKERS = ("illegal memory access", "illegal address",
                        "illegal instruction", "misaligned address",
                        "invalid program counter", "hardware stack error",
                        "unspecified launch failure",
                        "device-side assert", "uncorrectable ecc error",
                        "no cuda-capable device", "busy or unavailable",
                        "device lost", "device_lost")


def classify_backend_error(e: BaseException) -> Optional[str]:
    """Sort a batch failure into the recovery path that can cure it:
    ``"oom"`` (degradation ladder), ``"device-lost"`` (the card is gone:
    retry, then bisect), ``"compile"`` (a kernel does not build; no
    point retrying the identical batch — bisect immediately), or
    ``None`` (unclassified: the generic retry → bisect path).

    Matches by type first (:class:`ResourceExhausted`,
    ``torch.cuda.OutOfMemoryError``, ``MemoryError``,
    :class:`DeviceLostError`, ``kernels.KernelBuildError``), then by
    message fragments of the CUDA runtime's errors."""
    if isinstance(e, (ResourceExhausted, MemoryError)):
        return "oom"
    if isinstance(e, DeviceLostError):
        return "device-lost"
    # by name, so that sorting an error imports neither torch nor the
    # kernels module (``torch.cuda.OutOfMemoryError`` is a RuntimeError)
    names = {t.__name__ for t in type(e).__mro__}
    if "OutOfMemoryError" in names:
        return "oom"
    if "KernelBuildError" in names:
        return "compile"
    text = f"{type(e).__name__}: {e}".lower()
    if any(m in text for m in _OOM_MARKERS):
        return "oom"
    if any(m in text for m in _DEVICE_LOST_MARKERS):
        return "device-lost"
    return None


# --- degradation ladder ----------------------------------------------

#: the tier rung: demote to the next tier. The card is the only tier, so
#: the rung replays the batch at the current shape on the card
TIER_RUNG = "next-tier"
#: the JAX package's name of the tier rung, accepted in ``--oom-ladder``
TIER_RUNG_ALIAS = "cpu"
#: every rung a ladder may name, in their usual walk order
DEGRADE_RUNGS = ("halve-lanes", "halve-batch", TIER_RUNG)


def parse_ladder(text: Optional[str]) -> Tuple[str, ...]:
    """``--oom-ladder`` parser: comma-separated rung names in walk
    order; ``None`` is the card's default ladder, ``"none"`` (or empty)
    disables degradation entirely."""
    if text is None:
        return tuple(DEFAULT_RESILIENCE.oom_ladder)
    rungs = tuple(TIER_RUNG if r.strip() == TIER_RUNG_ALIAS else r.strip()
                  for r in text.split(",") if r.strip())
    if rungs in ((), ("none",)):
        return ()
    for r in rungs:
        if r not in DEGRADE_RUNGS:
            raise ValueError(
                f"oom ladder rung {r!r}: must be of {DEGRADE_RUNGS}")
    return rungs


# --- fault injection --------------------------------------------------

FAULT_MODES = ("hang", "raise", "device-lost", "kill", "oom")

#: how long an injected hang sleeps per check; the watchdog is expected
#: to fire long before the total (a daemon thread naps harmlessly after)
_HANG_TOTAL_S = 3600.0


@dataclass
class FaultSpec:
    """One trigger: ``mode`` fires when the batch index and/or contract
    name matches, at most ``times`` times (None = every time — a
    persistent poison; ``times=1`` models a transient fault the
    retry-once policy cures)."""

    mode: str
    batch: Optional[int] = None
    contract: Optional[str] = None
    times: Optional[int] = None
    fired: int = 0

    def matches(self, batch: Optional[int],
                contracts: Sequence[str]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.batch is not None and batch != self.batch:
            return False
        if self.contract is not None and self.contract not in contracts:
            return False
        return True

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """``mode[:key=value]*`` — e.g. ``raise:contract=c002``,
        ``hang:batch=1``, ``raise:batch=0:times=1``, ``kill:batch=2``,
        ``oom:batch=1:times=2``."""
        parts = [p for p in text.strip().split(":") if p]
        if not parts or parts[0] not in FAULT_MODES:
            raise ValueError(
                f"fault spec {text!r}: mode must be one of {FAULT_MODES}")
        spec = cls(mode=parts[0])
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"fault spec {text!r}: expected key=value, "
                                 f"got {kv!r}")
            k, v = kv.split("=", 1)
            if k == "batch":
                spec.batch = int(v)
            elif k == "contract":
                spec.contract = v
            elif k == "times":
                spec.times = int(v)
            else:
                raise ValueError(f"fault spec {text!r}: unknown key {k!r}")
        if spec.batch is None and spec.contract is None:
            raise ValueError(
                f"fault spec {text!r}: need batch= and/or contract= (an "
                "unconditional fault would poison every batch)")
        return spec


class FaultInjector:
    """Deterministic fault source, checked at the top of every guarded
    batch attempt. Specs parse from a ``;``-separated string
    (``--fault-inject``) or are built directly."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = list(specs)

    @classmethod
    def from_string(cls, text: Optional[str]) -> Optional["FaultInjector"]:
        if not text:
            return None
        return cls([FaultSpec.parse(p)
                    for p in text.split(";") if p.strip()])

    def fire(self, batch: Optional[int] = None,
             contracts: Sequence[str] = ()) -> None:
        """Raise/hang per the first matching spec (called INSIDE the
        watchdog, so a hang surfaces as :class:`BatchTimeout`)."""
        for spec in self.specs:
            if not spec.matches(batch, contracts):
                continue
            spec.fired += 1
            if spec.mode == "hang":
                t0 = time.monotonic()
                while time.monotonic() - t0 < _HANG_TOTAL_S:
                    time.sleep(0.05)
                return
            if spec.mode == "raise":
                raise ResilienceError(
                    f"injected fault (batch={batch}, "
                    f"contracts={list(contracts)})")
            if spec.mode == "device-lost":
                raise DeviceLostError(
                    f"injected device loss (batch={batch})")
            if spec.mode == "kill":
                raise InjectedKill(
                    f"injected kill (batch={batch})")
            if spec.mode == "oom":
                # the message of a real allocator failure, so that the
                # classifier takes the same string path it would on the
                # card; ``times=N`` models pressure that clears after N
                # ladder steps shrink the working set
                raise ResourceExhausted(
                    f"injected RESOURCE_EXHAUSTED: out of memory "
                    f"(batch={batch})")
