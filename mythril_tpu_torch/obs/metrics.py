"""Process-local metrics registry: counters, gauges, histograms.

The numeric half of the telemetry spine (obs/trace.py is the temporal
half): frontier occupancy, fork/park/spill rates, solver checks, compile
and degrade events, checkpoint write latency — one registry, snapshotted
to JSON (``--metrics FILE``) and optionally rendered in Prometheus text
exposition format (``FILE.prom``) for scrape-style collection.

Design points:

- updates are lock-guarded but allocation-free on the hot path; a
  metric object is created once (``REGISTRY.counter("x")`` get-or-create)
  and then ``inc``/``set``/``observe`` are O(1);
- the registry itself is always live — recording a counter costs tens of
  nanoseconds — but EXPENSIVE collection (host transfers of device
  arrays to compute occupancy) must be gated on ``REGISTRY.enabled``
  (set by ``--metrics`` / the soak) or ``trace.active()``;
- snapshots are plain dicts with a ``schema`` stamp so downstream
  tooling can evolve; histogram snapshots carry count/sum/min/max plus
  cumulative bucket counts (Prometheus ``le`` semantics).

Stdlib-only import, like obs/trace.py.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional, Sequence

#: version stamped into every snapshot
SCHEMA = 1

#: default histogram buckets (seconds): spans engine chunk times (~ms)
#: through cold XLA compiles (~minutes)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus-legal metric name (invalid chars become ``_``)."""
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _esc_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", " "))


def label_key(name: str, labels: Optional[Dict]) -> str:
    """Registry key for one labeled series: the base name plus a
    canonical (sorted, escaped) Prometheus label block. Two call sites
    with the same labels in any order share one series."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_esc_label(labels[k])}"'
                     for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _split_labels(name: str):
    """``(base, label_block)`` from a registry key; the block keeps its
    braces (``'{reason="depth"}'``) or is empty."""
    base, sep, rest = name.partition("{")
    return base, (sep + rest if sep else "")


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("name", "help", "value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "help", "value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max."""

    __slots__ = ("name", "help", "buckets", "bucket_counts", "count",
                 "sum", "min", "max", "_lock")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        # one slot per finite bucket + the +Inf overflow slot
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate (``q`` in [0, 1]): the
        upper bound of the first bucket whose cumulative count reaches
        ``q * count``, clamped to the observed ``max`` (the heartbeat's
        ``req p50/p95`` token — coarse by design, no sample storage).
        ``None`` when empty."""
        with self._lock:
            if not self.count:
                return None
            target = q * self.count
            running = 0
            for le, n in zip(self.buckets, self.bucket_counts):
                running += n
                if running >= target:
                    return min(le, self.max)
            return self.max

    def as_dict(self) -> Dict:
        with self._lock:
            cumulative: Dict[str, int] = {}
            running = 0
            for le, n in zip(self.buckets, self.bucket_counts):
                running += n
                cumulative[repr(le)] = running
            cumulative["+Inf"] = running + self.bucket_counts[-1]
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "min": (round(self.min, 6) if self.count else None),
                "max": (round(self.max, 6) if self.count else None),
                "buckets": cumulative,
            }


class MetricsRegistry:
    """Get-or-create registry of named metrics. One module-level
    instance (:data:`REGISTRY`) serves the whole process; tests build
    private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        #: gate for EXPENSIVE collection only (device syncs etc.);
        #: plain inc/set/observe calls are always accepted
        self.enabled = False

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict] = None) -> Counter:
        """``labels`` names one series of a labeled family
        (``counter("serve_shed_total", labels={"reason": "depth"})``);
        the Prometheus rendering groups the family under one
        HELP/TYPE block."""
        return self._get(label_key(name, labels), Counter, help=help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict] = None) -> Gauge:
        return self._get(label_key(name, labels), Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labels: Optional[Dict] = None) -> Histogram:
        return self._get(label_key(name, labels), Histogram, help=help,
                         buckets=buckets)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self.enabled = False

    # --- export --------------------------------------------------------
    def snapshot(self) -> Dict:
        """Plain-dict snapshot: ``{"schema", "t", "counters", "gauges",
        "histograms"}`` — the ``--metrics FILE`` payload."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict = {"schema": SCHEMA, "t": round(time.time(), 3),
                     "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = round(m.value, 6)
            elif isinstance(m, Gauge):
                out["gauges"][name] = round(m.value, 6)
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.as_dict()
        return out

    def to_prometheus(self, prefix: str = "mythril_") -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            items = list(self._metrics.items())
        lines: List[str] = []
        # HELP/TYPE are per FAMILY: labeled series of one base name
        # share a single header block (Prometheus exposition contract)
        headed: set = set()

        def head(pn: str, kind: str, help_text: str) -> None:
            if pn in headed:
                return
            headed.add(pn)
            if help_text:
                lines.append(f"# HELP {pn} {help_text}")
            lines.append(f"# TYPE {pn} {kind}")

        for name, m in items:
            base, labels = _split_labels(name)
            pn = _prom_name(prefix + base)
            if isinstance(m, Counter):
                head(pn, "counter", m.help)
                lines.append(f"{pn}{labels} {m.value:g}")
            elif isinstance(m, Gauge):
                head(pn, "gauge", m.help)
                lines.append(f"{pn}{labels} {m.value:g}")
            elif isinstance(m, Histogram):
                head(pn, "histogram", m.help)
                d = m.as_dict()
                # merge the series' label block with the ``le`` label
                # (``x_bucket{stage="device",le="0.5"}``)
                inner = labels[1:-1] if labels else ""
                for le, n in d["buckets"].items():
                    lb = f'{inner},le="{le}"' if inner else f'le="{le}"'
                    lines.append(f"{pn}_bucket{{{lb}}} {n}")
                lines.append(f"{pn}_sum{labels} {d['sum']:g}")
                lines.append(f"{pn}_count{labels} {d['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write(self, path: str) -> None:
        """Snapshot to ``path``: Prometheus text when the suffix is
        ``.prom``/``.txt``, JSON otherwise. Atomic (tmp + rename) so a
        kill mid-write never leaves a half snapshot."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if path.endswith((".prom", ".txt")):
            data = self.to_prometheus()
        else:
            data = json.dumps(self.snapshot(), indent=1)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(data)
        os.replace(tmp, path)


#: the process-global registry every instrumentation site uses
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


# --- cross-process metric backhaul (engine worker -> supervisor) --------

def snapshot_delta(after: Dict, before: Dict) -> Dict:
    """What changed between two :meth:`MetricsRegistry.snapshot` dicts —
    the engine worker ships this per batch reply so its counter ticks
    and histogram observations land in the parent registry instead of
    dying with the subprocess. Counters and histogram counts/buckets are
    differenced; gauges carry their last value."""
    out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    b_ctr = before.get("counters", {})
    for k, v in after.get("counters", {}).items():
        d = v - b_ctr.get(k, 0.0)
        if d:
            out["counters"][k] = round(d, 6)
    for k, v in after.get("gauges", {}).items():
        if v != before.get("gauges", {}).get(k):
            out["gauges"][k] = v
    b_h = before.get("histograms", {})
    for k, h in after.get("histograms", {}).items():
        hb = b_h.get(k, {})
        dc = h["count"] - hb.get("count", 0)
        if not dc:
            continue
        bb = hb.get("buckets", {})
        out["histograms"][k] = {
            "count": dc,
            "sum": round(h["sum"] - hb.get("sum", 0.0), 6),
            "min": h.get("min"), "max": h.get("max"),
            "buckets": {le: n - bb.get(le, 0)
                        for le, n in h["buckets"].items()},
        }
    return out


def apply_delta(delta: Optional[Dict],
                registry: Optional[MetricsRegistry] = None) -> None:
    """Fold a :func:`snapshot_delta` payload into a registry (the
    supervisor side of the backhaul). Histogram bucket deltas are
    de-cumulated back into per-bucket increments; min/max fold through
    direct comparison."""
    if not delta:
        return
    reg = registry if registry is not None else REGISTRY
    for k, v in delta.get("counters", {}).items():
        reg._get(k, Counter).inc(v)
    for k, v in delta.get("gauges", {}).items():
        reg._get(k, Gauge).set(v)
    for k, h in delta.get("histograms", {}).items():
        m = reg._get(k, Histogram)
        cum = h.get("buckets", {})
        with m._lock:
            m.count += int(h.get("count", 0))
            m.sum += float(h.get("sum", 0.0))
            for bound in ("min", "max"):
                v = h.get(bound)
                if isinstance(v, (int, float)):
                    if bound == "min" and v < m.min:
                        m.min = v
                    elif bound == "max" and v > m.max:
                        m.max = v
            prev = 0
            for i, le in enumerate(m.buckets):
                c = cum.get(repr(le), prev)
                m.bucket_counts[i] += max(0, c - prev)
                prev = max(prev, c)
            inf = cum.get("+Inf", prev)
            m.bucket_counts[-1] += max(0, inf - prev)


__all__ = ["SCHEMA", "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "REGISTRY", "apply_delta", "get_registry",
           "label_key", "snapshot_delta"]
