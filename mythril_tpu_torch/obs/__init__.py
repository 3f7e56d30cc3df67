"""Unified telemetry spine (docs/observability.md).

Two halves:

- :mod:`.trace` — span tracer: Chrome-trace JSON (Perfetto-loadable)
  plus an append-only, versioned JSONL event log; near-zero overhead
  when disabled;
- :mod:`.metrics` — process-local counter/gauge/histogram registry,
  snapshotted to JSON or Prometheus text format.

Both are stdlib-only imports (no jax, no engine) so backend-free front
ends — ``campaign-merge``, bench's pre-probe phase, the trace report
tool — can load them without initializing a backend.
"""

from . import metrics, trace

__all__ = ["metrics", "trace"]
