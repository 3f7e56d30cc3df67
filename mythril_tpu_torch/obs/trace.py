"""Span tracer: one ordered, schema'd event stream for the whole stack.

Before this module, diagnosing a slow or degraded campaign meant
grepping four disjoint channels (iprof histograms, ``CorpusCampaign``
events, ``BackendManager`` events, ad-hoc ``time.monotonic()`` deltas in
bench/tools). The tracer unifies them:

- ``with trace.span("superstep", steps=64):`` times a phase and emits it
  as BOTH a Chrome-trace event (open the ``--trace`` file in Perfetto /
  ``chrome://tracing``) and one line of an append-only JSONL event log
  with a versioned schema (``tools/trace_report.py`` summarizes it, the
  soak asserts it);
- ``trace.event("degrade", batch=3, step="halve-lanes")`` emits an
  instant event — the campaign re-emits its existing ``_events`` /
  ``backend.events`` channels here so the one stream carries everything
  in order;
- disabled (the default — no ``--trace`` flag), ``span()`` returns a
  shared no-op singleton and ``event()`` returns immediately: no
  allocation, no clock read, no file. Hot paths stay hot.

The JSONL schema (version :data:`SCHEMA`): every line is one JSON object
with at least ``kind`` (``"span"`` or an instant-event kind), ``t``
(wall-clock ``time.time()``, seconds) and ``schema``. Spans add ``name``,
``dur`` (seconds), ``mono`` (``time.monotonic()`` at span start — orders
events within a session where wall time may step) and ``tid``; all
``span(...)`` keyword attributes ride along verbatim. ``session`` is a
per-process token so streams from resumed/merged sessions stay sortable
(see ``merge_campaigns``).

``timer()`` is the always-measuring variant: it returns a real
:class:`Span` whose ``elapsed`` property works whether or not tracing is
enabled (emitting only when it is). bench.py and the profilers use it in
place of their former ad-hoc ``perf_counter``/``monotonic`` pairs, so
one mechanism both measures and (when asked) records.

Import cost is stdlib-only — no jax, no engine — so backend-free
front-ends (``campaign-merge``, bench's pre-probe phase) can load it.
"""

from __future__ import annotations

import collections
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

#: version stamped into every JSONL event (bump on breaking field
#: changes; readers must reject newer-than-known schemas)
SCHEMA = 1

#: default JSONL size-rotation threshold (docs/observability.md): an
#: always-on serve daemon must not grow the event log without bound
DEFAULT_MAX_JSONL_BYTES = int(os.environ.get(
    "MYTHRIL_TRACE_MAX_BYTES", 64 * 1024 * 1024))

#: cap on buffered (child-process) records per batch — a runaway span
#: source must not grow the IPC reply without bound
BUFFER_CAP = 20000


def jsonl_path_for(chrome_path: str) -> str:
    """The JSONL event-log path derived from a ``--trace FILE``:
    ``t.json -> t.jsonl``, anything else gets ``.jsonl`` appended."""
    if chrome_path.endswith(".json"):
        return chrome_path[:-5] + ".jsonl"
    return chrome_path + ".jsonl"


# --- request trace context (docs/observability.md "Distributed
# --- tracing") ----------------------------------------------------------
#
# One ``trace_id`` is minted at every ingestion point (HTTP submit,
# follower block, fleet unit claim, CLI analyze) and rides the ambient
# context below through every span/event emitted inside its scope —
# including across process boundaries, where an explicit
# ``context_snapshot()`` travels in the engine-worker IPC frame and is
# re-entered child-side with ``apply_context()``.

_CTX: "contextvars.ContextVar" = contextvars.ContextVar(
    "mythril_trace_ctx", default=None)


def new_trace_id() -> str:
    """A fresh 16-hex-char request trace id."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """A fresh 8-hex-char span id (unique within a trace)."""
    return os.urandom(4).hex()


class _CtxGuard:
    """Context-manager handle for one entered trace scope."""

    __slots__ = ("_token",)

    def __init__(self, token):
        self._token = token

    def __enter__(self) -> "_CtxGuard":
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            try:
                _CTX.reset(self._token)
            except ValueError:
                pass  # exited in a different context (thread hand-off)
            self._token = None
        return False


def trace_context(trace_id: Optional[str] = None,
                  parent: Optional[str] = None,
                  link_ids: Sequence[str] = ()) -> _CtxGuard:
    """Enter a request trace scope: every span/event emitted inside it
    carries ``trace_id`` (+ ``parent`` span linkage). ``trace_id=None``
    MINTS a fresh id — the ingestion-point spelling. ``link_ids`` are
    additional trace ids sharing this scope (a scheduler batch serves
    entries from several requests; its spans index under every one)."""
    ids = [trace_id or new_trace_id()]
    for x in link_ids:
        if x and x not in ids:
            ids.append(x)
    return _CtxGuard(_CTX.set((tuple(ids), parent)))


def context_snapshot() -> Optional[Dict]:
    """The current trace scope as a plain dict (``{"ids", "span"}``) —
    the form that crosses process/thread boundaries (engine-worker IPC
    frames, the pipelined host-phase thread). ``None`` outside any
    scope."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    ids, parent = ctx
    return {"ids": list(ids), "span": parent}


def apply_context(snap: Optional[Dict]) -> _CtxGuard:
    """Re-enter a scope captured by :func:`context_snapshot` (no-op
    guard for ``None`` — callers need not branch)."""
    if not isinstance(snap, dict) or not snap.get("ids"):
        return _CtxGuard(None)
    ids = tuple(str(x) for x in snap["ids"])
    return _CtxGuard(_CTX.set((ids, snap.get("span"))))


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[0][0] if ctx is not None else None


def _stamp_ctx(attrs: Dict) -> None:
    """Fold the ambient trace scope into one record's attrs (setdefault
    semantics: explicitly-carried ids — e.g. re-emitted worker records
    — always win)."""
    ctx = _CTX.get()
    if ctx is None:
        return
    ids, parent = ctx
    attrs.setdefault("trace_id", ids[0])
    if len(ids) > 1:
        attrs.setdefault("trace_ids", list(ids))
    if parent is not None:
        attrs.setdefault("parent", parent)


class _TraceIndex:
    """Bounded in-memory per-trace record index: the stitched-span
    source for ``GET /v1/trace/<id>``. Records land here as they are
    emitted (parent-side only — buffering child tracers skip it); both
    bounds are hard caps, oldest trace evicted first."""

    def __init__(self, max_traces: int = 256,
                 max_records_per_trace: int = 4096):
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, List[Dict]]" = (
            collections.OrderedDict())
        self.max_traces = max_traces
        self.max_records = max_records_per_trace

    def add(self, rec: Dict) -> None:
        ids = []
        tid = rec.get("trace_id")
        if tid:
            ids.append(tid)
        for x in rec.get("trace_ids") or ():
            if x not in ids:
                ids.append(x)
        if not ids:
            return
        with self._lock:
            for t in ids:
                recs = self._traces.get(t)
                if recs is None:
                    recs = self._traces[t] = []
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)
                else:
                    self._traces.move_to_end(t)
                if len(recs) < self.max_records:
                    recs.append(rec)

    def get(self, trace_id: str) -> Optional[List[Dict]]:
        with self._lock:
            recs = self._traces.get(trace_id)
            if recs is None:
                return None
            recs = list(recs)
        # one coherent timeline: monotonic order (worker records were
        # offset-corrected onto the parent clock before landing here)
        return sorted(recs, key=lambda r: (
            r.get("mono") if isinstance(r.get("mono"), (int, float))
            else 0.0))

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


_TRACE_INDEX = _TraceIndex()


def trace_records(trace_id: str) -> Optional[List[Dict]]:
    """Every indexed span/event of one trace, stitched into monotonic
    order, or ``None`` for an unknown id."""
    return _TRACE_INDEX.get(trace_id)


class Span:
    """One timed phase. Context manager; ``elapsed`` is live inside the
    ``with`` block (seconds since entry) and frozen to the final
    duration after exit — callers can both drive budget loops off it
    mid-flight and read the measurement afterwards."""

    __slots__ = ("_tracer", "name", "attrs", "t_wall", "_t0", "dur",
                 "sid", "_ctx_token")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t_wall = 0.0
        self._t0 = 0.0
        self.dur: Optional[float] = None
        self.sid: Optional[str] = None
        self._ctx_token = None

    def __enter__(self) -> "Span":
        self.t_wall = time.time()
        self._t0 = time.monotonic()
        # inside a request trace scope: take a span id, link to the
        # enclosing span, and become the parent for anything nested
        ctx = _CTX.get()
        if ctx is not None:
            ids, parent = ctx
            self.sid = new_span_id()
            self.attrs.setdefault("trace_id", ids[0])
            if len(ids) > 1:
                self.attrs.setdefault("trace_ids", list(ids))
            if parent is not None:
                self.attrs.setdefault("parent", parent)
            self.attrs.setdefault("span", self.sid)
            self._ctx_token = _CTX.set((ids, self.sid))
        return self

    #: stopwatch use outside a ``with`` block (``sw = timer("x").start()``;
    #: read ``sw.elapsed``; call ``sw.stop()`` if the span should emit)
    start = __enter__

    def stop(self) -> float:
        self.__exit__(None, None, None)
        return self.dur or 0.0

    def __exit__(self, *exc) -> bool:
        self.dur = time.monotonic() - self._t0
        if self._ctx_token is not None:
            try:
                _CTX.reset(self._ctx_token)
            except ValueError:
                pass  # stopped from a different thread/context
            self._ctx_token = None
        if self._tracer is not None:
            self._tracer._emit_span(self)
        return False

    @property
    def elapsed(self) -> float:
        if self.dur is not None:
            return self.dur
        return time.monotonic() - self._t0


class _NullSpan:
    """The disabled-tracer singleton: zero state, zero clock reads.
    ``elapsed`` is 0.0 — code that needs a measurement regardless of
    tracing must use :func:`timer`, not :func:`span`."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    # mirror Span's stopwatch surface so ``span(...).start()`` /
    # ``.stop()`` stay safe when tracing is disabled
    start = __enter__

    def stop(self) -> float:
        return 0.0

    elapsed = 0.0


_NULL_SPAN = _NullSpan()


class Tracer:
    """Emits spans/events to an in-memory Chrome-trace buffer plus an
    append-only JSONL log (flushed per event, so a killed run leaves a
    readable prefix). Thread-safe; one per process is the normal case
    (the module-level :func:`configure` installs it globally)."""

    def __init__(self, chrome_path: Optional[str] = None,
                 jsonl_path: Optional[str] = None, *,
                 buffer: bool = False,
                 max_jsonl_bytes: Optional[int] = None):
        self.chrome_path = chrome_path
        self.jsonl_path = (jsonl_path if jsonl_path is not None
                           else (jsonl_path_for(chrome_path)
                                 if chrome_path else None))
        self._lock = threading.Lock()
        self._chrome: List[Dict] = []
        self._t0_mono = time.monotonic()
        self._t0_wall = time.time()
        self._pid = os.getpid()
        #: per-process token: orders/merges event streams across resumed
        #: sessions and hosts (wall clocks may disagree; sessions don't)
        self.session = f"{self._pid:x}-{int(self._t0_wall * 1000):x}"
        #: child-process mode (engine worker): records accumulate in
        #: memory and are DRAINED into the batch reply instead of
        #: touching any file — the parent re-emits them offset-corrected
        self.buffer_records: Optional[List[Dict]] = [] if buffer else None
        self.max_jsonl_bytes = (DEFAULT_MAX_JSONL_BYTES
                                if max_jsonl_bytes is None
                                else int(max_jsonl_bytes))
        self._jsonl_bytes = 0
        self._fh = None
        if self.jsonl_path and not buffer:
            d = os.path.dirname(os.path.abspath(self.jsonl_path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.jsonl_path, "a", encoding="utf-8")
            try:
                self._jsonl_bytes = self._fh.tell()
            except OSError:
                self._jsonl_bytes = 0
        self._closed = False

    # --- emission ------------------------------------------------------
    @staticmethod
    def _count_dropped() -> None:
        """One record arrived while this tracer was closed (disabled
        mid-run): never silent — docs/observability.md."""
        from . import metrics as obs_metrics

        obs_metrics.REGISTRY.counter(
            "obs_events_dropped_total",
            help="trace records dropped because the tracer was closed "
                 "or its child buffer was full").inc()

    def _rotate_locked(self) -> None:
        """Size-based set-aside of the JSONL event log: the current
        file becomes ``<path>.1`` (replacing any previous set-aside —
        the checkpoint-rotation contract) and a fresh log continues,
        opening with a ``trace_log_rotated`` record so readers can see
        the seam."""
        rotated = self._jsonl_bytes
        try:
            self._fh.close()
            os.replace(self.jsonl_path, self.jsonl_path + ".1")
        except OSError:
            pass
        self._fh = open(self.jsonl_path, "a", encoding="utf-8")
        rec = {"schema": SCHEMA, "kind": "trace_log_rotated",
               "t": round(time.time(), 6),
               "mono": round(time.monotonic(), 6),
               "session": self.session, "rotated_bytes": rotated,
               "set_aside": self.jsonl_path + ".1"}
        line = json.dumps(rec)
        self._fh.write(line + "\n")
        self._fh.flush()
        self._jsonl_bytes = len(line) + 1
        from . import metrics as obs_metrics

        obs_metrics.REGISTRY.counter(
            "obs_event_log_rotations_total",
            help="JSONL event-log size rotations (.1 set-aside)").inc()

    def _write_jsonl(self, rec: Dict) -> None:
        if self.buffer_records is not None:
            with self._lock:
                if self._closed or len(self.buffer_records) >= BUFFER_CAP:
                    dropped = True
                else:
                    self.buffer_records.append(rec)
                    dropped = False
            if dropped:
                self._count_dropped()
            return
        _TRACE_INDEX.add(rec)
        if self._fh is None:
            return
        line = json.dumps(rec, default=str)
        dropped = False
        with self._lock:
            if self._closed:
                dropped = True
            else:
                self._fh.write(line + "\n")
                self._fh.flush()
                self._jsonl_bytes += len(line) + 1
                if (self.max_jsonl_bytes
                        and self._jsonl_bytes >= self.max_jsonl_bytes):
                    self._rotate_locked()
            size = self._jsonl_bytes
        if dropped:
            self._count_dropped()
            return
        from . import metrics as obs_metrics

        obs_metrics.REGISTRY.gauge(
            "obs_event_log_bytes",
            help="current size of the JSONL event log").set(size)

    def drain_buffer(self) -> List[Dict]:
        """Take (and clear) the buffered records — the engine worker
        calls this once per batch reply, so telemetry is flushed with
        the result it describes."""
        with self._lock:
            recs = list(self.buffer_records or ())
            if self.buffer_records is not None:
                self.buffer_records.clear()
        return recs

    def _emit_span(self, sp: Span) -> None:
        tid = threading.get_ident()
        rec = {"schema": SCHEMA, "kind": "span", "name": sp.name,
               "t": round(sp.t_wall, 6), "mono": round(sp._t0, 6),
               "dur": round(sp.dur or 0.0, 6), "tid": tid,
               "session": self.session}
        for k, v in sp.attrs.items():
            rec.setdefault(k, v)
        self._write_jsonl(rec)
        ev = {"name": sp.name, "ph": "X", "pid": self._pid, "tid": tid,
              "ts": round((sp._t0 - self._t0_mono) * 1e6, 3),
              "dur": round((sp.dur or 0.0) * 1e6, 3)}
        if sp.attrs:
            ev["args"] = dict(sp.attrs)
        with self._lock:
            self._chrome.append(ev)

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def event(self, kind: str, **attrs) -> None:
        """Instant event (Chrome phase ``i``). ``attrs`` may carry its
        own ``t``/``mono`` (a re-emitted historical event keeps its
        original clock readings); missing ones are stamped now."""
        now_wall = time.time()
        now_mono = time.monotonic()
        rec = {"schema": SCHEMA, "kind": kind,
               "t": round(now_wall, 6), "mono": round(now_mono, 6),
               "session": self.session}
        rec.update(attrs)
        _stamp_ctx(rec)
        self._write_jsonl(rec)
        mono = rec.get("mono", now_mono)
        if not isinstance(mono, (int, float)):
            mono = now_mono
        ev = {"name": kind, "ph": "i", "s": "p", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": round((mono - self._t0_mono) * 1e6, 3)}
        args = {k: v for k, v in attrs.items() if k not in ("t", "mono")}
        if args:
            ev["args"] = args
        with self._lock:
            self._chrome.append(ev)

    # --- lifecycle -----------------------------------------------------
    def flush(self) -> None:
        """Write the Chrome-trace file now (idempotent; ``close`` calls
        it). The JSONL log is already flushed per event."""
        if not self.chrome_path:
            return
        with self._lock:
            events = list(self._chrome)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"schema": SCHEMA, "session": self.session,
                             "t0_wall": round(self._t0_wall, 6)}}
        tmp = f"{self.chrome_path}.{self._pid}.tmp"
        d = os.path.dirname(os.path.abspath(self.chrome_path))
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        os.replace(tmp, self.chrome_path)

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._closed = True
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# --- module-level API (the one most call sites use) --------------------

_TRACER: Optional[Tracer] = None


def configure(chrome_path: Optional[str] = None,
              jsonl_path: Optional[str] = None, *,
              buffer: bool = False,
              max_jsonl_bytes: Optional[int] = None) -> Tracer:
    """Install the process-global tracer (replacing any previous one,
    which is closed first). ``--trace t.json`` maps to
    ``configure("t.json")`` → Chrome trace at ``t.json``, JSONL event
    log at ``t.jsonl``. ``buffer=True`` is the engine-worker mode: no
    files — records accumulate for :meth:`Tracer.drain_buffer`."""
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = Tracer(chrome_path, jsonl_path, buffer=buffer,
                     max_jsonl_bytes=max_jsonl_bytes)
    _TRACE_INDEX.clear()
    return _TRACER


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def active() -> bool:
    """True when a tracer is installed — gate EXPENSIVE collection
    (device syncs, array reductions) on this, never plain span calls
    (those are already near-free when disabled)."""
    return _TRACER is not None


def span(name: str, **attrs):
    """Phase span on the global tracer; the shared no-op singleton when
    tracing is off (zero allocation, zero clock reads)."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def timer(name: str, **attrs) -> Span:
    """Always-measuring span: ``elapsed`` works with tracing off; the
    event is emitted only when tracing is on. The replacement for
    ad-hoc ``t0 = monotonic(); ...; dt = monotonic() - t0`` pairs."""
    return Span(_TRACER, name, attrs)


def event(kind: str, **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.event(kind, **attrs)


def complete(name: str, dur: float, t_wall: Optional[float] = None,
             mono: Optional[float] = None, **attrs) -> None:
    """Emit an already-measured span. For durations assembled from
    overlapping phases (the campaign pipeline's per-batch wall is
    ``device_dur + commit_stall``, which no single ``with`` block
    brackets) a caller computes the value and records it here. No-op
    when tracing is off; ``t_wall``/``mono`` default to "ended just
    now" so the span lands at the right place on the timeline."""
    t = _TRACER
    if t is None:
        return
    _stamp_ctx(attrs)
    if attrs.get("trace_id"):
        attrs.setdefault("span", new_span_id())
    sp = Span(None, name, attrs)
    sp.dur = max(0.0, float(dur))
    sp.t_wall = time.time() - sp.dur if t_wall is None else t_wall
    sp._t0 = time.monotonic() - sp.dur if mono is None else mono
    t._emit_span(sp)


#: record keys that are TRANSPORT metadata, not span/event attributes —
#: stripped before re-emission (the parent tracer re-stamps its own)
_META_KEYS = frozenset(("schema", "kind", "name", "t", "mono", "dur",
                        "tid", "session"))


def reemit_records(records: Sequence[Dict], mono_offset: float = 0.0,
                   **extra) -> int:
    """Re-emit telemetry drained from a child process (engine worker)
    onto the parent's global tracer, correcting each record's ``mono``
    by ``mono_offset`` (``parent_mono - child_mono``, from the spawn
    handshake) so both processes share one coherent timeline. ``extra``
    attrs (``proc="worker"``, ``wpid=...``) tag the records' origin;
    the child's own ``session`` is preserved as ``src_session``.
    Returns the number of records re-emitted."""
    t = _TRACER
    if t is None or not records:
        return 0
    n = 0
    for rec in records:
        if not isinstance(rec, dict) or "kind" not in rec:
            continue
        attrs = {k: v for k, v in rec.items() if k not in _META_KEYS}
        attrs.update(extra)
        if rec.get("session"):
            attrs.setdefault("src_session", rec["session"])
        mono = rec.get("mono")
        if isinstance(mono, (int, float)):
            mono = round(float(mono) + mono_offset, 6)
        else:
            mono = time.monotonic()
        if rec.get("kind") == "span":
            complete(str(rec.get("name", "?")),
                     float(rec.get("dur") or 0.0),
                     t_wall=rec.get("t"), mono=mono, **attrs)
        else:
            event(str(rec["kind"]), t=rec.get("t", round(time.time(), 6)),
                  mono=mono, **attrs)
        n += 1
    return n


def close() -> None:
    """Close and uninstall the global tracer (writes the Chrome file)."""
    global _TRACER
    if _TRACER is not None:
        _TRACER.close()
        _TRACER = None


__all__ = ["SCHEMA", "Span", "Tracer", "active", "apply_context",
           "close", "complete", "configure", "context_snapshot",
           "current_trace_id", "event", "get_tracer", "jsonl_path_for",
           "new_span_id", "new_trace_id", "reemit_records", "span",
           "timer", "trace_context", "trace_records"]
