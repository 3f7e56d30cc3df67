"""Durable cross-campaign verdict store, keyed on the canonical
constraint hash (``smt/canon.py``).

PR 6's serve store caches per-CONTRACT verdicts; this is the per-QUERY
half ROADMAP calls the missing piece of the verdict-store direction: a
shared directory (the fleet ledger dir, a serve daemon's data dir — any
NFS/GCS mount the fleet machinery already uses) where every decided
SAT/UNSAT query lands as one JSON file, so fleet workers, resident
daemons, and repeat campaigns share solver work across processes and
restarts. On a clone-heavy corpus most queries are alpha-renamed
repeats; once one worker has paid the witness search, every other
worker's identical query is a file read.

Contracts kept deliberately identical to the rest of the repo's
durability story:

- every write goes through the repo-wide exclusive-write discipline
  (``utils/checkpoint.exclusive_write``: tmp + fsync + link-exclusive
  create) — FIRST WINS, concurrent writers of the same key cannot tear
  a file or flip an already-served verdict, and a losing writer simply
  drops its copy (the verdicts are equal by construction);
- corrupt or newer-schema files are counted MISSES, never errors, and
  the corrupt file is unlinked so re-analysis can rewrite it (a
  first-wins create would otherwise preserve the corruption forever);
- ``unknown``/timeout verdicts are NEVER stored — unknown is a property
  of a search budget, not of the query, and a persisted unknown would
  poison the key for every future (possibly bigger-budget) campaign.
  Only ``sat`` (with its canonical-coordinate witness, re-verified at
  serve time) and ``unsat`` are durable facts.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from ..obs import metrics as obs_metrics
from ..utils.checkpoint import exclusive_write

#: verdict-file schema (readers reject newer-than-known)
VSTORE_SCHEMA = 1

#: in-RAM read-through cache entries (per store instance): repeat hits
#: on one canonical key skip the file read
_RAM_CAP = 4096


class VerdictStore:
    """One directory of per-query verdict files: ``<dir>/q<hash>.json``.

    Many writers, many readers, across processes and hosts; file-level
    atomicity (exclusive create) is the whole concurrency story — no
    lock file, no index to corrupt."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._ram: "OrderedDict[str, Dict]" = OrderedDict()
        self._lock = threading.Lock()

    def _file(self, digest: str) -> str:
        return os.path.join(self.path, f"q{digest}.json")

    def get(self, digest: str) -> Optional[Dict]:
        """The stored verdict doc ({"verdict", "witness", ...}) or None
        on miss. Corruption (unparseable, wrong key, unknown schema,
        bogus verdict) is a counted miss and the file is removed so the
        next decided query can re-write it."""
        with self._lock:
            doc = self._ram.get(digest)
            if doc is not None:
                self._ram.move_to_end(digest)
                return doc
        p = self._file(digest)
        try:
            with open(p) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            doc = None
        if (not isinstance(doc, dict)
                or int(doc.get("schema", 0) or 0) > VSTORE_SCHEMA
                or doc.get("key") != digest
                or doc.get("verdict") not in ("sat", "unsat")):
            obs_metrics.REGISTRY.counter(
                "solver_vstore_corrupt_total",
                help="unreadable verdict-store files treated as "
                     "misses (and unlinked)").inc()
            try:
                os.unlink(p)
            except OSError:
                pass
            return None
        with self._lock:
            self._ram[digest] = doc
            while len(self._ram) > _RAM_CAP:
                self._ram.popitem(last=False)
        return doc

    def put(self, digest: str, verdict: str,
            witness: Optional[Dict] = None) -> bool:
        """Durably persist one decided verdict (first-wins). Refuses
        ``unknown`` by contract. Returns whether this caller's file is
        the one on disk."""
        if verdict not in ("sat", "unsat"):
            raise ValueError(
                f"verdict store only persists sat/unsat, not {verdict!r}")
        doc = {"schema": VSTORE_SCHEMA, "key": digest, "verdict": verdict,
               "witness": witness, "t": round(time.time(), 3)}
        won = exclusive_write(self._file(digest),
                              json.dumps(doc, sort_keys=True).encode())
        reg = obs_metrics.REGISTRY
        if won:
            reg.counter(
                "solver_vstore_writes_total",
                help="verdicts persisted to the shared solver "
                     "store").inc()
            with self._lock:
                self._ram[digest] = doc
                while len(self._ram) > _RAM_CAP:
                    self._ram.popitem(last=False)
        else:
            reg.counter(
                "solver_vstore_write_races_total",
                help="verdict writes dropped because another worker "
                     "committed the key first").inc()
        return won

    def count(self) -> int:
        """Number of stored verdicts (diagnostics; O(dir))."""
        try:
            return sum(1 for f in os.listdir(self.path)
                       if f.startswith("q") and f.endswith(".json"))
        except OSError:
            return 0


__all__ = ["VSTORE_SCHEMA", "VerdictStore"]
