"""Durable frontier / run checkpoints (crash-consistent resume).

PyTorch counterpart of the JAX package's ``utils/checkpoint.py``, with
the same on-disk format: a frontier checkpoint is one ``npz`` of named
leaves (``leaf<i>::base/pc``, ``leaf<i>::tape_op``, ... in the JAX
dtypes: u32 limbs as ``uint32``) plus a JSON meta blob (tx index, steps
done), so a ``frontier.npz`` written by the JAX package's
``save_frontier`` loads here and resumes on the card, and the other way
round. A campaign checkpoint is a checksummed JSON state (batch cursor,
issues, resilience fields) in the JAX package's format too;
:class:`BackgroundCheckpointWriter` writes it off the pipelined
campaign's commit path.

Every writer goes tmp-file -> flush -> fsync -> atomic rename, rotates
the previous good file to ``<path>.1`` first, and embeds a schema
version plus per-leaf and whole-file sha256 digests. Loaders verify
integrity before trusting a byte and raise :class:`CheckpointCorrupt`
for a torn file (fall back to the rotated copy) and ``ValueError`` for a
healthy file of another shape configuration (the wrong run). v1 files
(no digests) still load.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

log = logging.getLogger(__name__)

#: current on-disk schema of the npz frontier checkpoint and the JSON
#: campaign checkpoint (the JAX package's). v1 = the unversioned
#: formats, which still load.
CHECKPOINT_SCHEMA = 2

#: rotated last-known-good suffix: ``save`` moves the previous file to
#: ``<path>.1`` before renaming the new one into place
ROTATE_SUFFIX = ".1"

# whole-file integrity trailer appended AFTER the npz payload: zip
# readers locate the archive from its end, so the trailer must be
# stripped before np.load — which is exactly what lets a loader verify
# the digest before handing bytes to the zip machinery. (Trailing junk
# breaks np.load, so a v1 reader would loudly reject a v2 file instead
# of silently misreading it.)
_TRAILER_MAGIC = b"MYTHCKPT2:"
_TRAILER_LEN = len(_TRAILER_MAGIC) + 64  # magic + sha256 hexdigest


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file is torn, truncated, or fails its checksums —
    the caller should fall back to the rotated last-known-good copy.
    Deliberately NOT a ``ValueError``: a shape/config mismatch (healthy
    file, wrong run) keeps raising ``ValueError`` so resume logic can
    tell the two apart."""


def _quarantine_corrupt(path: str) -> None:
    """Move a verified-corrupt newest file to ``<path>.corrupt``
    (best-effort, evidence preserved): if it stayed in place, the next
    save's rotation would shove the garbage over the last-known-good
    ``<path>.1`` — destroying the only fallback."""
    try:
        os.replace(path, path + ".corrupt")
    except OSError:
        pass


def _named_leaves(sf) -> list:
    """``[(dotted name, numpy leaf)]`` of a frontier in field order, named
    as the JAX pytree path (``base/pc``); None fields are skipped, as a
    JAX pytree drops them."""
    import dataclasses

    out = []

    def walk(st, prefix):
        for fl in dataclasses.fields(st):
            v = getattr(st, fl.name)
            if v is None:
                continue
            if dataclasses.is_dataclass(v):
                walk(v, prefix + fl.name + "/")
            else:
                out.append((prefix + fl.name, np.asarray(v)))

    walk(sf.to_numpy() if hasattr(sf, "to_numpy") else sf, "")
    return out


def _leaf_sha256(arr: np.ndarray) -> str:
    """Content digest of one leaf: dtype + shape + raw bytes, so a
    bit-identical buffer reinterpreted under another dtype still fails."""
    h = hashlib.sha256()
    h.update(str(arr.dtype.str).encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def fsync_dir(path: str) -> None:
    """Flush the directory entry so the rename itself survives a power
    cut (best-effort: not every filesystem supports dir fds). Shared
    with the fleet ledger's link-exclusive writes (the fleet ledger)."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write(path: str, data: bytes, rotate: bool = True) -> None:
    """THE atomic-write discipline every durable artifact in this repo
    shares (checkpoints here, unit results and manifests in
    the fleet ledger): tmp file + flush + fsync +
    rotate-previous + atomic rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    if rotate and os.path.exists(path):
        # the previous (verified-at-write-time) file becomes the
        # last-known-good fallback; a crash between the two renames
        # leaves only <path>.1, which loaders try next
        os.replace(path, path + ROTATE_SUFFIX)
    os.replace(tmp, path)
    fsync_dir(path)


def exclusive_write(path: str, data: bytes) -> bool:
    """Atomically create ``path`` with ``data`` IFF it does not already
    exist: tmp file + fsync + ``os.link`` (which fails with EEXIST
    instead of overwriting, unlike rename). Returns whether this caller
    won — the first-wins primitive behind fleet unit commits
    (the fleet ledger), create-once manifests, and the solver
    verdict store (smt/vstore.py). The tmp name carries pid
    AND thread id so in-process fleets (threaded workers) never
    collide."""
    import threading

    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    try:
        os.link(tmp, path)
        won = True
    except FileExistsError:
        won = False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    if won:
        fsync_dir(path)
    return won


# --- frontier (npz) checkpoints ---------------------------------------


def save_frontier(path: str, sf, meta: Dict | None = None,
                  rotate: bool = True) -> None:
    """Serialize a SymFrontier (torch or numpy leaves) + meta to a
    versioned, checksummed npz, written durably (tmp + fsync + atomic
    rename) with the previous file rotated to ``<path>.1``."""
    with obs_trace.timer("checkpoint_save", what="frontier",
                         file=os.path.basename(path)) as sp:
        arrays = {}
        leaf_sha: Dict[str, str] = {}
        for i, (name, arr) in enumerate(_named_leaves(sf)):
            arrays[f"leaf{i}::{name}"] = arr
            leaf_sha[name] = _leaf_sha256(arr)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8)
        arrays["__schema__"] = np.frombuffer(
            json.dumps({"version": CHECKPOINT_SCHEMA,
                        "leaf_sha256": leaf_sha}).encode(), dtype=np.uint8)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        body = buf.getvalue()
        digest = hashlib.sha256(body).hexdigest().encode()
        durable_write(path, body + _TRAILER_MAGIC + digest, rotate=rotate)
    obs_metrics.REGISTRY.histogram(
        "checkpoint_write_seconds",
        help="durable checkpoint save latency").observe(sp.elapsed)


def _read_npz_body(path: str) -> Tuple[bytes, bool]:
    """``(raw npz bytes, had_trailer)`` with the whole-file digest
    verified and stripped. A v1 file (no trailer) returns as-is — it
    never carried a digest; the caller cross-checks ``had_trailer``
    against the schema version INSIDE the archive, so a tear that chops
    only the trailer off a v2 file (zip readers tolerate trailing junk)
    is still detected."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if len(raw) >= _TRAILER_LEN and \
            raw[-_TRAILER_LEN:-64] == _TRAILER_MAGIC:
        body, digest = raw[:-_TRAILER_LEN], raw[-64:]
        got = hashlib.sha256(body).hexdigest().encode()
        if got != digest:
            raise CheckpointCorrupt(
                f"{path}: whole-file sha256 mismatch (torn write?)")
        return body, True
    return raw, False  # v1: unversioned, no trailer


def load_frontier(path: str, template) -> Tuple[Any, Dict]:
    """Rebuild a frontier from ``path`` using ``template`` (a SymFrontier
    of the run's shape, on the device the result should live on) for the
    structure, verifying integrity first.

    The template must have the same shape configuration (lanes + limits)
    the checkpoint was written with. Leaves match by NAME (not index),
    so field reordering between versions cannot silently transpose
    arrays. Raises:

    - :class:`CheckpointCorrupt` — torn/truncated file, checksum
      mismatch, unreadable npz, missing/renamed leaf, dtype mismatch,
      or a schema newer than this reader;
    - ``ValueError`` — healthy file whose leaf SHAPES disagree with the
      template (a different lanes/limits config, not corruption).
    """
    with obs_trace.timer("checkpoint_load", what="frontier",
                         file=os.path.basename(path)) as sp:
        out = _load_frontier_inner(path, template)
    obs_metrics.REGISTRY.histogram(
        "checkpoint_load_seconds",
        help="checkpoint load+verify latency").observe(sp.elapsed)
    return out


def _load_frontier_inner(path: str, template) -> Tuple[Any, Dict]:
    body, had_trailer = _read_npz_body(path)
    try:
        # eager member reads: zip CRC errors surface lazily at access
        # time, and a v1 file has no whole-file digest to catch a torn
        # member earlier — every read must land inside this typed guard
        data = np.load(io.BytesIO(body))
        arrays = {k: data[k] for k in data.files}
    except Exception as e:  # noqa: BLE001 — zip/format errors vary
        raise CheckpointCorrupt(f"{path}: unreadable npz ({e})") from e
    try:
        meta = (json.loads(bytes(arrays["__meta__"]).decode())
                if "__meta__" in arrays else {})
        schema = (json.loads(bytes(arrays["__schema__"]).decode())
                  if "__schema__" in arrays else {"version": 1})
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: undecodable meta blob ({e})") from e
    version = int(schema.get("version", 1))
    if version > CHECKPOINT_SCHEMA:
        raise CheckpointCorrupt(
            f"{path}: schema v{version} is newer than this reader "
            f"(supports <= v{CHECKPOINT_SCHEMA})")
    if version >= 2 and not had_trailer:
        # the archive says v2 but the trailer is gone: a tear that
        # chopped only the trailing digest — the zip machinery tolerates
        # trailing junk, so this is the one tear shape the digest itself
        # cannot catch
        raise CheckpointCorrupt(
            f"{path}: v{version} checkpoint missing its integrity "
            "trailer (torn write?)")
    leaf_sha = schema.get("leaf_sha256", {})

    by_name: Dict[str, np.ndarray] = {}
    for key, arr in arrays.items():
        if key.startswith("__"):
            continue
        try:
            _, name = key.split("::", 1)
        except ValueError:
            raise CheckpointCorrupt(
                f"{path}: malformed leaf key {key!r}") from None
        by_name[name] = arr

    leaves = {}
    for name, tmpl_arr in _named_leaves(template):
        if name not in by_name:
            if name.endswith("op_resid"):
                # v1 frontiers predate the iprof residual sidecar; it
                # starts empty on resume
                leaves[name] = tmpl_arr
                continue
            raise CheckpointCorrupt(
                f"{path}: checkpoint missing leaf {name!r}")
        arr = by_name[name]
        want = leaf_sha.get(name)
        if want is not None and _leaf_sha256(arr) != want:
            raise CheckpointCorrupt(
                f"{path}: leaf {name!r} fails its sha256")
        if tuple(arr.shape) != tuple(tmpl_arr.shape):
            raise ValueError(
                f"shape mismatch for {name}: {arr.shape} vs "
                f"{tmpl_arr.shape}")
        if arr.dtype != tmpl_arr.dtype:
            raise CheckpointCorrupt(
                f"{path}: dtype mismatch for {name}: {arr.dtype} vs "
                f"{tmpl_arr.dtype}")
        leaves[name] = arr
    return _rebuild(template, leaves), meta


def _rebuild(template, leaves: Dict[str, np.ndarray], prefix: str = ""):
    """``template``'s TensorStruct type filled from ``leaves`` by name, on
    the template's device; fields absent from the template stay None."""
    import dataclasses

    src = {}
    for fl in dataclasses.fields(template):
        v = getattr(template, fl.name)
        if v is not None and dataclasses.is_dataclass(v):
            src[fl.name] = _rebuild(v, leaves, prefix + fl.name + "/")
        else:
            src[fl.name] = leaves.get(prefix + fl.name) if v is not None else None
    if prefix:
        return src
    return type(template).from_numpy(src, template.base.pc.device)


def load_frontier_resilient(path: str, template) -> Tuple[Any, Dict, str]:
    """``load_frontier`` with fallback to the rotated last-known-good
    copy: returns ``(tree, meta, source_path)``. A corrupt (or missing)
    newest file degrades to ``<path>.1``; only when both are unusable
    does the newest file's error propagate."""
    first_err: Optional[BaseException] = None
    for p in (path, path + ROTATE_SUFFIX):
        try:
            tree, meta = load_frontier(p, template)
            if p != path:
                log.warning("checkpoint %s unusable (%s); resumed from "
                            "rotated copy %s", path, first_err, p)
            return tree, meta, p
        except FileNotFoundError as e:
            if first_err is None:
                first_err = e
        except CheckpointCorrupt as e:
            if first_err is None:
                first_err = e
            if p == path:
                _quarantine_corrupt(p)
    raise first_err  # type: ignore[misc]


# --- campaign (JSON) checkpoints --------------------------------------


def save_json_checkpoint(path: str, state: Dict, rotate: bool = True) -> None:
    """Durable, checksummed JSON state: the payload is wrapped as
    ``{"__schema__": 2, "sha256": <hex of canonical state>, "state":
    ...}`` and written tmp + fsync + rotate + atomic rename."""
    with obs_trace.timer("checkpoint_save", what="campaign",
                         file=os.path.basename(path)) as sp:
        payload = json.dumps(state, sort_keys=True)
        doc = {"__schema__": CHECKPOINT_SCHEMA,
               "sha256": hashlib.sha256(payload.encode()).hexdigest(),
               "state": state}
        durable_write(path, json.dumps(doc).encode(), rotate=rotate)
    obs_metrics.REGISTRY.histogram(
        "checkpoint_write_seconds",
        help="durable checkpoint save latency").observe(sp.elapsed)


def load_json_checkpoint(path: str) -> Dict:
    """Verified state dict from ``path``. A v1 file (bare state dict, no
    ``__schema__`` wrapper) loads as-is. Raises
    :class:`CheckpointCorrupt` on torn JSON / checksum mismatch /
    unsupported schema, ``FileNotFoundError`` when absent."""
    with obs_trace.span("checkpoint_load", what="campaign",
                        file=os.path.basename(path)):
        return _load_json_checkpoint_inner(path)


def _load_json_checkpoint_inner(path: str) -> Dict:
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        doc = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable JSON ({e})") from e
    if not isinstance(doc, dict):
        raise CheckpointCorrupt(f"{path}: expected a JSON object")
    if "__schema__" not in doc:
        return doc  # v1: the file IS the state
    version = int(doc["__schema__"])
    if version > CHECKPOINT_SCHEMA:
        raise CheckpointCorrupt(
            f"{path}: schema v{version} is newer than this reader")
    state = doc.get("state")
    if not isinstance(state, dict):
        raise CheckpointCorrupt(f"{path}: missing state payload")
    want = doc.get("sha256")
    got = hashlib.sha256(
        json.dumps(state, sort_keys=True).encode()).hexdigest()
    if want != got:
        raise CheckpointCorrupt(f"{path}: state sha256 mismatch")
    return state


class BackgroundCheckpointWriter:
    """Serialize + durably write campaign JSON checkpoints off the
    critical path (the pipelined campaign's host phase must not stall
    on fsync).

    One worker thread; submissions COALESCE (latest state wins). That is
    safe because every submitted state is a complete, self-contained
    snapshot: skipping an intermediate one only widens the replay window
    after a crash, it never breaks consistency. Each write goes through
    :func:`save_json_checkpoint` — the identical v2
    tmp+fsync+rotate+atomic-rename contract as the synchronous path, so
    a kill at ANY instant (including mid-background-write) still leaves
    either the previous durable file or its rotated ``.1`` loadable.

    A write failure is remembered and re-raised at the next ``submit``
    or ``flush``/``close`` — a campaign must not silently run on without
    durability. The thread is a daemon: an abrupt interpreter death
    behaves exactly like kill -9 mid-write, which the loaders' checksum
    + rotation fallback already covers.
    """

    def __init__(self, path: str):
        self.path = path
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[Dict, Optional[Any]]] = None
        self._writing = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ckpt-writer:{os.path.basename(path)}")
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None:
                    return  # stopped with nothing left to write
                state, on_durable = self._pending
                self._pending = None
                self._writing = True
            try:
                save_json_checkpoint(self.path, state)
                if on_durable is not None:
                    on_durable()
            except Exception as e:  # noqa: BLE001 — surfaced at submit
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()

    def _raise_pending_error_locked(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def submit(self, state: Dict,
               on_durable: Optional[Any] = None) -> None:
        """Queue ``state`` for a durable write (replacing any not-yet-
        started queued state). ``on_durable`` (zero-arg callable) runs in
        the writer thread after the rename lands. The caller must not
        mutate ``state`` afterwards — pass a snapshot."""
        with self._cond:
            self._raise_pending_error_locked()
            if self._stop:
                raise RuntimeError(f"checkpoint writer for {self.path} "
                                   "is closed")
            self._pending = (state, on_durable)
            self._cond.notify_all()

    def flush(self) -> None:
        """Block until everything submitted so far is durably on disk."""
        with self._cond:
            while self._pending is not None or self._writing:
                self._cond.wait()
            self._raise_pending_error_locked()

    def close(self, discard_pending: bool = False) -> None:
        """Stop the writer. By default the queued state (if any) is
        written first; ``discard_pending`` drops it — the simulated-kill
        path, where flushing would grant durability a real SIGKILL never
        would. An in-flight write always completes (it cannot be
        interrupted, same as a real kill racing the rename)."""
        with self._cond:
            if discard_pending:
                self._pending = None
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60.0)
        if not discard_pending:
            with self._cond:
                self._raise_pending_error_locked()


def load_json_checkpoint_resilient(
        path: str) -> Tuple[Optional[Dict], Optional[str]]:
    """``(state, source_path)`` trying ``path`` then ``<path>.1``.
    ``(None, None)`` when no checkpoint exists at all (fresh start).
    Raises :class:`CheckpointCorrupt` only when a newest-file corruption
    has NO healthy rotated copy to fall back to AND a rotated file
    exists but is itself corrupt — a torn first-ever checkpoint (no
    rotation yet) degrades to a fresh start, because nothing older was
    ever persisted."""
    try:
        return load_json_checkpoint(path), path
    except FileNotFoundError:
        return None, None
    except CheckpointCorrupt as newest_err:
        _quarantine_corrupt(path)
        try:
            state = load_json_checkpoint(path + ROTATE_SUFFIX)
        except FileNotFoundError:
            # first checkpoint torn before any rotation: at most one
            # batch of work existed, and none of it was durably recorded
            log.warning("checkpoint %s corrupt (%s) with no rotated "
                        "copy; starting fresh", path, newest_err)
            return None, None
        except CheckpointCorrupt as e:
            raise CheckpointCorrupt(
                f"{path} and its rotated copy are both corrupt "
                f"({newest_err}; {e})") from e
        log.warning("checkpoint %s corrupt (%s); resumed from rotated "
                    "copy", path, newest_err)
        return state, path + ROTATE_SUFFIX


__all__ = [
    "BackgroundCheckpointWriter", "CHECKPOINT_SCHEMA", "CheckpointCorrupt",
    "ROTATE_SUFFIX", "durable_write", "exclusive_write", "fsync_dir",
    "load_frontier", "load_frontier_resilient", "load_json_checkpoint",
    "load_json_checkpoint_resilient", "save_frontier", "save_json_checkpoint",
]
