"""Durable frontier / run checkpoints (crash-consistent resume).

PyTorch counterpart of the JAX package's ``utils/checkpoint.py``, with
the same on-disk format: a frontier checkpoint is one ``npz`` of named
leaves (``leaf<i>::base/pc``, ``leaf<i>::tape_op``, ... in the JAX
dtypes: u32 limbs as ``uint32``) plus a JSON meta blob (tx index, steps
done), so a ``frontier.npz`` written by the JAX package's
``save_frontier`` loads here and resumes on the card, and the other way
round.

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
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

log = logging.getLogger(__name__)

#: current on-disk schema of the npz frontier checkpoint (the JAX
#: package's). v1 = the unversioned format, which still loads.
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


__all__ = [
    "CHECKPOINT_SCHEMA", "CheckpointCorrupt", "ROTATE_SUFFIX", "durable_write",
    "exclusive_write", "fsync_dir", "load_frontier", "load_frontier_resilient",
    "save_frontier",
]
