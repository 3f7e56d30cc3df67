"""Durable-write helpers (the subset of the JAX package's
``utils/checkpoint.py`` that the solver verdict store needs).

The frontier checkpoint half of that module is not part of this package:
``--checkpoint-dir`` is not supported by the PyTorch engine yet.
"""

from __future__ import annotations

import os


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
