"""Native (C) runtime components, built on first use with the system
compiler and loaded via ctypes — no pip/pybind11 in this environment.

Currently: ``tape_eval`` — the 256-bit tape evaluator the witness
search's repair loop runs hundreds of times per solver query (the
reference's analogous hot loop lives inside Z3's C++ core,
``laser/smt/solver`` ⚠unv SURVEY.md §2.2). Everything degrades to the
pure-Python evaluator when the compiler or the load fails
(``MYTHRIL_NO_NATIVE=1`` forces that path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_lib = None
_tried = False


def _build_and_load():
    src = os.path.join(_HERE, "tape_eval.c")
    so = os.path.join(_HERE, "_tape_eval.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        tmp = so + ".tmp.%d" % os.getpid()
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
                break
            except (OSError, subprocess.SubprocessError):
                continue
        else:
            raise RuntimeError("no working C compiler for tape_eval")
    lib = ctypes.CDLL(so)
    lib.tape_eval.restype = ctypes.c_int
    lib.tape_eval.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,                      # imm: read-only bytes
        ctypes.POINTER(ctypes.c_uint8),       # vals: mutable in/out
    ]
    return lib


def tape_eval_lib():
    """The loaded native library, or None (build failure / opt-out)."""
    global _lib, _tried
    if _tried:
        return _lib
    with _LOCK:
        if _tried:
            return _lib
        if os.environ.get("MYTHRIL_NO_NATIVE") == "1":
            _lib, _tried = None, True
            return None
        try:
            _lib = _build_and_load()
        except Exception:
            _lib = None
        _tried = True
    return _lib
