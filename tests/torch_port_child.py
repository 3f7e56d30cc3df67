"""Run a function of a ``test_torch_*`` module in a fresh Python process.

The PyTorch port's tests do their work — PyTorch and the JAX reference
alike — in child processes and only compare the pickled results in the
test worker. The long-lived xdist workers then load no PyTorch and
compile no extra XLA program: each XLA:CPU compile draws down a
per-process budget (docs/xla-cpu-segfault.md), and an in-process version
of these tests made workers crash in other files' compiles.
"""

import fcntl
import os
import pickle
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def start(module: str, func: str, path) -> subprocess.Popen:
    """Start ``module.func(path)`` in a child; it pickles its result to path."""
    code = (f"import sys; sys.path[:0] = [{HERE!r}, {ROOT!r}]; "
            f"import {module} as m; m.{func}({str(path)!r})")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen, path, timeout: float = 900):
    """Wait for a child of :func:`start` and load what it pickled."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


_DONE = {}


def once(key: str, compute, tmp_path_factory):
    """``compute()`` once per test session, for every module that asks
    with the same key. Under pytest-xdist the tests may be spread over
    several workers, each of which would run the children again; instead
    the workers share the result through a file beside their temp dirs:
    the first to take the lock computes, the others wait and load it."""
    if key not in _DONE:
        _DONE[key] = _once(key, compute, tmp_path_factory)
    return _DONE[key]


def _once(key: str, compute, tmp_path_factory):
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return compute()
    d = tmp_path_factory.getbasetemp().parent / f"torch-port-{uid}"
    d.mkdir(exist_ok=True)
    out = d / f"{key}.pkl"
    with open(d / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            res = compute()
            dump(res, d / f"{key}.tmp")
            os.replace(d / f"{key}.tmp", out)
            return res
    with open(out, "rb") as fh:
        return pickle.load(fh)


def run(module: str, func: str, tmp_path_factory, timeout: float = 900):
    def compute():
        path = tmp_path_factory.mktemp(func.strip("_")) / "out.pkl"
        return finish(start(module, func, path), path, timeout)

    return once(f"{module}.{func}", compute, tmp_path_factory)


def run_pair(module: str, jax_func: str, torch_func: str, tmp_path_factory):
    """The module's JAX and PyTorch children side by side -> (jax, torch)."""
    def compute():
        d = tmp_path_factory.mktemp(module)
        jax = start(module, jax_func, d / "jax.pkl")
        port = start(module, torch_func, d / "torch.pkl")
        want = finish(jax, d / "jax.pkl")
        return want, finish(port, d / "torch.pkl")

    return once(f"{module}.pair", compute, tmp_path_factory)


def dump(obj, path) -> None:
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def torch_single_thread():
    """Import torch for a child with one intra-op thread: the tensors are
    small, and the children share the cores with the test workers."""
    import torch

    torch.set_num_threads(1)
    return torch
