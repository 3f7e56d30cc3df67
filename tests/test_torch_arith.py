"""The u256 product family (kernels K8 and K9 on the card) and the arith
fixture end to end, on the CPU against the JAX package.

- ``mul``, ``mul_wide``, ``mulmod``, ``addmod`` and
  ``exp`` of the port's plain versions against ``mythril_tpu.ops.u256``
  and Python ints on edge and seeded random words, exactly;
- ``python -m mythril_tpu_torch analyze -f arith.bin-runtime --strategy S
  -o json --device cpu`` at the test profile for each of the six
  strategies, and with ``--enable-iprof``, against the JAX CLI's reports
  and profile pinned in ``tests/fixtures/torch_port/arith_*_test.*``.

The work runs in child processes (``torch_port_policies``)."""

import json
import os
import re

import numpy as np
import pytest

import torch_port_child
import torch_port_policies as tp
from torch_port_fixtures import FIXTURE_DIR, STRATEGIES

M = (1 << 256) - 1
OPS = ("mul", "mul_wide", "mulmod", "addmod", "exp")
COVERAGE_KEYS = ("lanes", "surviving_paths", "dropped_forks", "killed_infeasible",
                 "lanes_errored", "instruction_coverage_pct", "lanes_lost_to_caps")


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return tp.runs(tmp_path_factory)


def _ints(words):
    w = np.asarray(words, dtype=np.uint64)
    return [sum(int(row[i]) << (32 * i) for i in range(w.shape[-1])) for row in w]


def _python(op, a, b, m, e):
    if op == "mul":
        return [(x * y) & M for x, y in zip(a, b)]
    if op == "mul_wide":
        return [x * y for x, y in zip(a, b)]
    if op == "mulmod":
        return [(x * y) % z if z else 0 for x, y, z in zip(a, b, m)]
    if op == "addmod":
        return [(x + y) % z if z else 0 for x, y, z in zip(a, b, m)]
    return [pow(x, y, 1 << 256) for x, y in zip(a, e)]


@pytest.mark.parametrize("op", OPS)
def test_u256_product_family_matches_jax(res, op):
    want, got = res["jax"]["u256"][op], res["engine"]["u256"][op]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    a, b, m, e = (_ints(x) for x in tp.u256_inputs())
    py = _python(op, a, b, m, e)
    assert _ints(got) == py


def _issues(doc):
    return sorted((d["contract"], d["swc-id"], d["address"], d["title"], d["severity"])
                  for d in doc["issues"])


def _pinned(name):
    with open(os.path.join(FIXTURE_DIR, name)) as fh:
        return fh.read()


def _cli_runs(res):
    return {**res["cli_a"]["strategies"], **res["cli_b"]["strategies"]}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_arith_strategy_report_matches_jax(res, strategy):
    rc, out, err = _cli_runs(res)[strategy]
    assert rc == 0, err[-2000:]
    got, want = json.loads(out), json.loads(_pinned(f"arith_{strategy}_test.json"))
    assert _issues(got) == _issues(want)
    for k in COVERAGE_KEYS:
        assert got["coverage"][k] == want["coverage"][k], k


def test_arith_strategies_admit_different_survivors(res):
    dropped = {s: json.loads(out)["coverage"]["dropped_forks"]
               for s, (_, out, _) in _cli_runs(res).items()}
    assert len(set(dropped.values())) > 1, dropped


def test_arith_fixture_runs_the_product_opcodes(res):
    rc, _, err = res["cli_a"]["iprof"]
    assert rc == 0
    counts = dict(re.findall(r"^(MUL|EXP|MULMOD|ADDMOD)\s+(\d+)", err, re.M))
    assert set(counts) == {"MUL", "EXP", "MULMOD", "ADDMOD"}
    assert all(int(n) > 0 for n in counts.values())


def test_iprof_table_and_report_match_jax(res):
    rc, out, err = res["cli_a"]["iprof"]
    assert rc == 0
    table = err[err.index("Instruction profile"):]
    assert table.strip() == _pinned("arith_iprof_test.txt").strip()
    assert _issues(json.loads(out)) == _issues(json.loads(_pinned("arith_bfs_test.json")))


def _fields_read(path):
    with open(path) as fh:
        src = fh.read()
    return sorted(set(re.findall(r"\bsf\.(?:base\.)?\w+", src)))


def test_integer_module_copy_reads_the_same_fields():
    """The SWC-101 module reads the same frontier fields in both
    packages."""
    rel = os.path.join("analysis", "module", "modules", "integer.py")
    jax_fields = _fields_read(os.path.join(torch_port_child.ROOT, "mythril_tpu", rel))
    port_fields = _fields_read(os.path.join(torch_port_child.ROOT, "mythril_tpu_torch", rel))
    assert jax_fields and port_fields == jax_fields
