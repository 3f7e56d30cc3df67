"""Kernels K6 (the feasibility sweep, a warp per lane in dependency
rounds), K3 (the tape append, single rows and groups), K5 (MODEXP, a
quarter-warp per lane) and K7 (the in-place fork expansion) before the
card: their bodies (``kernels/csrc/propagate.cuh``, ``tape_append.cuh``,
``modexp.cuh``, ``fork_expand.cuh``) are compiled as host C++ with ``g++``
and a shim that runs each warp as 32 threads meeting at every vote,
shuffle and barrier (``torch_port_warphost``), driven through the
wrappers' own marshaling (``kernels.sweep_call``, ``kernels.TapeAppend``,
``kernels.modexp_call``, ``kernels.ForkExpand``) and held exactly to the
plain versions:

- K6 to ``propagate_feasibility_plain`` on seeded random tapes of
  ``chip_smoke.random_tapes`` at P = 16, T = 128 (self and forward
  references, clipped ids, NULL rows, FREE kinds, lanes with no new
  nodes), a quarter of the lanes rewired into dependency chains inside a
  window, a few windows' worth of new nodes a lane;
- K3's single-row entry point to ``append_node_plain`` over consecutive
  appends through one descriptor, which marshals the tape once and
  follows a replaced tape without keeping the old one alive, and its
  group entry point to ``append_group_plain`` (R
  sequential plain appends) on every case of ``chip_smoke.group_cases``:
  the SHA3 chain masked off mid-chain, the binary op's CONST, CONST and
  node, rows repeating earlier rows of their group, a forged fingerprint
  collision, random sources, masked-off lanes and overflows mid-group,
  at P = 32 and the default tape length (T = 512: scans of several
  steps);
- K5 to ``modexp_plain`` and Python's ``pow`` on edge cases (m = 0, 1,
  even, a power of two, 2^255 + 1; e = 0 and 256-bit exponents; base >= m)
  a base and modulus that need Barrett's third correction, and seeded
  full-width operands, at 17 lanes (a warp with three idle groups last)
  and 3;
- K7's copy and fix-up bodies, with the plan's per-lane body (its sort
  and scans serial in the host build), to ``expand_forks_plain`` over
  every leaf of ``chip_smoke.fork_frontier`` at P = 64 and the test
  limits (random rows in every field, bounded-loops tables the copies
  hit), for each policy, fork blocks of 16 and 64 lanes, defer on and
  off, with the profiler and loop bound and without either.

Everything runs in one child process (``torch_port_child``)."""

import shutil
import weakref

import pytest

import torch_port_child
import torch_port_k10host as k10host
import torch_port_warphost as warphost

SEEDS = [0, 1, 2]
P_K6 = 16
P_K3 = 32
P_K7 = 64
# a base and modulus whose table build needs Barrett's third correction
# (q - qhat = 3 on the second power)
BARRETT_3 = (115493631320220615308982905887737156535199793741578743490086311965284643747319, 5,
             57896044618658097711785492504343953926751871052829057858986680950883660023585)
T_TEST = 128  # TEST_LIMITS.tape_len


def _compute(path):
    """Child process: every comparison, as lists of differing fields."""
    import numpy as np
    import torch

    torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS, TEST_LIMITS
    from mythril_tpu_torch.symbolic.engine import append_group_plain, append_node_plain
    from mythril_tpu_torch.symbolic.propagate import propagate_feasibility_plain

    res = {}
    if not shutil.which("g++"):
        res["lib"] = None
        torch_port_child.dump(res, path)
        return
    lib = warphost.load(warphost.build())
    res["lib"] = True
    smoke = k10host.chip_smoke()
    T = TEST_LIMITS.tape_len

    def differing(got, want, names):
        return [n for n, x, y in zip(names, got, want)
                if x.dtype != y.dtype or not torch.equal(x, y)]

    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        sf = smoke.random_tapes("cpu", rng, P=P_K6, limits=TEST_LIMITS)
        # a quarter of the lanes: operands 1-3 nodes back, chains of
        # dependencies inside a window
        idx = np.arange(T)[None, :]
        chained = np.arange(P_K6) % 4 == 0
        a, b = sf.tape_a.numpy().copy(), sf.tape_b.numpy().copy()
        near = idx - rng.integers(1, 4, (P_K6, T))
        a[chained] = near[chained]
        b[chained] = np.where(rng.random((int(chained.sum()), T)) < 0.5, near[chained],
                              b[chained])
        op = sf.tape_op.numpy()
        a[op == 2] = sf.tape_a.numpy()[op == 2]  # FREE keeps its kind
        # lanes 1, 4 and 5 sweep a whole tape: four windows
        pl, tl = sf.prop_len.numpy().copy(), sf.tape_len.numpy().copy()
        pl[[1, 4, 5]], tl[[1, 4, 5]] = 0, T
        sf = sf.replace(tape_a=torch.as_tensor(a), tape_b=torch.as_tensor(b),
                        prop_len=torch.as_tensor(pl), tape_len=torch.as_tensor(tl))
        args = smoke._sweep_args(sf)
        inf = kernels.sweep_call(lib.propagate_sweep, 0, *args)
        want, inf_p = propagate_feasibility_plain(sf)
        names = ("prop_len", "iv_lo", "iv_hi", "kb_m", "kb_v", "infeasible")
        bad = differing(args[5:10] + [inf],
                        [getattr(want, k) for k in names[:5]] + [inf_p], names)
        start = np.maximum(sf.prop_len.numpy(), 1)[:, None]
        tlen = sf.tape_len.numpy()[:, None]
        new = (idx >= start) & (idx < tlen) & (op != 0)
        ai, bi = np.clip(a, 0, T - 1), np.clip(b, 0, T - 1)
        res["k6", seed] = dict(
            bad=bad, new=int(new.sum()), max_new=int((tlen - start).clip(0).max()),
            self_or_forward=int((new & ((ai >= idx) | (bi >= idx))).sum()),
            in_window=int((new & (ai < idx) & (ai >= idx - 3)).sum()),
            no_new_with_constraints=int(((tlen[:, 0] <= start[:, 0])
                                         & (sf.con_len.numpy() > 0)).sum()),
            infeasible=int(inf.sum()))

    # K3 at the default tape length (its scan takes 128 rows a step):
    # single rows over consecutive appends, then every group case
    rng = np.random.default_rng(7)
    k3 = kernels.TapeAppend(lib, 0, "cpu")
    T = DEFAULT_LIMITS.tape_len
    base = smoke.group_tape("cpu", rng, P_K3, T)
    tk, tp = [x.clone() for x in base], [x.clone() for x in base]
    single = []
    for step in range(6):
        op = torch.as_tensor(rng.integers(29, 31, P_K3).astype(np.int32))
        a = torch.as_tensor(rng.integers(0, 3, P_K3).astype(np.int32))
        b = torch.zeros(P_K3, dtype=torch.int32)
        imm = torch.as_tensor(rng.integers(0, 2, (P_K3, 8)).astype(np.int64))
        mask = torch.as_tensor((rng.random(P_K3) < 0.8) | (np.arange(P_K3) < 2))
        ids_k, ovf_k = kernels.tape_append(*tk, op, a, b, imm, mask, k3=k3)
        ids_p, ovf_p = append_node_plain(*tp, op, a, b, imm, mask)
        single.append(differing([ids_k, ovf_k, *tk], [ids_p, ovf_p, *tp],
                                ("ids", "overflow") + tuple(n for n, _ in kernels.TAPE_FIELDS)))
    res["k3 single"] = (single, k3.refreshed, bool(tp[5][:2].eq(T).all()))
    # a replaced tape (as expand_forks gathers one) is not kept alive by the
    # descriptor, and the new one is marshaled at the next append
    probe, n0 = weakref.ref(tk[3]), k3.refreshed
    tk, tp = [x.clone() for x in tk], [x.clone() for x in tp]
    ids_k, ovf_k = kernels.tape_append(*tk, op, a, b, imm, mask, k3=k3)
    ids_p, ovf_p = append_node_plain(*tp, op, a, b, imm, mask)
    res["k3 replaced"] = (probe() is None, k3.refreshed - n0,
                          differing([ids_k, ovf_k, *tk], [ids_p, ovf_p, *tp],
                                    ("ids", "overflow") + tuple(n for n, _ in kernels.TAPE_FIELDS)))
    groups = {}
    for name, tape, inputs in smoke.group_cases("cpu", rng, base):
        tk, tp = [x.clone() for x in tape], [x.clone() for x in tape]
        out_k, ovf_k = kernels.tape_append_group(*tk, *inputs, k3=k3)
        out_p, ovf_p = append_group_plain(*tp, *inputs)
        mask = inputs[6]
        groups[name] = dict(
            bad=differing([out_k, ovf_k, *tk], [out_p, ovf_p, *tp],
                          ("out", "overflow") + tuple(n for n, _ in kernels.TAPE_FIELDS)),
            masked=int(mask.sum()), appended=int((tp[5] - tape[5]).sum()),
            overflowed=ovf_p.nonzero().flatten().tolist(),
            untouched=bool((tp[5][2:4] == tape[5][2:4]).all()),
            repeats=int(((out_p[:, 1] == out_p[:, 0]) & mask[:, 1] & (out_p[:, 1] > 0)).sum())
            if name == "repeat" else None)
    res["k3 groups"] = groups

    # K5 on its edge cases and full-width operands
    from mythril_tpu_torch.ops import u256

    M = (1 << 256) - 1
    rng = np.random.default_rng(11)
    full = [tuple(int.from_bytes(rng.bytes(32), "big") for _ in range(3)) for _ in range(3)]
    cases = [(3, 5, 0), (3, 0, 1), (0, 0, 1), (5, 0, 7), (M, M, M), (M, M, M - 1),
             (2, M, 1 << 255), (2, M, (1 << 255) + 1), (M, 2, 3), (12345, M, 1),
             ((1 << 255) + 1, 3, (1 << 255) - 19), (9, M, 1 << 100), (M, 1, 2),
             BARRETT_3] + full
    k5 = {}
    for n in (len(cases), 3):
        b, e, m = (torch.as_tensor(u256.from_ints([c[i] for c in cases[:n]]).astype(np.int64))
                   for i in range(3))
        out = kernels.modexp_call(lib.modexp_u256, 0, b, e, m)
        got = [u256.to_int(w) for w in out.numpy()]
        k5[n] = dict(plain=bool(torch.equal(out, u256.modexp_plain(b, e, m))),
                     pow=[i for i, (x, y, z) in enumerate(cases[:n])
                          if got[i] != (pow(x, y, z) if z else 0)])
    res["k5"] = k5

    # K7's bodies through the descriptor, against the plain functional route
    from mythril_tpu_torch.symbolic.engine import expand_forks_plain, own_fork_fields
    from torch_port_batch import leaves

    sf, vis = smoke.fork_frontier("cpu", np.random.default_rng(3), P=P_K7, limits=TEST_LIMITS)
    bare = sf.replace(base=sf.base.replace(op_hist=None, op_resid=None))
    k7 = kernels.ForkExpand(lib, 0, "cpu")
    k7_res = {}
    for policy in kernels.FORK_POLICIES:
        for block in (16, P_K7):
            for defer in (False, True):
                for src, lb in ((sf, TEST_LIMITS.loop_bound), (bare, 0)):
                    got = k7.expand(own_fork_fields(src), block=block, policy=policy, defer=defer,
                                    loop_bound=lb, visited=vis)
                    want = expand_forks_plain(src, lb, block, policy, defer, vis)
                    w, g = leaves(want.to_numpy()), leaves(got.to_numpy())
                    k7_res[policy, block, defer, lb > 0] = dict(
                        bad=sorted(k for k in w if k not in g or not np.array_equal(w[k], g[k])),
                        copies=int(k7.count[0]),
                        trapped=int((want.base.err_code == 12).sum()
                                    - (src.base.err_code == 12).sum()))
    res["k7"] = k7_res
    res["launches"] = kernels.launch_counts()
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    out = torch_port_child.run("test_torch_warp_kernels", "_compute", tmp_path_factory)
    if out["lib"] is None:
        pytest.skip("needs g++ for the host build of the kernels' warp bodies")
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_host_k6_matches_plain_sweep(res, seed):
    r = res["k6", seed]
    assert r["bad"] == []
    # the inputs reach what the design must get right: several windows a
    # lane, self and forward references, dependencies inside a window,
    # lanes with constraints and no new node, kills both ways
    assert r["max_new"] == T_TEST - 1 and r["new"] > 0
    assert r["self_or_forward"] > 0 and r["in_window"] > 0
    assert r["no_new_with_constraints"] > 0
    assert 0 < r["infeasible"] < P_K6


def test_host_k3_single_rows_match_plain(res):
    single, refreshed, full = res["k3 single"]
    assert single == [[]] * len(single)
    # the descriptor marshaled the tape once for all the appends
    assert refreshed == 6
    assert full


def test_host_k3_descriptor_follows_a_replaced_tape(res):
    freed, refreshed, bad = res["k3 replaced"]
    assert freed and refreshed == 6 and bad == []


@pytest.mark.parametrize("case", ["chain", "binop", "repeat", "collision", "random"])
def test_host_k3_group_matches_plain(res, case):
    g = res["k3 groups"][case]
    assert g["bad"] == []
    assert g["appended"] > 0 and g["untouched"]
    assert {0, 1} & set(g["overflowed"])
    if case == "repeat":
        assert g["repeats"] > 0


@pytest.mark.parametrize("lanes", [17, 3])
def test_host_k5_matches_plain_and_pow(res, lanes):
    r = res["k5"][lanes]
    assert r["plain"] and r["pow"] == []


K7_CASES = [(p, b, d, lb) for p in ("fifo", "shallow", "deep", "random", "weighted",
                                    "coverage", "beam")
            for b in (16, P_K7) for d in (False, True) for lb in (True, False)]


@pytest.mark.parametrize("policy,block,defer,iprof_loops", K7_CASES, ids=[
    f"{p}-B{b}-{'defer' if d else 'drop'}-{'iprof' if lb else 'bare'}" for p, b, d, lb in K7_CASES])
def test_host_k7_matches_plain_functional_route(res, policy, block, defer, iprof_loops):
    r = res["k7"][policy, block, defer, iprof_loops]
    assert r["bad"] == [] and r["copies"] > 0


def test_host_k7_cases_retire_looping_lanes(res):
    assert sum(r["trapped"] for k, r in res["k7"].items() if k[3]) > 0


def test_host_launches_are_counted(res):
    counts = res["launches"]
    assert counts["propagate_sweep"] == 0  # sweep_call alone counts nothing
    assert counts["tape_append"] == 7 and counts["tape_append_group"] == 5
    # one per expansion through the descriptor; modexp_call counts nothing
    assert counts["fork_plan"] == len(K7_CASES) and counts["modexp_u256"] == 0
