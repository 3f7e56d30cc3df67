"""Kernels K6 (the feasibility sweep, a warp per lane in dependency
rounds) and K3 (the tape append, single rows and groups) before the card:
their warp bodies (``kernels/csrc/propagate.cuh``, ``tape_append.cuh``)
are compiled as host C++ with ``g++`` and a shim that runs each warp as
32 threads meeting at every vote and barrier (``torch_port_warphost``),
driven through the wrappers' own marshaling (``kernels.sweep_call``,
``kernels.TapeAppend``) and held exactly to the plain versions:

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
  steps).

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


def test_host_launches_are_counted(res):
    counts = res["launches"]
    assert counts["propagate_sweep"] == 0  # sweep_call alone counts nothing
    assert counts["tape_append"] == 7 and counts["tape_append_group"] == 5
