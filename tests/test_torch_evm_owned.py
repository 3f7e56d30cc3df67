"""K10's ownership contract and launch descriptor before the card, on its
host build (``torch_port_k10host``: ``evm_step.cuh`` compiled with g++
and driven through ``kernels.EvmStep``, the wrappers' own marshaling).

- A field swapped for a new tensor between launches is written, and the
  old tensor is left as it was; a wrong dtype, shape, device or layout
  found at a refresh raises; a written field sharing memory with another
  field raises, naming both.
- The fused entry point's count of running lanes, and ``run``'s read of
  it every ``RUN_READ_EVERY`` supersteps, equal ``run_plain`` at
  ``max_steps`` = 1 ... k + 1 and beyond quiescence, with one copy of the
  written fields a run and at most 1 + max_steps / k host reads.
- ``sym_run`` and ``sym_superstep`` routed to the host build (their card
  path: the written fields owned once per call, one descriptor, K10 in
  place) give the same frontier, field for field, as the plain versions
  on the frame and precompile batch of ``torch_port_batch`` at the test
  limits, in two chunks; the frontier each call was given is unchanged,
  and no field K10 writes shares memory with another frontier field at
  any launch.

The port is compared with itself (plain versions), so no JAX runs here.
Everything runs in one child process (``torch_port_child``).
"""

import shutil

import pytest

import torch_port_child
import torch_port_k10host as k10host

RUN_LANES = 4
CHUNK = 32  # a multiple of TEST_LIMITS.propagate_every: two chunks sweep as one run
BAD = ("dtype", "shape", "device", "layout")
ALIASES = ("same tensor", "overlapping view", "written over read", "disjoint rows")


def _compute(path):
    """Child process: every check, as plain data."""
    import dataclasses

    import numpy as np
    import torch

    torch_port_child.torch_single_thread()
    import torch_port_batch as tb
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import DEFAULT_LIMITS, TEST_LIMITS
    from mythril_tpu_torch.core import Corpus, make_env
    from mythril_tpu_torch.core import interpreter as ci
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.symbolic import SymSpec, make_sym_frontier, sym_run, sym_superstep
    from mythril_tpu_torch.workloads import erc20_transfer_workload

    smoke = k10host.chip_smoke()
    res = {}
    plain_k10_for = ci.k10_for
    if not shutil.which("g++"):
        torch_port_child.dump(None, path)
        return
    lib = k10host.load(k10host.build())

    def bad(got, want):
        return sorted(k for k, e in smoke.frontier_errs(got, want).items() if e != 0)

    def snapshot(x):
        return x.replace(**{k: v.clone() for k, v in vars(x).items()
                            if isinstance(v, torch.Tensor)})

    # a field swapped between launches
    f, env, corpus = smoke.vmtests_batch(TEST_LIMITS)
    k = k10host.step(lib)
    g = kernels.own_evm_fields(f)
    kernels.evm_step_call("superstep", k, g, env, corpus)
    want = ci.superstep_plain(snapshot(g), env, corpus)
    old = g.stack
    held = old.clone()
    g = g.replace(stack=old.clone())
    kernels.evm_step_call("superstep", k, g, env, corpus)
    res["swap"] = dict(written=bad(g, want), old_kept=bool(torch.equal(old, held)),
                       stack_moved=not torch.equal(g.stack, held))

    # a bad tensor at a refresh, after a good launch
    P = f.n_lanes
    bad_tensors = {
        "dtype": ("sp", g.sp.to(torch.int64)),
        "shape": ("sp", g.sp[:P - 1].clone()),
        "device": ("sp", torch.empty(P, dtype=torch.int32, device="meta")),
        "layout": ("stack", g.stack.transpose(0, 1).contiguous().transpose(0, 1)),
    }
    res["bad"] = {}
    for kind, (name, t) in bad_tensors.items():
        try:
            kernels.evm_step_call("superstep", k, g.replace(**{name: t}), env, corpus)
            res["bad"][kind] = None
        except (TypeError, ValueError) as e:
            res["bad"][kind] = str(e)

    # aliasing
    rows = torch.stack([g.sp, g.mem_words]).contiguous()
    aliased = {
        "same tensor": dict(returndata_len=g.retval_len),
        "overlapping view": dict(gas_max=g.gas_min.view(-1)),
        "written over read": dict(sp_base=g.sp),
        "disjoint rows": dict(sp=rows[0], mem_words=rows[1]),
    }
    res["alias"] = {}
    for kind, kw in aliased.items():
        try:
            kernels.evm_step_call("superstep", k10host.step(lib), g.replace(**kw), env, corpus)
            res["alias"][kind] = None
        except ValueError as e:
            res["alias"][kind] = str(e)

    # the running count and run's read every k supersteps: the ERC-20
    # transfer run (every lane stops at one step count) at a few lanes
    _, f, env, corpus = erc20_transfer_workload(RUN_LANES, DEFAULT_LIMITS)
    traj, counts = [f], []
    kc = k10host.step(lib)
    gc = kernels.own_evm_fields(f)
    kc.bind("superstep", gc, env, corpus)
    while bool(traj[-1].running.any()):
        traj.append(ci.superstep_plain(traj[-1], env, corpus))
        kc.launch("superstep")
        counts.append((int(kc.n_running[0]), int(traj[-1].running.sum())))
    quiet = len(traj) - 1
    K = ci.RUN_READ_EVERY
    steps = sorted(set(range(1, K + 2)) | {2 * K, 2 * K + 1, quiet - 1, quiet, quiet + 1,
                                           quiet + K, 256})
    plain = {m: bad(ci.run_plain(f, env, corpus, max_steps=m), traj[min(m, quiet)])
             for m in (1, K + 1, quiet + 1)}
    k10host.route(lib)
    before = snapshot(f)
    runs = {}
    for m in steps:
        syncs, copies = ci.HOST_SYNCS["count"], kernels.own_evm_fields.calls
        kernels.reset_launch_counts()
        out = ci.run(f, env, corpus, max_steps=m)
        runs[m] = dict(diff=bad(out, traj[min(m, quiet)]),
                       reads=ci.HOST_SYNCS["count"] - syncs,
                       copies=kernels.own_evm_fields.calls - copies,
                       launches=kernels.launch_counts()["evm_superstep"])
    res["run"] = dict(quiet=quiet, counts=counts, plain=plain, runs=runs,
                      input=bad(f, before))

    # sym_run and sym_superstep: plain first, then routed to the host build
    ci.k10_for = plain_k10_for
    images, cid, active, _, _ = tb.layout()
    L = tb.batch_limits(TEST_LIMITS, len(images))
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, L.max_code) for c in images])
    sf0 = make_sym_frontier(len(cid), L, contract_id=cid, active=active, n_contracts=len(images))
    env = make_env(len(cid))

    def leaves(sf):
        return tb.leaves(sf.to_numpy())

    def chunks():
        """Two sym_run calls and one sym_superstep -> (frontiers, the
        inputs changed by each call, K10 field copies)."""
        copies = kernels.own_evm_fields.calls
        sf1 = sym_run(sf0, env, corpus, SymSpec(), L, max_steps=CHUNK)
        held1 = leaves(sf1)
        sf2 = sym_run(sf1, env, corpus, SymSpec(), L, max_steps=CHUNK)
        held2 = leaves(sf2)
        one = sym_superstep(sf2, env, corpus, SymSpec(), L)
        changed = [k for held, x in ((held1, sf1), (held2, sf2))
                   for k, v in leaves(x).items() if not np.array_equal(held[k], v)]
        return [leaves(x) for x in (sf1, sf2, one)], changed, \
            kernels.own_evm_fields.calls - copies

    start = leaves(sf0)
    want, want_changed, _ = chunks()
    k10host.route(lib)
    launch = kernels.evm_step_call
    shared = set()

    def checked(entry, k10, f, env, corpus, **kw):
        # no field K10 writes may share memory with any other frontier field
        spans = {}
        for fl in dataclasses.fields(f):
            t = getattr(f, fl.name)
            if t is not None and t.numel():
                spans[fl.name] = (t.untyped_storage().data_ptr(), t.data_ptr(),
                                  t.data_ptr() + t.nbytes)
        for a in kernels.EVM_WRITES[entry]:
            for b, (s, lo, hi) in spans.items():
                if a in spans and b != a and s == spans[a][0] and lo < spans[a][2] \
                        and hi > spans[a][1]:
                    shared.add((a, b))
        return launch(entry, k10, f, env, corpus, **kw)

    kernels.evm_step_call = checked
    kernels.reset_launch_counts()
    got, got_changed, copies = chunks()
    kernels.evm_step_call = launch
    end = leaves(sf0)
    res["sym"] = dict(
        diff=[[k for k in w if not np.array_equal(w[k], g[k])] for w, g in zip(want, got)],
        changed=dict(plain=want_changed, owned=got_changed,
                     start=[k for k in start if not np.array_equal(start[k], end[k])]),
        copies=copies, shared=sorted(shared), launches=kernels.launch_counts(),
        progress=[int(x["base.n_steps"].sum()) for x in got])
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    out = torch_port_child.run("test_torch_evm_owned", "_compute", tmp_path_factory)
    if out is None:
        pytest.skip("g++ is not installed: K10's body cannot be built as host C++ here")
    return out


def test_a_field_swapped_between_launches_is_written_and_the_old_tensor_is_not(res):
    s = res["swap"]
    assert s["written"] == [] and s["stack_moved"]
    assert s["old_kept"]


@pytest.mark.parametrize("kind", BAD)
def test_a_bad_tensor_found_at_a_refresh_raises(res, kind):
    msg = res["bad"][kind]
    assert msg is not None and msg.startswith("evm_step ")


@pytest.mark.parametrize("kind", ALIASES)
def test_a_written_field_sharing_memory_with_another_raises(res, kind):
    msg = res["alias"][kind]
    if kind == "disjoint rows":  # one storage, no byte shared
        assert msg is None
        return
    names = {"same tensor": ("retval_len", "returndata_len"),
             "overlapping view": ("gas_max", "gas_min"),
             "written over read": ("sp", "sp_base")}[kind]
    assert msg is not None and all(n in msg for n in names), msg


def test_the_fused_entry_point_counts_the_running_lanes(res):
    r = res["run"]
    assert r["quiet"] > 2 * 16 + 1
    assert all(got == want for got, want in r["counts"])


def test_run_reads_every_k_supersteps_and_equals_run_plain(res):
    r = res["run"]
    assert all(d == [] for d in r["plain"].values())
    K = 16
    for m, o in r["runs"].items():
        assert o["diff"] == [], (m, o)
        assert o["copies"] == 1, (m, o)
        # at most max_steps launches, the reads: one before and one every K
        assert o["launches"] == min(m, -(-r["quiet"] // K) * K), (m, o)
        assert o["reads"] == 1 + len([i for i in range(K, o["launches"] + 1, K) if i < m]), \
            (m, o)
    assert r["input"] == []


def test_sym_run_owned_once_equals_the_plain_sym_run(res):
    s = res["sym"]
    assert s["diff"] == [[], [], []]
    a, b, c = s["progress"]
    assert a < b < c  # each chunk and the last superstep did work
    # one copy of K10's fields per sym_run call and one for sym_superstep
    assert s["copies"] == 3
    launches = s["launches"]
    assert launches["evm_prologue"] == launches["evm_dispatch"] == launches["evm_epilogue"] > 0


def test_sym_run_and_sym_superstep_leave_their_input_unchanged(res):
    s = res["sym"]
    assert s["changed"] == dict(plain=[], owned=[], start=[])
    assert s["shared"] == []
