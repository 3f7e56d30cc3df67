"""Kernel K10 (``kernels/csrc/evm_step.cu``) before the card: its
per-lane body (``evm_step.cuh``) is compiled as host C++ with ``g++`` and
a small shim (``torch_port_k10host``), driven through ctypes by the same
marshaling the CUDA wrappers use (``kernels.EvmStep``,
``kernels.evm_step_call``, the wrappers' standalone path), and held
field for field to the plain ``superstep_plain`` / ``prologue_plain`` /
``dispatch_plain`` / ``epilogue_plain`` at the test limits: the vmtests
batch stepped to quiescence, and a seeded random-opcode stress batch
(``chip_smoke.py`` builds both) that reaches every class and trap, under
both gas schedules, with the instruction profiler on and with a ``skip``
mask. Each entry point standalone (on copies) and, fused and split, over
consecutive steps in place on fields owned once through one descriptor,
with the fused entry point's count of running lanes.

Also the routing rule on the CPU: a CPU frontier goes to the plain
versions and launches no kernel. Everything runs in one child process
(``torch_port_child``)."""

import os
import shutil

import pytest

import torch_port_child
import torch_port_k10host as k10host

CSRC = k10host.CSRC
STRESS_LANES = 384
STRESS_STEPS = 4


def _compute(path):
    """Child process: every comparison, as lists of differing fields."""
    import numpy as np
    import torch

    torch_port_child.torch_single_thread()
    from mythril_tpu_torch import kernels
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import interpreter as ci

    smoke = k10host.chip_smoke()
    res = {}

    def bad(got, want):
        return sorted(k for k, e in smoke.frontier_errs(got, want).items() if e != 0)

    # routing on the CPU: plain versions, no launch
    kernels.reset_launch_counts()
    f, env, corpus = smoke.vmtests_batch(TEST_LIMITS)
    a = ci.superstep(f, env, corpus)
    f1, op, run, old_pc = ci.prologue(f, corpus)
    d = ci.dispatch(f1, env, corpus, op, run, old_pc, skip=torch.zeros_like(run))
    r = ci.run(f, env, corpus, max_steps=8)
    res["routing"] = dict(
        launches=kernels.launch_counts(),
        superstep=bad(a, ci.superstep_plain(f, env, corpus)),
        dispatch=bad(d, ci.dispatch_plain(f1, env, corpus, op, run, old_pc)),
        run=bad(r, ci.run_plain(f, env, corpus, max_steps=8)))

    # the header's pointer list is the wrappers' list
    with open(os.path.join(CSRC, "evm_step.cuh")) as fh:
        text = fh.read()
    import re

    block = text[text.index("#define EVM_PTR_FIELDS"):text.index("// dims, in this order")]
    res["fields"] = (re.findall(r"X\([^,]+,\s*(\w+)\)", block),
                     [n for n, *_ in kernels.EVM_FIELDS])

    if not shutil.which("g++"):
        res["lib"] = None
        torch_port_child.dump(res, path)
        return
    lib = k10host.load(k10host.build())
    res["lib"] = True
    # the wrappers' standalone path (a descriptor of their own, on copies
    # of the fields an entry point writes) on the host build
    kernels.EvmStep.on_card = classmethod(
        lambda cls, device, berlin=False: k10host.step(lib, device, berlin))

    def host(entry, f, env, corpus, berlin=False, **kw):
        if entry == "prologue":
            return kernels.evm_prologue(f, corpus, berlin)
        if entry == "dispatch":
            return kernels.evm_dispatch(f, env, corpus, **kw), None, None
        if entry == "epilogue":
            return kernels.evm_epilogue(f, **kw), None, None
        return kernels.evm_superstep(f, env, corpus, berlin), None, None

    def in_place(k10, g, h, env, corpus):
        """One split step of ``g`` in place through ``k10`` against the
        plain step of ``h`` -> (plain frontier, fields differing after
        prologue, op/run/old_pc equal, after dispatch, after epilogue)."""
        fp, op, run, old_pc = ci.prologue_plain(h, corpus, k10.berlin)
        _, kop, krun, kpc = kernels.evm_step_call("prologue", k10, g, None, corpus)
        out = [bad(g, fp), all(torch.equal(x, y) for x, y in
                               ((kop, op), (krun, run), (kpc, old_pc)))]
        dp = ci.dispatch_plain(fp, env, corpus, op, run, old_pc)
        kernels.evm_step_call("dispatch", k10, g, env, corpus, op=kop, run=krun, old_pc=kpc)
        out.append(bad(g, dp))
        ep = ci.epilogue_plain(dp, op, run, old_pc)
        kernels.evm_step_call("epilogue", k10, g, None, None, op=kop, run=krun, old_pc=kpc)
        out.append(bad(g, ep))
        return ep, out

    # the vmtests batch, step by step to quiescence (iprof on): the fused
    # entry point standalone, and fused and split each in place on fields
    # owned once (one descriptor each)
    f, env, corpus = smoke.vmtests_batch(TEST_LIMITS)
    f = f.attach_iprof()
    kf, ks = k10host.step(lib), k10host.step(lib)
    gf, gs = kernels.own_evm_fields(f), kernels.own_evm_fields(f)
    steps, mism, owned = 0, [], []
    while bool(f.running.any()) and steps < 256:
        want, split = in_place(ks, gs, f, env, corpus)
        got = host("superstep", f, env, corpus)[0]
        if bad(got, want):
            mism.append((steps, bad(got, want)))
        kernels.evm_step_call("superstep", kf, gf, env, corpus)
        owned.append(dict(step=steps, fused=bad(gf, want), split=split,
                          count=int(kf.n_running[0]) == int(want.running.sum())))
        f = want
        steps += 1
    res["vmtests"] = dict(steps=steps, quiet=not bool(f.running.any()), mismatches=mism)
    # run's in-place path: own once, then every superstep in place
    res["vmtests_in_place"] = bad(gf, f)
    res["vmtests_owned"] = owned

    # the stress batch: fused and split paths, both gas schedules, skip
    # mask, each entry point standalone; and the berlin steps again in
    # place on fields owned once, fused and split (no skip)
    rng = np.random.default_rng(20261017)
    f, env, corpus = smoke.evm_stress_batch(STRESS_LANES, TEST_LIMITS, rng)
    kf, ks = k10host.step(lib, berlin=True), k10host.step(lib, berlin=True)
    gf, gs = kernels.own_evm_fields(f), kernels.own_evm_fields(f)
    ops, codes, out, owned = [], [], [], []
    for step in range(STRESS_STEPS):
        # the standalone entry points leave their input as it was
        before = f.replace(**{k: v.clone() for k, v in vars(f).items()
                              if isinstance(v, torch.Tensor)})
        for berlin in (False, True):
            fp, op, run, old_pc = ci.prologue_plain(f, corpus, berlin)
            hp, hop, hrun, hpc = host("prologue", f, env, corpus, berlin=berlin)
            skip = torch.as_tensor(rng.random(STRESS_LANES) < 0.3)
            dp = ci.dispatch_plain(fp, env, corpus, op, run, old_pc, skip=skip)
            hd = host("dispatch", fp, env, corpus, op=op, run=run, old_pc=old_pc, skip=skip)[0]
            ep = ci.epilogue_plain(dp, op, run, old_pc)
            he = host("epilogue", dp, None, None, op=op, run=run, old_pc=old_pc)[0]
            # fused: the plain composite (no skip)
            dn = ci.dispatch_plain(fp, env, corpus, op, run, old_pc)
            want = ci.epilogue_plain(dn, op, run, old_pc)
            got = host("superstep", f, env, corpus, berlin=berlin)[0]
            out.append(dict(step=step, berlin=berlin, prologue=bad(hp, fp),
                            op=bool(torch.equal(hop, op) and torch.equal(hpc, old_pc)),
                            run=bool(torch.equal(hrun, run)), dispatch=bad(hd, dp),
                            epilogue=bad(he, ep), fused=bad(got, want), inputs=bad(f, before)))
            ops.append(op[run].numpy())
            if berlin:
                _, kop, krun, kpc = kernels.evm_step_call("prologue", ks, gs, None, corpus)
                split = [bad(gs, fp), all(torch.equal(x, y) for x, y in
                                          ((kop, op), (krun, run), (kpc, old_pc)))]
                kernels.evm_step_call("dispatch", ks, gs, env, corpus, op=kop, run=krun,
                                      old_pc=kpc)
                split.append(bad(gs, dn))
                kernels.evm_step_call("epilogue", ks, gs, None, None, op=kop, run=krun,
                                      old_pc=kpc)
                split.append(bad(gs, want))
                kernels.evm_step_call("superstep", kf, gf, env, corpus)
                owned.append(dict(step=step, fused=bad(gf, want), split=split,
                                  count=int(kf.n_running[0]) == int(want.running.sum())))
                f = want
        codes.append(f.err_code.numpy())
    res["stress"] = out
    res["stress_owned"] = owned
    res["classes"] = sorted({int(c) for c in ci.CLASS_TABLE[np.concatenate(ops)]})
    res["traps"] = sorted({int(c) for c in np.concatenate(codes)})
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_evm_step", "_compute", tmp_path_factory)


@pytest.fixture(scope="module")
def host(res):
    if res["lib"] is None:
        pytest.skip("g++ is not installed: K10's body cannot be built as host C++ here")
    return res


def test_cpu_frontier_takes_the_plain_versions_and_launches_nothing(res):
    r = res["routing"]
    assert all(n == 0 for n in r["launches"].values()), r["launches"]
    assert r["superstep"] == r["dispatch"] == r["run"] == []


def test_header_pointer_order_is_the_wrappers_order(res):
    header, wrappers = res["fields"]
    # the kernel's is_static is the field static, t_<name> the table NAME
    assert [n[2:].upper() if n.startswith("t_") else {"is_static": "static"}.get(n, n)
            for n in header] == wrappers


def test_vmtests_step_by_step_equal_the_plain_superstep(host):
    v = host["vmtests"]
    assert v["quiet"] and v["steps"] > 1
    assert v["mismatches"] == []


def test_run_in_place_equals_the_plain_steps(host):
    assert host["vmtests_in_place"] == []


@pytest.mark.parametrize("part", ["prologue", "op", "run", "dispatch", "epilogue", "fused",
                                  "inputs"])
def test_stress_batch_equals_the_plain_versions(host, part):
    bad = [(o["step"], o["berlin"], o[part]) for o in host["stress"]
           if o[part] not in ([], True)]
    assert bad == []


def test_stress_batch_reaches_every_class_and_trap(host):
    assert host["classes"] == list(range(16))
    assert {1, 2, 3, 4, 5, 6, 7, 10} <= set(host["traps"])


@pytest.mark.parametrize("part", ["fused", "split", "count"])
def test_vmtests_in_place_on_fields_owned_once_equal_the_plain_steps(host, part):
    v = host["vmtests_owned"]
    assert len(v) == host["vmtests"]["steps"] > 1
    if part == "split":
        # after the prologue, op/run/old_pc, after dispatch, after the epilogue
        assert [(o["step"], o["split"]) for o in v
                if o["split"] != [[], True, [], []]] == []
    else:
        assert [o["step"] for o in v if o[part] not in ([], True)] == []


@pytest.mark.parametrize("part", ["fused", "split", "count"])
def test_stress_steps_in_place_on_fields_owned_once_equal_the_plain_steps(host, part):
    v = host["stress_owned"]
    assert len(v) == STRESS_STEPS
    if part == "split":
        assert [(o["step"], o["split"]) for o in v
                if o["split"] != [[], True, [], []]] == []
    else:
        assert [o["step"] for o in v if o[part] not in ([], True)] == []

