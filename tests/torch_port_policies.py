"""Shared children of the port's tests of the fork policies, fork blocks,
berlin gas, the instruction profiler, checkpoints and the u256 product
family (``test_torch_arith``, ``test_torch_sweep``, ``test_torch_forks``,
``test_torch_checkpoint``).

Two JAX children and three PyTorch children start together and pickle
their results (``torch_port_child``):

- ``_jax_units``: the JAX package on seeded inputs — the u256 product
  family, ``propagate_feasibility`` on random tapes, ``expand_forks`` for
  every policy and block size, ``rebalance_parked`` and
  ``migrate_parked_device``;
- ``_jax_engine``: ONE jitted ``sym_run`` batch (berlin gas, the
  profiler, 8-lane fork blocks, the coverage policy, spill and in-loop
  migration) run twice from one compile, with the frontier saved by
  ``save_frontier`` between the two halves;
- ``_torch_engine``: the same through the port's plain versions on the
  CPU (the fork expansion through its in-place route, and that route held
  to the plain functional one on every case and on bounded-loops tables
  the copies hit), and a sweep of the batch's real frontier, the batch's
  input held unchanged; ``_torch_resume`` (once
  the JAX child is done) loads the JAX checkpoint, runs the second half
  from it, saves both halves through the port's ``save_frontier`` and
  tears the newest file;
- ``_torch_cli_a`` / ``_torch_cli_b``: the port's CLI on the arith
  fixture at the test profile for each strategy and with the profiler
  (held to the JAX reports pinned by ``torch_port_fixtures.py``), a
  checkpointed wrapper run resumed mid-transaction, and plugin discovery.
"""

import dataclasses
import os

import numpy as np

import torch_port_child
from torch_port_fixtures import (ARITH_TEST_ARGS, STRATEGIES, arith_file, arith_runtime,
                                 read_hex)

P_UNIT = 32          # lanes of the synthesized frontiers
ENGINE_LANES = 8     # lanes per program of the engine batch = its fork block
ENGINE_STEPS = 42    # per half; not a multiple of propagate_every, so the
#                      batch's frontier holds nodes no sweep has seen
BLOCKS = (0, 8, 16)
FORK_SEEDS = (1, 3)  # expand_forks' frontier; the lane-move cases' rows
POLICIES = ("fifo", "shallow", "deep", "random", "weighted", "coverage", "beam")
MIGRATE_BLOCK = 4
CHUNK = 16           # the checkpointed wrapper run's chunk (a multiple of
#                      propagate_every, so the sweeps fall on the same steps)
CALLEE = 0xAFFE + 0x10000  # contract_address(1)


def _cd(off):
    return [off, "CALLDATALOAD"]


def engine_programs():
    """Four programs for the berlin/iprof/fork-block batch."""
    from mythril_tpu_torch.disassembler.asm import assemble

    storage = assemble(
        0, "SLOAD", "POP", 0, "SLOAD", "POP", ("push3", CALLEE), "EXTCODESIZE", "POP",
        ("push3", CALLEE), "EXTCODESIZE", "POP", *_cd(4), "BALANCE", "POP",
        *_cd(4), "SLOAD", 1, "SSTORE", *_cd(36), ("ref", "x"), "JUMPI", 2, 2, "SSTORE",
        ("label", "x"), "STOP")
    calls = assemble(
        0, 0, 0, 0, 0, ("push3", CALLEE), ("push2", 5000), "CALL", "POP",
        0, 0, 0, 0, 1, *_cd(4), ("push2", 0xFFFF), "CALL", "POP", 1, 0, "SSTORE", "STOP")
    forks = []
    for i in range(6):
        forks += [*_cd(4), 1 << i, "AND", ("ref", f"l{i}"), "JUMPI", ("label", f"l{i}")]
    return [arith_runtime(), storage, calls, assemble(*forks, 1, 0, "SSTORE", "STOP")]


def engine_limits(base):
    return dataclasses.replace(base, gas_schedule="berlin", max_accounts=6)


ENGINE_KW = dict(max_steps=ENGINE_STEPS, fork_block=ENGINE_LANES, track_coverage=True,
                 fork_policy="coverage", defer_starved=True, migrate_every=4)


def _words(rng, n, edges):
    out = [int(x) for x in edges]
    while len(out) < n:
        out.append(int.from_bytes(rng.bytes(32), "big") >> int(rng.integers(0, 256)))
    return np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for x in out],
                    dtype=np.uint32)


def u256_inputs():
    """(a, b, m, e) u32[N, 8] words: edge cases, then seeded random."""
    rng = np.random.default_rng(11)
    M = (1 << 256) - 1
    edges = [0, 1, 2, 1 << 255, M, M - 1, (1 << 128) - 1, 1 << 128, 10, 10 ** 18]
    n = 96
    return (_words(rng, n, edges), _words(rng, n, edges[::-1]),
            _words(rng, n, [0, 1, M, 2, 7, 1 << 255, 10000, (1 << 255) + 19]),
            _words(rng, n, [0, 1, 1 << 255, M, 2, 255, 256, 3]))


def sweep_fields(limits):
    """Random tapes with every op (and NULL rows, clipped and FREE-kind
    operands), random starting domains and constraints."""
    rng = np.random.default_rng(5)
    P, T, C = P_UNIT, limits.tape_len, limits.max_constraints
    op = rng.integers(0, 29, (P, T)).astype(np.int32)
    op[rng.random((P, T)) < 0.3] = 1  # CONST
    a = (rng.random((P, T)) * (np.arange(T) + 3)[None, :]).astype(np.int32) - 1
    b = (rng.random((P, T)) * (np.arange(T) + 3)[None, :]).astype(np.int32) - 1
    free = op == 2
    a[free] = rng.integers(0, 18, int(free.sum()))

    def words(shape):
        w = rng.integers(0, 1 << 32, shape + (8,), dtype=np.int64)
        kind = rng.integers(0, 5, shape)
        w[kind == 0] = 0
        w[kind == 1, 1:] = 0
        w[kind == 1, 0] = rng.integers(0, 300, shape)[kind == 1]
        w[kind == 2, 2:] = 0
        w[kind == 3] = 0xFFFFFFFF
        return w.astype(np.uint32)

    km = words((P, T))
    tape_len = rng.integers(1, T + 1, P).astype(np.int32)
    return dict(
        tape_op=op, tape_a=a, tape_b=b, tape_imm=words((P, T)), tape_len=tape_len,
        prop_len=np.minimum(rng.integers(0, T, P), tape_len).astype(np.int32),
        iv_lo=words((P, T)), iv_hi=words((P, T)), kb_m=km, kb_v=words((P, T)) & km,
        con_len=rng.integers(0, 4, P).astype(np.int32),
        con_node=rng.integers(-1, T + 2, (P, C)).astype(np.int32),
        con_sign=rng.random((P, C)) < 0.5)


def fork_fields(limits, seed):
    """A frontier mid-superstep: live/free lanes, fork requests (JUMPI and
    call-enumeration), depths, parked counters and profiler rows."""
    rng = np.random.default_rng(seed)
    P, C, S = P_UNIT, limits.max_constraints, limits.max_stack
    active = rng.random(P) < rng.choice([0.4, 0.6, 0.9])
    sign = rng.random((P, C)) < 0.5
    return dict(
        active=active, fork_req=rng.random(P) < 0.7,
        con_len=rng.integers(1, C + 1, P).astype(np.int32), con_sign=sign,
        fork_dest=rng.integers(-2, 300, P).astype(np.int32),
        pc=rng.integers(1, 300, P).astype(np.int32), sp=rng.integers(2, S - 2, P).astype(np.int32),
        dropped_forks=rng.integers(0, 3, P).astype(np.int32),
        fork_cslot=np.where(rng.random(P) < 0.3, rng.integers(-1, S + 2, P), -1).astype(np.int32),
        fork_cval=rng.integers(0, 1 << 32, (P, 8)).astype(np.uint32),
        call_enum=rng.integers(0, 4, P).astype(np.int32),
        contract_id=rng.integers(0, 2, P).astype(np.int32),
        op_hist=rng.integers(0, 50, (P, 256)).astype(np.int32),
        op_resid=rng.integers(0, 9, 256).astype(np.int32),
        visited=rng.random((2, limits.max_code)) < 0.5)


def lb_fields(limits, f, seed):
    """Bounded-loops tables for the frontier of ``fork_fields`` ``f``: most
    lanes already hold the entry a backward copy of theirs hits, with
    counts about the bound; some tables are full, some empty."""
    rng = np.random.default_rng(seed)
    P, LBS = len(f["pc"]), limits.loop_slots
    lb_len = rng.integers(0, LBS + 1, P).astype(np.int32)
    lb_key = rng.integers(0, 1 << 40, (P, LBS))
    lb_cnt = rng.integers(0, limits.loop_bound + 2, (P, LBS)).astype(np.int32)
    lanes = np.nonzero((rng.random(P) < 0.7) & (lb_len > 0))[0]
    slot = (rng.random(P) * np.maximum(lb_len, 1)).astype(np.int64)[lanes]
    key = (f["contract_id"].astype(np.int64) * 32768 + f["fork_dest"]) * 32768 + f["pc"] - 1
    lb_key[lanes, slot] = key[lanes]
    lb_cnt[lanes, slot] = rng.integers(limits.loop_bound - 1, limits.loop_bound + 1, len(lanes))
    return dict(lb_len=lb_len, lb_key=lb_key, lb_cnt=lb_cnt)


def loop_table_paths(f, oi, ob, limits):
    """How the backward copies of a plan (``fork_plan_plain``'s rows, as
    numpy) meet their sources' tables: hits, misses that add an entry,
    misses on a full table (the coldest slot is reused)."""
    back = np.nonzero(ob[3])[0]
    src = oi[0][back]
    key = (f["contract_id"].astype(np.int64) * 32768 + f["fork_dest"]) * 32768 + f["pc"] - 1
    live = np.arange(limits.loop_slots)[None, :] < f["lb_len"][src][:, None]
    hit = np.any(live & (f["lb_key"][src] == key[src][:, None]), axis=1)
    full = f["lb_len"][src] == limits.loop_slots
    return dict(hit=int(hit.sum()), grown=int((~hit & ~full).sum()),
                cold=int((~hit & full).sum()))


def differing(want, got):
    """The leaves of two frontiers' ``leaves`` that differ."""
    return sorted(k for k in set(want) | set(got)
                  if k not in want or k not in got or got[k].dtype != want[k].dtype
                  or not np.array_equal(got[k], want[k]))


def migrate_cases():
    """(active, parked) masks over 32 lanes in blocks of 4: the JAX
    package's tests/test_migrate.py layouts, then seeded random ones."""
    P, B = P_UNIT, MIGRATE_BLOCK
    cases = []
    a = np.zeros(P, bool); a[0:4] = a[4:6] = True
    r = np.zeros(P, bool); r[1] = True
    cases.append((a, r))
    a = np.zeros(P, bool); a[0:3] = True
    cases.append((a, r.copy()))
    a = np.ones(P, bool); a[28:32] = False
    r = np.zeros(P, bool); r[0:4] = True
    cases.append((a, r))
    rng = np.random.default_rng(9)
    for _ in range(6):
        a = rng.random(P) < 0.75
        a[:B * 2] = True
        cases.append((a, rng.random(P) < 0.5))
    return cases


def _set(sf, fields, base_names, conv):
    base = {k: conv(v) for k, v in fields.items() if k in base_names}
    rest = {k: conv(v) for k, v in fields.items() if k not in base_names and k != "visited"}
    return sf.replace(base=sf.base.replace(**base), **rest)


BASE_FIELDS = ("active", "pc", "sp", "contract_id", "op_hist", "op_resid")


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------


def _jax_units(path):
    import jax
    import jax.numpy as jnp

    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.ops import u256
    from mythril_tpu.symbolic import make_sym_frontier
    from mythril_tpu.symbolic.engine import (expand_forks, migrate_parked_device,
                                             rebalance_parked)
    from mythril_tpu.symbolic.propagate import propagate_feasibility
    from torch_port_batch import leaves

    out = {}
    a, b, m, e = (jnp.asarray(x) for x in u256_inputs())
    out["u256"] = {k: np.asarray(v) for k, v in dict(
        mul=u256.mul(a, b), mul_wide=u256.mul_wide(a, b), mulmod=u256.mulmod(a, b, m),
        addmod=u256.addmod(a, b, m), exp=u256.exp(a, e)).items()}

    L = TEST_LIMITS
    sf = _set(make_sym_frontier(P_UNIT, L), sweep_fields(L), BASE_FIELDS, jnp.asarray)
    sf2, inf = jax.jit(propagate_feasibility)(sf)
    out["sweep"] = {"frontier": leaves(sf2), "infeasible": np.asarray(inf)}

    out["hist_totals"] = {seed: int(f["op_hist"].sum()) + int(f["op_resid"].sum())
                          for seed, f in ((s, fork_fields(L, s)) for s in FORK_SEEDS)}
    forks = {}
    f = fork_fields(L, FORK_SEEDS[0])
    sf = _set(make_sym_frontier(P_UNIT, L, n_contracts=2), f, BASE_FIELDS, jnp.asarray)
    for blk in BLOCKS:
        for pol in POLICIES:
            for defer in (False, True):
                forks[pol, blk, defer] = leaves(expand_forks(
                    sf, L.loop_bound, blk, pol, defer, jnp.asarray(f["visited"])))
    out["forks"] = forks

    moves = []
    migrate = jax.jit(migrate_parked_device, static_argnums=(1,))
    for act, parked in migrate_cases():
        f = fork_fields(L, FORK_SEEDS[1])
        f.update(active=act, fork_req=parked, pc=np.arange(P_UNIT, dtype=np.int32))
        sf = _set(make_sym_frontier(P_UNIT, L), f, BASE_FIELDS, jnp.asarray)
        reb, n = rebalance_parked(sf, MIGRATE_BLOCK)
        moves.append({"migrate": leaves(migrate(sf, MIGRATE_BLOCK)),
                      "rebalance": leaves(reb), "moved": n})
    out["moves"] = moves
    torch_port_child.dump(out, path)


def _jax_engine(path):
    import jax

    import mythril_tpu  # noqa: F401  (x64)
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.core import Corpus, make_env
    from mythril_tpu.disassembler import ContractImage
    from mythril_tpu.symbolic import SymSpec, make_sym_frontier, sym_run
    from mythril_tpu.symbolic.propagate import propagate_feasibility
    from mythril_tpu.utils.checkpoint import save_frontier
    from torch_port_batch import leaves

    EL = engine_limits(TEST_LIMITS)
    progs = engine_programs()
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, EL.max_code) for c in progs])
    P = ENGINE_LANES * len(progs)
    cid = np.repeat(np.arange(len(progs), dtype=np.int32), ENGINE_LANES)
    active = np.zeros(P, bool)
    active[::ENGINE_LANES] = True
    sf = make_sym_frontier(P, EL, contract_id=cid, active=active, n_contracts=len(progs))
    sf = sf.replace(base=sf.base.attach_iprof())
    env = make_env(P)
    sf1, vis1 = sym_run(sf, env, corpus, SymSpec(), EL, **ENGINE_KW)
    save_frontier(os.path.join(os.path.dirname(str(path)), "frontier.npz"), sf1,
                  {"tx": 0, "steps_done": ENGINE_STEPS})
    sf2, vis2 = sym_run(sf1, env, corpus, SymSpec(), EL, **ENGINE_KW)
    swept, inf = jax.jit(propagate_feasibility)(sf1)
    torch_port_child.dump({"half1": leaves(sf1), "half2": leaves(sf2),
                           "vis1": np.asarray(vis1), "vis2": np.asarray(vis2),
                           "swept": leaves(swept), "infeasible": np.asarray(inf)}, path)


def _torch_engine(path):
    torch = torch_port_child.torch_single_thread()
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import Corpus, make_env
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.ops import u256
    from mythril_tpu_torch.symbolic import SymSpec, make_sym_frontier, sym_run
    from mythril_tpu_torch.kernels import ForkExpand
    from mythril_tpu_torch.symbolic.engine import (B_BACK, expand_forks, expand_forks_inplace,
                                                   expand_forks_plain, fork_plan_plain,
                                                   migrate_parked_device, own_fork_fields,
                                                   rebalance_parked)
    from mythril_tpu_torch.symbolic.propagate import propagate_feasibility_plain
    from torch_port_batch import leaves

    def tt(x):
        x = np.asarray(x)
        return torch.as_tensor(x.astype(np.int64) if x.dtype == np.uint32 else x)

    def word(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64))

    def u32(t):
        return t.numpy().astype(np.uint32)

    out = {}
    a, b, m, e = (word(x) for x in u256_inputs())
    out["u256"] = dict(
        mul=u32(u256.mul(a, b)), mul_wide=u32(u256.mul_wide(a, b)),
        mulmod=u32(u256._mod_wide(u256.mul_wide(a, b), m)),
        addmod=u32(u256.addmod(a, b, m)), exp=u32(u256.exp(a, e)))

    L = TEST_LIMITS

    def port_frontier(n_contracts, fields):
        sf = make_sym_frontier(P_UNIT, L, n_contracts=n_contracts)
        host = sf.to_numpy()
        for k, v in fields.items():
            if k in BASE_FIELDS:
                setattr(host.base, k, v)
            elif k != "visited":
                setattr(host, k, v)
        return type(sf).from_numpy(host, "cpu")

    sf = port_frontier(1, sweep_fields(L))
    sf2, inf = propagate_feasibility_plain(sf)
    out["sweep"] = {"frontier": leaves(sf2.to_numpy()), "infeasible": inf.numpy()}

    forks, routes = {}, {}
    f = fork_fields(L, FORK_SEEDS[0])
    sf = port_frontier(2, f)
    vis = torch.as_tensor(f["visited"])
    held = leaves(sf.to_numpy())
    # the in-place route through one descriptor, as sym_run holds it,
    # against the plain functional route
    k7 = ForkExpand(None, 0, "cpu")
    for blk in BLOCKS:
        for pol in POLICIES:
            for defer in (False, True):
                forks[pol, blk, defer] = leaves(expand_forks(
                    sf, L.loop_bound, blk, pol, defer, vis).to_numpy())
                plain = leaves(expand_forks_plain(sf, L.loop_bound, blk, pol, defer,
                                                  vis).to_numpy())
                inplace = expand_forks_inplace(own_fork_fields(sf), L.loop_bound, blk, pol,
                                               defer, vis, k7)
                routes[pol, blk, defer] = (differing(plain, leaves(inplace.to_numpy())),
                                           differing(plain, forks[pol, blk, defer]))
    out["forks"] = forks
    out["fork_routes"] = routes
    out["forks_held"] = differing(held, leaves(sf.to_numpy()))
    # backward copies that hit, fill and overflow the bounded-loops tables
    f_lb = dict(f, **lb_fields(L, f, 4))
    sf_lb = port_frontier(2, f_lb)
    lb = {}
    for pol in POLICIES:
        for defer in (False, True):
            plain = expand_forks_plain(sf_lb, L.loop_bound, 0, pol, defer, vis)
            inplace = expand_forks_inplace(own_fork_fields(sf_lb), L.loop_bound, 0, pol, defer,
                                           vis, k7)
            b = sf_lb.base
            oi, ob = fork_plan_plain(b.active, sf_lb.fork_req, sf_lb.con_len, sf_lb.fork_dest,
                                     b.contract_id, b.pc, b.sp, sf_lb.dropped_forks,
                                     sf_lb.fork_cslot, sf_lb.call_enum, vis, block=P_UNIT,
                                     policy=pol, n_con=L.max_constraints, n_stack=L.max_stack,
                                     defer=defer)
            lb[pol, defer] = dict(
                bad=differing(leaves(plain.to_numpy()), leaves(inplace.to_numpy())),
                trapped=int((ob[B_BACK] & (plain.base.err_code == 12)).sum()),
                **loop_table_paths(f_lb, oi.numpy(), ob.numpy(), L))
    out["forks_lb"] = lb
    # the descriptor's ownership checks: a field shared with another raises,
    # an expanded view is copied once
    owned = own_fork_fields(sf)
    try:
        k7.bind(owned.replace(caller_sym=owned.callvalue_sym))
        out["k7_alias"] = None
    except ValueError as e:
        out["k7_alias"] = str(e)
    view = own_fork_fields(sf).replace(mem_havoc=torch.ones(1, dtype=torch.bool).expand(P_UNIT))
    want = expand_forks_plain(view, L.loop_bound, 0, "fifo", False, vis)
    got = expand_forks_inplace(view, L.loop_bound, 0, "fifo", False, vis, k7)
    out["k7_view"] = (differing(leaves(want.to_numpy()), leaves(got.to_numpy())),
                      got.mem_havoc.is_contiguous(), got.mem_havoc is not view.mem_havoc)

    moves = []
    for act, parked in migrate_cases():
        f = fork_fields(L, FORK_SEEDS[1])
        f.update(active=act, fork_req=parked, pc=np.arange(P_UNIT, dtype=np.int32))
        sf = port_frontier(1, f)
        reb, n = rebalance_parked(sf, MIGRATE_BLOCK)
        moves.append({"migrate": leaves(migrate_parked_device(sf, MIGRATE_BLOCK).to_numpy()),
                      "rebalance": leaves(reb.to_numpy()), "moved": n})
    out["moves"] = moves

    sf, env, corpus, EL = _torch_engine_batch()
    held = leaves(sf.to_numpy())
    sf1, vis1 = sym_run(sf, env, corpus, SymSpec(), EL, **ENGINE_KW)
    swept, inf = propagate_feasibility_plain(sf1)
    out["engine"] = {"half1": leaves(sf1.to_numpy()), "vis1": vis1.numpy(),
                     "swept": leaves(swept.to_numpy()), "infeasible": inf.numpy(),
                     "held": differing(held, leaves(sf.to_numpy()))}
    torch_port_child.dump(out, path)


def _torch_engine_batch():
    """The engine batch's starting frontier, env, corpus and limits."""
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.core import Corpus, make_env
    from mythril_tpu_torch.disassembler import ContractImage
    from mythril_tpu_torch.symbolic import make_sym_frontier

    EL = engine_limits(TEST_LIMITS)
    progs = engine_programs()
    corpus = Corpus.from_images([ContractImage.from_bytecode(c, EL.max_code) for c in progs])
    P = ENGINE_LANES * len(progs)
    cid = np.repeat(np.arange(len(progs), dtype=np.int32), ENGINE_LANES)
    active = np.zeros(P, bool)
    active[::ENGINE_LANES] = True
    sf = make_sym_frontier(P, EL, contract_id=cid, active=active, n_contracts=len(progs))
    return sf.replace(base=sf.base.attach_iprof()), make_env(P), corpus, EL


def _npz_arrays(path):
    """Every array of a frontier npz (its integrity trailer stripped)."""
    import io

    from mythril_tpu_torch.utils.checkpoint import _read_npz_body

    data = np.load(io.BytesIO(_read_npz_body(path)[0]))
    return {k: data[k] for k in data.files}


def _torch_resume(path):
    """The port's load of the JAX package's npz (written beside ``path``)
    and the batch's second half from it; then the port's own npz of both
    halves (the first rotated to ``.1``), and the newest torn."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.symbolic import SymSpec, sym_run
    from mythril_tpu_torch.utils.checkpoint import (CheckpointCorrupt, load_frontier,
                                                    load_frontier_resilient, save_frontier)
    from torch_port_batch import leaves

    d = os.path.dirname(str(path))
    template, env, corpus, EL = _torch_engine_batch()
    sf1, meta = load_frontier(os.path.join(d, "frontier.npz"), template)
    sf2, vis2 = sym_run(sf1, env, corpus, SymSpec(), EL, **ENGINE_KW)
    out = {"loaded": leaves(sf1.to_numpy()), "meta": meta,
           "half2": leaves(sf2.to_numpy()), "vis2": vis2.numpy()}
    own = os.path.join(d, "port_frontier.npz")
    save_frontier(own, sf1, meta)
    save_frontier(own, sf2, {"tx": 0, "steps_done": 2 * ENGINE_STEPS})
    out["jax_npz"] = _npz_arrays(os.path.join(d, "frontier.npz"))
    out["port_npz"] = _npz_arrays(own + ".1")
    with open(own, "r+b") as fh:
        fh.truncate(os.path.getsize(own) // 2)
    try:
        load_frontier(own, template)
        out["torn"] = None
    except CheckpointCorrupt as e:
        out["torn"] = type(e).__name__
    back, meta_back, src = load_frontier_resilient(own, template)
    out["fallback"] = {"leaves": leaves(back.to_numpy()), "meta": meta_back,
                       "source": os.path.basename(src),
                       "quarantined": os.path.exists(own + ".corrupt")}
    torch_port_child.dump(out, path)


def _cli(*argv):
    import contextlib
    import io

    from mythril_tpu_torch.interfaces.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(list(argv))
        except SystemExit as ex:
            rc = ex.code
    return rc, out.getvalue(), err.getvalue()


def _strategy_runs(strategies, extra=()):
    return {s: _cli("analyze", "-f", arith_file(), "--strategy", s, "--device", "cpu",
                    "-o", "json", *ARITH_TEST_ARGS, *extra) for s in strategies}


def _torch_cli_a(path):
    torch_port_child.torch_single_thread()
    res = {"strategies": _strategy_runs(STRATEGIES[:3])}
    # the campaign's --checkpoint-dir rides along: single analyze ignores it
    ck = os.path.join(os.path.dirname(str(path)), "ckpt_cli")
    res["iprof"] = _cli("analyze", "-f", arith_file(), "--enable-iprof", "--device", "cpu",
                        "-o", "json", "--checkpoint-dir", ck, *ARITH_TEST_ARGS)
    res["ckpt_dir_made"] = os.path.exists(ck)
    torch_port_child.dump(res, path)


PLUGIN_SRC = '''
import os

from mythril_tpu_torch.analysis.module.base import DetectionModule
from mythril_tpu_torch.plugin.interface import LaserPlugin


class PluginProbe(DetectionModule):
    name = "PluginProbe"
    swc_id = "000"
    description = "a detection module loaded from a plugin directory"

    def _execute(self, ctx):
        return []


class RunMarker(LaserPlugin):
    name = "run-marker"

    def on_run_end(self, wrapper):
        with open(os.path.join(os.path.dirname(__file__), "ran"), "w") as fh:
            fh.write(str(len(wrapper.tx_contexts)))
'''


def _torch_cli_b(path):
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch.analysis import SymExecWrapper, fire_lasers
    from mythril_tpu_torch.config import TEST_LIMITS
    from torch_port_fixtures import wrapper_doc

    res = {"strategies": _strategy_runs(STRATEGIES[3:])}
    d = os.path.join(os.path.dirname(str(path)), "ckpt")
    code = read_hex(arith_file())
    kw = dict(limits=TEST_LIMITS, lanes_per_contract=16, max_steps=192, device="cpu",
              deadline_chunk_steps=CHUNK)
    SymExecWrapper([code], contract_names=["MAIN"], transaction_count=1,
                   checkpoint_dir=d, **kw)
    # the rotated copy is the transaction's second-to-last seam: resume
    # mid-transaction, then run the second transaction as usual
    mid = os.path.join(d, "frontier.npz.1")
    res["ckpt_files"] = sorted(os.listdir(d))
    sym = SymExecWrapper([code], contract_names=["MAIN"], transaction_count=2,
                         resume_from=mid, **kw)
    res["resumed"] = wrapper_doc(fire_lasers(sym))
    pdir = os.path.join(os.path.dirname(str(path)), "plugins")
    os.makedirs(pdir)
    with open(os.path.join(pdir, "probe.py"), "w") as fh:
        fh.write(PLUGIN_SRC)
    res["detectors"] = _cli("list-detectors", "--plugin-dir", pdir)
    res["plugin_run"] = _cli("analyze", "-c", "6001600055", "--device", "cpu", "-o", "json",
                             "--plugin-dir", pdir, *ARITH_TEST_ARGS)
    marker = os.path.join(pdir, "ran")
    res["plugin_marker"] = open(marker).read() if os.path.exists(marker) else None
    torch_port_child.dump(res, path)


def runs(tmp_path_factory):
    """{"jax", "engine", "cli_a", "cli_b", "resume"} results, computed once
    per test session."""
    def compute():
        d = tmp_path_factory.mktemp("torch_port_policies")
        names = ("jax_engine", "jax", "engine", "cli_a", "cli_b")
        funcs = ("_jax_engine", "_jax_units", "_torch_engine", "_torch_cli_a", "_torch_cli_b")
        procs = {n: torch_port_child.start("torch_port_policies", f, d / f"{n}.pkl")
                 for n, f in zip(names, funcs)}
        got = {"jax_engine": torch_port_child.finish(procs.pop("jax_engine"),
                                                     d / "jax_engine.pkl")}
        # the JAX engine child wrote its checkpoint beside its result
        resume = torch_port_child.start("torch_port_policies", "_torch_resume", d / "resume.pkl")
        got.update({n: torch_port_child.finish(p, d / f"{n}.pkl") for n, p in procs.items()})
        got["resume"] = torch_port_child.finish(resume, d / "resume.pkl")
        got["jax"]["engine"] = got.pop("jax_engine")
        return got

    return torch_port_child.once("torch_port_policies", compute, tmp_path_factory)
