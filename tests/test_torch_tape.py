"""The plain version of kernel K3 (hash-consed tape append) against the
JAX package's ``append_node`` on a seeded frontier: dedup hits, fresh
rows, masked lanes, a full tape (overflow) and forged fingerprint
collisions (exact). Both packages run in a child process
(``torch_port_child``); each step's differences come back as lists."""

import dataclasses

import numpy as np
import pytest

import torch_port_child

P = 8
SEEDS = [0, 1, 2]
STEPS = 12
TAPE_FIELDS = ("tape_op", "tape_a", "tape_b", "tape_imm", "tape_hash", "tape_len")


def _rows(rng, n_fresh):
    op = rng.integers(1, 29, P).astype(np.int32)
    a = rng.integers(0, 40, P).astype(np.int32)
    b = rng.integers(0, 40, P).astype(np.int32)
    imm = np.zeros((P, 8), dtype=np.uint32)
    imm[:, 0] = rng.integers(0, 3, P)
    imm[:n_fresh, 7] = rng.integers(0, 2**32, n_fresh, dtype=np.uint64)
    mask = rng.random(P) < 0.75
    return op, a, b, imm, mask


def group_cases(rng):
    """K3's group at the engine's two call sites and at the edges, as
    numpy rows (mask, op, a, b, a_src, b_src: [P, R]; imm [P, R, 8] u32):

    - chain: the SHA3 chain (seed, 8 absorbs on the chain so far, the
      digest), rows masked off mid-chain (windows of 0-8 words) and lanes
      with no chain;
    - binop: CONST, CONST and the node on their outputs, with unary lanes
      (b literal 0) and zero constants (no CONST row);
    - duplicate: rows repeating an earlier row of their group, literally
      and through the same reference.

    Lane 0's tape has room for two rows: it overflows mid-group."""
    from mythril_tpu_torch.symbolic.ops import SymOp

    def words(shape, p_zero):
        w = rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(np.uint32)
        w[rng.random(shape) < p_zero] = 0
        return w

    rows = lambda vals: np.tile(np.asarray(vals, np.int32), (P, 1))
    cases = {}
    m_chain = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    nw = np.array([8, 3, 5, 0, 8, 1, 2, 6])
    mask = np.zeros((P, 10), bool)
    mask[:, 0] = mask[:, 9] = m_chain
    mask[:, 1:9] = m_chain[:, None] & (np.arange(8)[None, :] < nw[:, None])
    b = np.zeros((P, 10), np.int32)
    b[:, 1:9] = rng.integers(1, 30, (P, 8)) * (rng.random((P, 8)) < 0.5)
    imm = np.zeros((P, 10, 8), np.uint32)
    imm[:, 0, 0], imm[:, 0, 1] = rng.integers(1, 201, P), rng.integers(0, 32, P)
    imm[:, 1:9] = np.where((b[:, 1:9] == 0)[..., None], words((P, 8), 0.2), 0)
    cases["chain"] = (mask, rows([int(SymOp.KECCAK_SEED)] + [int(SymOp.KECCAK_ABS)] * 8
                                 + [int(SymOp.KECCAK)]), np.zeros((P, 10), np.int32), b,
                      rows([-1] + list(range(9))), rows([-1] * 10), imm)
    node = np.array([3, 5, 17, 16, 21, 18, 4, 12], np.int32)  # ISZERO, NOT unary
    unary = np.isin(node, [17, 21])
    s0 = np.array([0, 0, 7, 0, 0, 9, 0, 3], np.int32)
    s1 = np.array([0, 5, 0, 0, 4, 0, 0, 0], np.int32)
    a0, a1 = words((P,), 0.0), words((P,), 0.0)
    a0[3] = a1[6] = 0  # zero constants: no CONST row
    m_node = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    need_a = m_node & (s0 == 0) & a0.any(axis=1)
    need_b = m_node & ~unary & (s1 == 0) & a1.any(axis=1)
    cases["binop"] = (np.stack([need_a, need_b, m_node], 1),
                      np.stack([np.ones(P, np.int32), np.ones(P, np.int32), node], 1),
                      np.stack([s0, np.where(unary, 0, s1), np.zeros(P, np.int32)], 1),
                      np.zeros((P, 3), np.int32), rows([-1, -1, 0]), rows([-1, -1, 1]),
                      np.stack([a0, a1, np.zeros_like(a0)], 1))
    a = np.stack([rng.integers(0, 2**20, P)] * 2 + [np.zeros(P)] * 3, 1).astype(np.int32)
    imm = np.zeros((P, 5, 8), np.uint32)
    imm[:, 0] = imm[:, 1] = words((P,), 0.0)
    imm[:, 2] = imm[:, 3] = words((P,), 0.0)
    mask = rng.random((P, 5)) < 0.85
    mask[0] = True
    cases["duplicate"] = (mask, rows([29, 29, 30, 30, 31]), a,
                          np.tile(rng.integers(0, 40, (P, 1)), (1, 5)).astype(np.int32),
                          rows([-1, -1, 0, 1, 3]), rows([-1, -1, -1, -1, 2]), imm)
    return cases


def _compute(path):
    """Child process: append sequences through both packages."""
    torch = torch_port_child.torch_single_thread()
    import mythril_tpu  # noqa: F401
    import jax.numpy as jnp
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.symbolic.engine import append_node as jax_append
    from mythril_tpu.symbolic.state import make_sym_frontier as jax_make, tape_row_hash
    from mythril_tpu_torch.symbolic.engine import append_group, append_node
    from mythril_tpu_torch.symbolic.state import SymFrontier

    def seeded(room=0):
        sf = jax_make(P, TEST_LIMITS)
        tl = np.asarray(sf.tape_len).copy()
        # lane 0: a full tape (but ``room`` rows), fresh rows overflow
        tl[0] = TEST_LIMITS.tape_len - room
        return sf.replace(tape_len=jnp.asarray(tl))

    def differing(jsf, tsf):
        host = tsf.to_numpy()
        bad = [n for n in TAPE_FIELDS
               if not np.array_equal(getattr(host, n), np.asarray(getattr(jsf, n)))
               or getattr(host, n).dtype != np.asarray(getattr(jsf, n)).dtype]
        for n in ("err_code", "error"):
            if not np.array_equal(getattr(host.base, n), np.asarray(getattr(jsf.base, n))):
                bad.append("base." + n)
        return bad

    out = {}
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        jsf = seeded()
        tsf = SymFrontier.from_numpy(jsf, "cpu")
        steps = [("start", differing(jsf, tsf), True, True)]
        history = []
        for step in range(STEPS):
            if history and step % 3 == 2:
                op, a, b, imm, mask = history[int(rng.integers(0, len(history)))]  # dedup hits
            else:
                op, a, b, imm, mask = _rows(rng, n_fresh=P // 2)
            if step == 6:
                # forged collision: a live row of lanes 1..3 carries the next
                # row's fingerprint with other content -> missed dedup
                h = np.asarray(tape_row_hash(jnp.asarray(op), jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(imm)))
                th = np.asarray(jsf.tape_hash).copy()
                th[1:4, 3] = h[1:4]
                jsf = jsf.replace(tape_hash=jnp.asarray(th))
                tsf = tsf.replace(tape_hash=torch.as_tensor(th.view(np.int32).copy()))
                mask = mask.copy()
                mask[1:4] = True
            history.append((op, a, b, imm, mask))
            jsf, jids = jax_append(jsf, jnp.asarray(mask), jnp.asarray(op), jnp.asarray(a),
                                   jnp.asarray(b), jnp.asarray(imm))
            tsf, tids = append_node(tsf, torch.as_tensor(mask), torch.as_tensor(op),
                                    torch.as_tensor(a), torch.as_tensor(b),
                                    torch.as_tensor(imm.astype(np.int64)))
            steps.append((step, differing(jsf, tsf),
                          bool(np.array_equal(tids.numpy(), np.asarray(jids))),
                          bool((tids.numpy()[~mask] == 0).all())))
        out["seed", seed] = (steps, int(np.asarray(jsf.base.err_code)[0]),
                             int(tsf.base.err_code[0]))

    jsf = seeded()
    tsf = SymFrontier.from_numpy(jsf, "cpu")
    mask = np.array([True, False] * (P // 2))
    jsf, jids = jax_append(jsf, jnp.asarray(mask), 2, 12, jnp.arange(P, dtype=jnp.int32))
    tsf, tids = append_node(tsf, torch.as_tensor(mask), 2, 12,
                            torch.arange(P, dtype=torch.int32))
    out["scalar"] = (bool(np.array_equal(tids.numpy(), np.asarray(jids))), differing(jsf, tsf))

    jsf = seeded()
    host = SymFrontier.from_numpy(jsf, "cpu").to_numpy()
    out["round_trip"] = [
        fl.name for fl in dataclasses.fields(host) if fl.name != "base"
        and (getattr(host, fl.name).dtype != np.asarray(getattr(jsf, fl.name)).dtype
             or not np.array_equal(getattr(host, fl.name), np.asarray(getattr(jsf, fl.name))))]

    def jax_group(jsf, mask, op, a, b, a_src, b_src, imm):
        """The group's rows as sequential JAX appends: row r's operand is
        the output of row a_src (0 <= a_src < r) or the literal; a row's
        output is its id where masked in, its resolved a where not."""
        outs = []
        for r in range(op.shape[1]):
            def resolve(lit, src):
                if not r:
                    return lit
                prev = np.stack(outs, 1)[np.arange(P), np.clip(src, 0, r - 1)]
                return np.where((src >= 0) & (src < r), prev, lit).astype(np.int32)

            ar, br = resolve(a[:, r], a_src[:, r]), resolve(b[:, r], b_src[:, r])
            jsf, jids = jax_append(jsf, jnp.asarray(mask[:, r]), jnp.asarray(op[:, r]),
                                   jnp.asarray(ar), jnp.asarray(br), jnp.asarray(imm[:, r]))
            outs.append(np.where(mask[:, r], np.asarray(jids), ar).astype(np.int32))
        return jsf, np.stack(outs, 1)

    for case, rows in group_cases(np.random.default_rng(11)).items():
        jsf = seeded(room=2)
        tsf = SymFrontier.from_numpy(jsf, "cpu")
        jsf, jout = jax_group(jsf, *rows)
        mask, op, a, b, a_src, b_src, imm = rows
        tsf, tout = append_group(tsf, *(torch.as_tensor(x) for x in (
            mask, op, a, b, a_src, b_src, imm.astype(np.int64))))
        # lanes (but the overflowing lane 0) where row 1 repeats a masked-in row 0
        both = mask[1:, 0] & mask[1:, 1]
        out["group", case] = (differing(jsf, tsf), bool(np.array_equal(tout.numpy(), jout)),
                              int(np.asarray(jsf.base.err_code)[0]),
                              np.asarray(jsf.tape_len) - np.asarray(seeded(room=2).tape_len),
                              both, jout[1:, 1][both] == jout[1:, 0][both])

    out["cuda"] = None
    if torch.cuda.is_available():
        rng = np.random.default_rng(5)
        cpu = SymFrontier.from_numpy(seeded(), "cpu")
        gpu = SymFrontier.from_numpy(seeded(), "cuda")
        same = True
        for _ in range(6):
            op, a, b, imm, mask = _rows(rng, n_fresh=P // 2)
            args = [torch.as_tensor(x) for x in (mask, op, a, b, imm.astype(np.int64))]
            cpu, c_ids = append_node(cpu, *args)
            gpu, g_ids = append_node(gpu, *[x.cuda() for x in args])
            same = same and bool(torch.equal(c_ids, g_ids.cpu()))
        out["cuda"] = same and all(torch.equal(getattr(cpu, n), getattr(gpu, n).cpu())
                                   for n in TAPE_FIELDS)
    torch_port_child.dump(out, path)


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_port_child.run("test_torch_tape", "_compute", tmp_path_factory)


@pytest.mark.parametrize("seed", SEEDS)
def test_append_sequence_matches_jax(res, seed):
    steps, jax_err0, torch_err0 = res["seed", seed]
    assert len(steps) == STEPS + 1
    for step, bad, ids_equal, masked_zero in steps:
        assert bad == [], f"step {step}"
        assert ids_equal and masked_zero, f"step {step}"
    # the full tape overflowed into a TAPE_LIMIT trap on both sides
    assert jax_err0 == torch_err0 == 8


def test_scalar_operands_broadcast_like_jax(res):
    ids_equal, bad = res["scalar"]
    assert ids_equal and bad == []


def test_frontier_round_trips_through_numpy(res):
    assert res["round_trip"] == []


@pytest.mark.parametrize("case", ["chain", "binop", "duplicate"])
def test_group_plain_matches_jax_append_sequence(res, case):
    bad, outs_equal, err0, grown, both, same = res["group", case]
    assert bad == [] and outs_equal
    # lane 0 had room for two rows: it overflowed mid-group into one
    # TAPE_LIMIT trap, as the sequential traps attribute it
    assert err0 == 8 and grown[0] == 2
    if case == "duplicate":
        # row 1 repeats row 0 of its group: a dedup hit, the same id
        assert both.any() and same.all()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(res):
    if res["cuda"] is None:
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert res["cuda"]
