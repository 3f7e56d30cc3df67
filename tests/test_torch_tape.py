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


def _compute(path):
    """Child process: append sequences through both packages."""
    torch = torch_port_child.torch_single_thread()
    import mythril_tpu  # noqa: F401
    import jax.numpy as jnp
    from mythril_tpu.config import TEST_LIMITS
    from mythril_tpu.symbolic.engine import append_node as jax_append
    from mythril_tpu.symbolic.state import make_sym_frontier as jax_make, tape_row_hash
    from mythril_tpu_torch.symbolic.engine import append_node
    from mythril_tpu_torch.symbolic.state import SymFrontier

    def seeded():
        sf = jax_make(P, TEST_LIMITS)
        tl = np.asarray(sf.tape_len).copy()
        tl[0] = TEST_LIMITS.tape_len  # lane 0: a full tape, fresh rows overflow
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(res):
    if res["cuda"] is None:
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert res["cuda"]
