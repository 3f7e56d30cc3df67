"""The corpus campaign of the PyTorch port (``mythril_tpu_torch/mythril/
campaign.py``, ``resilience.py``, the JSON checkpoints, ``analyze
--corpus`` and ``campaign-merge``) against the JAX package's
``CorpusCampaign`` on the CPU.

The JAX results are pinned in ``tests/fixtures/torch_port/
campaign_test.json`` by ``JAX_PLATFORMS=cpu python
tests/torch_port_fixtures.py campaign_test`` (five golden contracts,
batches of 2 x 8 lanes, test limits, 64 steps, one transaction): every
case of ``torch_port_fixtures.CAMPAIGN_TEST_CASES`` (pipelined and
serial; a poison contract, a hang past the watchdog and an OOM, each
walked through retry, bisection, quarantine or the ladder), a run killed
at batch 2 and resumed from its checkpoint, the merge of two results and
the JAX CLI's ``--corpus`` output. The port runs the same cases in a
child process (``torch_port_child``). Each contract's issues and the
campaign's path coverage are held exactly, with the quarantine list,
the statuses, retries, the ladder's events and the solver's counts
(``chip_smoke.campaign_doc``)."""

import contextlib
import io
import json
import os
import tempfile

import pytest

import torch_port_child
import torch_port_fixtures as tpf

PINS = os.path.join(tpf.FIXTURE_DIR, "campaign_test.json")
CASES = [*tpf.CAMPAIGN_TEST_CASES, "resume"]


def _cli(argv):
    from mythril_tpu_torch.interfaces.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _compute(path):
    """Child process: every case through the port on the CPU, the merge of
    the pinned JAX results (library and CLI), the ``--corpus`` CLI."""
    torch_port_child.torch_single_thread()
    from mythril_tpu_torch import resilience
    from mythril_tpu_torch.config import TEST_LIMITS
    from mythril_tpu_torch.mythril import campaign

    tmp = tempfile.mkdtemp(prefix="torch_campaign_")
    res = {"runs": tpf.campaign_cases(campaign, resilience, TEST_LIMITS, tmp, device="cpu")}
    with open(PINS) as fh:
        runs = json.load(fh)["runs"]
    res["merge"] = campaign.merge_campaigns([runs["plain"], runs["raise"]])
    files = []
    for name in ("plain", "raise"):
        files.append(os.path.join(tmp, f"{name}.json"))
        with open(files[-1], "w") as fh:
            json.dump(runs[name], fh)
    rc, out = _cli(["campaign-merge", *files])
    res["merge_cli"] = (rc, json.loads(out))
    corpus_dir = os.path.join(tmp, "corpus")
    os.mkdir(corpus_dir)
    tpf.smoke().write_corpus(corpus_dir, tpf.campaign_test_corpus())
    rc, out = _cli(["analyze", "--corpus", corpus_dir, *tpf.CAMPAIGN_CLI_ARGS,
                    "--device", "cpu", "-o", "json"])
    res["cli"] = (rc, json.loads(out))
    res["cut"] = _cli(["analyze", "--corpus", corpus_dir, "--fleet", tmp, "--device", "cpu"])
    # a kernel launch's CUDA error, as its wrapper raises it, sorted
    from mythril_tpu_torch import kernels

    res["launch_errors"] = {}
    for code in (2, 700, 719, 1):
        try:
            kernels._raise_on(code, "fork_plan")
        except RuntimeError as e:
            res["launch_errors"][code] = resilience.classify_backend_error(e)
    torch_port_child.dump(res, path)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    return torch_port_child.run("test_torch_campaign", "_compute", tmp_path_factory)


@pytest.fixture(scope="module")
def pins():
    with open(PINS) as fh:
        return json.load(fh)


def doc(result):
    return tpf.smoke().campaign_doc(result)


@pytest.mark.parametrize("case", CASES)
def test_case_equals_the_jax_campaign(got, pins, case):
    assert doc(got["runs"][case]) == doc(pins["runs"][case])


def test_pipelined_serial_and_resumed_runs_equal_each_other(got, pins):
    runs = got["runs"]
    assert doc(runs["plain"]) == doc(runs["plain_serial"]) == doc(runs["resume"])
    # the killed run had checkpointed batches 0 and 1, as in JAX
    assert runs["resume"]["resumed_at_batch"] == pins["runs"]["resume"]["resumed_at_batch"] == 2


def test_faults_take_the_jax_recovery_paths(got):
    runs = {k: doc(v) for k, v in got["runs"].items()}
    assert runs["raise"]["quarantined"][0]["name"] == "c002"
    assert runs["raise"]["batch_status"][1] == "quarantined:1"
    assert runs["hang"]["batch_status"][1] == "ok-retry"
    assert runs["oom"]["batch_status"][1] == "ok-degraded:halve-batch"
    assert [(e["kind"], e.get("step")) for e in runs["oom"]["events"]] == [
        ("degrade", "halve-lanes"), ("degrade", "halve-batch"), ("degrade_ok", "halve-batch")]
    # the tier rung replays on the same device, as the JAX ladder's does
    # when the terminal tier is the only one
    assert runs["oom_tier"]["batch_status"][1] == "ok-degraded:next-tier"
    assert runs["oom_tier"]["events"][1]["width"] == runs["oom_tier"]["events"][0]["width"]


def test_merge_equals_the_jax_merge(got, pins):
    assert got["merge"] == pins["merge"]
    assert got["merge_cli"] == (0, pins["merge"])


def test_corpus_cli_equals_the_jax_cli(got, pins):
    rc, out = got["cli"]
    assert rc == 0
    assert doc(out) == doc(pins["cli"])
    assert out["batch_status"][1] == "ok-degraded:halve-lanes"


def test_fleet_flags_are_refused(got):
    rc, _ = got["cut"]
    assert rc == 2


def test_chip_smoke_campaign_pins_are_its_corpus():
    # chip_smoke.py's phase 11 holds its runs to campaign_default.json:
    # the corpus and the arguments it runs must be the pinned ones
    import hashlib

    sm = tpf.smoke()
    with open(os.path.join(tpf.FIXTURE_DIR, "campaign_default.json")) as fh:
        pin = json.load(fh)
    h = hashlib.sha256()
    for name, code in sm.campaign_corpus():
        h.update(name.encode() + b"\0" + hashlib.sha256(code).digest())
    assert pin["corpus"] == h.hexdigest()[:16]
    assert (pin["args"], pin["oom_args"]) == (list(sm.CAMPAIGN_ARGS), list(sm.CAMPAIGN_OOM))
    assert len(sm.campaign_corpus()) == 96 and pin["plain"]["batches"] == 3


def test_card_errors_are_classified(got):
    from mythril_tpu_torch.resilience import (DeviceLostError, ResourceExhausted,
                                              classify_backend_error)

    class OutOfMemoryError(RuntimeError):  # torch.cuda.OutOfMemoryError's name
        pass

    class KernelBuildError(RuntimeError):  # kernels.KernelBuildError's name
        pass

    assert classify_backend_error(OutOfMemoryError("CUDA out of memory. Tried to allocate")) == "oom"
    assert classify_backend_error(ResourceExhausted("x")) == "oom"
    assert classify_backend_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "device-lost"
    assert classify_backend_error(DeviceLostError("x")) == "device-lost"
    assert classify_backend_error(KernelBuildError("nvcc failed for fork_plan")) == "compile"
    assert classify_backend_error(ValueError("expected a contiguous tensor")) is None
    assert got["launch_errors"] == {2: "oom", 700: "device-lost", 719: "device-lost", 1: None}


def test_the_card_ladder():
    from mythril_tpu_torch.config import DEFAULT_RESILIENCE
    from mythril_tpu_torch.resilience import parse_ladder

    # the card is the only tier, its floor: the default ends at batching
    assert parse_ladder(None) == DEFAULT_RESILIENCE.oom_ladder == ("halve-lanes", "halve-batch")
    assert parse_ladder("halve-lanes,cpu") == ("halve-lanes", "next-tier")
    assert parse_ladder("none") == ()
    with pytest.raises(ValueError):
        parse_ladder("halve-lanes,gpu")
