"""The rank runner (``portbench/ranks.py``) on the CPU over gloo.

Two ranks of a tiny cell give one correct line, their pool digests agree,
and their lanes are bit-equal to the one-process run of the same pool
batches; a fault in the exchange between the ranks, or on one rank, is
not correct; a rank that raises, dies or hangs ends the run non-zero with
no line, within the group's timeout.  Breakers run in the rank processes,
which import them from this module by name.
"""
import json
import os
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ventjax_torch.pipeline.analyze as A
from portbench import devtrace, harness, ranks
from portbench.compare import MAPS
from portbench.generate import make_studies
from portbench.tests import test_portbench_faults as faults
from portbench.tests._tiny import ROOT, make_root

CELL = "tiny.ranks2"
DUMP = "PORTBENCH_TEST_DUMP"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root plus a mix of four studies a call (two a rank) and a
    cell of two ranks, listed by every per-layer metric."""
    root = make_root(tmp_path_factory.mktemp("ranks"))
    mix = json.loads((root / "portbench/traffic/tiny.json").read_text())
    mix.update(name="tiny4", studies_per_call=4, pool_studies=8)
    (root / "portbench/traffic/tiny4.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tiny4", "chips": 2,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_ranks(root, capfd, seed, trace=0, breaker=None, seconds=1.0):
    """(exit code, the result line or None, standard error) of a run of the
    two-rank cell; the ranks write to the file descriptors, so ``capfd``."""
    rc = harness.run(["--workload", CELL, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)], device="cpu",
                     root=root, breaker=breaker)
    out, err = capfd.readouterr()
    lines = [l for l in out.splitlines() if l.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


# -------------------------------------------------- breakers (rank side)

def dump_outputs(cell):
    """Each rank saves its set-up output of every pool batch."""
    flat = {}
    for b, out in cell.outputs.items():
        for k in MAPS:
            flat[f"{b}.{k}"] = out[k].numpy()
        for k, v in out["metrics"].items():
            flat[f"{b}.m.{k}"] = v.numpy()
    np.savez(Path(os.environ[DUMP]) / f"rank{cell.mesh.index}.npz", **flat)


def exchange_left_out(cell):
    """The batch's metrics are not exchanged: each rank's gathered batch
    holds its own rows in every rank's place (the harness's stop flag
    still travels)."""
    real = cell.gather

    def broken(t):
        every = real(t)
        if t.dim() == 2 and t.dtype == torch.float32:
            mine = t.repeat(cell.mesh.size, 1)
            mine[:, -1] = every[:, -1]
            return mine
        return every
    cell.gather = broken


def n4_state_unchanged_on_rank1(cell):
    if cell.mesh.index != 1:
        return
    real = A.n4_bias_correction

    def broken(image, mask, **kw):
        n4, ovf, (idx, _, wv) = real(image, mask, **kw)
        raw = image.reshape(image.shape[0], -1).gather(1, idx)
        return image.to(torch.float32), ovf, (idx, raw, wv)
    A.n4_bias_correction = broken


def half_batch_left_out_on_rank1(cell):
    if cell.mesh.index == 1:
        faults.half_batch_left_out(cell)


def vdp_answer_altered_on_rank1(cell):
    if cell.mesh.index == 1:
        faults.vdp_answer_altered(cell)


def _on_rank1_at_call3(cell, act):
    if cell.mesh.index != 1:
        return
    real, n = cell.call, [0]

    def broken(b):
        n[0] += 1
        if n[0] == 3:
            act()
        return real(b)
    cell.call = broken


def _raise():
    raise RuntimeError("a rank fails mid-window")


def rank_raises(cell):
    _on_rank1_at_call3(cell, _raise)


def rank_dies(cell):
    _on_rank1_at_call3(cell, lambda: os._exit(9))


def rank_hangs(cell):
    _on_rank1_at_call3(cell, lambda: time.sleep(600))


# ------------------------------------------------------------------ tests

def test_two_ranks_are_correct_and_bit_equal_to_one_process(
        root, capfd, tmp_path, monkeypatch):
    monkeypatch.setenv(DUMP, str(tmp_path))
    seed = 2 ** 31 + 17
    rc, res, err = run_ranks(root, capfd, seed, breaker=dump_outputs)
    assert rc == 0, err
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0
    assert set(res["metrics"]) == {"studies_per_s", "latency_ms_p95",
                                   "peak_mem_mib", "setup_s"}
    assert res["device"]["count"] == 2
    assert res["device"]["host_cpus"] == os.cpu_count()
    assert len(res["device"]["rank_cpus"]) == 2
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(l.startswith("check ") for l in tail)

    # the pool's digests agree, and are the pool's
    digests = dict(re.findall(r"rank (\d): pool digest ([0-9a-f]+)", err))
    spec = harness.load_cell(root, CELL)
    hp, mask = make_studies(8, tuple(spec.config["shape"]),
                            spec.config["vox"], seed, "cpu",
                            **spec.traffic["phantom"])
    assert digests == {"0": ranks.pool_digest(hp, mask),
                       "1": ranks.pool_digest(hp, mask)}

    # each rank's lanes bit-equal to the one-process run at the same pads
    one = harness.Cell(spec, seed, "cpu")
    for r in (0, 1):
        got = np.load(tmp_path / f"rank{r}.npz")
        for b, out in one.outputs.items():
            for k in MAPS:
                np.testing.assert_array_equal(
                    got[f"{b}.{k}"], out[k].numpy()[2 * r:2 * r + 2])
            for k, v in out["metrics"].items():
                np.testing.assert_array_equal(
                    got[f"{b}.m.{k}"], v.numpy()[2 * r:2 * r + 2])


def test_traced_run_over_two_ranks(root, capfd, monkeypatch):
    # a short traced window: reading a CPU session's events is slow
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.3)
    rc, res, err = run_ranks(root, capfd, seed=31, trace=1)
    assert rc == 0, err
    assert res["correct"] is True
    assert "breakdown" in res
    assert res["device"]["window_s"] > 0
    assert "studies_per_s" not in res["metrics"]


@pytest.mark.parametrize("fault,caught_by", [
    (exchange_left_out, "snr_rel"),
    (n4_state_unchanged_on_rank1, "n4_rel"),
    (half_batch_left_out_on_rank1, "snr_rel"),
    (vdp_answer_altered_on_rank1, "vdp_pp")])
def test_fault_over_ranks_is_not_correct(root, capfd, fault, caught_by):
    rc, res, err = run_ranks(root, capfd, seed=23, breaker=fault,
                             seconds=0.5)
    assert rc == 0, err
    assert res["correct"] is False
    failed = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert caught_by in failed and "repeat_diff" in failed, res["checks"]


@pytest.mark.parametrize("fault", [rank_raises, rank_dies, rank_hangs])
def test_a_rank_that_fails_ends_the_run_without_a_line(
        root, capfd, monkeypatch, fault):
    monkeypatch.setattr(ranks, "GROUP_TIMEOUT_S", 5.0)
    t0 = time.time()
    rc, res, err = run_ranks(root, capfd, seed=29, breaker=fault,
                             seconds=30.0)
    assert rc != 0 and res is None
    # set-up, the failure and the group's timeout, well before the window
    # of 30 s would have closed
    assert time.time() - t0 < 28, err
    assert "no result" in err


def test_nccl_ms_per_call():
    read = harness.load_reader(ROOT, "nccl_ms_per_call")
    dev = [("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
            100.0, 400.0),
           ("ncclKernel_AllGather_RING_LL_Sum_int8_t", 600.0, 700.0),
           ("moment_partial", 0.0, 900.0)]
    trace = devtrace.Trace(window=(0.0, 1000.0), device=dev, host=[])
    ctx = SimpleNamespace(trace=trace, calls=[0, 1])
    assert read(ctx) == pytest.approx(400e-3 / 2)
    trace.device = dev[2:]
    assert read(ctx) is None
