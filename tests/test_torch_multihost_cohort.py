"""The port's multi-process cohort driver on the CPU (gloo): the
counterparts of tests/test_multihost.py's driver cases.

Each rank is its own process (tests/_torch_multihost_driver_worker.py),
running run_cohort(use_mesh=True) over a RankMesh of two ranks with
process-0 export: a run that resumes to a no-op with every subject
exported once, held within 0.1 pp of ventjax's one-process run_cohort on
the same written studies; and a rank that dies after the first batch, after
which a fresh run resumes past it without rewriting it.
"""
import json
import os
import socket
import subprocess
import sys
import time


HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_multihost_driver_worker.py")
SHAPE, VOX = (32, 32, 8), (1.5, 1.5, 10.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_manifest(workdir, n, seed0):
    from ventjax_torch.io.synthetic import write_study

    manifest = []
    for i in range(n):
        root = os.path.join(workdir, f"study{i}")
        write_study(root, shape=SHAPE, vox=VOX, seed=seed0 + i,
                    with_proton=False)
        manifest.append({"id": f"s{i:02d}", "xenon": f"{root}/xenon.dcm",
                         "mask": f"{root}/mask"})
    with open(os.path.join(workdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def start(workdir, mode, world=2, crash_rank=-1):
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, WORKER, port, str(r), str(world), str(workdir),
         mode, str(crash_rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(procs, timeout=120):
    """Each rank's DRIVER_OK record; kills what still runs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        line = next(x for x in out.splitlines() if x.startswith("DRIVER_OK"))
        recs.append(json.loads(line[len("DRIVER_OK "):]))
    return recs


def test_two_rank_driver_resumes_and_matches_ventjax(tmp_path):
    """Two ranks, process-0 export: every subject exported once, the
    second call a no-op, the ranks' metrics identical, and within 0.1 pp
    of ventjax's one-process run_cohort on the same studies."""
    from ventjax.config import DEFAULT_CONFIG
    from ventjax.pipeline.cohort import run_cohort

    manifest = write_manifest(tmp_path, 6, seed0=50)
    procs = start(tmp_path, "resume")
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, ci_rmax=12,
                                 n4_fitting_levels=2, n4_max_iters=10)
    ref = {r["id"]: r for r in run_cohort(
        manifest, str(tmp_path / "ventjax"), config=cfg, batch_size=4,
        use_mesh=False, compact_export=False)}
    recs = finish(procs)
    assert json.dumps(recs[0]["results"], sort_keys=True) == json.dumps(
        recs[1]["results"], sort_keys=True)
    for e in manifest:
        sdir = tmp_path / "out" / e["id"]
        assert (sdir / ".done").exists()
        got = json.loads((sdir / "metrics.json").read_text())
        assert got["valid"] and "export_process" not in got
        for key in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(got[key] - ref[e["id"]][key]) < 0.1, (e["id"], key)
            assert recs[1]["results"][e["id"]][key] == got[key]


def test_two_rank_driver_recovers_from_a_dead_rank(tmp_path):
    """Rank 1 dies after the first batch is durable; the batch stays
    exported, the second is not complete, and a fresh two-rank run
    finishes every subject without rewriting the first batch."""
    manifest = write_manifest(tmp_path, 8, seed0=80)
    first = [e["id"] for e in manifest[:4]]
    out = tmp_path / "out"
    procs = start(tmp_path, "crash", crash_rank=1)
    try:
        out1, _ = procs[1].communicate(timeout=120)
        assert procs[1].returncode == 42, out1
        assert "CRASH_NOW" in out1
    finally:
        # rank 0 errors or waits in the second batch's gather: stop it
        time.sleep(1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert all((out / s / ".done").exists() for s in first)
    assert not all((out / e["id"] / ".done").exists()
                   for e in manifest[4:])
    mtimes = {s: (out / s / "metrics.json").stat().st_mtime_ns
              for s in first}

    finish(start(tmp_path, "once"))
    for e in manifest:
        sdir = out / e["id"]
        assert (sdir / ".done").exists(), e["id"]
        assert json.loads((sdir / "metrics.json").read_text())["valid"]
    for s, t in mtimes.items():
        assert (out / s / "metrics.json").stat().st_mtime_ns == t, s


def test_done_flags_come_from_rank_zero(tmp_path):
    """Only rank 0 sees the finished output root (rank 1 passes an empty
    one): rank 0's broadcast done flags make rank 1 skip every subject
    too, answering {"id": ..., "resumed": True} for the metrics it cannot
    read, and no rank analyses anything."""
    manifest = write_manifest(tmp_path, 4, seed0=90)
    finish(start(tmp_path, "once"))
    r0, r1 = finish(start(tmp_path, "view0"))
    ids = [e["id"] for e in manifest]
    assert sorted(r0["results"]) == sorted(r1["results"]) == sorted(ids)
    assert all(r0["results"][s]["valid"] for s in ids)
    assert all(r1["results"][s] == {"id": s, "resumed": True} for s in ids)
    # the broadcast alone: nothing was gathered, no barrier
    assert r0["collectives"] == r1["collectives"] == 1
