"""The port's multi-process cohort driver with shard_export on the CPU
(gloo): the counterparts of tests/test_multihost.py's sharded-export and
writer-crash cases.

Each rank is its own process (tests/_torch_multihost_driver_worker.py).
Four ranks where the case is which rank writes (6 subjects over an 8-lane
batch: ranks 0-2 own them, rank 3 owns padding); two where it is not.
"""
import json
import re
import time

import pytest

from test_torch_multihost_cohort import finish, start, write_manifest


def test_four_rank_sharded_export(tmp_path):
    """Each owning rank writes its own lanes, stamped with its rank; every
    subject is exported once; the metrics equal the process-0 export's
    lane for lane (checked in each worker), on every rank; the files equal
    the process-0 export's byte for byte, but for the stamp."""
    manifest = write_manifest(tmp_path, 6, seed0=50)
    recs = finish(start(tmp_path, "shard", world=4))
    assert len({json.dumps(r["results"], sort_keys=True)
                for r in recs}) == 1
    exporters = set()
    for e in manifest:
        sid = e["id"]
        sdir, p0 = tmp_path / "out" / sid, tmp_path / "out_p0" / sid
        assert (sdir / ".done").exists()
        m = json.loads((sdir / "metrics.json").read_text())
        assert m["valid"]
        exporters.add(m.pop("export_process"))
        want = json.loads((p0 / "metrics.json").read_text())
        assert json.dumps(m, sort_keys=True) == json.dumps(want,
                                                           sort_keys=True)
        for f in (f"{sid}_dataArray.nii", f"{sid}.json"):
            assert (sdir / f).read_bytes() == (p0 / f).read_bytes(), f
    assert exporters == {0, 1, 2}, exporters


def test_two_rank_shard_export_writer_crash(tmp_path):
    """Rank 1 dies mid-file on its second owned lane: that lane has a torn
    NIfTI, no metrics.json and no .done; a fresh run re-exports it with a
    readable NIfTI and leaves every lane made durable before the crash, by
    either writer, untouched."""
    from ventjax_torch.io import nifti

    manifest = write_manifest(tmp_path, 8, seed0=200)
    out = tmp_path / "out"
    procs = start(tmp_path, "torn", crash_rank=1)
    try:
        out1, _ = procs[1].communicate(timeout=120)
        assert procs[1].returncode == 43, out1
        torn = re.findall(r"TORN (\S+)", out1)
        wrote = re.findall(r"WROTE (\S+)", out1)
        assert len(torn) == 1 and len(wrote) == 1, out1
        time.sleep(2)   # rank 0's writers settle their lanes
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    tdir = out / torn[0]
    assert (tdir / f"{torn[0]}_dataArray.nii").exists()
    assert not (tdir / ".done").exists()
    assert not (tdir / "metrics.json").exists()
    with pytest.raises(ValueError):
        nifti.load(str(tdir / f"{torn[0]}_dataArray.nii"))
    durable = [e["id"] for e in manifest if (out / e["id"] / ".done").exists()]
    assert wrote[0] in durable
    mtimes = {s: (out / s / "metrics.json").stat().st_mtime_ns
              for s in durable}

    finish(start(tmp_path, "once-shard"))
    for e in manifest:
        sid = e["id"]
        assert (out / sid / ".done").exists(), sid
        assert json.loads((out / sid / "metrics.json").read_text())["valid"]
        data, _ = nifti.load(str(out / sid / f"{sid}_dataArray.nii"))
        assert data.shape == (32, 32, 8, 6), sid
    for s, t in mtimes.items():
        assert (out / s / "metrics.json").stat().st_mtime_ns == t, s


CLI_RANK = """
import builtins, json, os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from ventjax_torch.cli import main
written, real_open = [], builtins.open

def spy(path, mode="r", *a, **kw):
    if "w" in mode and os.path.basename(str(path)).startswith("cohort_"):
        written.append(os.path.basename(str(path)))
    return real_open(path, mode, *a, **kw)

builtins.open = spy
rc = main({argv!r})
builtins.open = real_open
import torch.distributed as tdist
print("CLI_RANK " + json.dumps({{"rc": rc, "written": sorted(written),
                                 "initialized": tdist.is_initialized()}}))
"""


def test_cli_cohort_shard_export_under_torchrun_env(tmp_path):
    """``cohort --mesh --shard-export`` in two processes with torchrun's
    variables: both ranks exit 0 and print the result line, the group is
    torn down, each rank exports its own lanes, and only rank 0 writes the
    aggregate files."""
    import os
    import subprocess
    import sys

    from test_torch_multihost_cohort import _free_port

    manifest = write_manifest(tmp_path, 4, seed0=30)
    out = tmp_path / "out"
    argv = ["cohort", "--manifest", str(tmp_path / "manifest.json"),
            "--out", str(out), "--batch", "4", "--mesh", "--shard-export",
            "--device", "cpu", "--max-defect", "1024"]
    code = CLI_RANK.format(root=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), argv=argv)
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{o}"
        line = next(x for x in o.splitlines() if x.startswith("CLI_RANK "))
        recs.append(json.loads(line[len("CLI_RANK "):]))
        assert json.loads(next(x for x in o.splitlines() if x.startswith(
            '{"subjects"'))) == {"subjects": 4, "valid": 4, "out": str(out)}
    assert [r["rc"] for r in recs] == [0, 0]
    assert not any(r["initialized"] for r in recs)
    assert recs[0]["written"] == ["cohort_metrics.csv", "cohort_summary.json"]
    assert recs[1]["written"] == []
    stamps = {json.loads((out / e["id"] / "metrics.json").read_text())[
        "export_process"] for e in manifest}
    assert stamps == {0, 1}
