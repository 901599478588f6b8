"""One rank of the port's multi-process cohort-driver tests.

Usage: python tests/_torch_multihost_driver_worker.py <port> <rank> <world>
       <workdir> <mode> [<crash_rank>]

<world> processes join a torch.distributed group (gloo, on the CPU)
through ventjax_torch.dist.initialize_multihost and call run_cohort on
<workdir>/manifest.json with use_mesh (one RankMesh shard per rank, two
lanes each) and batch_size 2 * world.  Modes:

- ``resume``: process-0 export into <workdir>/out, then a second call that
  must resume to a no-op (rank 0: nothing rewritten);
- ``shard``: shard_export into <workdir>/out, a second call that must
  resume to a no-op (every rank: nothing rewritten, by any rank), then
  process-0 export into <workdir>/out_p0; the metrics must agree lane for
  lane;
- ``crash``: process-0 export; rank <crash_rank> waits until the first
  batch is durable (its .done markers) and dies with exit code 42;
- ``torn``: shard_export; rank <crash_rank> writes its first owned lane,
  then dies mid-file on its second (a torn NIfTI under the real name,
  ``WROTE``/``TORN`` lines, exit code 43);
- ``once`` / ``once-shard``: one call (the recovery pass);
- ``view0``: one call where only rank 0 sees <workdir>/out (the other ranks
  pass an empty directory of their own): rank 0's done markers decide for
  every rank, and the ranks that cannot read a done subject's metrics
  answer ``{"id": ..., "resumed": True}``.

Every rank checks that each torch.distributed collective of run_cohort was
issued from the dispatch (main) thread, and prints one DRIVER_OK line with
its rank, its results by id and its collective count.
"""
import json
import os
import sys
import threading
import time

port, rank, world, workdir, mode = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    sys.argv[5])
crash_rank = int(sys.argv[6]) if len(sys.argv) > 6 else -1
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.dist import initialize_multihost  # noqa: E402
from ventjax_torch.pipeline import cohort as C  # noqa: E402

torch.set_num_threads(2)
collectives = []


def _on_dispatch_thread(fn):
    def wrapped(*args, **kw):
        collectives.append(threading.current_thread() is
                           threading.main_thread())
        return fn(*args, **kw)
    return wrapped


for name in ("all_gather", "broadcast", "barrier"):
    setattr(tdist, name, _on_dispatch_thread(getattr(tdist, name)))

initialize_multihost(f"localhost:{port}", num_processes=world,
                     process_id=rank)
manifest = C.load_manifest(os.path.join(workdir, "manifest.json"))
out = os.path.join(workdir, "out")
cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, ci_rmax=12,
                             n4_fitting_levels=2, n4_max_iters=10)
bs = 2 * world


def run(out_dir, shard=False, progress=None):
    return C.run_cohort(manifest, out_dir, config=cfg, batch_size=bs,
                        device="cpu", use_mesh=True, shard_export=shard,
                        progress=progress, export_workers=2,
                        decode_workers=2)


def mtimes(out_dir):
    return {e["id"]: os.stat(os.path.join(
        out_dir, e["id"], "metrics.json")).st_mtime_ns for e in manifest}


def by_id(results):
    return {r["id"]: {k: v for k, v in r.items() if k != "export_process"}
            for r in results}


def same(a, b):
    """Equal results (NaN equal to NaN, as JSON writes both)."""
    return json.dumps(by_id(a), sort_keys=True) == json.dumps(
        by_id(b), sort_keys=True)


progress = None
if mode == "crash" and rank == crash_rank:
    def progress(stage, done, total):
        # the first batch analysed on this rank: wait until rank 0's export
        # worker has made it durable, then die between batches
        if stage == "analyze" and done >= bs:
            deadline = time.time() + 120
            first = [e["id"] for e in manifest[:bs]]
            while time.time() < deadline and not all(
                    os.path.exists(os.path.join(out, s, ".done"))
                    for s in first):
                time.sleep(0.1)
            print("CRASH_NOW", flush=True)
            os._exit(42)

if mode == "torn" and rank == crash_rank:
    real_write = C._write_subject
    calls = []

    def torn_write(out_dir, entry, decoded, pack, results, lock, **kw):
        calls.append(entry["id"])
        sid = entry["id"]
        if len(calls) < 2:
            real_write(out_dir, entry, decoded, pack, results, lock, **kw)
            print(f"WROTE {sid}", flush=True)
            return
        sdir = os.path.join(out_dir, sid)
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, f"{sid}_dataArray.nii"), "wb") as f:
            f.write(b"\x00torn-by-crash" * 20)
        print(f"TORN {sid}", flush=True)
        os._exit(43)

    C._write_subject = torn_write

shard = mode in ("shard", "torn", "once-shard")
if mode == "view0" and rank != 0:
    out = os.path.join(workdir, f"view{rank}")
results = run(out, shard=shard, progress=progress)
assert len(results) == len(manifest), (len(results), len(manifest))
if mode != "view0":
    assert all(r.get("valid") for r in results), results

if mode == "resume":
    before = mtimes(out) if rank == 0 else None
    again = run(out)
    assert same(again, results)
    if rank == 0:
        assert mtimes(out) == before, "a resumed run rewrote exports"
elif mode == "shard":
    # every rank's files are there once any rank returns
    before = mtimes(out)
    again = run(out, shard=True)
    assert same(again, results)
    assert mtimes(out) == before, "a resumed run rewrote exports"
    p0 = run(os.path.join(workdir, "out_p0"))
    assert same(p0, results), "shard and process-0 metrics differ"

assert collectives and all(collectives), \
    "a collective was issued off the dispatch thread"
tdist.destroy_process_group()
print("DRIVER_OK " + json.dumps({
    "rank": rank, "collectives": len(collectives),
    "results": by_id(results)}, sort_keys=True), flush=True)
