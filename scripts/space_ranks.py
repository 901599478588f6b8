#!/usr/bin/env python3
"""The space axis over NCCL ranks, one slab a card: the oversize study.

Usage, on a machine with four NVIDIA GPUs, from the repository root:

    python3 scripts/space_ranks.py

The script runs chip_smoke.py path l's oversize study
(make_cohort(1, (256, 256, 64), vox 1.5x1.5x10, seed 0), the N4 pad
covering its mask, the default CI pad) three ways, each after a warm-up
run: through analyze_cohort on card 0; through dist.spatial_shard_fn over
a one-process (1, 4) mesh whose shard s is card s (the shards run in turn
on the host thread); and through spatial_shard_fn over a (1, 4)
RankSpaceMesh of four processes of this script (NCCL, rank s on card s),
whose slabs run at once.  It prints each run's host milliseconds and each
card's (each rank's) peak of torch.cuda.max_memory_allocated above what it
held before the run.  Every output of both sharded runs must equal the
unsharded run's bit for bit on every rank, or the script exits 1.  It
needs four cards (fewer: exit 2).
"""
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ventjax_torch import _build  # noqa: E402
from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.dist import (  # noqa: E402
    initialize_multihost, make_batch_space_mesh, make_rank_space_mesh,
    spatial_shard_fn,
)
from ventjax_torch.io.phantom import make_cohort  # noqa: E402
from ventjax_torch.pipeline import analyze_cohort, build_geometry  # noqa

SHAPE, VOX, SHARDS = (256, 256, 64), (1.5, 1.5, 10.0), 4
FIELDS = ("n4", "defect", "defect_lb", "defect_km", "defect_border",
          "ci_map")
METRICS = ("snr", "vdp", "vdp_lb", "vdp_km", "lung_volume",
           "defect_volume", "ci", "ci_saturated", "ci_overflow",
           "n4_overflow", "valid")


def study():
    hp, mask, _ = make_cohort(1, SHAPE, VOX, seed=0)
    n_mask = int((mask > 0).sum())
    cfg = DEFAULT_CONFIG.replace(
        n4_mask_pad=min(int(np.prod(SHAPE)), -(-n_mask // 8192) * 8192))
    fn = functools.partial(analyze_cohort, config=cfg,
                           geom=build_geometry(VOX, SHAPE, cfg))
    return hp, mask, n_mask, cfg, fn


def leaves(res):
    out = {f: getattr(res, f).cpu().numpy() for f in FIELDS}
    out.update({f: getattr(res.metrics, f).cpu().numpy() for f in METRICS})
    return out


def differing(res, want):
    got = leaves(res)
    return [k for k in want if not (
        got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k], equal_nan=got[k].dtype.kind == "f"))]


def measure(run, cards):
    """(result, host ms, {card: peak bytes above the start})."""
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    base = {d: torch.cuda.memory_allocated(d) for d in cards}
    t0 = time.perf_counter()
    out = run()
    for d in cards:
        torch.cuda.synchronize(d)
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {str(d): torch.cuda.max_memory_allocated(d) - base[d]
                     for d in cards}


def rank_main(port, rank, ref):
    """One NCCL rank on card ``rank``: a warm-up, then the measured run."""
    import torch.distributed as dist

    initialize_multihost(f"localhost:{port}", SHARDS, rank, backend="nccl",
                         timeout=300)
    hp, mask, _, _, fn = study()
    mesh = make_rank_space_mesh(1, SHARDS)
    dev = mesh.device
    hp_d, mask_d = torch.from_numpy(hp).to(dev), torch.from_numpy(
        mask).to(dev)
    sharded = spatial_shard_fn(fn, mesh)
    sharded(hp_d, mask_d)
    dist.barrier()
    got, ms, peak = measure(lambda: sharded(hp_d, mask_d), [dev])
    want = dict(np.load(ref))
    rec = {"rank": rank, "card": str(dev), "host_ms": ms,
           "peak_bytes": peak[str(dev)], "differs": differing(got, want)}
    dist.destroy_process_group()
    print("RANK " + json.dumps(rec), flush=True)


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        return rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available() or torch.cuda.device_count() < SHARDS:
        print(f"space_ranks: needs {SHARDS} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("cards: " + json.dumps(smi), flush=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(_build.build, ("n4_fit", "n4_sharpen", "ci_head",
                                     "ci_densify", "n4_field")))
    devs = [torch.device("cuda", i) for i in range(SHARDS)]
    hp, mask, n_mask, cfg, fn = study()
    hp_d = torch.from_numpy(hp).to(devs[0])
    mask_d = torch.from_numpy(mask).to(devs[0])
    one = spatial_shard_fn(fn, make_batch_space_mesh(1, SHARDS, devs))
    fn(hp_d, mask_d)
    one(hp_d, mask_d)
    want, ms_u, peak_u = measure(lambda: fn(hp_d, mask_d), devs[:1])
    want = leaves(want)
    got, ms_one, peak_one = measure(lambda: one(hp_d, mask_d), devs)
    diff_one = differing(got, want)
    del got
    with tempfile.TemporaryDirectory() as root:
        ref = os.path.join(root, "want.npz")
        np.savez(ref, **want)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(port), str(r), ref],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(SHARDS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    recs = []
    for p, out in zip(procs, outs):
        line = [x for x in out.splitlines() if x.startswith("RANK ")]
        if p.returncode != 0 or not line:
            print(f"space_ranks: a rank failed (exit {p.returncode}):\n"
                  f"{out[-3000:]}", file=sys.stderr)
            return 1
        recs.append(json.loads(line[0][len("RANK "):]))
    print(f"space_ranks: {SHAPE} study, {n_mask} mask voxels, n4_mask_pad "
          f"{cfg.n4_mask_pad}; unsharded on {devs[0]}: host ms {ms_u!r}, "
          f"peak bytes {json.dumps(peak_u)}; one process over (1, {SHARDS})"
          f", one shard a card: host ms {ms_one!r}, peak bytes "
          f"{json.dumps(peak_one)}, differing fields {diff_one}; {SHARDS} "
          f"NCCL ranks, one a card: host ms by rank "
          f"{[r['host_ms'] for r in recs]!r}, peak bytes by rank "
          f"{[r['peak_bytes'] for r in recs]}, differing fields by rank "
          f"{[r['differs'] for r in recs]}", flush=True)
    ok = not diff_one and not any(r["differs"] for r in recs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
