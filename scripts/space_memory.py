#!/usr/bin/env python3
"""Each space shard's peak device memory, one shard a card.

Usage, on a machine with four NVIDIA GPUs, from the repository root:

    python3 scripts/space_memory.py

The script runs chip_smoke.py path l's oversize study
(make_cohort(1, (256, 256, 64), vox 1.5x1.5x10, seed 0), the N4 pad
covering its mask, the default CI pad) through analyze_cohort on card 0,
then through dist.spatial_shard_fn over a (1, 4) mesh whose shard s is
card s, and prints, per card, the peak of torch.cuda.max_memory_allocated
above what the card held before the run, beside the unsharded run's, with
each run's host milliseconds.  Every output of the sharded run must equal
the unsharded run's bit for bit, or the script exits 1.  It needs four
cards (fewer: exit 2).
"""
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ventjax_torch import _build  # noqa: E402
from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.dist import (  # noqa: E402
    make_batch_space_mesh, spatial_shard_fn,
)
from ventjax_torch.io.phantom import make_cohort  # noqa: E402
from ventjax_torch.pipeline import analyze_cohort, build_geometry  # noqa

SHAPE, VOX, SHARDS = (256, 256, 64), (1.5, 1.5, 10.0), 4


def main():
    if not torch.cuda.is_available() or torch.cuda.device_count() < SHARDS:
        print(f"space_memory: needs {SHARDS} cards, found "
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
    hp, mask, _ = make_cohort(1, SHAPE, VOX, seed=0)
    n_mask = int((mask > 0).sum())
    cfg = DEFAULT_CONFIG.replace(
        n4_mask_pad=min(int(np.prod(SHAPE)), -(-n_mask // 8192) * 8192))
    geom = build_geometry(VOX, SHAPE, cfg)
    hp_d = torch.from_numpy(hp).to(devs[0])
    mask_d = torch.from_numpy(mask).to(devs[0])
    fn = functools.partial(analyze_cohort, geom=geom, config=cfg)
    sharded = spatial_shard_fn(fn, make_batch_space_mesh(1, SHARDS, devs))
    # warm-up of both (kernels loaded, cuDNN/cuFFT plans made)
    want = fn(hp_d, mask_d)
    got = sharded(hp_d, mask_d)

    def measure(run, cards):
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        base = {d: torch.cuda.memory_allocated(d) for d in cards}
        t0 = time.perf_counter()
        out = run(hp_d, mask_d)
        for d in cards:
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, {str(d): torch.cuda.max_memory_allocated(d) - base[d]
                         for d in cards}

    want, ms_u, peak_u = measure(fn, devs[:1])
    del want
    got, ms_s, peak_s = measure(sharded, devs)
    want = fn(hp_d, mask_d)
    fields = ("n4", "defect", "defect_lb", "defect_km", "defect_border",
              "ci_map")
    equal = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
             for f in fields}
    for f in ("snr", "vdp", "vdp_lb", "vdp_km", "ci", "lung_volume",
              "ci_overflow", "n4_overflow"):
        a, b = getattr(got.metrics, f), getattr(want.metrics, f)
        equal[f] = bool(torch.equal(a.nan_to_num(), b.nan_to_num())
                        if a.is_floating_point() else torch.equal(a, b))
    print(f"space_memory: {SHAPE} study, {n_mask} mask voxels, n4_mask_pad "
          f"{cfg.n4_mask_pad}; unsharded on {devs[0]}: peak bytes "
          f"{json.dumps(peak_u)}, host ms {ms_u!r}; over (1, {SHARDS}), "
          f"one shard a card: peak bytes {json.dumps(peak_s)}, host ms "
          f"{ms_s!r}; bit-equal {json.dumps(equal)}", flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
