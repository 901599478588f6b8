#!/usr/bin/env python3
"""Does the facade path leave the process slower for the batched slice?

Times the slice (analyze_cohort on chip_smoke's headline batch: 16 x
128x128x16, median host ms of REPS synchronised runs) twice before
chip_smoke's path g (phase_facade), once after it, and once more after
gc.collect() and torch.cuda.empty_cache(), all in one process on one card.
Beside each reading: Python's tracked objects, live threads and the CUDA
caching allocator's reserved bytes.

Run from the repository root:  python3 scripts/facade_after_effect.py
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

REPS = 7


def slice_reading(tag, run):
    ms = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    rec = {"tag": tag, "median_ms": round(statistics.median(ms), 3),
           "runs_ms": [round(m, 1) for m in ms],
           "gc_objects": len(gc.get_objects()),
           "threads": threading.active_count(),
           "cuda_reserved_mib": round(torch.cuda.memory_reserved() / 2**20,
                                      1)}
    cs.log("reading " + json.dumps(rec))
    return rec


def main():
    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.pipeline import analyze_cohort, build_geometry

    dev, card = cs.phase_device()
    cs.phase_build()
    hp, mask, n4_pad = cs.headline_cohort()
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=512, n4_mask_pad=n4_pad)
    geom = build_geometry(cs.VOX, cs.SHAPE, cfg)
    hp_d = torch.from_numpy(hp).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)

    def run():
        analyze_cohort(hp_d, mask_d, geom, cfg)

    run()                                    # warm-up
    out = [slice_reading("before 1", run), slice_reading("before 2", run)]
    t = time.perf_counter()
    cs.phase_facade(dev)
    cs.log(f"path g took {time.perf_counter() - t:.1f} s")
    out.append(slice_reading("after path g", run))
    gc.collect()
    torch.cuda.empty_cache()
    out.append(slice_reading("after gc and empty_cache", run))
    print(json.dumps({"card": card, "readings": out}), flush=True)


if __name__ == "__main__":
    main()
