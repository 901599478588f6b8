#!/usr/bin/env python3
"""Time the slice on this tree and on another checkout of ventjax_torch,
in turns, on one NVIDIA GPU.

Usage, from the repository root:

    python3 scripts/slice_turns.py OTHER_TREE [--pairs 2]

The slice is chip_smoke.py's headline batch: 16 phantoms of 128x128x16
(make_cohort, seed 0) through analyze_cohort at N4 pad 49,152 and CI pad
512.  Every run is its own process, in the order other, this, this, other
(repeated ``--pairs`` times): it warms up on two batches, times ten
synchronised batches by the host clock (median ms) and counts the device
activities of one batch with torch.profiler (after a warm-up batch in the
same session), with their summed time.  The kernels are built once per
tree; a library whose sources are the same in both trees is built once.
Prints one JSON line per run, then a summary line with each tree's medians.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LIBS = ("n4_fit", "n4_sharpen", "ci_head", "ci_densify")

RUN = r"""
import json, statistics, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from ventjax_torch import _build
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.pipeline import analyze_cohort, build_geometry

for name in %(libs)r:
    _build.load(name)
shape, vox = (128, 128, 16), (1.5, 1.5, 10.0)
hp, mask, _ = make_cohort(16, shape, vox, seed=0)
cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=512, n4_mask_pad=49152)
geom = build_geometry(vox, shape, cfg)
dev = torch.device("cuda", 0)
h, m = torch.from_numpy(hp).to(dev), torch.from_numpy(mask).to(dev)
run = lambda: analyze_cohort(h, m, geom, cfg)
for _ in range(2):
    run()
times = []
for _ in range(10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
# the profiler can lose a session's first activities: the counted batch
# follows a warm-up batch and a spin kernel that marks where it starts
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda._sleep(1000)
    run()
    torch.cuda.synchronize()
events = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)),
                key=lambda e: e.time_range.start)
mark = max(i for i, e in enumerate(events) if "spin_kernel" in e.name)
kernels = events[mark + 1:]
print("RUN " + json.dumps({
    "median_ms": statistics.median(times),
    "runs_ms": [round(t, 2) for t in times],
    "device_activities": len(kernels),
    "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}))
"""


def build(tree: Path) -> None:
    """Build the tree's libraries, taking this tree's where the sources
    (and so the file names) are the same."""
    code = ("from ventjax_torch import _build\n"
            f"print(' '.join(str(_build.library_path(n)) for n in {LIBS!r}))")
    want = subprocess.run([sys.executable, "-c", code], cwd=tree, text=True,
                          capture_output=True, check=True).stdout.split()
    mine = HERE / "build" / "ventjax_torch"
    for path in map(Path, want):
        if not path.exists() and (mine / path.name).exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(mine / path.name, path)
    subprocess.run([sys.executable, "-c",
                    "from concurrent.futures import ThreadPoolExecutor\n"
                    "from ventjax_torch import _build\n"
                    "with ThreadPoolExecutor(4) as pool:\n"
                    f"    list(pool.map(_build.build, {LIBS!r}))"],
                   cwd=tree, check=True)


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN % {"libs": LIBS}],
                         cwd=tree, text=True, capture_output=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(
                             tree)))
    line = [x for x in out.stdout.splitlines() if x.startswith("RUN ")]
    if out.returncode != 0 or not line:
        raise RuntimeError(f"the run in {tree} failed:\n{out.stderr[-3000:]}")
    return json.loads(line[0][4:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="another checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": args.other.resolve(), "this": HERE}
    build(HERE)
    build(trees["other"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    medians = {"other": [], "this": []}
    for _ in range(args.pairs):
        for tag in ("other", "this", "this", "other"):
            rec = {"tree": tag, **run(trees[tag])}
            medians[tag].append(rec["median_ms"])
            print(json.dumps(rec), flush=True)
    print(json.dumps({"card": smi, "median_ms": {
        k: statistics.median(v) for k, v in medians.items()},
        "runs": medians}), flush=True)


if __name__ == "__main__":
    main()
