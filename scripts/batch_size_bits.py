#!/usr/bin/env python3
"""Does a lane's result depend on the size of the batch it runs in?

Usage, on a machine with an NVIDIA GPU, from the repository root:

    python3 scripts/batch_size_bits.py [TREE]

TREE (default: this repository) is a checkout of ventjax_torch, for
instance an older commit's, whose kernels are built by this run.  The
script runs chip_smoke.py's headline slice (16 phantoms of 128x128x16,
make_cohort seed 0, N4 pad 49,152, CI pad 512) through analyze_cohort as
one batch and as consecutive shards of 8, 4, 2 and 1 lanes, and prints,
per shard size, each output field with whether its bits equal the batch's
and the largest absolute difference; then the same for SNR and for N4's
stages (corrected image, dense field, iterations, lattices, compacted
values) at shards of 4 and 1.  A batch mesh (dist.shard_cohort_fn) gives
the batch's bits only where every field is equal.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

tree = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1])
sys.path.insert(0, str(tree.resolve()))

import torch  # noqa: E402

from ventjax_torch import _build  # noqa: E402
from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.io.phantom import make_cohort  # noqa: E402
from ventjax_torch.ops import n4 as tn4  # noqa: E402
from ventjax_torch.ops.snr import calculate_snr  # noqa: E402
from ventjax_torch.pipeline import analyze_cohort, build_geometry  # noqa

with ThreadPoolExecutor(8) as pool:   # every library of the tree
    list(pool.map(_build.build, sorted(
        p.stem for p in (tree / "ventjax_torch" / "csrc").glob("*.cu"))))
dev = torch.device("cuda", 0)
SHAPE, VOX = (128, 128, 16), (1.5, 1.5, 10.0)
hp, mask, _ = make_cohort(16, SHAPE, VOX, seed=0)
cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=512, n4_mask_pad=49152)
geom = build_geometry(VOX, SHAPE, cfg)
hp_d, mask_d = torch.from_numpy(hp).to(dev), torch.from_numpy(mask).to(dev)


def diff(a, b):
    a, b = a.double(), b.double()
    same = (a == b) | (a.isnan() & b.isnan())
    return {"equal": bool(same.all()),
            "max_abs": float((a - b)[~same].abs().max()) if not bool(
                same.all()) else 0.0}


def sharded(fn, s):
    return [fn(hp_d[i:i + s], mask_d[i:i + s]) for i in range(0, 16, s)]


whole = analyze_cohort(hp_d, mask_d, geom, cfg)
for s in (8, 4, 2, 1):
    parts = sharded(lambda h, m: analyze_cohort(h, m, geom, cfg), s)
    out = {f: diff(getattr(whole, f), torch.cat([getattr(p, f)
                                                 for p in parts]))
           for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map")}
    out.update({f"metrics.{f}": diff(getattr(whole.metrics, f), torch.cat(
        [getattr(p.metrics, f) for p in parts]))
        for f in ("snr", "vdp", "vdp_lb", "vdp_km", "ci")})
    print(f"shards of {s}: {json.dumps(out)}", flush=True)

snr = lambda h, m: calculate_snr(h, m, cfg.snr_fov_buffer)
print("snr, shards of 4:", json.dumps(diff(snr(hp_d, mask_d), torch.cat(
    sharded(snr, 4)))), flush=True)


def n4(h, m):
    return tn4.n4_bias_correction(
        h, m, fitting_levels=cfg.n4_fitting_levels,
        max_iters=cfg.n4_max_iters,
        convergence_threshold=cfg.n4_convergence_threshold,
        bins=cfg.n4_histogram_bins, fwhm=cfg.n4_bias_fwhm,
        wiener_noise=cfg.n4_wiener_noise,
        control_points=cfg.n4_control_points, mask_pad=cfg.n4_mask_pad,
        return_field=True, return_iters=True, return_phi=True,
        return_compacted=True)


a = n4(hp_d, mask_d)
for s in (4, 1):
    parts = sharded(n4, s)
    for j, name in enumerate(("corrected", "field", "iterations", "phi")):
        print(f"n4 {name}, shards of {s}:", json.dumps(diff(a[j], torch.cat(
            [p[j] for p in parts]))), flush=True)
    print(f"n4 compacted values, shards of {s}:", json.dumps(diff(
        a[4][1], torch.cat([p[4][1] for p in parts]))), flush=True)
print(json.dumps({"tree": str(tree), "card": torch.cuda.get_device_name(0)}))
