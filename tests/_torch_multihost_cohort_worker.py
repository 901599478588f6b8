"""One rank of the two-process batch-mesh test of the port.

Usage: python tests/_torch_multihost_cohort_worker.py <port> <rank>

Two processes join a torch.distributed group (gloo, on the CPU) through
ventjax_torch.dist.initialize_multihost.  Both hold the same four subjects;
shard_cohort_fn over a RankMesh runs each rank's two lanes and gathers
every result leaf, so each rank holds all four.  Each rank checks its own
lanes bit-equal to its own unsharded run of them, and that the gathered
result has the whole batch's shapes.
"""
import os
import sys

port, rank = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.dist import (  # noqa: E402
    initialize_multihost, make_rank_mesh, shard_cohort_fn,
)
from ventjax_torch.io.phantom import make_cohort  # noqa: E402
from ventjax_torch.pipeline import analyze_cohort, build_geometry  # noqa

torch.set_num_threads(2)
initialize_multihost(f"localhost:{port}", num_processes=2, process_id=rank)
mesh = make_rank_mesh("cpu")

shape, vox = (32, 32, 8), (1.5, 1.5, 10.0)
cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                             n4_fitting_levels=2, n4_max_iters=10)
geom = build_geometry(vox, shape, cfg)
hp, mask, _ = make_cohort(4, shape=shape, vox=vox, seed=0)
hp, mask = torch.from_numpy(hp), torch.from_numpy(mask)

res = shard_cohort_fn(lambda h, m: analyze_cohort(h, m, geom, cfg), mesh)(
    hp, mask)
mine = slice(2 * rank, 2 * rank + 2)
ref = analyze_cohort(hp[mine], mask[mine], geom, cfg)
for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"):
    assert getattr(res, f).shape == (4,) + shape, f
    assert torch.equal(getattr(res, f)[mine], getattr(ref, f)), f
for f, want in vars(ref.metrics).items():
    got = getattr(res.metrics, f)
    assert got.shape == (4,) and got.dtype == want.dtype, f
    # bit-equal, NaN where the unsharded run has NaN (SNR at 32 rows: the
    # 20-row field-of-view buffers leave no noise voxel)
    torch.testing.assert_close(got[mine], want, rtol=0, atol=0,
                               equal_nan=True, msg=f)
assert bool(torch.isfinite(res.metrics.vdp).all())
torch.distributed.destroy_process_group()
print(f"TORCH_MULTIHOST_OK rank={rank} "
      f"vdp={[round(float(v), 4) for v in res.metrics.vdp]}", flush=True)
