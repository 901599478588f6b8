"""One rank of the two-process slice-sharded (halo) CI test of the port.

Usage: python tests/_torch_multihost_halo_worker.py <port> <rank> [device]

Two processes join a torch.distributed group (gloo) through
ventjax_torch.dist.initialize_multihost; the slice axis of one 32x32x32
volume is split between them, so the boundary coordinate messages cross a
real process boundary.  Each rank checks that its CI slab equals, bit for
bit, the unsharded engine's map of the same volume computed in the rank,
and that the saturated count and overflow flag summed over the ranks are
the unsharded ones.  ``device`` (default cpu) is the rank's torch device;
two ranks may share one card under gloo.
"""
import os
import sys

port, rank = sys.argv[1], int(sys.argv[2])
device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ventjax_torch.dist import (  # noqa: E402
    initialize_multihost, make_rank_mesh, make_sliced_ci_fn,
)
from ventjax_torch.ops.ci_pairwise import (  # noqa: E402
    build_ci_pairwise_geometry, calculate_ci_pairwise,
)

torch.set_num_threads(2)
initialize_multihost(f"localhost:{port}", num_processes=2, process_id=rank,
                     backend="gloo")
mesh = make_rank_mesh(device)
assert (mesh.size, mesh.index) == (2, rank)

H, W, D = 32, 32, 32
geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), (H, W, D), 16, "wrap")
# the same volume in both ranks: sparse singles plus a dense cluster across
# the rank boundary (z = 16), so the halo carries real witnesses
rng = np.random.default_rng(7)
defect = (rng.random((H, W, D)) > 0.99).astype(np.float32)
defect[8:16, 8:16, 13:19] = 1
defect[0, 0, 0] = defect[-1, -1, -1] = 1
full = torch.from_numpy(defect).to(mesh.device)
dl = D // 2

fn = make_sliced_ci_fn(geom, mesh, max_defect_per_shard=512, halo_pad=256,
                       tail_k=512)
ci, nsat, ovf = fn(full[:, :, rank * dl:(rank + 1) * dl])
assert not bool(ovf), "halo CI overflowed its pads"
assert ci.device == mesh.device

ci_u, nsat_u, ovf_u = calculate_ci_pairwise(full[None], geom, 1024,
                                            tail_k=1024)
assert not bool(ovf_u[0])
assert torch.equal(ci, ci_u[0, :, :, rank * dl:(rank + 1) * dl])
assert int(nsat) == int(nsat_u[0])
torch.distributed.destroy_process_group()
print(f"TORCH_MULTIHOST_HALO_OK rank={rank} nsat={int(nsat)} "
      f"ci_sum={float(ci.sum()):.3f}", flush=True)
