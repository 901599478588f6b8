"""One gloo rank of the space axis over torch.distributed ranks, on the CPU.

Usage: python tests/_torch_space_ranks_worker.py <port> <rank> <world> <dir>

Every rank makes the same inputs from seeds and runs, in one process
group:

- each collective of ``dist/space.py`` under ``space.on_ranks`` (this
  rank's slab of a row of ``world`` ranks) against the in-process form on
  every slab of the same inputs: its element, or the replicated value, bit
  for bit (``collectives`` in the record);
- ``spatial_shard_fn`` over every ``RankSpaceMesh`` shape of SPATIAL_MESHES
  whose size is the world: the result is saved to
  ``<dir>/spatial_<b>x<s>_rank<r>.npz`` for the test to hold against the
  one-process form;
- with two ranks, the sharded train step over a (1, 2) rank mesh (losses
  and parameters saved to ``<dir>/train_rank<r>.npz``) and a (2, 2) mesh
  on a world of 2, which must raise.

The record goes to ``<dir>/rank<r>.json``; the last line printed is
``SPACE_RANKS_OK``.
"""
import functools
import json
import os
import sys

port, rank, world, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                          sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ventjax_torch.config import DEFAULT_CONFIG  # noqa: E402
from ventjax_torch.dist import (  # noqa: E402
    initialize_multihost, make_rank_space_mesh, space, spatial_shard_fn,
)
from ventjax_torch.io.phantom import make_cohort  # noqa: E402
from ventjax_torch.ops.basic import sort_compact_masked  # noqa: E402
from ventjax_torch.pipeline import analyze_cohort, build_geometry  # noqa

torch.set_num_threads(2)
CPU = torch.device("cpu")
SPATIAL_MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
# tests/test_torch_space.py's case
VOX, SHAPE = (1.5, 1.5, 10.0), (32, 32, 8)
CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                             n4_fitting_levels=2, n4_max_iters=10)
TRAIN_SHAPE, TRAIN_STEPS = (32, 32, 4), 2

initialize_multihost(f"localhost:{port}", world, rank, backend="gloo",
                     timeout=120)
me = space.RankGroup(None, rank, world, CPU, 0)


def same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


def collectives():
    """{collective: its rank form bit-equal to the in-process form}."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4 * world, 6, 5, generator=g) * 10.0
    m = (torch.rand(3, 4 * world, 6, 5, generator=g) > 0.5).to(torch.float32)
    xs, ms = space.split_rows(x, [CPU] * world), space.split_rows(
        m, [CPU] * world)
    own = lambda v: [v[rank]]
    flat = lambda t: t.reshape(3, -1)
    ok = {}

    def check(name, inproc, ranked, element=False):
        with space.on_ranks(me):
            got = ranked()
        want = inproc()
        ok[name] = same(got, [want[rank]] if element else want)

    check("split_rows", lambda: xs, lambda: space.split_rows(x, [CPU]), True)
    check("gather_rows", lambda: space.gather_rows(xs),
          lambda: space.gather_rows(own(xs)))
    check("gather_rows_ragged",
          lambda: space.gather_rows([v[:, :1 + i] for i, v in
                                     enumerate(xs)]),
          lambda: space.gather_rows([xs[rank][:, :1 + rank]]))
    for edge in ("zeros", "none"):
        check(f"halo_rows_{edge}", lambda: space.halo_rows(xs, 2, edge=edge),
              lambda: space.halo_rows(own(xs), 2, edge=edge), True)
        check(f"with_halo_{edge}", lambda: space.with_halo(xs, 1, edge=edge),
              lambda: space.with_halo(own(xs), 1, edge=edge), True)
    parts = [flat(v) for v in xs]
    check("sum_in_order", lambda: space.sum_in_order(parts),
          lambda: space.sum_in_order(own(parts)))
    check("sum_int", lambda: space.sum_int([(v > 0).sum(1) for v in parts]),
          lambda: space.sum_int([(parts[rank] > 0).sum(1)]))
    for op in ("reduce_min", "reduce_max"):
        fn = getattr(space, op)
        check(op, lambda: fn(parts), lambda: fn(own(parts)))
    check("reduce_any", lambda: space.reduce_any([v > 20 for v in parts]),
          lambda: space.reduce_any([parts[rank] > 20]))
    check("row_sums_sharded", lambda: space.row_sums_sharded(parts),
          lambda: space.row_sums_sharded(own(parts)))
    check("masked_mean_sharded", lambda: space.masked_mean_sharded(xs, ms),
          lambda: space.masked_mean_sharded(own(xs), own(ms)))
    check("masked_std_sharded", lambda: space.masked_std_sharded(xs, ms),
          lambda: space.masked_std_sharded(own(xs), own(ms)))
    check("masked_sorted_index_sharded",
          lambda: space.masked_sorted_index_sharded(xs, ms, 0.7),
          lambda: space.masked_sorted_index_sharded(own(xs), own(ms), 0.7))
    check("once", lambda: (x.sum(0), m > 0),
          lambda: space.once(lambda: (x.sum(0), m > 0)))
    # the compacted-list tools on a mask's per-slab runs, as N4 makes them
    V = x[0].numel()
    Vs = V // world
    runs = []
    for s, (v, w) in enumerate(zip(xs, ms)):
        i, val, c = sort_compact_masked(flat(v), flat(w) > 0, Vs)
        runs.append((i + s * Vs, val, c))
    counts = [r[2] for r in runs]
    widths = [r[0].shape[1] for r in runs]
    cap = torch.clamp(space.sum_int(counts), max=V // 2)
    chunk = 7
    lay = space.chunk_layout(counts, widths, cap, chunk)
    with space.on_ranks(me):
        mine = space.chunk_layout(own(counts), own(widths), cap, chunk)
    ok["chunk_layout"] = (mine.widths == [lay.widths[rank]] and all(
        same(getattr(mine, f), [getattr(lay, f)[rank]])
        for f in ("valid", "counts", "sources")))
    idx = [r[0] for r in runs]
    check("gather_owned", lambda: space.gather_owned(idx, lay, fill=V - 1),
          lambda: space.gather_owned(own(idx), mine, fill=V - 1), True)
    owned = space.gather_owned(idx, lay, fill=V - 1)
    check("gather_runs",
          lambda: space.gather_runs(owned, lay.counts, V // 2, fill=V - 1),
          lambda: space.gather_runs(own(owned), mine.counts, V // 2,
                                    fill=V - 1))
    check("cat_chunks",
          lambda: space.cat_chunks([o.reshape(3, -1, 1) for o in owned]),
          lambda: space.cat_chunks([owned[rank].reshape(3, -1, 1)]))

    # the halo exchange's gradient: each slab's own share of d(loss)/dx
    wts = torch.randn(3, 4 + 2, 6, 5, generator=g)

    def grads(slabs, halo):
        leaves = [v.clone().requires_grad_(True) for v in slabs]
        loss = space.sum_in_order([(p * wts).sum()
                                   for p in halo(leaves)])
        loss.backward()
        return [v.grad for v in leaves]

    check("halo_gradient", lambda: grads(xs, lambda ls: space.with_halo(
        ls, 1)), lambda: grads(own(xs), lambda ls: space.with_halo(ls, 1)),
        True)
    return ok


record = {"rank": rank, "world": world, "collectives": collectives()}

for nb, ns in SPATIAL_MESHES[world]:
    hp, mask, _ = make_cohort(4, SHAPE, VOX, seed=3)
    geom = build_geometry(VOX, SHAPE, CFG)
    mesh = make_rank_space_mesh(nb, ns, "cpu")
    assert (mesh.row, mesh.slab) == (rank // ns, rank % ns)
    res = spatial_shard_fn(functools.partial(
        analyze_cohort, geom=geom, config=CFG), mesh)(
            torch.from_numpy(hp), torch.from_numpy(mask))
    leaves = {f: getattr(res, f).numpy() for f in (
        "n4", "defect", "defect_lb", "defect_km", "defect_border", "ci_map")}
    leaves.update({f"m_{k}": v.numpy()
                   for k, v in vars(res.metrics).items()})
    np.savez(os.path.join(out, f"spatial_{nb}x{ns}_rank{rank}.npz"), **leaves)

if world == 2:
    from ventjax_torch.io.phantom import make_random_cohort
    from ventjax_torch.models import segmentation as seg

    state = seg.create_train_state(torch.Generator().manual_seed(0),
                                   shape=TRAIN_SHAPE[:2], base=4,
                                   device="cpu")
    step = seg.make_sharded_train_step(state, make_rank_space_mesh(
        1, 2, "cpu"))
    losses = []
    for i in range(TRAIN_STEPS):
        _, m, p = make_random_cohort(2, shape=TRAIN_SHAPE, seed=1 + 2 * i)
        losses.append(float(step(state, p, m)))
    np.savez(os.path.join(out, f"train_rank{rank}.npz"),
             losses=np.asarray(losses),
             **{k: v.detach().numpy() for k, v in state.params.items()})
    try:
        make_rank_space_mesh(2, 2, "cpu")
        record["mismatch"] = "did not raise"
    except ValueError as e:
        record["mismatch"] = str(e)

with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(record, f)
torch.distributed.destroy_process_group()
print("SPACE_RANKS_OK", flush=True)
