"""The space axis over torch.distributed ranks (``dist.make_rank_space_mesh``,
``dist.space.on_ranks``), on the CPU: gloo ranks as subprocesses of
tests/_torch_space_ranks_worker.py, one launch of 2 ranks and one of 4.

Tolerances: none; everything bit-equal.  Each collective's rank form
against its in-process form on the same inputs (checked inside every
rank); ``spatial_shard_fn`` over (1, 2), (2, 2) and (1, 4) rank meshes on
every rank against the one-process ``spatial_shard_fn`` with
``devices=["cpu"] * n`` at the same mesh shape (both run the plain
versions chunk by chunk); the train step over (1, 2) ranks against the
one-process sharded step, its parameters identical across ranks.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.dist import make_batch_space_mesh, spatial_shard_fn
from ventjax_torch.io.phantom import make_cohort, make_random_cohort
from ventjax_torch.models import segmentation as seg
from ventjax_torch.pipeline import analyze_cohort, build_geometry

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_space_ranks_worker.py")
torch.set_num_threads(2)
CPU = torch.device("cpu")
VOX, SHAPE = (1.5, 1.5, 10.0), (32, 32, 8)     # the worker's
CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                             n4_fitting_levels=2, n4_max_iters=10)
TRAIN_SHAPE, TRAIN_STEPS = (32, 32, 4), 2
COLLECTIVES = (
    "split_rows", "gather_rows", "gather_rows_ragged", "halo_rows_zeros",
    "halo_rows_none", "with_halo_zeros", "with_halo_none", "sum_in_order",
    "sum_int", "reduce_min", "reduce_max", "reduce_any", "row_sums_sharded",
    "masked_mean_sharded", "masked_std_sharded",
    "masked_sorted_index_sharded", "once", "chunk_layout", "gather_owned",
    "gather_runs", "cat_chunks", "halo_gradient")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world, out, timeout=120):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), str(world), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "SPACE_RANKS_OK" in o, \
            f"rank {r} of {world} failed:\n{o[-4000:]}"
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: (its ranks' records, their output directory)}."""
    got = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"ranks{world}")
        got[world] = (_launch(world, out), out)
    return got


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_rank_form_bit_equal(ranks, world, name):
    recs, _ = ranks[world]
    assert [r["collectives"][name] for r in recs] == [True] * world


@pytest.mark.parametrize("nb,ns", [(1, 2), (2, 2), (1, 4)])
def test_spatial_shard_fn_over_ranks_bit_equal(ranks, nb, ns):
    _, out = ranks[nb * ns]
    hp, mask, _ = make_cohort(4, SHAPE, VOX, seed=3)
    geom = build_geometry(VOX, SHAPE, CFG)
    want = spatial_shard_fn(
        functools.partial(analyze_cohort, geom=geom, config=CFG),
        make_batch_space_mesh(nb, ns, devices=[CPU] * (nb * ns)))(
            torch.from_numpy(hp), torch.from_numpy(mask))
    leaves = {f: getattr(want, f).numpy() for f in (
        "n4", "defect", "defect_lb", "defect_km", "defect_border", "ci_map")}
    leaves.update({f"m_{k}": v.numpy()
                   for k, v in vars(want.metrics).items()})
    assert np.asarray(leaves["m_valid"]).all()
    for r in range(nb * ns):
        got = np.load(os.path.join(out, f"spatial_{nb}x{ns}_rank{r}.npz"))
        assert sorted(got.files) == sorted(leaves)
        for k, v in leaves.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")


def test_train_step_over_ranks_equals_one_process(ranks):
    _, out = ranks[2]
    state = seg.create_train_state(torch.Generator().manual_seed(0),
                                   shape=TRAIN_SHAPE[:2], base=4,
                                   device="cpu")
    step = seg.make_sharded_train_step(
        state, make_batch_space_mesh(1, 2, devices=[CPU] * 2))
    losses = []
    for i in range(TRAIN_STEPS):
        _, m, p = make_random_cohort(2, shape=TRAIN_SHAPE, seed=1 + 2 * i)
        losses.append(float(step(state, p, m)))
    got = [np.load(os.path.join(out, f"train_rank{r}.npz")) for r in (0, 1)]
    for g in got:
        np.testing.assert_array_equal(g["losses"], np.asarray(losses))
        for k, v in state.params.items():
            np.testing.assert_array_equal(g[k], v.detach().numpy(),
                                          err_msg=k)
    for k in state.params:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def test_world_size_not_matching_the_mesh_raises(ranks):
    recs, _ = ranks[2]
    for r in recs:
        assert "(2, 2)" in r["mismatch"] and "4 ranks" in r["mismatch"] \
            and "has 2" in r["mismatch"], r["mismatch"]
