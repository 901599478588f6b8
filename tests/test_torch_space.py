"""The space axis of ventjax_torch (``dist/space.py``, ``ops/n4_space.py``,
``pipeline/spatial.py``, ``make_sharded_train_step``) against its unsharded
counterparts and against ventjax's ("batch", "space") mesh, on the CPU.

Tolerances: every collective bit-equal to the unsharded function it
splits (``row_sums``, the masked mean, std and order statistic, SNR,
the compacted lists, the dense field's rows; K1's chunk partials reduced
over slabs equal to the one-list reduce).  The spatial pipeline on
ventjax's own case (tests/test_dist.py: 4 x 32x32x8, mesh 2 x 4) against
the port's analyze_cohort: SNR, lung volume and the flags bit-equal, the
CI map bit-equal where the defect maps agree, the VDPs within ventjax's
rtol 1e-6 (on the CPU the slabs' N4 sums chunk by chunk, so N4 agrees
within float32 rounding); against ventjax's spatial_shard_fn within
tests/test_torch_pipeline.py's tolerances.  The sharded train step
against train_step and ventjax's sharded step: loss within 1e-5
relative, parameters within STEP_ATOL after 3 steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.dist import make_batch_space_mesh as jax_batch_space_mesh
from ventjax.dist import spatial_shard_fn as jax_spatial_shard_fn
from ventjax.models import segmentation as jseg
from ventjax.pipeline import analyze_cohort as jax_analyze_cohort
from ventjax.pipeline.analyze import build_geometry as jax_build_geometry
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.dist import (
    BatchSpaceMesh, make_batch_space_mesh, make_rank_mesh, space,
    spatial_shard_fn,
)
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.models import segmentation as tseg
from ventjax_torch.ops import n4_cuda, n4_sharpen_cuda, n4_space
from ventjax_torch.ops.basic import (
    masked_mean, masked_sorted_index, masked_std, row_sums,
    sort_compact_masked,
)
from ventjax_torch.ops.n4 import n4_bias_correction
from ventjax_torch.ops.n4_field_cuda import n4_field_plain
from ventjax_torch.ops.snr import calculate_snr, noise_mask
from ventjax_torch.pipeline import analyze_cohort, build_geometry
from ventjax_torch.pipeline.analyze import make_analyze_fn
from ventjax_torch.pipeline.spatial import noise_mask_slabs, snr_slabs

torch.set_num_threads(2)
CPU = torch.device("cpu")
VOX = (1.5, 1.5, 10.0)
SHAPE = (32, 32, 8)
CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                             n4_fitting_levels=2, n4_max_iters=10)
JCFG = JAX_DEFAULT_CONFIG.replace(ci_max_defect_voxels=256, ci_rmax=12,
                                  n4_fitting_levels=2, n4_max_iters=10)
STEP_ATOL = 1e-5    # tests/test_torch_segmentation.py's


def _slabs(x, n):
    return space.split_rows(x, [CPU] * n)


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("n,shape", [
    (2, (3, 2, 16, 8, 4)), (4, (3, 2, 16, 8, 4)),     # V a power of two
    (2, (2, 2, 12, 5, 3)), (4, (2, 2, 12, 5, 3)),     # V = 180, 4 * 45
    (4, (1, 1, 4, 1, 1)),                              # a slab of one
    (3, (2, 1, 9, 4, 2)),                              # n not a power of 2
])
def test_row_sums_sharded_bit_equal(n, shape):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(shape, generator=g) * 100.0
    want = row_sums(x.reshape(shape[0], shape[1], -1))
    parts = [s.reshape(shape[0], shape[1], -1)
             for s in space.split_rows(x, [CPU] * n, dim=2)]
    assert torch.equal(space.row_sums_sharded(parts), want)


@pytest.mark.parametrize("n", [2, 4])
def test_masked_mean_std_and_order_statistic_bit_equal(n):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 16, 12, 5, generator=g)
    m = (torch.rand(3, 16, 12, 5, generator=g) > 0.6).to(torch.float32)
    xs, ms = _slabs(x, n), _slabs(m, n)
    assert torch.equal(space.masked_mean_sharded(xs, ms), masked_mean(x, m))
    assert torch.equal(space.masked_std_sharded(xs, ms), masked_std(x, m))
    for frac in (0.0, 0.5, 0.99):
        assert torch.equal(space.masked_sorted_index_sharded(xs, ms, frac),
                           masked_sorted_index(x, m, frac))


def test_halo_rows_and_reductions():
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    xs = _slabs(x, 4)
    halos = space.halo_rows(xs, 1)
    assert torch.equal(halos[0][0], torch.zeros(2, 1, 3))
    assert torch.equal(halos[3][1], torch.zeros(2, 1, 3))
    assert torch.equal(halos[1][0], x[:, 1:2])
    assert torch.equal(halos[1][1], x[:, 4:5])
    assert space.halo_rows(xs, 1, edge="none")[0][0] is None
    padded = space.with_halo(xs, 1)
    assert torch.equal(padded[2], x[:, 3:7])
    assert torch.equal(space.gather_rows(xs), x)
    parts = [torch.tensor([0.1, -3.0]), torch.tensor([0.2, 5.0]),
             torch.tensor([0.3, 1.0])]
    assert torch.equal(space.sum_in_order(parts),
                       (parts[0] + parts[1]) + parts[2])
    assert torch.equal(space.reduce_min(parts), torch.tensor([0.1, -3.0]))
    assert torch.equal(space.reduce_max(parts), torch.tensor([0.3, 5.0]))
    b = [torch.tensor([False, False]), torch.tensor([False, True])]
    assert torch.equal(space.reduce_any(b), torch.tensor([False, True]))
    big = [torch.tensor([2 ** 40]), torch.tensor([3], dtype=torch.int32)]
    assert int(space.sum_int(big)) == 2 ** 40 + 3
    with pytest.raises(ValueError, match="halo of 3 rows"):
        space.halo_rows(xs, 3)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_compacted_runs_gather_and_chunk_ownership(chunk):
    """Per-slab compactions with global indices give the lane's global list
    (gather_runs), and the owned-chunk buffers partition it into whole
    chunks in order, each slab's tail taken from the next slabs' heads."""
    g = torch.Generator().manual_seed(chunk)
    N, H, W, D, S, P = 3, 16, 6, 4, 4, 300
    m = torch.rand(N, H, W, D, generator=g) > 0.55
    m[1, :12] = False                  # a lane with three empty slabs
    x = torch.rand(N, H, W, D, generator=g) + 1.0
    V = H * W * D
    idx, vals, n = sort_compact_masked(x.reshape(N, -1), m.reshape(N, -1), P)
    runs = []
    Vs = V // S
    for s, (xs, ms) in enumerate(zip(_slabs(x, S), _slabs(m, S))):
        i, v, c = sort_compact_masked(xs.reshape(N, -1), ms.reshape(N, -1),
                                      min(P, Vs))
        runs.append((i + s * Vs, v, c))
    counts = [r[2] for r in runs]
    assert torch.equal(space.sum_int(counts), n)
    cap = torch.clamp(n, max=P)
    live = torch.arange(P)[None] < cap[:, None]
    got = space.gather_runs([r[0] for r in runs], counts, P, fill=-1)
    assert torch.equal(torch.where(live, got, -1), torch.where(live, idx, -1))
    layout = space.chunk_layout(counts, [r[0].shape[1] for r in runs], cap,
                                chunk)
    bufs = space.gather_owned([r[1] for r in runs], layout)
    start = torch.zeros(N, dtype=torch.int64)
    for s in range(S):
        assert layout.widths[s] % chunk == 0
        # a slab's owned range starts on a chunk boundary of the list
        owns = layout.counts[s] > 0
        assert (start[owns] % chunk == 0).all()
        start = start + layout.counts[s]
    owned = space.gather_runs(bufs, layout.counts, P)
    assert torch.equal(owned, torch.where(live, vals, torch.zeros_like(vals)))


def test_k1_and_k2_chunk_partials_over_slabs_equal_one_list():
    """K1's and K2's per-chunk partials of the owned-chunk buffers,
    concatenated over slabs, reduce to the one-list reduce's bits (the
    plain versions: the same per-chunk arithmetic)."""
    g = torch.Generator().manual_seed(3)
    N, ncp = 2, 5
    C = n4_cuda.CHUNK
    counts = [torch.tensor([3000, 10]), torch.tensor([1500, 5000]),
              torch.tensor([0, 2100])]
    P = sum(int(c.max()) for c in counts) + 100
    tot = sum(counts)
    vals = torch.randn(N, P, generator=g)
    rows = [torch.rand(N, ncp, P, generator=g) for _ in range(3)]
    live = (torch.arange(P)[None] < tot[:, None]).to(torch.float32)
    a = vals * live
    # each slab's run: its stretch of the global list
    off = torch.zeros(N, dtype=torch.int64)
    runs_a, runs_r = [], []
    for c in counts:
        w = int(c.max())
        j = (off[:, None] + torch.arange(w)[None]).clamp(max=P - 1)
        runs_a.append(a.gather(1, j))
        runs_r.append([r.gather(2, j[:, None].expand(N, ncp, w))
                       for r in rows])
        off = off + c
    layout = space.chunk_layout(counts, [r.shape[1] for r in runs_a],
                                tot.clamp(max=P), C)
    bufs = space.gather_owned(runs_a, layout)
    rb = []                     # rb[axis][slab]: [N, ncp, width] rows
    for k in range(3):
        per_c = [space.gather_owned([runs_r[s][k][:, c] for s in range(3)],
                                    layout) for c in range(ncp)]
        rb.append([torch.stack([per_c[c][s] for c in range(ncp)], 1)
                   for s in range(3)])
    want = n4_cuda.fit_moment_reduce(n4_cuda.fit_moment_partial(a, *rows))
    got = n4_cuda.fit_moment_reduce(space.cat_chunks([
        n4_cuda.fit_moment_partial(bufs[s], rb[0][s], rb[1][s], rb[2][s])
        for s in range(3)]))
    assert torch.equal(got, want)
    phi = torch.randn(N, ncp, ncp * ncp, generator=g)
    zero = torch.zeros(N)
    wv = live
    _, _, _, part = n4_cuda.fit_delta_conv_field(
        phi, *rows, wv, torch.zeros_like(wv), a, zero, return_part=True)
    wbufs = space.gather_owned([torch.ones_like(r) for r in runs_a], layout)
    parts = [n4_cuda.fit_delta_conv_field(
        phi, rb[0][s], rb[1][s], rb[2][s], wbufs[s],
        torch.zeros_like(bufs[s]), bufs[s], zero, return_part=True)[3]
        for s in range(3)]
    assert torch.equal(n4_cuda.fit_fold_stats(space.cat_chunks(parts)),
                       n4_cuda.fit_fold_stats(part))


def test_new_entry_points_against_one_call_plain():
    g = torch.Generator().manual_seed(0)
    N, ncp, P = 2, 5, 5000
    a = torch.randn(N, P, generator=g)
    r = [torch.rand(N, ncp, P, generator=g) for _ in range(3)]
    part = n4_cuda.fit_moment_partial(a, *r)
    assert part.shape == (N, 3, ncp ** 3)
    want = n4_cuda.fit_moment(a, *r)
    torch.testing.assert_close(n4_cuda.fit_moment_reduce(part), want,
                               rtol=1e-5, atol=1e-5 * want.abs().max())
    lu = torch.randn(N, P, generator=g)
    wv = (torch.rand(N, P, generator=g) > 0.3).to(torch.float32)
    bmn, sl = torch.full((N,), -3.0), torch.full((N,), 6.0 / 199)
    hp = n4_sharpen_cuda.sharpen_hist_partial(lu, wv, bmn, sl, 200)
    assert hp.shape == (N, 5, 202) and hp.dtype == torch.int64
    assert torch.equal(n4_sharpen_cuda.sharpen_hist_finish(hp, 200),
                       n4_sharpen_cuda.sharpen_hist_fixed_plain(
                           lu, wv, bmn, sl, 200))
    phi = torch.randn(N, ncp, ncp * ncp, generator=g)
    _, _, stats, p4 = n4_cuda.fit_delta_conv_field(
        phi, *r, wv, torch.zeros(N, P), lu, torch.zeros(N), return_part=True)
    assert p4.shape == (N, 3, 4)
    torch.testing.assert_close(n4_cuda.fit_fold_stats(p4), stats,
                               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="ncp"):
        n4_cuda.fit_moment_reduce(torch.zeros(N, 2, 10))


@pytest.mark.parametrize("n", [2, 4])
def test_field_slab_rows_equal_full_field(n):
    g = torch.Generator().manual_seed(n)
    ncps = (4, 5, 7)
    phi = torch.randn(2, sum(c ** 3 for c in ncps), generator=g)
    shape = (16, 12, 8)
    full = n4_field_plain(phi, shape, ncps)
    h = shape[0] // n
    for s in range(n):
        assert torch.equal(
            n4_field_plain(phi, shape, ncps, rows=(s * h, (s + 1) * h)),
            full[:, s * h:(s + 1) * h])


@pytest.mark.parametrize("fov", [0, 4, 20])
def test_snr_over_slabs_bit_equal(fov):
    hp, mask, _ = make_cohort(2, (64, 64, 8), VOX, seed=5)
    hp, mask = torch.from_numpy(hp), torch.from_numpy(mask)
    mask[1] = 0.0
    mask[1, 5:9, 10:20, 2:4] = 1.0          # every row but a few unmasked
    ms = _slabs(mask, 4)
    for got, want in zip(noise_mask_slabs(ms, 64, fov),
                         _slabs(noise_mask(mask, fov), 4)):
        assert torch.equal(got, want)
    torch.testing.assert_close(snr_slabs(_slabs(hp, 4), ms, 64, fov),
                               calculate_snr(hp, mask, fov), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("S", [1, 4])
def test_n4_slabs_close_to_unsharded_with_small_chunks(monkeypatch, S):
    """N4 over S slabs with chunks of 64 voxels (many owned chunks a slab,
    tails across slabs) against n4_bias_correction: the slab combiner,
    on one slab too, meets the one-list route."""
    monkeypatch.setattr(n4_cuda, "CHUNK", 64)
    monkeypatch.setattr(n4_space, "CHUNK", 64)
    hp, mask, _ = make_cohort(2, (32, 32, 8), VOX, seed=4)
    hp, mask = torch.from_numpy(hp), torch.from_numpy(mask)
    N, V, P = 2, 32 * 32 * 8, 1000
    comp = sort_compact_masked(hp.reshape(N, -1), mask.reshape(N, -1) > 0, P)
    kw = dict(fitting_levels=2, max_iters=6)
    want, ovf, iters, (_, cv_u, wv_u) = n4_bias_correction(
        hp, mask, mask_pad=P, return_overflow=True, return_iters=True,
        return_compacted=True, compacted=comp, **kw)
    runs = []
    Vs = V // S
    for s, (x, m) in enumerate(zip(_slabs(hp, S), _slabs(mask, S))):
        i, v, c = sort_compact_masked(x.reshape(N, -1), m.reshape(N, -1) > 0,
                                      min(P, Vs))
        runs.append((i + s * Vs, v, c))
    got, ovf_s, iters_s, (_, cv_s, wv_s) = n4_space.n4_slabs(
        _slabs(hp, S), runs, (32, 32, 8), P, **kw)
    assert torch.equal(ovf_s, ovf)
    assert torch.equal(iters_s, iters)
    m = mask > 0
    full = space.gather_rows(got)
    assert ((full - want).abs()[m] / want.abs()[m]).max() < 1e-5
    assert torch.equal(wv_s, wv_u)
    ok = wv_u > 0
    assert ((cv_s - cv_u).abs()[ok] / cv_u.abs()[ok]).max() < 1e-5


# ----------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def ventjax_case():
    """ventjax's own case (tests/test_dist.py): 4 x 32x32x8, seed 12."""
    hp, mask, _ = make_cohort(4, SHAPE, VOX, seed=12)
    geom = build_geometry(VOX, SHAPE, CFG)
    mesh = make_batch_space_mesh(2, 4, devices=[CPU] * 8)
    fn = functools.partial(analyze_cohort, geom=geom, config=CFG)
    args = torch.from_numpy(hp), torch.from_numpy(mask)
    return hp, mask, spatial_shard_fn(fn, mesh)(*args), analyze_cohort(
        *args, geom, CFG)


def _m(res, name):
    return np.asarray(getattr(res.metrics, name))


def test_spatial_pipeline_matches_unsharded(ventjax_case):
    _, _, got, want = ventjax_case
    for name in ("snr", "lung_volume", "valid", "n4_overflow", "ci_overflow",
                 "ci_saturated"):
        np.testing.assert_array_equal(_m(got, name), _m(want, name), name)
    for name in ("vdp", "vdp_lb", "vdp_km"):
        np.testing.assert_allclose(_m(got, name), _m(want, name), rtol=1e-6)
    np.testing.assert_allclose(got.ci_map.numpy(), want.ci_map.numpy(),
                               atol=1e-6)
    for lane in range(4):
        if torch.equal(got.defect[lane], want.defect[lane]):
            assert torch.equal(got.ci_map[lane], want.ci_map[lane])
    for name in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
                 "ci_map"):
        assert getattr(got, name).shape == (4,) + SHAPE, name
    assert np.isfinite(_m(got, "vdp")).all()


def test_spatial_pipeline_matches_ventjax_spatial_shard_fn(ventjax_case):
    hp, mask, got, _ = ventjax_case
    geom = jax_build_geometry(VOX, SHAPE, JCFG)
    fn = lambda h, m: jax_analyze_cohort(h, m, geom, JCFG)
    ref = jax_spatial_shard_fn(fn, jax_batch_space_mesh(2, 4))(
        jnp.asarray(hp), jnp.asarray(mask))
    for name in ("vdp", "vdp_lb", "vdp_km"):
        assert np.abs(_m(got, name) - _m(ref, name)).max() < 0.1, name
    snr_p, snr_j = _m(got, "snr"), _m(ref, "snr")
    np.testing.assert_array_equal(np.isnan(snr_p), np.isnan(snr_j))
    ok = ~np.isnan(snr_j)
    assert (np.abs(snr_p - snr_j)[ok] <= 1e-4 * np.abs(snr_j)[ok]).all()
    for name in ("lung_volume", "valid", "ci_overflow", "n4_overflow"):
        np.testing.assert_array_equal(_m(got, name), _m(ref, name), name)
    m = mask > 0
    n4p, n4j = got.n4.numpy(), np.asarray(ref.n4)
    assert (np.abs(n4p - n4j)[m] / np.abs(n4j)[m]).max() < 2e-3


def test_spatial_shard_fn_takes_make_analyze_fn():
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=3)
    args = torch.from_numpy(hp), torch.from_numpy(mask)
    fn = make_analyze_fn(VOX, SHAPE, CFG, batched=True)
    got = spatial_shard_fn(fn, make_batch_space_mesh(
        1, 2, devices=[CPU] * 2))(*args)
    want = fn(*args)
    np.testing.assert_array_equal(_m(got, "lung_volume"),
                                  _m(want, "lung_volume"))
    np.testing.assert_allclose(_m(got, "vdp"), _m(want, "vdp"), rtol=1e-6)


def test_spatial_raises_on_h_and_on_functions_it_cannot_shard():
    hp, mask, _ = make_cohort(2, (30, 32, 8), VOX, seed=3)
    geom = build_geometry(VOX, (30, 32, 8), CFG)
    fn = functools.partial(analyze_cohort, geom=geom, config=CFG)
    mesh = make_batch_space_mesh(1, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match=r"\(30, 32, 8\).*4 equal H-slabs"):
        spatial_shard_fn(fn, mesh)(torch.from_numpy(hp),
                                   torch.from_numpy(mask))
    for bad in (lambda h, m: analyze_cohort(h, m, geom, CFG),
                make_analyze_fn(VOX, SHAPE, CFG),          # not batched
                functools.partial(analyze_cohort, geom=geom,
                                  export_compact=True)):
        with pytest.raises(TypeError, match="shards the analysis pipeline"):
            spatial_shard_fn(bad, mesh)


def test_batch_space_mesh():
    mesh = make_batch_space_mesh(2, 3, devices=[CPU] * 7)
    assert isinstance(mesh, BatchSpaceMesh)
    assert (mesh.n_batch, mesh.n_space, mesh.size) == (2, 3, 6)
    assert mesh.devices[1] == (CPU,) * 3
    with pytest.raises(ValueError, match=r"2 \* 4 = 8 devices, got 7"):
        make_batch_space_mesh(2, 4, devices=[CPU] * 7)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "machine's refusal")
def test_meshes_default_to_the_card_and_raise_without_one():
    for make in (make_rank_mesh, lambda: make_batch_space_mesh(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    assert make_rank_mesh("cpu").device == CPU


# ---------------------------------------------------------- the train step

def _pair(base=4, shape=(32, 32), lr=1e-3):
    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=shape, base=base,
                                    learning_rate=lr, device="cpu")
    # copies: jnp.asarray may alias the torch parameters, which the port's
    # steps update in place while JAX's step may still be reading them
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                    tseg.params_to_flax(state.params))
    tx = optax.adam(lr)
    jstate = jseg.TrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    return jseg.SegUNet(base=base), tx, jstate, state


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def test_sharded_train_step_matches_train_step_and_ventjax():
    """ventjax's case (tests/test_models.py): make_cohort(4, (32, 32, 4),
    seed=0), base 4, mesh 4 x 2; three steps from the same parameters."""
    _, mask, proton = make_cohort(4, (32, 32, 4), seed=0)
    model, tx, jstate, ref = _pair()
    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=(32, 32), base=4, device="cpu")
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                    ("batch", "space"))
    jstep = jseg.make_sharded_train_step(model, tx, jmesh)
    step = tseg.make_sharded_train_step(
        state, make_batch_space_mesh(4, 2, devices=[CPU] * 8))
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(proton), jnp.asarray(mask))
        jloss = float(jax.block_until_ready(jloss))
        want = tseg.train_step(ref, proton, mask)
        got = step(state, proton, mask)
        for other in (float(want), jloss):
            assert abs(float(got) - other) <= 1e-5 * abs(other), i
        mine = _leaves(tseg.params_to_flax(state.params))
        for p_t, p_r, p_j in zip(mine,
                                 _leaves(tseg.params_to_flax(ref.params)),
                                 _leaves(jstate.params)):
            assert np.abs(p_t - p_r).max() <= STEP_ATOL, i
            assert np.abs(p_t - p_j).max() <= STEP_ATOL, i
    assert state.step == int(jstate.step) == 3


def test_sharded_train_step_raises_on_slab_height():
    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=(24, 32), base=4, device="cpu")
    _, mask, proton = make_cohort(2, (24, 32, 4), seed=0)
    step = tseg.make_sharded_train_step(
        state, make_batch_space_mesh(1, 4, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="slab of 6 rows"):
        step(state, proton, mask)
    with pytest.raises(TypeError, match="batch', 'space'"):
        tseg.make_sharded_train_step(state, None)
