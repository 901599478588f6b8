"""ventjax_torch basic/snr/median/vdp/kmeans ops against ventjax.ops.

The same numpy arrays (phantoms, or np.random.default_rng draws) go through
the JAX function (vmapped, on the CPU) and its PyTorch counterpart.
Compaction indices, masks, selected order statistics and defect maps must be
exact; float sums are taken in a different order by the two frameworks, so
means, stds and SNR get a relative tolerance of a few float32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.io.phantom import make_cohort
from ventjax.ops import basic as jb
from ventjax.ops import kmeans as jk
from ventjax.ops import median as jm
from ventjax.ops import snr as js
from ventjax.ops import vdp as jv
from ventjax_torch.ops import basic as tb
from ventjax_torch.ops import kmeans as tk
from ventjax_torch.ops import median as tm
from ventjax_torch.ops import snr as ts
from ventjax_torch.ops import vdp as tv

torch.set_num_threads(2)

SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)


@pytest.fixture(scope="module")
def cohort():
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=4)
    return hp, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("pad", [64, 1000, 8192])
def test_sort_compact_masked_exact(cohort, pad):
    hp, mask = cohort
    flat = hp.reshape(2, -1)
    m = mask.reshape(2, -1) > 0
    ji, jvals, jn = jax.vmap(
        lambda v, mm: jb.sort_compact_masked(v, mm, pad))(
            jnp.asarray(flat), jnp.asarray(m))
    ti, tvals, tn = tb.sort_compact_masked(_t(flat), _t(m), pad)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    ci, cn = tb.compact_mask_indices(_t(m), pad)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(cn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.95, 0.99])
def test_masked_sorted_index_exact(frac):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    x[:, :100] = 0.25              # ties
    m = (rng.random((3, 4096)) < 0.3).astype(np.float32)
    want = jax.vmap(lambda a, b: jb.masked_sorted_index(a, b, frac))(
        jnp.asarray(x), jnp.asarray(m))
    got = tb.masked_sorted_index(_t(x), _t(m), frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_kth_smallest_multi_exact():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    m = (rng.random((2, 2048)) < 0.5).astype(np.float32)
    ks = np.array([[0, 5, 100, 700], [3, 9, 511, 900]], np.int32)
    want = jax.vmap(jb.masked_kth_smallest_multi)(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(ks))
    got = tb.masked_kth_smallest_multi(_t(x), _t(m), _t(ks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_mean_std(cohort):
    hp, mask = cohort
    jmean = jax.vmap(jb.masked_mean)(jnp.asarray(hp), jnp.asarray(mask))
    jstd = jax.vmap(jb.masked_std)(jnp.asarray(hp), jnp.asarray(mask))
    # float32 sums in another order: a few ulps
    assert _rel(tb.masked_mean(_t(hp), _t(mask)), jmean) < 1e-5
    assert _rel(tb.masked_std(_t(hp), _t(mask)), jstd) < 1e-5


def test_gradient_border_exact():
    rng = np.random.default_rng(9)
    a = (rng.random((2,) + SHAPE) < 0.2).astype(np.float32)
    want = jax.vmap(jb.gradient_border)(jnp.asarray(a))
    np.testing.assert_array_equal(tb.gradient_border(_t(a)).numpy(),
                                  np.asarray(want))


def test_median3x3_binary_exact():
    rng = np.random.default_rng(10)
    a = (rng.random((2,) + SHAPE) < 0.5).astype(np.float32)
    want = jax.vmap(jm.median3x3_binary)(jnp.asarray(a))
    np.testing.assert_array_equal(tm.median3x3_binary(_t(a)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("fov_buffer", [0, 4, 8])   # 32 rows: 16+ is all
def test_noise_mask_and_snr(cohort, fov_buffer):
    hp, mask = cohort
    mask = mask.copy()
    mask[1, :, 0, :] = 1.0          # column 0 in the mask: half-open quirk
    want_nm = jax.vmap(lambda m: js.noise_mask(m, fov_buffer))(
        jnp.asarray(mask))
    np.testing.assert_array_equal(ts.noise_mask(_t(mask), fov_buffer).numpy(),
                                  np.asarray(want_nm))
    want = jax.vmap(lambda a, m: js.calculate_snr(a, m, fov_buffer))(
        jnp.asarray(hp), jnp.asarray(mask))
    got = ts.calculate_snr(_t(hp), _t(mask), fov_buffer)
    assert _rel(got, want) < 1e-5   # float32 sums in another order


@pytest.mark.parametrize("thresh", [0.4, 0.6])
def test_vdp_mean_anchored_exact(cohort, thresh):
    hp, mask = cohort
    jd, jvdp = jax.vmap(lambda a, m: jv.vdp_mean_anchored(a, m, thresh))(
        jnp.asarray(hp), jnp.asarray(mask))
    td, tvdp = tv.vdp_mean_anchored(_t(hp), _t(mask), thresh)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tvdp.numpy(), np.asarray(jvdp))


def test_vdp_linear_binning_exact(cohort):
    hp, mask = cohort
    jl, jvdp = jax.vmap(jv.vdp_linear_binning)(jnp.asarray(hp),
                                               jnp.asarray(mask))
    tl, tvdp = tv.vdp_linear_binning(_t(hp), _t(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tvdp.numpy(), np.asarray(jvdp))


@pytest.mark.parametrize("k,defect_clusters", [(4, 1), (3, 2)])
def test_vdp_kmeans_exact(cohort, k, defect_clusters):
    hp, mask = cohort
    P = 2048
    flat = hp.reshape(2, -1)
    m = mask.reshape(2, -1) > 0
    _, vals, n = tb.sort_compact_masked(_t(flat), _t(m), P)
    wv = (torch.arange(P)[None] < n[:, None]).to(torch.float32)

    def jfn(a, mm, cv, cw):
        return jk.vdp_kmeans(a, mm, k, 30, defect_clusters, mask_pad=P,
                             compacted=(cv, cw))

    jd, jvdp = jax.vmap(jfn)(jnp.asarray(hp), jnp.asarray(mask),
                             jnp.asarray(vals.numpy()), jnp.asarray(wv.numpy()))
    td, tvdp = tk.vdp_kmeans(_t(hp), _t(mask), k, 30, defect_clusters,
                             compacted=(vals, wv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tvdp.numpy(), np.asarray(jvdp))


def test_masked_quantiles_exact(cohort):
    hp, mask = cohort
    vals = hp.reshape(2, -1)
    m = mask.reshape(2, -1)
    want = jax.vmap(lambda v, w: jk._masked_quantiles(v, w, 4))(
        jnp.asarray(vals), jnp.asarray(m))
    got = tk._masked_quantiles(_t(vals), _t(m), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L", [1, 2, 5, 64, 1000, 49152])
def test_row_sums_fixed_order(L):
    """ops.basic.row_sums: the float64 sum to float32 rounding, and a row's
    bits the same alone and inside a batch (the property the batch mesh
    needs)."""
    from ventjax_torch.ops.basic import row_sums

    x = torch.from_numpy(np.random.default_rng(L).normal(
        size=(5, 3, L)).astype(np.float32))
    got = row_sums(x)
    want = x.double().sum(-1)
    assert got.shape == (5, 3) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-5 * max(
        1.0, float(x.double().abs().sum(-1).max()))
    for i in range(5):
        assert torch.equal(row_sums(x[i:i + 1]), got[i:i + 1])
