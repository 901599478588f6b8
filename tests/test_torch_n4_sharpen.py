"""ventjax_torch N4 sharpen kernels K4, K5 (ops/n4_sharpen_cuda.py) and the
N4 that runs them, against ventjax and float64.

On the CPU the wrappers run their plain float32 versions.  They are held to
ventjax's Pallas sharpen kernels (interpret mode, as
tests/test_n4_pallas_units.py runs them), to float64, and to ventjax's XLA
sharpen.  Tolerances, each with its reason:

- histogram against float64: 1e-5 of the largest bin, float32 arithmetic in
  t and a float32 running sum (measured ~1e-6);
- histogram against the Pallas kernel: 2^-16 of the largest bin, the
  accuracy of the kernel's double-bf16 weight split (measured ~3e-7;
  tests/test_n4_pallas_units.py allows 1e-2);
- mass: the bins sum to sum(wv) within 1e-6 relative (float32 rounding);
- residual against the Pallas kernel on the same table: 2^-16 of the
  table's largest entry over the smallest sv, the double-bf16 split of the
  table (measured ~6e-5 absolute);
- residual against ventjax's XLA sharpen (its own histogram, and the
  expectation through DFT matmuls instead of FFTs): 1e-3 absolute, the bound
  tests/test_n4_pallas_units.py puts on the Pallas kernel against it
  (measured ~4e-4);
- the whole N4 against ventjax's use_pallas=True route: 2e-3 relative on
  masked voxels, the envelope of tests/test_n4_pallas.py, and
  |dVDP| < 0.1 percentage points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.io.phantom import make_cohort
from ventjax.ops import n4 as jn4
from ventjax.ops import n4_pallas as jp
from ventjax.oracle.n4_oracle import _next_pow2_padded
from ventjax_torch.ops import n4 as tn4
from ventjax_torch.ops import n4_sharpen_cuda as sc
from ventjax_torch.ops.vdp import vdp_mean_anchored

torch.set_num_threads(2)

BINS = 200
P = 8192
FWHM, NOISE = 0.15, 0.01
PADDED = _next_pow2_padded(BINS)
OFFSET = (PADDED - BINS) // 2
SPLIT = 2.0 ** -16      # the Pallas kernels' double-bf16 accuracy


def _lanes(seeds=(3, 4)):
    """[N, P] masked log residuals (the last 700 voxels padding), and each
    lane's range and slope as N4 computes them."""
    lu = np.zeros((len(seeds), P), np.float32)
    wv = np.zeros((len(seeds), P), np.float32)
    for n, s in enumerate(seeds):
        m = P - 700 - 50 * n
        wv[n, :m] = 1.0
        lu[n, :m] = np.random.default_rng(s).normal(5.0, 0.7, m)
    lu_t, wv_t = torch.from_numpy(lu), torch.from_numpy(wv)
    bmn, bmx = tn4._masked_range(lu_t, wv_t)
    return lu_t, wv_t, bmn, (bmx - bmn) / (BINS - 1)


def _hist_f64(lu, wv, binmin, slope):
    lu, wv = lu.astype(np.float64), wv.astype(np.float64)
    t = np.clip((lu - binmin) / slope, 0, BINS - 1) * wv
    i0 = np.floor(t).astype(int)
    f = t - i0
    h = np.zeros(BINS + 2)
    np.add.at(h, i0, wv * (1 - f))
    np.add.at(h, i0 + 1, wv * f)
    return h[:BINS]


def test_sharpen_hist_plain_matches_pallas_and_f64():
    lu, wv, bmn, slope = _lanes()
    hist = sc.sharpen_hist(lu, wv, bmn, slope, BINS)
    assert hist.shape == (2, BINS) and hist.dtype == torch.float32
    for n in range(2):
        got = hist[n].numpy()
        exact = _hist_f64(lu[n].numpy(), wv[n].numpy(), float(bmn[n]),
                          float(slope[n]))
        top = exact.max()
        assert np.abs(got - exact).max() < 1e-5 * top
        want = np.asarray(jp.sharpen_hist_pallas(
            jnp.asarray(lu[n].numpy()), jnp.asarray(wv[n].numpy()),
            jnp.float32(bmn[n]), jnp.float32(slope[n]), BINS,
            interpret=True))
        assert np.abs(got - want).max() < SPLIT * top
        mass = float(wv[n].sum())
        assert abs(got.astype(np.float64).sum() - mass) < 1e-6 * mass


def test_sharpen_resid_plain_matches_pallas_and_xla():
    lu, wv, bmn, slope = _lanes()
    sv = torch.from_numpy(np.random.default_rng(5).random(
        lu.shape).astype(np.float32) + 0.5)
    hist = sc.sharpen_hist(lu, wv, bmn, slope, BINS)
    e_loc = tn4._sharpen_expectation(hist, bmn, slope, BINS, FWHM, NOISE,
                                     PADDED, OFFSET)
    a = sc.sharpen_resid(lu, wv, sv, e_loc, bmn, slope, BINS)
    assert a.shape == lu.shape and a.dtype == torch.float32
    for n in range(2):
        j = lambda x: jnp.asarray(x[n].numpy())
        e256 = jnp.zeros(256, jnp.float32).at[:BINS + 2].set(j(e_loc))
        want = np.asarray(jp.sharpen_resid_pallas(
            j(lu), j(wv), j(sv), e256, jnp.float32(bmn[n]),
            jnp.float32(slope[n]), BINS, interpret=True))
        bound = SPLIT * float(e_loc[n].abs().max()) / float(sv[n].min())
        assert np.abs(a[n].numpy() - want).max() < bound
        # ventjax's XLA sharpen, histogram and expectation included
        sharp = jn4._sharpen_vec(j(lu), j(wv), BINS, FWHM, NOISE, PADDED,
                                 OFFSET)
        r = (j(lu) - sharp) * j(wv)
        r = jnp.where(jnp.abs(r) < 1e-18, 0.0, r)
        xla = np.asarray(r / jnp.maximum(j(sv), 1e-30))
        assert np.abs(a[n].numpy() - xla).max() < 1e-3


def test_sharpen_degenerate_lanes_stay_finite():
    """A lane with no weighted voxel has the range (+inf, -inf) and a NaN
    t; a constant lane has slope 0.  Both give finite output, and the
    residual is 0 wherever wv = 0."""
    lu, wv, _, _ = _lanes(seeds=(3, 4, 5))
    wv[0] = 0.0                                  # nothing weighted
    lu[0] = 0.0
    lu[1] = 4.0 * wv[1]                          # constant over the mask
    bmn, bmx = tn4._masked_range(lu, wv)
    slope = (bmx - bmn) / (BINS - 1)
    assert not torch.isfinite(bmn[0]) and float(slope[1]) == 0.0
    hist = sc.sharpen_hist(lu, wv, bmn, slope, BINS)
    assert bool(torch.isfinite(hist).all())
    assert float(hist[0].abs().sum()) == 0.0
    assert float(hist[1, 0]) == float(wv[1].sum())      # all in slot 0
    e_loc = tn4._sharpen_expectation(hist, bmn, slope, BINS, FWHM, NOISE,
                                     PADDED, OFFSET)
    # lane 0's table is NaN (slope -inf); wv = 0 masks it out of K5
    assert bool(torch.isnan(e_loc[0]).all())
    assert bool(torch.isfinite(e_loc[1:]).all())
    a = sc.sharpen_resid(lu, wv, torch.ones_like(lu), e_loc, bmn, slope,
                         BINS)
    assert bool(torch.isfinite(a).all())
    assert bool((a[wv == 0] == 0).all())


def test_sharpen_wrappers_reject_bad_input():
    lu, wv, bmn, slope = _lanes()
    with pytest.raises(ValueError, match="bins"):
        sc.sharpen_hist(lu, wv, bmn, slope, sc.MAX_SLOTS - 1)
    with pytest.raises(ValueError, match="shape"):
        sc.sharpen_hist(lu, wv[:, :100], bmn, slope, BINS)
    with pytest.raises(ValueError, match="binmin"):
        sc.sharpen_hist(lu, wv, bmn[:1], slope, BINS)
    with pytest.raises(ValueError, match="e_loc"):
        sc.sharpen_resid(lu, wv, wv, torch.zeros((2, BINS)), bmn, slope,
                         BINS)
    meta = torch.empty((2, 64), device="meta")
    vec = torch.empty(2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        sc.sharpen_hist(meta, meta, vec, vec, BINS)
    with pytest.raises(RuntimeError, match="no kernel"):
        sc.sharpen_resid(meta, meta, meta,
                         torch.empty((2, BINS + 2), device="meta"), vec, vec,
                         BINS)


@pytest.fixture(scope="module")
def n4_pallas_route():
    """One 2-lane 64x64x8 cohort through the port and through ventjax's
    n4_use_pallas=True route (Pallas kernels in interpret mode)."""
    hp, mask, _ = make_cohort(2, (64, 64, 8), (1.5, 1.5, 10.0), seed=1)
    port, iters = tn4.n4_bias_correction(
        torch.from_numpy(hp), torch.from_numpy(mask), mask_pad=8192,
        return_iters=True)
    want = np.asarray(jax.jit(jax.vmap(
        lambda h, m: jn4.n4_bias_correction(h, m, mask_pad=8192,
                                            use_pallas=True)))(
        jnp.asarray(hp), jnp.asarray(mask)))
    return hp, mask, port.numpy(), iters, want


def _vdp(x, mask):
    return float(vdp_mean_anchored(torch.tensor(x)[None],
                                   torch.from_numpy(mask)[None])[1][0])


@pytest.mark.parametrize("lane", [0, 1])
def test_n4_matches_ventjax_pallas_route(n4_pallas_route, lane):
    hp, mask, port, iters, want = n4_pallas_route
    m = mask[lane] > 0
    rel = np.abs(port[lane] - want[lane])[m] / np.abs(want[lane])[m]
    assert float(rel.max()) < 2e-3
    assert abs(_vdp(port[lane], mask[lane])
               - _vdp(want[lane], mask[lane])) < 0.1
    assert int(iters[lane].sum()) > 4       # the loop really iterated
