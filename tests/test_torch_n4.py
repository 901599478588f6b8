"""ventjax_torch N4 (ops/n4.py, ops/n4_cuda.py) against ventjax and the
float64 oracle.

K1 (fit_moment), K2 (fit_delta_conv_field), K6 (fit_delta) and K7
(fit_delta_conv) run here as their plain float32 versions and are held against ventjax's Pallas kernels in interpret
mode, and against the same sums in float64.  The Pallas kernels feed bf16
operands to the contraction (a TPU matrix-unit choice): every term of a
moment carries four bf16 roundings (a*br, bc, bs and bc*bs), every term of
delta five (phi too), each at most 2^-9 relative.  The basis rows take few
distinct values (8 slices here), so those roundings do not average out;
the envelope against JAX is that many roundings, relative to the largest
magnitude of each output.  Against float64 the port's float32 versions are
held to 1e-5.  The full N4 is held to the envelope tests/test_n4_pallas.py
uses for the bf16 fit, 2e-3 on masked voxels, against JAX and the oracle,
and to |dVDP| < 0.1 percentage points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.io.phantom import make_cohort
from ventjax.ops import n4 as jn4
from ventjax.ops import n4_pallas as jp
from ventjax.oracle.n4_oracle import n4_bias_correction_oracle
from ventjax_torch.ops import n4 as tn4
from ventjax_torch.ops import n4_cuda
from ventjax_torch.ops.vdp import vdp_mean_anchored

torch.set_num_threads(2)

SHAPE = (64, 64, 8)
VOX = (1.5, 1.5, 10.0)
BF16 = 2.0 ** -9        # bf16 unit roundoff (8-bit significand)
MOMENT_ENVELOPE = 4 * BF16
DELTA_ENVELOPE = 5 * BF16


def _scaled_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _fit_inputs(ncp, P=8192, seed=0):
    """Basis rows for P random voxels of SHAPE (the last eighth padding)."""
    rng = np.random.default_rng(seed)
    H, W, D = SHAPE
    idx = np.sort(rng.choice(H * W * D, P, replace=False))
    coords = [idx // (W * D), (idx // D) % W, idx % D]
    n_el = ncp - 3
    rows_t = [tn4._bspline_rows(torch.from_numpy(c)[None], n, n_el)
              for c, n in zip(coords, SHAPE)]           # [1, P, ncp]
    rows_j = [jn4._bspline_rows(jnp.asarray(c), n, n_el, jnp.float32)
              for c, n in zip(coords, SHAPE)]           # [P, ncp]
    wv = (np.arange(P) < P - P // 8).astype(np.float32)
    return rng, rows_t, rows_j, wv


def _f64_moment(a, rows, power):
    br, bc, bs = (np.asarray(r, np.float64) ** power for r in rows)
    return np.einsum("p,pc,pd,pe->cde", a, br, bc, bs).reshape(
        br.shape[1], -1)


@pytest.mark.parametrize("ncp", [4, 11])
@pytest.mark.parametrize("power", [2, 3])
def test_fit_moment_plain_matches_pallas(ncp, power):
    rng, rows_t, rows_j, wv = _fit_inputs(ncp)
    if power == 2:      # the denominator: a = the weights
        a = wv
    else:               # the numerator: a smooth residual, as N4 fits
        x = np.linspace(0.0, 3.0, wv.shape[0])
        a = ((np.sin(x) + 0.1 * rng.normal(size=x.shape)) * wv).astype(
            np.float32)
    want = jp.fit_moment_pallas(
        jnp.asarray(a), *(jp.basis_rows_padded(r, power) for r in rows_j),
        ncp, interpret=True)[:ncp, :ncp * ncp]
    got = n4_cuda.fit_moment(
        torch.from_numpy(a)[None],
        *(tn4._rows(r, power) for r in rows_t))[0]
    assert got.shape == (ncp, ncp * ncp)
    assert _scaled_err(got, want) < MOMENT_ENVELOPE
    # and the same f32 algorithm as exact math: float32 rounding only
    exact = _f64_moment(a, [r[0].numpy() for r in rows_t], power)
    assert _scaled_err(got, exact) < 1e-5


@pytest.mark.parametrize("ncp", [4, 11])
@pytest.mark.parametrize("done", [False, True])
def test_fit_delta_conv_field_plain_matches_pallas(ncp, done):
    rng, rows_t, rows_j, wv = _fit_inputs(ncp, seed=1)
    P = wv.shape[0]
    # a fitted lattice is smooth: positive coefficients of one scale
    phi = (0.05 * (1.0 + 0.2 * rng.normal(size=(ncp, ncp * ncp)))).astype(
        np.float32)
    field = (0.1 * rng.normal(size=P) * wv).astype(np.float32)
    logv = ((3.0 + rng.normal(size=P)) * wv).astype(np.float32)
    phi_pad = np.zeros((jp.CP, jp.FP), np.float32)
    phi_pad[:ncp, :ncp * ncp] = phi
    jnf, jlu, js1, js2, jmn, jmx = jp.fit_delta_conv_field_pallas(
        jnp.asarray(phi_pad), *(jp.basis_rows_padded(r, 1) for r in rows_j),
        jnp.asarray(wv), jnp.asarray(field), jnp.asarray(logv),
        jnp.asarray(done), ncp, interpret=True)
    t = lambda x: torch.from_numpy(x)[None]
    nf, lu, stats = n4_cuda.fit_delta_conv_field(
        t(phi), *(tn4._rows(r, 1) for r in rows_t), t(wv), t(field),
        t(logv), torch.tensor([float(done)]))
    assert _scaled_err(nf[0], jnf) < DELTA_ENVELOPE
    assert _scaled_err(lu[0], jlu) < DELTA_ENVELOPE
    s1, s2, mn, mx = stats[0].tolist()
    assert abs(s1 - float(js1)) <= DELTA_ENVELOPE * abs(float(js1))
    # a square doubles the relative error
    assert abs(s2 - float(js2)) <= 2 * DELTA_ENVELOPE * abs(float(js2))
    span = float(jmx) - float(jmn)
    assert abs(mn - float(jmn)) <= DELTA_ENVELOPE * span
    assert abs(mx - float(jmx)) <= DELTA_ENVELOPE * span

    # exact math in float64: float32 rounding only
    br, bc, bs = (r[0].numpy().astype(np.float64) for r in rows_t)
    d = np.einsum("cde,pc,pd,pe->p", phi.reshape(ncp, ncp, ncp).astype(
        np.float64), br, bc, bs) * wv
    nf64 = field + (0.0 if done else d)
    lu64 = (logv - nf64) * wv
    e1 = np.expm1(-d)
    assert _scaled_err(nf[0], nf64) < 1e-5
    assert _scaled_err(lu[0], lu64) < 1e-5
    assert abs(s1 - (wv * e1).sum()) <= 1e-5 * np.abs(wv * e1).sum()
    assert abs(s2 - (wv * e1 * e1).sum()) <= 1e-5 * (wv * e1 * e1).sum()
    if done:
        np.testing.assert_array_equal(nf[0].numpy(), field)


def _delta_inputs(ncp, seed):
    """Basis rows, weights and a smooth fitted lattice (positive
    coefficients of one scale), padded for the Pallas kernels too."""
    rng, rows_t, rows_j, wv = _fit_inputs(ncp, seed=seed)
    phi = (0.05 * (1.0 + 0.2 * rng.normal(size=(ncp, ncp * ncp)))).astype(
        np.float32)
    phi_pad = np.zeros((jp.CP, jp.FP), np.float32)
    phi_pad[:ncp, :ncp * ncp] = phi
    rows_t1 = [tn4._rows(r, 1) for r in rows_t]
    rows_j1 = [jp.basis_rows_padded(r, 1) for r in rows_j]
    f64 = np.einsum("cde,pc,pd,pe->p", phi.reshape(ncp, ncp, ncp).astype(
        np.float64), *(r[0].numpy().astype(np.float64) for r in rows_t))
    return rng, phi, jnp.asarray(phi_pad), rows_t1, rows_j1, wv, f64


@pytest.mark.parametrize("ncp", [4, 11])
def test_fit_delta_plain_matches_pallas(ncp):
    """K6: the raw delta at every voxel, padding included."""
    _, phi, phi_pad, rows_t1, rows_j1, wv, f64 = _delta_inputs(ncp, seed=2)
    want = jp.fit_delta_pallas(phi_pad, *rows_j1, ncp, interpret=True)
    got = n4_cuda.fit_delta(torch.from_numpy(phi)[None], *rows_t1)
    assert got.shape == (1, wv.shape[0])
    assert _scaled_err(got[0], want) < DELTA_ENVELOPE
    assert _scaled_err(got[0], f64) < 1e-5


@pytest.mark.parametrize("ncp", [4, 11])
def test_fit_delta_conv_plain_matches_pallas(ncp):
    """K7 against its Pallas kernel and float64; and against the shared
    code of K6 and K2, bit for bit."""
    rng, phi, phi_pad, rows_t1, rows_j1, wv, f64 = _delta_inputs(ncp, seed=3)
    jd, js1, js2 = jp.fit_delta_conv_pallas(
        phi_pad, *rows_j1, jnp.asarray(wv), ncp, interpret=True)
    t = lambda x: torch.from_numpy(x)[None]
    phi_t, wv_t = t(phi), t(wv)
    d, stats = n4_cuda.fit_delta_conv(phi_t, *rows_t1, wv_t)
    assert d.shape == (1, wv.shape[0]) and stats.shape == (1, 2)
    assert _scaled_err(d[0], jd) < DELTA_ENVELOPE
    s1, s2 = stats[0].tolist()
    assert abs(s1 - float(js1)) <= DELTA_ENVELOPE * abs(float(js1))
    # a square doubles the relative error
    assert abs(s2 - float(js2)) <= 2 * DELTA_ENVELOPE * abs(float(js2))

    # exact math in float64: float32 rounding only
    d64 = f64 * wv
    e1 = np.expm1(-d64)
    assert _scaled_err(d[0], d64) < 1e-5
    assert abs(s1 - (wv * e1).sum()) <= 1e-5 * np.abs(wv * e1).sum()
    assert abs(s2 - (wv * e1 * e1).sum()) <= 1e-5 * (wv * e1 * e1).sum()

    # the shared code: flush(K6) * wv is K7's d, and K2 with done = 0 has
    # K7's d as its field step and K7's sums as its first two statistics
    raw = n4_cuda.fit_delta(phi_t, *rows_t1)
    flushed = torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw)
    assert torch.equal(flushed * wv_t, d)
    logv = t(((3.0 + rng.normal(size=wv.shape)) * wv).astype(np.float32))
    nf, _, k2 = n4_cuda.fit_delta_conv_field_plain(
        phi_t, *rows_t1, wv_t, torch.zeros_like(wv_t), logv, torch.zeros(1))
    assert torch.equal(nf, d)       # a zero field plus the step
    assert torch.equal(k2[:, :2], stats)


def test_kernel_wrappers_reject_other_devices_and_ncp():
    meta = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        n4_cuda.fit_moment(torch.empty((1, 16), device="meta"),
                           meta, meta, meta)
    big = torch.zeros((1, n4_cuda.MAX_NCP + 1, 16))
    with pytest.raises(ValueError, match="ncp"):
        n4_cuda.fit_moment(torch.zeros((1, 16)), big, big, big)
    with pytest.raises(RuntimeError, match="no kernel"):
        n4_cuda.fit_delta(torch.empty((1, 4, 16), device="meta"), meta,
                          meta, meta)
    rows = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="phi"):
        n4_cuda.fit_delta_conv(torch.zeros((1, 4, 4)), rows, rows, rows,
                               torch.zeros((1, 16)))


@pytest.fixture(scope="module")
def n4_runs():
    """One 2-lane cohort through the port (batched and per lane), JAX and
    the oracle."""
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=0)
    pad = 8192
    kw = dict(mask_pad=pad, return_iters=True)
    port, port_iters = tn4.n4_bias_correction(
        torch.from_numpy(hp), torch.from_numpy(mask), **kw)
    single = [tn4.n4_bias_correction(torch.from_numpy(hp[i:i + 1]),
                                     torch.from_numpy(mask[i:i + 1]), **kw)
              for i in range(2)]
    jax_out = np.asarray(jax.jit(jax.vmap(
        lambda h, m: jn4.n4_bias_correction(h, m, mask_pad=pad)))(
            jnp.asarray(hp), jnp.asarray(mask)))
    oracle = n4_bias_correction_oracle(hp[0].astype(np.float64), mask[0])
    return dict(hp=hp, mask=mask, port=port.numpy(), iters=port_iters,
                single=single, jax=jax_out, oracle=np.asarray(oracle))


def _masked_rel(a, b, m):
    return float((np.abs(a - b)[m] / np.abs(b)[m]).max())


def _vdp(x, mask):
    return float(vdp_mean_anchored(torch.tensor(x, dtype=torch.float32)[None],
                                   torch.from_numpy(mask)[None])[1][0])


def test_n4_matches_jax(n4_runs):
    for i in range(2):
        m = n4_runs["mask"][i] > 0
        assert _masked_rel(n4_runs["port"][i], n4_runs["jax"][i], m) < 2e-3
        assert abs(_vdp(n4_runs["port"][i], n4_runs["mask"][i])
                   - _vdp(n4_runs["jax"][i], n4_runs["mask"][i])) < 0.1


def test_n4_matches_oracle(n4_runs):
    m = n4_runs["mask"][0] > 0
    assert _masked_rel(n4_runs["port"][0], n4_runs["oracle"], m) < 2e-3
    assert abs(_vdp(n4_runs["port"][0], n4_runs["mask"][0])
               - _vdp(n4_runs["oracle"], n4_runs["mask"][0])) < 0.1


def test_n4_lane_alone_equals_lane_in_batch(n4_runs):
    for i, (alone, iters) in enumerate(n4_runs["single"]):
        np.testing.assert_array_equal(alone[0].numpy(), n4_runs["port"][i])
        np.testing.assert_array_equal(iters[0].numpy(),
                                      n4_runs["iters"][i].numpy())


def test_n4_optional_outputs():
    hp, mask, _ = make_cohort(1, (32, 32, 8), VOX, seed=2)
    out, field, ovf, phi, (idx, cvals, wv) = tn4.n4_bias_correction(
        torch.from_numpy(hp), torch.from_numpy(mask), mask_pad=512,
        max_iters=3, return_field=True, return_overflow=True,
        return_phi=True, return_compacted=True)
    n_mask = int((mask > 0).sum())
    assert bool(ovf[0]) == (n_mask > 512)
    assert phi.shape == (1, sum(jn4.n4_phi_sizes()))
    np.testing.assert_allclose(out.numpy(), hp * np.exp(-field.numpy()),
                               rtol=1e-6)
    # the host rebuild of the dense field from phi (float64) agrees
    host = jn4.n4_field_from_phi_np(phi[0].numpy(), (32, 32, 8))
    np.testing.assert_allclose(field[0].numpy(), host, atol=1e-5)
    assert idx.shape == cvals.shape == wv.shape == (1, 512)
