"""ventjax_torch's gather-scan CI engines (ops/ci.py) and the pipeline's
fallback to them, against ventjax and the float64 oracle.

The engines count 0/1 defect hits in float32 (exact integers) and compare
each ball's fraction with 0.5 after one float32 division, as ventjax does,
so on the same defect array the port must be BIT-equal to ventjax: CI maps,
saturation counts, both overflow flags.  Against the float64 oracle the
ladder is exact too (ventjax/config.py: both engines are exact): on the
fallback geometry every voxel gets the oracle's ball, so the map equals the
oracle's written as the engines write it (float32 radius times float32
min(vox)) at max-abs 0; elsewhere it is held to the unrounded oracle map
at 2e-5 mm (float32 radii).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.io.phantom import make_cohort
from ventjax.ops import ci as jci
from ventjax.oracle.ci_oracle import (
    calculate_ci_oracle, shell_structure, sphere_pixels,
)
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.ops import ci as tci
from ventjax_torch.ops.ci_pairwise import (
    CIPairwiseGeometry, build_ci_pairwise_geometry,
)
from ventjax_torch.pipeline import analyze_cohort, build_geometry

torch.set_num_threads(2)

SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)
RMAX = 20        # ~5000 LUT rows: three ladder stages
WITNESS_VOX = (3.125, 3.125, 15.0)
WITNESS_SHAPE = (32, 32, 6)
# A small N4 keeps the pipeline tests short; the CI engines see its defects.
FAST = DEFAULT_CONFIG.replace(n4_fitting_levels=2, n4_max_iters=5,
                              n4_mask_pad=4096, ci_max_defect_voxels=512)


def _defects(seed, cluster=True):
    rng = np.random.default_rng(seed)
    d = (rng.random(SHAPE) > 0.97).astype(np.float32)
    if cluster:
        d[8:14, 8:14, 2:5] = 1.0    # non-trivial crossings
    d[0:3, 28:32, 0:2] = 1.0        # touching borders: the wrap aliases
    return d


def _oracle_f32(defect, vox, rmax):
    """The oracle's CI map with each voxel's ball radius written as the
    engines write it, float32(radius) * float32(min(vox)): equal to an
    engine's map iff both chose the same ball at every voxel."""
    want = calculate_ci_oracle(defect, vox=vox, rmax=rmax, saturate=True)
    radii = shell_structure(sphere_pixels(vox, rmax))[0]
    min_vox = float(np.min(vox))
    j = np.searchsorted(radii * min_vox, want)
    assert np.array_equal(radii[j] * min_vox, want) or not want.any()
    out = radii.astype(np.float32)[j] * np.float32(min_vox)
    return np.where(defect != 0, out, np.float32(0.0))


def _check_lanes(got, defects, want_fn):
    for i, d in enumerate(defects):
        want = want_fn(jnp.asarray(d))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            assert int(g[i]) == int(w)


@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_geometry_equals_ventjax(border):
    want = jci.build_ci_geometry(VOX, SHAPE, RMAX, border)
    got = tci.build_ci_geometry(VOX, SHAPE, RMAX, border)
    for name in want.__dataclass_fields__:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert tci._snap_stage_rows(got, (640, 4096, 16384)) == \
        jci._snap_stage_rows(want, (640, 4096, 16384))


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("engine", ["flat", "staged"])
def test_ci_bit_equal_jax_batched(border, engine):
    """Two lanes in one batch, each against ventjax's single volume."""
    defects = [_defects(3), _defects(4, cluster=False)]
    gt = tci.build_ci_geometry(VOX, SHAPE, RMAX, border)
    gj = jci.build_ci_geometry(VOX, SHAPE, RMAX, border)
    batch = torch.from_numpy(np.stack(defects))
    if engine == "flat":
        got = tci.calculate_ci(batch, gt, 512, chunk=64)
        want_fn = lambda d: jci.calculate_ci(d, gj, 512, chunk=64)
    else:
        # a small chunk_elems: many chunks per stage, same bits
        got = tci.calculate_ci_staged(batch, gt, 512, chunk_elems=1 << 16)
        want_fn = lambda d: jci.calculate_ci_staged(d, gj, 512)
    _check_lanes(got, defects, want_fn)
    assert not got[2].any()
    if border == "wrap":     # the oracle replicates the reference's wrap
        for i, d in enumerate(defects):
            want = calculate_ci_oracle(d, vox=VOX, rmax=RMAX, saturate=True)
            assert np.abs(got[0][i].numpy() - want).max() < 2e-5


def test_ci_saturated_all_defect_volume():
    """Every aliased index of an all-defect volume is defect, so no ball
    ever drops below 0.5: every voxel saturates at the last tested radius
    (where the reference raises), counted; flat and staged agree."""
    defect = np.ones((16, 16, 16), np.float32)
    vox = (1.0, 1.0, 1.0)
    gt = tci.build_ci_geometry(vox, defect.shape, 6, "wrap")
    gj = jci.build_ci_geometry(vox, defect.shape, 6, "wrap")
    batch = torch.from_numpy(defect[None])
    flat = tci.calculate_ci(batch, gt, 4096, chunk=256)
    _check_lanes(flat, [defect],
                 lambda d: jci.calculate_ci(d, gj, 4096, chunk=256))
    staged = tci.calculate_ci_staged(batch, gt, 4096)
    _check_lanes(staged, [defect],
                 lambda d: jci.calculate_ci_staged(d, gj, 4096))
    np.testing.assert_array_equal(staged[0].numpy(), flat[0].numpy())
    assert int(flat[1][0]) > 0 and not bool(flat[2][0])
    want = calculate_ci_oracle(defect, vox=vox, rmax=6, saturate=True)
    assert np.abs(flat[0][0].numpy() - want).max() < 2e-5


def test_stage_overflow_when_stage_k_too_small():
    """More unresolved voxels than a stage takes: the excess saturate and
    are counted in the stage overflow, as in ventjax; a roomy stage_k
    clears it."""
    d = np.zeros(SHAPE, np.float32)
    d[4:20, 4:20, 1:6] = 1.0        # one dense cluster: deep crossings
    gt = tci.build_ci_geometry(VOX, SHAPE, RMAX, "wrap")
    gj = jci.build_ci_geometry(VOX, SHAPE, RMAX, "wrap")
    kw = dict(stage_k=(64, 16, 8))
    got = tci.calculate_ci_staged(torch.from_numpy(d[None]), gt, 2048, **kw)
    _check_lanes(got, [d], lambda x: jci.calculate_ci_staged(x, gj, 2048,
                                                             **kw))
    assert int(got[3][0]) > 0 and not bool(got[2][0])
    roomy = tci.calculate_ci_staged(torch.from_numpy(d[None]), gt, 2048,
                                    stage_k=(2048, 2048, 2048))
    assert int(roomy[3][0]) == 0
    np.testing.assert_array_equal(
        roomy[0].numpy(),
        tci.calculate_ci(torch.from_numpy(d[None]), gt, 2048)[0].numpy())


@pytest.mark.parametrize("engine", ["ladder", "full"])
def test_build_geometry_other_engines_get_the_ladder(engine):
    geom = build_geometry(VOX, SHAPE, DEFAULT_CONFIG.replace(ci_engine=engine))
    assert isinstance(geom, tci.CIGeometry)


def test_build_geometry_falls_back_where_pairwise_proof_fails():
    """The witness geometry fails the pairwise engine's float32 proof; the
    pipeline falls back to the ladder, whose CI map equals the oracle's."""
    cfg = FAST.replace(ci_rmax=20)
    with pytest.raises(ValueError):
        build_ci_pairwise_geometry(WITNESS_VOX, WITNESS_SHAPE, 20, "wrap")
    geom = build_geometry(WITNESS_VOX, WITNESS_SHAPE, cfg)
    assert isinstance(geom, tci.CIGeometry)
    hp, mask, _ = make_cohort(2, WITNESS_SHAPE, WITNESS_VOX, seed=5)
    res = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask), geom,
                         cfg)
    assert not res.metrics.ci_overflow.any()
    assert res.metrics.valid.all()
    for i in range(2):
        defect = res.defect[i].numpy()
        assert defect.sum() > 0
        want = _oracle_f32(defect, WITNESS_VOX, 20)
        assert np.abs(res.ci_map[i].numpy() - want).max() == 0.0
    # and the ladder alone on random defects
    defect = (np.random.default_rng(1234).random(WITNESS_SHAPE)
              > 0.95).astype(np.float32)
    ci, nsat, ovf, sovf = tci.calculate_ci_staged(
        torch.from_numpy(defect[None]), geom, 512)
    assert not bool(ovf[0]) and int(sovf[0]) == 0
    want = _oracle_f32(defect, WITNESS_VOX, 20)
    assert np.abs(ci[0].numpy() - want).max() == 0.0


def test_ci_engine_ladder_through_analyze_cohort():
    """ci_engine="ladder" on the default geometry: the same CI map and
    metrics as the pairwise engine (both exact), clean flags."""
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=1)
    h, m = torch.from_numpy(hp), torch.from_numpy(mask)
    pair = analyze_cohort(h, m, build_geometry(VOX, SHAPE, FAST), FAST)
    lcfg = FAST.replace(ci_engine="ladder")
    lgeom = build_geometry(VOX, SHAPE, lcfg)
    assert isinstance(lgeom, tci.CIGeometry)
    assert not isinstance(build_geometry(VOX, SHAPE, FAST), tci.CIGeometry)
    assert isinstance(build_geometry(VOX, SHAPE, FAST), CIPairwiseGeometry)
    lad = analyze_cohort(h, m, lgeom, lcfg)
    assert lad.defect.sum() > 0
    np.testing.assert_array_equal(lad.ci_map.numpy(), pair.ci_map.numpy())
    for name in ("ci", "ci_saturated", "ci_overflow", "vdp", "valid"):
        np.testing.assert_array_equal(getattr(lad.metrics, name).numpy(),
                                      getattr(pair.metrics, name).numpy())
    assert not lad.metrics.ci_overflow.any()
