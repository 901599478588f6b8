"""ventjax_torch's oracle copy (ventjax_torch/oracle) bit-equal to
ventjax.oracle on seeded phantoms: the same NumPy arithmetic in the same
order, so every output is equal, not close."""
import numpy as np
import pytest

from ventjax.oracle import n4_oracle as jax_n4
from ventjax.oracle import reference as jax_ref
from ventjax_torch.io.phantom import make_phantom
from ventjax_torch.oracle import n4_oracle as tn4
from ventjax_torch.oracle import reference as tref

VOX = (1.5, 1.5, 10.0)


@pytest.fixture(scope="module")
def ph():
    return make_phantom(shape=(32, 32, 8), vox=VOX, seed=7)


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert a == b or (a != a and b != b), (a, b)


CASES = {
    "normalize": lambda m, p: m.normalize(p.hp),
    "normalize_constant": lambda m, p: m.normalize(np.ones((4, 4, 2))),
    "calculate_border": lambda m, p: m.calculate_border(p.mask),
    "crop_to_data": lambda m, p: m.crop_to_data(p.mask, border=2),
    "crop_to_data_slices": lambda m, p: m.crop_to_data(
        p.hp * p.mask, border=1, border_slices=True),
    "calculate_snr": lambda m, p: m.calculate_snr(p.hp, p.mask, 4),
    "vdp_mean_anchored": lambda m, p: m.vdp_mean_anchored(p.hp, p.mask),
    "vdp_linear_binning": lambda m, p: m.vdp_linear_binning(p.hp, p.mask),
    "vdp_kmeans": lambda m, p: m.vdp_kmeans(p.hp, p.mask),
    "build_4d_array": lambda m, p: m.build_4d_array(
        p.hp, p.mask, proton=p.proton, n4=p.hp * 2, defect=p.mask,
        ci=np.ones(p.hp.shape[:2] + (1,))),
    "lung_volume_liters": lambda m, p: m.lung_volume_liters(p.mask, VOX),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_bit_equal(ph, name):
    _equal(CASES[name](tref, ph), CASES[name](jax_ref, ph))


def test_n4_pieces_bit_equal(ph):
    rng = np.random.default_rng(3)
    vals = rng.normal(5.0, 0.5, 2000)
    _equal(tn4.sharpen_log_intensities(vals),
           jax_n4.sharpen_log_intensities(vals))
    _equal(tn4.sharpen_log_intensities(np.full(8, 2.0)),
           jax_n4.sharpen_log_intensities(np.full(8, 2.0)))
    for n, e in ((32, 1), (8, 4), (1, 2)):
        _equal(tn4.bspline_basis_1d(n, e), jax_n4.bspline_basis_1d(n, e))
    resid = rng.normal(size=ph.hp.shape)
    w = (ph.mask > 0).astype(np.float64)
    _equal(tn4.fit_bspline_field(resid, w, 2),
           jax_n4.fit_bspline_field(resid, w, 2))
    assert tn4._next_pow2_padded(200) == jax_n4._next_pow2_padded(200)


@pytest.mark.parametrize("levels", [1, 4])
def test_n4_oracle_bit_equal(ph, levels):
    got = tn4.n4_bias_correction_oracle(ph.hp, ph.mask,
                                        fitting_levels=levels,
                                        return_field=True)
    want = jax_n4.n4_bias_correction_oracle(ph.hp, ph.mask,
                                            fitting_levels=levels,
                                            return_field=True)
    _equal(got, want)
