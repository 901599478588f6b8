"""ventjax_torch's raw-data and mask-editing ops on the CPU: the TWIX codec
(io/twix.py), the k-space recon (ops/fft_recon.py), the Haar wavelet
(ops/wavelet.py) and the mask morphology (ops/morphology.py), against
ventjax's and against numpy / scipy.

Tolerances: TWIX files and their parsed contents equal byte for byte (the
same NumPy code); the recon within 1e-5 of max |image| of ventjax's
matmul DFT (float32 either way, other rounding) and of numpy's float64
FFT, with the same dtype and shape; the wavelet within 1e-6 of ventjax's
(the same float32 operations; XLA may fuse them); the morphology exact
against ventjax and scipy.ndimage.
"""
import numpy as np
import pytest
import torch

from ventjax.io import twix as jtwix
from ventjax.ops import fft_recon as jrecon
from ventjax.ops import morphology as jmo
from ventjax.ops import wavelet as jwave
from ventjax_torch.io import twix as ttwix
from ventjax_torch.ops import fft_recon as trecon
from ventjax_torch.ops import morphology as tmo
from ventjax_torch.ops import wavelet as twave

torch.set_num_threads(2)


def _kspace(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _np_recon(k):
    img = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(
        k.astype(np.complex128), axes=(0, 1)), axes=(0, 1)), axes=(0, 1))
    return np.transpose(img, (1, 0, 2))[:, ::-1, :]


# -------------------------------------------------------------------- TWIX

@pytest.mark.parametrize("layout", ["vd", "vb"])
@pytest.mark.parametrize("coils", [1, 3])
@pytest.mark.parametrize("service", [False, True])
def test_twix_writers_byte_equal_and_read_equal(tmp_path, layout, coils,
                                                service):
    shape = ((coils,) if coils > 1 else ()) + (16, 12, 3)
    k = _kspace(shape, coils)
    name = "write_synthetic_twix" + ("_vb" if layout == "vb" else "")
    kw = dict(protocol_name="vent_gre", service_scans=service,
              header_params={"TR_us": 9000})
    tp, jp = str(tmp_path / "t.dat"), str(tmp_path / "j.dat")
    getattr(ttwix, name)(tp, k, **kw)
    getattr(jtwix, name)(jp, k, **kw)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got, want = ttwix.read_twix(jp), jtwix.read_twix(tp)
    for f in ("meas_id", "protocol_name", "scan_datetime", "header_text",
              "n_channels", "header_params"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.header_params["RepetitionTime"] == 9.0
    assert np.array_equal(got.kspace_multicoil(), want.kspace_multicoil())
    if coils == 1:
        assert np.array_equal(got.kspace(), k)
    else:
        with pytest.raises(ValueError, match="kspace_multicoil"):
            got.kspace()


def test_twix_garbage_rejected_as_in_ventjax(tmp_path):
    for data in (b"\x00" * 4, b"\xff" * 64):
        p = tmp_path / "g.dat"
        p.write_bytes(data)
        with pytest.raises(ValueError) as got:
            ttwix.read_twix(str(p))
        with pytest.raises(ValueError) as want:
            jtwix.read_twix(str(p))
        assert str(got.value) == str(want.value)


def test_parse_header_params_matches_ventjax():
    text = ('tProtocolName = "x"\n<ParamString."SoftwareVersions"> '
            '{ "syngo" }\nalTR[0] = 4000\nalTE[0] = bad\n'
            'adFlipAngleDegree[0] = 12.5\n')
    assert ttwix.parse_header_params(text) == jtwix.parse_header_params(text)
    assert ttwix.parse_header_params("") == {}


# ------------------------------------------------------------------- recon

@pytest.mark.parametrize("shape", [(16, 12, 3), (15, 9, 2), (32, 32, 1)])
def test_recon_matches_ventjax_and_numpy(shape):
    k = _kspace(shape, 7)
    got = trecon.recon_2d_multislice(k, device="cpu")
    want = jrecon.recon_2d_multislice(k)
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape == (shape[1], shape[0], shape[2])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - _np_recon(k)).max() <= 1e-5 * scale


def test_recon_rss_matches_ventjax_and_numpy():
    k = _kspace((3, 16, 12, 2), 9)
    got = trecon.recon_2d_multislice_rss(k, device="cpu")
    want = jrecon.recon_2d_multislice_rss(k)
    ref = np.sqrt(sum(np.abs(_np_recon(c)) ** 2 for c in k))
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * want.max()
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()


# ----------------------------------------------------------------- wavelet

def test_haar_round_trip_and_ventjax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 8, 6)).astype(np.float32)
    ca, det = twave.haar_dwt2(torch.from_numpy(x))
    jca, jdet = jwave.haar_dwt2(x)
    for a, b in zip((ca,) + det, (jca,) + jdet):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
    back = twave.haar_idwt2(ca, det).numpy()
    assert np.abs(back - x).max() <= 1e-5


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("soft", [False, True])
def test_denoise_volume_matches_ventjax(levels, soft):
    rng = np.random.default_rng(levels)
    vol = rng.normal(size=(16, 12, 3)).astype(np.float32) * 10
    got = twave.denoise_volume(torch.from_numpy(vol), 4.0, levels, soft)
    want = np.asarray(jwave.denoise_volume(vol, 4.0, levels, soft))
    assert got.dtype == torch.float32 and got.shape == vol.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_denoise_volume_rejects_odd_sizes():
    with pytest.raises(ValueError, match="divisible"):
        twave.denoise_volume(torch.zeros(10, 8, 2), 1.0, levels=2)


# -------------------------------------------------------------- morphology

def _scipy_slicewise(fn, vol, **kw):
    out = np.zeros(vol.shape, bool)
    for s in range(vol.shape[2]):
        out[:, :, s] = fn(vol[:, :, s] > 0, **kw)
    return out


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(1234)
    v = (rng.random((24, 20, 4)) > 0.62).astype(np.float32)
    v[0, :3, 0] = 1        # touches the border: erosion's border semantics
    return v


@pytest.mark.parametrize("op", ["dilate", "erode", "open", "close"])
@pytest.mark.parametrize("slicewise", [True, False])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_morphology_matches_ventjax(vol, op, slicewise, connectivity):
    for iters in (1, 2):
        kw = dict(slicewise=slicewise, connectivity=connectivity)
        got = getattr(tmo, f"binary_{op}")(vol, iters, **kw)
        want = np.asarray(getattr(jmo, f"binary_{op}")(vol, iters, **kw))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), iters


def test_morphology_matches_scipy(vol):
    nd = pytest.importorskip("scipy.ndimage")
    for iters in (1, 2):
        assert np.array_equal(
            tmo.binary_dilate(vol, iters).numpy() > 0,
            _scipy_slicewise(nd.binary_dilation, vol, iterations=iters))
        assert np.array_equal(
            tmo.binary_erode(vol, iters).numpy() > 0,
            _scipy_slicewise(nd.binary_erosion, vol, iterations=iters))
    assert np.array_equal(tmo.binary_open(vol).numpy() > 0,
                          _scipy_slicewise(nd.binary_opening, vol))
    assert np.array_equal(tmo.binary_close(vol).numpy() > 0,
                          _scipy_slicewise(nd.binary_closing, vol))
    assert np.array_equal(tmo.binary_dilate(vol, slicewise=False).numpy() > 0,
                          nd.binary_dilation(vol > 0))
    assert np.array_equal(tmo.binary_erode(vol, slicewise=False).numpy() > 0,
                          nd.binary_erosion(vol > 0))
    box = np.ones((3, 3), bool)
    assert np.array_equal(
        tmo.binary_dilate(vol, connectivity=2).numpy() > 0,
        _scipy_slicewise(nd.binary_dilation, vol, structure=box))
    # a leading batch dimension edits each volume alone
    two = np.stack([vol, 1 - vol])
    got = tmo.binary_erode(two, 1).numpy()
    assert np.array_equal(got[1] > 0, tmo.binary_erode(1 - vol).numpy() > 0)


def _holes_volume():
    v = np.zeros((32, 28, 3), np.float32)
    v[5:15, 5:15, :] = 1
    v[8:12, 8:12, :] = 0          # enclosed hole -> fills
    v[20:30, 10:20, 1] = 1
    v[24:27, 13:17, 1] = 0        # enclosed hole -> fills
    v[0:6, 20:24, 0] = 1
    v[0:3, 21:23, 0] = 0          # open to the border -> stays
    return v


def _spiral_volume(n=41):
    """A background corridor that winds through the mask and opens only at
    the border: its geodesic length far exceeds H+W."""
    sl = np.ones((n, n), np.float32)
    r0, r1, c0, c1 = 0, n - 1, 0, n - 1
    sl[r0, c0:c1 + 1] = 0
    while r1 - r0 > 4 and c1 - c0 > 4:
        sl[r0:r1 + 1, c1] = 0
        sl[r1, c0 + 2:c1 + 1] = 0
        sl[r0 + 2:r1 + 1, c0 + 2] = 0
        r0, r1, c0, c1 = r0 + 2, r1 - 2, c0 + 2, c1 - 2
        sl[r0, c0:c1 + 1] = 0
    return sl[:, :, None]


@pytest.mark.parametrize("case", ["holes", "spiral"])
@pytest.mark.parametrize("slicewise", [True, False])
def test_fill_holes_matches_scipy_and_ventjax(case, slicewise):
    nd = pytest.importorskip("scipy.ndimage")
    v = _holes_volume() if case == "holes" else _spiral_volume()
    got = tmo.fill_holes(v, slicewise=slicewise).numpy()
    assert np.array_equal(got,
                          np.asarray(jmo.fill_holes(v, slicewise=slicewise)))
    want = (_scipy_slicewise(nd.binary_fill_holes, v) if slicewise
            else nd.binary_fill_holes(v > 0))
    assert np.array_equal(got > 0, want)


def test_edit_mask_recipe_matches_ventjax(vol):
    recipe = "close:1, fillholes, erode:2"
    got = tmo.edit_mask(vol, recipe)
    assert np.array_equal(got.numpy(), np.asarray(jmo.edit_mask(vol, recipe)))
    manual = tmo.binary_erode(tmo.fill_holes(tmo.binary_close(vol, 1)), 2)
    assert torch.equal(got, manual)
    assert np.array_equal(tmo.edit_mask(vol, "").numpy(), vol > 0)
    for bad, match in (("sharpen:1", "unknown mask-edit op"),
                       ("dilate:x", "bad iteration count"),
                       ("dilate:-1", "negative")):
        with pytest.raises(ValueError, match=match):
            tmo.edit_mask(vol, bad)
