"""ventjax_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test takes the ``cuda`` fixture, which skips when no
GPU is present (decided at run time, never at import).  On a machine with
an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which sets up JAX; this file
imports no JAX.)  Tolerances: K1/K2 relative 1e-5 of each output's largest
magnitude, the same float32 algorithm in another summation order; K4
relative 1e-5 of the largest bin against its plain version, whose float32
atomics sum in another order (the kernel's fixed-point sum is nearer the
exact one), and bit-identical from launch to launch; K5 bit-equal, the same
float32 operations in the same order; K3, K8, K9 and the CI map bit-equal.
"""
import numpy as np
import pytest
import torch

from ventjax.config import DEFAULT_CONFIG
from ventjax.io.phantom import make_cohort
from ventjax_torch.ops import ci_cuda, ci_densify_cuda, n4_cuda
from ventjax_torch.ops import ci_pairwise as tcp
from ventjax_torch.ops import n4 as tn4
from ventjax_torch.ops import n4_sharpen_cuda as sc
from ventjax_torch.pipeline import analyze_cohort, build_geometry

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _rows(ncp, N, P, gen, dev):
    return [torch.from_numpy(gen.random((N, ncp, P)).astype(np.float32)).to(dev)
            for _ in range(3)]


@pytest.mark.parametrize("ncp", list(range(1, n4_cuda.MAX_NCP + 1)))
def test_fit_kernels_every_ncp(cuda, ncp):
    gen = np.random.default_rng(ncp)
    N, P = 3, 5000                      # P not a chunk multiple: ragged edge
    rows = _rows(ncp, N, P, gen, cuda)
    a = torch.from_numpy(gen.random((N, P)).astype(np.float32)).to(cuda)
    got = n4_cuda.fit_moment(a, *rows)
    assert _err(got, n4_cuda.fit_moment_plain(a, *rows)) < RTOL

    phi = torch.from_numpy(gen.random((N, ncp, ncp * ncp)).astype(
        np.float32)).to(cuda) * 0.01
    wv = (torch.arange(P, device=cuda)[None] < P - 100).float().expand(
        N, P).contiguous()
    field = torch.zeros((N, P), device=cuda)
    logv = torch.ones((N, P), device=cuda) * wv
    done = torch.tensor([0.0, 1.0, 0.0], device=cuda)
    got = n4_cuda.fit_delta_conv_field(phi, *rows, wv, field, logv, done)
    want = n4_cuda.fit_delta_conv_field_plain(phi, *rows, wv, field, logv,
                                              done)
    assert _err(got[0], want[0]) < RTOL
    assert _err(got[1], want[1]) < RTOL
    assert _err(got[2], want[2]) < RTOL
    assert torch.equal(got[0][1], field[1])     # the frozen lane


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("K,Kw", [(100, 100), (777, 1300)])
def test_head_counts_bit_equal(cuda, border, K, Kw):
    gen = np.random.default_rng(K)
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (64, 64, 8), 50,
                                          border)
    ns = min(96, geom.n_balls - 1)
    coord = lambda n, hi, lo=0: torch.from_numpy(
        gen.integers(lo, hi, size=(2, n)).astype(np.int32)).to(cuda)
    centers = (coord(K, 64), coord(K, 64), coord(K, 8))
    witnesses = (coord(Kw, 64), coord(Kw, 64), coord(Kw, 8))
    witnesses[1][:, -5:] = -tcp.SENT           # sentinel rows widen ranges
    r2 = torch.as_tensor(geom.r2_32[:ns], device=cuda)
    combos = tcp._alias_combos(geom)
    got = ci_cuda.head_counts(centers, witnesses, r2, combos, geom.scale,
                              geom.rmax)
    want = ci_cuda.head_counts_plain(centers, witnesses, r2, combos,
                                     geom.scale, geom.rmax)
    assert torch.equal(got, want)


def test_cohort_on_card_matches_cpu(cuda):
    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
    hp, mask, _ = make_cohort(2, shape, vox, seed=0)
    geom = build_geometry(vox, shape, cfg)
    counts = (n4_cuda.LAUNCHES, sc.LAUNCHES, ci_cuda.LAUNCHES)
    for d in counts:
        for k in d:
            d[k] = 0
    gpu = analyze_cohort(torch.from_numpy(hp).to(cuda),
                         torch.from_numpy(mask).to(cuda), geom, cfg)
    cpu = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask), geom,
                         cfg)
    assert all(v > 0 for d in counts for v in d.values())
    for name in ("vdp", "vdp_lb", "vdp_km"):
        d = (getattr(gpu.metrics, name).cpu() - getattr(cpu.metrics, name))
        assert float(d.abs().max()) < 0.1, name
    for i in range(2):
        if torch.equal(gpu.defect[i].cpu(), cpu.defect[i]):
            assert torch.equal(gpu.ci_map[i].cpu(), cpu.ci_map[i])


def _sharpen_lanes(N, P, gen, dev, bins):
    """Masked log residuals with a padded tail, a lane with no weighted
    voxel and a constant lane, and the range and slope N4 gives them."""
    wv = (torch.arange(P)[None] < torch.tensor([P - 37 * n for n in range(
        N)])[:, None]).float()
    lu = torch.from_numpy(gen.normal(5.0, 0.7, (N, P)).astype(
        np.float32)) * wv
    wv[0] = 0.0
    lu[1] = 4.0 * wv[1]
    lu, wv = lu.to(dev), wv.to(dev)
    bmn, bmx = tn4._masked_range(lu, wv)
    return lu, wv, bmn, (bmx - bmn) / (bins - 1)


@pytest.mark.parametrize("bins", [200, 300])
def test_sharpen_hist_kernel(cuda, bins):
    gen = np.random.default_rng(bins)
    lu, wv, bmn, slope = _sharpen_lanes(5, 10000, gen, cuda, bins)
    got = sc.sharpen_hist(lu, wv, bmn, slope, bins)
    again = sc.sharpen_hist(lu, wv, bmn, slope, bins)
    want = sc.sharpen_hist_plain(lu, wv, bmn, slope, bins)
    assert torch.equal(got, again)             # deterministic
    assert bool(torch.isfinite(got).all())
    assert float(got[0].abs().sum()) == 0.0    # nothing weighted
    assert _err(got[1:], want[1:]) < RTOL
    assert torch.equal(got[1], want[1])        # one bin of whole voxels


def test_sharpen_resid_kernel(cuda):
    gen = np.random.default_rng(7)
    bins = 200
    lu, wv, bmn, slope = _sharpen_lanes(5, 10000, gen, cuda, bins)
    e_loc = torch.from_numpy(gen.normal(5.0, 1.0, (5, bins + 2)).astype(
        np.float32)).to(cuda)
    sv = torch.from_numpy(gen.random((5, 10000)).astype(np.float32)).to(
        cuda) + 0.01
    got = sc.sharpen_resid(lu, wv, sv, e_loc, bmn, slope, bins)
    want = sc.sharpen_resid_plain(lu, wv, sv, e_loc, bmn, slope, bins)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    assert bool((got[wv == 0] == 0).all())


@pytest.mark.parametrize("K", [512, 4096])
@pytest.mark.parametrize("V", [262144, 100003])
def test_rank_densify_bit_equal(cuda, K, V):
    gen = np.random.default_rng(V + K)
    rate = np.array([0.0, 0.3 * K / V, 2.0 * K / V, 1.0])[:, None]
    d01 = torch.from_numpy(gen.random((4, V)) < rate).to(cuda)
    r = ci_densify_cuda.rank(d01)
    assert torch.equal(r, ci_densify_cuda.rank_plain(d01))
    cv = torch.from_numpy(gen.random((4, K)).astype(np.float32)).to(cuda)
    got = ci_densify_cuda.densify_rank(r, d01, cv, K)
    assert torch.equal(got, ci_densify_cuda.densify_rank_plain(r, d01, cv, K))


def test_n4_deterministic_on_card(cuda):
    """Two N4 runs on one CUDA batch give the same bits and iteration
    counts: nothing on the path sums with float atomics."""
    hp, mask, _ = make_cohort(4, (64, 64, 8), (1.5, 1.5, 10.0), seed=2)
    hp_d = torch.from_numpy(hp).to(cuda)
    mask_d = torch.from_numpy(mask).to(cuda)
    sc.LAUNCHES.update(sharpen_hist=0, sharpen_resid=0)
    runs = [tn4.n4_bias_correction(hp_d, mask_d, mask_pad=8192,
                                   return_iters=True) for _ in range(2)]
    assert sc.LAUNCHES["sharpen_hist"] > 0
    assert sc.LAUNCHES["sharpen_resid"] == sc.LAUNCHES["sharpen_hist"]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
