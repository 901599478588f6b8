"""ventjax_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test takes the ``cuda`` fixture, which skips when no
GPU is present (decided at run time, never at import).  On a machine with
an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which sets up JAX; this file
imports no JAX.)  Tolerances: K1/K2 relative 1e-5 of each output's largest
magnitude, the same float32 algorithm in another summation order; K3 and
the CI map bit-equal.
"""
import numpy as np
import pytest
import torch

from ventjax.config import DEFAULT_CONFIG
from ventjax.io.phantom import make_cohort
from ventjax_torch.ops import ci_cuda, n4_cuda
from ventjax_torch.ops import ci_pairwise as tcp
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
    for d in (n4_cuda.LAUNCHES, ci_cuda.LAUNCHES):
        for k in d:
            d[k] = 0
    gpu = analyze_cohort(torch.from_numpy(hp).to(cuda),
                         torch.from_numpy(mask).to(cuda), geom, cfg)
    cpu = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask), geom,
                         cfg)
    assert all(v > 0 for v in {**n4_cuda.LAUNCHES,
                               **ci_cuda.LAUNCHES}.values())
    for name in ("vdp", "vdp_lb", "vdp_km"):
        d = (getattr(gpu.metrics, name).cpu() - getattr(cpu.metrics, name))
        assert float(d.abs().max()) < 0.1, name
    for i in range(2):
        if torch.equal(gpu.defect[i].cpu(), cpu.defect[i]):
            assert torch.equal(gpu.ci_map[i].cpu(), cpu.ci_map[i])
