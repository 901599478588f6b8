"""ventjax_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test takes the ``cuda`` fixture, which skips when no
GPU is present (decided at run time, never at import).  On a machine with
an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(``--noconftest`` skips tests/conftest.py, which sets up JAX; this file
imports no JAX, and nothing of the ventjax package.)  Tolerances:
K1/K2/K6/K7 relative 1e-5 of each output's largest magnitude, the same
float32 algorithm in another summation order (and K7 bit-equal to K2 with
done = 0 and to the flushed, weighted K6: they share their code); K1 and
K2 bit-identical from launch to launch; K4 relative 1e-5 of the largest bin
against its plain version, whose float32 atomics sum in another order (the
kernel's fixed-point sum is nearer the exact one), bit-equal to its exact
fixed-point plain version, and bit-identical from launch to launch; K5
bit-equal, the same float32 operations in the same order; K3, K10
(against its plain version, the sort path), K8, K9 and the CI maps of both
engines bit-equal.  The Vent_Analysis facade on the
card against the CPU: defect arrays and CI map equal, VDPs within 0.1 pp;
mask editing equal; the k-space recon within 1e-5 of max |image| (cuFFT
against PyTorch's CPU FFT, both float32).  The segmentation U-Net (cuDNN
convolutions, TF32 off) against the CPU: masks equal except where the CPU
|logit| < 1e-3, a repeat bit-identical; one train step's loss within 1e-5
relative and its parameters within 1e-5 absolute.  dist/ on shards of the
one card: the halo CI and the batch mesh bit-equal to their unsharded runs.
N4's dense field (the n4_field kernel) bit-equal to its plain version, and
every output of the pipeline the same in groups of 1, 2 and 4 lanes.  The
space axis: K1's partial and reduce, K2's fold and K4's partial and finish
bit-equal to their plain versions (K1's partial within 1e-5) and to the
one-call entry points; a slab's field rows bit-equal to the full field's;
the pipeline over a (2, 4) mesh of the card, and over two gloo ranks
sharing it, bit-equal to analyze_cohort.  The pipeline runs under the
sync-debug mode "error" at both CI pads the benchmark's cells reach: every
host wait on its path is a declared ``host_wait``, N4's graph captures
included.  N4's level loop as CUDA graphs bit-equal to its eager loop, a
later call replaying without a capture.
"""
import numpy as np
import pytest
import torch

from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.ops import ci as tci
from ventjax_torch.ops import ci_cuda, ci_densify_cuda, n4_cuda
from ventjax_torch.ops import ci_pairwise as tcp
from ventjax_torch.ops import n4 as tn4
from ventjax_torch.ops import n4_sharpen_cuda as sc
from ventjax_torch.pipeline import (
    analyze_cohort, analyze_cohort_grouped, build_geometry,
)

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


def _spline_lanes(ncp, P, gen, dev, power):
    """B-spline rows of N4's shape for five lanes of P compacted voxels of a
    40x32x8 grid: raster order; raster order with a = 0; only the first
    two rows of h (non-zero window at c = 0); only the last row (window at
    c = ncp - 1); shuffled order (wide windows everywhere).  Returns a
    [5, P] and the three [5, ncp, P] rows."""
    H, W, D = 40, 32, 8
    n_el = ncp - 3 if ncp > 3 else 1
    vol = np.arange(H * W * D)
    hs = vol // (W * D)
    pools = [vol, vol, vol[hs <= 1], vol[hs == H - 1], vol]
    idx = np.stack([np.sort(gen.choice(pool, P)) for pool in pools])
    idx[4] = gen.permutation(idx[4])
    idx = torch.from_numpy(idx).to(dev)
    bv = [tn4._bspline_rows(c, n, n_el) for c, n in (
        (idx // (W * D), H), ((idx // D) % W, W), (idx % D, D))]
    if ncp <= 3:     # the kernels take any ncp; keep the rows' width
        bv = [b[..., :ncp] for b in bv]
    rows = [tn4._rows(b, power) for b in bv]
    a = torch.from_numpy(gen.normal(size=(5, P)).astype(np.float32)).to(dev)
    a[1] = 0.0
    return a, rows


@pytest.mark.parametrize("P", [4099, 6144])
@pytest.mark.parametrize("ncp", [1, 4, 5, 7, 11, 16])
def test_fit_moment_spline_rows(cuda, ncp, P):
    """K1 on B-spline rows as N4 gives them (the zero-row skips at work), at
    P not a multiple of the tile (256) or the chunk (2048), 4-byte and
    16-byte staging: within RTOL of the plain version, a lane with a = 0
    exactly 0, and bit-identical on relaunch."""
    gen = np.random.default_rng(1000 + ncp + P)
    for power in (2, 3):
        a, rows = _spline_lanes(ncp, P, gen, cuda, power)
        got = n4_cuda.fit_moment(a, *rows)
        want = n4_cuda.fit_moment_plain(a, *rows)
        for n in range(5):
            if bool(want[n].any()):
                assert _err(got[n], want[n]) < RTOL, (power, n)
            else:          # a = 0, or (ncp 1) no support in the last row
                assert not bool(got[n].any()), (power, n)
        assert not bool(got[1].any())
        assert torch.equal(got, n4_cuda.fit_moment(a, *rows))
        den = n4_cuda.fit_moment(torch.ones_like(a), *rows)
        assert _err(den, n4_cuda.fit_moment_plain(torch.ones_like(a), *rows)
                    ) < RTOL


@pytest.mark.parametrize("ncp", list(range(1, n4_cuda.MAX_NCP + 1)))
def test_fit_delta_kernels_every_ncp(cuda, ncp):
    """K6 and K7 against their plain versions, and against K2 (done = 0)
    and each other bit for bit."""
    gen = np.random.default_rng(100 + ncp)
    N, P = 3, 5000
    rows = _rows(ncp, N, P, gen, cuda)
    phi = torch.from_numpy(gen.random((N, ncp, ncp * ncp)).astype(
        np.float32)).to(cuda) * 0.01
    wv = (torch.arange(P, device=cuda)[None] < P - 100).float().expand(
        N, P).contiguous()
    raw = n4_cuda.fit_delta(phi, *rows)
    assert _err(raw, n4_cuda.fit_delta_plain(phi, *rows)) < RTOL
    d, stats = n4_cuda.fit_delta_conv(phi, *rows, wv)
    dp, sp = n4_cuda.fit_delta_conv_plain(phi, *rows, wv)
    assert _err(d, dp) < RTOL and _err(stats, sp) < RTOL
    flushed = torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw)
    assert torch.equal(flushed * wv, d)
    zero = torch.zeros((N, P), device=cuda)
    nf, _, k2 = n4_cuda.fit_delta_conv_field(
        phi, *rows, wv, zero, torch.ones_like(wv), torch.zeros(N, device=cuda))
    assert torch.equal(nf, d) and torch.equal(k2[:, :2], stats)


@pytest.mark.parametrize("P", [4099, 6144])
@pytest.mark.parametrize("ncp", [1, 4, 5, 7, 11, 16])
def test_fit_delta_spline_rows(cuda, ncp, P):
    """K2, K6 and K7 on B-spline rows as N4 gives them (power 1: the
    windowed contraction at work; the shuffled lane gives every thread of a
    warp its own windows), at P not a multiple of the tile or the chunk,
    with a phi that holds exact zeros: K2 within RTOL of the plain version,
    bit-identical on relaunch, frozen lanes exact, K7 bit-equal to K2 with
    done = 0 and to the flushed, weighted K6, and the per-lane tickets back
    at 0 after every launch."""
    gen = np.random.default_rng(2000 + ncp + P)
    _, rows = _spline_lanes(ncp, P, gen, cuda, 1)
    N = 5
    phi = gen.normal(0.05, 0.02, (N, ncp, ncp * ncp)).astype(np.float32)
    phi[gen.random(phi.shape) < 0.3] = 0.0
    phi = torch.from_numpy(phi).to(cuda)
    wv = (torch.arange(P, device=cuda)[None] < torch.tensor(
        [P - 37 * n for n in range(N)], device=cuda)[:, None]).float()
    field = torch.from_numpy(gen.normal(0.0, 0.01, (N, P)).astype(
        np.float32)).to(cuda) * wv
    logv = torch.from_numpy(gen.normal(5.0, 0.5, (N, P)).astype(
        np.float32)).to(cuda) * wv
    done = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0], device=cuda)
    got = n4_cuda.fit_delta_conv_field(phi, *rows, wv, field, logv, done)
    want = n4_cuda.fit_delta_conv_field_plain(phi, *rows, wv, field, logv,
                                              done)
    for g, w in zip(got, want):
        assert _err(g, w) < RTOL
    again = n4_cuda.fit_delta_conv_field(phi, *rows, wv, field, logv, done)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0][done == 1], field[done == 1])

    raw = n4_cuda.fit_delta(phi, *rows)
    assert _err(raw, n4_cuda.fit_delta_plain(phi, *rows)) < RTOL
    d, stats = n4_cuda.fit_delta_conv(phi, *rows, wv)
    flushed = torch.where(raw.abs() < 1e-18, torch.zeros_like(raw), raw)
    assert torch.equal(flushed * wv, d)
    nf, _, k2 = n4_cuda.fit_delta_conv_field(
        phi, *rows, wv, torch.zeros_like(wv), logv,
        torch.zeros(N, device=cuda))
    assert torch.equal(nf, d) and torch.equal(k2[:, :2], stats)
    torch.cuda.synchronize()
    assert all(not bool(t.any()) for t in n4_cuda._TICKETS.values())


def _severe_defects(K, N, gen, dev, shape=(128, 128, 16)):
    """[N, H, W, D] severe-load defect maps: clustered blobs until a lane
    holds ~3/4 of K defect voxels, the last lane half that."""
    H, W, D = shape
    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                             indexing="ij")
    d = np.zeros((N,) + shape, np.float32)
    for n in range(N):
        while d[n].sum() < (0.75 if n < N - 1 else 0.375) * K:
            c = gen.uniform([20, 20, 0], [H - 20, W - 20, D])
            r = gen.uniform([3, 3, 1], [10, 10, 3])
            blob = (((ii - c[0]) / r[0]) ** 2 + ((jj - c[1]) / r[1]) ** 2
                    + ((kk - c[2]) / r[2]) ** 2) <= 1.0
            d[n][blob & (gen.random(shape) < 0.8)] = 1.0
    return torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("K,Kw", [(2048, 2048), (2048, 1777)])
def test_head_counts_severe_maps(cuda, border, K, Kw):
    """K3 on clustered severe-load maps (the warp culling at work), and at
    a ragged Kw != K with sentinel rows in both: bit-equal to the plain
    version and bit-identical on relaunch."""
    gen = np.random.default_rng(K + Kw)
    shape = (128, 128, 16)
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), shape, 50,
                                          border)
    ns = min(96, geom.n_balls - 1)
    defect = _severe_defects(K, 3, gen, cuda, shape)
    centers = tcp.defect_coords(defect, K)[0]
    witnesses = tcp.defect_coords(defect, Kw)[0]
    r2 = torch.as_tensor(geom.r2_32[:ns], device=cuda)
    combos = tcp._alias_combos(geom)
    got = ci_cuda.head_counts(centers, witnesses, r2, combos, geom.scale,
                              geom.rmax)
    want = ci_cuda.head_counts_plain(centers, witnesses, r2, combos,
                                     geom.scale, geom.rmax)
    assert torch.equal(got, want)
    assert int(want.max()) > 0
    assert torch.equal(got, ci_cuda.head_counts(centers, witnesses, r2,
                                                combos, geom.scale,
                                                geom.rmax))


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


def _tail_args(geom, centers, witnesses):
    """K10's arguments for these rows on ``geom``: the balls up to its
    j_cap at this witness count."""
    dev = centers[0].device
    r2, T = tcp._tail_tables(geom, witnesses[0].shape[1])
    return (centers, witnesses, torch.as_tensor(r2, device=dev),
            torch.as_tensor(T, device=dev), tcp._alias_combos(geom),
            geom.scale, geom.rmax)


def _tail_bit_equal(args):
    """K10 once (one launch counted), bit-equal to its plain version (the
    sort path) and to a second launch."""
    before = ci_cuda.LAUNCHES["tail_balls"]
    got = ci_cuda.tail_balls(*args)
    assert ci_cuda.LAUNCHES["tail_balls"] == before + 1
    assert got.dtype == torch.int64 and got.device == args[2].device
    assert torch.equal(got, ci_cuda.tail_balls_plain(*args))
    assert torch.equal(got, ci_cuda.tail_balls(*args))
    return got


def _engine_tail(defect, geom, K):
    """The arguments the engine hands K10 at pad K with its tail at full
    width (the severe cohort's tail): rows unresolved by the head, then
    sentinel rows."""
    seen, real = [], tcp.tail_balls

    def spy(*args):
        seen.append(args)
        return real(*args)
    tcp.tail_balls = spy
    try:
        tcp.calculate_ci_pairwise(defect, geom, K, tail_k=K)
    finally:
        tcp.tail_balls = real
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("rows,Kw", [(256, 512), (1024, 8192), (1000, 1777)])
def test_tail_balls_severe_maps(cuda, border, rows, Kw):
    """K10 on severe-load maps, every one of the first ``rows`` defect
    voxels a center (pad rows included), at the cohort's and the severe
    cell's tail widths and at a Kw that is not a multiple of 32."""
    gen = np.random.default_rng(rows + Kw)
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (128, 128, 16),
                                          50, border)
    defect = _severe_defects(max(rows, Kw), 3, gen, cuda)
    args = _tail_args(geom, tcp.defect_coords(defect, rows)[0],
                      tcp.defect_coords(defect, Kw)[0])
    assert int(_tail_bit_equal(args).max()) > 0


@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_tail_balls_on_the_severe_cohorts_tail(cuda, border):
    """The engine's tail at pad 8,192 with 8,192 tail rows, as the severe
    cohort runs it: K10 bit-equal to the sort path, its rows failing past
    the head balls."""
    gen = np.random.default_rng(8192)
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (128, 128, 16),
                                          50, border)
    args = _engine_tail(_severe_defects(8192, 2, gen, cuda), geom, 8192)
    assert args[0][0].shape == (2, 8192) and args[1][0].shape == (2, 8192)
    live = args[0][0] < tcp.SENT
    got = _tail_bit_equal(args)
    assert bool(live.any()) and int(got[live].max()) > 96


def test_tail_balls_all_sentinels(cuda):
    """Sentinel rows against real witnesses, real rows against sentinel
    witnesses, sentinels against sentinels: no pair inside any ball."""
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (64, 64, 8), 50,
                                          "wrap")
    gen = np.random.default_rng(4)
    real = lambda n: tuple(torch.from_numpy(gen.integers(
        0, hi, size=(1, n)).astype(np.int32)).to(cuda) for hi in (64, 64, 8))
    sent = lambda n, j: tuple(torch.full((1, n), v, dtype=torch.int32,
                                         device=cuda)
                              for v in (tcp.SENT, j * tcp.SENT, tcp.SENT))
    cat = lambda a, b: tuple(torch.cat(p).contiguous() for p in zip(a, b))
    centers = cat(cat(sent(100, 1), real(100)), sent(100, 1))
    witnesses = cat(cat(real(300), sent(300, -1)), sent(300, -1))
    got = _tail_bit_equal(_tail_args(geom, centers, witnesses))
    assert not bool(got.any())


def _dense_ball(dev):
    """A 128x128x16 map holding one dense ellipsoid (~31,000 voxels) and a
    2 % sprinkle: its rows fail anywhere up to ball ~2,100 of 2,513."""
    H, W, D = 128, 128, 16
    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                             indexing="ij")
    d = ((((ii - 64) / 36.0) ** 2 + ((jj - 64) / 36.0) ** 2
          + ((kk - 8) / 5.4) ** 2) <= 1.0).astype(np.float32)
    d[np.random.default_rng(0).random(d.shape) < 0.02] = 1.0
    return torch.from_numpy(d)[None].to(dev)


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("Kw", [40000, 70000])
def test_tail_balls_every_ball_and_windows(cuda, border, Kw):
    """Witness counts where j_cap = M - 1, so every ball is tested: at Kw
    40,000 in one window of 16-bit counts, and at a halo-sized Kw of
    70,000 (32-bit counts) in two windows of balls, rows failing in
    both."""
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (128, 128, 16),
                                          50, border)
    d = _dense_ball(cuda)
    cidx = torch.nonzero(d.reshape(-1)).reshape(-1)
    pick = cidx[torch.randperm(len(cidx), generator=torch.Generator()
                               .manual_seed(Kw))[:512].to(cuda)]
    centers = tuple((v[None]).to(torch.int32).contiguous() for v in
                    (pick // (128 * 16), (pick // 16) % 128, pick % 16))
    args = _tail_args(geom, centers, tcp.defect_coords(d, Kw)[0])
    assert args[2].shape[0] == geom.n_balls - 1
    got = _tail_bit_equal(args)
    assert int(got.max()) > 1800 and int(got.min()) < 1000


def _sentinels(n, dev):
    return tuple(torch.full((1, n), tcp.SENT, dtype=torch.int32, device=dev)
                 for _ in range(3))


def _cat(*parts):
    return tuple(torch.cat(p, 1).contiguous() for p in zip(*parts))


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("Kw", [40000, 70000])
def test_tail_balls_late_rows_and_sentinel_blocks(cuda, border, Kw):
    """Two blocks of sentinel rows ahead of rows failing up to ball ~2,100,
    a block of padding rows (they meet the padding witnesses, slices of
    one repeated point, at distance 0), then a block that mixes padding
    rows and sentinels: K10 in windows of ~770 balls (16-bit counts) or
    ~400 (32-bit, Kw >= 65,536), rows failing in the third window or
    later, bit-equal to the sort path; the sentinel blocks' rows fail at
    the first ball, as a row with no witness."""
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (128, 128, 16),
                                          50, border)
    d = _dense_ball(cuda)
    cidx = torch.nonzero(d.reshape(-1)).reshape(-1)
    pick = cidx[torch.randperm(len(cidx), generator=torch.Generator()
                               .manual_seed(Kw + 1))[:400].to(cuda)]
    rows = tuple((v[None]).to(torch.int32) for v in
                 (pick // (128 * 16), (pick // 16) % 128, pick % 16))
    padding = tuple(torch.full((1, 40), v, dtype=torch.int32, device=cuda)
                    for v in (tcp.SENT, -tcp.SENT, tcp.SENT))
    centers = _cat(_sentinels(64, cuda), rows, padding, _sentinels(40, cuda))
    args = _tail_args(geom, centers, tcp.defect_coords(d, Kw)[0])
    bins, blocks = ci_cuda.tail_launch(cuda, args[2].shape[0], Kw,
                                       len(args[4]))
    assert blocks >= ci_cuda.TAIL_BLOCKS and 3 * bins < args[2].shape[0]
    got = _tail_bit_equal(args)
    assert not bool(got[:, :64].any()) and not bool(got[:, -40:].any())
    assert int(got[:, 64:464].max()) >= 2 * bins
    assert bool((got[:, 464:504] > 0).all())


@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_tail_balls_rows_that_never_fail(cuda, border):
    """A volume all defect (72x72x12, 62,208 witnesses, 16-bit counts):
    rows with the whole rmax ball inside never fail and take nb, after
    every window; rows at the corners fail (some, where "wrap" aliases the
    far side in); bit-equal to the sort path."""
    H, W, D = 72, 72, 12
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (H, W, D), 50,
                                          border)
    d = torch.ones((1, H, W, D), device=cuda)
    gen = torch.Generator().manual_seed(12)
    inner = tuple(torch.randint(lo, hi, (1, 64), generator=gen,
                                dtype=torch.int32).to(cuda)
                  for lo, hi in ((34, 38), (34, 38), (5, 7)))
    corner = tuple(torch.randint(0, 3, (1, 64), generator=gen,
                                 dtype=torch.int32).to(cuda)
                   for _ in range(3))
    args = _tail_args(geom, _cat(inner, corner),
                      tcp.defect_coords(d, H * W * D)[0])
    nb = args[2].shape[0]
    got = _tail_bit_equal(args)
    assert bool((got[:, :64] == nb).all()) and int(got[:, 64:].min()) < nb


@pytest.mark.parametrize("pad, tail", [(512, None), (8192, 8192)])
def test_every_sync_of_the_pipeline_is_declared(cuda, pad, tail):
    """analyze_cohort at 16 x 128x128x16 runs to its end with the sync-debug
    mode at "error", at the typical cohort's CI pad and at the ceiling
    with the tail at full width: every point where the host waits for the
    card is a declared ``host_wait``."""
    shape, vox = (128, 128, 16), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=pad, ci_tail_k=tail,
                                 n4_mask_pad=49152)
    hp, mask, _ = make_cohort(16, shape, vox, seed=0)
    hp, mask = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    geom = build_geometry(vox, shape, cfg)
    tn4.clear_graphs()      # so N4 captures its graphs under the mode too
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = analyze_cohort(hp, mask, geom, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(res.metrics.valid.all())
    assert torch.isfinite(res.metrics.vdp).all()


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
    launched = {k: v for d in counts for k, v in d.items()}
    # the pipeline's kernels (K6 and K7 belong to the unfused fit chain)
    for k in ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
              "sharpen_resid", "head_counts", "tail_balls"):
        assert launched[k] > 0, k
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


@pytest.mark.parametrize("P", [10000, 10001])
@pytest.mark.parametrize("width", ["wide", "narrow"])
def test_sharpen_hist_equals_fixed_plain(cuda, width, P):
    """K4 equals its exact fixed-point plain version bit for bit, on a wide
    residual and on a narrow one (most voxels of a warp in one bin, where
    the warp-aggregated sums do the work), with 16-byte (P % 4 == 0) and
    scalar loads."""
    gen = np.random.default_rng(P)
    lu, wv, bmn, slope = _sharpen_lanes(5, P, gen, cuda, 200)
    if width == "narrow":
        lu = torch.where(wv > 0, 5.0 + (lu - 5.0) * 1e-4, lu)
        bmn, bmx = tn4._masked_range(lu, wv)
        slope = (bmx - bmn) * 20.0 / 199     # all voxels in ~10 bins
    got = sc.sharpen_hist(lu, wv, bmn, slope, 200)
    assert torch.equal(got, sc.sharpen_hist_fixed_plain(lu, wv, bmn, slope,
                                                        200))
    assert torch.equal(got.cpu(), sc.sharpen_hist_fixed_plain(
        lu.cpu(), wv.cpu(), bmn.cpu(), slope.cpu(), 200))
    assert torch.equal(got, sc.sharpen_hist(lu, wv, bmn, slope, 200))


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


def _offset_view(t, off):
    """A contiguous copy of t that starts off elements into its storage."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("P", [49152, 10001, 4099])
def test_sharpen_resid_shapes_and_offsets(cuda, P):
    """K5 bit-equal to its plain version at the slice's P and ragged P, on
    lanes with zero-weight tails (one of half the lane) and an all-zero
    lane, with 16-byte loads (P % 4 == 0) and scalar ones, and with inputs
    that start 4 bytes past a 16-byte boundary of their storage."""
    gen = np.random.default_rng(P)
    bins, N = 200, 6
    lu, wv, bmn, slope = _sharpen_lanes(N, P, gen, cuda, bins)
    wv[2, P // 2:] = 0.0
    e_loc = torch.from_numpy(gen.normal(5.0, 1.0, (N, bins + 2)).astype(
        np.float32)).to(cuda)
    sv = torch.from_numpy(gen.random((N, P)).astype(np.float32)).to(cuda) \
        + 0.01
    want = sc.sharpen_resid_plain(lu, wv, sv, e_loc, bmn, slope, bins)
    assert bool((want[0] == 0).all()) and bool(torch.isfinite(want).all())
    assert torch.equal(sc.sharpen_resid(lu, wv, sv, e_loc, bmn, slope, bins),
                       want)
    shifted = [_offset_view(t, 1) for t in (lu, wv, sv)]
    assert torch.equal(sc.sharpen_resid(*shifted, e_loc, bmn, slope, bins),
                       want)
    assert torch.equal(sc.sharpen_resid(lu, wv, shifted[2], e_loc, bmn, slope,
                                        bins), want)


@pytest.mark.parametrize("V", [262144, 4112, 100003])
@pytest.mark.parametrize("case", ["none", "all", "one_per_warp_span",
                                  "rank_out_of_range"])
def test_densify_rank_flag_patterns(cuda, case, V):
    """K8 bit-equal to its plain version with no flag set, every flag set,
    one defect in each 512-voxel span (one per warp of the 16-byte path, at
    a random place in it), and set voxels whose rank is < 0 or >= k; with
    the 16-byte path (V % 16 == 0) and the scalar one, and with d01 or rank
    starting at an odd element of its storage."""
    N, K = 3, 512
    gen = np.random.default_rng(V)
    d = np.zeros((N, V), bool)
    if case == "all":
        d[:] = True
    elif case == "one_per_warp_span":
        for n in range(N):
            span = np.arange(0, V, 512)
            d[n, np.minimum(span + gen.integers(0, 512, span.size), V - 1)] = 1
    elif case == "rank_out_of_range":
        d = gen.random((N, V)) < 0.3
    d01 = torch.from_numpy(d).to(cuda)
    r = ci_densify_cuda.rank(d01)
    if case == "rank_out_of_range":
        r = torch.from_numpy(gen.integers(-2 * K, 2 * K, (N, V)).astype(
            np.int32)).to(cuda)
    cv = torch.from_numpy(gen.random((N, K)).astype(np.float32)).to(cuda) \
        + 1.0
    want = ci_densify_cuda.densify_rank_plain(r, d01, cv, K)
    assert int((want != 0).sum()) == int((d01 & (r >= 0) & (r < K)).sum())
    assert torch.equal(ci_densify_cuda.densify_rank(r, d01, cv, K), want)
    for dd, rr in ((_offset_view(d01, 1), r), (d01, _offset_view(r, 1))):
        assert torch.equal(ci_densify_cuda.densify_rank(rr, dd, cv, K), want)


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


def _rank_flags(pattern, N, V, gen):
    """[N, V] bool flags: none, all, only in each row's last K9 tile, or
    set at a random rate per row."""
    d = np.zeros((N, V), bool)
    if pattern == "ones":
        d[:] = True
    elif pattern == "last_tile":
        tile = ci_densify_cuda._lib().vj_rank_tile()
        start = (V - 1) // tile * tile
        d[:, start:] = gen.random((N, V - start)) < 0.5
        d[:, -1] = True
    elif pattern == "random":
        d = gen.random((N, V)) < gen.uniform(0.001, 0.9, (N, 1))
    return d


@pytest.mark.parametrize("V", [262144, 4112, 100003, 16 * 4096 + 1])
@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("pattern", ["zeros", "ones", "last_tile", "random"])
def test_rank_patterns(cuda, pattern, N, V):
    """K9 torch.equal to rank_plain on rows with no flag, every flag, flags
    only in the last tile, and random rates; V a multiple of 16 (the
    16-byte path) or not (the scalar path), and d01 starting at an odd
    element of its storage (the scalar path at any V)."""
    gen = np.random.default_rng(V + N)
    d01 = torch.from_numpy(_rank_flags(pattern, N, V, gen)).to(cuda)
    want = ci_densify_cuda.rank_plain(d01)
    assert torch.equal(ci_densify_cuda.rank(d01), want)
    assert torch.equal(ci_densify_cuda.rank(_offset_view(d01, 1)), want)


def test_rank_workspace_left_zero(cuda):
    """Calls of different shapes back to back share K9's workspace: each is
    torch.equal to rank_plain, and the workspace is zero after each."""
    gen = np.random.default_rng(7)
    shapes = [(16, 262144), (3, 4112), (1, 16 * 4096 + 1), (16, 262144),
              (5, 100003)]
    for N, V in shapes:
        d01 = torch.from_numpy(gen.random((N, V)) < 0.01).to(cuda)
        assert torch.equal(ci_densify_cuda.rank(d01),
                           ci_densify_cuda.rank_plain(d01)), (N, V)
        torch.cuda.synchronize()
        for ws in ci_densify_cuda._WORKSPACE.values():
            assert not bool(ws.any()), (N, V)


def test_doctor_on_card(cuda):
    """The quick doctor on the card: every check passes (kernel_build is
    required there and names the four libraries), names as on the CPU."""
    from ventjax_torch.utils import doctor

    report = doctor.run_doctor()
    by = {c["name"]: c for c in report["checks"]}
    assert list(by) == ["versions", "backend", "device_probe",
                        "kernel_build", "native_scanner", "seg_checkpoint",
                        "codec_roundtrip", "pipeline_selftest"]
    assert report["ok"], report
    assert by["kernel_build"]["required"]
    assert sorted(by["kernel_build"]["libraries"]) == sorted(doctor.LIBRARIES)
    assert by["pipeline_selftest"]["device"].startswith("cuda")


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


def _n4_counted(run):
    """(run(), launch and graph counter deltas, N4 syncs) on the card."""
    counts = (n4_cuda.LAUNCHES, sc.LAUNCHES)
    before, syncs = [dict(d) for d in counts], tn4.HOST_SYNCS["n4"]
    out = run()
    torch.cuda.synchronize()
    return out, {k: v - was[k] for d, was in zip(counts, before)
                 for k, v in d.items()}, tn4.HOST_SYNCS["n4"] - syncs


@pytest.mark.parametrize("N, shape, pad", [(16, (128, 128, 16), 49152),
                                           (3, (64, 64, 8), 8192)])
def test_n4_graph_route_bit_equal_to_eager(cuda, monkeypatch, N, shape, pad):
    """N4's level loop as one CUDA graph a level against the eager loop on
    the card: the corrected image, the iteration counts (lanes frozen at
    different iterations), the lattices and the compacted values
    bit-equal, in the call that captures and in later ones; once the
    allocator is warm a call only replays (one replay an iteration) and
    allocates no more above what it holds between calls than the eager
    loop does, its iterations' scratch held in the graphs' pool instead;
    each call counts the eager loop's launches."""
    hp, mask, _ = make_cohort(N, shape, (1.5, 1.5, 10.0), seed=4)
    hp, mask = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    tn4.clear_graphs()

    def run():
        """The outputs on the host: a call's peak holds no earlier call's."""
        out = tn4.n4_bias_correction(hp, mask, mask_pad=pad,
                                     return_iters=True, return_phi=True,
                                     return_compacted=True)
        return [t.cpu() for t in out[:3] + out[3]]

    with monkeypatch.context() as m:
        m.setattr(tn4, "_graphs_engage", lambda dev: False)
        run()
        torch.cuda.reset_peak_memory_stats(cuda)
        eager_held = torch.cuda.memory_allocated(cuda)
        want, eager, syncs = _n4_counted(run)
        eager_peak = torch.cuda.max_memory_allocated(cuda)
    iters = want[1]
    assert bool((iters != iters[:1]).any())
    assert syncs == int(iters.max(0).values.sum())
    kernels = ("fit_moment", "fit_delta_conv_field", "sharpen_hist",
               "sharpen_resid")
    assert eager["n4_iter_graph_captures"] == 0
    assert eager["n4_iter_graph_replays"] == 0
    for calls in range(4):
        torch.cuda.reset_peak_memory_stats(cuda)
        held = torch.cuda.memory_allocated(cuda)
        got, counts, s = _n4_counted(run)
        assert s == syncs
        assert {k: counts[k] for k in kernels} == {k: eager[k]
                                                   for k in kernels}
        assert counts["n4_iter_graph_replays"] == syncs - counts[
            "n4_iter_graph_captures"]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if calls == 0:
            assert counts["n4_iter_graph_captures"] == 4
        elif counts["n4_iter_graph_captures"] == 0:
            break
    # once the allocator is warm, a call finds its slots where the graphs
    # were captured: it replays every iteration, and allocates no more
    # than the eager loop above what each holds between calls (the graph
    # route's standing state, such as the capture stream's tickets, is in
    # the latter).  Its iterations' scratch is the graphs' pool, which the
    # allocated peak leaves out: the route holds that pool beside what the
    # eager loop holds
    assert counts["n4_iter_graph_captures"] == 0
    assert counts["n4_iter_graph_replays"] == syncs
    assert torch.cuda.max_memory_allocated(cuda) - held \
        <= eager_peak - eager_held
    assert tn4.graph_pool_bytes() > 0


def test_n4_graphs_keep_their_tickets_past_a_larger_batch(cuda, monkeypatch):
    """K2's ticket buffer on the capture stream is replaced when a batch of
    more lanes than it holds comes; the graphs captured on the old buffer
    keep it.  Graphs captured at N 16, then graphs at N 96 on the same
    stream, then N 16 again: the last calls replay and stay bit-equal to
    the eager loop."""
    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    small, big = (tuple(torch.from_numpy(a).to(cuda) for a in make_cohort(
        n, shape, vox, seed=n)[:2]) for n in (16, 96))

    def run(hp, mask):
        return tn4.n4_bias_correction(hp, mask, mask_pad=4096,
                                      return_iters=True, return_phi=True)

    with monkeypatch.context() as m:
        m.setattr(tn4, "_graphs_engage", lambda dev: False)
        want = run(*small)
    tn4.clear_graphs()
    for batch, captures in ((small, 4), (big, 4)):
        _, counts, _ = _n4_counted(lambda: run(*batch))
        assert counts["n4_iter_graph_captures"] == captures
    # the larger batch replaced the capture stream's tickets
    stream = tn4._STREAMS[tn4._place(cuda)].cuda_stream
    assert n4_cuda._TICKETS[cuda.index, stream].numel() >= 96
    for _ in range(3):
        got, counts, _ = _n4_counted(lambda: run(*small))
        if counts["n4_iter_graph_captures"] == 0:
            break
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert counts["n4_iter_graph_captures"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("vox,shape,rmax", [
    ((1.5, 1.5, 10.0), (64, 64, 8), 50),
    ((3.125, 3.125, 15.0), (32, 32, 6), 20),
])
def test_ladder_ci_on_card_bit_equal_cpu(cuda, vox, shape, rmax):
    """The gather-ladder and flat CI engines give the CPU's bits on the
    card (exact float32 counts, one division)."""
    gen = np.random.default_rng(rmax)
    d = (gen.random((3,) + shape) > 0.93).astype(np.float32)
    d[2] = 0.0                                       # an empty lane
    geom = tci.build_ci_geometry(vox, shape, rmax, "wrap")
    for fn in (tci.calculate_ci_staged, tci.calculate_ci):
        got = fn(torch.from_numpy(d).to(cuda), geom, 1024)
        want = fn(torch.from_numpy(d), geom, 1024)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), fn.__name__


def test_ladder_engine_through_pipeline_on_card(cuda):
    """ci_engine="ladder" on the card: the pairwise engine's CI map."""
    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
    hp, mask, _ = make_cohort(2, shape, vox, seed=4)
    h, m = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    pair = analyze_cohort(h, m, build_geometry(vox, shape, cfg), cfg)
    lcfg = cfg.replace(ci_engine="ladder")
    lgeom = build_geometry(vox, shape, lcfg)
    assert isinstance(lgeom, tci.CIGeometry)
    lad = analyze_cohort(h, m, lgeom, lcfg)
    assert torch.equal(lad.defect, pair.defect)
    assert torch.equal(lad.ci_map, pair.ci_map)
    assert not bool(lad.metrics.ci_overflow.any())


def test_run_cohort_on_card(cuda, tmp_path):
    """The cohort driver on the card: every subject exported, metrics
    within 0.1 pp of the same driver on the CPU."""
    from ventjax_torch.io.synthetic import write_study
    from ventjax_torch.pipeline import cohort as tc

    manifest = []
    for i in range(3):
        root = str(tmp_path / f"s{i}")
        write_study(root, shape=(64, 64, 8), seed=70 + i, with_proton=False)
        manifest.append({"id": f"s{i}", "xenon": f"{root}/xenon.dcm",
                         "mask": f"{root}/mask"})
    runners = {}
    gpu = tc.run_cohort(manifest, str(tmp_path / "gpu"), batch_size=2,
                        runners=runners, device=cuda)
    assert next(iter(runners.values())).device.type == "cuda"
    cpu_runners = {}
    for geo in runners:
        cpu_runners[geo] = tc._GeometryRunner(geo[0], geo[1], DEFAULT_CONFIG,
                                              2, device="cpu")
    cpu = tc.run_cohort(manifest, str(tmp_path / "cpu"), batch_size=2,
                        runners=cpu_runners, device="cpu")
    g = {r["id"]: r for r in gpu}
    for r in cpu:
        assert g[r["id"]]["valid"] and not g[r["id"]]["CI_overflow"]
        for k in ("VDP", "VDP_lb", "VDP_km"):
            assert abs(g[r["id"]][k] - r[k]) < 0.1, k
        assert (tmp_path / "gpu" / r["id"] / ".done").exists()


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_adult_studies_through_the_driver_and_the_facade_on_card(
        cuda, tmp_path, capsys):
    """Four adult studies (256x256x16 at 1.5x1.5x10 mm: a 188,304-voxel
    lung, 10 defects of radius 12, 16, 20 voxels as in the benchmark's
    adult mix, 18,000-23,600 defect voxels each) at the command line's
    defaults plus --max-defect 32768.  run_cohort sizes N4's pad from the
    lung (188,416) and grows the CI pad to 32,768, no flag standing, and
    every study's N4 image over the lung, defect and CI maps and metrics
    are bit-equal to analyze_cohort at the same pads.  The facade that
    ``analyze`` runs takes the lung's N4 pad and its defect count's CI pad,
    bit-equal to analyze_cohort there, and ``analyze`` prints its
    metrics."""
    import argparse
    import json

    from ventjax_torch import cli
    from ventjax_torch.compat import Vent_Analysis, ci_module
    from ventjax_torch.config import n4_pad_for
    from ventjax_torch.io import nifti
    from ventjax_torch.io.phantom import make_phantom
    from ventjax_torch.io.synthetic import write_study
    from ventjax_torch.pipeline import cohort as tc

    shape, vox, lung_voxels = (256, 256, 16), (1.5, 1.5, 10.0), 188_304
    manifest = []
    for i in range(4):
        root = tmp_path / f"s{i}"
        write_study(str(root), phantom=make_phantom(
            shape=shape, vox=vox, seed=90 + i, n_defects=10,
            defect_radius_vox=(12.0, 16.0, 20.0)), with_proton=False)
        manifest.append({"id": f"s{i}", "xenon": f"{root}/xenon.dcm",
                         "mask": f"{root}/mask"})
    decoded = [tc._decode_subject(e) for e in manifest]
    hp = torch.from_numpy(np.stack([d[0] for d in decoded]).astype(
        np.float32)).to(cuda)
    mask_np = np.stack([d[1] for d in decoded]).astype(np.float32)
    mask = torch.from_numpy(mask_np).to(cuda)
    assert int((mask_np[0] > 0).sum()) == lung_voxels

    cfg = cli._config(argparse.Namespace(deterministic=False,
                                         max_defect=32768))
    runners = {}
    got = {r["id"]: r for r in tc.run_cohort(
        manifest, str(tmp_path / "cohort"), config=cfg, batch_size=4,
        resume=False, runners=runners, device=cuda)}
    runner = next(iter(runners.values()))
    assert (runner.ci_bucket, runner.n4_bucket) == (32768, 188_416)
    pcfg = cfg.replace(ci_max_defect_voxels=runner.ci_bucket,
                       n4_mask_pad=runner.n4_bucket,
                       ci_tail_k=runner.ci_bucket if runner.ci_tail_full
                       else cfg.ci_tail_k)
    want = analyze_cohort(hp, mask, build_geometry(vox, shape, pcfg), pcfg)
    for i, e in enumerate(manifest):
        r = got[e["id"]]
        assert r["valid"] and not r["CI_overflow"] and not r["N4_overflow"]
        data = nifti.load(str(tmp_path / "cohort" / e["id"]
                              / f"{e['id']}_dataArray.nii"))[0]
        lung = mask_np[i] > 0
        assert _bit_equal(data[..., 3][lung], want.n4[i].cpu().numpy()[lung])
        assert _bit_equal(data[..., 4], want.defect[i].cpu().numpy())
        assert _bit_equal(data[..., 5], want.ci_map[i].cpu().numpy())
        for key, f in (("VDP", "vdp"), ("VDP_lb", "vdp_lb"),
                       ("VDP_km", "vdp_km"), ("CI", "ci")):
            assert _bit_equal(np.float32(r[key]), getattr(
                want.metrics, f)[i].cpu().numpy()), (e["id"], key)

    e = manifest[0]
    v = Vent_Analysis(xenon_path=e["xenon"], mask_path=e["mask"],
                      device=cuda)
    v.calculate_VDP()
    v.calculate_CI()
    k = ci_module.defect_pad(v.defectArray)
    assert int((v.defectArray != 0).sum()) <= k
    fcfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=k, ci_tail_k=k,
        n4_mask_pad=n4_pad_for(DEFAULT_CONFIG, lung_voxels, mask_np[0].size))
    assert fcfg.n4_mask_pad == 188_416
    one = analyze_cohort(hp[:1], mask[:1], build_geometry(vox, shape, fcfg),
                         fcfg)
    assert not bool(one.metrics.ci_overflow[0] or one.metrics.n4_overflow[0])
    lung = mask_np[0] > 0
    assert _bit_equal(np.asarray(v.N4HPvent, np.float32)[lung],
                      one.n4[0].cpu().numpy()[lung])
    assert _bit_equal(v.defectArray,
                      one.defect[0].cpu().numpy().astype(np.float64))
    assert _bit_equal(np.asarray(v.CIarray, np.float32),
                      one.ci_map[0].cpu().numpy())
    for key, f in (("VDP", "vdp"), ("VDP_lb", "vdp_lb"), ("VDP_km", "vdp_km"),
                   ("CI", "ci")):
        assert _bit_equal(np.float32(v.metadata[key]),
                          getattr(one.metrics, f)[0].cpu().numpy()), key

    capsys.readouterr()
    assert cli.main(["analyze", "--xenon", e["xenon"], "--mask", e["mask"],
                     "--out", str(tmp_path / "analyze"), "--max-defect",
                     "32768", "--device", "cuda"]) == 0
    printed = json.loads(capsys.readouterr().out)
    for key in ("VDP", "VDP_lb", "VDP_km", "CI"):
        assert np.float32(printed[key]) == np.float32(v.metadata[key]), key


def test_grouped_on_card_within_pipeline_tolerances(cuda):
    """Groups of 2 and of 1 against one batch of 4 on the card.  No float
    sum of the pipeline differs by batch size on the card any more
    (row_sums' fixed order for SNR and the VDP mean; N4's dense field in
    the fixed-order n4_field kernel, each lane's voxels summed alone), so
    groups of 2 and of 1 keep every output's bits."""
    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
    hp, mask, _ = make_cohort(4, shape, vox, seed=6)
    h, m = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    geom = build_geometry(vox, shape, cfg)
    whole = analyze_cohort(h, m, geom, cfg)
    for size in (2, 1):
        grouped = analyze_cohort_grouped(h, m, geom, cfg, group_size=size)
        for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"):
            assert torch.equal(getattr(grouped, f), getattr(whole, f)), \
                (size, f)
        for name in ("snr", "vdp", "vdp_lb", "vdp_km", "ci"):
            a, b = getattr(grouped.metrics, name), getattr(whole.metrics,
                                                           name)
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), \
                (size, name)


@pytest.mark.parametrize("shape", [(128, 128, 16), (33, 20, 5)])
def test_n4_field_bit_equal_on_card(cuda, shape):
    """The dense-field kernel against its plain version on the card, bit
    for bit, at the slice's levels (ncp 4, 5, 7, 11) and at a ragged
    grid; a lane's field the same alone, in a batch of 3 and in one of 16;
    a relaunch bit-identical; a launch counted."""
    from ventjax_torch.ops import n4_field_cuda as nf

    ncps = (4, 5, 7, 11)
    gen = np.random.default_rng(3)
    phi = torch.from_numpy(gen.normal(0, 0.2, (16, sum(
        c ** 3 for c in ncps))).astype(np.float32)).to(cuda)
    before = nf.LAUNCHES["n4_field"]
    got = nf.n4_field(phi, shape, ncps)
    assert nf.LAUNCHES["n4_field"] == before + 1
    assert torch.equal(got, nf.n4_field_plain(phi, shape, ncps))
    assert torch.equal(got, nf.n4_field(phi, shape, ncps))
    for lanes in (slice(5, 6), slice(2, 5)):
        assert torch.equal(nf.n4_field(phi[lanes].contiguous(), shape,
                                       ncps), got[lanes])
    # the kernel's limit of eight levels: lattices too large to stage, and
    # f columns past the default 48 KB of shared memory (ncp 131)
    big = (4, 5, 7, 11, 19, 35, 67, 131)
    assert len(big) == nf.MAX_LEVELS
    phi = torch.from_numpy(gen.normal(0, 0.2, (2, sum(
        c ** 3 for c in big))).astype(np.float32)).to(cuda)
    assert torch.equal(nf.n4_field(phi, (40, 36, 9), big),
                       nf.n4_field_plain(phi, (40, 36, 9), big))


def test_facade_on_card_matches_cpu(cuda, tmp_path):
    """Vent_Analysis on the card (its default device) against itself on the
    CPU on one written 64x64x8 study: defect arrays equal, VDPs within
    0.1 pp, the CI map equal where the defect arrays agree, and N4 (K4, K5,
    K1, K2) and the CI head (K3) launched."""
    from ventjax_torch.compat import Vent_Analysis
    from ventjax_torch.io.synthetic import write_study
    from ventjax_torch.ops import ci_cuda

    write_study(str(tmp_path), shape=(64, 64, 8), vox=(1.5, 1.5, 10.0),
                seed=6)
    paths = {"xenon_path": f"{tmp_path}/xenon.dcm",
             "mask_path": f"{tmp_path}/mask",
             "proton_path": f"{tmp_path}/proton.dcm"}
    k1 = n4_cuda.LAUNCHES["fit_moment"]
    k3 = ci_cuda.LAUNCHES["head_counts"]
    gpu = Vent_Analysis(**paths)
    assert gpu.device.type == "cuda"
    gpu.calculate_VDP()
    gpu.calculate_CI()
    assert n4_cuda.LAUNCHES["fit_moment"] > k1
    assert ci_cuda.LAUNCHES["head_counts"] > k3
    cpu = Vent_Analysis(**paths, device="cpu")
    cpu.calculate_VDP()
    cpu.calculate_CI()
    for name in ("defectArray", "defectArrayLB", "defectArrayKM"):
        assert np.array_equal(getattr(gpu, name), getattr(cpu, name)), name
    for key in ("VDP", "VDP_lb", "VDP_km"):
        assert abs(gpu.metadata[key] - cpu.metadata[key]) < 0.1, key
    assert np.array_equal(gpu.CIarray, cpu.CIarray)
    assert gpu.metadata["CI"] == cpu.metadata["CI"]
    assert np.abs(gpu.N4HPvent - cpu.N4HPvent).max() <= \
        2e-3 * np.abs(cpu.N4HPvent).max()


def test_edit_mask_and_recon_on_card_match_cpu(cuda):
    from ventjax_torch.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss,
    )
    from ventjax_torch.ops.morphology import edit_mask, fill_holes

    rng = np.random.default_rng(4)
    vol = (rng.random((40, 36, 5)) > 0.55).astype(np.float32)
    for recipe in ("close:1,fillholes,erode:1", "open:2,dilate:1",
                   "fillholes"):
        for slicewise in (True, False):
            got = edit_mask(torch.from_numpy(vol).to(cuda), recipe,
                            slicewise=slicewise)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), edit_mask(vol, recipe,
                                                    slicewise=slicewise))
    spiral = np.ones((41, 41, 1), np.float32)
    spiral[0, :, 0] = 0
    spiral[:, 40, 0] = 0
    spiral[40, 2:, 0] = 0
    assert torch.equal(fill_holes(torch.from_numpy(spiral).to(cuda)).cpu(),
                       fill_holes(spiral))
    k = (rng.normal(size=(64, 48, 4))
         + 1j * rng.normal(size=(64, 48, 4))).astype(np.complex64)
    got = recon_2d_multislice(k, device=cuda)
    want = recon_2d_multislice(k, device="cpu")
    assert got.dtype == want.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    kc = np.stack([k, k * 0.5])
    got = recon_2d_multislice_rss(kc, device=cuda)
    want = recon_2d_multislice_rss(kc, device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * want.max()


def test_predict_mask_on_card_matches_cpu(cuda):
    """The shipped U-Net on the card against the CPU: masks equal except
    where the CPU |logit| < 1e-3 (cuDNN's float32 sums in another order),
    a second prediction bit-identical, and the checkpoint's arrays equal
    on both devices."""
    from ventjax_torch.io.phantom import make_random_phantom
    from ventjax_torch.models import segmentation as seg

    path = seg.default_checkpoint_path()
    card = seg.load_checkpoint(path, device=cuda)
    cpu = seg.load_checkpoint(path, device="cpu")
    for k, p in card.params.items():
        assert p.device.type == "cuda" and torch.equal(p.cpu(),
                                                       cpu.params[k]), k
    for s in (10_000, 10_001, 10_050):
        proton = make_random_phantom(s).proton
        got = seg.predict_mask(card.model, proton)
        assert got.device.type == "cuda"
        assert torch.equal(seg.predict_mask(card.model, proton), got)
        logits = seg.predict_logits(cpu.model, proton)
        want = (torch.sigmoid(logits) > 0.5).float()
        assert not ((got.cpu() != want) & (logits.abs() >= 1e-3)).any(), s
        assert not torch.backends.cudnn.allow_tf32


def test_train_step_on_card_matches_cpu(cuda):
    """One Adam step from the same initialisation on the same batch: the
    losses within 1e-5 relative, the parameters within 1e-5 absolute (a
    hundredth of the learning rate), as the CPU tests hold the port to
    ventjax."""
    from ventjax_torch.io.phantom import make_random_cohort
    from ventjax_torch.models import segmentation as seg

    _, mask, proton = make_random_cohort(2, (64, 64, 8), seed=3)
    states = [seg.create_train_state(torch.Generator().manual_seed(0),
                                     shape=(64, 64), base=16, device=d)
              for d in (cuda, "cpu")]
    losses = [float(seg.train_step(st, proton, mask)) for st in states]
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for k, p in states[0].params.items():
        assert float((p.cpu() - states[1].params[k]).abs().max()) <= 1e-5, k


def test_sharded_ci_on_card_bit_equal(cuda):
    """The halo CI over four shards of the card (a repeated device): K3
    once per shard, the map, saturated count and flag the unsharded
    engine's on the card and the CPU's."""
    from ventjax_torch.dist import calculate_ci_sharded, make_batch_mesh

    rng = np.random.default_rng(7)
    d = (rng.random((40, 36, 28)) > 0.985).astype(np.float32)
    d[10:16, 8:14, 10:16] = 1   # across a shard cut
    d[0, 0, 0] = 1
    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), d.shape, 16,
                                          "wrap")
    dev = torch.from_numpy(d).to(cuda)
    before = ci_cuda.LAUNCHES["head_counts"]
    ci, nsat, ovf = calculate_ci_sharded(
        dev, geom, mesh=make_batch_mesh(devices=[cuda] * 4),
        max_defect_voxels=512, halo_pad=256)
    assert ci_cuda.LAUNCHES["head_counts"] - before == 4
    want = tcp.calculate_ci_pairwise(dev[None], geom, 2048)
    assert not bool(ovf) and ci.device == dev.device
    assert torch.equal(ci, want[0][0]) and int(nsat) == int(want[1][0])
    cpu = tcp.calculate_ci_pairwise(torch.from_numpy(d)[None], geom, 2048)
    assert torch.equal(ci.cpu(), cpu[0][0])


def test_batch_mesh_on_card_bit_identical(cuda):
    """shard_cohort_fn over four shards of the card gives the batch's
    bits for every output."""
    from ventjax_torch.dist import make_batch_mesh, shard_cohort_fn

    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
    hp, mask, _ = make_cohort(8, shape, vox, seed=6)
    h, m = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    geom = build_geometry(vox, shape, cfg)
    fn = lambda a, b: analyze_cohort(a, b, geom, cfg)
    whole = fn(h, m)
    meshed = shard_cohort_fn(fn, make_batch_mesh(devices=[cuda] * 4))(h, m)
    for f in ("n4", "defect", "defect_lb", "defect_km", "ci_map"):
        assert torch.equal(getattr(meshed, f), getattr(whole, f)), f
    for name in ("snr", "vdp", "vdp_lb", "vdp_km", "ci"):
        a, b = getattr(meshed.metrics, name), getattr(whole.metrics, name)
        assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name


# ------------------------------------------------ the space axis on the card

def test_split_entry_points_on_card(cuda):
    """K1's partial and reduce, K2's fold and K4's partial and finish:
    each against its plain version and against the one-call entry point."""
    g = torch.Generator().manual_seed(0)
    N, ncp, P = 3, 7, 3 * n4_cuda.CHUNK + 77
    a = torch.randn(N, P, generator=g)
    rows = [torch.rand(N, ncp, P, generator=g) for _ in range(3)]
    ad, rd = a.to(cuda), [r.to(cuda) for r in rows]
    part = n4_cuda.fit_moment_partial(ad, *rd)
    want = n4_cuda.fit_moment_partial_plain(a, *rows)
    assert _err(part, want) < RTOL
    red = n4_cuda.fit_moment_reduce(part)
    assert torch.equal(red, n4_cuda.fit_moment(ad, *rd))
    assert torch.equal(red.cpu(), n4_cuda.fit_moment_reduce_plain(part.cpu()))
    lu = torch.randn(N, P, generator=g)
    wv = (torch.rand(N, P, generator=g) > 0.3).to(torch.float32)
    bmn, sl = torch.full((N,), -3.0), torch.full((N,), 6.0 / 199)
    dev = [t.to(cuda) for t in (lu, wv, bmn, sl)]
    hp = sc.sharpen_hist_partial(*dev, 200)
    assert torch.equal(hp.cpu(), sc.sharpen_hist_partial_plain(
        lu, wv, bmn, sl, 200))
    hist = sc.sharpen_hist_finish(hp, 200)
    assert torch.equal(hist, sc.sharpen_hist(*dev, 200))
    assert torch.equal(hist.cpu(), sc.sharpen_hist_finish_plain(hp.cpu(), 200))
    phi = torch.randn(N, ncp, ncp * ncp, generator=g).to(cuda)
    zero = torch.zeros(N, device=cuda)
    out = n4_cuda.fit_delta_conv_field(phi, *rd, dev[1], torch.zeros_like(
        ad), dev[0], zero, return_part=True)
    folded = n4_cuda.fit_fold_stats(out[3])
    assert torch.equal(folded, out[2])
    assert torch.equal(folded.cpu(), n4_cuda.fit_fold_stats_plain(
        out[3].cpu()))


def test_field_slab_rows_on_card(cuda):
    from ventjax_torch.ops import n4_field_cuda as nf

    g = torch.Generator().manual_seed(1)
    ncps = (4, 5, 7, 11)
    shape = (128, 128, 16)
    phi = torch.randn(2, sum(c ** 3 for c in ncps), generator=g).to(cuda)
    full = nf.n4_field(phi, shape, ncps)
    for s in range(4):
        rows = (s * 32, (s + 1) * 32)
        got = nf.n4_field(phi, shape, ncps, rows=rows)
        assert torch.equal(got, full[:, rows[0]:rows[1]])
        assert torch.equal(got.cpu(), nf.n4_field_plain(phi.cpu(), shape,
                                                        ncps, rows=rows))


def test_spatial_pipeline_on_card_bit_equal(cuda):
    """The headline's slab program at 64x64x8 over a (2, 4) mesh of the one
    card against analyze_cohort on the card: every output bit-equal."""
    import functools

    from ventjax_torch.dist import make_batch_space_mesh, spatial_shard_fn

    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=16384)
    hp, mask, _ = make_cohort(4, shape, vox, seed=2)
    hp, mask = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    geom = build_geometry(vox, shape, cfg)
    fn = functools.partial(analyze_cohort, geom=geom, config=cfg)
    counts = n4_cuda.LAUNCHES
    before = counts["fit_moment_partial"]
    got = spatial_shard_fn(fn, make_batch_space_mesh(
        2, 4, devices=[cuda] * 8))(hp, mask)
    assert counts["fit_moment_partial"] > before
    want = analyze_cohort(hp, mask, geom, cfg)
    for name in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
                 "ci_map"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("snr", "vdp", "vdp_lb", "vdp_km", "lung_volume", "ci",
                 "ci_saturated", "ci_overflow", "n4_overflow", "valid"):
        torch.testing.assert_close(getattr(got.metrics, name),
                                   getattr(want.metrics, name), rtol=0,
                                   atol=0, equal_nan=True, msg=name)


def test_spatial_pipeline_across_cards_bit_equal(cuda):
    """One slab a card: each wrapper launches on its tensors' card, so the
    slabs give analyze_cohort's bits there too."""
    import functools

    from ventjax_torch.dist import make_batch_space_mesh, spatial_shard_fn

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more, found {n}")
    shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=16384)
    hp, mask, _ = make_cohort(2, shape, vox, seed=2)
    hp, mask = torch.from_numpy(hp).to(cuda), torch.from_numpy(mask).to(cuda)
    geom = build_geometry(vox, shape, cfg)
    fn = functools.partial(analyze_cohort, geom=geom, config=cfg)
    cards = [torch.device("cuda", i) for i in range(2)]
    got = spatial_shard_fn(fn, make_batch_space_mesh(1, 2, cards))(hp, mask)
    want = analyze_cohort(hp, mask, geom, cfg)
    for name in ("n4", "defect", "defect_lb", "defect_km", "ci_map"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


_RANK_ON_CARD = """
import functools, sys, torch
sys.path.insert(0, {root!r})
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.dist import (
    initialize_multihost, make_rank_space_mesh, spatial_shard_fn)
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.ops import n4_cuda
from ventjax_torch.pipeline import analyze_cohort, build_geometry
rank = int(sys.argv[1])
initialize_multihost("localhost:{port}", 2, rank, backend="gloo",
                     timeout=300)
shape, vox = (64, 64, 8), (1.5, 1.5, 10.0)
cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=16384)
hp, mask, _ = make_cohort(4, shape, vox, seed=2)
hp, mask = torch.from_numpy(hp).cuda(), torch.from_numpy(mask).cuda()
geom = build_geometry(vox, shape, cfg)
fn = functools.partial(analyze_cohort, geom=geom, config=cfg)
got = spatial_shard_fn(fn, make_rank_space_mesh(1, 2))(hp, mask)
assert n4_cuda.LAUNCHES["fit_moment_partial"] > 0
want = analyze_cohort(hp, mask, geom, cfg)
for name in ("n4", "defect", "defect_lb", "defect_km", "defect_border",
             "ci_map"):
    assert torch.equal(getattr(got, name), getattr(want, name)), name
for name in ("snr", "vdp", "vdp_lb", "vdp_km", "lung_volume", "ci",
             "ci_saturated", "ci_overflow", "n4_overflow", "valid"):
    torch.testing.assert_close(getattr(got.metrics, name),
                               getattr(want.metrics, name), rtol=0, atol=0,
                               equal_nan=True, msg=name)
torch.distributed.destroy_process_group()
print("RANK_ON_CARD_OK", flush=True)
"""


def test_spatial_pipeline_over_two_gloo_ranks_on_card_bit_equal(cuda):
    """The slab program over a (1, 2) rank mesh: two gloo ranks sharing the
    card, each returning analyze_cohort's bits."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _RANK_ON_CARD.format(root=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), port=port)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_ON_CARD_OK" in out, out[-3000:]
