"""ventjax_torch pairwise CI (ops/ci_pairwise.py, ops/ci_cuda.py) against
ventjax and the float64 oracle.

The engine is integer coordinates, float32 distances that the geometry's
build-time proof validates, integer counts and one sort, so on the same
defect array the port must be BIT-equal to ventjax: head counts (K3's plain
version against the Pallas head in interpret mode), CI maps, saturation
counts and overflow flags.  Against the float64 oracle the CI map agrees to
float32 rounding of the radii, 2e-5 mm.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.ops import ci_pairwise as jcp
from ventjax.ops.ci_pallas import head_counts_pallas
from ventjax.oracle.ci_oracle import calculate_ci_oracle
from ventjax_torch.ops import ci_pairwise as tcp
from ventjax_torch.ops import ci_cuda
from ventjax_torch.ops.ci_cuda import head_counts

torch.set_num_threads(2)

SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)
RMAX = 12


def _defects(seed=3):
    rng = np.random.default_rng(seed)
    d = (rng.random(SHAPE) > 0.97).astype(np.float32)
    d[8:14, 8:14, 2:5] = 1.0       # a cluster: non-trivial crossings
    d[0:3, 28:32, 0:2] = 1.0       # touching borders: the wrap aliases
    return d


@pytest.mark.parametrize("vox,shape,rmax,border", [
    ((1.5, 1.5, 10.0), (32, 32, 8), 12, "wrap"),
    ((1.5, 1.5, 10.0), (64, 64, 8), 50, "wrap"),
    ((2.0, 2.0, 12.0), (32, 32, 8), 16, "pad"),
])
def test_geometry_equals_ventjax(vox, shape, rmax, border):
    want = jcp.build_ci_pairwise_geometry(vox, shape, rmax, border)
    got = tcp.build_ci_pairwise_geometry(vox, shape, rmax, border)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tcp._alias_combos(got) == jcp._alias_combos(want)
    for K in (256, 4096):
        # the tail tests the balls below ventjax's j_cap, and its plain
        # version's sort thresholds are ventjax's (j_lo is read only where
        # thr is finite)
        r2, T = tcp._tail_tables(got, K)
        jthr, jj_lo, jj_cap = jcp._threshold_tables(want, K)
        assert len(r2) == len(T) == jj_cap
        thr, j_lo, j_cap = ci_cuda._order_tables(torch.from_numpy(r2),
                                                 torch.from_numpy(T), K)
        np.testing.assert_array_equal(thr, np.asarray(jthr))
        finite = np.isfinite(thr)
        np.testing.assert_array_equal(j_lo[finite],
                                      np.asarray(jj_lo)[finite])
        assert j_cap == jj_cap


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("ns", [96, 128])
def test_head_counts_plain_bit_equal_pallas(border, ns):
    geom = tcp.build_ci_pairwise_geometry(VOX, SHAPE, RMAX, border)
    ns = min(ns, geom.n_balls - 1)
    K = 256
    t = tcp.defect_coords(torch.from_numpy(_defects())[None], K)[0]
    coords = tuple(c[0].numpy() for c in t)
    r2 = geom.r2_32[:ns]
    combos = tuple(tcp._alias_combos(geom))
    want = head_counts_pallas(
        *(jnp.asarray(c) for c in coords + coords), jnp.asarray(r2),
        combos=combos, scale=geom.scale, ns=ns, rmax=geom.rmax,
        interpret=True)
    got = head_counts(t, t, torch.from_numpy(r2), combos, geom.scale,
                      geom.rmax)
    assert got.dtype == torch.int32 and got.shape == (1, K, ns)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want).astype(np.int32))


def _both(defects, border, K, tail_k=None):
    geom_j = jcp.build_ci_pairwise_geometry(VOX, SHAPE, RMAX, border)
    geom_t = tcp.build_ci_pairwise_geometry(VOX, SHAPE, RMAX, border)
    got = tcp.calculate_ci_pairwise(torch.from_numpy(np.stack(defects)),
                                    geom_t, K, tail_k=tail_k)
    for i, d in enumerate(defects):
        want = jcp.calculate_ci_pairwise(jnp.asarray(d), geom_j, K,
                                         tail_k=tail_k, use_pallas=False)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        assert int(got[1][i]) == int(want[1])
        assert bool(got[2][i]) == bool(want[2])
    return got


@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_ci_map_bit_equal_jax_and_oracle(border):
    d0 = _defects(3)
    d1 = _defects(4)
    ci, sat, ovf = _both([d0, d1], border, 512)
    assert not ovf.any()
    if border == "wrap":     # the oracle replicates the reference's wrap
        for i, d in enumerate((d0, d1)):
            want = calculate_ci_oracle(d, vox=VOX, rmax=RMAX, saturate=True)
            assert np.abs(ci[i].numpy() - want).max() < 2e-5


def test_ci_empty_and_defect_overflow():
    empty = np.zeros(SHAPE, np.float32)
    ci, sat, ovf = _both([empty, _defects(5)], "wrap", 256)
    assert float(ci[0].sum()) == 0.0 and int(sat[0]) == 0
    assert not bool(ovf[0])
    # more defect voxels than K: flagged, never silent
    assert int(_defects(5).sum()) > 256 and bool(ovf[1])


def test_ci_full_saturation_k8192():
    full = np.ones(SHAPE, np.float32)      # 8192 defect voxels at K = 8192
    ci, sat, ovf = _both([full], "wrap", 8192)
    assert int(sat[0]) > 0


def test_ci_tail_overflow_flag():
    d = np.zeros(SHAPE, np.float32)
    d[4:20, 4:20, 1:5] = 1.0       # one dense cluster: rows reach the tail
    ci, sat, ovf = _both([d], "wrap", 1024, tail_k=16)
    assert bool(ovf[0])
    ci2, _, ovf2 = _both([d], "wrap", 1024, tail_k=1024)
    assert not bool(ovf2[0])


def _hist_balls(centers, witnesses, r2, T, combos, scale, rmax):
    """K10's arithmetic as a histogram: each witness's first ball
    (searchsorted), per-row prefix sums, the first ball whose count is
    under T, else nb."""
    d2 = ci_cuda._alias_min_d2(centers, witnesses, combos, scale, rmax)
    nb = r2.shape[0]
    first = torch.searchsorted(r2, d2.contiguous(), right=False)
    hist = torch.zeros(first.shape[:2] + (nb + 1,), dtype=torch.int64)
    hist.scatter_add_(2, first, torch.ones_like(first))
    fail = hist[..., :nb].cumsum(2) < T.to(torch.int64)
    j = fail.to(torch.uint8).argmax(2)
    return torch.where(fail.any(2), j, torch.full_like(j, nb))


def _blobs(shape, seed):
    """A severe-like defect map: four large ellipsoidal blobs, 90 % full,
    whose inner rows stay unresolved past the head balls."""
    gen = np.random.default_rng(seed)
    H, W, D = shape
    ii, jj, kk = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                             indexing="ij")
    d = np.zeros(shape, np.float32)
    for _ in range(4):
        c = gen.uniform([0, 0, 0], [H, W, D])
        r = gen.uniform([4, 4, 2], [10, 10, 5])
        blob = (((ii - c[0]) / r[0]) ** 2 + ((jj - c[1]) / r[1]) ** 2
                + ((kk - c[2]) / r[2]) ** 2) <= 1.0
        d[blob & (gen.random(shape) < 0.9)] = 1.0
    return d


def _maps(kind, shape, seed):
    if kind == "random":
        gen = np.random.default_rng(seed)
        return [(gen.random(shape) < p).astype(np.float32)
                for p in (0.6, 0.03)]
    return [_blobs(shape, seed + i) for i in range(2)]


def _tail_call(defects, geom, K):
    """The arguments ``ci_pairwise_balls`` hands K10 when the engine runs
    ``defects`` with its tail at full width: compacted tail rows with
    sentinels, and the defect coordinates as witnesses."""
    seen = []
    real = tcp.tail_balls

    def spy(*args):
        seen.append(args)
        return real(*args)
    tcp.tail_balls = spy
    try:
        tcp.calculate_ci_pairwise(torch.from_numpy(np.stack(defects)), geom,
                                  K, tail_k=K)
    finally:
        tcp.tail_balls = real
    assert len(seen) == 1       # one call for the whole tail, no row chunks
    return seen[0]


@pytest.mark.parametrize("border", ["wrap", "pad"])
@pytest.mark.parametrize("maps", ["random", "severe"])
@pytest.mark.parametrize("shape,rmax,K,Kw", [
    ((32, 32, 8), 12, 256, 100),      # Kw not a multiple of 32
    ((32, 32, 8), 12, 300, 1024),     # j_cap = M - 1: every ball tested
    ((64, 64, 8), 50, 512, 512),
    ((64, 64, 8), 50, 1024, 2048),
])
def test_tail_balls_histogram_equals_sort(border, maps, shape, rmax, K, Kw):
    """The sort path (``tail_balls_plain``, through the wrapper) against a
    histogram of first balls, every defect voxel a center: the same first
    failing ball on every row, pad rows and witnesses included."""
    geom = tcp.build_ci_pairwise_geometry(VOX, shape, rmax, border)
    d = torch.from_numpy(np.stack(_maps(maps, shape, K + Kw)))
    centers = tcp.defect_coords(d, K)[0]
    witnesses = tcp.defect_coords(d, Kw)[0]
    r2, T = (torch.from_numpy(a) for a in tcp._tail_tables(geom, Kw))
    if Kw == 1024:
        assert len(r2) == geom.n_balls - 1
    args = (tcp._alias_combos(geom), geom.scale, geom.rmax)
    got = ci_cuda.tail_balls(centers, witnesses, r2, T, *args)
    assert got.dtype == torch.int64 and got.shape == (2, K)
    assert torch.equal(got, _hist_balls(centers, witnesses, r2, T, *args))
    assert int(got.max()) > 0


@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_tail_balls_on_the_engines_tail(border):
    """The engine's own tail on severe-like maps (rows unresolved after
    the head balls, then sentinel rows): one call, and the two
    formulations agree."""
    geom = tcp.build_ci_pairwise_geometry(VOX, (64, 64, 8), 50, border)
    args = _tail_call(_maps("severe", (64, 64, 8), 1), geom, 2048)
    centers = args[0]
    live = centers[0] < tcp.SENT
    assert bool(live.any()) and not bool(live.all())
    got = ci_cuda.tail_balls(*args)
    assert torch.equal(got, _hist_balls(*args))
    assert int(got[live].max()) > 96        # failing past the head balls


def test_tail_balls_on_direct_coordinates():
    """Arbitrary centers and witnesses, sentinel-only rows and witnesses,
    and an empty ball table (nb 0): the two formulations agree."""
    geom = tcp.build_ci_pairwise_geometry(VOX, SHAPE, RMAX, "wrap")
    gen = np.random.default_rng(5)
    coord = lambda n, hi: torch.from_numpy(
        gen.integers(0, hi, size=(3, n)).astype(np.int32))
    centers = (coord(77, 32), coord(77, 32), coord(77, 8))
    witnesses = [coord(333, 32), coord(333, 32), coord(333, 8)]
    for c in centers:
        c[1, :] = tcp.SENT                  # a lane of sentinel rows
    for w in witnesses:
        w[2, :] = tcp.SENT                  # a lane of sentinel witnesses
    r2, T = (torch.from_numpy(a) for a in tcp._tail_tables(geom, 333))
    args = (tcp._alias_combos(geom), geom.scale, geom.rmax)
    got = ci_cuda.tail_balls(centers, tuple(witnesses), r2, T, *args)
    assert torch.equal(got, _hist_balls(centers, witnesses, r2, T, *args))
    assert not bool(got[1].any()) and not bool(got[2].any())
    none = ci_cuda.tail_balls(centers, tuple(witnesses), r2[:0], T[:0],
                              *args)
    assert not bool(none.any())


def test_tail_balls_rejects_what_the_kernel_cannot_take():
    geom = tcp.build_ci_pairwise_geometry(VOX, SHAPE, RMAX, "wrap")
    c = tuple(torch.zeros((2, 64), dtype=torch.int32) for _ in range(3))
    w = tuple(torch.zeros((2, 96), dtype=torch.int32) for _ in range(3))
    r2, T = (torch.from_numpy(a) for a in tcp._tail_tables(geom, 96))
    args = (tcp._alias_combos(geom), geom.scale, geom.rmax)
    with pytest.raises(TypeError):          # int64 coordinates
        ci_cuda.tail_balls(tuple(x.long() for x in c), w, r2, T, *args)
    with pytest.raises(TypeError):          # float64 radii
        ci_cuda.tail_balls(c, w, r2.double(), T, *args)
    with pytest.raises(TypeError):          # int64 thresholds
        ci_cuda.tail_balls(c, w, r2, T.long(), *args)
    with pytest.raises(ValueError):         # witnesses of unequal width
        ci_cuda.tail_balls(c, (w[0], w[1][:, :50], w[2]), r2, T, *args)
    with pytest.raises(ValueError):         # centers of unequal shape
        ci_cuda.tail_balls((c[0], c[1][:1], c[2]), w, r2, T, *args)
    with pytest.raises(ValueError):         # r2 and T of unequal length
        ci_cuda.tail_balls(c, w, r2, T[:-1], *args)
    with pytest.raises(ValueError):         # neither pad nor wrap
        ci_cuda.tail_balls(c, w, r2, T, args[0][:3], *args[1:])
    with pytest.raises(ValueError):         # non-contiguous coordinates
        ci_cuda.tail_balls(tuple(x.t().contiguous().t() for x in c), w, r2,
                           T, *args)
    with pytest.raises(RuntimeError):       # no kernel for this device
        ci_cuda.tail_balls(
            tuple(x.to("meta") for x in c), tuple(x.to("meta") for x in w),
            r2.to("meta"), T.to("meta"), *args)
