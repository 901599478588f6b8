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
        thr, j_lo, j_cap = tcp._threshold_tables(got, K)
        jthr, jj_lo, jj_cap = jcp._threshold_tables(want, K)
        np.testing.assert_array_equal(thr, np.asarray(jthr))
        np.testing.assert_array_equal(j_lo, np.asarray(jj_lo))
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
