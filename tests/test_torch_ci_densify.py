"""ventjax_torch rank-densify kernels K9, K8 (ops/ci_densify_cuda.py) and the
CI map built with them, against ventjax.

On the CPU the wrappers run their plain versions.  Ranks are integers and
the dense map copies cv values without arithmetic, so every comparison here
is bit-equal: against ventjax's Pallas kernels in interpret mode (as
tests/test_ci_pallas.py runs them), against numpy, and for the whole CI map
against ventjax's ``pallas_densify=True`` and the port's own scatter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.ops import ci_pairwise as jcp
from ventjax.ops.ci_pallas import densify_rank_pallas, rank_pallas
from ventjax_torch.ops import ci_densify_cuda as cd
from ventjax_torch.ops import ci_pairwise as tcp

torch.set_num_threads(2)

VOX = (1.5, 1.5, 10.0)
RMAX = 12


def _d01(N, V, rate, seed):
    return np.random.default_rng(seed).random((N, V)) < rate


@pytest.mark.parametrize("V,rate", [(8192, 0.03), (16384, 0.5)])
def test_rank_plain_bit_equal_pallas(V, rate):
    d = _d01(2, V, rate, V)
    got = cd.rank(torch.from_numpy(d))
    assert got.dtype == torch.int32 and got.shape == (2, V)
    for n in range(2):
        want = np.asarray(rank_pallas(jnp.asarray(d[n]), interpret=True))
        np.testing.assert_array_equal(got[n].numpy(), want)
        np.testing.assert_array_equal(got[n].numpy(), np.cumsum(d[n]) - 1)


@pytest.mark.parametrize("V,K,rate", [
    (8192, 512, 0.03),     # every defect voxel within the pad
    (4096, 64, 0.05),      # rank >= k: the excess voxels stay 0
])
def test_densify_plain_bit_equal_pallas(V, K, rate):
    d = _d01(2, V, rate, K)
    cv = np.random.default_rng(K + 1).random((2, K)).astype(np.float32)
    d_t = torch.from_numpy(d)
    got = cd.densify_rank(cd.rank(d_t), d_t, torch.from_numpy(cv), K)
    assert got.dtype == torch.float32 and got.shape == (2, V)
    for n in range(2):
        rank = jnp.cumsum(jnp.asarray(d[n], jnp.int32)) - 1
        want = np.asarray(densify_rank_pallas(
            rank, jnp.asarray(d[n], jnp.int32), jnp.asarray(cv[n]), K,
            interpret=True))
        np.testing.assert_array_equal(got[n].numpy(), want)
        idx = np.nonzero(d[n])[0][:K]
        ref = np.zeros(V, np.float32)
        ref[idx] = cv[n, :len(idx)]
        np.testing.assert_array_equal(got[n].numpy(), ref)
    if K == 64:
        assert int(d.sum(1).min()) > K


def _defects(shape, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random(shape) > 0.97).astype(np.float32)
    d[8:14, 8:14, 2:5] = 1.0       # a cluster: non-trivial crossings
    d[0:3, -4:, 0:2] = 1.0         # touching borders: the wrap aliases
    return d


@pytest.mark.parametrize("K", [256, 512])
def test_ci_pallas_densify_bit_equal_ventjax_and_scatter(K):
    """32x32x8 (V = 8192): ventjax takes its kernels there too.  At K 256
    the defects overflow the pad, so the drop path is compared as well."""
    shape = (32, 32, 8)
    defects = [_defects(shape, 3), _defects(shape, 4)]
    geom_j = jcp.build_ci_pairwise_geometry(VOX, shape, RMAX, "wrap")
    geom_t = tcp.build_ci_pairwise_geometry(VOX, shape, RMAX, "wrap")
    batch = torch.from_numpy(np.stack(defects))
    got = tcp.calculate_ci_pairwise(batch, geom_t, K, pallas_densify=True)
    scatter = tcp.calculate_ci_pairwise(batch, geom_t, K)
    for a, b in zip(got, scatter):
        assert torch.equal(a, b)
    assert bool(got[2].any()) == (K == 256)
    for i, d in enumerate(defects):
        want = jcp.calculate_ci_pairwise(jnp.asarray(d), geom_j, K,
                                         use_pallas=False,
                                         pallas_densify=True)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        assert int(got[1][i]) == int(want[1])
        assert bool(got[2][i]) == bool(want[2])


def test_ci_pallas_densify_ragged_volume():
    """V = 30*30*7 = 6300 is no multiple of 4096: ventjax would scatter, the
    port's kernels take it; port against port."""
    shape = (30, 30, 7)
    geom = tcp.build_ci_pairwise_geometry(VOX, shape, RMAX, "wrap")
    batch = torch.from_numpy(np.stack([_defects(shape, 5),
                                       np.zeros(shape, np.float32)]))
    got = tcp.calculate_ci_pairwise(batch, geom, 512, pallas_densify=True)
    want = tcp.calculate_ci_pairwise(batch, geom, 512, pallas_densify=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[0][0].sum()) > 0 and float(got[0][1].sum()) == 0


def test_densify_wrappers_reject_bad_input():
    d = torch.zeros((2, 100), dtype=torch.bool)
    r = torch.zeros((2, 100), dtype=torch.int32)
    cv = torch.zeros((2, 16))
    with pytest.raises(TypeError, match="bool"):
        cd.rank(d.to(torch.float32))
    with pytest.raises(TypeError, match="rank"):
        cd.densify_rank(r.to(torch.int64), d, cv, 16)
    with pytest.raises(TypeError, match="cv"):
        cd.densify_rank(r, d, cv, 8)
    with pytest.raises(TypeError, match="cv"):
        cd.densify_rank(r, d, cv.double(), 16)
    meta_d = torch.empty((2, 100), dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        cd.rank(meta_d)
    with pytest.raises(RuntimeError, match="no kernel"):
        cd.densify_rank(torch.empty((2, 100), dtype=torch.int32,
                                    device="meta"), meta_d,
                        torch.empty((2, 16), device="meta"), 16)
