"""The traffic generator: deterministic from the seed, the phantom's lung
and parameters, and a mix's sizes."""
import json

import numpy as np
import pytest
import torch

from portbench.generate import lung_mask, make_studies
from portbench.tests._tiny import ROOT
from ventjax_torch.io.phantom import make_phantom

SHAPE, VOX = (48, 48, 8), (1.5, 1.5, 10.0)


@pytest.mark.parametrize("seed", [0, 2147483647, 2 ** 31 + 12345])
def test_same_seed_same_studies(seed):
    a = make_studies(3, SHAPE, VOX, seed, "cpu")
    b = make_studies(3, SHAPE, VOX, seed, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = make_studies(3, SHAPE, VOX, seed + 1, "cpu")
    assert not torch.equal(a[0], c[0])


def test_studies_differ_within_a_pool():
    hp, mask = make_studies(4, SHAPE, VOX, 5, "cpu")
    assert hp.shape == (4,) + SHAPE and hp.dtype == torch.float32
    assert all(not torch.equal(hp[0], hp[i]) for i in range(1, 4))
    assert all(torch.equal(mask[0], mask[i]) for i in range(1, 4))


def test_lung_is_make_phantoms():
    ph = make_phantom(shape=SHAPE, vox=VOX, seed=1)
    assert np.array_equal(lung_mask(SHAPE, "cpu").numpy(), ph.mask)


def test_signal_levels_follow_the_phantom():
    hp, mask = make_studies(2, SHAPE, VOX, 9, "cpu")
    lung = hp[mask > 0]
    assert 300 < float(lung.median()) < 500          # signal_level 400
    assert float(hp[mask == 0].mean()) < 20          # |N(0, 8)| floor
    assert bool((hp >= 0).all())


def test_severe_mix_plants_more_defect():
    mixes = {n: json.loads((ROOT / f"portbench/traffic/{n}.json").read_text())
             for n in ("typical.b16.pool32", "severe.b16.pool32")}
    low = {}
    for name, mix in mixes.items():
        hp, mask = make_studies(4, (128, 128, 16), VOX, 3, "cpu",
                                **mix["phantom"])
        low[name] = int(((hp < 100) & (mask > 0)).sum())
    assert low["severe.b16.pool32"] > 4 * low["typical.b16.pool32"]


@pytest.mark.parametrize("name", ["typical.b16.pool32", "severe.b16.pool32"])
def test_mix_sizes(name):
    mix = json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())
    bs, pool = mix["studies_per_call"], mix["pool_studies"]
    assert pool % bs == 0 and pool >= 2 * bs
    assert 1 <= mix["sample_calls"] <= pool // bs * 4
