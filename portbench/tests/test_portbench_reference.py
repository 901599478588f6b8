"""The plain reference against the port's NumPy oracle and against the
port's CPU path at tiny shapes."""
import json

import numpy as np
import pytest
import torch

from portbench.compare import judge_batch
from portbench.reference import pipeline as R
from portbench.tests._tiny import ROOT
from ventjax_torch import oracle
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.io.phantom import make_phantom
from ventjax_torch.oracle.n4_oracle import n4_bias_correction_oracle
from ventjax_torch.pipeline import analyze_cohort, build_geometry

torch.set_num_threads(2)
CONF = json.loads((ROOT / "portbench/configs/clinical_128x128x16.json")
                  .read_text())
PIPE = CONF["pipeline"]
VOX = (1.5, 1.5, 10.0)
SHAPE = (48, 48, 8)


@pytest.fixture(scope="module")
def phantoms():
    phs = [make_phantom(shape=SHAPE, vox=VOX, seed=s, n_defects=3,
                        defect_radius_vox=(3.0, 4.0, 5.0)) for s in (11, 12)]
    hp = torch.tensor(np.stack([p.hp for p in phs]))
    mask = torch.tensor(np.stack([p.mask for p in phs]))
    return phs, hp, mask


def test_n4_equals_the_oracle(phantoms):
    phs, hp, mask = phantoms
    traj, owner = R.n4(hp, mask, band=0.0, **R.n4_args(PIPE))
    assert owner.tolist() == [0, 1]
    for i, p in enumerate(phs):
        want = n4_bias_correction_oracle(p.hp, p.mask)
        m = p.mask > 0
        got = traj[i].numpy()
        assert np.abs(got[m] / want[m] - 1).max() < 1e-12


def test_n4_band_follows_both_outcomes(phantoms):
    _, hp, mask = phantoms
    one, _ = R.n4(hp, mask, band=0.0, **R.n4_args(PIPE))
    many, owner = R.n4(hp, mask, band=0.5, **R.n4_args(PIPE))
    assert len(owner) > 2 and sorted(set(owner.tolist())) == [0, 1]
    # the trajectory that takes every test as the threshold does is there
    for i in range(2):
        gaps = [float((many[j] - one[i]).abs().max())
                for j in torch.nonzero(owner == i).reshape(-1)]
        assert min(gaps) == 0.0


def test_snr_and_vdps_equal_the_oracle(phantoms):
    phs, hp, mask = phantoms
    snr = R.snr(hp, mask, 10)
    for i, p in enumerate(phs):
        # the oracle takes its means in the images' float32
        assert float(snr[i]) == pytest.approx(
            oracle.calculate_snr(p.hp.astype(np.float64), p.mask, 10),
            rel=1e-12)
        n4 = n4_bias_correction_oracle(p.hp, p.mask)
        t = torch.tensor(n4)[None]
        m = mask[i:i + 1]
        for ours, theirs in (
                (R.vdp_mean_anchored(t, m, 0.6),
                 oracle.vdp_mean_anchored(n4, p.mask, 0.6)),
                (R.vdp_linear_binning(t, m, PIPE["lb_edges"], 0.99),
                 oracle.vdp_linear_binning(n4, p.mask)),
                (R.vdp_kmeans(t, m, 4, 30, 1),
                 oracle.vdp_kmeans(n4, p.mask))):
            assert np.array_equal(ours[0][0].numpy(), theirs[0])
            assert float(ours[1][0]) == pytest.approx(theirs[1], rel=1e-12)


@pytest.mark.parametrize("vox", [(1.5, 1.5, 10.0), (3.125, 3.125, 15.0)])
def test_ci_map_equals_the_oracle(phantoms, vox):
    phs, _, _ = phantoms
    defect = phs[0].true_defect
    got = R.ci_map(torch.tensor(defect)[None], vox, 50)[0].numpy()
    want = oracle.calculate_ci_oracle(defect, vox, 50, saturate=True)
    assert np.array_equal(got, want)
    assert float(R.subject_ci(torch.tensor(got)[None],
                              torch.tensor(defect)[None], 0.95)[0]) == \
        float(np.sort(want[defect > 0])[int(0.95 * (defect > 0).sum())])


def test_port_cpu_path_within_the_limits(phantoms):
    _, hp, mask = phantoms
    pipe = dict(PIPE, snr_fov_buffer=10)
    cfg = DEFAULT_CONFIG.replace(snr_fov_buffer=10, ci_max_defect_voxels=512)
    res = analyze_cohort(hp, mask, build_geometry(VOX, SHAPE, cfg), cfg)
    out = {k: getattr(res, k) for k in ("n4", "defect", "defect_lb",
                                        "defect_km", "ci_map")}
    out["metrics"] = dict(vars(res.metrics))
    r = judge_batch(hp.numpy(), mask.numpy(), out, VOX, pipe, "cpu")
    lim = CONF["fidelity"]
    assert all(r[k] <= lim[k] for k in r), r
    assert r["defect_mismatch"] == 0 and r["ci_map_mm"] < 1e-5
