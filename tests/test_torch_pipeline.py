"""ventjax_torch.pipeline.analyze_cohort against ventjax's analyze_cohort
and the oracle, on a batch of two 64x64x8 phantoms.

Tolerances: |dVDP|, |dVDP_lb|, |dVDP_km| < 0.1 percentage points (the
fidelity budget; the two N4s differ within the bf16-fit envelope); SNR
relative 1e-4 (float32 sums in another order); lung volume, `valid` and the
overflow flags exact.  The CI map is held against the oracle CI of the
port's OWN defect array to 2e-5 mm (float32 radii).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.io.phantom import make_cohort
from ventjax.oracle.ci_oracle import calculate_ci_oracle, subject_ci
from ventjax.pipeline.analyze import analyze_cohort as jax_analyze_cohort
from ventjax.pipeline.analyze import build_geometry as jax_build_geometry
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.pipeline import (
    analyze_cohort, analyze_study, build_geometry,
)

torch.set_num_threads(2)

SHAPE = (64, 64, 8)
VOX = (1.5, 1.5, 10.0)
CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
JCFG = JAX_DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024, n4_mask_pad=8192)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runs():
    hp, mask, _ = make_cohort(2, SHAPE, VOX, seed=0)
    port = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask),
                          build_geometry(VOX, SHAPE, CFG), CFG)
    geom = jax_build_geometry(VOX, SHAPE, JCFG)
    ref = jax.jit(lambda h, m: jax_analyze_cohort(h, m, geom, JCFG))(
        jnp.asarray(hp), jnp.asarray(mask))
    return hp, mask, port, ref


def _m(res, name):
    return np.asarray(getattr(res.metrics, name))


def test_cohort_matches_jax(runs):
    hp, mask, port, ref = runs
    for name in ("vdp", "vdp_lb", "vdp_km"):
        assert np.abs(_m(port, name) - _m(ref, name)).max() < 0.1, name
    snr_p, snr_j = _m(port, "snr"), _m(ref, "snr")
    assert np.abs(snr_p - snr_j).max() / np.abs(snr_j).max() < 1e-4
    for name in ("lung_volume", "valid", "ci_overflow", "n4_overflow"):
        np.testing.assert_array_equal(_m(port, name), _m(ref, name), name)
    assert _m(port, "valid").all()
    assert np.isfinite(_m(port, "ci")).all()
    m = mask > 0
    n4p, n4j = port.n4.numpy(), np.asarray(ref.n4)
    assert (np.abs(n4p - n4j)[m] / np.abs(n4j)[m]).max() < 2e-3


def test_ci_matches_oracle_of_own_defects(runs):
    _, _, port, _ = runs
    for i in range(2):
        defect = port.defect[i].numpy()
        want = calculate_ci_oracle(defect, vox=VOX, rmax=CFG.ci_rmax,
                                   saturate=True)
        assert np.abs(port.ci_map[i].numpy() - want).max() < 2e-5
        assert float(port.metrics.ci[i]) == pytest.approx(
            subject_ci(want, defect), abs=2e-5)


def test_empty_mask_lane_isolated(runs):
    hp, mask, port, _ = runs
    mask = mask.copy()
    mask[1] = 0.0
    res = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask),
                         build_geometry(VOX, SHAPE, CFG), CFG)
    valid = res.metrics.valid.numpy()
    assert list(valid) == [True, False]
    for name in ("snr", "vdp", "vdp_lb", "vdp_km", "ci", "defect_volume"):
        v = _m(res, name)
        assert np.isnan(v[1]) and np.isfinite(v[0]), name
        # the healthy lane is untouched by its empty neighbour
        assert v[0] == _m(port, name)[0], name
    np.testing.assert_array_equal(res.ci_map[0].numpy(),
                                  port.ci_map[0].numpy())


def test_analyze_study_single_volume(runs):
    hp, mask, port, _ = runs
    res = analyze_study(torch.from_numpy(hp[1]), torch.from_numpy(mask[1]),
                        build_geometry(VOX, SHAPE, CFG), CFG,
                        export_compact=True)
    d = res.metrics.as_dict()
    assert d["VDP"] == float(port.metrics.vdp[1])
    assert d["valid"] is True
    np.testing.assert_array_equal(res.ci_map.numpy(), port.ci_map[1].numpy())
    assert res.export["n4_cv"].shape == (CFG.n4_mask_pad,)


def test_package_imports_no_jax():
    """Every module of ventjax_torch imports without loading jax, flax,
    optax, orbax, any module of the ventjax package, PIL or matplotlib (the machine with the card
    lacks JAX and ventjax, and may lack the drawing libraries); importing
    the package itself, which exports Vent_Analysis, loads none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ventjax_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ventjax_torch.__path__, 'ventjax_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'ventjax_torch.ops.n4_cuda' in names\n"
        "assert 'ventjax_torch.ops.ci_cuda' in names\n"
        "assert 'ventjax_torch._build' in names\n"
        "assert 'ventjax_torch.ops.ci' in names\n"
        "assert 'ventjax_torch.pipeline.cohort' in names\n"
        "for n in ('compat.vent_analysis', 'compat.ci_module', "
        "'report.screenshot', 'report.histogram', 'report.montage', "
        "'report.parula', 'ops.morphology', 'ops.wavelet', "
        "'ops.fft_recon', 'io.twix', 'oracle.ci_oracle', 'dist.halo', "
        "'dist.mesh', 'dist.space', 'ops.n4_space', 'pipeline.spatial'):\n"
        "    assert 'ventjax_torch.' + n in names, n\n"
        "assert ventjax_torch.Vent_Analysis.__module__ == "
        "'ventjax_torch.compat.vent_analysis'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "assert 'ventjax_torch.models.segmentation' in names\n"
        "assert 'ventjax_torch.io.phantom_oof' in names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "bad = sorted(m for m in sys.modules if m == 'ventjax' or "
        "m.startswith('ventjax.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
