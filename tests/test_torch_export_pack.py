"""The cohort driver's compact export pack, ``cohort --dense-export`` and
``enable_debug_checks`` of ventjax_torch, each beside ventjax's
counterpart on the same inputs, on the CPU.

The counterparts of tests/test_pipeline.py's compact-pack and debug-check
cases and of tests/test_cohort_retry.py's ceiling fallback.  Tolerances:
the port's rebuilt defect and CI channels and masked N4 voxels bit-equal
to its dense pack and to its own analyze_cohort (as ventjax's are to its
own), the out-of-mask N4 background within 1e-5 relative (the host's
float64 lattices against the card's float32 field), the host rebuild's
field equal to ventjax's bit for bit (the same numpy float64 code); across
the packages the VDPs within 0.1 pp (the two N4s differ within the
bf16-fit envelope) and the defect counts, flags and engines' channels as
tests/test_torch_cohort.py holds them.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.io.nifti import load as nifti_load
from ventjax.io.phantom import make_cohort, make_phantom
from ventjax.io.synthetic import write_study
from ventjax.ops.n4 import n4_field_from_phi_np as jax_field_from_phi
from ventjax.ops.n4 import n4_phi_sizes as jax_phi_sizes
from ventjax.pipeline import cohort as jc
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.ops.ci import CIGeometry
from ventjax_torch.ops.n4 import n4_field_from_phi_np, n4_phi_sizes
from ventjax_torch.pipeline import analyze, analyze_cohort, build_geometry
from ventjax_torch.pipeline import cohort as tc
from ventjax_torch.utils import profiling

torch.set_num_threads(2)
SHAPE, VOX = (32, 32, 8), (1.5, 1.5, 10.0)
LADDER_VOX = (3.125, 3.125, 15.0)
KW = dict(ci_max_defect_voxels=512, ci_rmax=12, n4_fitting_levels=2,
          n4_max_iters=5)
CFG, JCFG = DEFAULT_CONFIG.replace(**KW), JAX_DEFAULT_CONFIG.replace(**KW)


def _nifti(out, sid):
    return nifti_load(os.path.join(out, sid, f"{sid}_dataArray.nii"))[0]


@pytest.mark.parametrize("levels,shape", [(2, (32, 32, 8)),
                                          (4, (48, 40, 12))])
def test_field_from_phi_equals_ventjax(levels, shape):
    sizes = n4_phi_sizes(levels, 4)
    assert sizes == jax_phi_sizes(levels, 4)
    phi = np.random.default_rng(levels).standard_normal(
        sum(sizes)).astype(np.float32)
    got = n4_field_from_phi_np(phi, shape, fitting_levels=levels)
    assert got.dtype == np.float64 and got.shape == shape
    np.testing.assert_array_equal(
        got, jax_field_from_phi(phi, shape, fitting_levels=levels))
    with pytest.raises(ValueError, match="coefficients"):
        n4_field_from_phi_np(np.append(phi, 0), shape, fitting_levels=levels)


@pytest.fixture(scope="module")
def compact_batch():
    """tests/test_pipeline.py's batch (lane 3 invalid) through the port's
    runner with the compact pack and through analyze_cohort, and ventjax's
    compact pack of the same batch."""
    hp, mask, _ = make_cohort(4, shape=SHAPE, vox=VOX, seed=21)
    mask[3] = 0.0
    runner = tc._GeometryRunner(SHAPE, VOX, CFG, 4, device="cpu")
    batch = [({"id": f"s{i}"}, (hp[i], mask[i], VOX, None, None))
             for i in range(4)]
    pack, pads = runner.dispatch(batch)
    assert pads[:2] == (512, 8192)
    cfg8 = CFG.replace(n4_mask_pad=8192)
    res = analyze_cohort(torch.from_numpy(hp), torch.from_numpy(mask),
                         build_geometry(VOX, SHAPE, cfg8), cfg8)
    jrunner = jc._GeometryRunner(SHAPE, VOX, JCFG, mesh=None, batch_size=4)
    raw = jrunner._fn(512, 8192, compact=True)(jnp.asarray(hp),
                                                jnp.asarray(mask))
    jhost = jc._decode_host_pack(jax.tree_util.tree_map(np.asarray, raw),
                                 jrunner.blob_schema(512, 8192))
    return hp, mask, pack, res, jhost, cfg8


def test_compact_pack_rebuilds_dense_channels(compact_batch):
    hp, mask, pack, res, jhost, cfg8 = compact_batch
    assert sorted(pack) == ["ci_cv", "cidx", "mvec", "n4_cv", "n_def",
                            "phi"]
    host = {k: v.numpy() for k, v in pack.items() if k != "mvec"}
    metrics = tc._metrics_from_vec(pack["mvec"].numpy())
    jm = jhost["metrics"]
    for lane in range(3):
        lp = {k: v[lane] for k, v in host.items()}
        rb = tc._rebuild_compact_pack(lp, hp[lane], mask[lane], cfg8)
        assert np.array_equal(tc._densify_ci(rb), res.ci_map[lane].numpy())
        assert np.array_equal(rb["defect"].astype(np.float32),
                              res.defect[lane].numpy())
        m = mask[lane].reshape(-1) > 0
        got, want = rb["n4"].reshape(-1), res.n4[lane].numpy().reshape(-1)
        np.testing.assert_array_equal(got[m], want[m])
        rel = np.abs(got[~m] - want[~m]) / np.maximum(np.abs(want[~m]), 1e-6)
        assert rel.max() < 1e-5
        # ventjax's pack of the same lane: its rebuild's defect count and
        # VDP beside the port's
        jp = jax.tree_util.tree_map(lambda x: x[lane], jhost)
        jrb = jc._rebuild_compact_pack(jp, hp[lane], mask[lane],
                                       JCFG.replace(n4_mask_pad=8192))
        assert abs(float(metrics.vdp[lane]) - float(jm.vdp[lane])) < 0.1
        assert abs(int(jrb["defect"].sum()) - int(rb["defect"].sum())) \
            <= 0.001 * m.sum()
    # the invalid lane: the device's own flagged first-K truncation of the
    # stand-in mask's defects (cidx shipped, not derived from the host
    # mask); N4 is the host's alone; NaN metrics, as in ventjax
    lp = {k: v[3] for k, v in host.items()}
    rb = tc._rebuild_compact_pack(lp, hp[3], mask[3], cfg8)
    assert bool(metrics.ci_overflow[3]) and bool(jm.ci_overflow[3])
    got_idx = np.flatnonzero(rb["defect"].reshape(-1))
    dev_idx = np.flatnonzero(res.defect[3].numpy().reshape(-1))
    np.testing.assert_array_equal(got_idx, dev_idx[:512])
    assert np.isnan(float(metrics.vdp[3])) and np.isnan(float(jm.vdp[3]))
    assert not bool(metrics.valid[3]) and not bool(jm.valid[3])


def test_rebuild_whatever_the_memory_layout(compact_batch, monkeypatch):
    """The masked voxels are the shipped values when the study and the
    host field come in Fortran order (a decoded volume is often a
    transposed view), where numpy makes the background product
    non-C-contiguous."""
    from ventjax_torch.ops import n4 as tn4

    hp, mask, pack, res, _, cfg8 = compact_batch
    real = tn4.n4_field_from_phi_np
    monkeypatch.setattr(tn4, "n4_field_from_phi_np",
                        lambda *a, **kw: np.asfortranarray(real(*a, **kw)))
    lp = {k: v[0].numpy() for k, v in pack.items() if k != "mvec"}
    rb = tc._rebuild_compact_pack(lp, np.asfortranarray(hp[0]),
                                  np.asfortranarray(mask[0]), cfg8)
    m = mask[0] > 0
    np.testing.assert_array_equal(rb["n4"][m], res.n4[0].numpy()[m])
    assert rb["n4"].shape == hp[0].shape


@pytest.fixture(scope="module")
def two_engines(tmp_path_factory):
    """ventjax's two-geometry manifest (pairwise and ladder CI engines)
    through the port's driver with the compact and the dense pack, and
    through ventjax's with its compact default."""
    tmp = tmp_path_factory.mktemp("packs")
    cfg = dict(KW, ci_rmax=16)
    assert not isinstance(build_geometry(VOX, SHAPE, CFG.replace(**cfg)),
                          CIGeometry)
    assert isinstance(build_geometry(LADDER_VOX, SHAPE, CFG.replace(**cfg)),
                      CIGeometry)
    manifest = []
    for i, vox in enumerate((VOX, LADDER_VOX)):
        root = str(tmp / f"s{i}")
        write_study(root, shape=SHAPE, vox=vox, seed=40 + i,
                    with_proton=False)
        manifest.append({"id": f"s{i}", "xenon": f"{root}/xenon.dcm",
                         "mask": f"{root}/mask"})
    port = {mode: tc.run_cohort(manifest, str(tmp / mode),
                                config=DEFAULT_CONFIG.replace(**cfg),
                                device="cpu", compact_export=mode == "compact")
            for mode in ("compact", "dense")}
    ref = jc.run_cohort(manifest, str(tmp / "ref"),
                        config=JAX_DEFAULT_CONFIG.replace(**cfg),
                        use_mesh=False)
    return tmp, port, ref


@pytest.mark.parametrize("sid", ["s0", "s1"])   # pairwise, ladder
def test_compact_and_dense_exports_agree(two_engines, sid):
    tmp, port, ref = two_engines
    by = {m: {r["id"]: r for r in rs} for m, rs in port.items()}
    mc, md = by["compact"][sid], by["dense"][sid]
    assert json.dumps(mc, sort_keys=True) == json.dumps(md, sort_keys=True)
    ac, ad = _nifti(str(tmp / "compact"), sid), _nifti(str(tmp / "dense"),
                                                       sid)
    for ch in (0, 1, 2, 4, 5):     # proton, hp, mask, defect, CI
        np.testing.assert_array_equal(ac[..., ch], ad[..., ch])
    m = ad[..., 2] > 0
    np.testing.assert_array_equal(ac[..., 3][m], ad[..., 3][m])
    assert np.allclose(ac[..., 3], ad[..., 3], rtol=1e-5, atol=1e-5)
    # against ventjax's compact export of the same study
    want = {r["id"]: r for r in ref}[sid]
    for k in ("VDP", "VDP_lb", "VDP_km"):
        assert abs(mc[k] - want[k]) < 0.1, k
    for k in ("LungVolume", "valid", "CI_overflow", "N4_overflow"):
        assert mc[k] == want[k], k
    aj = _nifti(str(tmp / "ref"), sid)
    for ch in (0, 1, 2, 4):
        np.testing.assert_array_equal(ac[..., ch], aj[..., ch])
    assert np.abs(ac[..., 5] - aj[..., 5]).max() < 2e-5


def test_ceiling_overflow_falls_back_to_dense_defect_export(tmp_path):
    """tests/test_cohort_retry.py's case through both drivers: a defect
    count above the CI pad's ceiling spends every budget, the flag stands,
    and the exported defect channel is complete (the batch re-ran with the
    dense pack), the CI channel the flagged first K."""
    shape = (48, 48, 8)
    kw = dict(ci_max_defect_voxels=256, n4_fitting_levels=2,
              n4_max_iters=5)
    ph = make_phantom(shape=shape, vox=VOX, seed=31, n_defects=0)
    hp = np.asarray(ph.hp).copy()
    hp[16:28, 16:28, 2:6] = np.minimum(hp[16:28, 16:28, 2:6], 2.0)
    ph.hp[...] = hp
    root = str(tmp_path / "s0")
    write_study(root, phantom=ph)
    manifest = [{"id": "s0", "xenon": f"{root}/xenon.dcm",
                 "mask": f"{root}/mask"}]
    runners = {}
    got = tc.run_cohort(manifest, str(tmp_path / "port"),
                        config=DEFAULT_CONFIG.replace(**kw), batch_size=1,
                        device="cpu", runners=runners)
    (runner,) = runners.values()
    assert runner.compact and runner.ci_force_dense and runner.ci_tail_full
    want = jc.run_cohort(manifest, str(tmp_path / "ref"),
                         config=JAX_DEFAULT_CONFIG.replace(**kw),
                         use_mesh=False, batch_size=1)
    vox_cc = float(np.prod(VOX)) / 1000.0
    counts = []
    for out, m in ((tmp_path / "port", got[0]), (tmp_path / "ref", want[0])):
        assert m["valid"] and m["CI_overflow"], m
        data = _nifti(str(out), "s0")
        n_exported = int((data[..., 4] > 0).sum())
        assert n_exported == int(round(m["DefectVolume"] * 1000.0 / vox_cc))
        assert n_exported > 256
        assert int((data[..., 5] > 0).sum()) <= 256
        counts.append(n_exported)
    assert abs(got[0]["VDP"] - want[0]["VDP"]) < 0.1


def test_bump_policy_forces_the_dense_pack_last():
    """After the pad ladder and the tail escalation, a compact batch's
    standing CI overflow re-runs once with the dense pack; a dense batch's
    stands (ventjax's bump_for_retry)."""
    for vox, pairwise in ((VOX, True), (LADDER_VOX, False)):
        cfg = CFG.replace(ci_rmax=16, ci_max_defect_voxels=512)
        r = tc._GeometryRunner((64, 64, 8), vox, cfg, 1, device="cpu")
        j = jc._GeometryRunner((64, 64, 8), vox,
                               JCFG.replace(ci_rmax=16), None, 1)
        pads = (512, 8192, False)
        seq = []
        for _ in range(4):
            a = r.bump_for_retry(True, False, pads, compact_pack=True)
            b = j.bump_for_retry(True, False, pads, compact_pack=True)
            assert a == b
            seq.append((a, r.ci_tail_full, r.ci_force_dense))
            assert (r.ci_tail_full, r.ci_force_dense) == (
                j.ci_tail_full, j.ci_force_dense)
            pads = (512, 8192, r.ci_tail_full)
        assert r.ci_force_dense
        assert not r.bump_for_retry(True, False, pads, compact_pack=False)


def test_cli_dense_export_equals_run_cohort(tmp_path, capsys):
    """``cohort --dense-export`` parses as ventjax's CLI parses it and
    writes what run_cohort(compact_export=False) writes."""
    from ventjax.cli import build_parser as jax_parser
    from ventjax_torch.cli import main

    root = str(tmp_path / "s0")
    write_study(root, shape=SHAPE, vox=VOX, seed=40, with_proton=False)
    manifest = [{"id": "s0", "xenon": f"{root}/xenon.dcm",
                 "mask": f"{root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    argv = ["cohort", "--manifest", mpath, "--out", str(tmp_path / "cli"),
            "--dense-export"]
    assert jax_parser().parse_args(argv).dense_export
    assert main(argv + ["--max-defect", "512", "--device", "cpu"]) == 0
    capsys.readouterr()
    tc.run_cohort(manifest, str(tmp_path / "api"),
                  config=DEFAULT_CONFIG.replace(ci_max_defect_voxels=512),
                  device="cpu", compact_export=False)
    for f in ("s0_dataArray.nii", "metrics.json"):
        assert (tmp_path / "cli" / "s0" / f).read_bytes() == (
            tmp_path / "api" / "s0" / f).read_bytes(), f


# ------------------------------------------------------------ debug checks

def _port_fn(shape=(64, 64, 8)):
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024)
    geom = build_geometry(VOX, shape, cfg)
    return lambda hp, mask: analyze_cohort(torch.from_numpy(hp),
                                           torch.from_numpy(mask), geom, cfg)


@pytest.fixture
def debug_checks():
    profiling.enable_debug_checks()
    yield
    profiling.enable_debug_checks(False, False)


def test_pipeline_under_debug_checks(debug_checks):
    """tests/test_pipeline.py's case: the healthy pipeline runs clean under
    the checks, as ventjax's does under jax_debug_nans/infs."""
    from ventjax.pipeline import make_analyze_fn
    from ventjax.utils.profiling import enable_debug_checks

    hp, mask, _ = make_cohort(1, shape=(64, 64, 8), vox=VOX, seed=4)
    got = _port_fn()(hp, mask)
    assert np.isfinite(float(got.metrics.vdp[0]))
    enable_debug_checks()
    try:
        res = make_analyze_fn(VOX, (64, 64, 8),
                              JAX_DEFAULT_CONFIG.replace(
                                  ci_max_defect_voxels=1024))(
            jnp.asarray(hp[0]), jnp.asarray(mask[0]))
        want = float(res.metrics.vdp)
    finally:
        jax.config.update("jax_debug_nans", False)
        jax.config.update("jax_debug_infs", False)
    assert abs(float(got.metrics.vdp[0]) - want) < 0.1


def test_debug_checks_exempt_invalid_lanes(debug_checks):
    hp, mask, _ = make_cohort(2, shape=(64, 64, 8), vox=VOX, seed=4)
    mask[1] = 0.0
    hp[1] = 0.0          # a padding lane: its SNR is 0 / 0
    res = _port_fn()(hp, mask)
    assert bool(res.metrics.valid[0]) and not bool(res.metrics.valid[1])
    assert np.isnan(float(res.metrics.snr[1]))


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_debug_checks_name_the_stage(debug_checks, monkeypatch, kind):
    real = analyze.n4_bias_correction

    def poisoned(*a, **kw):
        out = real(*a, **kw)
        n4 = out[0].clone()
        n4[0, 5, 5, 2] = float(kind)
        return (n4,) + tuple(out[1:])

    monkeypatch.setattr(analyze, "n4_bias_correction", poisoned)
    # 64x64x8: at 32x32x8 the SNR's noise rows are empty (NaN by design)
    hp, mask, _ = make_cohort(1, shape=(64, 64, 8), vox=VOX, seed=4)
    with pytest.raises(FloatingPointError, match="'n4'") as e:
        _port_fn()(hp, mask)
    assert ("NaN" if kind == "nan" else "Inf") in str(e.value)
    profiling.enable_debug_checks(nans=kind != "nan", infs=kind != "inf")
    _port_fn()(hp, mask)     # that kind unchecked: no raise


def test_debug_checks_off_touch_nothing():
    """Off, a check reads none of its tensors: no sync and no launch."""
    class Untouchable:
        def __getattribute__(self, name):
            raise AssertionError(f"read {name}")

    profiling.enable_debug_checks(False, False)
    profiling.check_stage("n4", Untouchable(), Untouchable())
