"""ventjax_torch.dist (the slice-sharded halo CI, the batch mesh) against
ventjax.dist, on the CPU.

JAX runs on the eight fake CPU devices of tests/conftest.py; the port runs
on a mesh of repeated CPU devices (``local_devices`` replaced, as its
docstring allows).  Tolerances: the CI maps, saturated counts and overflow
flags bit-equal to ventjax's sharded result and to the port's unsharded
engine; the batch mesh bit-identical to the port's unsharded call, and
within the port's documented tolerances of ventjax's sharded cohort
(defect maps exact, |dVDP| <= 0.1 pp, CI map within 2e-5 mm where the
defect maps agree).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ventjax.compat import ci_module as jci
from ventjax.config import DEFAULT_CONFIG as JAX_DEFAULT_CONFIG
from ventjax.dist import halo as jhalo
from ventjax.dist import make_batch_mesh as jax_batch_mesh
from ventjax.dist import shard_cohort_fn as jax_shard_cohort_fn
from ventjax.ops.ci_pairwise import (
    build_ci_pairwise_geometry as jax_pairwise_geometry,
)
from ventjax.pipeline import analyze_cohort as jax_analyze_cohort
from ventjax.pipeline.analyze import build_geometry as jax_build_geometry
from ventjax_torch import dist
from ventjax_torch.compat import ci_module
from ventjax_torch.config import DEFAULT_CONFIG
from ventjax_torch.dist import halo, mesh
from ventjax_torch.io.phantom import make_cohort
from ventjax_torch.io.synthetic import write_study
from ventjax_torch.ops.ci import build_ci_geometry
from ventjax_torch.ops.ci_pairwise import (
    build_ci_pairwise_geometry, calculate_ci_pairwise,
)
from ventjax_torch.pipeline import analyze_cohort, build_geometry
from ventjax_torch.pipeline import cohort as tc

torch.set_num_threads(2)
VOX = (1.5, 1.5, 10.0)
CPU = torch.device("cpu")


@pytest.fixture
def cpu_mesh(monkeypatch):
    """Eight shards on the CPU: the port's local device list replaced."""
    monkeypatch.setattr(mesh, "local_devices",
                        lambda device="cuda": [CPU] * 8)


def _both(defect, rmax, **kw):
    """(port sharded, ventjax sharded), each as numpy (map, nsat, ovf)."""
    shape = defect.shape
    ci, nsat, ovf = halo.calculate_ci_sharded(
        torch.from_numpy(defect), build_ci_pairwise_geometry(
            VOX, shape, rmax, "wrap"), **kw)
    jci_, jnsat, jovf = jhalo.calculate_ci_sharded(
        jnp.asarray(defect), jax_pairwise_geometry(VOX, shape, rmax, "wrap"),
        **kw)
    return ((ci.numpy(), int(nsat), bool(ovf)),
            (np.asarray(jci_), int(jnsat), bool(jovf)))


def _unsharded(defect, rmax, K, **kw):
    geom = build_ci_pairwise_geometry(VOX, defect.shape, rmax, "wrap")
    ci, nsat, ovf = calculate_ci_pairwise(torch.from_numpy(defect)[None],
                                          geom, K, **kw)
    return ci[0].numpy(), int(nsat[0]), bool(ovf[0])


@pytest.mark.parametrize("vox,rmax", [((1.5, 1.5, 10.0), 16),
                                      ((1.5, 1.5, 10.0), 50),
                                      ((2.0, 2.0, 2.0), 12),
                                      ((1.0, 1.25, 3.5), 20)])
def test_halo_width_matches_ventjax(vox, rmax):
    shape = (32, 32, 16)
    assert halo.halo_width(build_ci_pairwise_geometry(vox, shape, rmax,
                                                      "wrap")) == \
        jhalo.halo_width(jax_pairwise_geometry(vox, shape, rmax, "wrap"))


@pytest.mark.parametrize("depth,n", [(28, 8), (32, 4), (1, 3), (64, 5),
                                     (17, 1)])
def test_padded_depth_for_matches_ventjax(depth, n):
    assert halo.padded_depth_for(depth, n) == jhalo.padded_depth_for(depth,
                                                                     n)


def _straddling_volume():
    """32x32x32: sparse singles, a dense cluster across the z = 16 cut (and
    the z = 8, 24 cuts of four shards), the two corners."""
    rng = np.random.default_rng(7)
    d = (rng.random((32, 32, 32)) > 0.99).astype(np.float32)
    d[8:16, 8:16, 13:19] = 1
    d[20:26, 4:10, 6:11] = 1
    d[0, 0, 0] = d[-1, -1, -1] = 1
    return d


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_ci_matches_ventjax_and_unsharded(cpu_mesh, n_shards):
    defect = _straddling_volume()
    port, ref = _both(defect, 16, n_shards=n_shards, max_defect_voxels=1024,
                      tail_k=1024)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:] == ref[1:] and not port[2]
    ci_u, nsat_u, ovf_u = _unsharded(defect, 16, 1024, tail_k=1024)
    assert not ovf_u
    np.testing.assert_array_equal(port[0], ci_u)
    assert port[1] == nsat_u
    assert port[0][defect > 0].min() > 0   # every defect voxel resolved


def test_sharded_ci_pads_nondivisible_depth(cpu_mesh):
    """D = 28 over 8 shards: padded to 32 slices, bit-identical."""
    rng = np.random.default_rng(1234)
    H, W, D = 40, 36, 28
    defect = (rng.random((H, W, D)) > 0.985).astype(np.float32)
    defect[0:3, 0:3, 25:28] = 1
    defect[0, 0, 0] = 1
    port, ref = _both(defect, 16, n_shards=8, max_defect_voxels=512)
    assert port[0].shape == (H, W, D)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1:] == ref[1:] and not port[2]
    ci_u, nsat_u, _ = _unsharded(defect, 16, 1024)
    np.testing.assert_array_equal(port[0], ci_u)
    assert port[1] == nsat_u


def test_one_shard_is_the_unsharded_engine(cpu_mesh):
    defect = _straddling_volume()
    port, _ = _both(defect, 16, n_shards=1, max_defect_voxels=1024)
    ci_u, nsat_u, ovf_u = _unsharded(defect, 16, 1024)
    np.testing.assert_array_equal(port[0], ci_u)
    assert port[1:] == (nsat_u, ovf_u)


def _jax_mesh(n):
    from jax.sharding import Mesh as JMesh

    import jax

    return JMesh(np.asarray(jax.devices()[:n]), ("space",))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["ladder", "too_many_devices", "halo_wide",
                                  "too_thin", "shape", "padded_depth_small",
                                  "padded_depth_divides"])
def test_rejections_carry_ventjax_messages(cpu_mesh, case):
    """Each refusal raises ventjax's ValueError, word for word (the module
    path named in the padding hint is the port's)."""
    shape = (32, 32, 8)
    port_geom = build_ci_pairwise_geometry(VOX, shape, 16, "wrap")
    jax_geom = jax_pairwise_geometry(VOX, shape, 16, "wrap")
    zeros_t, zeros_j = torch.zeros(shape), jnp.zeros(shape)
    if case == "ladder":
        from ventjax.ops.ci import build_ci_geometry as jax_ladder

        port = lambda: halo.calculate_ci_sharded(
            zeros_t, build_ci_geometry(VOX, shape, 12, "wrap"), n_shards=2)
        ref = lambda: jhalo.calculate_ci_sharded(
            zeros_j, jax_ladder(VOX, shape, 12, "wrap"), n_shards=2)
    elif case == "too_many_devices":
        port = lambda: halo.calculate_ci_sharded(zeros_t, port_geom,
                                                 n_shards=9)
        ref = lambda: jhalo.calculate_ci_sharded(zeros_j, jax_geom,
                                                 n_shards=9)
    elif case in ("halo_wide", "too_thin"):
        # rmax 50 at vox (1.5, 1.5, 10): an 8-slice halo; 4 shards of 16
        # slices leave 4-slice shards (at most 2 fit), 8 of 8 one slice
        deep = (32, 32, 16) if case == "halo_wide" else shape
        n = 4 if case == "halo_wide" else 8
        port = lambda: halo.calculate_ci_sharded(
            torch.zeros(deep), build_ci_pairwise_geometry(VOX, deep, 50,
                                                          "wrap"),
            n_shards=n)
        ref = lambda: jhalo.calculate_ci_sharded(
            jnp.zeros(deep), jax_pairwise_geometry(VOX, deep, 50, "wrap"),
            n_shards=n)
    elif case == "shape":
        port = lambda: halo.calculate_ci_sharded(torch.zeros((32, 32, 4)),
                                                 port_geom, n_shards=2)
        ref = lambda: jhalo.calculate_ci_sharded(jnp.zeros((32, 32, 4)),
                                                 jax_geom, n_shards=2)
    else:
        pd = 4 if case == "padded_depth_small" else 10
        port = lambda: halo.make_sliced_ci_fn(
            port_geom, dist.make_batch_mesh(4), padded_depth=pd)
        ref = lambda: jhalo.make_sliced_ci_fn(jax_geom, _jax_mesh(4),
                                              padded_depth=pd)
    want = _message(ref).replace("ventjax.dist", "ventjax_torch.dist")
    assert _message(port) == want
    if case == "too_thin":
        assert "too thin" in want
    if case == "halo_wide":
        assert "at most 2 shards" in want


def _dense_ball():
    H, W, D = 48, 48, 16
    ii, jj, kk = np.mgrid[:H, :W, :D]
    d = np.zeros((H, W, D), np.float32)
    d[((ii - 24) ** 2 + (jj - 24) ** 2 + ((kk - 8) * 6.7) ** 2) < 150] = 1
    return d


def test_tail_overflow_flags_not_silent(cpu_mesh):
    """A tail budget too small for a dense cluster flags (as ventjax's);
    an adequate one restores the unsharded map's bits."""
    defect = _dense_ball()
    assert 512 < defect.sum() < 2048
    port, ref = _both(defect, 16, n_shards=2, max_defect_voxels=2048,
                      tail_k=8)
    assert port[2] and ref[2]
    port, ref = _both(defect, 16, n_shards=2, max_defect_voxels=2048,
                      tail_k=2048)
    assert not port[2] and not ref[2]
    np.testing.assert_array_equal(port[0], ref[0])
    ci_u, _, ovf_u = _unsharded(defect, 16, 2048, tail_k=2048)
    assert not ovf_u
    np.testing.assert_array_equal(port[0], ci_u)


def test_halo_message_overflow_flags(cpu_mesh):
    """Boundary defects beyond the halo message flag; an adequate message
    restores bit-equality."""
    defect = np.zeros((40, 36, 16), np.float32)
    defect[4:20, 4:20, 7:9] = 1   # 512 voxels across the 2-shard cut
    port, ref = _both(defect, 16, n_shards=2, max_defect_voxels=1024,
                      halo_pad=16)
    assert port[2] and ref[2]
    port, ref = _both(defect, 16, n_shards=2, max_defect_voxels=1024,
                      halo_pad=512, tail_k=1024)
    assert not port[2] and not ref[2]
    ci_u, _, _ = _unsharded(defect, 16, 1024, tail_k=1024)
    np.testing.assert_array_equal(port[0], ci_u)
    np.testing.assert_array_equal(port[0], ref[0])


def test_edge_face_clusters_do_not_flag(cpu_mesh):
    """Messages no shard receives (shard 0's bottom, the last shard's top)
    never flag, however full."""
    defect = np.zeros((40, 36, 16), np.float32)
    defect[4:24, 4:24, 0:2] = 1
    defect[10:26, 10:26, 14:16] = 1
    port, ref = _both(defect, 16, n_shards=2, max_defect_voxels=2048,
                      halo_pad=64, tail_k=2048)
    assert not port[2] and not ref[2]
    ci_u, _, _ = _unsharded(defect, 16, 2048, tail_k=2048)
    np.testing.assert_array_equal(port[0], ci_u)
    np.testing.assert_array_equal(port[0], ref[0])


@pytest.mark.parametrize("case", ["clusters", "halo_retry"])
def test_ci_module_shard_slices(cpu_mesh, monkeypatch, case):
    """compat calculate_CI with ci_shard_slices 2: ventjax's map and the
    one-device map; a band hugging the cut overflows the default halo
    message and is retried once at full width."""
    defect = np.zeros((40, 36, 16), np.float64)
    if case == "clusters":
        defect[5:12, 6:13, 2:5] = 1
        defect[20:28, 18:28, 9:13] = 1
        defect[0, 0, 0] = 1
    else:
        defect[2:34, 2:22, 5:8] = 1   # 1920 voxels: pad 2048, message 1024
    calls = []
    real = halo.calculate_ci_sharded
    monkeypatch.setattr(halo, "calculate_ci_sharded", lambda *a, **kw: (
        calls.append(kw.get("halo_pad")) or real(*a, **kw)))
    cfg = DEFAULT_CONFIG.replace(ci_shard_slices=2)
    got = ci_module.calculate_CI(defect, vox=VOX, Rmax=16, config=cfg,
                                 device="cpu")
    assert calls == ([None] if case == "clusters" else [None, 2048])
    single = ci_module.calculate_CI(defect, vox=VOX, Rmax=16, device="cpu")
    want = jci.calculate_CI(defect, vox=VOX, Rmax=16,
                            config=JAX_DEFAULT_CONFIG.replace(
                                ci_shard_slices=2))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, want)


def test_ci_module_shard_slices_rejects_ladder_geometry(cpu_mesh):
    """vox (3.125, 3.125, 15) at rmax 20 fails the pairwise proof: the
    sharded branch says so, as ventjax's does."""
    defect = np.zeros((32, 32, 6))
    defect[4:8, 4:8, 2:4] = 1
    cfg = DEFAULT_CONFIG.replace(ci_shard_slices=2)
    with pytest.raises(ValueError, match="pairwise engine"):
        ci_module.calculate_CI(defect, vox=(3.125, 3.125, 15.0), Rmax=20,
                               config=cfg, device="cpu")


# ------------------------------------------------------------ batch mesh

COHORT_CFG = dict(ci_max_defect_voxels=256, ci_rmax=12, n4_fitting_levels=2,
                  n4_max_iters=5)
SHAPE = (32, 32, 8)


@pytest.fixture(scope="module")
def cohort16():
    hp, mask, _ = make_cohort(16, shape=SHAPE, vox=VOX, seed=0)
    cfg = DEFAULT_CONFIG.replace(**COHORT_CFG)
    geom = build_geometry(VOX, SHAPE, cfg)
    hp_t, mask_t = torch.from_numpy(hp), torch.from_numpy(mask)
    return hp, mask, hp_t, mask_t, cfg, geom, analyze_cohort(hp_t, mask_t,
                                                             geom, cfg)


@pytest.fixture(scope="module")
def jax_sharded16(cohort16):
    import jax

    hp, mask = cohort16[:2]
    cfg = JAX_DEFAULT_CONFIG.replace(**COHORT_CFG)
    geom = jax_build_geometry(VOX, SHAPE, cfg)
    fn = jax.jit(jax_shard_cohort_fn(
        lambda h, m: jax_analyze_cohort(h, m, geom, cfg),
        jax_batch_mesh(8)))
    return fn(jnp.asarray(hp), jnp.asarray(mask))


def _fields(res):
    out = {f: getattr(res, f) for f in ("n4", "defect", "defect_lb",
                                        "defect_km", "defect_border",
                                        "ci_map")}
    out.update({f"metrics.{k}": v for k, v in vars(res.metrics).items()})
    return out


@pytest.mark.parametrize("n", [4, 8])
def test_shard_cohort_fn_bit_identical(cohort16, jax_sharded16, n):
    hp, mask, hp_t, mask_t, cfg, geom, whole = cohort16
    m = dist.make_batch_mesh(devices=[CPU] * n)
    assert (m.size, m.devices) == (n, (CPU,) * n)
    res = dist.shard_cohort_fn(lambda h, k: analyze_cohort(h, k, geom, cfg),
                               m)(hp_t, mask_t)
    for name, x in _fields(res).items():
        want = _fields(whole)[name]
        assert x.shape == want.shape and x.dtype == want.dtype, name
        assert torch.equal(x, want) or bool(
            (x.isnan() & want.isnan() | (x == want)).all()), name
    ref = jax_sharded16
    for i in range(16):
        d = res.defect[i].numpy()
        np.testing.assert_array_equal(d, np.asarray(ref.defect[i]))
        for k in ("vdp", "vdp_lb", "vdp_km"):
            assert abs(float(getattr(res.metrics, k)[i])
                       - float(getattr(ref.metrics, k)[i])) <= 0.1
        assert np.abs(res.ci_map[i].numpy()
                      - np.asarray(ref.ci_map[i])).max() <= 2e-5


def test_shard_cohort_fn_rejects_an_uneven_batch(cohort16):
    _, _, hp_t, mask_t, cfg, geom, _ = cohort16
    fn = dist.shard_cohort_fn(lambda h, k: analyze_cohort(h, k, geom, cfg),
                              dist.make_batch_mesh(devices=[CPU] * 3))
    with pytest.raises(ValueError, match="multiple of 3"):
        fn(hp_t, mask_t)


def test_make_batch_mesh_defaults_to_local_devices(cpu_mesh):
    m = dist.make_batch_mesh()
    assert m.devices == (CPU,) * 8
    assert dist.make_batch_mesh(3).size == 3


def test_local_devices_honour_an_explicit_index(monkeypatch):
    """"cuda" lists every card; "cuda:1" names one (three cards faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert dist.local_devices("cuda") == cards
    assert dist.local_devices("cuda:1") == cards[1:2]
    assert dist.make_batch_mesh().devices == tuple(cards)


def test_local_devices_of_the_cpu_and_without_a_card():
    assert dist.local_devices("cpu") == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            dist.local_devices()


def test_initialize_multihost_single_process_is_a_noop():
    import torch.distributed as tdist

    assert dist.initialize_multihost() is None
    assert dist.initialize_multihost(num_processes=1) is None
    assert not tdist.is_initialized()
    with pytest.raises(ValueError, match="coordinator's host:port"):
        dist.initialize_multihost(num_processes=2, process_id=0)


@pytest.fixture(scope="module")
def cohort_studies(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cohort")
    manifest = []
    for i in range(6):
        sdir = root / f"study{i}"
        write_study(str(sdir), shape=SHAPE, vox=VOX, seed=60 + i,
                    with_proton=False)
        manifest.append({"id": f"s{i}", "xenon": f"{sdir}/xenon.dcm",
                         "mask": f"{sdir}/mask"})
    return root, manifest


def test_run_cohort_use_mesh_equals_one_device(cohort_studies, cpu_mesh,
                                               monkeypatch):
    """use_mesh over four CPU shards: batch_size 6 rounds up to 8, every
    batch splits over the mesh, and the exports equal the one-device run's,
    which is the default even where four devices are listed."""
    root, manifest = cohort_studies
    cfg = DEFAULT_CONFIG.replace(**COHORT_CFG)
    monkeypatch.setattr(mesh, "local_devices", lambda device: [CPU] * 4)
    seen = []
    real = mesh.shard_cohort_fn
    monkeypatch.setattr(mesh, "shard_cohort_fn", lambda f, m: (
        seen.append(m.size) or real(f, m)))
    runners = {}
    meshed = tc.run_cohort(manifest, str(root / "mesh"), config=cfg,
                           batch_size=6, runners=runners, device="cpu",
                           use_mesh=True)
    (runner,) = runners.values()
    assert runner.bs == 8 and runner.mesh.size == 4
    assert seen and set(seen) == {4}   # every dispatch, retries included
    n_meshed, plain_runners = len(seen), {}
    plain = tc.run_cohort(manifest, str(root / "plain"), config=cfg,
                          batch_size=6, device="cpu", runners=plain_runners)
    (runner,) = plain_runners.values()
    assert runner.mesh is None and runner.bs == 6 and len(seen) == n_meshed
    by_id = {r["id"]: r for r in plain}
    for r in meshed:
        assert json.dumps(r, sort_keys=True) == json.dumps(by_id[r["id"]],
                                                           sort_keys=True)
        for f in (f"{r['id']}_dataArray.nii",):
            a = open(os.path.join(root, "mesh", r["id"], f), "rb").read()
            b = open(os.path.join(root, "plain", r["id"], f), "rb").read()
            assert a == b


def test_adaptive_pad_is_a_multiple_of_the_mesh():
    m = dist.make_batch_mesh(devices=[CPU] * 4)
    r = tc._GeometryRunner(SHAPE, VOX, DEFAULT_CONFIG, 16, adaptive_pad=True,
                           device="cpu", mesh=m)
    assert [r._eff_bs(n) for n in (1, 3, 4, 5, 9, 16)] == [4, 4, 4, 8, 16,
                                                           16]
    one = tc._GeometryRunner(SHAPE, VOX, DEFAULT_CONFIG, 16,
                             adaptive_pad=True, device="cpu")
    assert [one._eff_bs(n) for n in (1, 3, 5)] == [1, 4, 8]


def test_watch_service_passes_use_mesh(tmp_path, monkeypatch):
    from ventjax_torch.pipeline import serve

    got = []
    monkeypatch.setattr(serve, "run_cohort",
                        lambda *a, **kw: got.append(kw["use_mesh"]) or [])
    inbox = tmp_path / "in"
    inbox.mkdir()
    sdir = inbox / "s0"
    write_study(str(sdir), shape=SHAPE, vox=VOX, seed=3, with_proton=False)
    for flag in (True, False):
        svc = serve.WatchService(str(inbox), str(tmp_path / f"o{flag}"),
                                 min_age=0.0, device="cpu", use_mesh=flag)
        svc.scan_once()
    assert got == [True, False]
