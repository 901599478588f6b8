"""Deployment self-check (``python -m ventjax_torch doctor``).

The port's counterpart of ``ventjax/utils/doctor.py``: ``run_doctor``
executes a battery of isolated checks (one failure never masks the rest)
and returns one JSON-serializable report of the same shape; the CLI exits 0
iff every REQUIRED check passed.

The checks run on ``device``: the CUDA card unless the caller asks for the
CPU (``device="cpu"``).  Without a card the default reports ``backend`` and
``device_probe`` failed (and every check that needs the card with them); it
never carries on on the CPU.

Required: versions, backend, device_probe, kernel_build (on a CUDA device:
nvcc builds and loads the port's five CUDA libraries), codec_roundtrip,
pipeline_selftest.  Optional (reported, never fatal): native_scanner (the
Python codec is a complete fallback), seg_checkpoint (the shipped
``--auto-mask`` artifact: its path and presence; where present it loads and
predicts one 32x32x4 volume on the device).  The reference package's
compile_cache check has no counterpart: kernel_build takes its place.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

#: |device VDP - oracle VDP| budget for the self-test, in percentage
#: points.
VDP_TOLERANCE_PP = 0.1
#: The CUDA libraries of the port (ventjax_torch/csrc/<name>.cu).
LIBRARIES = ("n4_fit", "n4_sharpen", "ci_head", "ci_densify", "n4_field")
#: CI defect pad of the quick self-test (VDP only; its CI is not checked).
QUICK_CI_PAD = 512


def _check(name: str, required: bool, fn: Callable[[], Dict]) -> Dict:
    t0 = time.perf_counter()
    try:
        info = fn() or {}
        ok = bool(info.pop("__ok__", True))
    except Exception as e:  # isolation: a crash is a failed check, not a crash
        info = {"error": f"{type(e).__name__}: {e}"}
        ok = False
    return {"name": name, "ok": ok, "required": required,
            "ms": round((time.perf_counter() - t0) * 1e3, 1), **info}


def _dev(device):
    """The device asked for; a CUDA device without a card raises."""
    from ventjax_torch.utils.device import resolve_device

    return resolve_device(device)


def _versions() -> Dict:
    import numpy as np
    import torch

    import ventjax_torch

    return {"ventjax_torch": ventjax_torch.__version__,
            "torch": torch.__version__, "numpy": np.__version__}


def _backend(device) -> Dict:
    import torch

    dev = _dev(device)
    out = {"backend": dev.type, "device": str(dev),
           "cuda": torch.version.cuda}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
        out["device_count"] = torch.cuda.device_count()
    return out


def _device_probe(device) -> Dict:
    """A trivial computation must round-trip the device."""
    import torch

    got = int(torch.arange(8, device=_dev(device)).sum())
    return {"__ok__": got == 28, "result": got}


def _kernel_build() -> Dict:
    """Build (or find built) and load the port's CUDA libraries, one nvcc
    per source, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    from ventjax_torch import _build

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = list(pool.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.load(name)
    return {"libraries": {n: os.path.basename(str(p))
                          for n, p in zip(LIBRARIES, paths)},
            "build_s": {n: round(_build.BUILD_SECONDS.get(n, 0.0), 1)
                        for n in LIBRARIES}}


def _native_scanner() -> Dict:
    from ventjax_torch.io import native

    return {"available": native.available()}


def _seg_checkpoint(device) -> Dict:
    """The shipped segmentation checkpoint's path and presence (absent is
    no failure, as in the reference); where present it must load and
    predict a binary mask of a small volume on the device."""
    import numpy as np

    from ventjax_torch.models.segmentation import (
        default_checkpoint_path, load_checkpoint, predict_mask,
    )

    path = default_checkpoint_path()
    if not os.path.exists(path):
        return {"path": path, "present": False}
    state = load_checkpoint(path, device=_dev(device))
    proton = np.random.default_rng(0).normal(
        500.0, 50.0, (32, 32, 4)).astype(np.float32)
    mask = predict_mask(state.model, proton)
    binary = bool(((mask == 0) | (mask == 1)).all())
    return {"__ok__": tuple(mask.shape) == proton.shape and binary,
            "path": path, "present": True, "step": state.step,
            "base": state.model.base, "device": str(mask.device)}


def _codec_roundtrip(tmp_dir: str) -> Dict:
    """DICOM write -> read bit-equality through the port's Python codec."""
    import numpy as np

    from ventjax_torch.io import synthetic
    from ventjax_torch.io.dicom import open_single_dicom

    rng = np.random.default_rng(0)
    want = rng.integers(0, 4096, (16, 16, 8)).astype(np.float64)  # [H,W,D]
    path = os.path.join(tmp_dir, "doctor.dcm")
    synthetic.write_multiframe(path, want, vox=(1.5, 1.5, 10.0))
    _, vol = open_single_dicom(path)
    return {"__ok__": vol.shape == want.shape and (vol == want).all(),
            "shape": list(vol.shape)}


def _pipeline_selftest(full: bool, device) -> Dict:
    """The port's analyze_study on the device vs the CPU oracle on a
    phantom: |dVDP| < 0.1 pp.  ``full`` uses the flagship 128x128x16
    geometry and the default CI pad, and reports CI; the quick form is
    32x32x8 with a small CI pad."""
    import numpy as np
    import torch

    from ventjax_torch.config import DEFAULT_CONFIG
    from ventjax_torch.io.phantom import make_phantom
    from ventjax_torch.oracle import reference as oracle
    from ventjax_torch.oracle.n4_oracle import n4_bias_correction_oracle
    from ventjax_torch.pipeline import analyze_study, build_geometry
    from ventjax_torch.utils.profiling import sync

    dev = _dev(device)
    shape = (128, 128, 16) if full else (32, 32, 8)
    vox = (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG if full else DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=QUICK_CI_PAD)
    ph = make_phantom(shape=shape, vox=vox, seed=7)
    hp = torch.from_numpy(np.asarray(ph.hp, np.float32)).to(dev)
    mask = torch.from_numpy(np.asarray(ph.mask, np.float32)).to(dev)
    t0 = time.perf_counter()
    res = analyze_study(hp, mask, build_geometry(vox, shape, cfg), cfg)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    vdp = float(res.metrics.vdp)
    n4_o = n4_bias_correction_oracle(ph.hp, ph.mask)
    _, vdp_o = oracle.vdp_mean_anchored(n4_o, ph.mask)
    dvdp = abs(vdp - float(vdp_o))
    out = {"__ok__": dvdp < VDP_TOLERANCE_PP, "device": str(dev),
           "shape": list(shape), "vdp": vdp, "vdp_oracle": float(vdp_o),
           "dvdp_pp": dvdp, "analysis_ms": round(ms, 1)}
    if full:
        out["ci"] = float(res.metrics.ci)
        out["ci_overflow"] = bool(res.metrics.ci_overflow)
    return out


def run_doctor(full: bool = False, tmp_dir: Optional[str] = None,
               device="cuda") -> Dict:
    """Run every check on ``device``; returns {"ok", "full", "checks":
    [...]} (JSON-ready).

    ``ok`` covers only required checks — a missing native scanner degrades
    decoding speed but does not fail the install.
    """
    import torch

    own_tmp = tmp_dir is None
    if own_tmp:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="ventjax_torch_doctor_")
        tmp_dir = tmp_ctx.name
    on_card = torch.device(device).type == "cuda"
    try:
        checks: List[Dict] = [
            _check("versions", True, _versions),
            _check("backend", True, lambda: _backend(device)),
            _check("device_probe", True, lambda: _device_probe(device)),
            _check("kernel_build", on_card, _kernel_build),
            _check("native_scanner", False, _native_scanner),
            _check("seg_checkpoint", False, lambda: _seg_checkpoint(device)),
            _check("codec_roundtrip", True,
                   lambda: _codec_roundtrip(tmp_dir)),
            _check("pipeline_selftest", True,
                   lambda: _pipeline_selftest(full, device)),
        ]
    finally:
        if own_tmp:
            tmp_ctx.cleanup()
    ok = all(c["ok"] for c in checks if c["required"])
    return {"ok": ok, "full": full, "checks": checks}


def format_report(report: Dict) -> str:
    return json.dumps(report, indent=2)
