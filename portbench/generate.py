"""The benchmark's one traffic generator: synthetic ventilation studies.

A batched copy of the phantom of ``ventjax_torch/io/phantom.py``
(``make_phantom``): two ellipsoid lobes as the lung mask, a smooth
ventilation signal, spherical defect clusters planted at random lung
voxels (signal times 0.08 inside them), a smooth multiplicative bias field
normalised to mean 1 over the lung, and a Rician-like floor
|N(0, noise_sigma * signal_level)| everywhere.  The lobes depend on the
shape alone, as in the original, so every study of a configuration has the
same lung mask.

It runs in torch on the device the benchmark measures, the whole pool in
a few large calls, from a ``torch.Generator`` seeded by ``--seed``: the same
seed on the same kind of device gives the same studies.  It copies the
original's formulas and parameters, not its random stream (numpy's).  A
traffic mix is a data file of this generator's parameters (see
``portbench/traffic/``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

#: Parameters a mix may set, with make_phantom's defaults.
DEFAULTS = {
    "n_defects": 3,
    "defect_radius_vox": (3.0, 5.0, 8.0),
    "bias_strength": 0.3,
    "noise_sigma": 0.02,
    "signal_level": 400.0,
}


def _grid(shape, device):
    H, W, D = shape
    return torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=device)
          for n in (H, W, D)), indexing="ij")


def _ellipsoid(r, c, s, center, radii):
    """0/1 ellipsoid over the grid; ``center`` and ``radii`` are triples of
    scalars or of [n] tensors (one ellipsoid per study)."""
    def term(x, x0, rad):
        if isinstance(x0, torch.Tensor):
            x0 = x0[:, None, None, None]
        return ((x - x0) / rad) ** 2
    d = (term(r, center[0], radii[0]) + term(c, center[1], radii[1])
         + term(s, center[2], radii[2]))
    return (d <= 1.0).to(torch.float32)


def lung_mask(shape: Tuple[int, int, int], device) -> torch.Tensor:
    """[H, W, D] 0/1 two-lobe lung mask of make_phantom."""
    H, W, D = shape
    r, c, s = _grid(shape, device)
    left = _ellipsoid(r, c, s, (H * 0.52, W * 0.32, D * 0.5),
                      (H * 0.30, W * 0.17, D * 0.42))
    right = _ellipsoid(r, c, s, (H * 0.52, W * 0.68, D * 0.5),
                       (H * 0.30, W * 0.17, D * 0.42))
    return torch.clamp(left + right, 0, 1)


def make_studies(
    n: int,
    shape: Tuple[int, int, int],
    vox: Sequence[float],
    seed: int,
    device,
    n_defects: int = DEFAULTS["n_defects"],
    defect_radius_vox: Sequence[float] = DEFAULTS["defect_radius_vox"],
    bias_strength: float = DEFAULTS["bias_strength"],
    noise_sigma: float = DEFAULTS["noise_sigma"],
    signal_level: float = DEFAULTS["signal_level"],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hp [n,H,W,D] float32, mask [n,H,W,D] float32) on ``device``."""
    H, W, D = shape
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    r, c, s = _grid(shape, dev)
    mask = lung_mask(shape, dev)
    lung = torch.nonzero(mask.reshape(-1)).reshape(-1)

    vent = 1.0 + 0.15 * torch.sin(2 * math.pi * r / H) * torch.cos(
        2 * math.pi * c / W)
    picks = torch.randint(0, lung.numel(), (n, n_defects), generator=gen,
                          device=dev)
    flat = lung[picks]                                   # [n, n_defects]
    ci, cj, ck = flat // (W * D), (flat // D) % W, flat % D
    defect = torch.zeros((n, H, W, D), dtype=torch.float32, device=dev)
    for i in range(n_defects):
        rad = float(defect_radius_vox[i % len(defect_radius_vox)])
        radz = max(rad * float(vox[0]) / float(vox[2]), 0.8)
        ball = _ellipsoid(r, c, s, (ci[:, i].float(), cj[:, i].float(),
                                    ck[:, i].float()), (rad, rad, radz))
        defect = torch.maximum(defect, ball * mask)
    vent = vent * (1.0 - 0.92 * defect)

    rr, cc, ss = (r - H / 2) / H, (c - W / 2) / W, (s - D / 2) / D
    bias = torch.exp(bias_strength * (0.8 * rr + 0.6 * cc - 0.5 * ss
                                      + 0.7 * rr * cc))
    bias = bias / bias[mask > 0].mean()

    noise = torch.randn((n, H, W, D), generator=gen, device=dev) * (
        noise_sigma * signal_level)
    hp = torch.clamp(signal_level * vent * bias * mask + noise.abs(), min=0)
    return hp.contiguous(), mask.expand(n, H, W, D).contiguous()
