"""Out-of-family lung phantoms for honest auto-mask evaluation.

The port's copy of the reference package's out-of-family generator (bit
for bit the same arrays, ``tests/test_torch_segmentation.py``).

The shipped segmentation checkpoint trains and validates on draws of
``ventjax_torch.io.phantom.make_random_phantom``.  Measuring Dice on more draws
of the *same* generator says nothing about out-of-family behavior — the
exact failure mode that matters for real anatomy.  This module is a SECOND,
independently coded phantom family sharing no helpers (and deliberately
different modeling choices) with the training generator:

- lobes are per-slice superellipses (|x/a|^p + |y/b|^p <= 1 with random
  exponent p in [1.6, 3.5]) whose centers/radii drift smoothly with depth
  along a curved medial axis — "bean" cross-sections rather than global
  3-D ellipsoids;
- a mediastinum notch is carved between the lobes (cardiac indentation on
  the left lung — an anatomical feature the training family lacks);
- proton texture: random-phase Fourier fields (band-limited "cloudy"
  texture) + a bright chest-wall ring + multiplicative vignette, instead
  of box-smoothed white noise on a constant background;
- intensity conventions differ: background brighter than lung by a random
  factor, global intensity scale drawn log-uniform over a decade.

Used by chip_smoke.py (path h) to report the checkpoint's out-of-family
Dice on the card beside its in-family Dice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _fourier_field(rng: np.random.Generator, shape, kmax: int = 4,
                   amplitude: float = 1.0) -> np.ndarray:
    """Smooth random field from a few random-phase low-frequency modes."""
    H, W, D = shape
    r = np.arange(H)[:, None, None] / H
    c = np.arange(W)[None, :, None] / W
    s = np.arange(D)[None, None, :] / max(D, 1)
    field = np.zeros(shape, np.float64)
    for _ in range(6):
        kr, kc, ks = rng.integers(0, kmax + 1, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        a = rng.normal(0, 1.0) / (1.0 + kr + kc + ks)
        field += a * (np.cos(2 * np.pi * kr * r + ph[0])
                      * np.cos(2 * np.pi * kc * c + ph[1])
                      * np.cos(2 * np.pi * ks * s + ph[2]))
    m = np.abs(field).max()
    return (amplitude * field / m if m > 0 else field).astype(np.float32)


def _superellipse_slice(H, W, center, radii, p, rot) -> np.ndarray:
    """One 2-D superellipse cross-section (|u/a|^p + |v/b|^p <= 1)."""
    r = np.arange(H)[:, None] - center[0]
    c = np.arange(W)[None, :] - center[1]
    cs, sn = np.cos(rot), np.sin(rot)
    u = cs * r - sn * c
    v = sn * r + cs * c
    with np.errstate(divide="ignore", invalid="ignore"):
        d = (np.abs(u / radii[0]) ** p + np.abs(v / radii[1]) ** p)
    return d <= 1.0


def make_oof_phantom(
    seed: int,
    shape: Tuple[int, int, int] = (128, 128, 16),
    vox: Optional[Tuple[float, float, float]] = None,
):
    """Returns (proton, mask, vox) for one out-of-family subject."""
    rng = np.random.default_rng(0xF00D ^ (seed * 2654435761 % 2**31))
    H, W, D = shape
    if vox is None:
        vox = (float(rng.uniform(1.2, 3.2)), float(rng.uniform(1.2, 3.2)),
               float(rng.uniform(6.0, 15.0)))

    p = float(rng.uniform(1.6, 3.5))
    rot0 = float(rng.uniform(-0.25, 0.25))
    # Curved medial axes: per-lobe center/radius profiles drifting with
    # depth (quadratic in slice index, random curvature).
    z = np.linspace(-1.0, 1.0, D)
    mask = np.zeros(shape, bool)
    gap = rng.uniform(0.015, 0.06) * W
    for side in (-1.0, 1.0):
        cx = H * rng.uniform(0.48, 0.56) + H * 0.04 * rng.normal() * z ** 2
        cy = (W * 0.5 + side * (W * rng.uniform(0.14, 0.20) + gap)
              + W * 0.03 * rng.normal() * z)
        ar = H * rng.uniform(0.24, 0.34) * (1.0 - rng.uniform(0.1, 0.35)
                                            * z ** 2)
        br = W * rng.uniform(0.12, 0.18) * (1.0 - rng.uniform(0.1, 0.35)
                                            * z ** 2)
        for k in range(D):
            if ar[k] < 2 or br[k] < 2:
                continue
            mask[:, :, k] |= _superellipse_slice(
                H, W, (cx[k], cy[k]), (ar[k], br[k]), p,
                rot0 * side)
    # Cardiac notch: carve a blob out of the left lung's medial-inferior
    # region (a feature the training family does not model).
    notch_c = (H * rng.uniform(0.55, 0.7), W * rng.uniform(0.42, 0.5))
    notch_r = (H * rng.uniform(0.08, 0.14), W * rng.uniform(0.05, 0.1))
    for k in range(D // 2, D):
        mask[:, :, k] &= ~_superellipse_slice(
            H, W, notch_c, notch_r, 2.0, 0.0)

    # Proton appearance: background BRIGHTER than lung, cloudy texture,
    # chest-wall ring, vignette, global scale over a decade.
    scale = float(10 ** rng.uniform(2.0, 3.0))
    lung_level = rng.uniform(0.15, 0.45)
    body = np.zeros(shape, bool)
    for k in range(D):
        body[:, :, k] = _superellipse_slice(
            H, W, (H * 0.52, W * 0.5), (H * 0.44, W * 0.46), 2.5, 0.0)
    texture = 1.0 + _fourier_field(rng, shape, kmax=5,
                                   amplitude=rng.uniform(0.1, 0.35))
    vignette = 1.0 - rng.uniform(0.1, 0.4) * (
        ((np.arange(H)[:, None, None] - H / 2) / (H / 2)) ** 2
        + ((np.arange(W)[None, :, None] - W / 2) / (W / 2)) ** 2) / 2.0
    proton = np.where(mask, lung_level, 1.0) * body
    ring = body & ~np.roll(body, 3, axis=0) | body & ~np.roll(body, -3, axis=1)
    proton = proton + rng.uniform(0.3, 0.9) * ring
    proton = scale * proton * texture * vignette
    proton = proton + np.abs(
        rng.normal(0, rng.uniform(0.01, 0.06) * scale, shape))
    return (proton.astype(np.float32), mask.astype(np.float32),
            tuple(float(v) for v in vox))
