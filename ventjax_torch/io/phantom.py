"""Synthetic ventilation phantoms for tests and benchmarks.

The port's copy of the reference package's ``make_phantom`` and
``make_cohort``: ellipsoid lung masks, a smooth ventilation signal with a
planted multiplicative bias field, and planted spherical defect clusters.
Host-side NumPy, deterministic per seed, and bit for bit the reference
package's arrays (``tests/test_torch_standalone.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Phantom:
    """A synthetic study: arrays are [H, W, D] float/int, vox is [row,col,slice] mm."""

    hp: np.ndarray          # ventilation image (with bias + noise), float32
    mask: np.ndarray        # binary lung mask, float32 (0/1)
    proton: np.ndarray      # anatomical image, float32
    vox: Tuple[float, float, float]
    true_bias: np.ndarray   # planted multiplicative bias field
    true_defect: np.ndarray # planted defect mask (inside lung), float32 (0/1)


def _ellipsoid(shape, center, radii) -> np.ndarray:
    H, W, D = shape
    r, c, s = np.ogrid[:H, :W, :D]
    dist = (
        ((r - center[0]) / radii[0]) ** 2
        + ((c - center[1]) / radii[1]) ** 2
        + ((s - center[2]) / radii[2]) ** 2
    )
    return (dist <= 1.0).astype(np.float32)


def make_phantom(
    shape: Tuple[int, int, int] = (128, 128, 16),
    vox: Tuple[float, float, float] = (1.5, 1.5, 10.0),
    seed: int = 0,
    n_defects: int = 3,
    defect_radius_vox: Sequence[float] = (3.0, 5.0, 8.0),
    bias_strength: float = 0.3,
    noise_sigma: float = 0.02,
    signal_level: float = 400.0,
) -> Phantom:
    """Build a two-lobe lung phantom with planted defects and bias field."""
    rng = np.random.default_rng(seed)
    H, W, D = shape

    # Two ellipsoid "lobes" with a gap between them (left/right lung).
    left = _ellipsoid(shape, (H * 0.52, W * 0.32, D * 0.5), (H * 0.30, W * 0.17, D * 0.42))
    right = _ellipsoid(shape, (H * 0.52, W * 0.68, D * 0.5), (H * 0.30, W * 0.17, D * 0.42))
    mask = np.clip(left + right, 0, 1).astype(np.float32)

    # Smooth ventilation signal: base level with gentle spatial variation.
    r, c, s = np.meshgrid(np.arange(H), np.arange(W), np.arange(D), indexing="ij")
    vent = 1.0 + 0.15 * np.sin(2 * np.pi * r / H) * np.cos(2 * np.pi * c / W)

    # Planted spherical defect clusters inside the lung.
    true_defect = np.zeros(shape, np.float32)
    lung_idx = np.argwhere(mask > 0)
    for i in range(n_defects):
        center = lung_idx[rng.integers(len(lung_idx))]
        rad = defect_radius_vox[i % len(defect_radius_vox)]
        ball = _ellipsoid(shape, center, (rad, rad, max(rad * vox[0] / vox[2], 0.8)))
        true_defect = np.maximum(true_defect, ball * mask)
    vent = vent * (1.0 - 0.92 * true_defect)

    # Smooth multiplicative bias field (low-order polynomial in space).
    rr = (r - H / 2) / H
    cc = (c - W / 2) / W
    ss = (s - D / 2) / D
    bias = np.exp(bias_strength * (0.8 * rr + 0.6 * cc - 0.5 * ss + 0.7 * rr * cc))
    bias = (bias / bias[mask > 0].mean()).astype(np.float32)

    hp = signal_level * vent * bias * mask
    # Background (outside mask): Rician-ish noise floor.
    noise = rng.normal(0, noise_sigma * signal_level, shape)
    hp = hp + np.abs(noise)
    hp = np.clip(hp, 0, None).astype(np.float32)

    proton = (signal_level * 1.5 * (1.0 - 0.65 * mask)
              + rng.normal(0, noise_sigma * signal_level, shape)).astype(np.float32)
    proton = np.clip(proton, 0, None)

    return Phantom(
        hp=hp,
        mask=mask,
        proton=proton,
        vox=tuple(float(v) for v in vox),
        true_bias=bias,
        true_defect=(true_defect * mask).astype(np.float32),
    )


def make_cohort(
    n: int,
    shape: Tuple[int, int, int] = (128, 128, 16),
    vox: Tuple[float, float, float] = (1.5, 1.5, 10.0),
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack n phantoms into batched [N,H,W,D] hp/mask/proton arrays."""
    hps, masks, protons = [], [], []
    for i in range(n):
        ph = make_phantom(shape=shape, vox=vox, seed=seed + i)
        hps.append(ph.hp)
        masks.append(ph.mask)
        protons.append(ph.proton)
    return np.stack(hps), np.stack(masks), np.stack(protons)
