"""Synthetic ventilation phantoms for tests and benchmarks.

The port's copy of the reference package's ``make_phantom`` and
``make_cohort``: ellipsoid lung masks, a smooth ventilation signal with a
planted multiplicative bias field, and planted spherical defect clusters;
and of its domain-randomized ``make_random_phantom`` and
``make_random_cohort``, which train and validate the segmentation model.
Host-side NumPy, deterministic per seed, and bit for bit the reference
package's arrays (``tests/test_torch_standalone.py``,
``tests/test_torch_segmentation.py``).
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


def _smooth3(field: np.ndarray, iters: int = 2) -> np.ndarray:
    """Cheap separable box smoothing with wrap-around (numpy only)."""
    f = field.astype(np.float32)
    for _ in range(iters):
        for ax in range(3):
            f = (np.roll(f, 1, ax) + f + np.roll(f, -1, ax)) / 3.0
    return f


def _ellipsoid_field(shape, center, radii, rot=None) -> np.ndarray:
    """Continuous ellipsoid distance field (<=1 inside), optional in-plane
    rotation — the soft version of _ellipsoid for partial-volume edges."""
    H, W, D = shape
    r, c, s = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                          indexing="ij")
    dr, dc, ds_ = r - center[0], c - center[1], s - center[2]
    if rot:
        cs, sn = np.cos(rot), np.sin(rot)
        dr, dc = cs * dr - sn * dc, sn * dr + cs * dc
    return ((dr / radii[0]) ** 2 + (dc / radii[1]) ** 2
            + (ds_ / radii[2]) ** 2).astype(np.float32)


def make_random_phantom(seed: int, shape=None) -> Phantom:
    """Domain-randomized phantom for segmentation training/validation:
    randomizes what a real proton scan varies —

    - lung geometry: lobe centers/radii/rotation, occasional single lobe,
      slice count (when shape is None), anisotropic voxels;
    - proton appearance: random lung/background contrast (lungs darker
      by a random factor, sometimes barely), smooth anatomical intensity
      gradients, bright chest-wall-like band, dark airway-like tube;
    - partial-volume edges: the mask edge in the proton image is a smooth
      sigmoid of the ellipsoid field, not a hard 0/1 step;
    - corruption: random Gaussian noise level, random multiplicative bias
      on BOTH hp and proton, random global intensity scale.

    The binary mask stays the hard-thresholded geometry, so Dice targets
    are well-defined.  H and W stay multiples of 4 (the U-Net pools twice).
    """
    rng = np.random.default_rng(seed)
    if shape is None:
        H = W = int(rng.choice([96, 112, 128]))
        D = int(rng.integers(6, 21))
        shape = (H, W, D)
    else:
        H, W, D = shape
    vox = (float(rng.uniform(1.2, 3.2)), float(rng.uniform(1.2, 3.2)),
           float(rng.uniform(5.0, 15.0)))

    # -- geometry -----------------------------------------------------------
    two_lobes = rng.random() > 0.15
    rot = float(rng.uniform(-0.25, 0.25))
    gap = rng.uniform(0.28, 0.42)
    fields = []
    for side in ([-1.0, +1.0] if two_lobes else [0.0]):
        center = (H * rng.uniform(0.42, 0.58),
                  W * (0.5 + side * gap * 0.5) + W * rng.uniform(-0.03, 0.03),
                  D * rng.uniform(0.42, 0.58))
        radii = (H * rng.uniform(0.22, 0.36),
                 W * rng.uniform(0.13, 0.22) * (1.6 if not two_lobes else 1.0),
                 D * rng.uniform(0.36, 0.5))
        fields.append(_ellipsoid_field(shape, center, radii, rot=rot))
    soft = np.min(np.stack(fields), axis=0)  # <=1 inside a lobe
    mask = (soft <= 1.0).astype(np.float32)
    # partial-volume edge profile for the images (NOT the label)
    edge_width = rng.uniform(0.05, 0.25)
    pv = 1.0 / (1.0 + np.exp(np.clip((soft - 1.0) / edge_width, -60, 60)))

    # -- ventilation image (hp) --------------------------------------------
    signal = float(rng.uniform(200, 800))
    r, c, s = np.meshgrid(np.arange(H), np.arange(W), np.arange(D),
                          indexing="ij")
    vent = 1.0 + rng.uniform(0.05, 0.25) * np.sin(
        2 * np.pi * r / H * rng.uniform(0.5, 2)) * np.cos(
        2 * np.pi * c / W * rng.uniform(0.5, 2))
    rr, cc, ss = (r - H / 2) / H, (c - W / 2) / W, (s - D / 2) / D
    amp = rng.uniform(0.1, 0.5)
    coef = rng.normal(0, 1, 5)
    bias = np.exp(amp * (coef[0] * rr + coef[1] * cc + coef[2] * ss
                         + coef[3] * rr * cc + coef[4] * rr * rr))
    m = mask > 0
    if m.any():
        bias = bias / bias[m].mean()
    noise_sigma = rng.uniform(0.005, 0.06) * signal
    hp = signal * vent * bias.astype(np.float32) * mask
    hp = np.clip(hp + np.abs(rng.normal(0, noise_sigma, shape)), 0, None)

    # -- proton (anatomical) image -----------------------------------------
    bg = float(rng.uniform(0.8, 1.6)) * signal
    lung_frac = float(rng.uniform(0.1, 0.55))  # lungs darker, variable
    proton = bg * (1.0 - (1.0 - lung_frac) * pv)
    # smooth anatomical gradient + a bright band (chest-wall-ish)
    proton = proton * np.exp(rng.uniform(0.0, 0.3)
                             * (rng.normal() * rr + rng.normal() * cc))
    band_r = H * rng.uniform(0.08, 0.18)
    wall = np.exp(-((r - H * rng.uniform(0.78, 0.92)) ** 2)
                  / (2 * band_r ** 2))
    proton = proton * (1.0 + rng.uniform(0.0, 0.6) * wall)
    if rng.random() > 0.5:  # dark airway-like tube down the midline
        tube = _ellipsoid_field(
            shape, (H * 0.45, W * 0.5, D * 0.5),
            (H * 0.1, W * rng.uniform(0.02, 0.05), D * 0.6))
        proton = proton * (1.0 - 0.7 * (tube <= 1.0))
    proton = proton * _smooth3(
        np.exp(rng.uniform(0.0, 0.25) * rng.normal(0, 1, shape)), iters=4)
    proton = np.clip(
        proton + rng.normal(0, rng.uniform(0.01, 0.06) * bg, shape), 0, None
    ).astype(np.float32)

    return Phantom(
        hp=hp.astype(np.float32),
        mask=mask,
        proton=proton,
        vox=vox,
        true_bias=bias.astype(np.float32),
        true_defect=np.zeros(shape, np.float32),
    )


def make_random_cohort(
    n: int,
    shape: Tuple[int, int, int] = (128, 128, 16),
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack n domain-randomized phantoms (fixed shape for batching)."""
    hps, masks, protons = [], [], []
    for i in range(n):
        ph = make_random_phantom(seed + i, shape=shape)
        hps.append(ph.hp)
        masks.append(ph.mask)
        protons.append(ph.proton)
    return np.stack(hps), np.stack(masks), np.stack(protons)
