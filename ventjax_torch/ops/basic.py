"""Elementwise and reduction utilities shared across the pipeline.

Counterpart of ``ventjax/ops/basic.py``.  Every function takes a batch
dimension first (``[N, ...]``) and reduces over the rest, where ``ventjax``
vmaps a single-volume function.
"""
from __future__ import annotations

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def compact_mask_indices(m: torch.Tensor, pad: int):
    """Flat indices of the set entries of each row of ``m`` ([N, V] bool).

    Returns ``(idx [N, pad] int64, n_mask [N])``: ascending row-major
    indices, padded to ``pad`` slots with ``V - 1`` (slot validity is
    ``arange(pad) < n_mask``).
    """
    idx, _, n = _sort_keys(m, pad)
    return idx, n


def _sort_keys(m: torch.Tensor, pad: int):
    N, V = m.shape
    if pad > V:
        raise ValueError(f"compaction pad {pad} exceeds the volume size {V}")
    ar = torch.arange(V, device=m.device, dtype=torch.int64)
    key = torch.where(m, ar, torch.full_like(ar, V))
    sk, order = torch.sort(key, dim=1, stable=True)
    return torch.clamp(sk[:, :pad], max=V - 1), order[:, :pad], m.sum(dim=1)


def sort_compact_masked(values: torch.Tensor, m: torch.Tensor, pad: int):
    """compact_mask_indices plus the values carried by the same stable key
    sort: ``(idx, vals, n_mask)``.  The first n_mask values are the masked
    ones; pad slots carry unmasked values in flat order, as in ventjax."""
    idx, order, n = _sort_keys(m, pad)
    return idx, values.gather(1, order), n


def gradient_border(a: torch.Tensor) -> torch.Tensor:
    """Per-slice gradient border of a binary [N,H,W,D] volume:
    (d/drow != 0) | (d/dcol != 0), with np.gradient's one-sided edges."""
    a = a.to(torch.float32)
    (gr,) = torch.gradient(a, dim=1)
    (gc,) = torch.gradient(a, dim=2)
    return ((gr != 0) | (gc != 0)).to(torch.float32)


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis in a fixed pairwise order: the row, padded
    with zeros to a power of two, is halved by elementwise adds until one
    column is left.  A lane's sum then has the same bits whatever the
    batch size (torch's reduction kernels split a row by the number of
    rows on a card), so shards of a batch sum as the batch does."""
    L = x.shape[-1]
    P = 1 << (L - 1).bit_length() if L > 1 else 1
    if P != L:
        x = torch.nn.functional.pad(x, (0, P - L))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[N] mean of x over the entries where the weight m is set."""
    w = _flat(m).to(x.dtype)
    s = row_sums(torch.stack([_flat(x) * w, w], dim=1))
    return s[:, 0] / s[:, 1]


def masked_std(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[N] population std (ddof=0) of x over the masked entries."""
    w = _flat(m).to(x.dtype)
    xf = _flat(x)
    s = row_sums(torch.stack([xf * w, w], dim=1))
    n = s[:, 1]
    mu = s[:, 0] / n
    return torch.sqrt(row_sums(w * (xf - mu[:, None]) ** 2) / n)


def masked_kth_smallest_multi(x: torch.Tensor, m: torch.Tensor,
                              ks: torch.Tensor) -> torch.Tensor:
    """[N, R] (k+1)-th smallest masked value of each row, for the [N, R]
    ranks ``ks``: a sort with masked-out entries set to +inf."""
    keyed = torch.where(_flat(m) > 0, _flat(x),
                        torch.full_like(_flat(x), float("inf")))
    srt = torch.sort(keyed, dim=1).values
    return srt.gather(1, ks.to(torch.int64).clamp(0, srt.shape[1] - 1))


def masked_kth_smallest(x: torch.Tensor, m: torch.Tensor,
                        k: torch.Tensor) -> torch.Tensor:
    """[N] (k+1)-th smallest masked value, one rank per row."""
    return masked_kth_smallest_multi(x, m, k.reshape(-1, 1))[:, 0]


def masked_sorted_index(x: torch.Tensor, m: torch.Tensor,
                        frac: float) -> torch.Tensor:
    """[N] sorted(x[m > 0])[int(count * frac)]: the reference's
    floor-index percentile (count * frac is taken in float32, as in
    ``ventjax``)."""
    count = (_flat(m) > 0).sum(1)
    idx = (count.to(torch.float32) * frac).to(torch.int64)
    return masked_kth_smallest(x, m, idx)
