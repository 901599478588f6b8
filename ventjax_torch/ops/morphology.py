"""Binary mask morphology: the reference's "edit mask" roadmap item.

Counterpart of ``ventjax/ops/morphology.py``.  Lung masks are hand-drawn
per slice in the reference workflow, so the ops default to slice-wise 2-D
structuring elements (each [H,W] slice edited independently, like the
per-slice medfilt2d); ``slicewise=False`` switches to the full 3-D
neighbourhood.

All ops take float/bool [..., H, W, D] tensors (leading batch dimensions
are optional), return float32 0/1 tensors on the input's device, and are
exact: a window max of 0/1 values over explicitly padded shifts.  Border
semantics match scipy.ndimage's defaults (outside the volume is
background, so masks touching the border erode from it).
"""
from __future__ import annotations

import torch

# fill_holes tests its flood for a fixpoint every this many dilations: each
# test is a device-to-host sync, and dilating a fixpoint changes nothing.
FLOOD_STEPS_PER_CHECK = 16


def _mask01(mask) -> torch.Tensor:
    return (torch.as_tensor(mask) > 0).to(torch.float32)


def _axis_max(x: torch.Tensor, dim: int, pad_value: float) -> torch.Tensor:
    """Max over the 3-window along ``dim`` (a negative axis), with
    ``pad_value`` outside the volume."""
    pad = [0, 0] * (-dim - 1) + [1, 1]
    xp = torch.nn.functional.pad(x, pad, value=pad_value)
    n = x.shape[dim]
    return torch.maximum(torch.maximum(xp.narrow(dim, 0, n),
                                       xp.narrow(dim, 1, n)),
                         xp.narrow(dim, 2, n))


def _dilate_once(m: torch.Tensor, slicewise: bool, connectivity: int,
                 pad_value: float = 0.0) -> torch.Tensor:
    """One max-dilation step with an explicit out-of-volume value.

    connectivity 1 = cross element (scipy's default structure: 4-neighbour
    per slice, 6-neighbour in 3-D); connectivity 2 = the full 3x3(x3) box.
    """
    dims = (-3, -2) if slicewise else (-3, -2, -1)
    if connectivity == 1:
        out = m
        for d in dims:
            out = torch.maximum(out, _axis_max(m, d, pad_value))
        return out
    for d in dims:      # the box max is separable
        m = _axis_max(m, d, pad_value)
    return m


def binary_dilate(mask, iters: int = 1, *, slicewise: bool = True,
                  connectivity: int = 1) -> torch.Tensor:
    """Grow the mask by `iters` structuring-element steps."""
    m = _mask01(mask)
    for _ in range(int(iters)):
        m = _dilate_once(m, slicewise, connectivity, pad_value=0.0)
    return (m > 0).to(torch.float32)


def binary_erode(mask, iters: int = 1, *, slicewise: bool = True,
                 connectivity: int = 1) -> torch.Tensor:
    """Shrink the mask: erosion = complement of dilating the complement.

    The complement is padded with 1 (outside the volume is background), so
    border-touching masks erode from the border — scipy's border_value=0.
    """
    inv = 1.0 - _mask01(mask)
    for _ in range(int(iters)):
        inv = _dilate_once(inv, slicewise, connectivity, pad_value=1.0)
    return (inv == 0).to(torch.float32)


def binary_open(mask, iters: int = 1, **kw) -> torch.Tensor:
    """Erode then dilate: removes islands/spurs smaller than the element."""
    return binary_dilate(binary_erode(mask, iters, **kw), iters, **kw)


def binary_close(mask, iters: int = 1, **kw) -> torch.Tensor:
    """Dilate then erode: closes gaps/channels smaller than the element."""
    return binary_erode(binary_dilate(mask, iters, **kw), iters, **kw)


def fill_holes(mask, *, slicewise: bool = True) -> torch.Tensor:
    """Fill enclosed background regions (scipy binary_fill_holes semantics).

    Geodesic reconstruction: flood the background from the volume border
    (cross connectivity, scipy's default structure) by repeated
    dilate-and-clip; background the flood cannot reach is a hole.  The
    flood runs to its fixpoint: the geodesic distance through a winding
    corridor can be O(H*W), far above any fixed H+W(+D) trip count.
    """
    m = _mask01(mask)
    H, W, D = m.shape[-3:]
    dev = m.device
    outside = 1.0 - m
    ii = torch.arange(H, device=dev)[:, None, None]
    jj = torch.arange(W, device=dev)[None, :, None]
    kk = torch.arange(D, device=dev)[None, None, :]
    border = (ii == 0) | (ii == H - 1) | (jj == 0) | (jj == W - 1)
    if not slicewise:
        border = border | (kk == 0) | (kk == D - 1)
    reach = outside * border.to(torch.float32)
    while True:
        before = reach
        for _ in range(FLOOD_STEPS_PER_CHECK):
            reach = torch.minimum(_dilate_once(reach, slicewise, 1), outside)
        if torch.equal(reach, before):
            break
    holes = (reach == 0) & (outside > 0)
    return ((m > 0) | holes).to(torch.float32)


_OPS = {
    "dilate": binary_dilate,
    "erode": binary_erode,
    "open": binary_open,
    "close": binary_close,
}


def edit_mask(mask, ops: str, *, slicewise: bool = True) -> torch.Tensor:
    """Apply a comma-separated edit recipe, e.g. ``"close:1,fillholes,erode:2"``.

    Grammar: ``op[:iters]`` with op in {dilate, erode, open, close,
    fillholes}; iters defaults to 1 (ignored for fillholes).  Applied left
    to right.  Exposed as ``Vent_Analysis.editMask`` and the CLI's
    ``--mask-edit``.
    """
    m = torch.as_tensor(mask)
    for step in ops.split(","):
        step = step.strip()
        if not step:
            continue
        name, _, arg = step.partition(":")
        name = name.strip().lower()
        if name == "fillholes":
            m = fill_holes(m, slicewise=slicewise)
            continue
        if name not in _OPS:
            raise ValueError(
                f"unknown mask-edit op {name!r}; expected one of "
                f"{sorted(_OPS)} or 'fillholes'")
        try:
            iters = int(arg) if arg else 1
        except ValueError:
            raise ValueError(f"bad iteration count in mask-edit step "
                             f"{step!r}") from None
        if iters < 0:
            raise ValueError(f"negative iterations in mask-edit step {step!r}")
        m = _OPS[name](m, iters, slicewise=slicewise)
    return (m > 0).to(torch.float32)
