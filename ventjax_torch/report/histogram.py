"""Masked-signal histogram figure: the reference's "show histogram?"
roadmap item.

The port's copy of ``ventjax/report/histogram.py``.  matplotlib and PIL
are imported inside the functions that draw, never at module level.

Renders the linear-binning view of a study (Mu He 2016, the VDP_lb method
at Vent_Analysis.py:254-257): normalized masked signal distribution with
the six clinical bins delimited by the configured edges.  Bin identity is
carried primarily by x-position between labeled dashed edge lines; the
fill colors reinforce the standard clinical reading (reds = defect,
greens = normal, blues = hyper) and are never the only cue.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Clinical bin colors (defect -> hyperventilated), mid-lightness so the
# neutral-ink labels stay readable on white.
BIN_COLORS = ("#b3342c", "#e07b39", "#e8c84a", "#5aa05a", "#3b7fb8",
              "#7a4fa3")
BIN_LABELS = ("defect", "low", "normal", "normal", "high", "hyper")
_INK = "#333333"
_MUTED = "#777777"


def signal_histogram(
    path: str,
    signal: np.ndarray,
    mask: np.ndarray,
    edges: Sequence[float] = (0.16, 0.34, 0.52, 0.70, 0.88),
    percentile: float = 0.99,
    bins: int = 80,
    title: Optional[str] = None,
    vdp_lb: Optional[float] = None,
) -> str:
    """Save the masked-signal histogram PNG; returns `path`.

    `signal` is the (N4-corrected) volume; values under ``mask > 0`` are
    normalized by the reference's floor-index percentile
    (sorted[int(count*percentile)], Vent_Analysis.py:255) so the x-axis
    matches the linear-binning bin edges exactly.

    Rendered with matplotlib when available; falls back to a plain PIL
    rendering otherwise.  With neither, the PIL import raises an
    ImportError that names Pillow.
    """
    vals = np.asarray(signal, np.float64)[np.asarray(mask) > 0]
    if vals.size == 0:
        raise ValueError("empty mask: nothing to histogram")
    denom = np.sort(vals)[int(len(vals) * percentile)]
    if denom == 0:
        raise ValueError("normalization percentile is zero")
    norm = vals / denom
    edges = tuple(float(e) for e in edges)
    xmax = max(1.1, float(np.quantile(norm, 0.999)) * 1.05)
    hist_edges = np.linspace(0.0, xmax, bins + 1)
    counts, _ = np.histogram(norm, bins=hist_edges)
    centers = 0.5 * (hist_edges[:-1] + hist_edges[1:])
    # color each histogram bar by the clinical bin its center falls in
    bin_idx = np.searchsorted(edges, centers, side="left")
    colors = [BIN_COLORS[i] for i in bin_idx]

    head = title or "Masked ventilation signal"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if vdp_lb is not None:
            head += f"   (VDP_lb = {float(vdp_lb):.1f}%)"
        return _render_pil(path, counts, hist_edges, colors, edges, xmax,
                           head, percentile)
    return _render_mpl(path, counts, centers, hist_edges, colors, edges,
                       xmax, head, percentile, vdp_lb)


def _render_mpl(path, counts, centers, hist_edges, colors, edges, xmax,
                head, percentile, vdp_lb):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7.2, 4.2), dpi=130)
    ax.bar(centers, counts, width=(hist_edges[1] - hist_edges[0]) * 0.92,
           color=colors, linewidth=0)
    for e in edges:
        ax.axvline(e, color=_MUTED, linestyle="--", linewidth=1)
    # region labels in neutral ink above the plot (identity never
    # color-alone: position between the dashed edges is the primary cue)
    bounds = (0.0,) + edges + (xmax,)
    top = ax.get_ylim()[1]
    shown = set()
    for i in range(6):
        label = BIN_LABELS[i]
        if label in shown:  # the two "normal" bins share one label
            continue
        lo = bounds[i]
        hi = bounds[i + 1] if label != "normal" else bounds[i + 2]
        shown.add(label)
        ax.text(0.5 * (lo + min(hi, xmax)), top * 1.02, label,
                ha="center", va="bottom", fontsize=8, color=_INK)
    ax.set_xlim(0, xmax)
    ax.set_xlabel(f"signal / {int(percentile * 100)}th-percentile signal",
                  color=_INK)
    ax.set_ylabel("voxel count", color=_INK)
    if vdp_lb is not None:
        head += f"   (VDP$_{{lb}}$ = {float(vdp_lb):.1f}%)"
    # pad the title above the bin region labels (which sit just over the
    # axis top)
    ax.set_title(head, color=_INK, fontsize=11, pad=20)
    ax.spines[["top", "right"]].set_visible(False)
    ax.tick_params(colors=_MUTED, labelsize=8)
    ax.grid(axis="y", color="#e6e6e6", linewidth=0.6)
    ax.set_axisbelow(True)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def _render_pil(path, counts, hist_edges, colors, edges, xmax, head,
                percentile):
    """Matplotlib-free rendering: same bars, dashed bin edges, and labels
    on a white canvas via PIL."""
    from ventjax_torch.report.screenshot import _pil

    Image, ImageDraw, _ = _pil()

    W, H = 936, 546
    ml, mr, mt, mb = 70, 20, 60, 55  # margins
    pw, ph = W - ml - mr, H - mt - mb
    img = Image.new("RGB", (W, H), "white")
    d = ImageDraw.Draw(img)

    def xpix(x):
        return ml + int(pw * x / xmax)

    top = max(1, int(counts.max()))
    # y gridlines + tick labels
    for frac in (0.25, 0.5, 0.75, 1.0):
        y = mt + ph - int(ph * frac)
        d.line([(ml, y), (W - mr, y)], fill="#e6e6e6", width=1)
        d.text((ml - 6, y), str(int(top * frac)), fill=_MUTED, anchor="rm")
    # bars
    for i, c in enumerate(counts):
        x0 = xpix(hist_edges[i]) + 1
        x1 = max(x0, xpix(hist_edges[i + 1]) - 1)
        h = int(ph * c / top)
        if h:
            d.rectangle([x0, mt + ph - h, x1, mt + ph], fill=colors[i])
    # dashed bin-edge lines + region labels
    for e in edges:
        x = xpix(e)
        for y in range(mt, mt + ph, 8):
            d.line([(x, y), (x, min(y + 4, mt + ph))], fill=_MUTED, width=1)
    bounds = (0.0,) + tuple(edges) + (xmax,)
    shown = set()
    for i in range(6):
        label = BIN_LABELS[i]
        if label in shown:
            continue
        lo = bounds[i]
        hi = bounds[i + 1] if label != "normal" else bounds[i + 2]
        shown.add(label)
        d.text((xpix(0.5 * (lo + min(hi, xmax))), mt - 6), label,
               fill=_INK, anchor="ms")
    # axes, labels, title
    d.line([(ml, mt + ph), (W - mr, mt + ph)], fill=_INK, width=1)
    d.line([(ml, mt), (ml, mt + ph)], fill=_INK, width=1)
    for x in (0.0, 0.5, 1.0):
        if x <= xmax:
            d.text((xpix(x), mt + ph + 6), f"{x:.1f}", fill=_MUTED,
                   anchor="ma")
    d.text((ml + pw // 2, H - 18),
           f"signal / {int(percentile * 100)}th-percentile signal",
           fill=_INK, anchor="mm")
    d.text((ml, 18), head, fill=_INK, anchor="lm")
    img.save(path)
    return path
