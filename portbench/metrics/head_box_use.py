"""Percent of the (center, witness, alias shift) triples handed to the CI
head kernel K3 that lie in the rmax box, so that K3 has a distance to
compute: the traced calls' in-box triples of their defect maps
(``kernels/work.py:box_distances``) over the triples the K3 wrapper was
entered with (``ventjax_torch/ops/ci_cuda.py``: ``head_counts_triples``,
N x K x Kw x alias combos) over the traced window.  The rest is the pad's
sentinel rows and pairs out of each other's reach."""
from portbench.kernels.work import box_distances


def read(ctx):
    triples = ctx.counts.get("head_counts_triples", 0)
    if triples <= 0:
        return None
    inside = {}
    for b in set(ctx.calls):
        w = ctx.work(b)
        inside[b] = float(box_distances(w["defect"], w["rmax"]).sum())
    return 100.0 * sum(inside[b] for b in ctx.calls) / triples
