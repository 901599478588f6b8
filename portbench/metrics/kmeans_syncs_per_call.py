"""VDP k-means' device-to-host syncs a call: the program's
``vdp_kmeans.sync`` spans, one a Lloyd iteration
(``ventjax_torch/ops/kmeans.py``), over the traced calls."""


def read(ctx):
    a, b = ctx.trace.window
    n = sum(1 for name, s, e in ctx.trace.host
            if name == "vdp_kmeans.sync" and s >= a and e <= b)
    return n / len(ctx.calls) if n and ctx.calls else None
