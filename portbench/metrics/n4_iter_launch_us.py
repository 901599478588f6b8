"""Host microseconds an N4 iteration spends queueing its work: the time
inside the program's ``n4.iter`` spans less the ``n4.sync`` waits inside
them, over the iterations (``ventjax_torch/ops/n4.py``), in the traced
calls."""


def _spans(ctx, name):
    a, b = ctx.trace.window
    return [e - s for n, s, e in ctx.trace.host
            if n == name and s >= a and e <= b]


def read(ctx):
    iters, waits = _spans(ctx, "n4.iter"), _spans(ctx, "n4.sync")
    if not iters or not waits:
        return None
    return (sum(iters) - sum(waits)) / len(iters)
