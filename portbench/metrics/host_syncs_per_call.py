"""Every point a call's host waits for the card: the program's spans whose
name ends in ``.sync`` (``utils/profiling.host_wait``), over the traced
calls."""


def read(ctx):
    a, b = ctx.trace.window
    n = sum(1 for name, s, e in ctx.trace.host
            if name.endswith(".sync") and s >= a and e <= b)
    return n / len(ctx.calls) if n and ctx.calls else None
