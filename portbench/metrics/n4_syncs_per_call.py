"""N4 level loop's device-to-host syncs a call (``ops/n4.py`` HOST_SYNCS),
over the measured window."""


def read(ctx):
    n = ctx.window_counts.get("n4_host_syncs", 0)
    return n / ctx.window_calls if ctx.window_calls and n > 0 else None
