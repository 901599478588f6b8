"""Device activities (kernels, copies, fills) in the traced window a study."""


def read(ctx):
    n = len(ctx.trace.device)
    return n / ctx.studies if n else None
