"""Warps an SM that K10, the CI tail's kernel, holds resident: the
occupancy API's blocks an SM at each launch's shared memory, times its 8
warps a block (``ventjax_torch/ops/ci_cuda.py``:
``LAUNCHES["tail_balls_resident_warps"]``), over its launches
(``LAUNCHES["tail_balls"]``) in the traced calls.  None where the program
counts no resident warps or launched no K10."""


def read(ctx):
    warps = ctx.counts.get("tail_balls_resident_warps")
    launches = ctx.counts.get("tail_balls", 0)
    if warps is None or launches <= 0:
        return None
    return warps / launches
