"""Device milliseconds a call in NCCL's kernels, in rank 0's traced calls
(``ranks.py``: the gather of the batch's metrics, one a call).  An
all-gather's kernel runs until every peer has joined it, so this holds
also how long rank 0 waited for the slowest rank.  None where no NCCL
kernel ran (one process, or gloo on the CPU)."""


def read(ctx):
    seconds, n = ctx.trace.device_seconds(["nccl"])
    return 1e3 * seconds / len(ctx.calls) if n and ctx.calls else None
