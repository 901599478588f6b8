"""Host ms a call spends in the pipeline's ``n4`` range (pipeline/analyze.py)."""
from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "n4")
