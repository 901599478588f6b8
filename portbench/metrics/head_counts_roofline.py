"""Percent of its roofline that head_counts reached (see readers.roofline and
kernels/head_counts.json)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "head_counts")
