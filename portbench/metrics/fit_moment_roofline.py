"""Percent of its roofline that fit_moment reached (see readers.roofline and
kernels/fit_moment.json)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "fit_moment")
