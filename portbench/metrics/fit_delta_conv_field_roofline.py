"""Percent of its roofline that fit_delta_conv_field reached (see readers.roofline and
kernels/fit_delta_conv_field.json)."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "fit_delta_conv_field")
