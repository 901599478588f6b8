"""CPU oracle: NumPy/SciPy re-statements of the reference formulas.

The port's copy of ``ventjax/oracle``: the same names
and arithmetic, held bit-equal to the original by a CPU test.  These
functions replicate the behaviour of the reference application, quirks
included, and are the ground truth of the doctor's pipeline self-test.
They are deliberately simple, slow, host-side code.
"""
from ventjax_torch.oracle.reference import (
    normalize,
    calculate_border,
    crop_to_data,
    calculate_snr,
    vdp_mean_anchored,
    vdp_linear_binning,
    vdp_kmeans,
    build_4d_array,
)
from ventjax_torch.oracle.ci_oracle import (
    sphere_pixels,
    calculate_ci_oracle,
)
from ventjax_torch.oracle.n4_oracle import n4_bias_correction_oracle

__all__ = [
    "normalize",
    "calculate_border",
    "crop_to_data",
    "calculate_snr",
    "vdp_mean_anchored",
    "vdp_linear_binning",
    "vdp_kmeans",
    "build_4d_array",
    "sphere_pixels",
    "calculate_ci_oracle",
    "n4_bias_correction_oracle",
]
