"""Device ops on [N, ...] batches: the PyTorch counterparts of ventjax.ops.

``n4_cuda`` (K1, K2), ``n4_sharpen_cuda`` (K4, K5), ``ci_cuda`` (K3),
``ci_densify_cuda`` (K9, K8) and ``n4_field_cuda`` (N4's dense field) hold
the CUDA kernels' wrappers and plain versions; the other modules are plain
PyTorch.  ``__all__`` covers ventjax.ops's names and the port's own.
"""
from ventjax_torch.ops.basic import (
    gradient_border,
    masked_mean,
    masked_sorted_index,
    masked_std,
    minmax_normalize,
)
from ventjax_torch.ops.ci import calculate_ci
from ventjax_torch.ops.ci_densify_cuda import densify_rank, rank
from ventjax_torch.ops.ci_pairwise import calculate_ci_pairwise
from ventjax_torch.ops.kmeans import vdp_kmeans
from ventjax_torch.ops.median import median3x3_binary
from ventjax_torch.ops.n4 import n4_bias_correction
from ventjax_torch.ops.n4_sharpen_cuda import sharpen_hist, sharpen_resid
from ventjax_torch.ops.snr import calculate_snr
from ventjax_torch.ops.vdp import vdp_linear_binning, vdp_mean_anchored

__all__ = [
    "minmax_normalize",
    "gradient_border",
    "masked_mean",
    "masked_sorted_index",
    "masked_std",
    "calculate_ci",
    "calculate_ci_pairwise",
    "densify_rank",
    "rank",
    "vdp_kmeans",
    "median3x3_binary",
    "n4_bias_correction",
    "sharpen_hist",
    "sharpen_resid",
    "calculate_snr",
    "vdp_linear_binning",
    "vdp_mean_anchored",
]
