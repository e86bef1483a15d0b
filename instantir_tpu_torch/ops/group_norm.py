"""GroupNorm(+SiLU) with fp32 statistics -- the plain version.

Twin of ``instantir_tpu/ops/group_norm.py::group_norm_silu_reference``. The
Pallas GroupNorm kernel of the JAX package is off by default there (it measured
slower than XLA's fused GroupNorm on the TPU) and is not on this port's path
yet; its semantics are, through these functions. Statistics use the
E[x^2] - mu^2 form clamped at 0 -- not ``F.group_norm``'s variance -- so the
port rounds where the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm_silu_nchw(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float, apply_silu: bool
) -> torch.Tensor:
    """GroupNorm over channels-first ``[B, C, *spatial]`` input; returns x.dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    mean_sq = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((mean_sq - mean * mean).clamp(min=0.0) + eps)
    y = ((xf - mean) * inv).reshape(x.shape)
    affine_shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(affine_shape) + bias.float().reshape(affine_shape)
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_silu_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float, apply_silu: bool
) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` in and out, like the JAX function."""
    y = group_norm_silu_nchw(x.permute(0, 3, 1, 2), scale, bias, num_groups, eps, apply_silu)
    return y.permute(0, 2, 3, 1)
