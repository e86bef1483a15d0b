"""ZeroSFT residual fusion, twin of ``instantir_tpu/models/zero_sft.py``.

Instead of adding the Aggregator's residual ``c`` to a skip connection, the
residual modulates the (up-path ∥ skip) concatenation through a GroupNorm-SFT
with zero-initialised convolutions:

  h_raw = [h_ori ∥ h]                           (the plain concat path)
  h     = h + zero_conv(c)                      (1×1)
  h     = [h_ori ∥ h]
  γ, β  = zero_mul(a), zero_add(a),  a = SiLU(mlp_shared(c))   (3×3)
  out   = GN(h)·(γ+1) + β
  return out·s + h_raw·(1−s)                    (s = control_scale)

The JAX module reads its channel counts from the call; here they are given:
``label_nc`` (the residual's), ``norm_nc`` (the skip's) and
``concat_channels`` (the up path's, 0 for the mid block). The norm is the
port's ``GroupNorm32`` (``param_free_norm``, eps 1e-5, no SiLU), so on the
card it runs the fused GroupNorm kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import GroupNorm32


def _zero_conv(cin: int, cout: int, k: int, common: dict) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, padding=k // 2, **common)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ZeroSFT(nn.Module):
    def __init__(self, label_nc: int, norm_nc: int, concat_channels: int = 0, nhidden: int = 128,
                 norm_num_groups: int = 32, use_norm: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        out_nc = norm_nc + concat_channels
        self.dtype = dtype
        self.zero_conv = _zero_conv(label_nc, norm_nc, 1, common)
        self.mlp_shared = nn.Conv2d(label_nc, nhidden, 3, padding=1, **common)
        self.zero_mul = _zero_conv(nhidden, out_nc, 3, common)
        self.zero_add = _zero_conv(nhidden, out_nc, 3, common)
        self.param_free_norm = GroupNorm32(norm_num_groups, out_nc, **common) if use_norm else None

    def forward(self, control: torch.Tensor, h: torch.Tensor, h_ori: Optional[torch.Tensor] = None,
                control_scale: float = 1.0) -> torch.Tensor:
        control = control.to(self.dtype)
        h_raw = torch.cat([h_ori, h], dim=1) if h_ori is not None else h
        h = h + self.zero_conv(control)
        if h_ori is not None:
            h = torch.cat([h_ori, h], dim=1)
        actv = F.silu(self.mlp_shared(control))
        gamma, beta = self.zero_mul(actv), self.zero_add(actv)
        hn = self.param_free_norm(h) if self.param_free_norm is not None else h
        h = hn * (gamma + 1.0) + beta
        if control_scale == 1.0:
            return h
        return h * control_scale + h_raw * (1.0 - control_scale)
