"""ResNet blocks and up/down sampling for the SDXL UNet (NCHW).

Twin of ``instantir_tpu/models/resnet.py``. conv1/conv2/conv_shortcut/
time_emb_proj and the sampler convs are previewer-LoRA targets.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import GroupNorm32, LoRAConv2d, LoRALinear


class ResnetBlock2D(nn.Module):
    """GN->SiLU->conv x2 with additive time-embedding injection and shortcut
    (diffusers ``ResnetBlock2D``, ``time_embedding_norm=default``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
                 norm_num_groups: int = 32, eps: float = 1e-5, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm32(norm_num_groups, in_channels, eps=eps, fuse_silu=True, **common)
        self.conv1 = LoRAConv2d(in_channels, out_channels, 3, padding=1, **lora, **common)
        self.time_emb_proj = (
            LoRALinear(temb_channels, out_channels, **lora, **common) if temb_channels is not None else None
        )
        self.norm2 = GroupNorm32(norm_num_groups, out_channels, eps=eps, fuse_silu=True, **common)
        self.conv2 = LoRAConv2d(out_channels, out_channels, 3, padding=1, **lora, **common)
        self.conv_shortcut = (
            LoRAConv2d(in_channels, out_channels, 1, padding=0, **lora, **common)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None, lora_scale: float = 0.0) -> torch.Tensor:
        h = self.conv1(self.norm1(x), lora_scale)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb), lora_scale)[:, :, None, None]
        h = self.conv2(self.norm2(h), lora_scale)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, lora_scale)
        return x + h


class Downsample2D(nn.Module):
    """3x3 stride-2 conv (padding 1)."""

    def __init__(self, channels: int, out_channels: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = LoRAConv2d(channels, out_channels, 3, stride=2, padding=1, lora_rank=lora_rank,
                               lora_alpha=lora_alpha, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        return self.conv(x, lora_scale)


class Upsample2D(nn.Module):
    """Nearest x2 then 3x3 conv."""

    def __init__(self, channels: int, out_channels: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.conv = LoRAConv2d(channels, out_channels, 3, padding=1, lora_rank=lora_rank, lora_alpha=lora_alpha,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), lora_scale)
