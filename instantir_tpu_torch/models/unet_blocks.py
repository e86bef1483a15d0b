"""SDXL UNet down/mid/up blocks (NCHW, functional LoRA, optional IP branch).

Twin of ``instantir_tpu/models/unet_blocks.py``. The up blocks take the
channel count of each skip connection they consume, ``skip_channels[j]`` for
layer j (popped from the end of the down stack). Built with ``zero_sft``, an
up block fuses a ``(control, skip)`` pair in place of a skip through its own
``zero_sfts.{j}`` (``models/zero_sft.py``); a plain skip is concatenated. The
down and mid blocks pass the Aggregator's ``attn1_with_ip`` / ``attn1_mode``
to their transformers and ``ref_scale`` to their forwards.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from instantir_tpu_torch.models.resnet import Downsample2D, ResnetBlock2D, Upsample2D
from instantir_tpu_torch.models.transformer import Transformer2DModel
from instantir_tpu_torch.models.zero_sft import ZeroSFT


def _attn_kwargs(heads, head_dim, transformer_layers, cross_attention_dim, has_cross_attention, with_ip,
                 time_aware_ip, temb_channels, norm_num_groups, lora, use_flash, common, attn1_with_ip=False,
                 attn1_mode="plain"):
    return dict(heads=heads, head_dim=head_dim, num_layers=transformer_layers,
                cross_attention_dim=cross_attention_dim, has_cross_attention=has_cross_attention, with_ip=with_ip,
                time_aware_ip=time_aware_ip, temb_dim=temb_channels, norm_num_groups=norm_num_groups,
                use_flash=use_flash, attn1_with_ip=attn1_with_ip, attn1_mode=attn1_mode, **lora, **common)


def _zero_sfts(in_channels, out_channels, skip_channels, norm_num_groups, common):
    """One ZeroSFT per up-block resnet: the residual and the skip have the
    skip's channels, the up path's hidden (concatenated first) its own."""
    return nn.ModuleList([
        ZeroSFT(skip, skip, in_channels if j == 0 else out_channels, norm_num_groups=norm_num_groups, **common)
        for j, skip in enumerate(skip_channels)
    ])


def _fuse_skip(x, skip, zero_sfts, j):
    """The resnet input of up layer j: ``[x ∥ skip]``, or a ``(control, skip)``
    pair fused through ``zero_sfts[j]``."""
    if isinstance(skip, tuple):
        control, skip_h = skip
        return zero_sfts[j](control, skip_h, h_ori=x)
    return torch.cat([x, skip], dim=1)


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, num_layers: int = 2,
                 add_downsample: bool = True, norm_num_groups: int = 32, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype=torch.float32, device=None):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          norm_num_groups=norm_num_groups, **lora, **common)
            for i in range(num_layers)
        ])
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, out_channels, **lora, **common)]) if add_downsample else None
        )

    def forward(self, x, temb, lora_scale: float = 0.0):
        res = []
        for resnet in self.resnets:
            x = resnet(x, temb, lora_scale)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, lora_scale)
            res.append(x)
        return x, tuple(res)


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, heads: int, head_dim: int,
                 transformer_layers: int = 1, num_layers: int = 2, cross_attention_dim: int = 2048,
                 has_cross_attention: bool = True, with_ip: bool = False, time_aware_ip: bool = True,
                 add_downsample: bool = True, norm_num_groups: int = 32, lora_rank: int = 0,
                 lora_alpha: float = 1.0, use_flash: bool = True, dtype=torch.float32, device=None,
                 attn1_with_ip: bool = False, attn1_mode: str = "plain"):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        tr = _attn_kwargs(heads, head_dim, transformer_layers, cross_attention_dim, has_cross_attention, with_ip,
                          time_aware_ip, temb_channels, norm_num_groups, lora, use_flash, common, attn1_with_ip,
                          attn1_mode)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, temb_channels,
                          norm_num_groups=norm_num_groups, **lora, **common)
            for i in range(num_layers)
        ])
        self.attentions = nn.ModuleList([Transformer2DModel(out_channels, **tr) for _ in range(num_layers)])
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, out_channels, **lora, **common)]) if add_downsample else None
        )

    def forward(self, x, temb, encoder_hidden_states=None, ip_hidden_states=None, attn_temb=None,
                lora_scale: float = 0.0, ip_scale=None, ref_scale: float = 1.0):
        res = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb, lora_scale)
            x = attn(x, encoder_hidden_states=encoder_hidden_states, ip_hidden_states=ip_hidden_states,
                     temb=attn_temb, lora_scale=lora_scale, ip_scale=ip_scale, ref_scale=ref_scale)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, lora_scale)
            res.append(x)
        return x, tuple(res)


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, in_channels: int, temb_channels: int, heads: int, head_dim: int,
                 transformer_layers: int = 1, cross_attention_dim: int = 2048, has_cross_attention: bool = True,
                 with_ip: bool = False, time_aware_ip: bool = True, norm_num_groups: int = 32,
                 lora_rank: int = 0, lora_alpha: float = 1.0, use_flash: bool = True, dtype=torch.float32,
                 device=None, attn1_with_ip: bool = False, attn1_mode: str = "plain"):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        tr = _attn_kwargs(heads, head_dim, transformer_layers, cross_attention_dim, has_cross_attention, with_ip,
                          time_aware_ip, temb_channels, norm_num_groups, lora, use_flash, common, attn1_with_ip,
                          attn1_mode)
        rn = dict(norm_num_groups=norm_num_groups, **lora, **common)
        self.resnets = nn.ModuleList([ResnetBlock2D(in_channels, in_channels, temb_channels, **rn) for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2DModel(in_channels, **tr)])

    def forward(self, x, temb, encoder_hidden_states=None, ip_hidden_states=None, attn_temb=None,
                lora_scale: float = 0.0, ip_scale=None, ref_scale: float = 1.0):
        x = self.resnets[0](x, temb, lora_scale)
        x = self.attentions[0](x, encoder_hidden_states=encoder_hidden_states, ip_hidden_states=ip_hidden_states,
                               temb=attn_temb, lora_scale=lora_scale, ip_scale=ip_scale, ref_scale=ref_scale)
        return self.resnets[1](x, temb, lora_scale)


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, skip_channels: Sequence[int], temb_channels: int,
                 add_upsample: bool = True, norm_num_groups: int = 32, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None, zero_sft: bool = False):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        self.zero_sfts = (_zero_sfts(in_channels, out_channels, skip_channels, norm_num_groups, common)
                          if zero_sft else None)
        self.resnets = nn.ModuleList([
            ResnetBlock2D((in_channels if j == 0 else out_channels) + skip, out_channels, temb_channels,
                          norm_num_groups=norm_num_groups, **lora, **common)
            for j, skip in enumerate(skip_channels)
        ])
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels, **lora, **common)]) if add_upsample else None
        )

    def forward(self, x, res_samples: Tuple, temb, lora_scale: float = 0.0):
        for j, resnet in enumerate(self.resnets):
            x = resnet(_fuse_skip(x, res_samples[-1 - j], self.zero_sfts, j), temb, lora_scale)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, lora_scale)
        return x


class CrossAttnUpBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, skip_channels: Sequence[int], temb_channels: int,
                 heads: int, head_dim: int, transformer_layers: int = 1, cross_attention_dim: int = 2048,
                 has_cross_attention: bool = True, with_ip: bool = False, time_aware_ip: bool = True,
                 add_upsample: bool = True, norm_num_groups: int = 32, lora_rank: int = 0, lora_alpha: float = 1.0,
                 use_flash: bool = True, dtype=torch.float32, device=None, zero_sft: bool = False):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        tr = _attn_kwargs(heads, head_dim, transformer_layers, cross_attention_dim, has_cross_attention, with_ip,
                          time_aware_ip, temb_channels, norm_num_groups, lora, use_flash, common)
        self.zero_sfts = (_zero_sfts(in_channels, out_channels, skip_channels, norm_num_groups, common)
                          if zero_sft else None)
        self.resnets = nn.ModuleList([
            ResnetBlock2D((in_channels if j == 0 else out_channels) + skip, out_channels, temb_channels,
                          norm_num_groups=norm_num_groups, **lora, **common)
            for j, skip in enumerate(skip_channels)
        ])
        self.attentions = nn.ModuleList([Transformer2DModel(out_channels, **tr) for _ in skip_channels])
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, out_channels, **lora, **common)]) if add_upsample else None
        )

    def forward(self, x, res_samples: Tuple, temb, encoder_hidden_states=None,
                ip_hidden_states=None, attn_temb=None, lora_scale: float = 0.0, ip_scale=None):
        for j, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = resnet(_fuse_skip(x, res_samples[-1 - j], self.zero_sfts, j), temb, lora_scale)
            x = attn(x, encoder_hidden_states=encoder_hidden_states, ip_hidden_states=ip_hidden_states,
                     temb=attn_temb, lora_scale=lora_scale, ip_scale=ip_scale)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, lora_scale)
        return x
