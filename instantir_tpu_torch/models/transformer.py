"""Transformer2D stack for SDXL blocks (use_linear_projection variant).

Twin of ``instantir_tpu/models/transformer.py``: diffusers
``BasicTransformerBlock``/``Transformer2DModel`` semantics with the IP branch
folded into ``Attention`` and cross-attention removable
(``has_cross_attention=False`` for the Aggregator). Modules take NCHW maps;
tokens are the row-major flattened H·W axis, as in the JAX package.

The Aggregator's variants of the self-attention ``attn1``: ``attn1_with_ip``
gives it the decoupled time-aware IP branch over cross-attention-wide image
tokens (``aggregator_adapter``); ``attn1_mode`` ``"split"`` / ``"sep_split"``
makes it a ``SplitAttention`` (``joint`` / ``sep``) over the map's
``spatial`` (H, W), with ``ref_scale`` for ``sep``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.attention import Attention, SplitAttention
from instantir_tpu_torch.models.layers import GroupNorm32, LayerNorm32, LoRALinear


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, lora: dict, common: dict):
        super().__init__()
        self.proj = LoRALinear(dim, inner * 2, **lora, **common)

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        h, gate = self.proj(x, lora_scale).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward (``net.0.proj``, ``net.2``): x·gelu(gate), project back."""

    def __init__(self, dim: int, mult: int = 4, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        common = dict(dtype=dtype, device=device)
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, lora, common), nn.Identity(),
                                  LoRALinear(dim * mult, dim, **lora, **common)])

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        return self.net[2](self.net[0](x, lora_scale), lora_scale)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cross_attention_dim: int = 2048,
                 has_cross_attention: bool = True, with_ip: bool = False, time_aware_ip: bool = True,
                 temb_dim: Optional[int] = None, lora_rank: int = 0, lora_alpha: float = 1.0,
                 use_flash: bool = True, dtype=torch.float32, device=None, attn1_with_ip: bool = False,
                 attn1_mode: str = "plain"):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.has_cross_attention = has_cross_attention
        self.attn1_with_ip = attn1_with_ip
        self.attn1_mode = attn1_mode
        self.norm1 = LayerNorm32(dim, eps=1e-5, **common)
        if attn1_mode == "plain":
            self.attn1 = Attention(dim, heads, head_dim, with_ip=attn1_with_ip, time_aware_ip=time_aware_ip,
                                   temb_dim=temb_dim, ip_dim=cross_attention_dim, use_flash=use_flash, **lora,
                                   **common)
        else:
            self.attn1 = SplitAttention(dim, heads, head_dim, mode="sep" if attn1_mode == "sep_split" else "joint",
                                        temb_dim=temb_dim, use_flash=use_flash, **common)
        if has_cross_attention:
            self.norm2 = LayerNorm32(dim, eps=1e-5, **common)
            self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim=cross_attention_dim, with_ip=with_ip,
                                   time_aware_ip=time_aware_ip, temb_dim=temb_dim, use_flash=use_flash,
                                   **lora, **common)
        self.norm3 = LayerNorm32(dim, eps=1e-5, **common)
        self.ff = GEGLUFeedForward(dim, **lora, **common)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None, temb: Optional[torch.Tensor] = None,
                lora_scale: float = 0.0, ip_scale: Optional[float] = None, spatial=None,
                ref_scale: float = 1.0) -> torch.Tensor:
        normed = self.norm1(hidden_states)
        if self.attn1_mode == "plain":
            with_ip = self.attn1_with_ip
            attn1_out = self.attn1(normed, ip_hidden_states=ip_hidden_states if with_ip else None,
                                   temb=temb if with_ip else None, lora_scale=lora_scale,
                                   ip_scale=ip_scale if with_ip else None)
        else:
            attn1_out = self.attn1(normed, spatial, temb=temb, ref_scale=ref_scale)
        hidden_states = hidden_states + attn1_out
        if self.has_cross_attention:
            hidden_states = hidden_states + self.attn2(
                self.norm2(hidden_states), encoder_hidden_states=encoder_hidden_states,
                ip_hidden_states=ip_hidden_states, temb=temb, lora_scale=lora_scale, ip_scale=ip_scale,
            )
        return hidden_states + self.ff(self.norm3(hidden_states), lora_scale)


class Transformer2DModel(nn.Module):
    """GroupNorm -> linear proj_in -> N transformer blocks -> proj_out + residual."""

    def __init__(self, in_channels: int, heads: int, head_dim: int, num_layers: int = 1,
                 cross_attention_dim: int = 2048, has_cross_attention: bool = True, with_ip: bool = False,
                 time_aware_ip: bool = True, temb_dim: Optional[int] = None, norm_num_groups: int = 32,
                 lora_rank: int = 0, lora_alpha: float = 1.0, use_flash: bool = True, dtype=torch.float32,
                 device=None, attn1_with_ip: bool = False, attn1_mode: str = "plain"):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.norm = GroupNorm32(norm_num_groups, in_channels, eps=1e-6, **common)
        self.proj_in = LoRALinear(in_channels, in_channels, **lora, **common)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(in_channels, heads, head_dim, cross_attention_dim, has_cross_attention, with_ip,
                                  time_aware_ip, temb_dim, use_flash=use_flash, attn1_with_ip=attn1_with_ip,
                                  attn1_mode=attn1_mode, **lora, **common)
            for _ in range(num_layers)
        ])
        self.proj_out = LoRALinear(in_channels, in_channels, **lora, **common)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: Optional[torch.Tensor] = None,
                ip_hidden_states: Optional[torch.Tensor] = None, temb: Optional[torch.Tensor] = None,
                lora_scale: float = 0.0, ip_scale: Optional[float] = None, ref_scale: float = 1.0) -> torch.Tensor:
        b, c, h, w = hidden_states.shape
        residual = hidden_states
        x = self.norm(hidden_states).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x, lora_scale)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states=encoder_hidden_states, ip_hidden_states=ip_hidden_states,
                      temb=temb, lora_scale=lora_scale, ip_scale=ip_scale, spatial=(h, w), ref_scale=ref_scale)
        x = self.proj_out(x, lora_scale)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
