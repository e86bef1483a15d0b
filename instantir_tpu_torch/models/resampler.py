"""Perceiver Resampler -- projects DINOv2 tokens to 64 image-prompt tokens.

Twin of ``instantir_tpu/models/resampler.py``: learned latent queries attend
over [image tokens ++ latents] with a double-sqrt scale and an fp32 softmax;
pre-LN feed-forward with no biases; final projection + LayerNorm to the UNet
cross-attention width. ``to_q``/``to_kv``/``to_out`` carry the previewer LoRA.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import LayerNorm32, LoRALinear


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1280
    depth: int = 4
    head_dim: int = 64
    heads: int = 20
    num_queries: int = 64
    embedding_dim: int = 1024  # DINOv2-large hidden size
    output_dim: int = 2048  # SDXL cross-attention dim
    ff_mult: int = 4
    lora_rank: int = 0
    lora_alpha: float = 1.0


def instantir_resampler_config(**overrides) -> ResamplerConfig:
    return dataclasses.replace(ResamplerConfig(), **overrides)


def tiny_resampler_config(**overrides) -> ResamplerConfig:
    base = ResamplerConfig(dim=32, depth=2, head_dim=8, heads=4, num_queries=8, embedding_dim=16, output_dim=32)
    return dataclasses.replace(base, **overrides)


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int, heads: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        inner = head_dim * heads
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype, device=device)
        self.head_dim = head_dim
        self.heads = heads
        self.norm1 = LayerNorm32(dim, eps=1e-6, dtype=dtype, device=device)
        self.norm2 = LayerNorm32(dim, eps=1e-6, dtype=dtype, device=device)
        self.to_q = LoRALinear(dim, inner, bias=False, **lora)
        self.to_kv = LoRALinear(dim, inner * 2, bias=False, **lora)
        self.to_out = LoRALinear(inner, dim, bias=False, **lora)

    def forward(self, x: torch.Tensor, latents: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents, lora_scale)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2), lora_scale).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(b, -1, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        # double-sqrt scaling + fp32 softmax
        scale = 1.0 / math.sqrt(math.sqrt(self.head_dim))
        weight = torch.matmul(q.float() * scale, (k.float() * scale).transpose(-1, -2))
        weight = torch.softmax(weight, dim=-1).to(v.dtype)
        out = torch.matmul(weight, v).transpose(1, 2).reshape(b, l, -1)
        return self.to_out(out, lora_scale)


class Resampler(nn.Module):
    def __init__(self, config: ResamplerConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        common = dict(dtype=dtype, device=device)
        self.latents = nn.Parameter(torch.randn(1, cfg.num_queries, cfg.dim, **common) * cfg.dim**-0.5)
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim, **common)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PerceiverAttention(cfg.dim, cfg.head_dim, cfg.heads, cfg.lora_rank, cfg.lora_alpha, **common),
                nn.Sequential(
                    LayerNorm32(cfg.dim, eps=1e-6, **common),
                    nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False, **common),
                    nn.GELU(),
                    nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False, **common),
                ),
            ])
            for _ in range(cfg.depth)
        ])
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim, **common)
        self.norm_out = LayerNorm32(cfg.output_dim, eps=1e-6, **common)

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x.to(self.dtype))
        for attn, ff in self.layers:
            latents = latents + attn(x, latents, lora_scale)
            latents = latents + ff(latents)
        return self.norm_out(self.proj_out(latents))
