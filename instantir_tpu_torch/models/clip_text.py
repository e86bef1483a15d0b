"""CLIP text encoders for SDXL prompt conditioning.

Twin of ``instantir_tpu/models/clip_text.py``. SDXL uses two towers:
  * ``text_encoder``   -- CLIP ViT-L/14's text tower: 12 layers, width 768,
    quick-GELU; its penultimate hidden state is used;
  * ``text_encoder_2`` -- OpenCLIP bigG's: 32 layers, width 1280, GELU; its
    penultimate hidden state and the projected final-LN state at the first
    EOS token (the pooled embedding, 1280 wide).

Prompt embeddings = concat(tower 1 penultimate, tower 2 penultimate) -> [B,
77, 2048]. Causal masking throughout; attention runs the plain path
(``attention_xla``, as the JAX twin does: 77 tokens never reach the flash
kernel). Parameter names are the HF ``transformers`` names
(``text_model.encoder.layers.N.self_attn.q_proj.weight``, ``text_projection.weight``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import LayerNorm32
from instantir_tpu_torch.ops.attention import attention_xla


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None  # set -> CLIPTextModelWithProjection
    eos_token_id: int = 49407
    eps: float = 1e-5


def clip_vit_l_text_config(**overrides) -> CLIPTextConfig:
    return dataclasses.replace(CLIPTextConfig(), **overrides)


def open_clip_bigg_text_config(**overrides) -> CLIPTextConfig:
    base = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120, hidden_act="gelu",
                          projection_dim=1280)
    return dataclasses.replace(base, **overrides)


def tiny_clip_text_config(**overrides) -> CLIPTextConfig:
    base = CLIPTextConfig(vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                          projection_dim=16)
    return dataclasses.replace(base, **overrides)


class _SelfAttention(nn.Module):
    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.q_proj = nn.Linear(c, c, dtype=dtype, device=device)
        self.k_proj = nn.Linear(c, c, dtype=dtype, device=device)
        self.v_proj = nn.Linear(c, c, dtype=dtype, device=device)
        self.out_proj = nn.Linear(c, c, dtype=dtype, device=device)


class _MLP(nn.Module):
    def __init__(self, c: int, hidden: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, c, dtype=dtype, device=device)


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block: causal self-attention, then the MLP (quick-GELU or exact GELU)."""

    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.act = cfg.hidden_act
        self.self_attn = _SelfAttention(c, dtype, device)
        self.layer_norm1 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)
        self.mlp = _MLP(c, cfg.intermediate_size, dtype, device)
        self.layer_norm2 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)

        def heads(t):
            return t.reshape(b, n, self.heads, c // self.heads)

        attn = attention_xla(heads(a.q_proj(h)), heads(a.k_proj(h)), heads(a.v_proj(h)), bias=causal_bias)
        x = x + a.out_proj(attn.reshape(b, n, c))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype, device=device)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size, dtype=dtype, device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, dtype, device) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype, device)
        self.encoder = _Encoder(cfg, dtype, device)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.eps, dtype=dtype, device=device)


class CLIPTextModel(nn.Module):
    """``forward(input_ids)`` -> (last hidden state, penultimate hidden
    state, pooled projection or None)."""

    def __init__(self, config: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.text_model = _TextTransformer(config, dtype, device)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False, dtype=dtype,
                                             device=device)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        tm = self.text_model
        b, n = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :n]
        causal = torch.triu(torch.full((n, n), -1e9, dtype=torch.float32, device=input_ids.device), diagonal=1)
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, causal[None, None])
        last = tm.final_layer_norm(x)
        pooled = None
        if cfg.projection_dim is not None:
            # the final-LN state at the first EOS token, projected
            eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
            pooled = self.text_projection(last[torch.arange(b, device=input_ids.device), eos])
        return last, penultimate, pooled


def encode_sdxl_prompt(enc1: CLIPTextModel, enc2: CLIPTextModel, ids1: torch.Tensor,
                       ids2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDXL's two-tower prompt embedding: ([B, 77, d1 + d2], pooled [B, proj])."""
    _, h1, _ = enc1(ids1)
    _, h2, pooled = enc2(ids2)
    return torch.cat([h1, h2], dim=-1), pooled
