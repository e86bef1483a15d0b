"""CLIP vision tower (ViT): the image half of CLIPLoss and the ``--use_clip_encoder`` image-prompt encoder.

Twin of ``instantir_tpu/models/clip_vision.py``: HF
``CLIPVisionModelWithProjection`` (conv patch embedding without bias, class
token, learned positions, ``pre_layrnorm`` in fp32, quick-GELU pre-LN layers,
``post_layernorm`` on the class token, the visual projection). Parameter names
are the HF ``transformers`` names (``vision_model.encoder.layers.N.self_attn.q_proj.weight``,
``vision_model.pre_layrnorm.weight``, ``visual_projection.weight``), so an HF
state dict loads by name (``convert.import_clip_vision``). Attention runs the
plain path (``attention_xla``), as in JAX: 197 tokens never reach the flash
kernel. Images enter NCHW, as DINOv2's do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.dinov2 import _keys_cubic, _mean_std, _triangle, resize_bhwc
from instantir_tpu_torch.models.layers import LayerNorm32
from instantir_tpu_torch.ops.attention import attention_xla


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    projection_dim: Optional[int] = 512
    hidden_act: str = "quick_gelu"
    eps: float = 1e-5


def clip_vit_b16_config(**overrides) -> CLIPVisionConfig:
    return dataclasses.replace(CLIPVisionConfig(), **overrides)


def tiny_clip_vision_config(**overrides) -> CLIPVisionConfig:
    base = CLIPVisionConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, image_size=32,
                            patch_size=8, projection_dim=8)
    return dataclasses.replace(base, **overrides)


# OpenAI CLIP normalization; inputs in [0, 1]
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@functools.lru_cache(maxsize=None)
def _clip_mean_std(dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP's mean and std in ``dtype`` on ``device``, built once per (dtype,
    device): a copy from host memory cannot be recorded in a CUDA graph.
    Callers do not write to them."""
    return (torch.tensor(CLIP_MEAN, dtype=dtype, device=device),
            torch.tensor(CLIP_STD, dtype=dtype, device=device))


def preprocess_clip(images01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized to ``size``² (antialiased bicubic,
    ``jax.image.resize``'s weights, then clipped to [0, 1]) and
    CLIP-normalized, [B, H, W, 3]."""
    b, h, w, c = images01.shape
    if (h, w) != (size, size):
        images01 = resize_bhwc(images01, size, size, _keys_cubic).clamp(0.0, 1.0)
    mean, std = _clip_mean_std(images01.dtype, images01.device)
    return (images01 - mean) / std


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


class CLIPVisionLayer(nn.Module):
    """Pre-LN block: self-attention (no mask), then the MLP."""

    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.act = cfg.hidden_act
        self.layer_norm1 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)
        self.self_attn = _SelfAttention(c, dtype, device)
        self.layer_norm2 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)
        self.mlp = _MLP(c, cfg.intermediate_size, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)

        def heads(t):
            return t.reshape(b, n, self.heads, c // self.heads)

        attn = attention_xla(heads(a.q_proj(h)), heads(a.k_proj(h)), heads(a.v_proj(h)))
        x = x + a.out_proj(attn.reshape(b, n, c))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp.fc2(h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device):
        super().__init__()
        c = cfg.hidden_size
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))
        self.patch_embedding = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size, bias=False, dtype=dtype,
                                         device=device)
        self.position_embedding = nn.Embedding(n, c, dtype=dtype, device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList([CLIPVisionLayer(cfg, dtype, device) for _ in range(cfg.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype, device, post_norm: bool = True):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype, device)
        self.pre_layrnorm = LayerNorm32(cfg.hidden_size, eps=cfg.eps, dtype=dtype, device=device)  # HF's spelling
        self.encoder = _Encoder(cfg, dtype, device)
        if post_norm:
            self.post_layernorm = LayerNorm32(cfg.hidden_size, eps=cfg.eps, dtype=dtype, device=device)

    def tokens(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, 3, S, S] normalized -> the last layer's tokens [B, N+1, d] (no post-LN)."""
        emb = self.embeddings
        b = pixel_values.shape[0]
        x = emb.patch_embedding(pixel_values.to(dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(b, 1, -1), x], dim=1) + emb.position_embedding.weight[None]
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values [B, 3, S, S] normalized)`` -> (tokens [B, N+1,
    d] before the post-LN, projected post-LN class token [B, proj] or None)."""

    def __init__(self, config: CLIPVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.vision_model = _VisionTransformer(config, dtype, device)
        if config.projection_dim is not None:
            self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False, dtype=dtype,
                                               device=device)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = self.vision_model.tokens(pixel_values, self.dtype)
        pooled = self.vision_model.post_layernorm(x[:, 0])
        proj = self.visual_projection(pooled) if self.config.projection_dim is not None else None
        return x, proj


class CLIPImageEncoder(nn.Module):
    """The CLIP vision tower as the pipeline's image-prompt encoder (the
    reference's ``--use_clip_encoder``), a drop-in for ``DINOv2Model``:
    ``forward`` takes the ImageNet-normalized NCHW pixels the pipeline's
    ``preprocess_dinov2`` gives, re-normalizes them to CLIP's statistics,
    resizes again (antialiased bilinear) only off the config's grid, and
    returns the penultimate layer's hidden states ``[B, N+1, hidden_size]``
    (HF ``hidden_states[-2]``): ``num_layers - 1`` layers, no post-LN, no
    projection. Its parameters are those layers' and the embeddings', under
    the HF names; the last layer, ``post_layernorm`` and
    ``visual_projection`` of a checkpoint are never read."""

    def __init__(self, config: CLIPVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        sub = dataclasses.replace(config, num_layers=config.num_layers - 1, projection_dim=None)
        self.vision_model = _VisionTransformer(sub, dtype, device, post_norm=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = pixel_values.permute(0, 2, 3, 1)
        imagenet_mean, imagenet_std = _mean_std(x.dtype, x.device)
        x01 = x * imagenet_std + imagenet_mean
        if tuple(x01.shape[1:3]) != (cfg.image_size, cfg.image_size):
            x01 = resize_bhwc(x01, cfg.image_size, cfg.image_size, _triangle)
        clip_mean, clip_std = _clip_mean_std(x01.dtype, x01.device)
        return self.vision_model.tokens(((x01 - clip_mean) / clip_std).permute(0, 3, 1, 2), self.dtype)
