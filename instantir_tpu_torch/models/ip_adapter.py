"""Image-projection heads, twin of ``instantir_tpu/models/ip_adapter.py``.

The live InstantIR model projects DINOv2 tokens with the Perceiver
``Resampler``; these are the other IP-adapter heads, for multi-adapter parity:

  * ``ImageProjModel``: linear -> N tokens -> LayerNorm (computed in fp32);
  * ``MLPProjModel``: linear -> exact GELU -> linear -> LayerNorm (fp32);
  * ``MultiImageProjection``: one projector per image-embedding tensor, the
    tokens concatenated.

The LayerNorms take flax's default epsilon, 1e-6.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import LayerNorm32


class ImageProjModel(nn.Module):
    def __init__(self, cross_attention_dim: int = 2048, clip_embeddings_dim: int = 1024,
                 clip_extra_context_tokens: int = 4, dtype=torch.float32, device=None):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.clip_extra_context_tokens = clip_extra_context_tokens
        self.proj = nn.Linear(clip_embeddings_dim, cross_attention_dim * clip_extra_context_tokens, dtype=dtype,
                              device=device)
        self.norm = LayerNorm32(cross_attention_dim, eps=1e-6, dtype=dtype, device=device)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(image_embeds.shape[0], self.clip_extra_context_tokens, self.cross_attention_dim))


class MLPProjModel(nn.Module):
    def __init__(self, cross_attention_dim: int = 2048, clip_embeddings_dim: int = 1024, dtype=torch.float32,
                 device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        self.fc1 = nn.Linear(clip_embeddings_dim, clip_embeddings_dim, **common)
        self.fc2 = nn.Linear(clip_embeddings_dim, cross_attention_dim, **common)
        self.norm = LayerNorm32(cross_attention_dim, eps=1e-6, **common)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.fc2(F.gelu(self.fc1(image_embeds.to(self.fc1.weight.dtype))))
        if x.dim() == 2:
            x = x[:, None, :]
        return self.norm(x)


class MultiImageProjection(nn.Module):
    """Applies ``projectors[i]`` to ``image_embeds_list[i]`` and concatenates
    the tokens (``image_projection_layers``, as diffusers names them)."""

    def __init__(self, projectors: Sequence[nn.Module]):
        super().__init__()
        self.image_projection_layers = nn.ModuleList(projectors)

    def __len__(self) -> int:
        return len(self.image_projection_layers)

    def forward(self, image_embeds_list: Sequence[torch.Tensor], **kwargs) -> torch.Tensor:
        if len(image_embeds_list) != len(self.image_projection_layers):
            raise ValueError(f"got {len(image_embeds_list)} image-embedding tensors for "
                             f"{len(self.image_projection_layers)} projectors")
        return torch.cat([proj(emb, **kwargs) for proj, emb in zip(self.image_projection_layers, image_embeds_list)],
                         dim=1)
