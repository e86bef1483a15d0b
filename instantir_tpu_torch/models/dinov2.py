"""DINOv2 vision transformer -- the LQ-image encoder of the adapter.

Twin of ``instantir_tpu/models/dinov2.py``: facebook/dinov2-large (patch-14
conv embed, CLS token, learned position embeddings, 24 pre-LN blocks with
LayerScale, exact-GELU MLP, final LayerNorm); returns ``last_hidden_state``.
Parameter names are the HF ``transformers`` names. Attention runs the plain
path (257 tokens). A patch grid other than the native one gets the position
embeddings resized bicubically, as ``jax.image.resize(method="cubic")`` does
(the trainers feed 224² pixels whatever ``image_size`` is).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import LayerNorm32
from instantir_tpu_torch.ops.attention import attention_xla


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 224  # position-embedding native grid
    eps: float = 1e-6


def dinov2_large_config(**overrides) -> DINOv2Config:
    return dataclasses.replace(DINOv2Config(), **overrides)


def tiny_dinov2_config(**overrides) -> DINOv2Config:
    base = DINOv2Config(hidden_size=16, num_layers=2, num_heads=2, patch_size=14, image_size=28)
    return dataclasses.replace(base, **overrides)


class _SelfAttention(nn.Module):
    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.query = nn.Linear(c, c, dtype=dtype, device=device)
        self.key = nn.Linear(c, c, dtype=dtype, device=device)
        self.value = nn.Linear(c, c, dtype=dtype, device=device)


class _Output(nn.Module):
    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.dense = nn.Linear(c, c, dtype=dtype, device=device)


class _AttentionBlock(nn.Module):
    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.attention = _SelfAttention(c, dtype, device)
        self.output = _Output(c, dtype, device)


class _LayerScale(nn.Module):
    def __init__(self, c: int, dtype, device):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((c,), 1e-5, dtype=dtype, device=device))


class _MLP(nn.Module):
    def __init__(self, c: int, hidden: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, c, dtype=dtype, device=device)


class DINOv2Block(nn.Module):
    def __init__(self, cfg: DINOv2Config, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)
        self.attention = _AttentionBlock(c, dtype, device)
        self.layer_scale1 = _LayerScale(c, dtype, device)
        self.norm2 = LayerNorm32(c, eps=cfg.eps, dtype=dtype, device=device)
        self.mlp = _MLP(c, c * cfg.mlp_ratio, dtype, device)
        self.layer_scale2 = _LayerScale(c, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.norm1(x)
        sa = self.attention.attention

        def heads(t):
            return t.reshape(b, n, self.num_heads, c // self.num_heads)

        attn = attention_xla(heads(sa.query(h)), heads(sa.key(h)), heads(sa.value(h))).reshape(b, n, c)
        x = x + self.layer_scale1.lambda1 * self.attention.output.dense(attn)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + self.layer_scale2.lambda1 * h


class _Embeddings(nn.Module):
    def __init__(self, cfg: DINOv2Config, dtype, device):
        super().__init__()
        c = cfg.hidden_size
        native = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c, dtype=dtype, device=device))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + native * native, c, dtype=dtype, device=device))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size, dtype=dtype,
                                                     device=device)


class _Encoder(nn.Module):
    def __init__(self, cfg: DINOv2Config, dtype, device):
        super().__init__()
        self.layer = nn.ModuleList([DINOv2Block(cfg, dtype, device) for _ in range(cfg.num_layers)])


class DINOv2Model(nn.Module):
    def __init__(self, config: DINOv2Config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = _Embeddings(config, dtype, device)
        self.encoder = _Encoder(config, dtype, device)
        self.layernorm = LayerNorm32(config.hidden_size, eps=config.eps, dtype=dtype, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: [B, 3, H, W] (normalized) -> last_hidden_state [B, 1+N, C]."""
        cfg = self.config
        b, _, h, w = pixel_values.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        native = cfg.image_size // cfg.patch_size
        emb = self.embeddings
        x = emb.patch_embeddings.projection(pixel_values.to(self.dtype)).flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.expand(b, 1, -1), x], dim=1)
        pos = emb.position_embeddings.float()
        if (gh, gw) != (native, native):
            grid = pos[0, 1:].reshape(native, native, -1)
            wy = _resize_weights(native, gh, _keys_cubic, pos.device)
            wx = _resize_weights(native, gw, _keys_cubic, pos.device)
            grid = torch.einsum("pw,hwc->hpc", wx, torch.einsum("oh,hwc->owc", wy, grid))
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)
        x = x + pos.to(self.dtype)
        for block in self.encoder.layer:
            x = block(x)
        return self.layernorm(x)


# ImageNet normalization used by the DINOv2 processor.
DINOV2_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
DINOV2_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s "cubic";
    ``F.interpolate(mode="bicubic")`` uses a = -0.75 and no antialiasing)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_matrix(in_size: int, out_size: int, kernel: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """[out, in] weights of ``jax.image.resize`` along one axis for a kernel
    (``_triangle``: "linear"; ``_keys_cubic``: "cubic"): half-pixel centres,
    the kernel widened by the scale when downsampling (antialiasing), each row
    normalised to sum 1, which drops the taps that fall outside the input."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, weights / np.where(total == 0, 1, total), 0)
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, kernel: Callable[[np.ndarray], np.ndarray],
                    device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` on ``device``, built and copied there once per
    (sizes, kernel, device): a training step resizes every batch, and each
    copy from host memory would stall the stream. Callers do not write to it."""
    return torch.from_numpy(_resize_matrix(in_size, out_size, kernel)).to(device)


@functools.lru_cache(maxsize=None)
def _mean_std(dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std in ``dtype`` on ``device``, built once per
    (dtype, device) as ``_resize_weights`` is. Callers do not write to them."""
    return (torch.tensor(DINOV2_MEAN, dtype=dtype, device=device),
            torch.tensor(DINOV2_STD, dtype=dtype, device=device))


def resize_bhwc(images: torch.Tensor, out_h: int, out_w: int,
                kernel: Callable[[np.ndarray], np.ndarray] = _triangle) -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, C] with ``jax.image.resize``'s
    weights for ``kernel`` (``_triangle``: "bilinear", ``_keys_cubic``:
    "bicubic"; antialiased when downsampling), summed in fp32 and returned
    in the input's dtype."""
    _, h, w, _ = images.shape
    wy = _resize_weights(h, out_h, kernel, images.device)
    wx = _resize_weights(w, out_w, kernel, images.device)
    out = torch.einsum("oh,bhwc->bowc", wy, images.float())
    return torch.einsum("pw,bowc->bopc", wx, out).to(images.dtype)


def preprocess_dinov2(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized to ``size``² (antialiased bilinear,
    ``resize_bhwc``) and ImageNet-normalized in the input's dtype, [B, H, W, 3]."""
    b, h, w, c = images.shape
    if (h, w) != (size, size):
        images = resize_bhwc(images, size, size, _triangle)
    mean, std = _mean_std(images.dtype, images.device)
    return (images - mean) / std
