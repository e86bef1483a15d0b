"""ArcFace IR-SE50 face-recognition backbone for IDLoss.

Twin of ``instantir_tpu/losses/arcface.py``: the InsightFace IR-SE-50 that
``model_ir_se50.pth`` targets, a 3×3 stem, four stages of bottleneck-IR-SE
units ([3, 4, 14, 3] at depths [64, 128, 256, 512], stride 2 at each stage
entry), and a BN -> flatten -> Linear(512·7·7 -> 512) -> BN head whose output
is L2-normalized. Inference only: each BatchNorm is held as its folded
per-channel affine (``scale``, ``bias``); ``import_arcface`` folds a
checkpoint's running statistics on load. Module names are InsightFace's
(``input_layer.0``, ``body.{i}.res_layer.{0..5}``, ``body.{i}.shortcut_layer.{0,1}``,
``output_layer.{0,3,4}``). The head flattens NCHW, the published layout, so
``output_layer.3.weight`` loads as it is (the JAX module flattens NHWC and
permutes that Linear instead).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig:
    input_size: int = 112
    stem_channels: int = 64
    # (depth, num_units) per stage: IR-50
    stages: Tuple[Tuple[int, int], ...] = ((64, 3), (128, 4), (256, 14), (512, 3))
    embedding_dim: int = 512
    se_reduction: int = 16


def ir_se_50_config() -> ArcFaceConfig:
    return ArcFaceConfig()


def tiny_arcface_config() -> ArcFaceConfig:
    return ArcFaceConfig(input_size=16, stem_channels=4, stages=((4, 1), (8, 2)), embedding_dim=8, se_reduction=2)


class Affine(nn.Module):
    """A folded inference BatchNorm: per-channel ``scale·x + bias`` over dim 1."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * self.scale.to(x.dtype).reshape(shape) + self.bias.to(x.dtype).reshape(shape)


class _SE(nn.Module):
    def __init__(self, depth: int, reduction: int, dtype, device):
        super().__init__()
        self.fc1 = nn.Conv2d(depth, depth // reduction, 1, bias=False, dtype=dtype, device=device)
        self.fc2 = nn.Conv2d(depth // reduction, depth, 1, bias=False, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        se = self.fc2(F.relu(self.fc1(h.mean(dim=(2, 3), keepdim=True))))
        return h * torch.sigmoid(se)


class BottleneckIRSE(nn.Module):
    def __init__(self, in_channels: int, depth: int, stride: int, se_reduction: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stride = stride
        self.res_layer = nn.ModuleDict({
            "0": Affine(in_channels, dtype, device),
            "1": nn.Conv2d(in_channels, depth, 3, padding=1, bias=False, dtype=dtype, device=device),
            "2": nn.PReLU(depth, dtype=dtype, device=device),
            "3": nn.Conv2d(depth, depth, 3, stride=stride, padding=1, bias=False, dtype=dtype, device=device),
            "4": Affine(depth, dtype, device),
            "5": _SE(depth, se_reduction, dtype, device),
        })
        if in_channels != depth:
            self.shortcut_layer = nn.ModuleDict({
                "0": nn.Conv2d(in_channels, depth, 1, stride=stride, bias=False, dtype=dtype, device=device),
                "1": Affine(depth, dtype, device),
            })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "shortcut_layer"):
            shortcut = self.shortcut_layer["1"](self.shortcut_layer["0"](x))
        else:  # torch MaxPool2d(kernel 1, stride): a strided subsample
            shortcut = x[:, :, ::self.stride, ::self.stride]
        h = x
        for layer in self.res_layer.values():
            h = layer(h)
        return h + shortcut


class ArcFaceBackbone(nn.Module):
    """[B, S, S, 3] in [-1, 1] -> L2-normalized embeddings [B, embedding_dim] (fp32)."""

    def __init__(self, config: ArcFaceConfig = ArcFaceConfig(), dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.input_layer = nn.ModuleDict({
            "0": nn.Conv2d(3, cfg.stem_channels, 3, padding=1, bias=False, dtype=dtype, device=device),
            "1": Affine(cfg.stem_channels, dtype, device),
            "2": nn.PReLU(cfg.stem_channels, dtype=dtype, device=device),
        })
        blocks, in_ch = [], cfg.stem_channels
        for depth, n_units in cfg.stages:
            for u in range(n_units):
                blocks.append(BottleneckIRSE(in_ch, depth, 2 if u == 0 else 1, cfg.se_reduction, dtype, device))
                in_ch = depth
        self.body = nn.ModuleList(blocks)
        spatial = cfg.input_size // (2 ** len(cfg.stages))
        self.output_layer = nn.ModuleDict({
            "0": Affine(in_ch, dtype, device),
            "3": nn.Linear(in_ch * spatial * spatial, cfg.embedding_dim, dtype=dtype, device=device),
            "4": Affine(cfg.embedding_dim, dtype, device),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        for layer in self.input_layer.values():
            h = layer(h)
        for block in self.body:
            h = block(h)
        out = self.output_layer
        h = out["4"](out["3"](out["0"](h).flatten(1))).float()
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


def fold_bn(sd: Dict[str, torch.Tensor], prefix: str, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A BatchNorm's weight, bias and running statistics -> its ``Affine``'s
    scale and bias (fp32 numpy arithmetic, as the JAX converter folds)."""
    def a(k):
        return torch.as_tensor(sd[f"{prefix}.{k}"]).detach().float().cpu().numpy()

    scale = a("weight") / np.sqrt(a("running_var") + eps)
    return {f"{prefix}.scale": torch.from_numpy(scale),
            f"{prefix}.bias": torch.from_numpy(a("bias") - a("running_mean") * scale)}


def import_arcface(sd: Dict[str, torch.Tensor], model: ArcFaceBackbone) -> Dict[str, torch.Tensor]:
    """An InsightFace ``model_ir_se50.pth`` state dict -> ``model``'s state
    dict: every ``Affine`` from its BatchNorm folded, every other parameter
    by name. A tensor the model needs and ``sd`` lacks raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    for name, m in model.named_modules():
        if isinstance(m, Affine):
            out.update(fold_bn(sd, name))
    for name, _ in model.named_parameters():
        if name not in out:
            out[name] = torch.as_tensor(sd[name]).float()
    return out
