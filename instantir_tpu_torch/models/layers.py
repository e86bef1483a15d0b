"""Core layers: LoRA-capable Linear/Conv, fp32 GroupNorm/LayerNorm, time embeddings.

Twin of ``instantir_tpu/models/layers.py``. LoRA is functional: every
LoRA-capable layer computes ``y = base(x) + lora_scale * (alpha/r) * B(A(x))``
with zero-init B, and the caller passes ``lora_scale`` per forward (the
previewer-on and previewer-off UNet passes share one set of weights). The
branch is skipped when ``lora_scale`` is 0. Parameter names are the
diffusers/PEFT state-dict names (``weight``, ``bias``, ``lora_A.weight``,
``lora_B.weight``). Normalisation parameters are fp32 whatever the model dtype.
``merge_lora`` folds the branch into merged weights for a model run with
``lora_scale=0``.

The int8 branches of the JAX ``QuantizableDense`` / ``QuantizableConv``
live in ``LoRALinear`` and ``LoRAConv2d`` (``_Quantizable``):
``quantize_(weight_only)`` deletes the fp ``weight`` and keeps int8 codes and
fp32 per-output-channel scales as buffers. W8A8 (``weight_q``) runs the int8
product of ``ops/quant.py`` and adds the bias in the compute dtype; W8
(``weight_qw``) dequantizes to the compute dtype at each use and runs the
ordinary ``F.linear`` / ``F.conv2d`` (``quant.w8_op``), differentiable in
``x``. The LoRA
branches stay in fp, and ``merge_lora`` leaves a quantized base unmerged.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.ops import quant
from instantir_tpu_torch.ops.group_norm import group_norm_silu


class _Quantizable:
    """The int8 state of a LoRA base layer: ``quant_mode`` is None (fp
    ``weight``), "w8a8" (``weight_q``) or "w8" (``weight_qw``), with fp32
    ``weight_scale [out]`` beside the codes."""

    quant_mode: Optional[str] = None
    tp = None  # the layer's tensor-parallel placement (``parallel.tp.TPShard``), set by ``parallel.tp.tp_shard_``

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the layer computes in: its weight's, or the one it had before ``quantize_``."""
        return self.weight.dtype if self.quant_mode is None else self._compute_dtype

    @torch.no_grad()
    def quantize_(self, weight_only: bool = False) -> None:
        """Replace the fp ``weight`` by its int8 codes and scales (``quant.quantize_weight``)."""
        q, scale = quant.quantize_weight(self.weight)
        self._compute_dtype = self.weight.dtype
        del self.weight
        self.register_buffer("weight_qw" if weight_only else "weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.quant_mode = "w8" if weight_only else "w8a8"


class LoRALinear(_Quantizable, nn.Linear):
    """Linear with an optional low-rank adapter branch (PEFT semantics)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        if lora_rank > 0:
            self.lora_A = nn.Linear(in_features, lora_rank, bias=False, dtype=dtype, device=device)
            self.lora_B = nn.Linear(lora_rank, out_features, bias=False, dtype=dtype, device=device)
            nn.init.zeros_(self.lora_B.weight)

    def product(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """The base layer's output (fp, W8 or W8A8), with or without its bias."""
        b = self.bias if bias else None
        if self.quant_mode is None:
            return F.linear(x, self.weight, b)
        if self.quant_mode == "w8":
            return quant.w8_op(x, self.weight_qw, self.weight_scale, b, self._compute_dtype)
        y = quant.w8a8_dense(x, self.weight_q, self.weight_scale)
        return y if b is None else y + b.to(y.dtype)

    def lora(self, x: torch.Tensor, lora_scale: float) -> torch.Tensor:
        return (lora_scale * self.lora_alpha / self.lora_rank) * self.lora_B(self.lora_A(x))

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.tp is not None:
            return self.tp(self, x, lora_scale)
        y = self.product(x)
        if self.lora_rank > 0 and lora_scale != 0.0:
            y = y + self.lora(x, lora_scale)
        return y


class LoRAConv2d(_Quantizable, nn.Conv2d):
    """NCHW conv with an optional low-rank adapter (A: k x k -> r, B: 1 x 1 -> out)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=bias,
                         dtype=dtype, device=device)
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        if lora_rank > 0:
            self.lora_A = nn.Conv2d(in_channels, lora_rank, kernel_size, stride=stride, padding=padding,
                                    bias=False, dtype=dtype, device=device)
            self.lora_B = nn.Conv2d(lora_rank, out_channels, 1, bias=False, dtype=dtype, device=device)
            nn.init.zeros_(self.lora_B.weight)

    def product(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """The base layer's output (fp, W8 or W8A8), with or without its bias."""
        b = self.bias if bias else None
        if self.quant_mode is None:
            return self._conv_forward(x, self.weight, b)
        if self.quant_mode == "w8":
            return quant.w8_op(x, self.weight_qw, self.weight_scale, b, self._compute_dtype, self.stride[0],
                               self.padding[0])
        y = quant.w8a8_conv(x, self.weight_q, self.weight_scale, self.stride[0], self.padding[0])
        return y if b is None else y + b.to(y.dtype).reshape(1, -1, 1, 1)

    def lora(self, x: torch.Tensor, lora_scale: float) -> torch.Tensor:
        return (lora_scale * self.lora_alpha / self.lora_rank) * self.lora_B(self.lora_A(x))

    def forward(self, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.tp is not None:
            return self.tp(self, x, lora_scale)
        y = self.product(x)
        if self.lora_rank > 0 and lora_scale != 0.0:
            y = y + self.lora(x, lora_scale)
        return y


def merge_lora(model: nn.Module, lora_scale: float) -> Dict[str, torch.Tensor]:
    """Fold every LoRA branch of ``model`` into its base weight, twin of
    ``instantir_tpu/models/layers.py::merge_lora_tree``: ``W + s·(α/r)·B·A``
    for a ``LoRALinear``, and for a ``LoRAConv2d`` the 1×1 ``B`` folded into
    ``A``'s k×k kernel, computed in the weight's own dtype (the coefficient
    rounded to it first, as the JAX version does). Returns ``{parameter
    name: merged weight}`` for the LoRA-bearing layers only: run the model on
    them with ``lora_scale=0`` through ``torch.func.functional_call``, and
    every other parameter is the model's own, by reference. A quantized base
    has no fp weight to merge into and is left out, as the JAX version skips
    one."""
    merged = {}
    for name, m in model.named_modules():
        if isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora_rank > 0 and m.quant_mode is None:
            a, b, w = m.lora_A.weight, m.lora_B.weight, m.weight
            if isinstance(m, LoRALinear):  # b [out, r] @ a [r, in]
                delta = b @ a
            else:  # b [out, r, 1, 1], a [r, in, kh, kw]
                delta = torch.einsum("or,rihw->oihw", b[:, :, 0, 0], a)
            coef = torch.tensor(lora_scale * m.lora_alpha / m.lora_rank, dtype=w.dtype).item()
            merged[f"{name}.weight" if name else "weight"] = w + coef * delta
    return merged


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics in the E[x^2] - mu^2 form (+ optional
    fused SiLU); fp32 ``weight``/``bias``; output in ``dtype``. Whether the
    fused kernel or the plain version runs is ``ops.group_norm.USE_FUSED``,
    for every model's norms, the VAE's included."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, fuse_silu: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps, self.fuse_silu)
        return y.to(self.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 with fp32 parameters; output in ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__(dim, eps=eps, dtype=torch.float32, device=device)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.out_dtype)


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``get_timestep_embedding``), fp32 always."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP on the sinusoidal embedding, with optional ``cond_proj``."""

    def __init__(self, in_channels: int, time_embed_dim: int, cond_proj_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if cond_proj_dim is not None:
            self.cond_proj = nn.Linear(cond_proj_dim, in_channels, bias=False, dtype=dtype, device=device)
        else:
            self.cond_proj = None
        self.linear_1 = nn.Linear(in_channels, time_embed_dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim, dtype=dtype, device=device)

    def forward(self, sample: torch.Tensor, condition: Optional[torch.Tensor] = None) -> torch.Tensor:
        sample = sample.to(self.linear_1.weight.dtype)
        if condition is not None:
            if self.cond_proj is None:
                raise ValueError("condition passed but cond_proj_dim is None")
            sample = sample + self.cond_proj(condition.to(sample.dtype))
        return self.linear_2(F.silu(self.linear_1(sample)))


class AdaLayerNorm(nn.Module):
    """Time-conditioned LayerNorm: ``LN(x)·(1+scale) + shift`` with
    ``(shift, scale) = Linear(SiLU(temb))``; the linear is LoRA-capable.
    Under tensor parallelism (``tp``) it normalises this rank's features of
    a column-parallel projection."""

    tp = None

    def __init__(self, embedding_dim: int, temb_dim: int, lora_rank: int = 0, lora_alpha: float = 1.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.linear = LoRALinear(temb_dim, 2 * embedding_dim, bias=True, lora_rank=lora_rank,
                                 lora_alpha=lora_alpha, dtype=dtype, device=device)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        emb = self.linear(F.silu(temb.to(self.linear.compute_dtype)), lora_scale)
        shift, scale = emb[:, None, :].chunk(2, dim=-1)
        if self.tp is None:
            normed = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)
        else:  # ``x`` holds this rank's features: the statistics are the whole row's, shift and scale its slice
            normed = self.tp.layer_norm(x, 1e-6)
            shift, scale = self.tp.local(shift, -1), self.tp.local(scale, -1)
        return normed * (1.0 + scale) + shift
