"""int8 weights for the UNet and the Aggregator: W8A8 and weight-only W8.

Twin of ``instantir_tpu/ops/quant.py``, in the port's layouts (weights
``[out, in]`` and ``[out, in, kh, kw]``, activations NCHW):

* ``quantize_weight`` -- symmetric per-output-channel int8: the fp32 absmax
  over every axis but the output one, ``max(absmax, 1e-8) / 127``, round half
  to even, clip to ±127;
* ``dequantize_weight`` -- the codes times their scales, in a compute dtype;
  ``w8_op`` runs the W8 layer: the ordinary fp op on the dequantized weight,
  differentiable in ``x``, its backward dequantizing again rather than
  keeping the dequantized weight;
* ``w8a8_dense`` / ``w8a8_conv`` -- dynamic symmetric activation
  quantization (per token for a matmul, per sample for a convolution, whose
  spatial mixing keeps only a scale constant over the receptive field), an
  int8 x int8 -> int32 product, then ``(y.float() * xs * ks).to(x.dtype)``;
* ``quantize_tree`` -- the walk over a model's modules that quantizes every
  LoRA base weight of at least ``min_size`` values in place (the fp weight is
  deleted, int8 codes and fp32 scales become buffers);
* ``quantized_bytes`` -- (int8 weight bytes, every parameter and buffer byte).

The int8 products are ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card,
exact in int32 like XLA's int8 dot). On CUDA it takes more than 16 rows and
an inner and an output size that are multiples of 8: ``int_mm`` pads with zero
rows and columns, which quantize to 0 and leave the product exact. PyTorch has
no int8 convolution on CUDA, so ``w8a8_conv`` unfolds the activation codes
(carried exactly in bf16: integers of at most 127 in magnitude), casts them
back to int8 and multiplies, a few samples at a time so that the unfolded
codes stay bounded (``UNFOLD_LIMIT``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Below this many values a weight stays in fp: small layers do not pay for the
# quantize/dequantize passes, and the 4-channel conv_in/conv_out fall under it.
DEFAULT_MIN_SIZE = 65536
# unfolded int8 codes of one w8a8_conv chunk (values): 128 MB, about 2.7
# samples of the 1024² UNet's 320-channel 3x3 convolutions
UNFOLD_LIMIT = 1 << 27


def _per_out(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(-1, *([1] * (ndim - 1)))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight ``[out, ...]`` -> (int8 codes of its shape, fp32 scales ``[out]``)."""
    wf = w.detach().float()
    absmax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    scale = absmax.clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / _per_out(scale, wf.dim())), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 codes ``[out, ...]`` times fp32 scales ``[out]``, in ``dtype``:
    the fp32 product rounded once to ``dtype``, as the JAX twin computes it,
    in one pass (the product is computed in fp32 and stored in ``dtype``: 3
    bytes a value moved, where ``.float()``, the product and ``.to(dtype)``
    as three ops move 19)."""
    return torch.mul(q, _per_out(scale, q.dim()), out=torch.empty(q.shape, dtype=dtype, device=q.device))


class _W8(torch.autograd.Function):
    """``F.linear`` / ``F.conv2d`` on the weight dequantized to ``dtype``
    (the W8 path). It saves the int8 codes and scales for the backward and
    dequantizes again there, where autograd would keep each layer's
    dequantized weight alive from the forward to the backward: a whole second
    bf16 copy of the quantized model in a training step. The gradient flows
    to ``x`` (and to ``bias`` when it needs one), not to the frozen codes."""

    @staticmethod
    def forward(ctx, x, q, scale, bias, dtype, stride, padding):
        w = dequantize_weight(q, scale, dtype)
        ctx.save_for_backward(q, scale)
        ctx.meta = (dtype, stride, padding, x.shape)
        return F.linear(x, w, bias) if q.dim() == 2 else F.conv2d(x, w, bias, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        q, scale = ctx.saved_tensors
        dtype, stride, padding, shape = ctx.meta
        gx = gb = None
        if ctx.needs_input_grad[0]:
            w = dequantize_weight(q, scale, dtype)
            gx = gy @ w if q.dim() == 2 else torch.nn.grad.conv2d_input(shape, w, gy, stride, padding)
        if ctx.needs_input_grad[3]:
            gb = gy.sum(dim=tuple(range(gy.dim() - 1)) if q.dim() == 2 else (0, 2, 3))
        return gx, None, None, gb, None, None, None


def w8_op(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype,
          stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The W8 layer: ``x`` in ``dtype`` through the weight ``q`` (``[out, in]``
    or OIHW) dequantized to ``dtype``, plus ``bias`` (``_W8``)."""
    return _W8.apply(x, q, scale, bias, dtype, stride, padding)


def _quant_act(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes as fp32 integers in [-127, 127], fp32 scales kept over ``dims``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=dims, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0), scale


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``a [M, K]`` times int8 ``w [N, K]`` transposed -> int32 ``[M, N]``,
    exact. On CUDA the operands are padded with zeros to what cuBLASLt's int8
    GEMM takes (M > 16; K, N multiples of 8) and the padding is dropped."""
    m, n = a.shape[0], w.shape[0]
    if a.is_cuda:
        pad_k = -a.shape[1] % 8
        if pad_k:
            a, w = F.pad(a, (0, pad_k)), F.pad(w, (0, pad_k))
        pad_n = -n % 8
        if pad_n:
            w = F.pad(w, (0, 0, 0, pad_n))
        if m <= 16:
            a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    y = torch._int_mm(a, w.t())
    return y[:m, :n] if y.shape != (m, n) else y


def w8a8_dense(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """``x [..., in]`` times int8 ``wq [out, in]`` with per-token activation
    scales, which factor out of the contraction: ``y = (xq·wqᵀ) ⊙ xs ⊙ ws``.
    Output in ``x.dtype``."""
    codes, xs = _quant_act(x, -1)
    y = int_mm(codes.to(torch.int8).reshape(-1, x.shape[-1]), wq)
    y = y.reshape(*x.shape[:-1], wq.shape[0])
    return (y.float() * xs * wscale).to(x.dtype)


def conv_int32(codes: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The exact int32 product of ``w8a8_conv``: activation codes ``[B, C, H,
    W]`` (integers in [-127, 127], in any float dtype) convolved with the int8
    OIHW ``wq`` by unfolding, ``UNFOLD_LIMIT`` unfolded codes at a time ->
    int32 ``[B, Ho·Wo, out]``."""
    codes = codes.to(torch.bfloat16)  # exact: integers of at most 127 in magnitude
    out, cin, kh, kw = wq.shape
    w2 = wq.reshape(out, cin * kh * kw)
    ho = (codes.shape[2] + 2 * padding - kh) // stride + 1
    wo = (codes.shape[3] + 2 * padding - kw) // stride + 1
    per = max(1, UNFOLD_LIMIT // (ho * wo * w2.shape[1]))
    ys = []
    for i in range(0, codes.shape[0], per):
        cols = F.unfold(codes[i:i + per], (kh, kw), padding=padding, stride=stride)  # [n, C·kh·kw, L]
        n = cols.shape[0]
        a = torch.empty((n, ho * wo, w2.shape[1]), dtype=torch.int8, device=codes.device)
        a.copy_(cols.transpose(1, 2))
        ys.append(int_mm(a.reshape(n * ho * wo, -1), w2).reshape(n, ho * wo, out))
    return torch.cat(ys) if len(ys) > 1 else ys[0]


def w8a8_conv(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NCHW convolution with the int8 OIHW ``wq`` and per-sample activation
    scales (zero padding quantizes to 0). Output in ``x.dtype``."""
    codes, xs = _quant_act(x, (1, 2, 3))
    b, out = x.shape[0], wq.shape[0]
    y = conv_int32(codes, wq, stride, padding)
    y = (y.float() * xs.reshape(b, 1, 1) * wscale).to(x.dtype)
    ho = (x.shape[2] + 2 * padding - wq.shape[2]) // stride + 1
    return y.permute(0, 2, 1).reshape(b, out, ho, -1)


def _lora_bases(model: nn.Module):
    from instantir_tpu_torch.models.layers import LoRAConv2d, LoRALinear

    return [(name, m) for name, m in model.named_modules() if isinstance(m, (LoRALinear, LoRAConv2d))]


def quantize_tree(model: nn.Module, min_size: Optional[int] = None, weight_only: bool = False,
                  exclude: Optional[Callable[[Tuple[str, ...]], bool]] = None) -> nn.Module:
    """Quantize, in place, the base weight of every ``LoRALinear`` /
    ``LoRAConv2d`` of ``model`` with at least ``min_size`` values (default
    ``DEFAULT_MIN_SIZE``, read at call time) whose module path (its name split
    at the dots) ``exclude`` does not take: W8A8 (``weight_q``), or W8
    (``weight_qw``) with ``weight_only``; the scales are ``weight_scale``. The
    LoRA branches, norms, time embeddings and smaller weights stay in fp. A
    base quantized already is left as it is. Returns ``model``."""
    if min_size is None:
        min_size = DEFAULT_MIN_SIZE
    for name, m in _lora_bases(model):
        if m.quant_mode is not None or m.weight.dim() not in (2, 4) or m.weight.numel() < min_size:
            continue
        if exclude is not None and exclude(tuple(name.split(".")) if name else ()):
            continue
        m.quantize_(weight_only)
    return model


def quantize_like(model: nn.Module, state_dict) -> None:
    """Quantize each base of ``model`` that ``state_dict`` holds int8 codes for
    (``<name>.weight_q`` or ``<name>.weight_qw``), in that mode, so that the
    state dict then loads strictly."""
    for name, m in _lora_bases(model):
        prefix = f"{name}." if name else ""
        for key, weight_only in (("weight_q", False), ("weight_qw", True)):
            if prefix + key in state_dict and m.quant_mode is None:
                m.quantize_(weight_only)


def quant_mode(model: nn.Module) -> Optional[str]:
    """"w8a8" or "w8" when some base of ``model`` is quantized, else None."""
    return next((m.quant_mode for _, m in _lora_bases(model) if m.quant_mode is not None), None)


def quantized_bytes(model: nn.Module) -> Tuple[int, int]:
    """(bytes of the int8 weight codes, bytes of every parameter and buffer)."""
    q = sum(t.numel() for n, t in model.named_buffers() if n.rsplit(".", 1)[-1] in ("weight_q", "weight_qw"))
    total = sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
    return q, total
