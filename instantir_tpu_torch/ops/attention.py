"""Attention ops: the hand-written Hopper flash-attention forward + the plain path.

Twin of ``instantir_tpu/ops/attention.py``. Layout convention: ``[batch, seq,
heads, head_dim]`` (BSHD) at every public function, as in the JAX package.

* ``attention_xla`` -- the plain path: fp32 logits and softmax, probabilities
  rounded to the V dtype before P·V (the JAX reference path's semantics).
* ``flash_attention`` -- the wrapper of ``csrc/flash_fwd.cu``, the port of the
  Pallas kernel ``flash_attention``. On a CUDA tensor it launches the kernel or
  raises; only a tensor on the CPU takes the plain version,
  ``flash_attention_reference``.
* ``dot_product_attention`` -- the dispatch rule of the JAX package: a
  self-attention with no bias, kv >= 512 and q >= 128 on the accelerator goes
  to the flash kernel; everything else goes to ``attention_xla``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LOG2E = 1.4426950408889634

# Launches of the flash kernel in this process (bumped only where it launches).
flash_attention_launches = 0


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention, fp32 softmax. q/k/v: [B, S, H, D] -> [B, Sq, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """Plain-PyTorch version of the flash kernel: the same blocked online
    softmax with the same rounding points (q pre-scaled by scale·log2e in fp32
    and rounded to its dtype; fp32 scores, max and sum with exp2; P rounded to
    the V dtype before P·V; fp32 accumulation; O = acc / l in the input dtype).
    A ragged last K/V block is simply shorter. q/k/v: [B, S, H, D]."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    qf = qs.permute(0, 2, 1, 3).float()  # [B, H, Sq, D]
    kf = k.permute(0, 2, 1, 3)
    vf = v.permute(0, 2, 1, 3)
    b, h, sq, _ = qf.shape
    m = torch.full((b, h, sq, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, kf.shape[2], block_k):
        kb = kf[:, :, j0 : j0 + block_k].float()
        vb = vf[:, :, j0 : j0 + block_k]
        s = torch.matmul(qf, kb.transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


_flash_fn = None


def _flash_kernel():
    global _flash_fn
    if _flash_fn is None:
        from instantir_tpu_torch import kernels

        fn = kernels.load("flash_fwd").instantir_flash_fwd_bf16_d64
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _flash_fn = fn
    return _flash_fn


def _check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: q/k/v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: the kernel takes bfloat16 only, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q/k/v must be [B, S, H, D]")
    b, sq, h, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention: the kernel takes head_dim 64 only, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash_attention: shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    if b * h > 65535:
        raise ValueError(f"flash_attention: batch*heads {b * h} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention. q/k/v: [B, S, H, D] -> [B, Sq, H, D].

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` (bf16, head_dim 64;
    anything else raises). On CPU tensors it runs ``flash_attention_reference``.
    """
    global flash_attention_launches
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention: q is on the CPU but k/v are not")
        return flash_attention_reference(q, k, v, scale)
    _check_flash_inputs(q, k, v)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    fn = _flash_kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()), ctypes.c_void_p(v.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), b, h, sq, k.shape[1], ctypes.c_float(scale * LOG2E),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError_t {err}")
    flash_attention_launches += 1
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Dispatching attention: the flash kernel on CUDA for long self-attention
    (the JAX package's rule, with "on TPU" read as "on a CUDA tensor"),
    ``attention_xla`` for everything else."""
    if use_flash and bias is None and q.is_cuda and k.shape[1] >= 512 and q.shape[1] >= 128:
        return flash_attention(q, k, v, scale=q.shape[-1] ** -0.5 if scale is None else scale)
    return attention_xla(q, k, v, scale=scale, bias=bias)
