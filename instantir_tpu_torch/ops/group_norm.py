"""GroupNorm(+SiLU) with fp32 statistics: the fused Triton kernel and the plain version.

Twin of ``instantir_tpu/ops/group_norm.py``. Statistics use the
E[x^2] - mu^2 form clamped at 0 -- not ``F.group_norm``'s variance -- so the
port rounds where the JAX package does.

* ``group_norm_silu_nchw`` -- the plain version (twin of
  ``group_norm_silu_reference``, channels first).
* ``group_norm_silu_fused`` -- the wrapper of the Triton kernels below, the
  port of the Pallas function ``group_norm_silu_pallas``. On a CUDA tensor it
  launches them or raises; only a tensor on the CPU takes the plain version.
* ``group_norm_silu_diff`` -- the ``torch.autograd.Function`` around it (twin
  of ``_gn_silu_diff``): backward differentiates the plain formula and saves
  x, not the fp32 intermediates.
* ``group_norm_silu`` -- the dispatch ``GroupNorm32`` calls, governed by the
  module-level setting ``USE_FUSED``.

Why Triton and not CUDA C++ here: the function is a reduction followed by a
fused elementwise pass with no matrix product, which Triton compiles to the
same coalesced 16-byte loads, warp reductions and ``ex2`` a hand-written CUDA
kernel would use. What bounds it on the H100 is bytes: x is read (twice: once
for the statistics, once to normalise; the second read of a UNet-sized
activation comes from the 50 MB L2 when it fits) and y written once, against
a few operations per element; the design keeps every intermediate (fp32 copy,
centred copy, pre-activation) out of device memory and reads and writes the
model dtype.

The tensors are NCHW, so one (batch, group) is a contiguous slab of
``C/G * H*W`` elements. Two kernels, like the Pallas function: partial fp32
sums of x and x^2 per (batch, group, split), then ``y = x*w + b`` (+SiLU) in
x's dtype per (batch, channel, block), where each program of the second kernel
folds the tiny group arithmetic (mean, clamped variance, rstd, per-channel
``w = rstd*gamma``, ``b = beta - mean*w``) from the partials itself, so no
torch op sits between the two launches. Any H*W is taken: tails are masked.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The port's counterpart of the JAX package's INSTANTIR_PALLAS_GN switch: True
# sends every GroupNorm32 on a half-precision CUDA tensor through the fused
# Triton kernel, False through the plain version. On by default from the H100
# measurements of chip_smoke.py (PERF.md): per call the kernel takes 2-10x less
# time than the plain version at every UNet shape; the difference that makes
# to a whole restore (a few percent) is inside the host's run-to-run spread.
USE_FUSED = True

# Launches of the fused kernel pair in this process (bumped only where it launches).
group_norm_launches = 0

_STATS_BLOCK = 2048
_NORM_BLOCK = 2048
_MAX_SPLITS = 64


def group_norm_silu_nchw(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float, apply_silu: bool
) -> torch.Tensor:
    """GroupNorm over channels-first ``[B, C, *spatial]`` input; returns x.dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    mean_sq = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((mean_sq - mean * mean).clamp(min=0.0) + eps)
    y = ((xf - mean) * inv).reshape(x.shape)
    affine_shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(affine_shape) + bias.float().reshape(affine_shape)
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_silu_reference(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float, apply_silu: bool
) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` in and out, like the JAX function."""
    y = group_norm_silu_nchw(x.permute(0, 3, 1, 2), scale, bias, num_groups, eps, apply_silu)
    return y.permute(0, 2, 3, 1)


_triton_kernels = None


def _kernels():
    """The two ``@triton.jit`` kernels, defined at first use: ``triton`` is
    imported here and nowhere at module level, so the module imports where
    Triton is absent."""
    global _triton_kernels, triton, tl
    if _triton_kernels is not None:
        return _triton_kernels
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats_kernel(x_ptr, part_ptr, n, split_size, nsplit, BLOCK: tl.constexpr):
        # program (bg, split): fp32 sum and sum of squares of one split of the
        # contiguous (batch, group) slab of n elements
        bg = tl.program_id(0)
        split = tl.program_id(1)
        base = bg.to(tl.int64) * n
        start = split * split_size
        acc_s = tl.zeros([BLOCK], dtype=tl.float32)
        acc_q = tl.zeros([BLOCK], dtype=tl.float32)
        for i in range(0, split_size, BLOCK):
            offs = start + i + tl.arange(0, BLOCK)
            x = tl.load(x_ptr + base + offs, mask=offs < n, other=0.0).to(tl.float32)
            acc_s += x
            acc_q += x * x
        out = (bg * nsplit + split) * 2
        tl.store(part_ptr + out, tl.sum(acc_s, axis=0))
        tl.store(part_ptr + out + 1, tl.sum(acc_q, axis=0))

    @triton.jit
    def gn_norm_kernel(x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, hw, cpg, channels, n, nsplit, eps,
                       APPLY_SILU: tl.constexpr, SPLITS_P2: tl.constexpr, BLOCK: tl.constexpr):
        # program (b*C + c, block): the group statistics from the partials,
        # folded into this channel's w and b, then y = x*w + b (+SiLU)
        bc = tl.program_id(0)
        blk = tl.program_id(1)
        c = bc % channels
        bg = bc // cpg  # = b*G + c // cpg, because C = G*cpg
        idx = tl.arange(0, SPLITS_P2)
        pmask = idx < nsplit
        s = tl.sum(tl.load(part_ptr + (bg * nsplit + idx) * 2, mask=pmask, other=0.0), axis=0)
        q = tl.sum(tl.load(part_ptr + (bg * nsplit + idx) * 2 + 1, mask=pmask, other=0.0), axis=0)
        mean = s / n
        var = tl.maximum(q / n - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = rstd * tl.load(w_ptr + c).to(tl.float32)
        b = tl.load(b_ptr + c).to(tl.float32) - mean * w
        offs = blk * BLOCK + tl.arange(0, BLOCK)
        mask = offs < hw
        base = bc.to(tl.int64) * hw
        x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        y = x * w + b
        if APPLY_SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    _triton_kernels = (triton, gn_stats_kernel, gn_norm_kernel)
    return _triton_kernels


def _check_gn_inputs(x, scale, bias, num_groups) -> None:
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"group_norm_silu_fused: x must be bfloat16, float16 or float32, got {x.dtype}")
    if x.dim() < 3:
        raise ValueError(f"group_norm_silu_fused: x must be [B, C, *spatial], got {tuple(x.shape)}")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"group_norm_silu_fused: {c} channels do not divide into {num_groups} groups")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu_fused: x must be contiguous (NCHW)")
    if x.numel() == 0:
        raise ValueError("group_norm_silu_fused: empty input")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"group_norm_silu_fused: {name} must be a contiguous [{c}] tensor on {x.device}")
    if x.shape[0] * c > 2**31 - 1:
        raise ValueError("group_norm_silu_fused: batch*channels exceeds the grid limit")


def group_norm_silu_fused(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """Fused GroupNorm(+SiLU) over channels-first ``[B, C, *spatial]``, output
    in x's dtype. CUDA tensors launch the Triton kernels or raise; CPU tensors
    run ``group_norm_silu_nchw``. Not differentiable: ``group_norm_silu_diff`` is."""
    global group_norm_launches
    if not x.is_cuda:
        return group_norm_silu_nchw(x, scale, bias, num_groups, eps, apply_silu)
    _check_gn_inputs(x, scale, bias, num_groups)
    triton, stats_kernel, norm_kernel = _kernels()
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    cpg = c // num_groups
    n = cpg * hw
    nsplit = max(1, min(_MAX_SPLITS, triton.cdiv(n, 4 * _STATS_BLOCK)))
    split_size = triton.cdiv(triton.cdiv(n, nsplit), _STATS_BLOCK) * _STATS_BLOCK
    partials = torch.empty((b * num_groups, nsplit, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stats_kernel[(b * num_groups, nsplit)](x, partials, n, split_size, nsplit, BLOCK=_STATS_BLOCK, num_warps=8)
        norm_kernel[(b * c, triton.cdiv(hw, _NORM_BLOCK))](
            x, y, scale, bias, partials, hw, cpg, c, n, nsplit, eps,
            APPLY_SILU=apply_silu, SPLITS_P2=max(16, triton.next_power_of_2(nsplit)), BLOCK=_NORM_BLOCK, num_warps=8)
    group_norm_launches += 1
    return y


class _GroupNormSiluDiff(torch.autograd.Function):
    """Differentiable fused GroupNorm(+SiLU), the twin of ``_gn_silu_diff``:
    the forward is the kernel, the backward differentiates the plain formula
    (``group_norm_silu_nchw``) on the saved x."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        return group_norm_silu_fused(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
            y = group_norm_silu_nchw(*inputs, *ctx.args)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*[next(grads) if need else None for need in needs], None, None, None)


def group_norm_silu_diff(x, scale, bias, num_groups: int, eps: float = 1e-5, apply_silu: bool = False):
    """``group_norm_silu_fused`` with a gradient."""
    return _GroupNormSiluDiff.apply(x, scale, bias, num_groups, eps, apply_silu)


def group_norm_silu(x, scale, bias, num_groups: int, eps: float = 1e-5, apply_silu: bool = False):
    """Dispatching GroupNorm(+SiLU) over ``[B, C, *spatial]``: with
    ``USE_FUSED`` on, the fused kernel (through its autograd Function) for
    everything but fp32 tensors on the card -- the fp32 VAE keeps the plain
    path, as in the JAX package; with it off, the plain version."""
    if USE_FUSED and not (x.is_cuda and x.dtype == torch.float32):
        return group_norm_silu_diff(x.contiguous(), scale, bias, num_groups, eps, apply_silu)
    return group_norm_silu_nchw(x, scale, bias, num_groups, eps, apply_silu)
