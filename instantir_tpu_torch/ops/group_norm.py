"""GroupNorm(+SiLU) with fp32 statistics: the cluster kernel and the plain version.

Twin of ``instantir_tpu/ops/group_norm.py``. Statistics use the
E[x^2] - mu^2 form clamped at 0 -- not ``F.group_norm``'s variance -- so the
port rounds where the JAX package does.

* ``group_norm_silu_nchw`` -- the plain version (twin of
  ``group_norm_silu_reference``, channels first).
* ``group_norm_silu_fused`` -- the wrapper of ``csrc/group_norm.cu``, the port
  of the Pallas function ``group_norm_silu_pallas``. On a CUDA tensor it
  launches the kernel or raises; only a tensor on the CPU takes the plain
  version.
* ``gn_plan`` / ``slab_slices`` -- the launch plan the wrapper hands the kernel
  (cluster size, shared memory per CTA) and the partition of a (batch, group)
  slab among a cluster's CTAs that the kernel computes on the device.
* ``group_norm_silu_diff`` -- the ``torch.autograd.Function`` around the
  wrapper (twin of ``_gn_silu_diff``): backward differentiates the plain
  formula and saves x, not the fp32 intermediates.
* ``group_norm_silu`` -- the dispatch every ``GroupNorm32`` calls (the VAE's
  too), governed by the module-level setting ``USE_FUSED``.

The kernel (its source note has the details): what bounds it on the H100 is
bytes -- x read once and y written once against a few operations per element.
One launch of B*G thread-block clusters: each cluster's CTAs bring their runs
of one contiguous (batch, group) slab into shared memory with bulk copies, sum
x and x^2 in fp32, exchange the partial sums through distributed shared memory
and normalise from shared memory, so x is read from device memory once where
the Triton pair it replaced read it twice; and one ctypes call on the raw
stream where that pair paid two launches through Triton's Python launcher.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from instantir_tpu_torch import kernels

# The port's counterpart of the JAX package's INSTANTIR_PALLAS_GN switch: True
# sends every GroupNorm32 through the fused kernel (on a CUDA tensor; a CPU
# tensor takes its plain version), the VAE's included, False through the plain
# version. On by default from the H100 measurements of chip_smoke.py (PERF.md).
USE_FUSED = True

# Launches of the fused kernel in this process (bumped only where it launches).
group_norm_launches = 0

# The card the plan is made for (an H100: PERF.md names the one measured).
H100_SMS = 132
SMEM_PER_SM = 233_472  # 228 KB of an SM's shared memory that CTAs may take
SMEM_PER_CTA = 232_448  # 227 KB, the opt-in limit of one CTA
SMEM_RESERVED_PER_CTA = 1_024  # what the runtime keeps of an SM's shared memory for each resident CTA
STATIC_SMEM = 256  # bound on the kernel's __shared__ variables (kStaticSmemBound in the source)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
PORTABLE_CLUSTER = 8  # larger clusters need cudaFuncAttributeNonPortableClusterSizeAllowed
MIN_SLICE_BYTES = 8_192  # a cluster grown to fill the card stops before a CTA's run falls below this
CTAS_PER_SM = 3  # a CTA's shared memory is at most this share of an SM's


@dataclass(frozen=True)
class GnPlan:
    """How ``csrc/group_norm.cu`` is launched for one shape: ``cs`` CTAs per
    cluster (``non_portable`` above 8), each keeping ``res_vec`` 16-byte
    vectors of its run in ``smem_bytes`` of dynamic shared memory (the data,
    then fp32 w and b for the group's channels). ``path`` is "resident" when
    every run fits, "reread" when the rest of a run is read from device memory
    a second time."""

    cs: int
    non_portable: bool
    res_vec: int
    smem_bytes: int
    path: str


def slab_slices(start: int, n: int, itemsize: int, cs: int) -> List[Dict[str, Tuple[int, int]]]:
    """The kernel's partition of one (batch, group) slab of ``n`` elements
    whose first element lies ``start`` elements after a 16-byte boundary: per
    CTA rank, element ranges (relative to the slab) of its ``head`` (rank 0:
    the elements before the first 16-byte boundary), its ``body`` (a run of
    whole 16-byte vectors) and its ``tail`` (the last rank: the elements after
    the last boundary). Empty ranges are ``(i, i)``."""
    vec = 16 // itemsize
    mis = (start * itemsize) % 16
    head = min((16 - mis) // itemsize if mis else 0, n)
    nvec = (n - head) // vec
    tail0 = head + nvec * vec
    out = []
    for r in range(cs):
        v0, v1 = nvec * r // cs, nvec * (r + 1) // cs
        out.append({"head": (0, head) if r == 0 else (0, 0),
                     "body": (head + v0 * vec, head + v1 * vec),
                     "tail": (tail0, n) if r == cs - 1 else (n, n)})
    return out


def gn_plan(batch: int, channels: int, hw: int, groups: int, itemsize: int, num_sms: int = H100_SMS) -> GnPlan:
    """The cluster size and shared memory of a launch. The cluster grows
    (powers of two up to 16) until every CTA's run fits in a third of an SM's
    shared memory, so that three CTAs share an SM and one's loads and sums
    overlap another's normalising and stores (measured on the H100 against
    half and a quarter: PERF.md §6); then, up to 8, until the grid covers
    the card's SMs, as long as a run stays at least ``MIN_SLICE_BYTES``. A
    slab larger than 16 such runs keeps what fits and takes the "reread"
    path."""
    cpg = channels // groups
    n = cpg * hw
    table = 8 * cpg  # fp32 w and b per channel of the group
    cap = (SMEM_PER_SM // CTAS_PER_SM - SMEM_RESERVED_PER_CTA - STATIC_SMEM - table) // 16
    if cap < 1:
        raise ValueError(f"group_norm_silu_fused: {cpg} channels per group leave no shared memory for data")
    vec = 16 // itemsize
    nvec = n * itemsize // 16  # the most whole vectors a slab's body holds: one that starts aligned

    def run(cs: int) -> int:  # the longest run of a CTA, in vectors
        return max(s["body"][1] - s["body"][0] for s in slab_slices(0, n, itemsize, cs)) // vec

    cs = 1
    while cs < CLUSTER_SIZES[-1] and run(cs) > cap:
        cs *= 2
    while (cs < PORTABLE_CLUSTER and batch * groups * cs < num_sms
           and nvec * 16 // (2 * cs) >= MIN_SLICE_BYTES):
        cs *= 2
    res_vec = min(run(cs), cap)
    return GnPlan(cs=cs, non_portable=cs > PORTABLE_CLUSTER, res_vec=res_vec, smem_bytes=res_vec * 16 + table,
                  path="resident" if res_vec >= run(cs) else "reread")


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


_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry points: (source, symbol, argtypes)
_ENTRY_POINTS = {
    "group_norm_silu": ("group_norm", "instantir_group_norm_silu", [_PTR] * 4 + [_INT] * 11 + [ctypes.c_float, _PTR]),
}
# per (shape, dtype, device, groups): the launch's integer arguments
_launch_ints: Dict[tuple, tuple] = {}


def _shape_ints(x: torch.Tensor, num_groups: int) -> tuple:
    """The checks that depend on x's shape and dtype alone, and the launch's
    integers (dtype code, B*G, G, n, hw, cpg, then the plan's cs,
    non_portable, res_vec, smem_bytes), once per shape."""
    key = (x.shape, x.dtype, x.device, num_groups)
    ints = _launch_ints.get(key)
    if ints is None:
        if x.dtype not in _DTYPE_CODE:
            raise ValueError(f"group_norm_silu_fused: x must be bfloat16, float16 or float32, got {x.dtype}")
        if x.dim() < 3:
            raise ValueError(f"group_norm_silu_fused: x must be [B, C, *spatial], got {tuple(x.shape)}")
        b, c = x.shape[:2]
        if c % num_groups:
            raise ValueError(f"group_norm_silu_fused: {c} channels do not divide into {num_groups} groups")
        if x.numel() == 0:
            raise ValueError("group_norm_silu_fused: empty input")
        n = x.numel() // (b * num_groups)
        if n > 2**31 - 1:
            raise ValueError("group_norm_silu_fused: a (batch, group) slab exceeds 2**31 - 1 elements")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = gn_plan(b, c, n * num_groups // c, num_groups, x.element_size(), sms)
        ints = _launch_ints[key] = (_DTYPE_CODE[x.dtype], b * num_groups, num_groups, n, n * num_groups // c,
                                    c // num_groups, plan.cs, int(plan.non_portable), plan.res_vec, plan.smem_bytes)
    return ints


def _check_operands(x, scale, bias) -> None:
    if not x.is_contiguous():
        raise ValueError("group_norm_silu_fused: x must be contiguous (NCHW)")
    if x.data_ptr() % 16:
        raise ValueError("group_norm_silu_fused: x must be 16-byte aligned")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"group_norm_silu_fused: {name} must be a contiguous float32 [{c}] tensor on {x.device}")


def group_norm_silu_fused(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """Fused GroupNorm(+SiLU) over channels-first ``[B, C, *spatial]``, output
    in x's dtype; ``scale`` and ``bias`` fp32 ``[C]``. CUDA tensors launch
    ``csrc/group_norm.cu`` once or raise; CPU tensors run
    ``group_norm_silu_nchw``. Not differentiable: ``group_norm_silu_diff`` is."""
    global group_norm_launches
    if not x.is_cuda:
        return group_norm_silu_nchw(x, scale, bias, num_groups, eps, apply_silu)
    ints = _shape_ints(x, num_groups)
    _check_operands(x, scale, bias)
    y = torch.empty_like(x)
    kernels.launch("group_norm_silu_fused", kernels.bind(*_ENTRY_POINTS["group_norm_silu"]), x.device,
                   (x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), *ints, int(apply_silu), eps))
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
    ``USE_FUSED`` on, the fused kernel in every dtype and at every shape,
    through its autograd Function only where an input needs a gradient (the
    restore, under ``torch.no_grad()``, calls the wrapper directly); with it
    off, the plain version."""
    if USE_FUSED:
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
            return group_norm_silu_diff(x, scale, bias, num_groups, eps, apply_silu)
        return group_norm_silu_fused(x, scale, bias, num_groups, eps, apply_silu)
    return group_norm_silu_nchw(x, scale, bias, num_groups, eps, apply_silu)
