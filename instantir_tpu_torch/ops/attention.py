"""Attention ops: the hand-written Hopper flash-attention kernels + the plain path.

Twin of ``instantir_tpu/ops/attention.py``. Layout convention: ``[batch, seq,
heads, head_dim]`` (BSHD) at every public function, as in the JAX package.

* ``attention_xla`` -- the plain path: fp32 logits and softmax, probabilities
  rounded to the V dtype before P·V (the JAX reference path's semantics).
* ``flash_attention`` -- the wrapper of ``csrc/flash_fwd.cu``, the port of the
  Pallas kernel ``flash_attention`` (``wgmma`` products, K/V tiles of 64 keys
  through a ``cp.async`` ring, 64 or 128 q rows per CTA chosen by the C entry
  point). On a CUDA tensor it launches the kernel or raises; only a tensor on
  the CPU takes the plain version, ``flash_attention_reference``, whose
  ``block_k`` default is the kernel's key tile.
* ``flash_attention_lse`` -- the training forward (port of
  ``_flash_forward_lse``): the same kernel plus the per-row log2-domain
  logsumexp ``[B, H, Sq]`` fp32; plain version ``flash_attention_lse_reference``.
* ``flash_backward_dq`` / ``flash_backward_dkv`` -- the wrappers of
  ``csrc/flash_bwd.cu``, the ports of the two Pallas kernels of
  ``_flash_backward``; plain version ``flash_backward_reference``.
* ``flash_attention_diff`` -- the ``torch.autograd.Function`` that ties them
  together (twin of ``_flash_diff``).
* ``dot_product_attention`` -- the dispatch rule of the JAX package: inside
  ``sequence_parallel_scope`` a long self-attention rings over the mesh
  (``parallel/ring_attention.py``); else a self-attention with no bias,
  kv >= 512 and q >= 128 on the accelerator goes to the flash kernels (the
  differentiable one when an input needs a gradient); everything else goes
  to ``attention_xla``.

Every wrapper takes bf16 or fp32 (one dtype for all its operands), as the
Pallas kernels take any float dtype: bf16 launches the ``wgmma`` kernels
above, fp32 those of ``csrc/flash_f32.cu``: a forward on ``wgmma`` and a
backward on ``mma.sync``, both on the tensor cores in 3xTF32 (one TF32 product
keeps 10 mantissa bits, short of the fp32 tolerance; three products of the
split ``hi + lo`` keep about 21: ``split_tf32`` and the ``matmul`` hooks of
``flash_attention_lse_reference`` and ``flash_backward_reference`` emulate
them on the CPU). Every entry point has its own launch counter, bumped only
where it launches.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from instantir_tpu_torch import kernels

LOG2E = 1.4426950408889634

# The sequence-parallel scope (twin of the JAX package's): while a restore with
# ``RestoreConfig.sequence_parallel`` runs, ``dot_product_attention`` sends every
# self-attention with no bias whose sequence reaches ``min_seq`` and divides
# the mesh axis through ring attention. A stack of (mesh, axis, min_seq).
_SP_SCOPE: list = []


@contextlib.contextmanager
def sequence_parallel_scope(mesh, axis: str = "data", min_seq: int = 8192):
    _SP_SCOPE.append((mesh, axis, int(min_seq)))
    try:
        yield
    finally:
        _SP_SCOPE.pop()


@contextlib.contextmanager
def tensor_parallel_scope(mesh, axis: str = "model"):
    """Twin of the JAX scope, which shard_maps the Pallas call onto each
    chip's local heads; ``parallel/tp.py`` already hands every attention its
    local heads, so here the scope does nothing."""
    yield


# Launches of each kernel in this process (bumped only where it launches).
flash_attention_launches = 0  # forward without lse (inference)
flash_attention_lse_launches = 0  # forward with lse (training)
flash_backward_dq_launches = 0
flash_backward_dkv_launches = 0
# the fp32 entry points (csrc/flash_f32.cu)
flash_attention_f32_launches = 0
flash_attention_lse_f32_launches = 0
flash_backward_dq_f32_launches = 0
flash_backward_dkv_f32_launches = 0


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


def flash_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_k: int = 64,
    matmul=torch.matmul,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the flash forward kernels: the same blocked
    online softmax with the same rounding points (q pre-scaled by scale·log2e
    in fp32 and rounded to its dtype; fp32 scores, max and sum with exp2; P
    rounded to the V dtype before P·V; fp32 accumulation; O = acc / l in the
    input dtype). A ragged last K/V block is simply shorter. q/k/v:
    [B, S, H, D]. Returns ``(o, lse2)`` with ``lse2 = m + log2 l`` (the
    logsumexp of the log2-domain scores), fp32 ``[B, H, Sq]``. ``matmul``
    takes both block products (fp32 operands); the tests pass an emulation
    of the fp32 kernel's 3xTF32 products (with ``block_k`` its 32-key tile)."""
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
        s = matmul(qf, kb.transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3), (m + torch.log2(l)).squeeze(-1)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    block_k: int = 64,
) -> torch.Tensor:
    """The output of ``flash_attention_lse_reference`` alone."""
    return flash_attention_lse_reference(q, k, v, scale, block_k)[0]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, on the bits, as ``cvt.rna.tf32.f32`` rounds a finite
    value: half a TF32 ulp added to the magnitude, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``: together
    about 21 of fp32's 24 significant bits. The split of the fp32 kernels'
    3xTF32 products, ``a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``
    (``csrc/flash_f32.cu``)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    block_q: int = 64,
    block_k: int = 64,
    matmul=torch.matmul,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of the two backward kernels: the blocked dQ sweep
    (per q block over K/V blocks) and the blocked dK/dV sweep (per K/V block
    over q blocks) of the Pallas bodies, with their rounding points:
    ``q2 = dtype(fp32(q)·scale·log2e)``, ``k2`` likewise; ``p = exp2(s - lse2)``
    in fp32; P and dS rounded to the input dtype before their products; fp32
    accumulators; ``dq = dtype(acc·scale)``, ``dk = dtype(acc·scale)``,
    ``dv = dtype(acc)``. ``D = rowsum(dO∘O)`` in fp32. q/k/v/o/do: [B, S, H, D];
    lse: [B, H, Sq] fp32 (log2 domain). Returns (dq, dk, dv) in [B, S, H, D].
    ``matmul`` takes every block product (fp32 operands); the tests pass an
    emulation of the fp32 kernels' 3xTF32 products."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    dt = q.dtype

    def fold(x):
        return x.permute(0, 2, 1, 3)  # [B, H, S, D]

    qf, kf, vf, dof = fold(q), fold(k), fold(v), fold(do)
    delta = (dof.float() * fold(o).float()).sum(dim=-1, keepdim=True)  # [B, H, Sq, 1]
    lse_c = lse.unsqueeze(-1)  # [B, H, Sq, 1]
    q2 = (qf.float() * (scale * LOG2E)).to(dt).float()
    k2 = (kf.float() * (scale * LOG2E)).to(dt).float()
    qf32, kf32, vf32, dof32 = qf.float(), kf.float(), vf.float(), dof.float()
    sq, skv = qf.shape[2], kf.shape[2]

    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, sq, block_q):
        i = slice(i0, i0 + block_q)
        for j0 in range(0, skv, block_k):
            j = slice(j0, j0 + block_k)
            s = matmul(q2[:, :, i], kf32[:, :, j].transpose(-1, -2))
            p = torch.exp2(s - lse_c[:, :, i])
            dp = matmul(dof32[:, :, i], vf32[:, :, j].transpose(-1, -2))
            ds = (p * (dp - delta[:, :, i])).to(dt).float()
            dq[:, :, i] += matmul(ds, kf32[:, :, j])

    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    lse_r, delta_r = lse_c.transpose(-1, -2), delta.transpose(-1, -2)  # [B, H, 1, Sq]
    for j0 in range(0, skv, block_k):
        j = slice(j0, j0 + block_k)
        for i0 in range(0, sq, block_q):
            i = slice(i0, i0 + block_q)
            s_t = matmul(k2[:, :, j], qf32[:, :, i].transpose(-1, -2))
            p_t = torch.exp2(s_t - lse_r[:, :, :, i])
            dv[:, :, j] += matmul(p_t.to(dt).float(), dof32[:, :, i])
            dp_t = matmul(vf32[:, :, j], dof32[:, :, i].transpose(-1, -2))
            ds_t = (p_t * (dp_t - delta_r[:, :, :, i])).to(dt).float()
            dk[:, :, j] += matmul(ds_t, qf32[:, :, i])

    def unfold(x):
        return x.permute(0, 2, 1, 3)

    return unfold((dq * scale).to(dt)), unfold((dk * scale).to(k.dtype)), unfold(dv.to(v.dtype))


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "fwd": [_PTR] * 4 + [_INT] * 4 + [_FLOAT, _PTR],
    "fwd_lse": [_PTR] * 5 + [_INT] * 4 + [_FLOAT, _PTR],
    "bwd_dq": [_PTR] * 7 + [_INT] * 4 + [_FLOAT, _FLOAT, _PTR],
    "bwd_dkv": [_PTR] * 8 + [_INT] * 4 + [_FLOAT, _FLOAT, _PTR],
}
# C entry points: (source, symbol, argtypes); the fp32 ones take the same arguments
_ENTRY_POINTS = {
    "fwd": ("flash_fwd", "instantir_flash_fwd_bf16_d64", _ARGTYPES["fwd"]),
    "fwd_lse": ("flash_fwd", "instantir_flash_fwd_lse_bf16_d64", _ARGTYPES["fwd_lse"]),
    "bwd_dq": ("flash_bwd", "instantir_flash_bwd_dq_bf16_d64", _ARGTYPES["bwd_dq"]),
    "bwd_dkv": ("flash_bwd", "instantir_flash_bwd_dkv_bf16_d64", _ARGTYPES["bwd_dkv"]),
    **{f"{name}_f32": ("flash_f32", f"instantir_flash_{name}_f32_d64", argtypes) for name, argtypes in _ARGTYPES.items()},
}
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_flash_inputs(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: the kernels take bfloat16 or float32, one dtype for q, k and v; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not k.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q/k/v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q/k/v must be [B, S, H, D]")
    b, sq, h, d = q.shape
    if d != 64:
        raise ValueError(f"{what}: the kernel takes head_dim 64 only, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{what}: shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if sq == 0 or k.shape[1] == 0:
        # kv_len >= 1 also means no q row has all its keys masked: l > 0 and lse is finite
        raise ValueError(f"{what}: empty sequence")
    if b * h > 65535:
        raise ValueError(f"{what}: batch*heads {b * h} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(what, name, t)


def _check_operand(what: str, name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None, shape: Optional[tuple] = None) -> None:
    """Contiguity and alignment of one kernel operand; with ``like``/``dtype``/
    ``shape`` also its device, dtype and shape."""
    if like is not None and t.device != like.device:
        raise ValueError(f"{what}: {name} is on {t.device}, expected {like.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _launch(what: str, name: str, like: torch.Tensor, *args) -> bool:
    """Launch entry point ``name`` (its ``_f32`` twin for fp32 ``like``; the
    source built at first use) on the current stream of ``like``'s device and
    raise if the launch was refused. Returns whether the fp32 twin ran."""
    f32 = like.dtype == torch.float32
    call = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    kernels.launch(what, kernels.bind(*_ENTRY_POINTS[name + "_f32" if f32 else name]), like.device, call)
    return f32


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention. q/k/v: [B, S, H, D] -> [B, Sq, H, D].

    On CUDA tensors this launches ``csrc/flash_fwd.cu`` (bf16) or
    ``csrc/flash_f32.cu`` (fp32), head_dim 64; anything else raises. On CPU
    tensors it runs ``flash_attention_reference``. Not differentiable:
    ``flash_attention_diff`` is.
    """
    global flash_attention_launches, flash_attention_f32_launches
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention: q is on the CPU but k/v are not")
        return flash_attention_reference(q, k, v, scale)
    _check_flash_inputs("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    if _launch("flash_attention", "fwd", q, q, k, v, out, b, h, sq, k.shape[1], scale * LOG2E):
        flash_attention_f32_launches += 1
    else:
        flash_attention_launches += 1
    return out


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` that also returns the per-row log2-domain logsumexp
    ``lse2 = m + log2 l`` as fp32 ``[B, H, Sq]`` (what the backward kernels
    rebuild P from). CUDA tensors launch the lse entry point of
    ``csrc/flash_fwd.cu`` (bf16) or ``csrc/flash_f32.cu`` (fp32) or raise;
    CPU tensors run ``flash_attention_lse_reference``."""
    global flash_attention_lse_launches, flash_attention_lse_f32_launches
    if not q.is_cuda:
        if k.is_cuda or v.is_cuda:
            raise ValueError("flash_attention_lse: q is on the CPU but k/v are not")
        return flash_attention_lse_reference(q, k, v, scale)
    _check_flash_inputs("flash_attention_lse", q, k, v)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lse = q.new_empty((b, h, sq), dtype=torch.float32)
    if _launch("flash_attention_lse", "fwd_lse", q, q, k, v, out, lse, b, h, sq, k.shape[1], scale * LOG2E):
        flash_attention_lse_f32_launches += 1
    else:
        flash_attention_lse_launches += 1
    return out, lse


def _check_backward_inputs(what, q, k, v, do, lse, delta) -> None:
    _check_flash_inputs(what, q, k, v)
    b, sq, h, _ = q.shape
    _check_operand(what, "do", do, like=q, dtype=q.dtype, shape=q.shape)
    _check_operand(what, "lse", lse, like=q, dtype=torch.float32, shape=(b, h, sq))
    _check_operand(what, "delta", delta, like=q, dtype=torch.float32, shape=(b, h, sq))


def flash_backward_dq(q, k, v, do, lse, delta, scale: Optional[float] = None) -> torch.Tensor:
    """dQ = scale · Σ_j [P ∘ (dO·V_jᵀ − D)]·K_j with P = exp2(q2·Kᵀ − lse2).
    CUDA only (``csrc/flash_bwd.cu`` for bf16, ``csrc/flash_f32.cu`` for fp32,
    head_dim 64): the plain version of both backward kernels is
    ``flash_backward_reference``. q/k/v/do: [B, S, H, 64]; lse, delta: fp32
    [B, H, Sq]."""
    global flash_backward_dq_launches, flash_backward_dq_f32_launches
    _check_backward_inputs("flash_backward_dq", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    dq = torch.empty_like(q)
    if _launch("flash_backward_dq", "bwd_dq", q, q, k, v, do, lse, delta, dq, b, h, sq, k.shape[1],
               scale * LOG2E, scale):
        flash_backward_dq_f32_launches += 1
    else:
        flash_backward_dq_launches += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dV = Σ_i Pᵀ·dO_i and dK = scale · Σ_i dSᵀ·Q_i with Sᵀ = k2·Qᵀ. CUDA
    only (``csrc/flash_bwd.cu``, ``csrc/flash_f32.cu``); see ``flash_backward_dq``."""
    global flash_backward_dkv_launches, flash_backward_dkv_f32_launches
    _check_backward_inputs("flash_backward_dkv", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _launch("flash_backward_dkv", "bwd_dkv", q, q, k, v, do, lse, delta, dk, dv, b, h, sq, k.shape[1],
               scale * LOG2E, scale):
        flash_backward_dkv_f32_launches += 1
    else:
        flash_backward_dkv_launches += 1
    return dk, dv


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO∘O) in fp32, [B, Sq, H, D] -> [B, H, Sq] (left to plain
    torch, as the JAX package leaves it to XLA)."""
    return (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


class _FlashAttentionDiff(torch.autograd.Function):
    """Differentiable flash attention, the twin of ``_flash_diff``: forward
    with lse, backward through the dQ and dK/dV kernels (their plain versions
    on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # arrives as a view of the caller's reshape
        if not q.is_cuda:
            return (*flash_backward_reference(q, k, v, o, lse, do, ctx.scale), None)
        delta = flash_delta(o, do)
        dq = flash_backward_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` with a gradient. q/k/v: [B, S, H, D]."""
    return _FlashAttentionDiff.apply(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Dispatching attention: the flash kernels on CUDA for long self-attention
    (the JAX package's rule, with "on TPU" read as "on a CUDA tensor"),
    ``attention_xla`` for everything else. Where an input needs a gradient the
    differentiable kernels run (forward with lse, dQ and dK/dV backward);
    otherwise the inference forward.

    Inside ``sequence_parallel_scope`` a self-attention with no bias,
    ``q_len == kv_len >= min_seq`` and the length divisible by the mesh axis
    rings instead: each rank takes its shard of the replicated q/k/v, runs
    ``ring_attention`` and all-gathers the output (what ``shard_map`` over
    replicated inputs does in JAX). That branch is inference only: its
    gather carries no gradient, so it refuses inputs that need one."""
    kv_len = k.shape[1]
    if _SP_SCOPE and bias is None and q.shape[1] == kv_len:
        from instantir_tpu_torch.parallel import ring_attention as ring
        from instantir_tpu_torch.parallel.mesh import axis_size

        mesh, axis, min_seq = _SP_SCOPE[-1]
        if kv_len >= min_seq and kv_len % axis_size(mesh, axis) == 0:
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
                raise NotImplementedError("sequence_parallel_scope rings inference attention only; call "
                                          "parallel.ring_attention.ring_attention on shards for a gradient")
            local = [ring.shard_sequence(x, mesh, axis) for x in (q, k, v)]
            return ring.gather_sequence(ring.ring_attention(*local, mesh, axis=axis, scale=scale), mesh, axis)
    if use_flash and bias is None and q.is_cuda and k.shape[1] >= 512 and q.shape[1] >= 128:
        scale_v = q.shape[-1] ** -0.5 if scale is None else scale
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return flash_attention_diff(q, k, v, scale_v)
        return flash_attention(q, k, v, scale=scale_v)
    return attention_xla(q, k, v, scale=scale, bias=bias)
