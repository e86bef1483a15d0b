"""Ring attention: exact attention with the sequence sharded over the mesh's ``data`` axis.

Twin of ``instantir_tpu/parallel/ring_attention.py``. Each rank keeps its q
shard; the K/V shards travel one hop a step around the ring of the data
group (``dist.batch_isend_irecv``, the twin of ``jax.lax.ppermute``) while an
online softmax merges each visiting block: exact attention, O(S/n) attention
memory a rank. With one rank there is no hop, as the JAX ``fori_loop(0, 0)``
has none.

The block is ``_block_attention_lse`` (the JAX function, fp32) on CPU
tensors. On a CUDA tensor it runs through the flash forward with lse (K2,
``ops/attention.py::flash_attention_lse``): a block is S/n × S/n, and at one
rank the whole sequence, where the JAX einsum's fp32 logits would take
2·10·32768² values (86 GB) for a 2048² Aggregator map. K2's lse is in the
log2 domain (converted here with ln 2) and its output comes in q's dtype:
on the card each block's output is rounded to bf16 once before the fp32
merge, where the JAX block keeps fp32. The gradient (``torch.autograd.Function``)
recomputes each block's probabilities from the merged lse and sends the dK/dV
partial sums back around the ring with their K/V; on the card through the
flash backward kernels (K3, K4), whose per-block dQ/dK/dV come in the input
dtype before their fp32 sums.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from instantir_tpu_torch.ops import attention as attn
from instantir_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

LN2 = math.log(2.0)


def _block_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block with its logsumexp, fp32 accumulators (the JAX
    function): q [B, Sq, H, D], k/v [B, Sk, H, D] -> (out [B, Sq, H, D]
    fp32, lse [B, Sq, H] fp32, natural log). On CUDA tensors K2."""
    if q.is_cuda:
        o, lse2 = attn.flash_attention_lse(q, k, v, scale)
        return o.float(), (lse2 * LN2).transpose(1, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype).float(), v.float())
    return out, (m + torch.log(l))[..., 0].transpose(1, 2)


def _merge(o1, lse1, o2, lse2):
    """Combine two partial attentions over disjoint K/V sets (flash merge)."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def _block_backward(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) of one block in fp32, from the merged output ``o`` and
    lse ([B, Sq, H], natural log): P = exp(q·kᵀ·scale − lse), the flash
    backward's formulas (K3 and K4 on CUDA tensors)."""
    if q.is_cuda:
        lse2 = (lse / LN2).transpose(1, 2).contiguous()
        delta = attn.flash_delta(o, do)
        dq = attn.flash_backward_dq(q, k, v, do, lse2, delta, scale)
        dk, dv = attn.flash_backward_dkv(q, k, v, do, lse2, delta, scale)
        return dq.float(), dk.float(), dv.float()
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(logits - lse.transpose(1, 2)[..., None])
    delta = (dof * o.float()).sum(dim=-1).transpose(1, 2)[..., None]  # [B, H, Sq, 1]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv


def _hop(tensors, group, n: int, rank: int):
    """Send ``tensors`` to the next rank of the ring and return those of the previous one."""
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, scale):
        group, n, rank = axis_group(mesh, axis), axis_size(mesh, axis), axis_rank(mesh, axis)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _block_attention_lse(q, k, v, scale)
        kv = (k, v)
        for _ in range(n - 1):
            kv = _hop(kv, group, n, rank)
            o2, lse2 = _block_attention_lse(q, *kv, scale)
            o, lse = _merge(o, lse, o2, lse2)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, n, rank, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, n, rank, scale = ctx.ring
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kv = (k, v)
        for step in range(n):
            bq, bk, bv = _block_backward(q, *kv, o, lse, do, scale)
            dq += bq
            dk += bk
            dv += bv
            # dK/dV travel with their K/V; after the last block one more hop brings them home
            if step < n - 1:
                *kv, dk, dv = _hop((*kv, dk, dv), group, n, rank)
            elif n > 1:
                dk, dv = _hop((dk, dv), group, n, rank)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "data",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence sharded along ``mesh[axis]``: q/k/v
    are this rank's ``[B, S/n, H, D]`` shards (``shard_sequence``), the
    result its ``[B, S/n, H, D]`` shard of the output. Differentiable. The
    global sequence ``S`` is the shard's times the axis size."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, mesh, axis, scale)


def shard_sequence(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's shard of a replicated ``[B, S, ...]`` along S (a view); a
    sequence the axis does not divide raises ``ValueError``."""
    n = axis_size(mesh, axis)
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by mesh axis {axis}={n}")
    s, r = x.shape[1] // n, axis_rank(mesh, axis)
    return x[:, r * s:(r + 1) * s]


def gather_sequence(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The replicated ``[B, S, ...]`` from each rank's shard along S (an all-gather, in rank order)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    parts = x.transpose(0, 1).contiguous()  # [S/n, B, ...]: the gather's leading axis
    out = parts.new_empty((n * parts.shape[0],) + tuple(parts.shape[1:]))
    dist.all_gather_into_tensor(out, parts, group=axis_group(mesh, axis))
    return out.transpose(0, 1)
