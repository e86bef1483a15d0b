"""Reference-attention K/V caching (the KVCopy experiments).

Twin of ``instantir_tpu/models/kv_cache.py``: K/V token caches taken from an
encoder pass over a reference image and fed into another forward as extra
attention tokens (``Attention(..., external_kv=...)``).

* ``KVCache`` / ``AttentionCache`` are NamedTuples of tensors, never changed
  in place (so no ``clone_kvs``).
* ``KVCopy`` is a standalone ``to_k`` / ``to_v`` pair (optional LoRA on both)
  that makes a ``KVCache`` from hidden states; ``init_kv_copy`` copies a source
  attention's base projections into it.
* ``drop_kvs`` keeps a static count ``max(1, round(S·(1 − p)))`` of each
  layer's self-attention tokens, at positions drawn per layer (or given).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from instantir_tpu_torch.models.layers import LoRALinear


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, inner_dim]
    v: torch.Tensor


class AttentionCache(NamedTuple):
    self_attention: KVCache
    cross_attention: KVCache


class KVCopy(nn.Module):
    """``to_k`` / ``to_v`` producing a ``KVCache`` from ``[B, S, in]`` hidden
    states, ``in = cross_attention_dim or inner_dim`` (the JAX module reads it
    from the call)."""

    def __init__(self, inner_dim: int, cross_attention_dim: Optional[int] = None, lora_rank: int = 0,
                 lora_alpha: float = 1.0, dtype=torch.float32, device=None):
        super().__init__()
        in_dim = cross_attention_dim or inner_dim
        common = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype, device=device)
        self.to_k = LoRALinear(in_dim, inner_dim, bias=False, **common)
        self.to_v = LoRALinear(in_dim, inner_dim, bias=False, **common)

    def forward(self, hidden_states: torch.Tensor, lora_scale: float = 0.0) -> KVCache:
        return KVCache(k=self.to_k(hidden_states, lora_scale), v=self.to_v(hidden_states, lora_scale))


@torch.no_grad()
def init_kv_copy(kvcopy: KVCopy, attn: nn.Module) -> KVCopy:
    """Copy the source attention's ``to_k`` / ``to_v`` base weights into
    ``kvcopy`` IN PLACE (its LoRA branches are left as they are) and return
    it: the JAX function's parameter surgery done on the module."""
    kvcopy.to_k.weight.copy_(attn.to_k.weight)
    kvcopy.to_v.weight.copy_(attn.to_v.weight)
    return kvcopy


def drop_kvs(caches: Dict[str, AttentionCache], drop_chance: float,
             indices: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, AttentionCache]:
    """Keep ``max(1, round(S·(1 − drop_chance)))`` of each layer's
    self-attention tokens (the cross-attention cache is kept whole). The kept
    positions are ``indices[name]`` (sorted, as the JAX function sorts
    ``jax.random.choice``'s draw) or, without them, a sorted draw without
    replacement from ``generator``, one per layer in the dict's order."""
    out = {}
    for name, cache in caches.items():
        s = cache.self_attention.k.shape[1]
        keep = max(1, int(round(s * (1.0 - drop_chance))))
        if indices is not None:
            idx = indices[name].to(cache.self_attention.k.device).long()
            if idx.shape != (keep,):
                raise ValueError(f"{name}: {tuple(idx.shape)} indices given for a static count of {keep}")
        else:
            dev = generator.device if generator is not None else "cpu"
            idx = torch.randperm(s, generator=generator, device=dev)[:keep].sort().values
            idx = idx.to(cache.self_attention.k.device)
        out[name] = AttentionCache(
            self_attention=KVCache(k=cache.self_attention.k.index_select(1, idx),
                                   v=cache.self_attention.v.index_select(1, idx)),
            cross_attention=cache.cross_attention,
        )
    return out
