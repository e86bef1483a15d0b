"""SDXL attention with the decoupled, time-aware image-prompt (IP) branch.

Twin of ``instantir_tpu/models/attention.py::Attention``. The behaviours are
forward-time arguments:

  * plain self/cross attention;
  * + the decoupled IP branch: a second softmax over the image tokens with the
    same queries, added as ``out + ip_scale * ip_out``;
  * + time-aware IP: AdaLayerNorm(temb) on the projected ip K/V.

The previewer LoRA targets ``to_q``/``to_out`` everywhere but ``to_k``/``to_v``
only on self-attention; the ip projections (and their AdaLN linears) are
always LoRA'd when the model has a LoRA rank. The external-KV modes and
``SplitAttention`` of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from instantir_tpu_torch.models.layers import AdaLayerNorm, LoRALinear
from instantir_tpu_torch.ops.attention import dot_product_attention


class IPProcessor(nn.Module):
    """Holds the ip K/V projections (state-dict prefix ``processor.``)."""

    def __init__(self, cross_dim: int, inner_dim: int, temb_dim: Optional[int], lora_rank: int, lora_alpha: float,
                 dtype, device):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha, dtype=dtype, device=device)
        self.to_k_ip = LoRALinear(cross_dim, inner_dim, bias=False, **lora)
        self.to_v_ip = LoRALinear(cross_dim, inner_dim, bias=False, **lora)
        if temb_dim is not None:
            self.ln_k_ip = AdaLayerNorm(inner_dim, temb_dim, **lora)
            self.ln_v_ip = AdaLayerNorm(inner_dim, temb_dim, **lora)


class Attention(nn.Module):
    """Multi-head attention over ``[B, N, C]`` tokens.

    ``cross_attention_dim`` set means this is a cross-attention (K/V from the
    encoder states, no LoRA on ``to_k``/``to_v``). ``with_ip`` builds the
    decoupled image-prompt branch; ``time_aware_ip`` adds AdaLN(temb) on its
    K/V, for which ``temb_dim`` is the width of the time embedding.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int, cross_attention_dim: Optional[int] = None,
                 with_ip: bool = False, time_aware_ip: bool = True, temb_dim: Optional[int] = None,
                 ip_scale: float = 1.0, lora_rank: int = 0, lora_alpha: float = 1.0, out_bias: bool = True,
                 use_flash: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        inner_dim = heads * head_dim
        kv_dim = cross_attention_dim or query_dim
        self.is_cross = cross_attention_dim is not None
        self.heads = heads
        self.head_dim = head_dim
        self.with_ip = with_ip
        self.time_aware_ip = time_aware_ip
        self.ip_scale = ip_scale
        self.use_flash = use_flash
        common = dict(dtype=dtype, device=device)
        lora_qo = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        lora_kv = dict(lora_rank=0 if self.is_cross else lora_rank, lora_alpha=lora_alpha)
        self.to_q = LoRALinear(query_dim, inner_dim, bias=False, **lora_qo, **common)
        self.to_k = LoRALinear(kv_dim, inner_dim, bias=False, **lora_kv, **common)
        self.to_v = LoRALinear(kv_dim, inner_dim, bias=False, **lora_kv, **common)
        self.to_out = nn.ModuleList([LoRALinear(inner_dim, query_dim, bias=out_bias, **lora_qo, **common)])
        if with_ip:
            if time_aware_ip and temb_dim is None:
                raise ValueError("time_aware_ip requires temb_dim")
            self.processor = IPProcessor(kv_dim, inner_dim, temb_dim if time_aware_ip else None, lora_rank,
                                         lora_alpha, dtype, device)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        ip_hidden_states: Optional[torch.Tensor] = None,
        temb: Optional[torch.Tensor] = None,
        lora_scale: float = 0.0,
        ip_scale: Optional[float] = None,
    ) -> torch.Tensor:
        if self.is_cross != (encoder_hidden_states is not None):
            raise ValueError("encoder_hidden_states must be given exactly to a cross-attention")
        b, n, _ = hidden_states.shape
        context = encoder_hidden_states if self.is_cross else hidden_states
        q = self.to_q(hidden_states, lora_scale)
        k = self.to_k(context, lora_scale)
        v = self.to_v(context, lora_scale)

        def heads(t):
            return t.reshape(b, -1, self.heads, self.head_dim)

        q = heads(q)
        out = dot_product_attention(q, heads(k), heads(v), use_flash=self.use_flash).reshape(b, n, -1)

        if self.with_ip:
            if ip_hidden_states is None:
                raise ValueError("with_ip=True requires ip_hidden_states")
            ip_k = self.processor.to_k_ip(ip_hidden_states, lora_scale)
            ip_v = self.processor.to_v_ip(ip_hidden_states, lora_scale)
            if self.time_aware_ip:
                if temb is None:
                    raise ValueError("time_aware_ip requires temb")
                ip_k = self.processor.ln_k_ip(ip_k, temb, lora_scale)
                ip_v = self.processor.ln_v_ip(ip_v, temb, lora_scale)
            ip_out = dot_product_attention(q, heads(ip_k), heads(ip_v), use_flash=self.use_flash)
            scale = self.ip_scale if ip_scale is None else ip_scale
            out = out + scale * ip_out.reshape(b, n, -1)

        return self.to_out[0](out, lora_scale)
