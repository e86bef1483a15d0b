"""SDXL attention with the decoupled, time-aware image-prompt (IP) branch.

Twin of ``instantir_tpu/models/attention.py::Attention``. The behaviours are
forward-time arguments:

  * plain self/cross attention;
  * + the decoupled IP branch: a second softmax over the image tokens with the
    same queries, added as ``out + ip_scale * ip_out``;
  * + time-aware IP: AdaLayerNorm(temb) on the projected ip K/V;
  * + external K/V tokens (``external_kv``, a ``models/kv_cache.py::KVCache``):
    ``concat`` appends them to the K/V sequence of the main softmax;
    ``additive`` runs a second softmax over them with the same queries and
    adds ``additive_scale * ext_out``; ``ta_additive`` first AdaLN(temb)s
    them (``ln_k_ext`` / ``ln_v_ext``).

The previewer LoRA targets ``to_q``/``to_out`` everywhere but ``to_k``/``to_v``
only on self-attention; the ip projections (and their AdaLN linears) are
always LoRA'd when the model has a LoRA rank.

``SplitAttention`` is the Aggregator's self-attention ablation over the
H-concatenated (cond | pad | ref) map (``joint`` and ``sep``). Every softmax
goes through ``ops/attention.py::dot_product_attention``, so the flash kernels
run wherever its length rule lets them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from instantir_tpu_torch.models.layers import AdaLayerNorm, LoRALinear
from instantir_tpu_torch.models.kv_cache import KVCache
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
    K/V, for which ``temb_dim`` is the width of the time embedding. ``ip_dim``
    is the width of the ip tokens (default: the K/V input's; the Aggregator's
    self-attention takes cross-attention-wide tokens). ``external_kv_mode``
    and ``additive_scale`` say how ``external_kv`` enters (module
    docstring); ``ta_additive`` needs ``temb_dim``.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int, cross_attention_dim: Optional[int] = None,
                 with_ip: bool = False, time_aware_ip: bool = True, temb_dim: Optional[int] = None,
                 ip_scale: float = 1.0, lora_rank: int = 0, lora_alpha: float = 1.0, out_bias: bool = True,
                 use_flash: bool = True, dtype=torch.float32, device=None, ip_dim: Optional[int] = None,
                 external_kv_mode: str = "concat", additive_scale: float = 1.0):
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
        self.dtype = dtype
        self.external_kv_mode = external_kv_mode
        self.additive_scale = additive_scale
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
            self.processor = IPProcessor(ip_dim or kv_dim, inner_dim, temb_dim if time_aware_ip else None,
                                         lora_rank, lora_alpha, dtype, device)
        if external_kv_mode == "ta_additive":
            if temb_dim is None:
                raise ValueError("external_kv_mode='ta_additive' requires temb_dim")
            self.ln_k_ext = AdaLayerNorm(inner_dim, temb_dim, **common)
            self.ln_v_ext = AdaLayerNorm(inner_dim, temb_dim, **common)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        ip_hidden_states: Optional[torch.Tensor] = None,
        temb: Optional[torch.Tensor] = None,
        lora_scale: float = 0.0,
        ip_scale: Optional[float] = None,
        external_kv: Optional[KVCache] = None,
    ) -> torch.Tensor:
        if self.is_cross != (encoder_hidden_states is not None):
            raise ValueError("encoder_hidden_states must be given exactly to a cross-attention")
        b, n, _ = hidden_states.shape
        context = encoder_hidden_states if self.is_cross else hidden_states
        q = self.to_q(hidden_states, lora_scale)
        k = self.to_k(context, lora_scale)
        v = self.to_v(context, lora_scale)
        if external_kv is not None and self.external_kv_mode == "concat":
            k = torch.cat([k, external_kv.k.to(k.dtype)], dim=1)
            v = torch.cat([v, external_kv.v.to(v.dtype)], dim=1)

        def heads(t):
            return t.reshape(b, -1, self.heads, self.head_dim)

        q = heads(q)
        out = dot_product_attention(q, heads(k), heads(v), use_flash=self.use_flash).reshape(b, n, -1)

        if external_kv is not None and self.external_kv_mode != "concat":
            # a second softmax with the same queries over the external K/V
            if self.external_kv_mode not in ("additive", "ta_additive"):
                raise ValueError(f"unknown external_kv_mode {self.external_kv_mode!r}")
            ext_k, ext_v = external_kv.k.to(self.dtype), external_kv.v.to(self.dtype)
            if self.external_kv_mode == "ta_additive":
                if temb is None:
                    raise ValueError("external_kv_mode='ta_additive' requires temb")
                ext_k, ext_v = self.ln_k_ext(ext_k, temb), self.ln_v_ext(ext_v, temb)
            ext_out = dot_product_attention(q, heads(ext_k), heads(ext_v), use_flash=self.use_flash)
            out = out + self.additive_scale * ext_out.reshape(b, n, -1)

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


class SplitAttention(nn.Module):
    """The Aggregator's self-attention ablations over the flattened
    H-concatenated (cond | pad | ref) map, twin of the JAX ``SplitAttention``.
    The two streams are recovered (the zero pad row between them, if any, is
    dropped), attended, and put back together around a fresh zero pad row, so
    the pad tokens pass through on the transformer's residual unchanged.

    * ``mode="joint"``: one self-attention over [cond; ref] without the pad
      row. Without a pad row it is plain attention over the whole map.
    * ``mode="sep"``: per-stream self-attention with the shared projections,
      AdaLN(temb) on the ref stream's K/V (``ln_k_ref`` / ``ln_v_ref``, which
      need ``temb_dim``), and the two cross-stream attentions added
      asymmetrically: ``cond += ref_scale·10·attn(q_cond, k_ref, v_ref)`` and
      ``ref += ref_scale·attn(q_ref, k_cond, v_cond)``, all before the shared
      ``to_out``.

    The projections are named as :class:`Attention`'s (``to_q``, ``to_k``,
    ``to_v``, ``to_out.0``), so a plain Aggregator's weights load unchanged.
    ``external_kv`` is appended to the joint K/V, or to the ref stream's.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int, mode: str = "joint",
                 temb_dim: Optional[int] = None, use_flash: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        if mode not in ("joint", "sep"):
            raise ValueError(f"unknown SplitAttention mode {mode!r}")
        inner = heads * head_dim
        common = dict(dtype=dtype, device=device)
        self.heads = heads
        self.head_dim = head_dim
        self.mode = mode
        self.use_flash = use_flash
        self.to_q = LoRALinear(query_dim, inner, bias=False, **common)
        self.to_k = LoRALinear(query_dim, inner, bias=False, **common)
        self.to_v = LoRALinear(query_dim, inner, bias=False, **common)
        self.to_out = nn.ModuleList([LoRALinear(inner, query_dim, bias=True, **common)])
        if mode == "sep":
            if temb_dim is None:
                raise ValueError("mode='sep' requires temb_dim (AdaLN on the ref K/V)")
            self.ln_k_ref = AdaLayerNorm(inner, temb_dim, **common)
            self.ln_v_ref = AdaLayerNorm(inner, temb_dim, **common)

    def forward(self, hidden_states: torch.Tensor, spatial: Tuple[int, int], temb: Optional[torch.Tensor] = None,
                ref_scale: float = 1.0, external_kv: Optional[KVCache] = None) -> torch.Tensor:
        h, w = spatial
        b, n, _ = hidden_states.shape
        if n != h * w:
            raise ValueError(f"sequence {n} does not match spatial {h}x{w}")
        n0 = (h // 2) * w
        pad = n - 2 * n0  # 0, or one w-token zero row between the streams
        x0, x1 = hidden_states[:, :n0], hidden_states[:, n - n0:]

        def attend(q, k, v):
            def split(t):
                return t.reshape(b, -1, self.heads, self.head_dim)

            return dot_product_attention(split(q), split(k), split(v), use_flash=self.use_flash).reshape(b, -1, q.shape[-1])

        to_out = self.to_out[0]
        if self.mode == "joint":
            x = torch.cat([x0, x1], dim=1)
            k, v = self.to_k(x), self.to_v(x)
            if external_kv is not None:
                k = torch.cat([k, external_kv.k.to(k.dtype)], dim=1)
                v = torch.cat([v, external_kv.v.to(v.dtype)], dim=1)
            out = to_out(attend(self.to_q(x), k, v))
            o0, o1 = out[:, :n0], out[:, n0:]
        else:
            if temb is None:
                raise ValueError("mode='sep' requires temb (AdaLN on the ref K/V)")
            q0, k0, v0 = self.to_q(x0), self.to_k(x0), self.to_v(x0)
            q1, k1, v1 = self.to_q(x1), self.to_k(x1), self.to_v(x1)
            k1, v1 = self.ln_k_ref(k1, temb), self.ln_v_ref(v1, temb)
            if external_kv is not None:
                k1 = torch.cat([k1, external_kv.k.to(k1.dtype)], dim=1)
                v1 = torch.cat([v1, external_kv.v.to(v1.dtype)], dim=1)
            o0 = attend(q0, k0, v0) + ref_scale * 10.0 * attend(q0, k1, v1)
            o1 = attend(q1, k1, v1) + ref_scale * attend(q1, k0, v0)
            o0, o1 = to_out(o0), to_out(o1)
        if pad:
            return torch.cat([o0, o0.new_zeros(b, pad, o0.shape[-1]), o1], dim=1)
        return torch.cat([o0, o1], dim=1)
