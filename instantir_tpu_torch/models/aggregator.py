"""Aggregator -- the ControlNet variant that fuses the LQ latent with the
previewer's clean latent into per-resolution UNet residuals.

Twin of ``instantir_tpu/models/aggregator.py::Aggregator``:
  * two conv stems, ``conv_in`` (LQ latent) and ``ref_conv_in`` (preview latent);
  * the two streams concatenated along H, doubling the self-attention sequence;
  * the SDXL down+mid trunk with cross-attention removed;
  * each skip activation and the mid activation split back into (cond, ref)
    halves and passed through an SFT head (3x3 conv -> SiLU -> gamma/beta convs
    modulating the ref half) and a zero-init 1x1 conv, times
    ``conditioning_scale``.
The Aggregator never carries LoRA. With ``gradient_checkpointing`` (from
``UNetConfig``, switchable between calls) each down block and the mid block
is recomputed in the backward pass.

The ablations of the JAX module, each off by default:
  * ``pad_concat``: a zero row between the two streams at the stem, re-zeroed
    after every down block (the rebuilt map also replaces that block's last
    residual);
  * ``attn1_mode``: ``"plain"`` (joint self-attention over the whole map),
    ``"split"`` (joint, the pad row left out) or ``"sep_split"`` (per-stream
    self-attention plus AdaLN'd cross-stream attention, ``ref_scale``);
  * ``aggregator_adapter``: a time-aware IP branch on every self-attention
    (``processor.to_k_ip`` / ``to_v_ip`` / ``ln_k_ip`` / ``ln_v_ip``) over
    ``ip_hidden_states``, the image tokens the caller projects first (stage 2's
    ``agg_resampler``); it needs ``attn1_mode="plain"``;
  * ``global_pool_conditions``: every residual mean-pooled over H and W.
``ConditioningEmbedding`` is the JAX package's pixel-space condition encoder,
which no Aggregator path uses.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from instantir_tpu_torch.models.layers import LoRAConv2d, TimestepEmbedding
from instantir_tpu_torch.models.unet import (
    UNetConfig,
    build_down_blocks,
    build_mid_block,
    down_stack_channels,
    time_and_added_embedding,
)
from instantir_tpu_torch.models.unet_blocks import CrossAttnDownBlock2D


class SFT(nn.Module):
    """SFT modulation of the ref stream by the cond stream."""

    def __init__(self, channels: int, hidden: int = 128, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        self.mlp_shared = nn.Sequential(nn.Conv2d(channels, hidden, 3, padding=1, **common), nn.SiLU())
        self.mul = nn.Conv2d(hidden, channels, 3, padding=1, **common)
        self.add = nn.Conv2d(hidden, channels, 3, padding=1, **common)

    def forward(self, cond: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        actv = self.mlp_shared(cond)
        return ref * (self.mul(actv) + 1.0) + self.add(actv)


def sft_head(channels: int, dtype, device) -> nn.ModuleList:
    """``[SFT, zero 1x1 conv]`` (state-dict names ``.0.*`` and ``.1``)."""
    zero_conv = nn.Conv2d(channels, channels, 1, dtype=dtype, device=device)
    nn.init.zeros_(zero_conv.weight)
    nn.init.zeros_(zero_conv.bias)
    return nn.ModuleList([SFT(channels, dtype=dtype, device=device), zero_conv])


def _split_h(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hh = t.shape[2]
    return t[:, :, : hh // 2], t[:, :, hh - hh // 2 :]


def _pad_row(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``[c; zero row; r]`` along H."""
    return torch.cat([c, c.new_zeros(c.shape[0], c.shape[1], 1, c.shape[3]), r], dim=2)


def _rebuild_pad(t: torch.Tensor) -> torch.Tensor:
    """The map with its middle row zeroed again, each stream's rows kept."""
    cond, ref = _split_h(t)
    return _pad_row(cond, ref)


class ConditioningEmbedding(nn.Module):
    """ControlNet-style pixel-space condition encoder, twin of the JAX
    module: ``conv_in`` -> SiLU -> [3x3 conv -> SiLU -> 3x3 stride-2 conv ->
    SiLU] x (len - 1) -> zero-init ``conv_out`` (NCHW)."""

    def __init__(self, embedding_channels: int, block_out_channels: Sequence[int] = (16, 32, 96, 256),
                 conditioning_channels: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        chans = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(conditioning_channels, chans[0], 3, padding=1, **common)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(nn.Conv2d(chans[i], chans[i], 3, padding=1, **common))
            blocks.append(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1, **common))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], embedding_channels, 3, padding=1, **common)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(conditioning.to(self.conv_in.weight.dtype)))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class Aggregator(nn.Module):
    """SDXL down+mid trunk on the H-concatenated (LQ, preview) pair (NCHW)."""

    def __init__(self, config: UNetConfig, use_flash: bool = True, dtype=torch.float32, device=None,
                 pad_concat: bool = False, attn1_mode: str = "plain", aggregator_adapter: bool = False,
                 global_pool_conditions: bool = False):
        super().__init__()
        if aggregator_adapter and attn1_mode != "plain":
            raise ValueError("aggregator_adapter requires attn1_mode='plain' (the split-attention "
                             "ablations replace attn1 with SplitAttention, which has no ip branch)")
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.use_flash = use_flash
        self.pad_concat = pad_concat
        self.attn1_mode = attn1_mode
        self.aggregator_adapter = aggregator_adapter
        self.global_pool_conditions = global_pool_conditions
        self.gradient_checkpointing = cfg.gradient_checkpointing  # may be switched between calls
        common = dict(dtype=dtype, device=device)
        no_lora = dict(lora_rank=0, lora_alpha=1.0)
        variant = dict(attn1_with_ip=aggregator_adapter, attn1_mode=attn1_mode)
        c0 = cfg.block_out_channels[0]
        self.conv_in = LoRAConv2d(cfg.in_channels, c0, 3, padding=1, **common)  # LoRA-less bases, quantizable
        self.ref_conv_in = LoRAConv2d(cfg.in_channels, c0, 3, padding=1, **common)
        self.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim, **common)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim,
                                               **common)
        self.down_blocks = build_down_blocks(cfg, False, False, no_lora, use_flash, common, **variant)
        self.mid_block = build_mid_block(cfg, False, False, no_lora, use_flash, common, **variant)
        self.controlnet_down_blocks = nn.ModuleList([sft_head(ch, dtype, device) for ch in down_stack_channels(cfg)])
        self.controlnet_mid_block = sft_head(cfg.block_out_channels[-1], dtype, device)

    @staticmethod
    def _head(head: nn.ModuleList, t: torch.Tensor) -> torch.Tensor:
        cond, ref = _split_h(t)
        return head[1](head[0](cond, ref))

    def forward(
        self,
        sample: torch.Tensor,  # [B, 4, H, W] LQ latent
        timesteps: torch.Tensor,  # [B] or scalar
        controlnet_cond: torch.Tensor,  # [B, 4, H, W] preview latent
        added_text_embeds: torch.Tensor,
        added_time_ids: torch.Tensor,
        conditioning_scale: float = 1.0,
        ip_hidden_states: Optional[torch.Tensor] = None,  # aggregator_adapter tokens [B, N, cross_dim]
        ip_scale: Optional[float] = None,
        ref_scale: float = 1.0,  # sep_split's cross-stream strength
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        if self.aggregator_adapter and ip_hidden_states is None:
            raise ValueError("aggregator_adapter=True requires ip_hidden_states (project the "
                             "image-encoder tokens through the aggregator's Resampler first)")
        cfg = self.config
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        emb = time_and_added_embedding(cfg, self.time_embedding, self.add_embedding, timesteps,
                                       added_text_embeds, added_time_ids)
        # sep_split's AdaLN and the adapter's TA-IP AdaLN read the combined time embedding
        attn_temb = emb if (self.attn1_mode == "sep_split" or self.aggregator_adapter) else None
        attn_kw = dict(ip_hidden_states=ip_hidden_states, attn_temb=attn_temb, ip_scale=ip_scale,
                       ref_scale=ref_scale)

        def run(block, *args, **kwargs):
            if self.gradient_checkpointing and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False, **kwargs)
            return block(*args, **kwargs)

        cond = self.conv_in(sample.to(self.dtype))
        ref = self.ref_conv_in(controlnet_cond.to(self.dtype))
        x = _pad_row(cond, ref) if self.pad_concat else torch.cat([cond, ref], dim=2)
        res_samples = (x,)
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock2D):
                x, res = run(block, x, emb, **attn_kw)
            else:
                x, res = run(block, x, emb)
            if self.pad_concat:
                x = _rebuild_pad(x)
                res = res[:-1] + (x,)
            res_samples = res_samples + res
        x = run(self.mid_block, x, emb, **attn_kw)

        down = tuple(self._head(head, r) * conditioning_scale
                     for head, r in zip(self.controlnet_down_blocks, res_samples))
        mid = self._head(self.controlnet_mid_block, x) * conditioning_scale
        if self.global_pool_conditions:
            down = tuple(r.mean(dim=(2, 3), keepdim=True) for r in down)
            mid = mid.mean(dim=(2, 3), keepdim=True)
        return down, mid
