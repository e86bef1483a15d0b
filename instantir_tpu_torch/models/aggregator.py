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
is recomputed in the backward pass. ``pad_concat``, ``attn1_mode`` and
``aggregator_adapter`` are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from instantir_tpu_torch.models.layers import TimestepEmbedding
from instantir_tpu_torch.models.unet import (
    UNetConfig,
    build_down_blocks,
    build_mid_block,
    down_stack_channels,
    time_and_added_embedding,
)


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


class Aggregator(nn.Module):
    """SDXL down+mid trunk on the H-concatenated (LQ, preview) pair (NCHW)."""

    def __init__(self, config: UNetConfig, use_flash: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.gradient_checkpointing = cfg.gradient_checkpointing  # may be switched between calls
        common = dict(dtype=dtype, device=device)
        no_lora = dict(lora_rank=0, lora_alpha=1.0)
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1, **common)
        self.ref_conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1, **common)
        self.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim, **common)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim,
                                               **common)
        self.down_blocks = build_down_blocks(cfg, False, False, no_lora, use_flash, common)
        self.mid_block = build_mid_block(cfg, False, False, no_lora, use_flash, common)
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
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        cfg = self.config
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        emb = time_and_added_embedding(cfg, self.time_embedding, self.add_embedding, timesteps,
                                       added_text_embeds, added_time_ids)

        def run(block, *args):
            if self.gradient_checkpointing and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        x = torch.cat([self.conv_in(sample.to(self.dtype)), self.ref_conv_in(controlnet_cond.to(self.dtype))], dim=2)
        res_samples = (x,)
        for block in self.down_blocks:
            x, res = run(block, x, emb)
            res_samples = res_samples + res
        x = run(self.mid_block, x, emb)

        down = tuple(self._head(head, r) * conditioning_scale
                     for head, r in zip(self.controlnet_down_blocks, res_samples))
        mid = self._head(self.controlnet_mid_block, x) * conditioning_scale
        return down, mid

