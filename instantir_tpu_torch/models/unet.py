"""SDXL UNet2DConditionModel (NCHW, functional LoRA, fused IP branch).

Twin of ``instantir_tpu/models/unet.py``. The config mirrors
stabilityai/stable-diffusion-xl-base-1.0's UNet: blocks [320, 640, 1280],
transformer depths [-, 2, 10], heads [5, 10, 20] (head_dim 64),
cross-attention dim 2048, text_time added embeddings (2816 = 1280 pooled +
6 x 256 time ids). The previewer LoRA is a forward argument (``lora_scale``),
the image-prompt tokens an explicit input, and the time-aware IP AdaLN reads
the UNet's own time embedding. Parameter names are the diffusers names.
``forward`` also takes DeepCache's split (``return_deep`` / ``cached_deep``).
``UNetConfig.residual_fusion`` says how the Aggregator's residuals enter:
``"add"`` (SDXL / InstantIR) or ``"zero_sft"`` (each up-block resnet fuses its
(residual, skip) pair through its own ``zero_sfts.{j}``, the mid residual
through ``mid_zero_sft``; ``models/zero_sft.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from instantir_tpu_torch.models.layers import GroupNorm32, LoRAConv2d, TimestepEmbedding, get_timestep_embedding
from instantir_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlock2D,
    CrossAttnUpBlock2D,
    DownBlock2D,
    UNetMidBlock2DCrossAttn,
    UpBlock2D,
)
from instantir_tpu_torch.models.zero_sft import ZeroSFT


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = ("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32
    time_cond_proj_dim: Optional[int] = None
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    with_ip: bool = False  # decoupled image-prompt branch in every cross-attention
    time_aware_ip: bool = True
    lora_rank: int = 0  # previewer LoRA rank (0 = no LoRA params)
    lora_alpha: float = 1.0
    # how the Aggregator's residuals enter: "add" or "zero_sft" (GroupNorm-SFT
    # modulation with zero-init convolutions at every skip and the mid block)
    residual_fusion: str = "add"
    # recompute each down/mid/up block in the backward pass instead of storing
    # its activations (``torch.utils.checkpoint`` per block); the parameters
    # and the outputs are the same with the flag on or off
    gradient_checkpointing: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def sdxl_base_config(**overrides) -> UNetConfig:
    return dataclasses.replace(UNetConfig(), **overrides)


def tiny_unet_config(**overrides) -> UNetConfig:
    """A shape-faithful miniature for CPU tests (same topology, tiny dims)."""
    base = UNetConfig(
        sample_size=16,
        block_out_channels=(32, 64, 64),
        transformer_layers_per_block=(1, 1, 2),
        num_attention_heads=(2, 4, 4),
        cross_attention_dim=32,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 16,
        norm_num_groups=8,
    )
    return dataclasses.replace(base, **overrides)


def down_stack_channels(cfg: UNetConfig) -> Tuple[int, ...]:
    """Channels of every skip connection the down path pushes, in order."""
    chans = [cfg.block_out_channels[0]]
    for i, ch in enumerate(cfg.block_out_channels):
        chans += [ch] * cfg.layers_per_block
        if i < len(cfg.block_out_channels) - 1:
            chans.append(ch)
    return tuple(chans)


def build_down_blocks(cfg: UNetConfig, has_cross_attention: bool, with_ip: bool, lora: dict, use_flash: bool,
                      common: dict, attn1_with_ip: bool = False, attn1_mode: str = "plain") -> nn.ModuleList:
    """The SDXL down path (shared by the UNet and the Aggregator trunk, whose
    self-attentions take ``attn1_with_ip`` and ``attn1_mode``)."""
    blocks = []
    in_ch = cfg.block_out_channels[0]
    for i, block_type in enumerate(cfg.down_block_types):
        out_ch = cfg.block_out_channels[i]
        kw = dict(temb_channels=cfg.time_embed_dim, num_layers=cfg.layers_per_block,
                  add_downsample=i < len(cfg.down_block_types) - 1, norm_num_groups=cfg.norm_num_groups,
                  **lora, **common)
        if block_type == "CrossAttnDownBlock2D":
            heads = cfg.num_attention_heads[i]
            blocks.append(CrossAttnDownBlock2D(
                in_ch, out_ch, heads=heads, head_dim=out_ch // heads,
                transformer_layers=cfg.transformer_layers_per_block[i],
                cross_attention_dim=cfg.cross_attention_dim, has_cross_attention=has_cross_attention,
                with_ip=with_ip, time_aware_ip=cfg.time_aware_ip, use_flash=use_flash, attn1_with_ip=attn1_with_ip,
                attn1_mode=attn1_mode, **kw))
        elif block_type == "DownBlock2D":
            blocks.append(DownBlock2D(in_ch, out_ch, **kw))
        else:
            raise ValueError(f"unknown down block type {block_type!r}")
        in_ch = out_ch
    return nn.ModuleList(blocks)


def build_mid_block(cfg: UNetConfig, has_cross_attention: bool, with_ip: bool, lora: dict, use_flash: bool,
                    common: dict, attn1_with_ip: bool = False, attn1_mode: str = "plain") -> UNetMidBlock2DCrossAttn:
    heads = cfg.num_attention_heads[-1]
    mid_ch = cfg.block_out_channels[-1]
    return UNetMidBlock2DCrossAttn(
        mid_ch, cfg.time_embed_dim, heads=heads, head_dim=mid_ch // heads,
        transformer_layers=cfg.transformer_layers_per_block[-1], cross_attention_dim=cfg.cross_attention_dim,
        has_cross_attention=has_cross_attention, with_ip=with_ip, time_aware_ip=cfg.time_aware_ip,
        norm_num_groups=cfg.norm_num_groups, use_flash=use_flash, attn1_with_ip=attn1_with_ip, attn1_mode=attn1_mode,
        **lora, **common)


def time_and_added_embedding(cfg: UNetConfig, time_embedding: nn.Module, add_embedding: nn.Module,
                             timesteps: torch.Tensor, added_text_embeds: torch.Tensor, added_time_ids: torch.Tensor,
                             timestep_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """emb = TimeEmbedding(sinusoid(t)) + AddEmbedding([pooled, sinusoid(time_ids)]),
    the sinusoids in fp32."""
    b = added_text_embeds.shape[0]
    t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
    emb = time_embedding(t_emb, timestep_cond)
    time_embeds = get_timestep_embedding(
        added_time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos, cfg.freq_shift
    ).reshape(b, -1)
    add_embeds = torch.cat([added_text_embeds.float(), time_embeds], dim=-1)
    return emb + add_embedding(add_embeds)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, use_flash: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.gradient_checkpointing = cfg.gradient_checkpointing  # may be switched between calls
        common = dict(dtype=dtype, device=device)
        lora = dict(lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)
        c0 = cfg.block_out_channels[0]
        self.conv_in = LoRAConv2d(cfg.in_channels, c0, 3, padding=1, **common)  # a LoRA-less base, quantizable
        self.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim, cfg.time_cond_proj_dim, **common)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim,
                                               **common)
        zero_sft = cfg.residual_fusion == "zero_sft"
        self.down_blocks = build_down_blocks(cfg, True, cfg.with_ip, lora, use_flash, common)
        self.mid_block = build_mid_block(cfg, True, cfg.with_ip, lora, use_flash, common)
        mid_ch = cfg.block_out_channels[-1]
        self.mid_zero_sft = (ZeroSFT(mid_ch, mid_ch, norm_num_groups=cfg.norm_num_groups, **common)
                             if zero_sft else None)

        skips = list(down_stack_channels(cfg))
        reversed_channels = tuple(reversed(cfg.block_out_channels))
        reversed_heads = tuple(reversed(cfg.num_attention_heads))
        reversed_layers = tuple(reversed(cfg.transformer_layers_per_block))
        up = []
        prev_ch = cfg.block_out_channels[-1]
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = reversed_channels[i]
            num_res = cfg.layers_per_block + 1
            skip_channels = tuple(reversed(skips[-num_res:]))
            del skips[-num_res:]
            kw = dict(temb_channels=cfg.time_embed_dim, add_upsample=i < len(cfg.up_block_types) - 1,
                      norm_num_groups=cfg.norm_num_groups, zero_sft=zero_sft, **lora, **common)
            if block_type == "CrossAttnUpBlock2D":
                heads = reversed_heads[i]
                up.append(CrossAttnUpBlock2D(
                    prev_ch, out_ch, skip_channels, heads=heads, head_dim=out_ch // heads,
                    transformer_layers=reversed_layers[i], cross_attention_dim=cfg.cross_attention_dim,
                    with_ip=cfg.with_ip, time_aware_ip=cfg.time_aware_ip, use_flash=use_flash, **kw))
            elif block_type == "UpBlock2D":
                up.append(UpBlock2D(prev_ch, out_ch, skip_channels, **kw))
            else:
                raise ValueError(f"unknown up block type {block_type!r}")
            prev_ch = out_ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, c0, fuse_silu=True, **common)
        self.conv_out = LoRAConv2d(c0, cfg.out_channels, 3, padding=1, **common)

    def forward(
        self,
        sample: torch.Tensor,  # [B, C, H, W] latents
        timesteps: torch.Tensor,  # [B] or scalar
        encoder_hidden_states: torch.Tensor,  # [B, 77·k, cross_dim]
        added_text_embeds: torch.Tensor,  # [B, pooled_dim]
        added_time_ids: torch.Tensor,  # [B, 6]
        ip_hidden_states: Optional[torch.Tensor] = None,  # [B, 64, cross_dim]
        timestep_cond: Optional[torch.Tensor] = None,
        down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
        lora_scale: float = 0.0,
        ip_scale: Optional[float] = None,
        cached_deep: Optional[torch.Tensor] = None,
        return_deep: bool = False,
        cache_depth: int = 1,
    ):
        """DeepCache split execution (twin of the JAX UNet's):

        * ``return_deep=True`` -- the full forward, which also returns the
          feature entering up block ``n_up - cache_depth`` (the deep trunk's
          output): ``(out, deep)``.
        * ``cached_deep=<that feature>`` -- the shallow forward: only the first
          ``cache_depth`` down blocks (for fresh skip connections) and the last
          ``cache_depth`` up blocks, on top of the cached trunk.

        ``shallow(x, cached_deep=deep(x)) == full(x)`` bit for bit; the split
        approximates only when the trunk is reused across timesteps. In
        shallow mode ``down_block_additional_residuals`` must be the shallow
        skip slice (the first ``3·cache_depth`` entries at layers_per_block 2)
        and ``mid_block_additional_residual`` is unused; ``cached_deep``
        requires ``residual_fusion='add'``. With ``'zero_sft'`` the residuals
        are required: each is paired with its skip and fused in the up block.
        """
        cfg = self.config
        b = sample.shape[0]
        shallow = cached_deep is not None
        n_blocks = len(cfg.down_block_types)
        if shallow or return_deep:
            if not 1 <= cache_depth < n_blocks:
                raise ValueError(f"cache_depth must be in [1, {n_blocks - 1}], got {cache_depth}")
            if shallow and cfg.residual_fusion != "add":
                raise ValueError("cached_deep requires residual_fusion='add'")
        timesteps = torch.as_tensor(timesteps, device=sample.device).reshape(-1).expand(b)
        emb = time_and_added_embedding(cfg, self.time_embedding, self.add_embedding, timesteps,
                                       added_text_embeds, added_time_ids, timestep_cond)
        attn_kw = dict(encoder_hidden_states=encoder_hidden_states, ip_hidden_states=ip_hidden_states,
                       attn_temb=emb, lora_scale=lora_scale, ip_scale=ip_scale)

        def run(block, *args, **kwargs):
            if self.gradient_checkpointing and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False, **kwargs)
            return block(*args, **kwargs)

        sample = self.conv_in(sample.to(self.dtype))
        down_res = (sample,)
        for i, block in enumerate(self.down_blocks):
            if shallow and i >= cache_depth:
                break
            if isinstance(block, CrossAttnDownBlock2D):
                sample, res = run(block, sample, emb, **attn_kw)
            else:
                sample, res = run(block, sample, emb, lora_scale)
            down_res = down_res + res

        if shallow:
            # the boundary level's downsample output feeds a deep up block that
            # does not run: the list keeps exactly the skips the shallow up blocks pop
            down_res = down_res[:-1]
            if down_block_additional_residuals is not None and len(down_block_additional_residuals) != len(down_res):
                raise ValueError(f"shallow mode expects {len(down_res)} residuals (the shallow skip slice), "
                                 f"got {len(down_block_additional_residuals)}")
        zero_sft = cfg.residual_fusion == "zero_sft"
        if down_block_additional_residuals is not None:
            if zero_sft:  # (control, skip) pairs, fused in the up blocks
                down_res = tuple((r.to(s.dtype), s) for s, r in zip(down_res, down_block_additional_residuals))
            else:
                down_res = tuple(s + r.to(s.dtype) for s, r in zip(down_res, down_block_additional_residuals))
        elif zero_sft:
            raise ValueError("residual_fusion='zero_sft' is a controlnet-fusion variant; it requires "
                             "down_block_additional_residuals/mid_block_additional_residual")

        if shallow:  # the mid block lives in the cached trunk
            sample = cached_deep.to(self.dtype)
        else:
            sample = run(self.mid_block, sample, emb, **attn_kw)
            if mid_block_additional_residual is not None:
                if zero_sft:
                    sample = self.mid_zero_sft(mid_block_additional_residual.to(sample.dtype), sample)
                else:
                    sample = sample + mid_block_additional_residual.to(sample.dtype)

        deep = None
        n_up = len(self.up_blocks)
        for i, block in enumerate(self.up_blocks):
            if shallow and i < n_up - cache_depth:
                continue
            if return_deep and i == n_up - cache_depth:
                deep = sample
            num_res = len(block.resnets)
            res, down_res = down_res[-num_res:], down_res[:-num_res]
            if isinstance(block, CrossAttnUpBlock2D):
                sample = run(block, sample, res, emb, **attn_kw)
            else:
                sample = run(block, sample, res, emb, lora_scale)

        out = self.conv_out(self.conv_norm_out(sample))
        return (out, deep) if return_deep else out
