"""SDXL AutoencoderKL (NCHW).

Twin of ``instantir_tpu/models/vae.py``: diffusers ``AutoencoderKL`` as the
InstantIR pipeline uses it (blocks [128, 256, 512, 512], 2 layers per block,
latent 4 channels, scaling_factor 0.13025, single-head mid-block attention
with biased QKV and a residual). The encoder downsamples with the asymmetric
(0,1)x(0,1) padding diffusers uses. ``encode`` takes the posterior noise as an
argument. ``decode(z, dtype=torch.bfloat16)`` runs the decoder in bf16 from
the fp32 weights, as the JAX package's bf16 ``AutoencoderKL`` applies the fp32
tree. ``tiled_decode`` / ``tiled_encode_moments`` / ``tiled_encode`` are the
constant-memory tiled VAE (uniform tiles, the last one shifted inward,
weight-normalised tent blending). Its GroupNorms take the dispatch every
``GroupNorm32`` takes (``ops.group_norm.group_norm_silu``): on the card the
fused kernel, whose ``reread`` path takes the long slabs (up to 33.5 MB a
group in fp32 at 1024²).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from instantir_tpu_torch.models.layers import GroupNorm32
from instantir_tpu_torch.ops.attention import attention_xla


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    latents_mean: Optional[Tuple[float, ...]] = None
    latents_std: Optional[Tuple[float, ...]] = None


def sdxl_vae_config(**overrides) -> VAEConfig:
    return dataclasses.replace(VAEConfig(), **overrides)


def tiny_vae_config(**overrides) -> VAEConfig:
    base = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
    return dataclasses.replace(base, **overrides)


def vae_scale_factor(cfg: VAEConfig) -> int:
    return 2 ** (len(cfg.block_out_channels) - 1)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_num_groups: int = 32, dtype=torch.float32,
                 device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm32(norm_num_groups, in_channels, eps=1e-6, fuse_silu=True, **common)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **common)
        self.norm2 = GroupNorm32(norm_num_groups, out_channels, eps=1e-6, fuse_silu=True, **common)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **common)
        self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1, **common) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head full-channel attention with biased QKV + residual. Calls
    ``attention_xla`` directly, as the JAX block does."""

    def __init__(self, channels: int, norm_num_groups: int = 32, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm32(norm_num_groups, channels, eps=1e-6, **common)
        self.to_q = nn.Linear(channels, channels, **common)
        self.to_k = nn.Linear(channels, channels, **common)
        self.to_v = nn.Linear(channels, channels, **common)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **common)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = attention_xla(self.to_q(y), self.to_k(y), self.to_v(y)).reshape(b, h * w, c)
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int = 32, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(norm_num_groups=norm_num_groups, dtype=dtype, device=device)
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, **common) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, **common)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    def __init__(self, channels: int, stride: int, padding: int, dtype, device):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=padding, dtype=dtype, device=device)


class _VAEBlock(nn.Module):
    def __init__(self, resnets, sampler_name: Optional[str], sampler: Optional[nn.Module]):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler_name is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))
        self.sampler_name = sampler_name


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        rn = dict(norm_num_groups=cfg.norm_num_groups, **common)
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1, **common)
        blocks = []
        in_ch = chans[0]
        for i, ch in enumerate(chans):
            resnets = [VAEResnetBlock(in_ch if j == 0 else ch, ch, **rn) for j in range(cfg.layers_per_block)]
            final = i == len(chans) - 1
            blocks.append(_VAEBlock(resnets, None if final else "downsamplers",
                                    None if final else _Sampler(ch, 2, 0, dtype, device)))
            in_ch = ch
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(chans[-1], **rn)
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, chans[-1], eps=1e-6, fuse_silu=True, **common)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if block.sampler_name is not None:
                # diffusers VAE downsample: pad (0,1)x(0,1), stride-2, no pad in the conv
                x = block.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        common = dict(dtype=dtype, device=device)
        rn = dict(norm_num_groups=cfg.norm_num_groups, **common)
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1, **common)
        self.mid_block = VAEMidBlock(rev[0], **rn)
        blocks = []
        in_ch = rev[0]
        for i, ch in enumerate(rev):
            resnets = [VAEResnetBlock(in_ch if j == 0 else ch, ch, **rn) for j in range(cfg.layers_per_block + 1)]
            final = i == len(rev) - 1
            blocks.append(_VAEBlock(resnets, None if final else "upsamplers",
                                    None if final else _Sampler(ch, 1, 1, dtype, device)))
            in_ch = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, rev[-1], eps=1e-6, fuse_silu=True, **common)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1, **common)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if block.sampler_name is not None:
                x = block.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(x))


class _DecodePath(nn.Module):
    """``post_quant_conv`` then the decoder, under AutoencoderKL's parameter
    names: the module ``AutoencoderKL.decode`` applies in another dtype."""

    def __init__(self, config: VAEConfig, dtype, device):
        super().__init__()
        self.decoder = Decoder(config, dtype=dtype, device=device)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1, dtype=dtype, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        common = dict(dtype=dtype, device=device)
        self.encoder = Encoder(config, **common)
        self.decoder = Decoder(config, **common)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1, **common)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1, **common)
        self._decode_paths: Dict[torch.dtype, _DecodePath] = {}  # per other dtype, on the meta device

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of the diagonal Gaussian posterior, NCHW."""
        mean, logvar = self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior sample ``mean + std * noise`` (or the mode when ``noise``
        is None) -- not yet scaled by ``scaling_factor``."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Latents (unscaled) -> image, NCHW. ``dtype`` other than the
        module's runs ``post_quant_conv`` and the decoder in that dtype from
        this module's weights, cast on every call so that they never go stale
        (GroupNorm weights and statistics stay fp32), through a weightless
        copy of the modules on the meta device."""
        if dtype is None or dtype == self.dtype:
            return self.decoder(self.post_quant_conv(z.to(self.dtype)))
        path = self._decode_paths.get(dtype)
        if path is None:
            path = self._decode_paths[dtype] = _DecodePath(self.config, dtype, "meta")
        own = dict(self.named_parameters())
        weights = {name: own[name].to(p.dtype) for name, p in path.named_parameters()}
        return torch.func.functional_call(path, weights, (z,))


# ---------------------------------------------------------------------------
# Tiled encode/decode: constant-memory VAE at large resolutions. Every tile has
# the same shape (the last row and column of tiles are shifted inward, not
# shrunk); the outputs are blended with separable tent weights normalised by
# their sum, one tile at a time on a canvas.
# ---------------------------------------------------------------------------


def _tile_starts(size: int, tile: int, stride: int) -> Tuple[int, ...]:
    """Tile origins covering [0, size) with a final inward-shifted tile."""
    if size <= tile:
        return (0,)
    starts = []
    pos = 0
    while pos + tile < size:
        starts.append(pos)
        pos += stride
    starts.append(size - tile)
    return tuple(starts)


def _tent_weights(length: int, blend: int, device) -> torch.Tensor:
    """1D weight profile: a linear ramp over ``blend`` samples at both ends."""
    i = torch.arange(length, dtype=torch.float32, device=device)
    up = (i + 1.0) / (blend + 1.0)
    down = (length - i) / (blend + 1.0)
    return torch.clamp(torch.minimum(up, down), max=1.0)


def _tiled_accumulate(tile_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, tile_in: int,
                      stride_in: int, out_scale_num: int, out_scale_den: int, out_channels: int,
                      overlap: float) -> torch.Tensor:
    """Run ``tile_fn`` on uniform NCHW tiles of ``x`` and blend its outputs on
    a weight-normalised fp32 canvas. ``out_scale_num / out_scale_den`` maps
    input to output coordinates (8/1 for decode, 1/8 for encode at SDXL)."""
    b, _, h, w = x.shape

    def to_out(v: int) -> int:
        return v * out_scale_num // out_scale_den

    t_out = to_out(tile_in)
    blend = max(1, to_out(max(out_scale_den, int(round(tile_in * overlap)))))
    w1d = _tent_weights(t_out, blend, x.device)
    mask = (w1d[:, None] * w1d[None, :])[None, None]
    canvas = torch.zeros((b, out_channels, to_out(h), to_out(w)), dtype=torch.float32, device=x.device)
    wsum = torch.zeros((1, 1, to_out(h), to_out(w)), dtype=torch.float32, device=x.device)
    for y in _tile_starts(h, tile_in, stride_in):
        for x0 in _tile_starts(w, tile_in, stride_in):
            out = tile_fn(x[:, :, y:y + tile_in, x0:x0 + tile_in]).float()
            oy, ox = to_out(y), to_out(x0)
            canvas[:, :, oy:oy + t_out, ox:ox + t_out] += out * mask
            wsum[:, :, oy:oy + t_out, ox:ox + t_out] += mask
    return canvas / wsum


def tiled_decode(vae: AutoencoderKL, z: torch.Tensor, *, tile_latent: int = 96, overlap: float = 0.25,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``vae.decode(z, dtype)`` tile by tile with blended overlaps (NCHW); the
    plain decode when the latent fits one tile. The output is in the
    decode's dtype."""
    _, _, h, w = z.shape
    if h <= tile_latent and w <= tile_latent:
        return vae.decode(z, dtype)
    tile = min(tile_latent, h, w)
    stride = max(1, int(tile * (1.0 - overlap)))
    out = _tiled_accumulate(lambda zt: vae.decode(zt, dtype), z, tile, stride, vae_scale_factor(vae.config), 1,
                            vae.config.out_channels, overlap)
    return out.to(dtype or vae.dtype)


def tiled_encode_moments(vae: AutoencoderKL, x: torch.Tensor, *, tile_sample: int = 768,
                         overlap: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled posterior moments (NCHW): per-tile ``encode_moments`` blended in
    latent space. Tile origins and strides stay multiples of the downsample
    factor so that latent offsets are whole."""
    scale = vae_scale_factor(vae.config)
    _, _, h, w = x.shape
    if h <= tile_sample and w <= tile_sample:
        return vae.encode_moments(x)
    tile = min(tile_sample, h, w)
    tile -= tile % scale
    stride = max(scale, int(tile * (1.0 - overlap)))
    stride -= stride % scale
    if h % scale or w % scale:
        raise ValueError(f"tiled encode needs /{scale}-aligned input, got {h}x{w}")
    moments = _tiled_accumulate(lambda xt: torch.cat(vae.encode_moments(xt), dim=1), x, tile, stride, 1, scale,
                                2 * vae.config.latent_channels, overlap)
    mean, logvar = moments.to(vae.dtype).chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def tiled_encode(vae: AutoencoderKL, x: torch.Tensor, noise: Optional[torch.Tensor] = None, *,
                 tile_sample: int = 768, overlap: float = 0.25) -> torch.Tensor:
    """Tiled counterpart of ``AutoencoderKL.encode``: ``mean + std * noise``
    (the mode when ``noise`` is None)."""
    mean, logvar = tiled_encode_moments(vae, x, tile_sample=tile_sample, overlap=overlap)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)


@functools.lru_cache(maxsize=None)
def _latent_stats(cfg: VAEConfig, dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``latents_mean`` and ``latents_std`` as [1, C, 1, 1] tensors on
    ``device``, built once per (config, dtype, device): a copy from host
    memory stalls the stream and cannot be recorded in a CUDA graph. Callers
    do not write to them."""
    shape = (1, -1, 1, 1)
    return (torch.tensor(cfg.latents_mean, dtype=dtype, device=device).reshape(shape),
            torch.tensor(cfg.latents_std, dtype=dtype, device=device).reshape(shape))


def scale_latents(cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Raw posterior latents -> model space (x scaling_factor, mean/std norm); NCHW."""
    if cfg.latents_mean is not None and cfg.latents_std is not None:
        mean, std = _latent_stats(cfg, z.dtype, z.device)
        return (z - mean) * cfg.scaling_factor / std
    return z * cfg.scaling_factor


def unscale_latents(cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Model-space latents -> decoder input; NCHW."""
    if cfg.latents_mean is not None and cfg.latents_std is not None:
        mean, std = _latent_stats(cfg, z.dtype, z.device)
        return z * std / cfg.scaling_factor + mean
    return z / cfg.scaling_factor
