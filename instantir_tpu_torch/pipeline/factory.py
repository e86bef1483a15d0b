"""Pipeline assembly: build the port's models on a device, with synthetic weights.

Twin of ``instantir_tpu/pipeline/factory.py::build_pipeline``. The UNet,
Aggregator, Resampler and DINOv2 run in ``dtype``; the VAE runs in fp32 (the
reference's force_upcast). Every parameter is drawn on the device from a
``torch.Generator`` seeded with ``seed``: weights vary (all-equal weights
drive GroupNorm to NaN), norm scales are 1 and biases 0, and the LoRA-B and
zero-conv weights are nonzero so those paths do real work. Real weights go in
afterwards with ``load_state_dict``; ``pipeline.load`` builds the models
from checkpoint files instead, with ``init_aggregator_from_unet`` when no
Aggregator checkpoint is given.

Storage: in ``dtype`` (norms fp32), where the JAX ``build_pipeline`` keeps
fp32 parameters under bf16 compute. Both give JAX's result up to bf16
arithmetic order, so the port does not keep fp32 copies: flax rounds every
kernel and bias to the compute dtype at each use, which is the rounding bf16
storage makes once; the norms stay fp32 in both; only the merged previewer
LoRA (``fuse_previewer_lora``) differs, merged here from bf16 values where
JAX merges fp32 ones and rounds once, by at most one bf16 ulp of a layer's
largest weight. A one-step CFG restore with the merged LoRA is then no
further from JAX's than the same restore with the dynamic LoRA branch,
where storage cannot matter (``tests/test_torch_port_bf16_merge.py``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.dinov2 import DINOv2Config, DINOv2Model
from instantir_tpu_torch.models.layers import GroupNorm32
from instantir_tpu_torch.models.resampler import Resampler, ResamplerConfig
from instantir_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from instantir_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline
from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule


@torch.no_grad()
def synthesize_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``model`` in place from ``generator``."""
    for name, p in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        if isinstance(owner, (GroupNorm32, nn.LayerNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
            continue
        if leaf == "bias":
            p.zero_()
            continue
        if p.dim() >= 2 and p.shape[0] > 1:  # linear / conv weights: fan-in scaled
            std = p[0].numel() ** -0.5
        elif p.dim() >= 2:  # cls token, position embeddings, resampler latents
            std = 0.02
        else:  # layer scales
            std = 0.1
        p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device) * std)
    return model


def build_pipeline(
    unet_config: UNetConfig,
    vae_config: VAEConfig,
    resampler_config: ResamplerConfig,
    dino_config: DINOv2Config,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> InstantIRPipeline:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_pipeline: device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to build on the CPU)")
    models = [
        UNet2DConditionModel(unet_config, dtype=dtype, device=device),
        Aggregator(unet_config, dtype=dtype, device=device),
        AutoencoderKL(vae_config, dtype=torch.float32, device=device),
        Resampler(resampler_config, dtype=dtype, device=device),
        DINOv2Model(dino_config, dtype=dtype, device=device),
    ]
    generator = torch.Generator(device=device).manual_seed(seed)
    for model in models:
        synthesize_weights(model.requires_grad_(False).eval(), generator)
    unet, aggregator, vae, resampler, dino = models
    return InstantIRPipeline(unet, aggregator, vae, resampler, dino, sdxl_schedule(), device=device)


_FROM_UNET = ("down_blocks", "mid_block", "time_embedding", "add_embedding", "conv_in")


def init_aggregator_from_unet(unet_state: Dict[str, torch.Tensor],
                              agg_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Twin of ``instantir_tpu/pipeline/factory.py::init_aggregator_from_unet``
    (the reference's ``Aggregator.from_unet``): the Aggregator's ``conv_in``
    (also into ``ref_conv_in``), time and added embeddings, down blocks and
    mid block take the UNet's tensor of the same name and shape. Its blocks
    have no ``attn2``/``norm2`` and no LoRA, and its SFT heads no UNet
    counterpart: those keep ``agg_state``'s. Returns a new dict."""
    out = dict(agg_state)
    for name, value in agg_state.items():
        top, _, rest = name.partition(".")
        if top == "ref_conv_in":
            src = f"conv_in.{rest}"
        elif top in _FROM_UNET:
            src = name
        else:
            continue
        s = unet_state.get(src)
        if s is not None and tuple(s.shape) == tuple(value.shape):
            out[name] = s
    return out
