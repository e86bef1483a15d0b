"""Assemble the InstantIR pipeline and the SDXL text encoders from released checkpoints.

Twin of ``instantir_tpu/pipeline/load.py``. The checkpoint tree is the
reference's (``infer.py:114-144``):
  1. the SDXL base in the diffusers layout: ``unet/``, ``vae/``,
     ``text_encoder*/``, ``tokenizer*/`` (a ``config.json`` and one weights
     file each);
  2. ``adapter.pt``: the Resampler and the ip projections of the UNet;
  3. ``previewer_lora_weights.bin``: LoRA tensors of the UNet and the Resampler;
  4. ``aggregator.pt``: the Aggregator (built from the UNet when absent);
  5. a DINOv2 folder (HF ``transformers`` layout): the image encoder; with
     ``use_clip_encoder`` an HF CLIP vision folder instead (the reference's
     ``--use_clip_encoder``, ``infer.py:275-279``), read into a
     ``CLIPImageEncoder`` with the Resampler's ``embedding_dim`` its
     ``hidden_size``.

The port's parameter names are the checkpoints' own (``convert.py``), so a
file's tensors are picked by name; only ``adapter.pt``'s ip projections and
the LoRA file's keys are renamed (``convert.import_ip_adapter``,
``convert.import_previewer_lora``). The models are built on the ``meta``
device and allocated on the target device once (``to_empty``): no weight is
drawn or held twice. Leaves no file provides (a fresh adapter or LoRA) are
drawn by ``fill_missing_leaves`` from ``np.random.default_rng(0)``.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from instantir_tpu_torch.convert import (
    import_clip_vision,
    import_ip_adapter,
    import_previewer_lora,
    load_torch_state_dict,
)
from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModel,
    clip_vit_l_text_config,
    open_clip_bigg_text_config,
)
from instantir_tpu_torch.models.clip_vision import CLIPImageEncoder, CLIPVisionConfig, clip_vit_b16_config
from instantir_tpu_torch.models.dinov2 import DINOv2Config, DINOv2Model, dinov2_large_config
from instantir_tpu_torch.models.layers import GroupNorm32
from instantir_tpu_torch.models.resampler import Resampler, ResamplerConfig, instantir_resampler_config
from instantir_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig, sdxl_base_config
from instantir_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sdxl_vae_config
from instantir_tpu_torch.pipeline.factory import init_aggregator_from_unet
from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline
from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule
from instantir_tpu_torch.utils.tokenizer import CLIPTokenizer

State = Dict[str, torch.Tensor]


def _read_config(folder: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(folder, "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def unet_config_from_json(d: Dict[str, Any], **overrides) -> UNetConfig:
    """diffusers ``UNet2DConditionModel`` config.json -> UNetConfig."""
    heads = d.get("num_attention_heads") or d["attention_head_dim"]  # diffusers SDXL quirk
    tl = d.get("transformer_layers_per_block", 1)
    n = len(d["down_block_types"])
    fields = dict(
        sample_size=d.get("sample_size", 128),
        in_channels=d.get("in_channels", 4),
        out_channels=d.get("out_channels", 4),
        down_block_types=tuple(d["down_block_types"]),
        up_block_types=tuple(d["up_block_types"]),
        block_out_channels=tuple(d["block_out_channels"]),
        layers_per_block=d.get("layers_per_block", 2),
        transformer_layers_per_block=tuple(tl) if isinstance(tl, (list, tuple)) else (tl,) * n,
        num_attention_heads=tuple(heads) if isinstance(heads, (list, tuple)) else (heads,) * n,
        cross_attention_dim=d.get("cross_attention_dim", 2048),
        addition_time_embed_dim=d.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=d.get("projection_class_embeddings_input_dim", 2816),
        norm_num_groups=d.get("norm_num_groups", 32),
        time_cond_proj_dim=d.get("time_cond_proj_dim"),
        flip_sin_to_cos=d.get("flip_sin_to_cos", True),
        freq_shift=float(d.get("freq_shift", 0)),
    )
    fields.update(overrides)
    return UNetConfig(**fields)


def vae_config_from_json(d: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=d.get("in_channels", 3),
        out_channels=d.get("out_channels", 3),
        latent_channels=d.get("latent_channels", 4),
        block_out_channels=tuple(d["block_out_channels"]),
        layers_per_block=d.get("layers_per_block", 2),
        norm_num_groups=d.get("norm_num_groups", 32),
        scaling_factor=d.get("scaling_factor", 0.13025),
        latents_mean=tuple(d["latents_mean"]) if d.get("latents_mean") else None,
        latents_std=tuple(d["latents_std"]) if d.get("latents_std") else None,
    )


def clip_config_from_json(d: Dict[str, Any]) -> CLIPTextConfig:
    with_proj = "CLIPTextModelWithProjection" in (d.get("architectures") or [])
    return CLIPTextConfig(
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        intermediate_size=d["intermediate_size"],
        max_length=d.get("max_position_embeddings", 77),
        hidden_act=d.get("hidden_act", "quick_gelu"),
        projection_dim=d.get("projection_dim") if with_proj else None,
        eos_token_id=d.get("eos_token_id", 49407),
    )


def dinov2_config_from_json(d: Dict[str, Any]) -> DINOv2Config:
    return DINOv2Config(
        hidden_size=d["hidden_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        mlp_ratio=d.get("mlp_ratio", 4),
        patch_size=d.get("patch_size", 14),
        image_size=d.get("image_size", 224),
    )


def clip_vision_config_from_json(d: Dict[str, Any]) -> CLIPVisionConfig:
    """HF CLIP vision ``config.json`` (or a ``CLIPModel``'s, its
    ``vision_config``) -> ``CLIPVisionConfig``."""
    d = d.get("vision_config", d)
    return CLIPVisionConfig(
        hidden_size=d["hidden_size"],
        num_layers=d["num_hidden_layers"],
        num_heads=d["num_attention_heads"],
        intermediate_size=d["intermediate_size"],
        image_size=d.get("image_size", 224),
        patch_size=d.get("patch_size", 16),
        projection_dim=d.get("projection_dim", 512),
        hidden_act=d.get("hidden_act", "quick_gelu"),
        eps=d.get("layer_norm_eps", 1e-5),
    )


def instantir_config_from_json(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Optional ``instantir_config.json`` beside the InstantIR files:
    ``{"lora_rank": ..., "resampler": {ResamplerConfig fields}}`` (the
    reference hard-codes these, ``infer.py:269-273``)."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _find_weights(folder: str) -> str:
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin", "model.safetensors",
                 "pytorch_model.bin"):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights found under {folder}")


# ---------------------------------------------------------------------------
# fresh leaves, the Aggregator from the UNet, and the copy to the device
# ---------------------------------------------------------------------------

_ZERO_CONV = re.compile(r"^controlnet_(down_blocks\.\d+|mid_block)\.1\.")
_NORMS = (GroupNorm32, nn.LayerNorm, nn.GroupNorm)


def fresh_leaf(model: nn.Module, name: str, shape, rng: np.random.Generator) -> torch.Tensor:
    """The JAX loader's rule for a leaf no checkpoint provides
    (``load.py::fill_missing_leaves``), over the port's names: zeros for
    biases, LoRA B, the Aggregator's zero convs and the AdaLN (``ln_*``)
    modulation linears; ones for norm scales; N(0, 1/fan_in) otherwise, the
    fan-in of the JAX layout (a linear's inputs, a conv's inputs x kernel
    area; the leading axes of any other array)."""
    owner_name, _, leaf = name.rpartition(".")
    parts = name.split(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    if leaf == "bias" or "lora_B" in parts or _ZERO_CONV.match(name) or any(p.startswith("ln_") for p in parts):
        return torch.zeros(shape, dtype=torch.float32)
    if isinstance(owner, _NORMS):
        return torch.ones(shape, dtype=torch.float32)
    if isinstance(owner, nn.Linear):
        fan_in = shape[1]
    elif isinstance(owner, nn.Conv2d):
        fan_in = int(np.prod(shape[1:]))
    else:
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else int(shape[0])
    return torch.from_numpy(rng.normal(scale=1.0 / np.sqrt(max(fan_in, 1)), size=shape).astype(np.float32))


def fill_missing_leaves(model: nn.Module, state: State, rng: np.random.Generator) -> State:
    """``state`` completed with ``fresh_leaf`` for every parameter of
    ``model`` it lacks, in ``named_parameters`` order."""
    out = dict(state)
    for name, p in model.named_parameters():
        if name not in out:
            out[name] = fresh_leaf(model, name, tuple(p.shape), rng)
    return out


def build_aggregator_state(aggregator: Aggregator, unet_state: State, rng: np.random.Generator) -> State:
    """A fresh Aggregator from the UNet's tensors (``init_aggregator_from_unet``;
    the SFT heads drawn, the zero convs zero)."""
    template = dict(aggregator.named_parameters())
    copied = {k: v for k, v in init_aggregator_from_unet(unet_state, template).items() if v is not template[k]}
    return fill_missing_leaves(aggregator, copied, rng)


def _pick(sd: State, model: nn.Module, what: str, required: Callable[[str], bool] = lambda name: True) -> State:
    """The tensors of ``sd`` that are parameters of ``model`` (others are
    passed over, as the JAX converters do); a required parameter that ``sd``
    lacks raises ``KeyError``."""
    names = [n for n, _ in model.named_parameters()]
    state = {n: sd[n] for n in names if n in sd}
    missing = [n for n in names if required(n) and n not in state]
    if missing:
        raise KeyError(f"the {what} checkpoint lacks {len(missing)} of the model's tensors (first: {missing[:5]})")
    return state


@torch.no_grad()
def materialize(model: nn.Module, state: State, dtype: torch.dtype, device: torch.device) -> nn.Module:
    """Allocate a ``meta``-built ``model`` on ``device`` and copy ``state``
    in: each floating tensor rounded to ``dtype`` first, as the JAX loader
    casts each tree (a parameter kept in fp32, a norm's, holds that rounding)."""
    model.to_empty(device=device)
    for name, p in model.named_parameters():
        t = state[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: the checkpoint's shape {tuple(t.shape)} differs from the model's "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(dtype) if t.is_floating_point() else t)
    return model.requires_grad_(False).eval()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to load on the CPU)")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


def load_instantir_pipeline(
    sdxl_path: str,
    instantir_path: Optional[str] = None,
    vision_encoder_path: Optional[str] = None,
    adapter_path: Optional[str] = None,
    previewer_lora_path: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    use_flash: bool = True,
    strict: bool = True,
    use_clip_encoder: bool = False,
    device="cuda",
    timings: Optional[Dict[str, float]] = None,
) -> InstantIRPipeline:
    """An ``InstantIRPipeline`` on ``device`` from a released checkpoint tree.

    The UNet, Aggregator, Resampler and image encoder hold ``dtype`` (bf16 by
    default), the VAE fp32, as in the JAX loader. The image encoder is
    DINOv2, or with ``use_clip_encoder`` the CLIP vision tower of
    ``vision_encoder_path`` as a ``CLIPImageEncoder`` (its penultimate
    layer's tokens; the Resampler's ``embedding_dim`` is its ``hidden_size``). The InstantIR files are
    each optional: a missing one leaves its leaves to ``fill_missing_leaves``
    (the Aggregator to ``build_aggregator_state``). ``strict`` (default): a
    present checkpoint that maps onto the model only in part raises (an
    ip-adapter or LoRA tensor that lands nowhere); ``strict=False`` warns
    instead. A required tensor missing from a file raises ``KeyError`` either
    way. ``timings``, if given, receives the seconds spent reading the files
    (``read_s``) and copying to the device (``to_device_s``)."""
    if not vision_encoder_path:
        raise ValueError("load_instantir_pipeline needs vision_encoder_path (the DINOv2 or CLIP vision folder)")
    device = _device(device)
    t_start = time.perf_counter()
    icfg = instantir_config_from_json(instantir_path and os.path.join(instantir_path, "instantir_config.json")) or {}
    lora_rank = int(icfg.get("lora_rank", 64))
    d = _read_config(os.path.join(sdxl_path, "unet"))
    unet_cfg = (unet_config_from_json(d, with_ip=True, lora_rank=lora_rank) if d
                else sdxl_base_config(with_ip=True, lora_rank=lora_rank))
    d = _read_config(os.path.join(sdxl_path, "vae"))
    vae_cfg = vae_config_from_json(d) if d else sdxl_vae_config()
    d = _read_config(vision_encoder_path)
    if use_clip_encoder:
        dino_cfg = clip_vision_config_from_json(d) if d else clip_vit_b16_config()
    else:
        dino_cfg = dinov2_config_from_json(d) if d else dinov2_large_config()
    if "resampler" in icfg:
        res_cfg = ResamplerConfig(**{"lora_rank": lora_rank, **icfg["resampler"]})
    else:
        res_cfg = instantir_resampler_config(lora_rank=lora_rank, embedding_dim=dino_cfg.hidden_size,
                                             output_dim=unet_cfg.cross_attention_dim)
    meta = torch.device("meta")
    unet = UNet2DConditionModel(unet_cfg, use_flash=use_flash, dtype=dtype, device=meta)
    aggregator = Aggregator(unet_cfg, use_flash=use_flash, dtype=dtype, device=meta)
    vae = AutoencoderKL(vae_cfg, dtype=torch.float32, device=meta)
    resampler = Resampler(res_cfg, dtype=dtype, device=meta)
    dino = (CLIPImageEncoder if use_clip_encoder else DINOv2Model)(dino_cfg, dtype=dtype, device=meta)
    rng = np.random.default_rng(0)

    # the UNet's base weights (its LoRA and ip leaves come from the InstantIR files)
    unet_state = _pick(load_torch_state_dict(_find_weights(os.path.join(sdxl_path, "unet"))), unet, "UNet",
                       required=lambda n: "lora_" not in n and ".processor." not in n)

    # adapter.pt: the ip projections and the Resampler
    adapter_file = adapter_path or (instantir_path and os.path.join(instantir_path, "adapter.pt"))
    res_state: State = {}
    if adapter_file and os.path.exists(adapter_file):
        adapter_sd = load_torch_state_dict(adapter_file)
        if any(k.startswith(("image_proj_model.", "adapter_modules.")) for k in adapter_sd):
            # legacy flat IP-Adapter files (the reference's revise_state_dict,
            # module/ip_adapter/utils.py:164-178)
            adapter_sd = {("image_proj." + k[len("image_proj_model."):] if k.startswith("image_proj_model.")
                           else "ip_adapter." + k[len("adapter_modules."):]): v
                          for k, v in adapter_sd.items() if k.startswith(("image_proj_model.", "adapter_modules."))}
        image_proj = {k[len("image_proj."):]: v for k, v in adapter_sd.items() if k.startswith("image_proj.")}
        ip = {k[len("ip_adapter."):]: v for k, v in adapter_sd.items() if k.startswith("ip_adapter.")}
        unet_state.update(import_ip_adapter(ip, [n for n, _ in unet.named_parameters()], strict=strict))
        res_state = _pick(image_proj, resampler, "Resampler (adapter.pt image_proj)",
                          required=lambda n: "lora_" not in n)
    else:
        print("[load] no adapter.pt -- ip attention + resampler freshly initialized")

    # the previewer LoRA: the UNet's and the Resampler's
    lora_file = previewer_lora_path or (instantir_path and os.path.join(instantir_path, "previewer_lora_weights.bin"))
    if lora_file and os.path.exists(lora_file):
        unet_lora, res_lora, leftover = import_previewer_lora(
            load_torch_state_dict(lora_file), [n for n, _ in unet.named_parameters()],
            [n for n, _ in resampler.named_parameters()])
        if leftover:
            msg = (f"{len(leftover)}/{len(unet_lora) + len(res_lora) + len(leftover)} previewer-LoRA tensors "
                   f"did not merge (first: {leftover[:5]})")
            if strict:
                raise ValueError(f"[load] {msg} -- pass strict=False to allow a partial load")
            print(f"[load] WARNING: {msg}")
        unet_state.update(unet_lora)
        res_state.update(res_lora)
        print(f"[load] merged {len(unet_lora)} UNet + {len(res_lora)} resampler previewer-LoRA tensors")
    res_state = fill_missing_leaves(resampler, res_state, rng)
    unet_state = fill_missing_leaves(unet, unet_state, rng)

    # the Aggregator: aggregator.pt, or from the UNet
    agg_file = instantir_path and os.path.join(instantir_path, "aggregator.pt")
    if agg_file and os.path.exists(agg_file):
        agg_state = _pick(load_torch_state_dict(agg_file), aggregator, "Aggregator")
    else:
        print("[load] no aggregator.pt -- initialized from the UNet (from_unet)")
        agg_state = build_aggregator_state(aggregator, unet_state, rng)

    vae_state = _pick(load_torch_state_dict(_find_weights(os.path.join(sdxl_path, "vae"))), vae, "VAE")
    encoder_sd = load_torch_state_dict(_find_weights(vision_encoder_path))
    if use_clip_encoder:
        dino_state = import_clip_vision(encoder_sd, [n for n, _ in dino.named_parameters()])
    else:
        dino_state = _pick(encoder_sd, dino, "DINOv2")
    t_read = time.perf_counter()

    for model, state, model_dtype in ((unet, unet_state, dtype), (aggregator, agg_state, dtype),
                                      (vae, vae_state, torch.float32), (resampler, res_state, dtype),
                                      (dino, dino_state, dtype)):
        materialize(model, state, model_dtype, device)
    _sync(device)
    if timings is not None:
        timings.update(read_s=t_read - t_start, to_device_s=time.perf_counter() - t_read)
    return InstantIRPipeline(unet, aggregator, vae, resampler, dino, sdxl_schedule(), device=device)


def load_text_encoders(sdxl_path: str, dtype: torch.dtype = torch.bfloat16, device="cuda",
                       timings: Optional[Dict[str, float]] = None):
    """Both CLIP text towers (in ``dtype`` on ``device``) and both tokenizers
    of a diffusers SDXL folder -> ``((encoder 1, tokenizer 1), (encoder 2,
    tokenizer 2))``; each tower's config from its ``config.json`` when there
    is one."""
    device = _device(device)
    t_start = time.perf_counter()
    out, states = [], []
    for sub, default in (("text_encoder", clip_vit_l_text_config), ("text_encoder_2", open_clip_bigg_text_config)):
        d = _read_config(os.path.join(sdxl_path, sub))
        enc = CLIPTextModel(clip_config_from_json(d) if d else default(), dtype=dtype, device=torch.device("meta"))
        states.append(_pick(load_torch_state_dict(_find_weights(os.path.join(sdxl_path, sub))), enc, sub))
        out.append(enc)
    toks = [CLIPTokenizer.from_pretrained(os.path.join(sdxl_path, sub)) for sub in ("tokenizer", "tokenizer_2")]
    t_read = time.perf_counter()
    for enc, state in zip(out, states):
        materialize(enc, state, dtype, device)
    _sync(device)
    if timings is not None:
        timings.update(read_s=t_read - t_start, to_device_s=time.perf_counter() - t_read)
    return (out[0], toks[0]), (out[1], toks[1])

