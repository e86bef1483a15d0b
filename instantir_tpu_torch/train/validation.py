"""Validation renders of the three trainers (reference ``log_validation``:
``train_stage1_adapter.py:90-159``, ``train_previewer_lora.py:118-191``,
``train_stage2_aggregator.py:99-189``): fixed validation images through the
pipeline, logged as LQ | restored | GT strips.

Twin of ``instantir_tpu/train/validation.py``, with its tags and settings:
stage 1 samples with CFG 5 (``validation/stage1``), the previewer restores in
one step at t = 999 from the noised LQ latent (``validation/previewer_one_step``;
the VAE posterior sample and the noise are one draw, as the JAX package takes
both from one key), stage 2 runs the whole restore in 30 steps, CFG 7,
preview_start 0.1, control_guidance_end 0.7 (``validation/instantir``). The
pipeline object is cached on the trainer and reads the live weights; stage 2
renders staged (``fused`` off), so that no recorded graph's memory pool stays
beside the training steps. Each function returns the uint8 strips
``[N, 24 + H, 3·W, 3]`` it logged. Every random draw may be given (the tests
feed the JAX draws); otherwise a ``torch.Generator`` seeded 0 draws them, as
the JAX functions use ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from instantir_tpu_torch.models.dinov2 import preprocess_dinov2
from instantir_tpu_torch.models.vae import scale_latents, unscale_latents
from instantir_tpu_torch.schedulers.diffusion import add_noise
from instantir_tpu_torch.utils.vis import triplet_strip

COND_KEYS = ("prompt_embeds", "pooled_embeds", "time_ids")


def _to_u8(x) -> np.ndarray:
    x = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return ((np.clip(x, -1, 1) + 1) * 127.5).astype(np.uint8)


def _cached(trainer, name: str, make: Callable[[], Any]):
    cache = trainer.__dict__.setdefault("_val_cache", {})
    if name not in cache:
        cache[name] = make()
    return cache[name]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def validation_cond(cond, n: int, device) -> Dict[str, torch.Tensor]:
    """The prompt conditioning of ``n`` validation images on ``device``:
    ``cond`` (a dict of batched tensors, or the training loop's callable of
    a host batch, asked for ``n`` empty captions) cut or repeated to ``n`` rows."""
    if callable(cond):
        cond = cond({"captions": [""] * n})
    out = {}
    for k in COND_KEYS:
        v = torch.as_tensor(cond[k]).to(device)
        reps = -(-n // v.shape[0])
        out[k] = (v.repeat(reps, *([1] * (v.dim() - 1))) if reps > 1 else v)[:n]
    return out


def _log(tracker, step: int, tag: str, lq, img, gt) -> np.ndarray:
    strips = np.stack([triplet_strip(_to_u8(a), _to_u8(b), _to_u8(c)) for a, b, c in zip(lq, img, gt)])
    if tracker is not None:
        tracker.images(step, tag, strips.astype(np.float32) / 255.0)
    return strips


@torch.no_grad()
def _ip_tokens(trainer, lq: torch.Tensor, lora_scale: float) -> torch.Tensor:
    """DINOv2 tokens of the LQ images (224², as the JAX function's default) through the Resampler."""
    tokens = trainer.image_encoder(_nchw(preprocess_dinov2((lq + 1.0) / 2.0)))
    return trainer.resampler(tokens, lora_scale=lora_scale)


def _stage1_pipe(trainer):
    from instantir_tpu_torch.pipeline.stage1_sdxl import Stage1SDXLPipeline

    return _cached(trainer, "stage1_pipe", lambda: Stage1SDXLPipeline(
        trainer.unet, trainer.vae, trainer.resampler, trainer.image_encoder, trainer.schedule, device=trainer.device))


def _generator(trainer) -> torch.Generator:
    return torch.Generator(device=trainer.device).manual_seed(0)


@torch.no_grad()
def validate_stage1(trainer, lq, gt, cond, tracker, step: int, num_steps: int = 30,
                    latents: Optional[torch.Tensor] = None,
                    step_noise: Optional[List[torch.Tensor]] = None) -> np.ndarray:
    """Stage-1 validation: txt2img sampling (CFG 5) conditioned on the LQ
    images' DINOv2 tokens, the adapter being the trained piece."""
    from instantir_tpu_torch.pipeline.stage1_sdxl import Stage1Config

    dev = trainer.device
    lq = torch.as_tensor(lq).to(dev, torch.float32)
    c = validation_cond(cond, lq.shape[0], dev)
    ip = _ip_tokens(trainer, lq, 0.0)
    h = lq.shape[1]
    img = _stage1_pipe(trainer)(c["prompt_embeds"], c["pooled_embeds"], ip, height=h, width=h,
                                cfg=Stage1Config(num_inference_steps=num_steps, guidance_scale=5.0),
                                latents=latents, step_noise=step_noise, generator=_generator(trainer),
                                output_type="image")
    return _log(tracker, step, "validation/stage1", lq, img, gt)


@torch.no_grad()
def validate_previewer(trainer, lq, gt, cond, tracker, step: int,
                       noise: Optional[torch.Tensor] = None) -> np.ndarray:
    """Previewer validation: a one-step restore at t = 999 from the LQ latent
    noised at 999 (reference ``prepare_latents`` / ``log_validation``).
    ``noise`` (NHWC latents) is both the VAE posterior draw and the noise."""
    dev = trainer.device
    lq = torch.as_tensor(lq).to(dev, torch.float32)
    c = validation_cond(cond, lq.shape[0], dev)
    vae = trainer.vae
    if noise is None:
        f = 2 ** (len(vae.config.block_out_channels) - 1)
        noise = torch.randn((lq.shape[0], lq.shape[1] // f, lq.shape[2] // f, vae.config.latent_channels),
                            generator=_generator(trainer), dtype=torch.float32, device=dev)
    eps = _nchw(noise.to(dev, torch.float32))
    lq_latent = scale_latents(vae.config, vae.encode(_nchw(lq), noise=eps))
    t = torch.full((lq.shape[0],), 999, dtype=torch.long, device=dev)
    noisy = _nhwc(add_noise(trainer.schedule, lq_latent, eps, t))
    alpha = trainer.cfg.lora_alpha
    ip = _ip_tokens(trainer, lq, float(alpha))
    preview = _stage1_pipe(trainer).one_step_preview(noisy, 999, c, ip, lora_scale=alpha)
    img = _nhwc(vae.decode(unscale_latents(vae.config, _nchw(preview).float())))
    return _log(tracker, step, "validation/previewer_one_step", lq, img, gt)


@torch.no_grad()
def validate_stage2(trainer, lq, gt, cond, tracker, step: int, num_steps: int = 30,
                    noise=None) -> np.ndarray:
    """Stage-2 validation: the whole InstantIR restore on the live weights,
    staged. ``noise`` is a ``pipeline.instantir.RestoreNoise``."""
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreConfig

    dev = trainer.device
    lq = torch.as_tensor(lq).to(dev, torch.float32)
    c = validation_cond(cond, lq.shape[0], dev)
    pipe = _cached(trainer, "instantir_pipe", lambda: InstantIRPipeline(
        trainer.unet, trainer.aggregator, trainer.vae, trainer.resampler, trainer.image_encoder, trainer.schedule,
        device=dev))
    cfg = RestoreConfig(num_inference_steps=num_steps, guidance_scale=7.0, preview_start=0.1,
                        control_guidance_end=0.7, lora_alpha=trainer.cfg.lora_alpha)
    img, _ = pipe.restore(lq, c["prompt_embeds"], c["pooled_embeds"], cfg=cfg, noise=noise,
                          generator=_generator(trainer), output_type="pt")
    return _log(tracker, step, "validation/instantir", lq, img, gt)
