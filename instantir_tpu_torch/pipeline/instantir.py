"""InstantIR restoration pipeline (staged restore, eager PyTorch).

Twin of ``instantir_tpu/pipeline/instantir.py``. Per step, a one-step LCM
previewer (the UNet with its previewer LoRA on) produces a clean reference
latent, the Aggregator fuses (LQ latent, preview) into per-resolution
residuals, and the main UNet (LoRA off, time-aware IP attention) predicts the
noise that a stochastic DDPM step consumes. The step schedule is split into at
most three phases by ``build_step_phases``:

  A. controlnet on, previewer off  -> preview latent := LQ latent
  B. controlnet on, previewer on   -> previewer UNet + LCM step
  C. controlnet off                -> plain UNet step

Public tensors keep the JAX layout (NHWC images and latents); the models run
NCHW inside. Every random draw is injectable (``RestoreNoise``) so a run can be
held against the JAX pipeline's ``jax.random`` draws; otherwise the draws come
from a ``torch.Generator`` on the pipeline's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.dinov2 import DINOv2Model, preprocess_dinov2
from instantir_tpu_torch.models.resampler import Resampler
from instantir_tpu_torch.models.unet import UNet2DConditionModel
from instantir_tpu_torch.models.vae import AutoencoderKL, scale_latents, unscale_latents, vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import (
    DiffusionSchedule,
    add_noise,
    ddpm_inference_timesteps,
    ddpm_prev_timesteps,
    ddpm_step,
    lcm_single_step,
)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float) -> torch.Tensor:
    """CFG std rescale (arXiv 2305.08891 §3.4), population std over all but the batch axis."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


@dataclasses.dataclass(frozen=True)
class RestoreConfig:
    """Sampling configuration; the same fields and defaults as the JAX twin.
    Fields marked "not ported" raise ``NotImplementedError`` when set away
    from their default."""

    num_inference_steps: int = 30
    guidance_scale: float = 7.0
    guidance_rescale: float = 0.0
    preview_start: float = 0.0
    preview_end: float = 1.0
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    controlnet_conditioning_scale: float = 1.0
    lora_alpha: float = 1.0  # previewer LoRA strength when enabled
    fuse_previewer_lora: bool = False  # not ported
    # CFG single-pass control branch (opt-in approximations of the JAX package)
    preview_cfg: bool = True
    controlnet_cfg: bool = True
    deepcache_interval: int = 1  # not ported
    deepcache_depth: int = 1  # not ported
    multistep_restore: bool = False  # not ported
    adastep_restore: bool = False
    sequence_parallel: bool = False  # not ported
    sp_min_seq: int = 8192  # not ported
    save_preview_row: bool = False  # not ported
    vae_tiling: bool = False  # not ported
    vae_tile_latent: int = 96  # not ported
    vae_tile_overlap: float = 0.25  # not ported
    vae_slicing: bool = False  # not ported
    decode_dtype: str = "float32"  # only "float32" is ported
    num_train_timesteps: int = 1000
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    timesteps: Optional[Tuple[int, ...]] = None  # custom descending sequence
    fused: bool = False  # not ported (one XLA program in the JAX package)

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


_NOT_PORTED = ("fuse_previewer_lora", "deepcache_interval", "deepcache_depth", "multistep_restore",
               "sequence_parallel", "sp_min_seq", "save_preview_row", "vae_tiling", "vae_tile_latent",
               "vae_tile_overlap", "vae_slicing", "fused")


def _check_ported(cfg: RestoreConfig) -> None:
    default = RestoreConfig()
    for name in _NOT_PORTED:
        if getattr(cfg, name) != getattr(default, name):
            raise NotImplementedError(f"RestoreConfig.{name}={getattr(cfg, name)!r} is not ported yet")
    if cfg.decode_dtype != "float32":
        raise NotImplementedError(f"RestoreConfig.decode_dtype={cfg.decode_dtype!r} is not ported yet")


def inference_timesteps(cfg: RestoreConfig) -> np.ndarray:
    if cfg.timesteps is not None:
        return np.asarray(cfg.timesteps, np.int64)
    return ddpm_inference_timesteps(cfg.num_inference_steps, cfg.num_train_timesteps, cfg.timestep_spacing,
                                    cfg.steps_offset)


def build_step_phases(cfg: RestoreConfig, timesteps: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
    """Split the step sequence into contiguous runs of equal mode
    ("A"/"B"/"C"), each with its ``t`` and ``prev_t`` lists."""
    if timesteps is None:
        timesteps = inference_timesteps(cfg)
    timesteps = np.asarray(timesteps, np.int64)
    n = len(timesteps)
    prev_ts = ddpm_prev_timesteps(timesteps, cfg.num_train_timesteps, n)
    phases: List[Dict[str, Any]] = []
    for i in range(n):
        keep = not (i / n < cfg.control_guidance_start or (i + 1) / n > cfg.control_guidance_end)
        previewing = not (i / n < cfg.preview_start or (i + 1) / n > cfg.preview_end)
        mode = ("B" if previewing and keep else "A") if keep else "C"
        if phases and phases[-1]["mode"] == mode:
            phases[-1]["t"].append(int(timesteps[i]))
            phases[-1]["prev_t"].append(int(prev_ts[i]))
        else:
            phases.append({"mode": mode, "t": [int(timesteps[i])], "prev_t": [int(prev_ts[i])]})
    return phases


@dataclasses.dataclass
class RestoreNoise:
    """Every random draw of one restore, NHWC fp32 like the JAX draws:
    ``vae`` the VAE posterior draw, ``init`` the draw that noises the LQ latent
    at the first timestep, ``steps[i]`` the DDPM noise of step i."""

    vae: torch.Tensor
    init: torch.Tensor
    steps: List[torch.Tensor]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class InstantIRPipeline:
    """Bundles the models and exposes ``restore``. Text encoding happens
    outside: ``restore`` takes prompt embeddings."""

    def __init__(self, unet: UNet2DConditionModel, aggregator: Aggregator, vae: AutoencoderKL,
                 resampler: Resampler, image_encoder: DINOv2Model, schedule: DiffusionSchedule,
                 device="cuda"):
        self.device = torch.device(device)
        self.unet = unet
        self.aggregator = aggregator
        self.vae = vae
        self.resampler = resampler
        self.image_encoder = image_encoder
        self.schedule = schedule.to(self.device)

    # ------------------------------------------------------------------
    # Encoders (run once per call, outside the denoise loop)
    # ------------------------------------------------------------------

    def encode_image_embeds(self, images01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """DINOv2 tokens for (cond, uncond). The uncond tokens come from
        DINOv2 on a zero tensor in *preprocessed* pixel space."""
        size = self.image_encoder.config.image_size
        pixels = preprocess_dinov2(images01, size=size)
        cond = self.image_encoder(_nchw(pixels))
        uncond = self.image_encoder(torch.zeros((1, 3, size, size), dtype=pixels.dtype, device=pixels.device))
        return cond, uncond.expand_as(cond)

    def encode_vae_image(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """[-1, 1] NHWC images -> scaled NCHW latents (sampled posterior)."""
        return scale_latents(self.vae.config, self.vae.encode(_nchw(images), noise=_nchw(noise)))

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Model-space NCHW latents -> NHWC images in [-1, 1] (fp32 decode)."""
        return _nhwc(self.vae.decode(unscale_latents(self.vae.config, latents.float())))

    # ------------------------------------------------------------------
    # The denoise loop
    # ------------------------------------------------------------------

    def _sample(self, cfg: RestoreConfig, latents: torch.Tensor, cond: Dict[str, torch.Tensor],
                image_latent: torch.Tensor, ip_base: torch.Tensor, ip_lora: torch.Tensor,
                step_noise: List[torch.Tensor]) -> torch.Tensor:
        schedule = self.schedule
        do_cfg = cfg.do_cfg
        gs = cfg.guidance_scale
        bsz = latents.shape[0]
        share_preview = do_cfg and not cfg.preview_cfg
        share_cnet = do_cfg and not cfg.controlnet_cfg

        def double(x):
            return torch.cat([x, x], dim=0) if do_cfg else x

        def unet(lat, tb, cnd, lora_scale, ip_tokens, residuals=None, mid_residual=None):
            return self.unet(lat, tb, cnd["prompt_embeds"], cnd["pooled_embeds"], cnd["time_ids"],
                             ip_hidden_states=ip_tokens, down_block_additional_residuals=residuals,
                             mid_block_additional_residual=mid_residual, lora_scale=lora_scale)

        def cfg_combine(noise_pred):
            if not do_cfg:
                return noise_pred
            uncond, text = noise_pred.chunk(2, dim=0)
            pred = uncond + gs * (text - uncond)
            if cfg.guidance_rescale > 0.0:
                pred = rescale_noise_cfg(pred, text, cfg.guidance_rescale)
            return pred

        preview_factor = torch.ones((bsz, 1, 1, 1), dtype=torch.float32, device=latents.device)
        prev_preview = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
        step = 0
        for phase in build_step_phases(cfg):
            mode = phase["mode"]
            for t, prev_t in zip(phase["t"], phase["prev_t"]):
                tb = torch.full((bsz * (2 if do_cfg else 1),), t, dtype=torch.long, device=latents.device)
                tb1 = tb[:bsz]
                prev_tb1 = torch.full((bsz,), prev_t, dtype=torch.long, device=latents.device)
                latent_in = double(latents)

                if mode == "C":
                    noise_pred = cfg_combine(unet(latent_in, tb, cond, 0.0, ip_base))
                    latents, _ = ddpm_step(schedule, noise_pred, tb1, prev_tb1, latents, step_noise[step])
                    step += 1
                    continue

                if mode == "B":
                    if share_preview:
                        p_cond = {k: v[-bsz:] for k, v in cond.items()}
                        preview_noise = unet(latents, tb1, p_cond, cfg.lora_alpha, ip_lora[-bsz:])
                        preview_latent = double(lcm_single_step(schedule, preview_noise, tb1, latents))
                    else:
                        preview_noise = unet(latent_in, tb, cond, cfg.lora_alpha, ip_lora)
                        preview_latent = lcm_single_step(schedule, preview_noise, tb, latent_in)
                else:
                    preview_latent = image_latent

                if share_cnet:
                    down_res, mid_res = self.aggregator(
                        image_latent[-bsz:], tb1, preview_latent[-bsz:].to(latents.dtype),
                        cond["pooled_embeds"][-bsz:], cond["time_ids"][-bsz:])
                    down_res = tuple(double(r) for r in down_res)
                    mid_res = double(mid_res)
                else:
                    down_res, mid_res = self.aggregator(
                        image_latent, tb, preview_latent.to(latents.dtype), cond["pooled_embeds"], cond["time_ids"])

                # adaptive restoration scaling
                cond_scale = double(preview_factor.clamp(0.0, cfg.controlnet_conditioning_scale))
                down_res = tuple(r * cond_scale.to(r.dtype) for r in down_res)
                mid_res = mid_res * cond_scale.to(mid_res.dtype)
                noise_pred = cfg_combine(unet(latent_in, tb, cond, 0.0, ip_base, down_res, mid_res))
                preview_text = preview_latent[-bsz:]

                latents_next, pred_x0 = ddpm_step(schedule, noise_pred, tb1, prev_tb1, latents, step_noise[step])
                step += 1
                if cfg.adastep_restore:
                    # preview_factor <- |preview - x0|^2 / |preview - prev_preview|^2
                    pt = preview_text.float()
                    d_pred = ((pt - pred_x0.float()) ** 2).sum(dim=(1, 2, 3))
                    d_prev = ((pt - prev_preview) ** 2).sum(dim=(1, 2, 3))
                    preview_factor = (d_pred / d_prev.clamp(min=1e-12)).reshape(-1, 1, 1, 1)
                    prev_preview = pt
                latents = latents_next
        return latents

    @torch.no_grad()
    def restore(
        self,
        lq_images: torch.Tensor,  # [B, H, W, 3] in [-1, 1]
        prompt_embeds: torch.Tensor,  # [B, 77, 2048] text-cond
        pooled_embeds: torch.Tensor,  # [B, 1280]
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_embeds: Optional[torch.Tensor] = None,
        cfg: RestoreConfig = RestoreConfig(),
        generator: Optional[torch.Generator] = None,
        noise: Optional[RestoreNoise] = None,
        output_type: str = "np",
    ):
        """End-to-end restoration. Returns ``(image, None)`` -- NHWC in
        [-1, 1] as numpy (``"np"``) or a tensor (``"pt"``) -- or
        ``(latents, None)`` in NHWC for ``output_type="latent"``; the second
        item stands where the JAX twin returns its preview row."""
        _check_ported(cfg)
        dev = self.device
        lq_images = lq_images.to(dev)
        prompt_embeds = prompt_embeds.to(dev)
        pooled_embeds = pooled_embeds.to(dev)
        b, h, w, _ = lq_images.shape
        timesteps = inference_timesteps(cfg)
        n_steps = len(timesteps)
        f = vae_scale_factor(self.vae.config)
        lat_shape = (b, h // f, w // f, self.vae.config.latent_channels)
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)

            def draw():
                return torch.randn(lat_shape, generator=generator, dtype=torch.float32, device=dev)

            noise = RestoreNoise(vae=draw(), init=draw(), steps=[draw() for _ in range(n_steps)])
        if len(noise.steps) != n_steps:
            raise ValueError(f"noise.steps holds {len(noise.steps)} draws for {n_steps} steps")

        # 1. LQ -> latent (fp32 VAE encode), used as both init and condition
        image_latent = self.encode_vae_image(lq_images.float(), noise.vae.to(dev))
        image_latent = image_latent.to(prompt_embeds.dtype)

        # 2. image-prompt tokens (cond + uncond), both LoRA modes
        dino_cond, dino_uncond = self.encode_image_embeds((lq_images + 1.0) / 2.0)
        dino_tokens = torch.cat([dino_uncond, dino_cond], dim=0) if cfg.do_cfg else dino_cond
        ip_base = self.resampler(dino_tokens, lora_scale=0.0)
        ip_lora = self.resampler(dino_tokens, lora_scale=cfg.lora_alpha)

        # 3. prompt conditioning (+ CFG doubling; negatives default to zeros)
        if cfg.do_cfg:
            neg_pe = torch.zeros_like(prompt_embeds) if negative_prompt_embeds is None else negative_prompt_embeds.to(dev)
            neg_pp = torch.zeros_like(pooled_embeds) if negative_pooled_embeds is None else negative_pooled_embeds.to(dev)
            prompt_embeds = torch.cat([neg_pe, prompt_embeds], dim=0)
            pooled_embeds = torch.cat([neg_pp, pooled_embeds], dim=0)
        time_ids = torch.tensor([[h, w, 0, 0, h, w]], dtype=prompt_embeds.dtype, device=dev)
        time_ids = time_ids.repeat(prompt_embeds.shape[0], 1)
        cond = {"prompt_embeds": prompt_embeds, "pooled_embeds": pooled_embeds, "time_ids": time_ids}

        # 4. init latents from the noised LQ latent
        t0 = torch.full((b,), int(timesteps[0]), dtype=torch.long, device=dev)
        latents = add_noise(self.schedule, image_latent, _nchw(noise.init.to(dev)), t0)

        # 5. the loop
        cond_image_latent = torch.cat([image_latent] * 2, dim=0) if cfg.do_cfg else image_latent
        step_noise = [_nchw(s.to(dev)) for s in noise.steps]
        latents = self._sample(cfg, latents, cond, cond_image_latent, ip_base, ip_lora, step_noise)

        if output_type == "latent":
            return _nhwc(latents), None
        image = self.decode_latents(latents).float()
        if output_type == "np":
            return image.cpu().numpy(), None
        return image, None
