"""Stage-1 SDXL pipeline: txt2img with IP-adapter image prompting.

Twin of ``instantir_tpu/pipeline/stage1_sdxl.py`` (the reference's vanilla
SDXL pipeline of the stage-1 and previewer validation renders): latents from
pure noise (or given), DDPM sampling over ``ddpm_inference_timesteps`` or a
custom descending sequence, classifier-free guidance on the doubled batch
(zero negative embeddings unless given, the ip tokens repeated), and the
previewer's one-step mode (``one_step_preview``: one UNet pass and an LCM
step). The step loop is Python over the port's modules, which it reads live:
a trainer's validation renders its current weights.

Public tensors keep the JAX layout (NHWC latents and images); the models run
NCHW inside. The initial latents and each step's DDPM noise are arguments; a
``torch.Generator`` on the pipeline's device draws the ones not given.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from instantir_tpu_torch.models.layers import LoRAConv2d, LoRALinear, merge_lora
from instantir_tpu_torch.models.vae import unscale_latents, vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import (
    ddpm_inference_timesteps,
    ddpm_prev_timesteps,
    ddpm_step,
    lcm_single_step,
)


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    num_inference_steps: int = 30
    guidance_scale: float = 5.0
    lora_scale: float = 0.0  # > 0 runs the previewer LoRA during sampling
    num_train_timesteps: int = 1000
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    timesteps: Optional[Tuple[int, ...]] = None  # custom (descending) sequence

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


def stage1_timesteps(cfg: Stage1Config) -> Tuple[np.ndarray, np.ndarray]:
    """(the step timesteps, each one's previous timestep; -1 after a custom sequence's last)."""
    if cfg.timesteps is not None:
        ts = np.asarray(cfg.timesteps, np.int64)
        return ts, np.concatenate([ts[1:], [-1]])
    ts = ddpm_inference_timesteps(cfg.num_inference_steps, cfg.num_train_timesteps, cfg.timestep_spacing,
                                  cfg.steps_offset)
    return ts, ddpm_prev_timesteps(ts, cfg.num_train_timesteps, cfg.num_inference_steps)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Stage1SDXLPipeline:
    """txt2img with image-prompt conditioning on the port's models."""

    def __init__(self, unet, vae, resampler, image_encoder, schedule, device=None):
        self.unet = unet
        self.vae = vae
        self.resampler = resampler
        self.image_encoder = image_encoder
        self.device = torch.device(device) if device is not None else next(unet.parameters()).device
        self.schedule = schedule.to(self.device)

    @torch.no_grad()
    def merge_previewer_lora_inplace(self, alpha: float = 1.0) -> "Stage1SDXLPipeline":
        """Fold the UNet's previewer LoRA at strength ``alpha`` into its base
        weights in place (``models.layers.merge_lora``) and drop the A/B
        pairs: sampling with ``lora_scale=0`` then behaves as LoRA ``alpha``,
        without the adapter products. Irreversible on these modules; a
        quantized base cannot take the merge."""
        if any(isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora_rank > 0 and m.quant_mode is not None
               for m in self.unet.modules()):
            raise ValueError("merge_previewer_lora_inplace on a quantized UNet: the int8 base weights can't absorb "
                             "a LoRA merge")
        merged = merge_lora(self.unet, alpha)
        own = dict(self.unet.named_parameters())
        for name, w in merged.items():
            own[name].copy_(w)
        for m in self.unet.modules():
            if isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora_rank > 0:
                del m.lora_A, m.lora_B
                m.lora_rank = 0
        return self

    def _unet(self, latents, t, cond, ip_tokens, lora_scale):
        tb = torch.full((latents.shape[0],), int(t), dtype=torch.long, device=latents.device)
        return self.unet(_nchw(latents), tb, cond["prompt_embeds"], cond["pooled_embeds"], cond["time_ids"],
                         ip_hidden_states=ip_tokens, lora_scale=lora_scale), tb

    @torch.no_grad()
    def one_step_preview(self, latents: torch.Tensor, t: int, cond, ip_tokens: torch.Tensor,
                         lora_scale: float = 1.0) -> torch.Tensor:
        """The previewer validation's mode: one UNet pass at ``t`` on NHWC
        ``latents`` and an LCM step; NHWC out."""
        eps, tb = self._unet(latents, t, cond, ip_tokens, lora_scale)
        return _nhwc(lcm_single_step(self.schedule, eps, tb, _nchw(latents)))

    def draw_noise(self, cfg: Stage1Config, batch: int, lat_h: int, lat_w: int,
                   generator: torch.Generator) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(initial latents, each step's DDPM noise), NHWC fp32, from ``generator`` in that order."""
        shape = (batch, lat_h, lat_w, 4)

        def draw():
            return torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)

        return draw(), [draw() for _ in range(len(stage1_timesteps(cfg)[0]))]

    @torch.no_grad()
    def __call__(self, prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor, ip_tokens: torch.Tensor,
                 height: int, width: int, cfg: Stage1Config = Stage1Config(),
                 latents: Optional[torch.Tensor] = None, step_noise: Optional[List[torch.Tensor]] = None,
                 negative_prompt_embeds: Optional[torch.Tensor] = None,
                 negative_pooled_embeds: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, output_type: str = "latent") -> torch.Tensor:
        """Sample NHWC latents (``output_type="latent"``) or decode them to an
        NHWC image in [-1, 1] (fp32 VAE decode). ``latents`` (NHWC fp32) and
        ``step_noise`` (one NHWC draw a step) are drawn from ``generator``
        (seed 0 on the pipeline's device when not given) where missing."""
        b = prompt_embeds.shape[0]
        f = vae_scale_factor(self.vae.config)
        ts, prev_ts = stage1_timesteps(cfg)
        if latents is None or step_noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            init, drawn = self.draw_noise(cfg, b, height // f, width // f, generator)
            latents = init if latents is None else latents
            step_noise = drawn if step_noise is None else step_noise
        if len(step_noise) != len(ts):
            raise ValueError(f"step_noise holds {len(step_noise)} draws for {len(ts)} steps")
        latents = latents.to(self.device, torch.float32)
        if cfg.do_cfg:
            neg_pe = torch.zeros_like(prompt_embeds) if negative_prompt_embeds is None else negative_prompt_embeds
            neg_pp = torch.zeros_like(pooled_embeds) if negative_pooled_embeds is None else negative_pooled_embeds
            prompt_embeds = torch.cat([neg_pe, prompt_embeds])
            pooled_embeds = torch.cat([neg_pp, pooled_embeds])
            if ip_tokens.shape[0] == b:
                ip_tokens = torch.cat([ip_tokens, ip_tokens])
        time_ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=prompt_embeds.dtype,
                                device=prompt_embeds.device).repeat(prompt_embeds.shape[0], 1)
        cond = {"prompt_embeds": prompt_embeds, "pooled_embeds": pooled_embeds, "time_ids": time_ids}
        for t, prev_t, noise in zip(ts, prev_ts, step_noise):
            latent_in = torch.cat([latents, latents]) if cfg.do_cfg else latents
            eps, _ = self._unet(latent_in, t, cond, ip_tokens, cfg.lora_scale)
            if cfg.do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            tb = torch.full((b,), int(t), dtype=torch.long, device=self.device)
            prev = torch.full((b,), int(prev_t), dtype=torch.long, device=self.device)
            nxt, _ = ddpm_step(self.schedule, eps, tb, prev, _nchw(latents), _nchw(noise.to(self.device)))
            latents = _nhwc(nxt)
        if output_type == "latent":
            return latents
        z = unscale_latents(self.vae.config, _nchw(latents).float())
        return _nhwc(self.vae.decode(z))
