"""Previewer trainer: one-step LCM-LoRA distillation.

Twin of ``instantir_tpu/train/previewer_lora.py`` (rebuild of the reference's
``train_previewer_lora.py:1360-1681``): distill the SDXL + adapter teacher
into a previewer LoRA that denoises in one step. Per step:

  1. DINOv2 tokens of lq at 224² (per-sample drop to the zero-image tokens),
     the Resampler with LoRA on (under gradient) and off (no gradient);
     VAE-encoded **gt** latents (fp32, sampled);
  2. a solver index i: start_t = solver grid[i], t = max(start_t − T/n, 0),
     the LCM boundary scalings at both;
  3. student (LoRA on): eps at start_t with *uncond text* and the cond image
     tokens -> model_pred = c_skip·z + c_out·x̂0;
  4. teacher (LoRA off, no gradient): cond and uncond passes, CFG
     ``cond + w·(cond − uncond)`` on x0 and eps with w ~ U[w_min, w_max],
     a DDIM step to the previous solver point (alpha-bar[0] at index 0);
  5. target (LoRA on, no gradient, the same network): at t on x_prev;
  6. the ``lcm_losses`` (pseudo-Huber c = 0.001 by default); with a loss that
     needs images, both predictions are decoded by the fp32 VAE (the
     prediction's decode rematerialised in the backward pass) and DINOLoss
     reads the trainer's DINOv2; update every LoRA leaf (the Resampler's too).

All four UNet calls take the cond pooled embeds and time ids; only the text
changes. PyTorch idiom as in stages 1 and 2 (``common.Trainer``: raw images
degraded on the device, the host loop ``run``/``resume``/``save_checkpoint``).
The visualisation strip goes to the tracker and stays in ``last_vis_strip``.
``run`` renders ``validate_previewer`` every ``validation_steps``;
``use_8bit_adam`` takes the blockwise-int8 AdamW and ``quantize_frozen_unet``
stores every frozen UNet base as W8 (the LoRA pairs stay fp).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from instantir_tpu_torch.losses import DINOLoss, DiffusionLossInputs, LCMVisualization
from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
from instantir_tpu_torch.models.dinov2 import preprocess_dinov2
from instantir_tpu_torch.models.vae import scale_latents, unscale_latents, vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import (
    add_noise,
    ddim_solver_timesteps,
    lcm_boundary_scalings,
    pred_x0_from_eps,
)
from instantir_tpu_torch.train import common


@dataclasses.dataclass
class PreviewerConfig:
    """The same fields and defaults as the JAX twin."""

    output_dir: str = "previewer_out"
    max_train_steps: int = 1000
    train_batch_size: int = 32
    shard_optimizer_state: bool = True  # ZeRO-1 AdamW state over the mesh's data axis (common.make_adamw)
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 100
    weight_decay: float = 1e-2
    use_8bit_adam: bool = False  # blockwise-int8 Adam moments (train/adam8bit.py)
    # QLoRA storage (common.quantize_frozen_unet): LoRA distillation over W8 frozen UNet bases
    quantize_frozen_unet: bool = False
    max_grad_norm: float = 1.0
    prefetch_batches: int = 2  # batches prepared ahead by a worker thread (common.pipelined_batches); 0: in turn
    gradient_accumulation_steps: int = 1
    resolution: int = 512
    jit_degradation: bool = True  # the traced chain when H, W are multiples of 16·sf (common.run_degradation)
    num_ddim_timesteps: int = 50
    w_min: float = 3.0
    w_max: float = 15.0
    lora_alpha: float = 1.0
    image_drop_rate: float = 0.05
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = 3
    logging_steps: int = 10
    seed: int = 42
    sanity_check: bool = False
    validation_steps: int = 0  # 0 disables
    resume_from_checkpoint: Optional[str] = "latest"
    handle_preemption: bool = False  # SIGTERM -> checkpoint at the next step boundary and stop
    async_checkpointing: bool = False  # write checkpoints from a thread, overlapping the next steps
    report_to: str = "tensorboard"


def lora_trainable_pred(path: Tuple[str, ...]) -> bool:
    """Path ``(model, *parameter name parts)`` -> trains? Every LoRA leaf of
    any model (the UNet's and the Resampler's, the ip projections' and their
    AdaLN's included)."""
    return any(p in ("lora_A", "lora_B") for p in path)


@dataclasses.dataclass
class PreviewerDraws:
    """The random draws of one step (the JAX step's ``jax.random.split(key,
    5)``), any of which may be given: ``solver_index`` int ``[B]`` in [0,
    num_ddim_timesteps); ``noise`` NHWC ``[B, h, w, 4]``; ``w_uniform`` ``[B]``
    uniforms in [0, 1) for the teacher's CFG weight; ``drop_uniform`` ``[B]``
    uniforms compared with ``image_drop_rate``; ``vae_noise`` NHWC
    ``[B, h, w, 4]``, the posterior draw of the gt encode."""

    solver_index: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    w_uniform: Optional[torch.Tensor] = None
    drop_uniform: Optional[torch.Tensor] = None
    vae_noise: Optional[torch.Tensor] = None


# metrics key of the DINOLoss teacher tokens' mean, which train_step folds into the center
TEACHER_MEAN = "_dino_teacher_mean"


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def build_previewer_step(unet, resampler, vae, image_encoder, schedule, losses, cfg: PreviewerConfig) -> Callable:
    """Returns ``loss_fn(batch, draws, generator, dino_center) -> (total,
    metrics)``, the differentiable part of a step. ``metrics`` holds each
    loss by class name, ``_vis_strip`` (NHWC ``[lq | gt | decoded
    prediction]``) with an ``LCMVisualization`` loss, and ``TEACHER_MEAN``
    with a ``DINOLoss``."""
    solver_ts = torch.from_numpy(ddim_solver_timesteps(schedule.num_train_timesteps, cfg.num_ddim_timesteps)).to(
        schedule.alphas_cumprod.device)
    topk = schedule.num_train_timesteps // cfg.num_ddim_timesteps
    alpha = cfg.lora_alpha
    has_image_loss = any(loss.needs_images for loss, _ in losses)
    has_vis = any(isinstance(loss, LCMVisualization) for loss, _ in losses)

    def loss_fn(batch: Dict[str, torch.Tensor], draws: Optional[PreviewerDraws], generator: Optional[torch.Generator],
                dino_center: torch.Tensor):
        draws = draws or PreviewerDraws()
        lq, gt = batch["lq"], batch["gt"]  # NHWC in [-1, 1]
        bsz, dev = gt.shape[0], gt.device
        factor = vae_scale_factor(vae.config)
        lat_shape = (bsz, gt.shape[1] // factor, gt.shape[2] // factor, vae.config.latent_channels)

        def normal(given, shape):
            return common.normal_draw(given, shape, generator, dev)

        def uniform(given):
            return common.uniform_draw(given, bsz, generator, dev)

        def bcast(x):
            return x.reshape(-1, 1, 1, 1).float()

        text, uncond_text = batch["prompt_embeds"], batch["uncond_prompt_embeds"]
        pooled, time_ids = batch["pooled_embeds"], batch["time_ids"]

        def unet_fwd(z, t, text_in, ip, lora):
            return unet(z, t, text_in, pooled, time_ids, ip_hidden_states=ip, lora_scale=lora)

        with torch.no_grad():
            tokens_cond = image_encoder(_nchw(preprocess_dinov2((lq + 1.0) / 2.0, size=common.DINO_TRAIN_SIZE)))
            tokens_uncond = batch["uncond_tokens"].to(tokens_cond.dtype).expand_as(tokens_cond)
            drop = uniform(draws.drop_uniform).reshape(bsz, 1, 1) < cfg.image_drop_rate
            tokens = torch.where(drop, tokens_uncond, tokens_cond)
            ip_base = resampler(tokens, lora_scale=0.0)
            ip_uncond_base = resampler(tokens_uncond, lora_scale=0.0)
            latents = scale_latents(vae.config, vae.encode(_nchw(gt.float()),
                                                           noise=_nchw(normal(draws.vae_noise, lat_shape))))

            index = draws.solver_index
            if index is None:
                index = common.randint_draw(cfg.num_ddim_timesteps, bsz, generator, dev)
            index = index.to(dev).long()
            start_t = solver_ts[index]
            t = (start_t - topk).clamp(min=0)
            c_skip_s, c_out_s = lcm_boundary_scalings(start_t, schedule.timestep_scaling)
            c_skip, c_out = lcm_boundary_scalings(t, schedule.timestep_scaling)
            noisy = add_noise(schedule, latents, _nchw(normal(draws.noise, lat_shape)), start_t)
            w = cfg.w_min + (cfg.w_max - cfg.w_min) * uniform(draws.w_uniform).reshape(bsz, 1, 1, 1)

        # student: LoRA on, uncond text with the cond image tokens
        ip_lora = resampler(tokens, lora_scale=alpha)
        eps_student = unet_fwd(noisy, start_t, uncond_text, ip_lora, alpha)
        model_pred = bcast(c_skip_s) * noisy + bcast(c_out_s) * pred_x0_from_eps(schedule, noisy, eps_student, start_t)

        with torch.no_grad():
            # teacher: LoRA off, CFG on x0 and eps, DDIM to the previous solver point; at index 0
            # alpha-bar[0], not 1 (the reference's DDIMSolver), keeping the eps term alive
            eps_c = unet_fwd(noisy, start_t, text, ip_base, 0.0).float()
            eps_u = unet_fwd(noisy, start_t, uncond_text, ip_uncond_base, 0.0).float()
            x0_c = pred_x0_from_eps(schedule, noisy, eps_c, start_t)
            x0_u = pred_x0_from_eps(schedule, noisy, eps_u, start_t)
            x0 = x0_c + w * (x0_c - x0_u)
            eps = eps_c + w * (eps_c - eps_u)
            prev_t = torch.where(index > 0, solver_ts[(index - 1).clamp(min=0)], torch.zeros_like(index))
            abar_prev = schedule.alphas_cumprod[prev_t].reshape(-1, 1, 1, 1)
            x_prev = torch.sqrt(abar_prev) * x0 + torch.sqrt(1.0 - abar_prev) * eps

            # target: LoRA on, the same network, at t on x_prev
            eps_t = unet_fwd(x_prev, t, uncond_text, ip_lora.detach(), alpha)
            target = bcast(c_skip) * x_prev + bcast(c_out) * pred_x0_from_eps(schedule, x_prev, eps_t, t)

        pred_image = target_image = feature_fn = None
        if has_image_loss:
            def decode(z):
                return _nhwc(vae.decode(unscale_latents(vae.config, z.float())))

            with torch.no_grad():
                target_image = decode(target)
            pred_image = checkpoint(decode, model_pred, use_reentrant=False)

            def feature_fn(img):
                return image_encoder(_nchw(preprocess_dinov2((img + 1.0) / 2.0, size=common.DINO_TRAIN_SIZE)))

        total = 0.0
        metrics = {}
        inputs = DiffusionLossInputs(predicted=model_pred, target=target, timesteps=start_t, pred_image=pred_image,
                                     target_image=target_image)
        for loss, lw in losses:
            if isinstance(loss, DINOLoss):
                val, metrics[TEACHER_MEAN] = loss.apply_with_center(inputs, feature_fn, dino_center)
            else:
                val = loss(inputs)
            total = total + lw * val
            metrics[type(loss).__name__] = val.detach()
        if has_vis:
            metrics["_vis_strip"] = torch.cat([lq, gt, pred_image.detach().to(lq.dtype)], dim=2)
        return total, metrics

    return loss_fn


class PreviewerTrainer(common.Trainer):
    """Holds the models, the optimiser over every LoRA leaf, the DINOLoss
    center and the step (``common.Trainer``). ``device="cuda"`` (the default)
    raises without a card; pass ``device="cpu"`` to train on the CPU.
    ``mesh`` as ``common.Trainer``: the DINOLoss teacher mean that moves the
    center is a metric, so its mean over the global batch."""

    def __init__(self, unet, resampler, vae, image_encoder, cfg: PreviewerConfig,
                 losses_config: Optional[LossesConfig] = None, schedule=None, device="cuda", mesh="auto"):
        self.unet, self.resampler, self.vae, self.image_encoder = unet, resampler, vae, image_encoder
        models = {"unet": unet, "resampler": resampler, "vae": vae, "image_encoder": image_encoder}
        if not any(lora_trainable_pred(tuple(n.split("."))) for n in common.named_parameters(models)):
            raise ValueError("no LoRA params found: build the UNet/Resampler with lora_rank > 0")
        super().__init__("previewer", models, cfg, lora_trainable_pred, losses_config, schedule, device, mesh)
        self._dino = next((loss for loss, _ in self.losses if isinstance(loss, DINOLoss)), None)
        self._vis = next((loss for loss, _ in self.losses if isinstance(loss, LCMVisualization)), None)
        # running teacher-token center of DINOLoss, fp32 whatever the models' dtype
        self.dino_center = torch.zeros((image_encoder.config.hidden_size,), dtype=torch.float32, device=self.device)
        self.last_vis_strip: Optional[torch.Tensor] = None
        self._loss_fn = build_previewer_step(unet, resampler, vae, image_encoder, self.schedule, self.losses, cfg)

    def loss_configs(self, losses_config: Optional[LossesConfig]):
        """``lcm_losses``; pseudo-Huber with c = 0.001 when none are given."""
        if losses_config and losses_config.lcm_losses:
            return losses_config.lcm_losses
        return [SingleLossConfig(name="HuberLoss", init_params={"huber_c": 0.001})]

    def loss(self, batch, draws: Optional[PreviewerDraws] = None, generator: Optional[torch.Generator] = None):
        """The differentiable forward of a step at the current DINOLoss
        center: (weighted loss total, metrics)."""
        return self._loss_fn(batch, *self.step_draws(draws, generator), self.dino_center)

    def train_step(self, batch, draws: Optional[PreviewerDraws] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``common.Trainer.train_step``, then the DINOLoss center's momentum
        fold; the visualisation strip leaves the metrics and is kept as
        ``last_vis_strip`` (and goes to the tracker) on every
        ``visualize_every_k``-th step."""
        step = self.global_step
        metrics = super().train_step(batch, draws, generator)
        mean = metrics.pop(TEACHER_MEAN, None)
        if self._dino is not None:
            m = self._dino.center_momentum
            self.dino_center = self.dino_center * m + mean * (1.0 - m)
        strip = metrics.pop("_vis_strip", None)
        if strip is not None and self._vis.visualize_every_k > 0 and step % self._vis.visualize_every_k == 0:
            self.last_vis_strip = strip
            if self.tracker.writer is not None or self.tracker.wandb is not None:
                self.tracker.images(step, "TrainVisualization", (strip.float().cpu().numpy() + 1.0) / 2.0)
        return metrics

    def validate(self, val_batch, cond):
        from instantir_tpu_torch.train.validation import validate_previewer

        return validate_previewer(self, val_batch["lq"], val_batch["gt"], cond, self.tracker, self.global_step)

    def lora_state(self) -> Dict[str, torch.Tensor]:
        """The diffusers-format previewer LoRA (``unet.<path>.lora_A/B.weight``),
        fp32 copies of their masters on the CPU: the UNet's LoRA leaves under
        the reference's names. The Resampler's LoRA is left out, as in the JAX
        export."""
        return {f"unet.{k}": common.fp32_cpu(v) for k, v in self.master_state("unet").items() if "lora_" in k}

    def export_lora(self, path: str) -> None:
        """Write ``lora_state`` to ``path``: the payload of ``previewer_lora_weights.bin``."""
        torch.save(self.lora_state(), path)
