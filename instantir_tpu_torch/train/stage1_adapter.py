"""Stage-1 trainer: DCP adapter pretraining (Resampler + IP attention).

Twin of ``instantir_tpu/train/stage1_adapter.py``: train only the image-prompt
pathway (the Resampler and the UNet's ``to_k_ip``/``to_v_ip``/``ln_k_ip``/
``ln_v_ip``) on the eps-MSE objective with the *degraded* image's DINOv2
tokens as condition:

  DINO tokens of lq at 224² (with per-sample image drop -> zero-image tokens)
  -> VAE-encode gt -> uniform t (optionally importance-weighted loss) -> add noise
  -> UNet forward (IP attention, no LoRA, no aggregator)
  -> sum of weighted diffusion losses -> update the ip parameters only.

PyTorch idiom: the models are ``nn.Module``s whose ``requires_grad`` flags
carry the trainable/frozen split, the optimiser is ``torch.optim.AdamW``
behind optax's clip and schedule semantics (``common.ClippedAdamW``), and
every random draw of a step is an optional argument (``Stage1Draws``) so a
step can be held against the JAX step's own ``jax.random`` draws; otherwise
the draws come from a ``torch.Generator`` on the trainer's device.

Public tensors keep the JAX layout: NHWC images in [-1, 1], NHWC noise.
``prepare_batch`` degrades raw images on the device, and ``run`` /
``resume`` / ``save_checkpoint`` are the host loop (``common.Trainer``), which
renders ``validate_stage1`` every ``validation_steps``. ``use_8bit_adam``
takes the blockwise-int8 AdamW (``train/adam8bit.py``);
``quantize_frozen_unet`` stores the frozen UNet's bases as W8 in place, the
trained ip projections kept in fp. ``mesh="auto"`` trains data parallel over
the launched process group with ZeRO-1 (``common.Trainer``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from instantir_tpu_torch.losses import DiffusionLossInputs
from instantir_tpu_torch.losses.loss_config import LossesConfig
from instantir_tpu_torch.models.dinov2 import preprocess_dinov2
from instantir_tpu_torch.models.vae import scale_latents, vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import add_noise, importance_sampling_weights
from instantir_tpu_torch.train import common


@dataclasses.dataclass
class Stage1Config:
    """The same fields and defaults as the JAX twin."""

    output_dir: str = "stage1_out"
    max_train_steps: int = 1000
    train_batch_size: int = 96
    shard_optimizer_state: bool = True  # ZeRO-1 AdamW state over the mesh's data axis (common.make_adamw)
    learning_rate: float = 1e-4
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 100
    weight_decay: float = 1e-2
    use_8bit_adam: bool = False  # blockwise-int8 Adam moments (train/adam8bit.py)
    # QLoRA storage (common.quantize_frozen_unet): the frozen UNet's bases W8, the ip projections fp
    quantize_frozen_unet: bool = False
    max_grad_norm: float = 1.0
    prefetch_batches: int = 2  # batches prepared ahead by a worker thread (common.pipelined_batches); 0: in turn
    gradient_accumulation_steps: int = 1
    resolution: int = 512
    jit_degradation: bool = True  # the traced chain when H, W are multiples of 16·sf (common.run_degradation)
    image_drop_rate: float = 0.05
    importance_sampling: bool = False
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


def stage1_trainable_pred(path: Tuple[str, ...]) -> bool:
    """Path ``(model, *parameter name parts)`` -> trains in stage 1?"""
    joined = "/".join(path)
    if "lora_" in joined:
        return False
    if path[0] == "resampler":
        return True
    return path[0] == "unet" and any(n in joined for n in ("to_k_ip", "to_v_ip", "ln_k_ip", "ln_v_ip"))


@dataclasses.dataclass
class Stage1Draws:
    """The random draws of one step, any of which may be given: ``timesteps``
    int ``[B]``; ``noise`` NHWC ``[B, h, w, 4]``, the eps target; ``drop_uniform``
    ``[B]`` uniforms in [0, 1) compared with ``image_drop_rate``; ``vae_noise``
    NHWC ``[B, h, w, 4]``, the VAE posterior draw."""

    timesteps: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    drop_uniform: Optional[torch.Tensor] = None
    vae_noise: Optional[torch.Tensor] = None


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def build_stage1_step(unet, resampler, vae, image_encoder, schedule, losses, cfg: Stage1Config) -> Callable:
    """Returns ``loss_fn(batch, draws, generator) -> (total, metrics)``, the
    differentiable part of a step."""
    iw = None
    if cfg.importance_sampling:
        iw = torch.from_numpy(importance_sampling_weights(schedule.num_train_timesteps))

    def loss_fn(batch: Dict[str, torch.Tensor], draws: Optional[Stage1Draws] = None,
                generator: Optional[torch.Generator] = None):
        draws = draws or Stage1Draws()
        lq, gt = batch["lq"], batch["gt"]  # NHWC in [-1, 1]
        bsz, dev = gt.shape[0], gt.device
        factor = vae_scale_factor(vae.config)
        lat_shape = (bsz, gt.shape[1] // factor, gt.shape[2] // factor, vae.config.latent_channels)

        def normal(given, shape):
            return common.normal_draw(given, shape, generator, dev)

        with torch.no_grad():  # frozen encoders: DINOv2 tokens of lq, VAE latents of gt
            pixels = preprocess_dinov2((lq + 1.0) / 2.0, size=common.DINO_TRAIN_SIZE)
            tokens_cond = image_encoder(_nchw(pixels))
            tokens_uncond = batch["uncond_tokens"].to(tokens_cond.dtype).expand_as(tokens_cond)
            drop = common.uniform_draw(draws.drop_uniform, bsz, generator, dev).reshape(bsz, 1, 1) < cfg.image_drop_rate
            tokens = torch.where(drop, tokens_uncond, tokens_cond)
            z = vae.encode(_nchw(gt.float()), noise=_nchw(normal(draws.vae_noise, lat_shape)))
            latents = scale_latents(vae.config, z)
            # t is drawn uniformly and the loss weighted by T·p(t): drawing from
            # p(t) and dividing would cancel to the uniform objective
            t = draws.timesteps
            if t is None:
                t = common.sample_timesteps(generator, bsz, schedule.num_train_timesteps, None, device=dev)
            t = t.to(dev).long()
            noise = _nchw(normal(draws.noise, lat_shape))
            noisy = add_noise(schedule, latents, noise, t)

        ip_tokens = resampler(tokens)
        eps_pred = unet(noisy, t, batch["prompt_embeds"], batch["pooled_embeds"], batch["time_ids"],
                        ip_hidden_states=ip_tokens)

        weights = None
        if iw is not None:
            weights = schedule.num_train_timesteps * iw.to(dev)[t]

        total = 0.0
        metrics = {}
        for loss, w in losses:
            val = loss(DiffusionLossInputs(predicted=eps_pred, target=noise, timesteps=t, weights=weights))
            total = total + w * val
            metrics[type(loss).__name__] = val.detach()
        return total, metrics

    return loss_fn


class Stage1Trainer(common.Trainer):
    """Holds the models, the optimiser and the step (``common.Trainer``).
    ``device="cuda"`` (the default) raises without a card; pass
    ``device="cpu"`` to train on the CPU; ``mesh`` as ``common.Trainer``."""

    def __init__(self, unet, resampler, vae, image_encoder, cfg: Stage1Config,
                 losses_config: Optional[LossesConfig] = None, schedule=None, device="cuda", mesh="auto"):
        self.unet, self.resampler, self.vae, self.image_encoder = unet, resampler, vae, image_encoder
        models = {"unet": unet, "resampler": resampler, "vae": vae, "image_encoder": image_encoder}
        super().__init__("stage1", models, cfg, stage1_trainable_pred, losses_config, schedule, device, mesh)
        self._loss_fn = build_stage1_step(unet, resampler, vae, image_encoder, self.schedule, self.losses, cfg)

    frozen_unet_keep = staticmethod(stage1_trainable_pred)

    def validate(self, val_batch, cond):
        from instantir_tpu_torch.train.validation import validate_stage1

        return validate_stage1(self, val_batch["lq"], val_batch["gt"], cond, self.tracker, self.global_step)

    def adapter_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The reference-format ``adapter_ckpt.pt`` payload ``{image_proj,
        ip_adapter}`` (``convert.export_adapter``) in fp32 on the CPU, the
        trained leaves from their fp32 masters."""
        from instantir_tpu_torch.convert import export_adapter

        payload = export_adapter(self.master_state("unet"), self.master_state("resampler"))
        return {part: {k: common.fp32_cpu(v) for k, v in tensors.items()} for part, tensors in payload.items()}

    def export_adapter(self, path: str) -> None:
        torch.save(self.adapter_state(), path)
