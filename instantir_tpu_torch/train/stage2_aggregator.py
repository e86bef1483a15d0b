"""Stage-2 trainer: Aggregator training with the frozen previewer.

Twin of ``instantir_tpu/train/stage2_aggregator.py`` (rebuild of the
reference's ``train_stage2_aggregator.py:1451-1676``). Per step:

  1. condition drops from one uniform per sample: image / text / both;
  2. DINOv2 tokens of lq at 224², VAE encodes of gt and lq (fp32, sampled);
  3. uniform t, noisy gt;
  4. the previewer (no gradient, **EMA adapter**, LoRA on at ``lora_alpha``)
     predicts eps on the noisy gt, with the train-time CFG
     w = 1 + u·(cfg_scale − 1) when ``cfg_scale > 1``, then one LCM step;
  5. the Aggregator on (lq latent, t, preview) -> residuals, under gradient;
  6. the main UNet (LoRA off, live adapter) on the noisy gt with the residuals
     -> eps; the losses, importance-weighted by T·p(t) if asked;
  7. update the Aggregator (and the adapter under ``optimize_adapter``), and
     EMA-update the adapter copy every ``ema_update_steps`` steps.

PyTorch idiom as in stage 1 (``common.Trainer``): ``requires_grad`` carries
the trainable split, every draw of a step is an optional argument
(``Stage2Draws``), and the previewer reads the EMA tensors through
``torch.func.functional_call`` rather than a swap into the modules. The EMA
copy is fp32 whatever the models' dtype: the JAX modules keep fp32 parameters
under bf16 compute, and a bf16 copy at decay 0.999 would drop every update
smaller than half an ulp. ``prepare_batch`` degrades raw images on the
device, and ``run`` / ``resume`` / ``save_checkpoint`` are the host loop
(``common.Trainer``); a checkpoint holds the EMA copy beside the JAX
trainers' state. ``run`` renders ``validate_stage2`` every
``validation_steps``; ``use_8bit_adam`` takes the blockwise-int8 AdamW and
``quantize_frozen_unet`` stores the frozen UNet's bases as W8 (the ip
projections fp), through which the gradients reach the Aggregator.

``aggregator_adapter`` gives the Aggregator its own image-prompt adapter
(``enable_aggregator_adapter`` builds both parts): a Resampler,
``agg_resampler``, projects the (image-dropped) DINOv2 tokens *before* the
Aggregator call, and a time-aware IP branch on every self-attention of the
Aggregator reads them. ``agg_resampler`` trains with the Aggregator (fp32
masters, the 8-bit moments under ``use_8bit_adam``) and goes into the
checkpoints. The validation render cannot run with the adapter: the restore
calls the Aggregator without image tokens, which raises ``ValueError`` in the
JAX trainer and here alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from instantir_tpu_torch.losses import DiffusionLossInputs
from instantir_tpu_torch.losses.loss_config import LossesConfig
from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.dinov2 import preprocess_dinov2
from instantir_tpu_torch.models.resampler import Resampler, ResamplerConfig
from instantir_tpu_torch.models.vae import scale_latents, vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import add_noise, importance_sampling_weights, lcm_single_step
from instantir_tpu_torch.train import common
from instantir_tpu_torch.train.stage1_adapter import stage1_trainable_pred


@dataclasses.dataclass
class Stage2Config:
    """The same fields and defaults as the JAX twin."""

    output_dir: str = "stage2_out"
    max_train_steps: int = 1000
    train_batch_size: int = 6
    shard_optimizer_state: bool = True  # ZeRO-1 AdamW state over the mesh's data axis (common.make_adamw)
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 100
    weight_decay: float = 1e-2
    use_8bit_adam: bool = False  # blockwise-int8 Adam moments (train/adam8bit.py)
    # QLoRA storage (common.quantize_frozen_unet): the frozen UNet's bases W8, the ip projections fp;
    # gradients still flow through it to the Aggregator
    quantize_frozen_unet: bool = False
    max_grad_norm: float = 1.0
    prefetch_batches: int = 2  # batches prepared ahead by a worker thread (common.pipelined_batches); 0: in turn
    gradient_accumulation_steps: int = 1
    resolution: int = 512
    jit_degradation: bool = True  # the traced chain when H, W are multiples of 16·sf (common.run_degradation)
    image_drop_rate: float = 0.0
    text_drop_rate: float = 0.85
    cond_drop_rate: float = 0.15
    cfg_scale: float = 1.0  # train-time previewer CFG
    lora_alpha: float = 1.0
    optimize_adapter: bool = False
    use_ema_adapter: bool = True
    ema_decay: float = 0.999
    ema_update_steps: int = 1
    importance_sampling: bool = False
    # the Aggregator's own Resampler and a TA-IP branch on every attn1, trained with it
    aggregator_adapter: bool = False
    adapter_tokens: int = 64  # the agg_resampler's queries
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


def stage2_trainable_pred(cfg: Stage2Config) -> common.PathPred:
    """Path ``(model, *parameter name parts)`` -> trains in stage 2? The
    Aggregator and its ``agg_resampler``, plus the adapter (stage 1's leaves)
    under ``optimize_adapter``."""

    def pred(path: Tuple[str, ...]) -> bool:
        if path[0] in ("aggregator", "agg_resampler"):
            return True
        return cfg.optimize_adapter and stage1_trainable_pred(path)

    return pred


@torch.no_grad()
def enable_aggregator_adapter(aggregator: Aggregator, state: Dict[str, torch.Tensor], encoder_hidden_size: int,
                              cfg: Stage2Config, image_proj_sd: Optional[Dict[str, torch.Tensor]] = None,
                              seed: int = 0) -> Tuple[Aggregator, Resampler]:
    """Twin of the JAX function: returns ``(aggregator', agg_resampler)`` on
    ``aggregator``'s device and in its dtype.

    * ``aggregator'``: a new Aggregator with ``aggregator_adapter=True`` (each
      attn1 grows ``processor.to_k_ip`` / ``to_v_ip`` and the AdaLNs
      ``ln_k_ip`` / ``ln_v_ip``), holding ``state`` (the Aggregator's tensors
      by name, e.g. ``aggregator.state_dict()``) and, for the leaves ``state``
      lacks, fresh ones by ``pipeline/load.py::fill_missing_leaves``'s rule
      (the AdaLN linears zero, so the modulation starts as the identity);
    * ``agg_resampler``: the Aggregator's own Resampler (dim 1280, depth 4,
      20 heads of 64, ``num_queries = adapter_tokens``, input width
      ``encoder_hidden_size``, output the cross-attention width), loaded
      strictly from ``image_proj_sd`` when given, else fresh by the same rule.

    The fresh leaves come from one ``numpy`` generator seeded with ``seed``,
    the Aggregator's first. ``aggregator`` itself is left as it is."""
    from instantir_tpu_torch.pipeline.load import fill_missing_leaves

    ucfg = aggregator.config
    device = next(aggregator.parameters()).device
    dtype = aggregator.dtype
    rng = np.random.default_rng(seed)
    agg = Aggregator(ucfg, use_flash=aggregator.use_flash, dtype=dtype, device="meta",
                     pad_concat=aggregator.pad_concat, attn1_mode=aggregator.attn1_mode, aggregator_adapter=True,
                     global_pool_conditions=aggregator.global_pool_conditions)
    full = fill_missing_leaves(agg, state, rng)
    agg.to_empty(device=device)
    for name, p in agg.named_parameters():
        p.copy_(full[name])
    agg.gradient_checkpointing = aggregator.gradient_checkpointing

    rcfg = ResamplerConfig(num_queries=cfg.adapter_tokens, embedding_dim=encoder_hidden_size,
                           output_dim=ucfg.cross_attention_dim)
    res = Resampler(rcfg, dtype=dtype, device="meta")
    res_state = dict(image_proj_sd) if image_proj_sd is not None else fill_missing_leaves(res, {}, rng)
    names = {n for n, _ in res.named_parameters()}
    if image_proj_sd is not None and set(res_state) != names:
        raise KeyError(f"image_proj_sd does not match the agg_resampler: missing {sorted(names - set(res_state))[:5]}, "
                       f"unexpected {sorted(set(res_state) - names)[:5]}")
    res.to_empty(device=device)
    for name, p in res.named_parameters():
        p.copy_(res_state[name])
    return agg.requires_grad_(False).eval(), res.requires_grad_(False).eval()


# The adapter leaves the EMA copy tracks (the Resampler and the ip projections).
ADAPTER_EMA_PRED = stage1_trainable_pred


@dataclasses.dataclass
class Stage2Draws:
    """The random draws of one step (the JAX step's ``jax.random.split(key,
    6)``), any of which may be given: ``timesteps`` int ``[B]``; ``noise``
    NHWC ``[B, h, w, 4]``, the eps target; ``drop_uniform`` ``[B]`` uniforms
    in [0, 1) that pick the condition drops; ``cfg_uniform`` ``[B]`` uniforms
    for the previewer's CFG weight (read when ``cfg_scale > 1``);
    ``vae_noise_gt`` / ``vae_noise_lq`` NHWC ``[B, h, w, 4]``, the posterior
    draws of the two encodes."""

    timesteps: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    drop_uniform: Optional[torch.Tensor] = None
    cfg_uniform: Optional[torch.Tensor] = None
    vae_noise_gt: Optional[torch.Tensor] = None
    vae_noise_lq: Optional[torch.Tensor] = None


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _module_tensors(ema: Optional[Dict[str, torch.Tensor]], model: str, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA tensors of ``model`` under the module's own names, each in the
    dtype of the parameter it stands for (LayerNorm32 keeps fp32 ones in a
    bf16 model)."""
    if ema is None:
        return {}
    own = dict(module.named_parameters())
    prefix = model + "."
    return {n[len(prefix):]: t.to(own[n[len(prefix):]].dtype) for n, t in ema.items() if n.startswith(prefix)}


def build_stage2_step(unet, aggregator, resampler, vae, image_encoder, schedule, losses, cfg: Stage2Config,
                      agg_resampler: Optional[Resampler] = None) -> Callable:
    """Returns ``loss_fn(batch, draws, generator, ema_adapter) -> (total,
    metrics)``, the differentiable part of a step; ``ema_adapter`` is the EMA
    copy ``{"<model>.<name>": tensor}`` the previewer runs with (None: the
    live adapter). With ``agg_resampler`` the image tokens are projected
    through it before the Aggregator call, which reads them."""
    alpha = cfg.lora_alpha
    iw = torch.from_numpy(importance_sampling_weights(schedule.num_train_timesteps)) if cfg.importance_sampling else None

    def loss_fn(batch: Dict[str, torch.Tensor], draws: Optional[Stage2Draws], generator: Optional[torch.Generator],
                ema_adapter: Optional[Dict[str, torch.Tensor]]):
        draws = draws or Stage2Draws()
        lq, gt = batch["lq"], batch["gt"]  # NHWC in [-1, 1]
        bsz, dev = gt.shape[0], gt.device
        factor = vae_scale_factor(vae.config)
        lat_shape = (bsz, gt.shape[1] // factor, gt.shape[2] // factor, vae.config.latent_channels)

        def normal(given, shape):
            return common.normal_draw(given, shape, generator, dev)

        def uniform(given):
            return common.uniform_draw(given, bsz, generator, dev)

        with torch.no_grad():
            # condition drops from one uniform per sample (reference :1461-1467)
            r = uniform(draws.drop_uniform)
            image_rate, text_rate = cfg.image_drop_rate, cfg.text_drop_rate
            drop_both = (r >= image_rate + text_rate) & (r < image_rate + text_rate + cfg.cond_drop_rate)
            drop_image = (r < image_rate) | drop_both
            drop_text = ((r >= image_rate) & (r < image_rate + text_rate)) | drop_both

            tokens_cond = image_encoder(_nchw(preprocess_dinov2((lq + 1.0) / 2.0, size=common.DINO_TRAIN_SIZE)))
            tokens_uncond = batch["uncond_tokens"].to(tokens_cond.dtype).expand_as(tokens_cond)
            tokens = torch.where(drop_image.reshape(bsz, 1, 1), tokens_uncond, tokens_cond)
            text = torch.where(drop_text.reshape(bsz, 1, 1), batch["uncond_prompt_embeds"], batch["prompt_embeds"])
            pooled = torch.where(drop_text.reshape(bsz, 1), batch["uncond_pooled_embeds"], batch["pooled_embeds"])
            time_ids = batch["time_ids"]

            gt_latent = scale_latents(vae.config, vae.encode(_nchw(gt.float()),
                                                             noise=_nchw(normal(draws.vae_noise_gt, lat_shape))))
            lq_latent = scale_latents(vae.config, vae.encode(_nchw(lq.float()),
                                                             noise=_nchw(normal(draws.vae_noise_lq, lat_shape))))
            # uniform t; importance sampling enters as a T·p(t) loss weight
            t = draws.timesteps
            if t is None:
                t = common.sample_timesteps(generator, bsz, schedule.num_train_timesteps, None, device=dev)
            t = t.to(dev).long()
            noise = _nchw(normal(draws.noise, lat_shape))
            noisy = add_noise(schedule, gt_latent, noise, t)

            # the previewer: EMA adapter, LoRA on
            ema_unet = _module_tensors(ema_adapter, "unet", unet)
            ema_res = _module_tensors(ema_adapter, "resampler", resampler)

            def previewer_eps(text_in, tokens_in):
                ip = functional_call(resampler, ema_res, (tokens_in,), {"lora_scale": alpha})
                return functional_call(unet, ema_unet, (noisy, t, text_in, pooled, time_ids),
                                       {"ip_hidden_states": ip, "lora_scale": alpha})

            eps = previewer_eps(text, tokens)
            if cfg.cfg_scale > 1.0:
                eps_u = previewer_eps(batch["uncond_prompt_embeds"], tokens_uncond)
                w = 1.0 + uniform(draws.cfg_uniform).reshape(bsz, 1, 1, 1) * (cfg.cfg_scale - 1.0)
                eps = eps_u + w * (eps - eps_u)
            preview = lcm_single_step(schedule, eps, t, noisy)
            preview_err = torch.mean((preview.float() - gt_latent.float()) ** 2)

        agg_kwargs = {}
        if agg_resampler is not None:  # the image-dropped tokens, projected before the Aggregator call
            agg_kwargs["ip_hidden_states"] = agg_resampler(tokens)
        down_res, mid_res = aggregator(lq_latent, t, preview, pooled, time_ids, **agg_kwargs)
        ip_base = resampler(tokens, lora_scale=0.0)
        eps_pred = unet(noisy, t, text, pooled, time_ids, ip_hidden_states=ip_base,
                        down_block_additional_residuals=down_res, mid_block_additional_residual=mid_res,
                        lora_scale=0.0)

        weights = None
        if iw is not None:
            weights = schedule.num_train_timesteps * iw.to(dev)[t]
        total = 0.0
        metrics = {"preview_error_latent": preview_err}
        for loss, lw in losses:
            val = loss(DiffusionLossInputs(predicted=eps_pred, target=noise, timesteps=t, weights=weights))
            total = total + lw * val
            metrics[type(loss).__name__] = val.detach()
        return total, metrics

    return loss_fn


class Stage2Trainer(common.Trainer):
    """Holds the models, the optimiser, the fp32 EMA adapter copy and the step
    (``common.Trainer``). ``device="cuda"`` (the default) raises without a
    card; pass ``device="cpu"`` to train on the CPU. With ``aggregator_adapter``
    the Aggregator must have been built with the adapter and ``agg_resampler``
    given (``enable_aggregator_adapter`` makes both): it joins the models as
    ``"agg_resampler"``. ``mesh`` as ``common.Trainer``: the EMA copy stays
    whole on every rank, which all apply the same update to the same masters."""

    def __init__(self, unet, aggregator, resampler, vae, image_encoder, cfg: Stage2Config,
                 losses_config: Optional[LossesConfig] = None, schedule=None, device="cuda",
                 agg_resampler: Optional[Resampler] = None, mesh="auto"):
        if cfg.aggregator_adapter:
            if agg_resampler is None:
                raise ValueError("aggregator_adapter=True needs the aggregator's Resampler module "
                                 "(agg_resampler) -- use enable_aggregator_adapter(...) to build it")
            if not getattr(aggregator, "aggregator_adapter", False):
                raise ValueError("aggregator_adapter=True but the Aggregator module was built "
                                 "without aggregator_adapter=True")
        self.agg_resampler = agg_resampler if cfg.aggregator_adapter else None
        self.unet, self.aggregator, self.resampler = unet, aggregator, resampler
        self.vae, self.image_encoder = vae, image_encoder
        models = {"unet": unet, "aggregator": aggregator, "resampler": resampler, "vae": vae,
                  "image_encoder": image_encoder}
        if self.agg_resampler is not None:
            models["agg_resampler"] = self.agg_resampler
        super().__init__("stage2", models, cfg, stage2_trainable_pred(cfg), losses_config, schedule, device, mesh)
        self.ema_adapter: Optional[Dict[str, torch.Tensor]] = None
        if cfg.use_ema_adapter:
            self.ema_adapter = {n: p.detach().float().clone() for n, p in self.named_parameters().items()
                                if ADAPTER_EMA_PRED(tuple(n.split(".")))}
        self._loss_fn = build_stage2_step(unet, aggregator, resampler, vae, image_encoder, self.schedule,
                                          self.losses, cfg, agg_resampler=self.agg_resampler)

    def loss(self, batch, draws: Optional[Stage2Draws] = None, generator: Optional[torch.Generator] = None):
        """The differentiable forward of a step, the previewer on the EMA
        adapter: (weighted loss total, metrics)."""
        return self._loss_fn(batch, *self.step_draws(draws, generator), self.ema_adapter)

    def train_step(self, batch, draws: Optional[Stage2Draws] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``common.Trainer.train_step``, then the EMA update of the adapter
        copy on every ``ema_update_steps``-th step when the adapter trains."""
        metrics = super().train_step(batch, draws, generator)
        cfg = self.cfg
        if self.ema_adapter is not None and cfg.optimize_adapter and self.global_step % cfg.ema_update_steps == 0:
            masters = self.master_parameters()
            common.ema_update(self.ema_adapter, {n: masters[n] for n in self.ema_adapter}, cfg.ema_decay)
        return metrics

    def checkpoint_state(self):
        """``common.Trainer.checkpoint_state`` plus the fp32 EMA adapter copy (``ema_adapter``)."""
        state = super().checkpoint_state()
        if self.ema_adapter is not None:
            state["ema_adapter"] = self.ema_adapter
        return state

    @torch.no_grad()
    def load_checkpoint_state(self, state) -> None:
        super().load_checkpoint_state(state)
        if self.ema_adapter is not None and "ema_adapter" in state:
            for n, t in self.ema_adapter.items():
                t.copy_(state["ema_adapter"][n])

    frozen_unet_keep = staticmethod(stage1_trainable_pred)

    def validate(self, val_batch, cond):
        from instantir_tpu_torch.train.validation import validate_stage2

        return validate_stage2(self, val_batch["lq"], val_batch["gt"], cond, self.tracker, self.global_step)

    def aggregator_state(self) -> Dict[str, torch.Tensor]:
        """The reference-format ``aggregator_ckpt.pt`` payload in fp32 on the
        CPU, the trained leaves from their fp32 masters: the port's Aggregator
        names are those ``convert.export_aggregator`` gives the JAX tree
        (``train_stage2_aggregator.py:1023-1043``)."""
        return {k: common.fp32_cpu(v) for k, v in self.master_state("aggregator").items()}

    def export_aggregator(self, path: str) -> None:
        torch.save(self.aggregator_state(), path)
