"""What the trainers share: parameter selection, LR schedules, AdamW, timestep
draws, the EMA helpers and the trainer frame.

Twin of the parts of ``instantir_tpu/train/common.py`` that the trainers use,
in PyTorch idiom: a path predicate sets ``requires_grad`` on named parameters
(in place of partitioned pytrees), ``torch.optim.AdamW`` with optax's
global-norm clip and schedule semantics stands in for the optax chain, and
the EMA helpers work on dicts of name -> tensor. ``Trainer`` holds what the
JAX ``Stage1Trainer``, ``Stage2Trainer`` and ``PreviewerTrainer`` repeat. The mesh/ZeRO helpers,
``quantize_frozen_unet``, 8-bit Adam, the checkpoint manager, the tracker,
batch pipelining and the preemption handler of the JAX package are not ported
yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

from instantir_tpu_torch.losses import build_losses
from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule

PathPred = Callable[[Tuple[str, ...]], bool]


def named_parameters(models: Dict[str, nn.Module]) -> Dict[str, nn.Parameter]:
    """``{"<model>.<parameter name>": parameter}`` over a dict of models."""
    return {f"{top}.{name}": p for top, model in models.items() for name, p in model.named_parameters()}


def set_trainable(models: Dict[str, nn.Module], pred: PathPred) -> List[str]:
    """Set ``requires_grad`` on every parameter from ``pred`` applied to its
    path ``(model, *name.split("."))``; returns the trainable names. The
    frozen majority then never enters the backward pass's parameter gradients."""
    trainable = []
    for full, p in named_parameters(models).items():
        on = bool(pred(tuple(full.split("."))))
        p.requires_grad_(on)
        if on:
            trainable.append(full)
    return trainable


def fp32_cpu(t: torch.Tensor) -> torch.Tensor:
    """An fp32 copy on the CPU (an export's leaf)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def count_params(params: Iterable[torch.Tensor]) -> int:
    return int(sum(p.numel() for p in params))


def lr_schedule(name: str, base_lr: float, warmup_steps: int = 0, total_steps: int = 1_000_000) -> Callable[[int], float]:
    """constant | cosine with linear warm-up from 0, as a function of the
    number of updates already made (the first update of a warmed-up schedule
    therefore has learning rate 0, as in the JAX package)."""
    if name == "constant":
        def main(step: int) -> float:
            return base_lr
    elif name == "cosine":
        decay_steps = max(total_steps - warmup_steps, 1)

        def main(step: int) -> float:
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * min(max(step, 0), decay_steps) / decay_steps))
    else:
        raise ValueError(f"unknown lr schedule {name}")
    if warmup_steps <= 0:
        return main

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return main(step - warmup_steps)

    return schedule


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class ClippedAdamW:
    """``torch.optim.AdamW`` behind optax's ``clip_by_global_norm`` and
    learning-rate schedule: ``step(grads)`` scales the gradients by
    ``max_norm / max(norm, max_norm)``, applies AdamW (decoupled decay, eps
    outside the root, bias correction) with the schedule evaluated at the
    number of updates made so far, and returns the norm before clipping.

    A leaf narrower than fp32 (a bf16 model's) trains through an fp32 master
    copy, as the JAX trainers train fp32 parameters under bf16 compute: the
    norm, the clip and the AdamW update (fp32 moments) are taken in fp32 on
    the master, whose rounding is then written back into the leaf -- the value
    the JAX modules cast their fp32 parameters to at each use. ``masters[i]``
    is ``params[i]`` itself for an fp32 leaf."""

    def __init__(self, params: List[nn.Parameter], lr: Union[Callable[[int], float], float], weight_decay: float,
                 b1: float, b2: float, eps: float, max_grad_norm: Optional[float]):
        self.params = list(params)
        self.masters = [p if p.dtype == torch.float32 else p.detach().float().clone() for p in self.params]
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.optimizer = torch.optim.AdamW(self.masters, lr=self.schedule(0), betas=(b1, b2), eps=eps,
                                           weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        factor = None
        if self.max_grad_norm is not None:
            factor = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
        for m, g in zip(self.masters, grads):  # one fp32 gradient at a time: no second copy of them all
            g = g.float()
            m.grad = g if factor is None else g * factor
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for p, m in zip(self.params, self.masters):
            if m is not p:
                p.copy_(m)
        self.count += 1
        return norm


def make_adamw(
    params: List[nn.Parameter],
    lr: Union[Callable[[int], float], float],
    weight_decay: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    use_8bit: bool = False,
) -> ClippedAdamW:
    if use_8bit:
        raise NotImplementedError("make_adamw(use_8bit=True): the blockwise-int8 Adam is not ported yet")
    return ClippedAdamW(params, lr, weight_decay, b1, b2, eps, max_grad_norm)


def normal_draw(given: Optional[torch.Tensor], shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """``given`` on ``device``, or an fp32 standard-normal draw of ``shape`` from ``generator``."""
    if given is not None:
        return given.to(device)
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def uniform_draw(given: Optional[torch.Tensor], batch: int, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """``given`` as ``[batch]`` on ``device``, or ``batch`` fp32 uniforms in [0, 1) from ``generator``."""
    if given is not None:
        return given.to(device).reshape(batch)
    return torch.rand((batch,), generator=generator, dtype=torch.float32, device=device)


def sample_timesteps(generator: torch.Generator, batch: int, num_train_timesteps: int,
                     importance_weights=None, device=None) -> torch.Tensor:
    """Uniform or importance-weighted t ~ p(t), int64 ``[batch]``."""
    if importance_weights is None:
        return torch.randint(0, num_train_timesteps, (batch,), generator=generator, device=device)
    probs = torch.as_tensor(importance_weights, dtype=torch.float32, device=device)
    return torch.multinomial(probs, batch, replacement=True, generator=generator)


# ---------------------------------------------------------------------------
# EMA (dicts of name -> tensor; in place, where the JAX package returns new trees)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], decay: float) -> None:
    """``ema <- ema·d + new·(1−d)`` in place, ``new`` cast to each EMA tensor's
    dtype (reference ``update_ema_model``, ``train_stage2_aggregator.py:719-722``)."""
    for name, e in ema.items():
        e.copy_(e * decay + new[name].to(e.dtype) * (1.0 - decay))


@torch.no_grad()
def masked_ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], mask: Dict[str, bool],
                      decay: float) -> None:
    """``ema_update`` on the names ``mask`` selects; the others track ``new`` exactly."""
    for name, e in ema.items():
        n = new[name].to(e.dtype)
        e.copy_(e * decay + n * (1.0 - decay) if mask[name] else n)


def swap_masked(params: Dict[str, torch.Tensor], donor: Dict[str, torch.Tensor],
                mask: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """The tensors of ``donor`` where ``mask`` is set, those of ``params``
    elsewhere: the analogue of the reference's EMA attn-processor swap
    (``train_stage2_aggregator.py:1535-1540``)."""
    return {name: donor[name] if mask[name] else p for name, p in params.items()}


# ---------------------------------------------------------------------------
# The trainer frame
# ---------------------------------------------------------------------------

# The trainers feed DINOv2 224² pixels whatever its native grid, as the JAX
# trainers do; the encoder resizes its position embeddings to fit.
DINO_TRAIN_SIZE = 224


class Trainer:
    """The models on one device, the trainable split from a path predicate,
    the losses ``loss_configs`` picks, ``ClippedAdamW`` on the trainable
    leaves, every draw of a step from a seeded ``torch.Generator`` unless
    given, and gradient accumulation. A subclass sets
    ``self._loss_fn(batch, draws, generator) -> (total, metrics)``.
    ``device="cuda"`` (the default) raises without a card; pass
    ``device="cpu"`` to train on the CPU."""

    def __init__(self, tag: str, models: Dict[str, nn.Module], cfg, pred: PathPred,
                 losses_config: Optional[LossesConfig], schedule, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device 'cuda' requested but no CUDA device is available "
                               "(pass device='cpu' to train on the CPU)")
        self.cfg = cfg
        self.models = models
        for name, model in models.items():
            where = {p.device.type for p in model.parameters()}
            if where != {self.device.type}:
                raise ValueError(f"{type(self).__name__}: {name} lies on {sorted(where)}, "
                                 f"the trainer on {self.device.type}")
        self.schedule = (schedule or sdxl_schedule()).to(self.device)
        self.losses = build_losses(self.loss_configs(losses_config))
        self.trainable_names = set_trainable(models, pred)
        named = self.named_parameters()
        self.trainable: List[nn.Parameter] = [named[n] for n in self.trainable_names]
        self.optimizer = make_adamw(
            self.trainable, lr_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.lr_warmup_steps, cfg.max_train_steps),
            weight_decay=cfg.weight_decay, use_8bit=cfg.use_8bit_adam, max_grad_norm=cfg.max_grad_norm)
        self._loss_fn: Optional[Callable] = None
        self._accumulated: Optional[List[torch.Tensor]] = None
        self._micro_steps = 0
        self._uncond_tok: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.global_step = 0
        print(f"[{tag}] trainable params: {count_params(self.trainable) / 1e6:.2f}M")

    def loss_configs(self, losses_config: Optional[LossesConfig]) -> List[SingleLossConfig]:
        """The losses this trainer sums: ``diffusion_losses``, L2 by default
        (stages 1 and 2; the previewer reads ``lcm_losses``)."""
        return losses_config.diffusion_losses if losses_config else [SingleLossConfig(name="L2Loss")]

    def named_parameters(self) -> Dict[str, nn.Parameter]:
        """Every parameter of the models under ``<model>.<name>``."""
        return named_parameters(self.models)

    def master_parameters(self) -> Dict[str, torch.Tensor]:
        """``named_parameters`` with each trainable leaf as its fp32 master
        (``ClippedAdamW.masters``): the values the JAX trainers hold."""
        named: Dict[str, torch.Tensor] = dict(self.named_parameters())
        named.update(zip(self.trainable_names, self.optimizer.masters))
        return named

    def master_state(self, model: str) -> Dict[str, torch.Tensor]:
        """``models[model].state_dict()`` with each trainable leaf read from
        its fp32 master: what the exports are made of."""
        named = self.master_parameters()
        return {k: named.get(f"{model}.{k}", v) for k, v in self.models[model].state_dict().items()}

    @torch.no_grad()
    def _uncond_image_tokens(self) -> torch.Tensor:
        """DINOv2 tokens of the zero (preprocessed) 224² image: constant while
        the image encoder is frozen, so computed once."""
        if self._uncond_tok is None:
            self._uncond_tok = self.models["image_encoder"](
                torch.zeros((1, 3, DINO_TRAIN_SIZE, DINO_TRAIN_SIZE), dtype=torch.float32, device=self.device))
        return self._uncond_tok

    def prepare_batch(self, batch: Dict[str, torch.Tensor], cond: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """An already degraded pair ``{"lq", "gt"}`` (NHWC in [-1, 1]) plus the
        text conditioning (``cond``, whatever the step reads) -> the step's
        batch on the trainer's device. Raw ``{"images", "kernel", ...}``
        batches need the RealESRGAN degradation, which is not ported yet."""
        if "lq" not in batch or "gt" not in batch:
            raise NotImplementedError("prepare_batch: raw images need the on-device degradation "
                                      "(data/degradation.py), which is not ported yet; pass 'lq' and 'gt'")
        out = {"lq": torch.as_tensor(batch["lq"]).to(self.device), "gt": torch.as_tensor(batch["gt"]).to(self.device),
               "uncond_tokens": self._uncond_image_tokens()}
        out.update({k: torch.as_tensor(v).to(self.device) for k, v in cond.items()})
        return out

    def loss(self, batch, draws=None, generator: Optional[torch.Generator] = None):
        """The differentiable forward of a step: (weighted loss total, metrics)."""
        return self._loss_fn(batch, draws, generator or self._generator)

    def loss_and_grads(self, batch, draws=None, generator: Optional[torch.Generator] = None):
        """(loss, metrics, gradients of the trainable leaves in ``trainable_names`` order)."""
        total, metrics = self.loss(batch, draws, generator)
        grads = torch.autograd.grad(total, self.trainable)
        return total.detach(), metrics, list(grads)

    def train_step(self, batch, draws=None, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One (micro-)step. With ``gradient_accumulation_steps = k`` the
        optimiser steps on every k-th call, on the mean of the k gradients;
        ``grad_norm`` is this call's gradient norm before clipping."""
        loss, metrics, grads = self.loss_and_grads(batch, draws, generator)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            if self._accumulated is None:
                self._accumulated = [g.float() for g in grads]
            else:
                for a, g in zip(self._accumulated, grads):
                    a += g
            self._micro_steps += 1
            if self._micro_steps == k:
                self.optimizer.step([a / k for a in self._accumulated])  # the fp32 mean
                self._accumulated, self._micro_steps = None, 0
        else:
            self.optimizer.step(grads)
        self.global_step += 1
        return metrics
