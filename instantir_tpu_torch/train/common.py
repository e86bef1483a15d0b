"""What the trainers share: parameter selection, LR schedules, AdamW, timestep draws.

Twin of the parts of ``instantir_tpu/train/common.py`` that stage 1 uses, in
PyTorch idiom: a path predicate sets ``requires_grad`` on named parameters
(in place of partitioned pytrees) and ``torch.optim.AdamW`` with optax's
global-norm clip and schedule semantics stands in for the optax chain. The
mesh/ZeRO helpers, ``quantize_frozen_unet``, 8-bit Adam, the checkpoint
manager, the tracker, batch pipelining, the preemption handler and the EMA
helpers of the JAX package are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

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
    number of updates made so far, and returns the norm before clipping."""

    def __init__(self, params: List[nn.Parameter], lr: Union[Callable[[int], float], float], weight_decay: float,
                 b1: float, b2: float, eps: float, max_grad_norm: Optional[float]):
        self.params = list(params)
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.optimizer = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps,
                                           weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        if self.max_grad_norm is not None:
            factor = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
            grads = [g * factor.to(g.dtype) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
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


def sample_timesteps(generator: torch.Generator, batch: int, num_train_timesteps: int,
                     importance_weights=None, device=None) -> torch.Tensor:
    """Uniform or importance-weighted t ~ p(t), int64 ``[batch]``."""
    if importance_weights is None:
        return torch.randint(0, num_train_timesteps, (batch,), generator=generator, device=device)
    probs = torch.as_tensor(importance_weights, dtype=torch.float32, device=device)
    return torch.multinomial(probs, batch, replacement=True, generator=generator)
