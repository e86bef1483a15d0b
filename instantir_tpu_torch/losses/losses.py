"""Diffusion-space losses, config-instantiated and registry-dispatched.

Twin of ``instantir_tpu/losses/losses.py``. Ported: L2 with optional
per-sample importance weights (the stage-1/2 diffusion objective), L1,
pseudo-Huber (the previewer's LCM distillation) and WeightedNoise. Every loss
is computed in fp32 whatever the model dtype. The perceptual and feature
losses of the JAX package (DINOLoss, LPIPSLoss, CLIPLoss, IDLoss,
DreamSIMLoss) and ``LCMVisualization`` are not ported yet: ``build_losses``
raises ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from instantir_tpu_torch.losses.loss_config import SingleLossConfig


@dataclasses.dataclass
class DiffusionLossInputs:
    """Everything a diffusion-space loss may consume."""

    predicted: torch.Tensor  # model output (eps-hat or consistency prediction)
    target: torch.Tensor  # eps or distillation target
    timesteps: Optional[torch.Tensor] = None  # [B]
    weights: Optional[torch.Tensor] = None  # [B] importance weights
    pred_image: Optional[torch.Tensor] = None  # decoded prediction (image-space losses)
    target_image: Optional[torch.Tensor] = None


class Loss:
    """Base: ``__call__(inputs) -> scalar``."""

    # image-space losses set True: a trainer then decodes pred/target through
    # the VAE and fills pred_image/target_image
    needs_images: bool = False

    def __init__(self, visualize_every_k: int = -1, **kwargs):
        self.visualize_every_k = visualize_every_k

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        raise NotImplementedError


def _weighted_mean(per_sample: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return per_sample.mean()
    return (per_sample * weights.to(per_sample.dtype)).mean()


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


class L2Loss(Loss):
    """MSE with optional per-sample importance weights."""

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        per = _per_sample_mean((inputs.predicted.float() - inputs.target.float()) ** 2)
        return _weighted_mean(per, inputs.weights)


class L1Loss(Loss):
    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        per = _per_sample_mean((inputs.predicted.float() - inputs.target.float()).abs())
        return _weighted_mean(per, inputs.weights)


class HuberLoss(Loss):
    """Pseudo-Huber: sqrt(d^2 + c^2) - c (c = 0.001 in the reference recipe)."""

    def __init__(self, huber_c: float = 0.001, **kwargs):
        super().__init__(**kwargs)
        self.huber_c = huber_c

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        d2 = (inputs.predicted.float() - inputs.target.float()) ** 2
        per = _per_sample_mean(torch.sqrt(d2 + self.huber_c**2) - self.huber_c)
        return _weighted_mean(per, inputs.weights)


class WeightedNoiseLoss(L2Loss):
    """L2 with externally supplied per-sample weights."""


LOSS_REGISTRY: Dict[str, Any] = {
    "L2Loss": L2Loss,
    "L1Loss": L1Loss,
    "HuberLoss": HuberLoss,
    "WeightedNoiseLoss": WeightedNoiseLoss,
}
NOT_PORTED = ("LCMVisualization", "DINOLoss", "LPIPSLoss", "DreamSIMLoss", "CLIPLoss", "IDLoss")


def build_losses(configs: List[SingleLossConfig]) -> List[Tuple[Loss, float]]:
    """Instantiate (loss, weight) pairs from config."""
    out = []
    for c in configs:
        if c.name in NOT_PORTED:
            raise NotImplementedError(f"loss {c.name!r} is not ported yet (ported: {sorted(LOSS_REGISTRY)})")
        if c.name not in LOSS_REGISTRY:
            raise KeyError(f"unknown loss {c.name!r}")
        out.append((LOSS_REGISTRY[c.name](visualize_every_k=c.visualize_every_k, **c.init_params), c.weight))
    return out
