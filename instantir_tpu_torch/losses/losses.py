"""Diffusion-space losses, config-instantiated and registry-dispatched.

Twin of ``instantir_tpu/losses/losses.py``. Ported: L2 with optional
per-sample importance weights (the stage-1/2 diffusion objective), L1,
pseudo-Huber (the previewer's LCM distillation), WeightedNoise, DINOLoss
(teacher-centred softmax cross-entropy over DINOv2 tokens, the features from
a ``feature_fn`` the trainer supplies) and ``LCMVisualization``. Every loss
is computed in fp32 whatever the model dtype. The perceptual losses of the
JAX package (LPIPSLoss, CLIPLoss, IDLoss, DreamSIMLoss) are not ported yet:
``build_losses`` raises ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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


FeatureFn = Callable[[torch.Tensor], torch.Tensor]


class DINOLoss(Loss):
    """Teacher-centred softmax cross-entropy over DINOv2 tokens: student
    tokens of ``pred_image`` at temperature ``student_temp``, teacher tokens
    of ``target_image`` (no gradient) less a running center at
    ``teacher_temp``. ``feature_fn`` maps [-1, 1] NHWC images to tokens
    ``[B, N, D]``; the trainer passes its DINOv2."""

    needs_images = True

    def __init__(self, feature_fn: Optional[FeatureFn] = None, student_temp: float = 0.1,
                 teacher_temp: float = 0.04, center_momentum: float = 0.9, **kwargs):
        super().__init__(**kwargs)
        self.feature_fn = feature_fn
        self.student_temp = student_temp
        self.teacher_temp = teacher_temp
        self.center_momentum = center_momentum
        self.center: Optional[torch.Tensor] = None  # running center, folded by update_center

    def apply_with_center(self, inputs: DiffusionLossInputs, feature_fn: FeatureFn,
                          center: Union[torch.Tensor, float]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, the teacher tokens' mean over batch and tokens): the caller
        folds the mean into its center with ``center_momentum``."""
        student = feature_fn(inputs.pred_image).float()
        with torch.no_grad():
            teacher = feature_fn(inputs.target_image).float()
        t = torch.softmax((teacher - center) / self.teacher_temp, dim=-1)
        log_s = torch.log_softmax(student / self.student_temp, dim=-1)
        loss = -(t * log_s).sum(dim=-1).mean()
        return loss, teacher.mean(dim=(0, 1))

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if self.feature_fn is None:
            raise ValueError("DINOLoss requires feature_fn (the DINOv2 forward)")
        loss, self.latest_teacher_mean = self.apply_with_center(
            inputs, self.feature_fn, 0.0 if self.center is None else self.center)
        return loss

    def update_center(self) -> None:
        """Fold the last call's teacher mean into the center (momentum
        ``center_momentum``; the first fold takes the mean as it is)."""
        if not hasattr(self, "latest_teacher_mean"):
            return
        m, mean = self.center_momentum, self.latest_teacher_mean
        self.center = mean if self.center is None else self.center * m + mean * (1 - m)


class LCMVisualization(Loss):
    """Contributes 0 to the objective. Its presence asks the previewer
    trainer for an [lq | gt | one-step prediction] strip every
    ``visualize_every_k`` steps (and so for the decoded images)."""

    needs_images = True

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=inputs.predicted.device)


LOSS_REGISTRY: Dict[str, Any] = {
    "LCMVisualization": LCMVisualization,
    "L2Loss": L2Loss,
    "L1Loss": L1Loss,
    "HuberLoss": HuberLoss,
    "WeightedNoiseLoss": WeightedNoiseLoss,
    "DINOLoss": DINOLoss,
}
NOT_PORTED = ("LPIPSLoss", "DreamSIMLoss", "CLIPLoss", "IDLoss")


def build_losses(configs: List[SingleLossConfig], **shared_kwargs) -> List[Tuple[Loss, float]]:
    """Instantiate (loss, weight) pairs from config. A ``feature_fn`` among
    ``shared_kwargs`` goes to each DINOLoss whose config gives none."""
    out = []
    for c in configs:
        if c.name in NOT_PORTED:
            raise NotImplementedError(f"loss {c.name!r} is not ported yet (ported: {sorted(LOSS_REGISTRY)})")
        if c.name not in LOSS_REGISTRY:
            raise KeyError(f"unknown loss {c.name!r}")
        kwargs = dict(c.init_params)
        if c.name == "DINOLoss" and "feature_fn" in shared_kwargs:
            kwargs.setdefault("feature_fn", shared_kwargs["feature_fn"])
        out.append((LOSS_REGISTRY[c.name](visualize_every_k=c.visualize_every_k, **kwargs), c.weight))
    return out
