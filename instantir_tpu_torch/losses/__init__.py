"""Loss library of the port (twin of ``instantir_tpu/losses``)."""

from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig, load_losses_config
from instantir_tpu_torch.losses.losses import (
    LOSS_REGISTRY,
    CLIPLoss,
    DINOLoss,
    DiffusionLossInputs,
    DreamSIMLoss,
    HuberLoss,
    IDLoss,
    L1Loss,
    L2Loss,
    LCMVisualization,
    Loss,
    LPIPSLoss,
    WeightedNoiseLoss,
    build_losses,
)

__all__ = [
    "LOSS_REGISTRY", "CLIPLoss", "DINOLoss", "DiffusionLossInputs", "DreamSIMLoss", "HuberLoss", "IDLoss", "L1Loss",
    "L2Loss", "LCMVisualization", "Loss", "LPIPSLoss", "LossesConfig", "SingleLossConfig", "WeightedNoiseLoss",
    "build_losses", "load_losses_config",
]
