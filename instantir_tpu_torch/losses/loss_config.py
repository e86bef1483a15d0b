"""YAML -> dataclass loss configuration.

Twin of ``instantir_tpu/losses/loss_config.py``: two loss groups,
``diffusion_losses`` applied to the eps/latent objective and ``lcm_losses``
applied to the consistency (previewer distillation) objective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


@dataclasses.dataclass
class SingleLossConfig:
    name: str
    weight: float = 1.0
    init_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    visualize_every_k: int = -1


@dataclasses.dataclass
class LossesConfig:
    diffusion_losses: List[SingleLossConfig] = dataclasses.field(default_factory=list)
    lcm_losses: List[SingleLossConfig] = dataclasses.field(default_factory=list)


def load_losses_config(path: str) -> LossesConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    def parse(items):
        return [SingleLossConfig(**i) for i in (items or [])]

    return LossesConfig(diffusion_losses=parse(raw.get("diffusion_losses")), lcm_losses=parse(raw.get("lcm_losses")))
