"""LPIPS perceptual distance: the VGG16 trunk and the learned linear heads.

Twin of ``instantir_tpu/losses/lpips.py`` (what the reference gets from
``lpips.LPIPS(net='vgg')``): both images are shifted into VGG's input
statistics, VGG16 features are taken at the five relu checkpoints
(relu1_2/2_2/3_3/4_3/5_3), unit-normalized over channels in fp32, their
squared differences are mapped through per-layer 1×1 ``lin`` heads, averaged
over space and summed. Parameter names are the published checkpoint's
(``net.slice{k}.{i}.weight|bias``, ``lin{k}.model.1.weight``), so
``lpips.LPIPS(net='vgg').state_dict()`` loads by name. fp32 by default.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg16.features conv indices per LPIPS slice
VGG16_SLICES: Tuple[Tuple[int, ...], ...] = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG16_CHANNELS: Tuple[int, ...] = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (shift/scale from [-1, 1] inputs to VGG's statistics)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@dataclasses.dataclass(frozen=True)
class LPIPSConfig:
    slices: Tuple[Tuple[int, ...], ...] = VGG16_SLICES
    channels: Tuple[int, ...] = VGG16_CHANNELS
    eps: float = 1e-10


def tiny_lpips_config() -> LPIPSConfig:
    """Two slices of one tiny conv each, for unit tests."""
    return LPIPSConfig(slices=((0,), (2,)), channels=(4, 8))


class LPIPS(nn.Module):
    """``forward(x, y)``: two [B, H, W, 3] images in [-1, 1] -> per-sample distance [B] (fp32)."""

    def __init__(self, config: LPIPSConfig = LPIPSConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.net = nn.Module()
        in_ch = 3
        for si, (conv_ids, ch) in enumerate(zip(config.slices, config.channels)):
            convs = nn.ModuleDict()
            for ci in conv_ids:
                convs[str(ci)] = nn.Conv2d(in_ch, ch, 3, padding=1, dtype=dtype, device=device)
                in_ch = ch
            setattr(self.net, f"slice{si + 1}", convs)
            lin = nn.Module()
            lin.model = nn.ModuleDict({"1": nn.Conv2d(ch, 1, 1, bias=False, device=device)})  # fp32 heads
            setattr(self, f"lin{si}", lin)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b = x.shape[0]
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        # both images through the trunk in one batch
        h = ((torch.cat([x, y]) - shift) / scale).permute(0, 3, 1, 2).to(self.dtype)
        total = torch.zeros((b,), dtype=torch.float32, device=x.device)
        for si in range(len(cfg.slices)):
            if si > 0:
                h = F.max_pool2d(h, 2)
            for conv in getattr(self.net, f"slice{si + 1}").values():
                h = F.relu(conv(h))
            f = h.float()
            f = f / torch.sqrt((f * f).sum(dim=1, keepdim=True) + cfg.eps)
            d = (f[:b] - f[b:]) ** 2
            total = total + getattr(self, f"lin{si}").model["1"](d).mean(dim=(1, 2, 3))
        return total
