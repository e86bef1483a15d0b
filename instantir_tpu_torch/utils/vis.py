"""Visualization helpers: caption strips on images for the tracker, grids, AdaIN.

Twin of ``instantir_tpu/utils/vis.py`` (reference ``utils/vis_utils.py``).
The image helpers work on uint8 ``[H, W, 3]`` numpy arrays (Pillow draws the
captions, imported inside the function); ``calc_mean_std`` and
``adaptive_instance_normalization`` work on NCHW tensors, as the reference's
``infer.py`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def add_text_to_image(image: np.ndarray, text: str, strip_height: int = 24) -> np.ndarray:
    """Prepend a white caption strip with ``text`` to an [H, W, 3] uint8 image."""
    from PIL import Image, ImageDraw

    h, w, _ = image.shape
    strip = np.full((strip_height, w, 3), 255, np.uint8)
    canvas = Image.fromarray(np.concatenate([strip, image], axis=0))
    ImageDraw.Draw(canvas).text((4, 4), text, fill=(0, 0, 0))
    return np.asarray(canvas)


def image_grid(images: Sequence[np.ndarray], cols: Optional[int] = None) -> np.ndarray:
    """Tile equally sized [H, W, 3] images into a grid of ``cols`` columns (default: one row)."""
    n = len(images)
    cols = cols or n
    rows = (n + cols - 1) // cols
    h, w, c = images[0].shape
    grid = np.zeros((rows * h, cols * w, c), images[0].dtype)
    for i, im in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    return grid


def triplet_strip(lq: np.ndarray, restored: np.ndarray, gt: Optional[np.ndarray] = None) -> np.ndarray:
    """LQ | restored | (GT) with captions: the strip the trainers log."""
    panels = [add_text_to_image(lq, "LQ"), add_text_to_image(restored, "restored")]
    if gt is not None:
        panels.append(add_text_to_image(gt, "GT"))
    return np.concatenate(panels, axis=1)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-channel spatial mean and std of an NCHW tensor
    (reference ``infer.py:90-105``): unbiased variance, ``eps`` added before
    the root. Returns ``[B, C, 1, 1]`` pairs."""
    b, c = feat.shape[:2]
    flat = feat.reshape(b, c, -1)
    n = flat.shape[-1]
    var = flat.var(dim=-1, correction=1 if n > 1 else 0)
    return flat.mean(dim=-1).reshape(b, c, 1, 1), torch.sqrt(var + eps).reshape(b, c, 1, 1)


def adaptive_instance_normalization(content_feat: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
    """AdaIN: ``content_feat`` re-statisticked to ``style_feat``'s per-channel
    spatial mean and std (reference ``infer.py:107-111``), NCHW."""
    style_mean, style_std = calc_mean_std(style_feat)
    content_mean, content_std = calc_mean_std(content_feat)
    return (content_feat - content_mean) / content_std * style_std + style_mean
