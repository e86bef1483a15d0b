"""CLIP-loss image augmentations (reference ``losses/losses.py:296-333``).

Twin of ``instantir_tpu/losses/augmentations.py``: the batch is resized
(antialiased bilinear, ``jax.image.resize``'s weights), the resize kept as
the first tile, and ``augmentations_number - 1`` more tiles pushed through
an affine warp (rotation about the centre and a translation, kornia
``RandomAffine(degrees=15, translate=0.1)``) and then a perspective warp
(corners moved inward, kornia ``RandomPerspective(0.7)``), each applied with
probability ``p``. A warp is a 3×3 output->input homography applied by a
differentiable bilinear sampler with border or zero fill.

``jax.random`` cannot be reproduced, so the draws are an argument
(``AugmentationDraws``: the homographies and the apply-flags); without one
they come from a ``torch.Generator`` (``sample_augmentation_draws``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from instantir_tpu_torch.models.dinov2 import _triangle, resize_bhwc


@dataclasses.dataclass
class AugmentationDraws:
    """Per augmented image i: its affine and perspective homographies
    [N, 3, 3] (output->input) and whether each is applied [N] (bool)."""

    affine: torch.Tensor
    use_affine: torch.Tensor
    perspective: torch.Tensor
    use_perspective: torch.Tensor


def _bilinear_sample(images: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border: bool) -> torch.Tensor:
    """images [N, H, W, C]; sx/sy [N, oh, ow] source coordinates -> [N, oh, ow, C]."""
    n, h, w, _ = images.shape
    x0 = torch.clamp(torch.floor(sx), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    idx = torch.arange(n, device=images.device).reshape(n, 1, 1)

    def gather(yy, xx):
        return images[idx, yy.long(), xx.long()]

    out = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x1) * (1 - wy) * wx
           + gather(y1, x0) * wy * (1 - wx) + gather(y1, x1) * wy * wx)
    if border:
        return out  # clamped coordinates are border padding
    valid = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    return out * valid


def projective_warp(images: torch.Tensor, hom: torch.Tensor, border: bool = False) -> torch.Tensor:
    """Inverse-warp [N, H, W, C] images by [N, 3, 3] output->input homographies."""
    n, h, w, _ = images.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                            torch.arange(w, dtype=torch.float32, device=images.device), indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # [H, W, 3]
    src = torch.einsum("hwk,njk->nhwj", coords, hom.float())
    return _bilinear_sample(images, src[..., 0] / src[..., 2], src[..., 1] / src[..., 2], border)


def affine_homography(angle_deg: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """kornia RandomAffine's map for rotation ``angle_deg`` about the centre
    and translation (tx, ty) pixels, inverted (output->input): [N, 3, 3]."""
    ang = angle_deg * math.pi / 180.0
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    c, s = torch.cos(-ang), torch.sin(-ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [torch.stack([c, -s, cx - c * (cx + tx) + s * (cy + ty)], -1),
            torch.stack([s, c, cy - s * (cx + tx) - c * (cy + ty)], -1),
            torch.stack([zero, zero, one], -1)]
    return torch.stack(rows, dim=-2)


def four_point_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[N, 4, 2] point pairs -> [N, 3, 3] H (h33 = 1) with H·src_i ∝ dst_i."""
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([r1, r2], dim=2).reshape(-1, 8, 8)
    sol = torch.linalg.solve(a, dst.reshape(-1, 8))
    return torch.cat([sol, torch.ones_like(sol[:, :1])], dim=-1).reshape(-1, 3, 3)


def perspective_homography(offsets01: torch.Tensor, h: int, w: int, distortion: float) -> torch.Tensor:
    """kornia RandomPerspective: corners moved inward by ``offsets01`` [N, 4,
    2] (uniform in [0, 1)) x distortion / 2 x size; returns the map from the
    moved (output) corners back to the originals [N, 3, 3]."""
    dev = offsets01.device
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]], device=dev)
    signs = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=dev)
    dst = corners + signs * (offsets01 * distortion / 2.0 * torch.tensor([w, h], dtype=torch.float32, device=dev))
    return four_point_homography(dst, corners.expand_as(dst))


def sample_augmentation_draws(n: int, size: int, generator: Optional[torch.Generator], device, p: float = 0.7,
                              degrees: float = 15.0, translate: float = 0.1,
                              distortion: float = 0.7) -> AugmentationDraws:
    """The draws of ``n`` augmented images of ``size``² from ``generator``
    (the distributions of the JAX sampler, not its stream)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    ang = (2 * u(n) - 1) * degrees
    tx, ty = (2 * u(n) - 1) * translate * size, (2 * u(n) - 1) * translate * size
    return AugmentationDraws(affine=affine_homography(ang, tx, ty, size, size), use_affine=u(n) < p,
                             perspective=perspective_homography(u(n, 4, 2), size, size, distortion),
                             use_perspective=u(n) < p)


def image_augmentations(images: torch.Tensor, output_size: int, augmentations_number: int,
                        draws: Optional[AugmentationDraws] = None, generator: Optional[torch.Generator] = None,
                        p: float = 0.7, degrees: float = 15.0, translate: float = 0.1,
                        distortion: float = 0.7) -> torch.Tensor:
    """[B, H, W, C] -> [B·N, S, S, C]: the first B resized and not
    augmented, the rest warped by ``draws`` (drawn from ``generator`` when
    not given), tile by tile in the JAX order."""
    b = images.shape[0]
    resized = resize_bhwc(images, output_size, output_size, _triangle)
    n_aug = (augmentations_number - 1) * b
    if n_aug <= 0:
        return resized
    if draws is None:
        draws = sample_augmentation_draws(n_aug, output_size, generator, images.device, p, degrees, translate,
                                          distortion)
    eye = torch.eye(3, device=images.device)
    tiled = resized.repeat(augmentations_number - 1, 1, 1, 1)
    m_aff = torch.where(draws.use_affine.reshape(-1, 1, 1), draws.affine.float(), eye)
    out = projective_warp(tiled, m_aff, border=True)
    m_per = torch.where(draws.use_perspective.reshape(-1, 1, 1), draws.perspective.float(), eye)
    return torch.cat([resized, projective_warp(out, m_per, border=False)])
