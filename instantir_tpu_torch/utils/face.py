"""Face alignment: the similarity transform from 5-point landmarks to the
ArcFace template, and a differentiable warp-crop.

Twin of ``instantir_tpu/utils/face.py`` (reference ``utils/utils.py`` and
``utils/matlab_cp2tform.py``). ``similarity_transform`` is the port's own
numpy copy (the cp2tform least-squares solve); ``warp_affine`` samples
bilinearly with JAX's convention (pixel centres at integer coordinates, the
inverse map from the output grid, zero outside the source), not
``grid_sample``'s defaults. Landmark detection is injected
(``utils/mtcnn.py`` provides the cascade).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# canonical 5-point template, relative coordinates (reference utils/utils.py:9)
REFERENCE_FACIAL_POINTS_RELATIVE = np.array(
    [
        [38.29459953, 51.69630051],
        [73.53179932, 51.50139999],
        [56.02519989, 71.73660278],
        [41.54930115, 92.3655014],
        [70.72990036, 92.20410156],
    ]
) / 112.0


def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (rotation + scale + translation) mapping
    src [N, 2] -> dst [N, 2]; a 2×3 affine matrix (cp2tform semantics)."""
    n = src.shape[0]
    # solve for [a, b, tx, ty] with x' = a·x − b·y + tx ; y' = b·x + a·y + ty
    A = np.zeros((2 * n, 4))
    b = np.zeros(2 * n)
    A[0::2, 0] = src[:, 0]
    A[0::2, 1] = -src[:, 1]
    A[0::2, 2] = 1
    A[1::2, 0] = src[:, 1]
    A[1::2, 1] = src[:, 0]
    A[1::2, 3] = 1
    b[0::2] = dst[:, 0]
    b[1::2] = dst[:, 1]
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    a, bb, tx, ty = sol
    return np.array([[a, -bb, tx], [bb, a, ty]])


def warp_affine(image: torch.Tensor, matrix: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """Differentiable inverse warp of one [H, W, C] image by a 2×3 fp32
    input->output ``matrix``: each output pixel samples the input at the
    inverse map of its coordinates, bilinearly, zero outside -> [oh, ow, C]."""
    oh, ow = out_size
    dev = image.device
    m = torch.cat([matrix.float(), torch.tensor([[0.0, 0.0, 1.0]], device=dev)])
    minv = torch.linalg.inv(m)[:2]
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    src = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1) @ minv.T  # [oh, ow, 2] (x, y)
    sx, sy = src[..., 0], src[..., 1]

    h, w, _ = image.shape
    x0 = torch.clamp(torch.floor(sx), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]

    def gather(yy, xx):
        return image[yy.long(), xx.long()]

    out = (gather(y0, x0) * (1 - wy) * (1 - wx) + gather(y0, x1) * (1 - wy) * wx
           + gather(y1, x0) * wy * (1 - wx) + gather(y1, x1) * wy * wx)
    valid = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1))[..., None]
    return out * valid


def extract_faces_and_landmarks(images: torch.Tensor, landmarks: np.ndarray, output_size: int = 112) -> torch.Tensor:
    """Crop-align faces to the ArcFace template, differentiably with respect
    to the pixels: images [B, H, W, C], landmarks [B, 5, 2] in pixels ->
    [B, output_size, output_size, C]."""
    template = REFERENCE_FACIAL_POINTS_RELATIVE * output_size
    out = []
    for i in range(images.shape[0]):
        m = similarity_transform(np.asarray(landmarks[i], np.float64), template)
        m = torch.as_tensor(m.astype(np.float32), device=images.device)
        out.append(warp_affine(images[i], m, (output_size, output_size)))
    return torch.stack(out)
