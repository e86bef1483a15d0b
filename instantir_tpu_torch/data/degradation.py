"""RealESRGAN-style two-stage degradation on the device (fp32, NHWC at the boundary).

Twin of ``instantir_tpu/data/degradation.py`` (the reference's
``utils/degradation_pipeline.py:174-352`` and the basicsr device ops it
imports): USM sharpen -> blur(k1) -> random resize -> Gaussian|Poisson noise
-> JPEG -> (p=0.8) blur(k2) -> resize to gt/sf·scale -> noise -> {JPEG, sinc}
in a random order -> clamp -> paired crop -> bicubic resize back -> 1%
no-degradation -> [-1, 1].

Two chains, as in the JAX package:
  * ``traced_call`` -- the chain every trainer runs (the JAX ``jitted``
    form): random-size resizes land on static /16 canvases with a
    [0,0]-anchored valid window and a reflect fill, so the shapes depend on
    the input size alone (a later CUDA-graph recording needs nothing else);
  * ``__call__`` -- the eager fallback for inputs whose sides are not
    multiples of 16·sf: every choice comes from the numpy ``host_rng`` in the
    JAX call order, the intermediate sizes snapped to /16.

Every per-call choice (scales, modes, noise kinds and levels, JPEG
qualities, crop offsets) is drawn on the host -- from a CPU
``torch.Generator`` in the traced chain -- so the host knows each branch
without reading the device; only pixel noise is drawn on the device. Every
draw may also be given (``ChainDraws``, ``NoiseDraws``), which is how the
tests feed the JAX chain's own ``jax.random`` draws. Poisson counts cannot be
reproduced across packages: ``add_poisson_noise`` takes them as an argument.

Resizes reproduce ``jax.image.resize`` / ``scale_and_translate`` (Keys cubic
with a = -0.5, the antialiased triangle widened by 1/scale, weights
renormalised over the taps inside the image) as dense [in, out] weight
matrices applied by two matmuls; ``F.interpolate`` differs on all three
counts. Convolutions and matmuls of the chain run in full fp32
(``full_fp32``): cuDNN would otherwise round the blur's operands to TF32 on
the card only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from instantir_tpu_torch.data.kernels import KERNEL_OPT, sample_kernel_triple

DEGRADE_OPT = {
    "resize_prob": [0.2, 0.7, 0.1],
    "resize_range": [0.15, 1.5],
    "gaussian_noise_prob": 0.5,
    "noise_range": [1, 30],
    "poisson_scale_range": [0.05, 3],
    "gray_noise_prob": 0.4,
    "jpeg_range": [30, 95],
    "second_blur_prob": 0.8,
    "resize_prob2": [0.3, 0.4, 0.3],
    "resize_range2": [0.3, 1.2],
    "gaussian_noise_prob2": 0.5,
    "noise_range2": [1, 25],
    "poisson_scale_range2": [0.05, 2.5],
    "gray_noise_prob2": 0.4,
    "jpeg_range2": [30, 95],
    "gt_size": 512,
    "no_degradation_prob": 0.01,
    "use_usm": True,
    "sf": 4,
    "resize_lq": True,
}

MODES = ("area", "bilinear", "bicubic")  # the index a traced mode draw picks

# ---------------------------------------------------------------------------
# full fp32 for the chain's convolutions and matmuls
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions without TF32 and fp32 matmuls at "highest"
    precision inside the block; the caller's settings come back when it
    exits. The switches are process-wide, so the chain runs on the thread
    that runs the training steps, between two steps
    (``train.common.pipelined_batches`` stages batches on its worker thread
    and degrades them in the consumer)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Indices of ``jnp.pad(..., mode="reflect")`` along a side of ``n``: the
    reflection keeps going past a full period (``F.pad`` refuses pad >= n)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = torch.remainder(idx, period)
    return torch.where(m >= n, period - m, m)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last two dims of ``x`` by ``pad`` on each side."""
    if pad == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    return x.index_select(-2, _reflect_index(h, pad, x.device)).index_select(-1, _reflect_index(w, pad, x.device))


def filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-sample 2D filtering with reflect padding (basicsr ``filter2D``):
    one grouped convolution, ``groups = B·C``. img ``[B, H, W, C]``; kernel
    ``[B, k, k]``, the same across channels."""
    b, h, w, c = img.shape
    k = kernel.shape[-1]
    x = reflect_pad(img.permute(0, 3, 1, 2).reshape(1, b * c, h, w), k // 2)
    weight = kernel.to(x.device, x.dtype).repeat_interleave(c, dim=0).unsqueeze(1)
    with full_fp32():
        out = F.conv2d(x, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _usm_kernel(radius: int, device: torch.device) -> torch.Tensor:
    size = radius * 2 + 1
    sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8  # cv2.getGaussianKernel(sigma=0)
    return torch.from_numpy(gaussian_kernel_1d(size, sigma)).to(device)


def usm_sharp(img: torch.Tensor, weight: float = 0.5, radius: int = 50, threshold: int = 10) -> torch.Tensor:
    """Unsharp masking with a soft edge mask (basicsr ``USMSharp``): a
    separable (2·radius+1)-tap Gaussian blur, two 1-D convolutions."""
    k1 = _usm_kernel(radius, img.device)

    def blur(x):
        b, h, w, c = x.shape
        y = reflect_pad(x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w), radius)
        with full_fp32():
            y = F.conv2d(y, k1.view(1, 1, -1, 1))
            y = F.conv2d(y, k1.view(1, 1, 1, -1))
        return y.reshape(b, c, h, w).permute(0, 2, 3, 1)

    residual = img - blur(img)
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = blur(mask)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * img


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5 (``jax.image``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_METHODS = {"area": (_triangle, True), "bilinear": (_triangle, False), "bicubic": (_keys_cubic, False)}


@functools.lru_cache(maxsize=32)
def weight_matrix(in_size: int, out_size: int, inv_scale: float, mode: str, device: torch.device) -> torch.Tensor:
    """fp32 ``[in_size, out_size]`` resampling weights: the algorithm of
    ``jax._src.image.scale.compute_weight_mat`` with translation 0.
    ``inv_scale`` is the fp32 value of 1/scale (exact as a Python float)."""
    kernel, antialias = _METHODS[mode]
    f32 = torch.float32
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def apply_weights(img: torch.Tensor, wh: Optional[torch.Tensor], ww: Optional[torch.Tensor]) -> torch.Tensor:
    """``img`` [B, H, W, C] resampled along H by ``wh`` [H, H'] and along W by ``ww`` [W, W'] (None: kept)."""
    with full_fp32():
        if wh is not None:
            img = torch.einsum("bhwc,hk->bkwc", img, wh)
        if ww is not None:
            img = torch.einsum("bhwc,wk->bhkc", img, ww)
    return img


def _inv_scale_eager(out_size: int, in_size: int) -> float:
    """``jax.image.resize``'s 1/scale: (out/in) and its inverse in double, then fp32."""
    return float(np.float32(1.0 / (out_size / in_size)))


def _inv_scale_traced(out_valid: int, in_valid: int) -> float:
    """``scale_and_translate``'s 1/scale with traced fp32 sizes: every step in fp32."""
    return float(np.float32(1.0) / (np.float32(out_valid) / np.float32(in_valid)))


def resize(img: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    """area | bilinear | bicubic resize, NHWC (``jax.image.resize``: a side
    whose size does not change is left as it is)."""
    _, h, w, _ = img.shape
    wh = None if size[0] == h else weight_matrix(h, size[0], _inv_scale_eager(size[0], h), str(mode), img.device)
    ww = None if size[1] == w else weight_matrix(w, size[1], _inv_scale_eager(size[1], w), str(mode), img.device)
    return apply_weights(img, wh, ww)


def reflect_fill(img: torch.Tensor, vh: int, vw: int) -> torch.Tensor:
    """Fill the canvas beyond the [0,0]-anchored valid (vh, vw) window with
    the valid region's reflection (np.pad 'reflect' indexing, clamped once
    past a full period)."""
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    row = torch.clamp(vh - 1 - (vh - 1 - torch.arange(h, device=dev)).abs(), 0, vh - 1)
    col = torch.clamp(vw - 1 - (vw - 1 - torch.arange(w, device=dev)).abs(), 0, vw - 1)
    return img.index_select(1, row).index_select(2, col)


def resize_valid(img: torch.Tensor, in_valid: Tuple[int, int], canvas: Tuple[int, int],
                 out_valid: Tuple[int, int], mode: str) -> torch.Tensor:
    """Resize the [0,0]-anchored valid region of ``img`` onto a static
    ``canvas``, the valid size becoming ``out_valid``
    (``jax.image.scale_and_translate`` with translation 0: output pixel
    centres sampled at (j+0.5)/scale over the whole input canvas), then
    ``reflect_fill`` beyond the new valid window."""
    _, h, w, _ = img.shape
    wh = weight_matrix(h, canvas[0], _inv_scale_traced(out_valid[0], in_valid[0]), mode, img.device)
    ww = weight_matrix(w, canvas[1], _inv_scale_traced(out_valid[1], in_valid[1]), mode, img.device)
    return reflect_fill(apply_weights(img, wh, ww), int(out_valid[0]), int(out_valid[1]))


@dataclasses.dataclass
class NoiseDraws:
    """Pixel draws of one noise stage, any of which may be given (else drawn
    on the image's device): ``normal`` (the image's shape) and
    ``gray_normal`` ``[B, H, W, 1]`` standard normals for Gaussian noise;
    ``counts`` and ``gray_counts`` Poisson counts of the same shapes."""

    normal: Any = None
    gray_normal: Any = None
    counts: Any = None
    gray_counts: Any = None


def _draw_device(generator: Optional[torch.Generator], device: torch.device) -> torch.device:
    """Where a draw from ``generator`` is made: on its own device (a CPU
    generator gives the same numbers for an image on any device), else on ``device``."""
    return generator.device if generator is not None else device


def _given(x, device) -> Optional[torch.Tensor]:
    """A given draw as an fp32 tensor on ``device`` (None stays None)."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def add_gaussian_noise(img: torch.Tensor, sigma: torch.Tensor, gray_mask: torch.Tensor,
                       normal=None, gray_normal=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """sigma ``[B]`` on the 0-255 scale; gray_mask ``[B]`` in {0, 1}: gray
    noise is shared across channels (basicsr ``random_add_gaussian_noise_pt``)."""
    b, h, w, _ = img.shape
    dev = img.device
    normal = _given(normal, dev)
    gray_normal = _given(gray_normal, dev)
    where = _draw_device(generator, dev)
    if normal is None:
        normal = torch.randn(img.shape, generator=generator, dtype=torch.float32, device=where).to(dev)
    if gray_normal is None:
        gray_normal = torch.randn((b, h, w, 1), generator=generator, dtype=torch.float32, device=where).to(dev)
    s = sigma.reshape(-1, 1, 1, 1)
    noise = normal * s / 255.0
    gray = gray_normal * s / 255.0
    noise = torch.where(gray_mask.reshape(-1, 1, 1, 1) > 0, gray.expand(img.shape), noise)
    return torch.clamp(img + noise, 0.0, 1.0)


def add_poisson_noise(img: torch.Tensor, scale: torch.Tensor, gray_mask: torch.Tensor, counts=None,
                      gray_counts=None, generator: Optional[torch.Generator] = None, vals: float = 256.0) -> torch.Tensor:
    """Per-sample scaled Poisson (shot) noise at ``vals`` levels; scale ``[B]``,
    gray_mask ``[B]``. ``counts`` / ``gray_counts`` are the Poisson draws of
    rate ``clip(x, 0, 1)·vals`` for the image and its channel mean, drawn with
    ``torch.poisson`` when not given."""
    dev = img.device
    gray_img = img.mean(dim=-1, keepdim=True)

    def shot(c, x):
        lam = torch.clamp(x, 0.0, 1.0) * vals
        c = _given(c, dev)
        if c is None:
            c = torch.poisson(lam.to(_draw_device(generator, dev)), generator=generator).to(dev)
        return c / vals - x

    noise = shot(counts, img)
    gray = shot(gray_counts, gray_img).expand(img.shape)
    noise = torch.where(gray_mask.reshape(-1, 1, 1, 1) > 0, gray, noise)
    return torch.clamp(img + noise * scale.reshape(-1, 1, 1, 1), 0.0, 1.0)


# --------------------------- DiffJPEG (DCT-based) ---------------------------

_Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_C_TABLE = np.full((8, 8), 99, dtype=np.float32)
_C_TABLE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]


def _dct_matrix() -> np.ndarray:
    m = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            m[k, n] = np.cos((2 * n + 1) * k * np.pi / 16) * (np.sqrt(0.125) if k == 0 else 0.5)
    return m


_DCT = _dct_matrix()


@functools.lru_cache(maxsize=8)
def _jpeg_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(a).to(device) for a in (_DCT, _Y_TABLE, _C_TABLE))


def quality_factor(quality: torch.Tensor) -> torch.Tensor:
    """JPEG quality (1-100) -> quantization scale factor."""
    return torch.where(quality < 50, 5000.0 / torch.clamp(quality, min=1.0), 200.0 - quality * 2.0) / 100.0


def _channel_jpeg(x: torch.Tensor, dct: torch.Tensor, table: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """One channel ``[B, H, W]`` (0..255) through the 8×8 DCT, quantisation and back; factor ``[B]``."""
    b, h, w = x.shape
    blocks = (x - 128.0).reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)  # [B, hb, wb, 8, 8]
    with full_fp32():
        coefs = torch.matmul(torch.matmul(dct, blocks), dct.t())
        q = torch.clamp(torch.round(table * factor.reshape(-1, 1, 1, 1, 1)), 1.0, 255.0)
        coefs = torch.round(coefs / q) * q
        blocks = torch.matmul(torch.matmul(dct.t(), coefs), dct)
    return blocks.permute(0, 1, 3, 2, 4).reshape(b, h, w) + 128.0


def jpeg_compress(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """DCT-domain JPEG round trip with 4:2:0 chroma subsampling. img ``[B,
    H, W, 3]`` in [0, 1] (H, W multiples of 16); quality ``[B]``."""
    dct, y_table, c_table = _jpeg_constants(img.device)
    x = img * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    factor = quality_factor(quality)
    bsz, h, w = y.shape
    cb_s = cb.reshape(bsz, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    cr_s = cr.reshape(bsz, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    y = _channel_jpeg(y, dct, y_table, factor)
    cb_s = _channel_jpeg(cb_s, dct, c_table, factor)
    cr_s = _channel_jpeg(cr_s, dct, c_table, factor)

    cb = cb_s.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    cr = cr_s.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b2 = y + 1.772 * cb
    out = torch.stack([r, g, b2], dim=-1) / 255.0
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _snap(v: int, multiple: int = 16) -> int:
    """Bucket a size to a multiple of 16 (JPEG blocks, a bounded set of shapes)."""
    return max(multiple, int(round(v / multiple)) * multiple)


def _snap_up(v: int, multiple: int = 16) -> int:
    return max(multiple, int(-(-v // multiple)) * multiple)


@dataclasses.dataclass
class ChainDraws:
    """The per-call choices of ``traced_call``, host values (the draws of the
    JAX chain's ``jax.random.split(key, 24)``, ``degradation.py:376-457``):
    ``u`` the 16 choice uniforms (``u[0]``..``u[6]`` read); ``up1`` /
    ``down1`` the uniforms of the stage-1 up and down scales, ``mode1`` the
    resize mode index into ``MODES``; ``sigma1`` / ``pscale1`` ``[B]`` the
    Gaussian sigmas and Poisson scales, ``gray1`` ``[B]`` the gray-noise mask
    (0/1), ``q1`` ``[B]`` the JPEG qualities; the same for stage 2; ``mode3``
    the final resize's mode; ``top`` / ``left`` the lq crop offsets; and the
    pixel draws of the two noise stages (``noise1``, ``noise2``)."""

    u: Sequence[float]
    up1: float
    down1: float
    mode1: int
    sigma1: Any
    pscale1: Any
    gray1: Any
    q1: Any
    up2: float
    down2: float
    mode2: int
    sigma2: Any
    pscale2: Any
    gray2: Any
    q2: Any
    mode3: int
    top: int
    left: int
    noise1: NoiseDraws = dataclasses.field(default_factory=NoiseDraws)
    noise2: NoiseDraws = dataclasses.field(default_factory=NoiseDraws)


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclasses.dataclass
class RealESRGANDegradation:
    """Callable degradation: (gt ``[B, H, W, 3]`` in [0, 1], kernels) ->
    (lq, gt), both in [-1, 1] at ``gt_size`` (the reference's ``__call__``)."""

    kernel_opt: dict = dataclasses.field(default_factory=lambda: dict(KERNEL_OPT))
    degrade_opt: dict = dataclasses.field(default_factory=lambda: dict(DEGRADE_OPT))
    resolution: Optional[int] = None

    def __post_init__(self):
        if self.resolution is not None:
            self.degrade_opt = dict(self.degrade_opt, gt_size=self.resolution)

    def canvases(self, ori_h: int, ori_w: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """The traced chain's static canvases (stage 1, stage 2) for an ``ori_h × ori_w`` input."""
        opt, sf = self.degrade_opt, self.degrade_opt["sf"]
        r1, r2 = opt["resize_range"][1], opt["resize_range2"][1]
        return ((_snap_up(int(ori_h * r1)), _snap_up(int(ori_w * r1))),
                (_snap_up(int(ori_h / sf * r2)), _snap_up(int(ori_w / sf * r2))))

    def draw_choices(self, batch: int, final: Tuple[int, int], generator: Optional[torch.Generator]) -> ChainDraws:
        """Every per-call choice of ``traced_call`` from a CPU ``generator``
        (the ranges of the JAX draws; the values are the port's own)."""
        opt = self.degrade_opt
        lq_size = opt["gt_size"] // opt["sf"]

        def rand(n=()):
            return torch.rand(n, generator=generator, dtype=torch.float32).numpy()

        def between(lo, hi, n):
            return np.maximum(rand((n,)) * _f32(hi - lo) + _f32(lo), _f32(lo)).astype(np.float32)

        def randint(hi):
            return int(torch.randint(0, hi, (), generator=generator))

        u = rand((16,))
        up1, down1, mode1 = float(rand()), float(rand()), randint(3)
        sigma1 = between(*opt["noise_range"], batch)
        pscale1 = between(*opt["poisson_scale_range"], batch)
        gray1 = (rand((batch,)) < opt["gray_noise_prob"]).astype(np.float32)
        q1 = between(*opt["jpeg_range"], batch)
        up2, down2, mode2 = float(rand()), float(rand()), randint(3)
        sigma2 = between(*opt["noise_range2"], batch)
        pscale2 = between(*opt["poisson_scale_range2"], batch)
        gray2 = (rand((batch,)) < opt["gray_noise_prob2"]).astype(np.float32)
        q2 = between(*opt["jpeg_range2"], batch)
        mode3 = randint(3)
        top, left = randint(final[0] - lq_size + 1), randint(final[1] - lq_size + 1)
        return ChainDraws(u=[float(x) for x in u], up1=up1, down1=down1, mode1=mode1, sigma1=sigma1, pscale1=pscale1,
                          gray1=gray1, q1=q1, up2=up2, down2=down2, mode2=mode2, sigma2=sigma2, pscale2=pscale2,
                          gray2=gray2, q2=q2, mode3=mode3, top=top, left=left)

    @staticmethod
    def _per_sample(device: torch.device, *arrays) -> Tuple[torch.Tensor, ...]:
        """The per-sample host values as fp32 device tensors: one upload of
        one (pinned, on a card) buffer, with no wait for the device."""
        stacked = torch.from_numpy(np.stack([np.asarray(a, np.float32).reshape(-1) for a in arrays]))
        if device.type == "cuda":
            stacked = stacked.pin_memory().to(device, non_blocking=True)
        else:
            stacked = stacked.to(device)
        return tuple(stacked.unbind(0))

    def _noise(self, out, gaussian: bool, sigma, pscale, gray, draws: NoiseDraws, generator):
        if gaussian:
            return add_gaussian_noise(out, sigma, gray, draws.normal, draws.gray_normal, generator)
        return add_poisson_noise(out, pscale, gray, draws.counts, draws.gray_counts, generator)

    def traced_call(self, img_gt: torch.Tensor, kernels, draws: Optional[ChainDraws] = None,
                    generator: Optional[torch.Generator] = None,
                    device_generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chain on static /16 canvases (the JAX ``traced_call``): needs H,
        W multiples of 16·sf. The choices come from ``draws``, else from the
        CPU ``generator``; the pixel noise from ``device_generator`` (drawn on
        that generator's device and moved to the image's)."""
        opt = self.degrade_opt
        kernel1, kernel2, sinc_kernel = kernels
        im_gt = img_gt.float()
        b, ori_h, ori_w, _ = im_gt.shape
        sf = opt["sf"]
        gt_size = opt["gt_size"]
        lq_size = gt_size // sf
        if ori_h % (16 * sf) or ori_w % (16 * sf):
            raise ValueError(f"traced degradation needs H,W multiples of {16 * sf}, got {ori_h}x{ori_w}")
        final = (ori_h // sf, ori_w // sf)
        d = draws if draws is not None else self.draw_choices(b, final, generator)
        dev = im_gt.device
        u = [_f32(x) for x in d.u]
        sigma1, pscale1, gray1, q1, sigma2, pscale2, gray2, q2 = self._per_sample(
            dev, d.sigma1, d.pscale1, d.gray1, d.q1, d.sigma2, d.pscale2, d.gray2, d.q2)

        if opt["use_usm"]:
            im_gt = usm_sharp(im_gt)

        # ---- stage 1: blur -> random resize -> noise -> JPEG ----
        out = filter2d(im_gt, kernel1)
        p = np.asarray(opt["resize_prob"]) / np.sum(opt["resize_prob"])
        s_up = _f32(1.0) + _f32(d.up1) * _f32(opt["resize_range"][1] - 1.0)
        s_down = _f32(opt["resize_range"][0]) + _f32(d.down1) * _f32(1.0 - opt["resize_range"][0])
        scale1 = s_up if u[0] < _f32(p[0]) else (s_down if u[0] < _f32(p[0] + p[1]) else _f32(1.0))
        canvas1, canvas2 = self.canvases(ori_h, ori_w)
        v1 = tuple(int(np.round(_f32(s) * scale1)) for s in (ori_h, ori_w))
        out = resize_valid(out, (ori_h, ori_w), canvas1, v1, MODES[d.mode1])
        out = self._noise(out, u[1] < _f32(opt["gaussian_noise_prob"]), sigma1, pscale1, gray1, d.noise1,
                          device_generator)
        out = jpeg_compress(torch.clamp(out, 0.0, 1.0), q1)

        # ---- stage 2: (p) blur -> random resize -> noise -> {JPEG, sinc} ----
        if u[2] < _f32(opt["second_blur_prob"]):
            out = filter2d(out, kernel2)
        p2 = np.asarray(opt["resize_prob2"]) / np.sum(opt["resize_prob2"])
        s_up2 = _f32(1.0) + _f32(d.up2) * _f32(opt["resize_range2"][1] - 1.0)
        s_down2 = _f32(opt["resize_range2"][0]) + _f32(d.down2) * _f32(1.0 - opt["resize_range2"][0])
        scale2 = s_up2 if u[3] < _f32(p2[0]) else (s_down2 if u[3] < _f32(p2[0] + p2[1]) else _f32(1.0))
        v2 = tuple(int(np.round(_f32(s / sf) * scale2)) for s in (ori_h, ori_w))
        out = resize_valid(out, v1, canvas2, v2, MODES[d.mode2])
        out = self._noise(out, u[4] < _f32(opt["gaussian_noise_prob2"]), sigma2, pscale2, gray2, d.noise2,
                          device_generator)

        if u[5] < _f32(0.5):  # resize back + sinc, then JPEG
            out = resize_valid(out, v2, final, final, MODES[d.mode3])
            out = filter2d(out, sinc_kernel)
            out = jpeg_compress(torch.clamp(out, 0.0, 1.0), q2)
        else:  # JPEG, then resize back + sinc
            out = jpeg_compress(torch.clamp(out, 0.0, 1.0), q2)
            out = resize_valid(out, v2, final, final, MODES[d.mode3])
            out = filter2d(out, sinc_kernel)
        im_lq = torch.clamp(out, 0.0, 1.0)

        # ---- paired random crop + resize back ----
        top, left = d.top, d.left
        im_lq = im_lq[:, top:top + lq_size, left:left + lq_size]
        im_gt = im_gt[:, top * sf:top * sf + gt_size, left * sf:left * sf + gt_size]
        return self._finish(im_lq, im_gt, u[6] < _f32(opt["no_degradation_prob"]))

    def _finish(self, im_lq: torch.Tensor, im_gt: torch.Tensor, no_degradation: bool):
        opt = self.degrade_opt
        gt_size = opt["gt_size"]
        if opt["resize_lq"]:
            im_lq = resize(im_lq, (gt_size, gt_size), "bicubic")
        if no_degradation:
            im_lq = im_gt
        im_lq = torch.where(torch.isnan(im_lq).any(), im_gt, im_lq)  # no host read: the test stays on the device
        im_lq = torch.clamp(im_lq * 2.0 - 1.0, -1.0, 1.0)
        im_gt = torch.clamp(im_gt * 2.0 - 1.0, -1.0, 1.0)
        return im_lq.contiguous(), im_gt.contiguous()

    def sample_kernels(self, rng: np.random.Generator, batch: int, device=None):
        """``batch`` kernel triples from ``rng`` as three ``[B, 21, 21]`` tensors."""
        triples = [sample_kernel_triple(rng, self.kernel_opt) for _ in range(batch)]
        return tuple(torch.from_numpy(np.stack([t[i] for t in triples])).to(device) for i in range(3))

    def __call__(self, img_gt: torch.Tensor, kernels=None, host_rng: Optional[np.random.Generator] = None,
                 noise1: Optional[NoiseDraws] = None, noise2: Optional[NoiseDraws] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eager chain: every choice from the numpy ``host_rng`` in the
        JAX call order (``degradation.py:478-582``), intermediate sizes
        snapped to /16; pixel noise from ``noise1`` / ``noise2`` or drawn
        from the device ``generator``. Without ``host_rng`` one is seeded
        from ``generator``."""
        opt = self.degrade_opt
        dev = img_gt.device
        noise1, noise2 = noise1 or NoiseDraws(), noise2 or NoiseDraws()
        if host_rng is None:
            host_rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                                               device=_draw_device(generator, dev))))
        if kernels is None:
            kernels = self.sample_kernels(host_rng, img_gt.shape[0], dev)
        kernel1, kernel2, sinc_kernel = kernels

        def per_sample(x):
            return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

        im_gt = img_gt.float()
        if opt["use_usm"]:
            im_gt = usm_sharp(im_gt)
        b, ori_h, ori_w, _ = im_gt.shape
        sf = opt["sf"]

        # ---- stage 1 ----
        out = filter2d(im_gt, kernel1)
        updown = host_rng.choice(["up", "down", "keep"], p=np.asarray(opt["resize_prob"]) / np.sum(opt["resize_prob"]))
        scale = (
            host_rng.uniform(1, opt["resize_range"][1])
            if updown == "up"
            else host_rng.uniform(opt["resize_range"][0], 1)
            if updown == "down"
            else 1.0
        )
        mode = host_rng.choice(list(MODES))
        out = resize(out, (_snap(int(ori_h * scale)), _snap(int(ori_w * scale))), mode)

        if host_rng.random() < opt["gaussian_noise_prob"]:
            sigma = per_sample(host_rng.uniform(*opt["noise_range"], size=(b,)))
            gray = per_sample(host_rng.random(b) < opt["gray_noise_prob"])
            out = add_gaussian_noise(out, sigma, gray, noise1.normal, noise1.gray_normal, generator)
        else:
            pscale = per_sample(host_rng.uniform(*opt["poisson_scale_range"], size=(b,)))
            gray = per_sample(host_rng.random(b) < opt["gray_noise_prob"])
            out = add_poisson_noise(out, pscale, gray, noise1.counts, noise1.gray_counts, generator)

        quality = per_sample(host_rng.uniform(*opt["jpeg_range"], size=(b,)))
        out = jpeg_compress(torch.clamp(out, 0.0, 1.0), quality)

        # ---- stage 2 ----
        if host_rng.random() < opt["second_blur_prob"]:
            out = filter2d(out, kernel2)
        updown = host_rng.choice(
            ["up", "down", "keep"], p=np.asarray(opt["resize_prob2"]) / np.sum(opt["resize_prob2"])
        )
        scale = (
            host_rng.uniform(1, opt["resize_range2"][1])
            if updown == "up"
            else host_rng.uniform(opt["resize_range2"][0], 1)
            if updown == "down"
            else 1.0
        )
        mode = host_rng.choice(list(MODES))
        out = resize(out, (_snap(int(ori_h / sf * scale)), _snap(int(ori_w / sf * scale))), mode)

        if host_rng.random() < opt["gaussian_noise_prob2"]:
            sigma = per_sample(host_rng.uniform(*opt["noise_range2"], size=(b,)))
            gray = per_sample(host_rng.random(b) < opt["gray_noise_prob2"])
            out = add_gaussian_noise(out, sigma, gray, noise2.normal, noise2.gray_normal, generator)
        else:
            pscale = per_sample(host_rng.uniform(*opt["poisson_scale_range2"], size=(b,)))
            gray = per_sample(host_rng.random(b) < opt["gray_noise_prob2"])
            out = add_poisson_noise(out, pscale, gray, noise2.counts, noise2.gray_counts, generator)

        final_size = (ori_h // sf, ori_w // sf)
        quality = per_sample(host_rng.uniform(*opt["jpeg_range2"], size=(b,)))
        mode = host_rng.choice(list(MODES))
        if host_rng.random() < 0.5:  # resize back + sinc, then JPEG
            out = resize(out, final_size, mode)
            out = filter2d(out, sinc_kernel)
            out = jpeg_compress(torch.clamp(out, 0.0, 1.0), quality)
        else:  # JPEG, then resize back + sinc
            out = jpeg_compress(torch.clamp(out, 0.0, 1.0), quality)
            out = resize(out, final_size, mode)
            out = filter2d(out, sinc_kernel)
        im_lq = torch.clamp(out, 0.0, 1.0)

        # ---- paired random crop (gt at gt_size, lq aligned at gt_size/sf) ----
        gt_size = opt["gt_size"]
        lq_size = gt_size // sf
        if im_lq.shape[1] < lq_size or im_lq.shape[2] < lq_size:
            raise ValueError(f"degradation: the {tuple(im_lq.shape[1:3])} lq image is smaller than its "
                             f"{lq_size}² crop (inputs below gt_size {gt_size})")
        top_lq = int(host_rng.integers(0, max(im_lq.shape[1] - lq_size, 0) + 1))
        left_lq = int(host_rng.integers(0, max(im_lq.shape[2] - lq_size, 0) + 1))
        im_lq = im_lq[:, top_lq:top_lq + lq_size, left_lq:left_lq + lq_size]
        im_gt = im_gt[:, top_lq * sf:top_lq * sf + gt_size, left_lq * sf:left_lq * sf + gt_size]
        return self._finish(im_lq, im_gt, host_rng.random() < opt["no_degradation_prob"])
