"""Host-side blur-kernel synthesis for the RealESRGAN degradation.

Twin of ``instantir_tpu/data/kernels.py``, kept as the port's own copy (numpy
and ``scipy.special.j1``): isotropic / anisotropic Gaussian, generalized
Gaussian, plateau and circular-sinc low-pass kernels, the families the
reference draws from basicsr (``utils/degradation_pipeline.py:8,111-172``).
The kernels are drawn on the host in the data loader and shipped with the
batch (``utils/train_utils.py:128-170``); only their application
(``data/degradation.py::filter2d``) runs on the device. The same
``np.random.Generator`` state gives bitwise the JAX module's arrays.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.special import j1

KERNEL_RANGE = [2 * v + 1 for v in range(3, 11)]  # 7..21

KERNEL_OPT = {
    "blur_kernel_size": 21,
    "kernel_list": ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso", "plateau_aniso"],
    "kernel_prob": [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    "sinc_prob": 0.1,
    "blur_sigma": [0.2, 3],
    "betag_range": [0.5, 4],
    "betap_range": [1, 2],
    "blur_kernel_size2": 21,
    "kernel_list2": ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso", "plateau_aniso"],
    "kernel_prob2": [0.45, 0.25, 0.12, 0.03, 0.12, 0.03],
    "sinc_prob2": 0.1,
    "blur_sigma2": [0.2, 1.5],
    "betag_range2": [0.5, 4],
    "betap_range2": [1, 2],
    "final_sinc_prob": 0.8,
}


def _mesh(kernel_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)  # [k, k, 2]
    return xx, yy, xy


def sigma_matrix2(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def _quadratic_form(xy: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    inv = np.linalg.inv(sigma)
    return np.einsum("hwc,cd,hwd->hw", xy, inv, xy)


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float = None, theta: float = 0.0, isotropic=True):
    _, _, xy = _mesh(kernel_size)
    sigma = sigma_matrix2(sig_x, sig_x if isotropic else sig_y, 0.0 if isotropic else theta)
    kernel = np.exp(-0.5 * _quadratic_form(xy, sigma))
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0, isotropic=True):
    _, _, xy = _mesh(kernel_size)
    sigma = sigma_matrix2(sig_x, sig_x if isotropic else sig_y, 0.0 if isotropic else theta)
    kernel = np.exp(-0.5 * np.power(_quadratic_form(xy, sigma), beta))
    return kernel / kernel.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y=None, theta=0.0, beta=1.0, isotropic=True):
    _, _, xy = _mesh(kernel_size)
    sigma = sigma_matrix2(sig_x, sig_x if isotropic else sig_y, 0.0 if isotropic else theta)
    kernel = 1.0 / (np.power(_quadratic_form(xy, sigma), beta) + 1)
    return kernel / kernel.sum()


def circular_lowpass_kernel(omega_c: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2D circular (sinc) low-pass filter; kernel_size must be odd."""
    assert kernel_size % 2 == 1
    with np.errstate(divide="ignore", invalid="ignore"):
        xx, yy, _ = _mesh(kernel_size)
        r = np.sqrt(xx**2 + yy**2)
        kernel = omega_c * j1(omega_c * r) / (2 * np.pi * r)
        kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = omega_c**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


def random_mixed_kernel(
    rng: np.random.Generator,
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int,
    sigma_range: Sequence[float],
    rotation_range: Sequence[float] = (-math.pi, math.pi),
    betag_range: Sequence[float] = (0.5, 4),
    betap_range: Sequence[float] = (1, 2),
) -> np.ndarray:
    kind = rng.choice(kernel_list, p=np.asarray(kernel_prob) / np.sum(kernel_prob))
    sig_x = rng.uniform(*sigma_range)
    sig_y = rng.uniform(*sigma_range)
    theta = rng.uniform(*rotation_range)
    if kind == "iso":
        return bivariate_gaussian(kernel_size, sig_x, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian(kernel_size, sig_x, sig_y, theta, isotropic=False)
    if kind == "generalized_iso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sig_x, beta=beta, isotropic=True)
    if kind == "generalized_aniso":
        beta = rng.uniform(*betag_range)
        return bivariate_generalized_gaussian(kernel_size, sig_x, sig_y, theta, beta, isotropic=False)
    if kind == "plateau_iso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sig_x, beta=beta, isotropic=True)
    if kind == "plateau_aniso":
        beta = rng.uniform(*betap_range)
        return bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, isotropic=False)
    raise ValueError(f"unknown kernel kind {kind}")


def pulse_kernel(size: int = 21) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    k[size // 2, size // 2] = 1.0
    return k


def sample_kernel_triple(
    rng: np.random.Generator, opt: Optional[dict] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(kernel, kernel2, sinc_kernel), each padded to 21×21 — reference
    ``get_kernel`` (``utils/degradation_pipeline.py:111-172``)."""
    opt = opt or KERNEL_OPT

    def first_or_second(suffix: str):
        kernel_size = int(rng.choice(KERNEL_RANGE))
        if rng.uniform() < opt[f"sinc_prob{suffix}"]:
            omega_c = rng.uniform(np.pi / 3 if kernel_size < 13 else np.pi / 5, np.pi)
            kernel = circular_lowpass_kernel(omega_c, kernel_size, pad_to=0)
        else:
            kernel = random_mixed_kernel(
                rng,
                opt[f"kernel_list{suffix}"],
                opt[f"kernel_prob{suffix}"],
                kernel_size,
                opt[f"blur_sigma{suffix}"],
                (-math.pi, math.pi),
                opt[f"betag_range{suffix}"],
                opt[f"betap_range{suffix}"],
            )
        pad = (21 - kernel_size) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    kernel = first_or_second("")
    kernel2 = first_or_second("2")
    if rng.uniform() < opt["final_sinc_prob"]:
        kernel_size = int(rng.choice(KERNEL_RANGE))
        omega_c = rng.uniform(np.pi / 3, np.pi)
        sinc = circular_lowpass_kernel(omega_c, kernel_size, pad_to=21).astype(np.float32)
    else:
        sinc = pulse_kernel(21)
    return kernel, kernel2, sinc
