"""Diffusion numerics as plain functions over precomputed fp32 schedule tables.

Twin of ``instantir_tpu/schedulers/diffusion.py``. Every routine takes
*batched per-sample timesteps* (a ``[B]`` integer tensor, or a scalar) and works
on tensors of any layout ``[B, ...]``; table math is fp32. Timestep sequences
are static metadata built on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

TimestepLike = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed fp32 diffusion tables. ``alphas_cumprod`` has shape
    [num_train_timesteps]; ``final_alpha_cumprod`` is the alpha-bar used when a
    "previous step" falls off the start of the table."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: float
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(self, betas=self.betas.to(device), alphas_cumprod=self.alphas_cumprod.to(device))


def betas_for_alpha_bar(num_diffusion_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Glide squaredcos_cap_v2 beta schedule (cosine alpha-bar), float64."""

    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    t = np.arange(num_diffusion_timesteps, dtype=np.float64)
    betas = 1 - alpha_bar((t + 1) / num_diffusion_timesteps) / alpha_bar(t / num_diffusion_timesteps)
    return np.minimum(betas, max_beta)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal step has zero SNR (arXiv 2305.08891 §3):
    shift sqrt(alpha-bar) so the last is zero, scale it so the first is kept."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    first, last = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar = ((alphas_bar_sqrt - last) * first / (first - last)) ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    trained_betas: Optional[np.ndarray] = None,
    rescale_betas_zero_snr: bool = False,
    set_alpha_to_one: bool = True,
    prediction_type: str = "epsilon",
    timestep_scaling: float = 10.0,
    device=None,
) -> DiffusionSchedule:
    """Build the fp32 schedule tables (float64 numpy on the host, then fp32)."""
    if trained_betas is not None:
        betas = np.asarray(trained_betas, dtype=np.float64)
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        betas = betas_for_alpha_bar(num_train_timesteps)
    else:
        raise NotImplementedError(f"unknown beta_schedule: {beta_schedule}")
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final_alpha = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return DiffusionSchedule(
        betas=torch.tensor(betas, dtype=torch.float32, device=device),
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32, device=device),
        final_alpha_cumprod=float(np.float32(final_alpha)),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
        timestep_scaling=timestep_scaling,
    )


def sdxl_schedule(device=None, **overrides) -> DiffusionSchedule:
    """The SDXL-base DDPM schedule (scaled_linear 0.00085 -> 0.012, T=1000)."""
    kwargs = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear")
    kwargs.update(overrides)
    return make_schedule(device=device, **kwargs)


def _expand(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append singleton dims so a [B] vector broadcasts against a [B, ...] tensor."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def _timesteps(t: TimestepLike, table: torch.Tensor) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(t, device=table.device)).long()


def _gather_bar(schedule: DiffusionSchedule, t: TimestepLike, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt(alpha_bar_t), sqrt(1 - alpha_bar_t), broadcast to ndim dims, fp32."""
    abar = schedule.alphas_cumprod[_timesteps(t, schedule.alphas_cumprod)]
    return _expand(torch.sqrt(abar), ndim), _expand(torch.sqrt(1.0 - abar), ndim)


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    """x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    sa, sb = _gather_bar(schedule, t, x0.ndim)
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)


def get_velocity(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    """v = sqrt(abar_t) eps - sqrt(1 - abar_t) x0."""
    sa, sb = _gather_bar(schedule, t, x0.ndim)
    return (sa * noise.float() - sb * x0.float()).to(x0.dtype)


def pred_x0_from_eps(schedule: DiffusionSchedule, sample: torch.Tensor, eps: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    sa, sb = _gather_bar(schedule, t, sample.ndim)
    return ((sample.float() - sb * eps.float()) / sa).to(sample.dtype)


def pred_eps_from_x0(schedule: DiffusionSchedule, sample: torch.Tensor, x0: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    sa, sb = _gather_bar(schedule, t, sample.ndim)
    return ((sample.float() - sa * x0.float()) / sb).to(sample.dtype)


def pred_x0_from_v(schedule: DiffusionSchedule, sample: torch.Tensor, v: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    sa, sb = _gather_bar(schedule, t, sample.ndim)
    return (sa * sample.float() - sb * v.float()).to(sample.dtype)


def _predicted_x0(schedule: DiffusionSchedule, model_output: torch.Tensor, sample: torch.Tensor, t: TimestepLike) -> torch.Tensor:
    if schedule.prediction_type == "epsilon":
        return pred_x0_from_eps(schedule, sample, model_output, t)
    if schedule.prediction_type == "sample":
        return model_output
    if schedule.prediction_type == "v_prediction":
        return pred_x0_from_v(schedule, sample, model_output, t)
    raise ValueError(f"unknown prediction_type: {schedule.prediction_type}")


def ddpm_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    t: TimestepLike,
    prev_t: TimestepLike,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    variance_type: str = "fixed_small",
    clip_sample: bool = False,
    clip_sample_range: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral DDPM step x_t -> x_{prev_t}; returns (prev_sample, pred_x0).

    ``prev_t < 0`` selects ``final_alpha_cumprod``. ``noise`` is taken as given
    and masked off where ``t <= 0``.
    """
    x = sample.float()
    table = schedule.alphas_cumprod
    t = _timesteps(t, table)
    prev_t = _timesteps(prev_t, table)
    alpha_prod_t = _expand(table[t], x.ndim)
    final = torch.full_like(table[:1], schedule.final_alpha_cumprod)
    alpha_prod_prev = _expand(torch.where(prev_t >= 0, table[prev_t.clamp(min=0)], final), x.ndim)
    beta_prod_t = 1.0 - alpha_prod_t
    beta_prod_prev = 1.0 - alpha_prod_prev
    current_alpha_t = alpha_prod_t / alpha_prod_prev
    current_beta_t = 1.0 - current_alpha_t

    pred_x0 = _predicted_x0(schedule, model_output.float(), x, t)
    if clip_sample:
        pred_x0 = pred_x0.clamp(-clip_sample_range, clip_sample_range)

    pred_original_coeff = torch.sqrt(alpha_prod_prev) * current_beta_t / beta_prod_t
    current_sample_coeff = torch.sqrt(current_alpha_t) * beta_prod_prev / beta_prod_t
    prev_sample = pred_original_coeff * pred_x0 + current_sample_coeff * x

    if variance_type == "fixed_small":
        sigma = torch.sqrt((beta_prod_prev / beta_prod_t * current_beta_t).clamp(min=1e-20))
    elif variance_type == "fixed_large":
        sigma = torch.sqrt(current_beta_t.clamp(min=1e-20))
    else:
        raise ValueError(f"unsupported variance_type: {variance_type}")

    if noise is not None:
        is_last = _expand((t <= 0).float(), x.ndim)
        prev_sample = prev_sample + (1.0 - is_last) * sigma * noise.float()
    return prev_sample.to(sample.dtype), pred_x0.to(sample.dtype)


def ddim_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    t: TimestepLike,
    prev_t: TimestepLike,
    sample: torch.Tensor,
    eta: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic DDIM step (eta 0 only, as in the JAX package); returns
    (prev_sample, pred_x0). ``prev_t < 0`` selects ``final_alpha_cumprod``."""
    del eta
    x = sample.float()
    table = schedule.alphas_cumprod
    t = _timesteps(t, table)
    prev_t = _timesteps(prev_t, table)
    final = torch.full_like(table[:1], schedule.final_alpha_cumprod)
    alpha_prod_prev = _expand(torch.where(prev_t >= 0, table[prev_t.clamp(min=0)], final), x.ndim)
    pred_x0 = _predicted_x0(schedule, model_output.float(), x, t)
    eps = pred_eps_from_x0(schedule, x, pred_x0, t).float()
    prev_sample = torch.sqrt(alpha_prod_prev) * pred_x0 + torch.sqrt(1.0 - alpha_prod_prev) * eps
    return prev_sample.to(sample.dtype), pred_x0.to(sample.dtype)


def lcm_boundary_scalings(
    t: TimestepLike, timestep_scaling: float = 10.0, sigma_data: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_skip, c_out for consistency-model boundary conditions."""
    scaled_t = torch.as_tensor(t).float() * timestep_scaling
    c_skip = sigma_data**2 / (scaled_t**2 + sigma_data**2)
    c_out = scaled_t / torch.sqrt(scaled_t**2 + sigma_data**2)
    return c_skip, c_out


def lcm_single_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    t: TimestepLike,
    sample: torch.Tensor,
    clip_sample: bool = False,
    clip_sample_range: float = 1.0,
) -> torch.Tensor:
    """One-step LCM denoise: c_out * pred_x0 + c_skip * x_t."""
    x = sample.float()
    t = _timesteps(t, schedule.alphas_cumprod)
    pred_x0 = _predicted_x0(schedule, model_output.float(), x, t)
    if clip_sample:
        pred_x0 = pred_x0.clamp(-clip_sample_range, clip_sample_range)
    c_skip, c_out = lcm_boundary_scalings(t, schedule.timestep_scaling, schedule.sigma_data)
    return (_expand(c_out, x.ndim) * pred_x0 + _expand(c_skip, x.ndim) * x).to(sample.dtype)


def ddpm_inference_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    timestep_spacing: str = "leading",
    steps_offset: int = 1,
) -> np.ndarray:
    """Descending int timesteps for DDPM sampling (diffusers spacing rules)."""
    if timestep_spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts += steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {timestep_spacing}")
    return ts


def ddpm_prev_timesteps(timesteps: np.ndarray, num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Per-entry previous timestep: t - T//n (may go negative at the end)."""
    return np.asarray(timesteps, dtype=np.int64) - num_train_timesteps // num_inference_steps


def lcm_inference_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    original_inference_steps: int = 50,
    strength: float = 1.0,
) -> np.ndarray:
    """LCM spacing: subsample the k*c-1 training schedule, descending."""
    c = num_train_timesteps // original_inference_steps
    lcm_origin = np.arange(1, int(original_inference_steps * strength) + 1) * c - 1
    skipping_step = len(lcm_origin) // num_inference_steps
    if skipping_step < 1:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} exceeds the {len(lcm_origin)}-entry "
            f"LCM origin schedule (original_inference_steps={original_inference_steps}, "
            f"strength={strength}); reduce num_inference_steps"
        )
    return lcm_origin[::-skipping_step][:num_inference_steps].astype(np.int64)


def ddim_solver_timesteps(num_train_timesteps: int = 1000, ddim_steps: int = 50) -> np.ndarray:
    """Ascending DDIM solver grid of the LCM distillation: (i+1)*c - 1."""
    step_ratio = num_train_timesteps // ddim_steps
    return (np.arange(1, ddim_steps + 1) * step_ratio - 1).astype(np.int64)


def importance_sampling_weights(num_train_timesteps: int, alpha: float = 0.5) -> np.ndarray:
    """Timestep-importance pmf: p(t) ∝ 1/T · (1 − alpha·cos(πt/T)), fp32 numpy."""
    t = np.arange(num_train_timesteps, dtype=np.float64)
    w = 1.0 / num_train_timesteps * (1.0 - alpha * np.cos(np.pi * t / num_train_timesteps))
    return (w / w.sum()).astype(np.float32)
