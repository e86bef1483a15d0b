"""InstantIR restoration pipeline (eager PyTorch, or the whole restore as one CUDA graph).

Twin of ``instantir_tpu/pipeline/instantir.py``. Per step, a one-step LCM
previewer (the UNet with its previewer LoRA on) produces a clean reference
latent, the Aggregator fuses (LQ latent, preview) into per-resolution
residuals, and the main UNet (LoRA off, time-aware IP attention) predicts the
noise that a stochastic DDPM step consumes. The step schedule is split into at
most three phases by ``build_step_phases``:

  A. controlnet on, previewer off  -> preview latent := LQ latent (or the
     caller's ``reference_latents``)
  B. controlnet on, previewer on   -> previewer UNet + LCM step
  C. controlnet off                -> plain UNet step

The step loop is Python: where the JAX sampler has ``lax.cond`` (a DeepCache
refresh or stale step, the Heun lookahead's last step) the port branches on
the host. ``RestoreConfig.fused`` records the whole restore, VAE encode to
decode, as one CUDA graph and replays it (``InstantIRPipeline.restore``).

Public tensors keep the JAX layout (NHWC images and latents); the models run
NCHW inside. Every random draw is injectable (``RestoreNoise``) so a run can be
held against the JAX pipeline's ``jax.random`` draws; otherwise the draws come
from a ``torch.Generator`` on the pipeline's device.

``shard(mesh)`` attaches a ``(data, model)`` mesh (``parallel/mesh.py``, one
process per GPU): a restore then runs each rank's rows of the batch over the
``data`` axis and all-gathers the result, or, with
``RestoreConfig.sequence_parallel``, runs the whole batch on every rank and
rings each long self-attention over the ranks
(``parallel/ring_attention.py``); a ``model`` axis larger than 1 puts the
five models in the tensor-parallel layout (``parallel/tp.py``), each rank
holding its shard and the ranks of a ``model`` group running every restore
together.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.clip_vision import CLIPImageEncoder
from instantir_tpu_torch.models.dinov2 import DINOv2Model, preprocess_dinov2
from instantir_tpu_torch.models.layers import LoRAConv2d, LoRALinear, merge_lora
from instantir_tpu_torch.models.resampler import Resampler
from instantir_tpu_torch.models.unet import UNet2DConditionModel
from instantir_tpu_torch.models.vae import (
    AutoencoderKL,
    scale_latents,
    tiled_decode,
    tiled_encode,
    unscale_latents,
    vae_scale_factor,
)
from instantir_tpu_torch.ops import group_norm, quant
from instantir_tpu_torch.ops.attention import sequence_parallel_scope, tensor_parallel_scope
from instantir_tpu_torch.parallel.mesh import axis_size, gather_batch, replicate_params, shard_batch
from instantir_tpu_torch.parallel.tp import shard_weights, tp_shard_
from instantir_tpu_torch.schedulers.diffusion import (
    DiffusionSchedule,
    add_noise,
    ddpm_inference_timesteps,
    ddpm_prev_timesteps,
    ddpm_step,
    lcm_single_step,
)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float) -> torch.Tensor:
    """CFG std rescale (arXiv 2305.08891 §3.4), population std over all but the batch axis."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


@dataclasses.dataclass(frozen=True)
class RestoreConfig:
    """Sampling configuration; the same fields and defaults as the JAX twin."""

    num_inference_steps: int = 30
    guidance_scale: float = 7.0
    guidance_rescale: float = 0.0
    preview_start: float = 0.0
    preview_end: float = 1.0
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    controlnet_conditioning_scale: float = 1.0
    lora_alpha: float = 1.0  # previewer LoRA strength when enabled
    # merge the previewer LoRA into the weights once per restore and run the
    # previewer on them with the adapter branch skipped
    fuse_previewer_lora: bool = False
    # CFG single-pass control branch (opt-in approximations of the JAX package)
    preview_cfg: bool = True
    controlnet_cfg: bool = True
    # DeepCache: every deepcache_interval-th step (and each phase's first)
    # refreshes the main UNet's deep trunk and the Aggregator's shallow skips;
    # the steps between run only the shallowest deepcache_depth levels
    deepcache_interval: int = 1
    deepcache_depth: int = 1
    multistep_restore: bool = False  # the Heun lookahead on previewing steps
    adastep_restore: bool = False
    # with an attached mesh (``InstantIRPipeline.shard``): the batch replicated on
    # every rank and each self-attention of at least sp_min_seq tokens that the
    # data axis divides rung over the ranks (``ops.attention.sequence_parallel_scope``)
    sequence_parallel: bool = False
    sp_min_seq: int = 8192
    save_preview_row: bool = False
    vae_tiling: bool = False
    vae_tile_latent: int = 96  # latent-space tile edge
    vae_tile_overlap: float = 0.25
    vae_slicing: bool = False  # encode and decode one sample at a time
    decode_dtype: str = "float32"  # or "bfloat16"
    num_train_timesteps: int = 1000
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    timesteps: Optional[Tuple[int, ...]] = None  # custom descending sequence
    fused: bool = False  # the whole restore as one CUDA graph

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0


# Recorded restores (``RestoreConfig.fused``) kept at once by default
# (``InstantIRPipeline.max_graphs``). Each holds a private memory pool of its
# restore's peak (9.86 GB at 1024² on an H100), and the CLI records one per
# image size: two keep a size and the one before it (a folder that alternates
# two aspect ratios replays both) without letting a folder of many sizes fill
# the card. A server raises the bound to its bucket count (``cli/serve.py``).
MAX_GRAPHS = 2
_DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_config(cfg: RestoreConfig) -> None:
    if cfg.decode_dtype not in _DECODE_DTYPES:
        raise ValueError(f"RestoreConfig.decode_dtype must be one of {sorted(_DECODE_DTYPES)}, "
                         f"got {cfg.decode_dtype!r}")


def inference_timesteps(cfg: RestoreConfig) -> np.ndarray:
    if cfg.timesteps is not None:
        return np.asarray(cfg.timesteps, np.int64)
    return ddpm_inference_timesteps(cfg.num_inference_steps, cfg.num_train_timesteps, cfg.timestep_spacing,
                                    cfg.steps_offset)


def build_step_phases(cfg: RestoreConfig, timesteps: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
    """Split the step sequence into contiguous runs of equal mode
    ("A"/"B"/"C"), each with per-step lists: ``t``, ``prev_t``, the Heun
    lookahead's target ``next_t`` (the next entry of the sequence) and
    ``has_next`` (0.0 on the last step), and DeepCache's ``refresh`` (1.0
    every ``deepcache_interval``-th step and on each phase's first, so that a
    cache never crosses a mode boundary)."""
    if timesteps is None:
        timesteps = inference_timesteps(cfg)
    timesteps = np.asarray(timesteps, np.int64)
    n = len(timesteps)
    prev_ts = ddpm_prev_timesteps(timesteps, cfg.num_train_timesteps, n)
    phases: List[Dict[str, Any]] = []
    for i in range(n):
        keep = not (i / n < cfg.control_guidance_start or (i + 1) / n > cfg.control_guidance_end)
        previewing = not (i / n < cfg.preview_start or (i + 1) / n > cfg.preview_end)
        previewing = previewing and keep  # a preview is unused with the controlnet off
        mode = ("B" if previewing else "A") if keep else "C"
        next_t = int(timesteps[i + 1]) if i + 1 < n else int(timesteps[i])
        has_next = 1.0 if i + 1 < n else 0.0
        refresh = 1.0 if i % max(cfg.deepcache_interval, 1) == 0 else 0.0
        if phases and phases[-1]["mode"] == mode:
            for k, v in (("t", int(timesteps[i])), ("prev_t", int(prev_ts[i])), ("next_t", next_t),
                         ("has_next", has_next), ("refresh", refresh)):
                phases[-1][k].append(v)
        else:
            phases.append({"mode": mode, "t": [int(timesteps[i])], "prev_t": [int(prev_ts[i])], "next_t": [next_t],
                           "has_next": [has_next], "refresh": [1.0]})
    return phases


@dataclasses.dataclass
class RestoreNoise:
    """Every random draw of one restore, NHWC fp32 like the JAX draws:
    ``vae`` the VAE posterior draw (row i is sample i's: the JAX package's
    sliced encode draws one key per sample), ``init`` the draw that noises
    the LQ latent at the first timestep, ``steps[i]`` the DDPM noise of step i."""

    vae: torch.Tensor
    init: torch.Tensor
    steps: List[torch.Tensor]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _dense(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` with the row-major strides of its shape. Equal
    values must give equal images, but a size-1 dimension's stride (``x[None]``
    of a numpy array has 0) decides whether cuDNN runs the VAE's convolutions
    channels-last, and with it their rounding."""
    return t.to(device).clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _time_ids(h: int, w: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """SDXL's micro-conditioning row ``[h, w, 0, 0, h, w]`` on ``device``,
    built once per (size, dtype, device): a copy from host memory cannot be
    recorded in a CUDA graph. Callers do not write to it."""
    return torch.tensor([[h, w, 0, 0, h, w]], dtype=dtype, device=device)


class InstantIRPipeline:
    """Bundles the models and exposes ``restore``. Text encoding happens
    outside: ``restore`` takes prompt embeddings."""

    def __init__(self, unet: UNet2DConditionModel, aggregator: Aggregator, vae: AutoencoderKL,
                 resampler: Resampler, image_encoder: Union[DINOv2Model, CLIPImageEncoder],
                 schedule: DiffusionSchedule,
                 device="cuda"):
        self.device = torch.device(device)
        self.unet = unet
        self.aggregator = aggregator
        self.vae = vae
        self.resampler = resampler
        self.image_encoder = image_encoder
        self.schedule = schedule.to(self.device)
        self._frozen: Optional[Dict[str, torch.Tensor]] = None  # freeze_previewer's merged weights
        self._frozen_alpha: Optional[float] = None
        self._uncond: Optional[Tuple[Any, torch.Tensor]] = None  # (key, DINOv2 tokens of the zero image)
        # recorded restores, least recently replayed first (``_graph_replay``)
        self._graphs: "collections.OrderedDict[Any, Tuple[torch.cuda.CUDAGraph, List[Optional[torch.Tensor]], Any]]" = \
            collections.OrderedDict()
        self.max_graphs = MAX_GRAPHS  # recordings kept at once (``_graph_replay``)
        self.mesh = None  # the (data, model) DeviceMesh of ``shard``

    def shard(self, mesh) -> "InstantIRPipeline":
        """Attach ``mesh`` (``parallel.make_mesh``; None detaches), the twin of
        the JAX ``shard``: every rank's parameters become rank 0's
        (``replicate_params``, a broadcast over the ``data`` axis), and each
        ``restore`` then restores this rank's rows of the batch, which the
        ``data`` axis must divide, and all-gathers the result, so that every
        rank returns the whole batch; with ``sequence_parallel`` every rank
        restores the whole batch and rings the long self-attentions.

        A ``model`` axis larger than 1 is tensor parallelism: the ranks of a
        ``model`` group must hold the same weights (loaded from one checkpoint
        or built from one seed; a fingerprint check raises otherwise), and the
        five models then take the TP layout in place (``parallel.tp.tp_shard_``: attention
        and MLP weights split over heads and features, resnet and sampler
        convs over channels, column/row pairs closed by one all-reduce over
        the ``model`` group), a frozen previewer's merged weights with them
        (``shard_weights``), and the ranks of a ``model`` group run every
        restore together. An int8 base (``quantize`` first, as in the JAX
        package) stays whole. A TP layout cannot be undone: re-sharding or
        detaching such a pipeline raises (rebuild it)."""
        if self.tp_size > 1:
            raise ValueError("this pipeline already holds a tensor-parallel shard of its models; shard() cannot "
                             "place it again or detach it: rebuild the pipeline")
        if mesh is not None:
            tp = axis_size(mesh, "model") > 1
            # the data axis broadcasts rank 0's weights; the ranks of a model group must already hold the same
            # whole weights (each takes its own slice): checked, not copied
            for axis, broadcast in (("data", True), ("model", False)) if tp else (("data", True),):
                for name in self._MODELS:
                    replicate_params(getattr(self, name), mesh, axis, broadcast)
                if self._frozen is not None:
                    replicate_params(self._frozen, mesh, axis, broadcast)
            if tp:
                for name in self._MODELS:
                    tp_shard_(getattr(self, name), mesh)
                if self._frozen is not None:
                    self._frozen = shard_weights(self.unet, self._frozen)
                self._graphs.clear()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
            self._uncond = None  # tokens computed before the broadcast
        self.mesh = mesh
        return self

    @property
    def tp_size(self) -> int:
        """The size of the attached mesh's ``model`` axis (1: no tensor parallelism)."""
        return axis_size(self.mesh, "model") if self.mesh is not None else 1

    def _trace_scopes(self, cfg: RestoreConfig) -> contextlib.ExitStack:
        """The parallelism scopes of one restore on the attached mesh: the
        ring's when ``sequence_parallel``, the TP scope when the mesh has a
        ``model`` axis (``ops/attention.py``); none without a mesh."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            if cfg.sequence_parallel:
                stack.enter_context(sequence_parallel_scope(self.mesh, min_seq=cfg.sp_min_seq))
            if self.tp_size > 1:
                stack.enter_context(tensor_parallel_scope(self.mesh))
        return stack

    def freeze_previewer(self, alpha: float = 1.0) -> "InstantIRPipeline":
        """Inference only: merge the UNet's previewer LoRA at strength
        ``alpha`` into a dedicated set of weights once (``W + alpha·(α/r)·B·A``,
        ``models.layers.merge_lora``) and free the LoRA A/B pairs. Previewing
        steps then run the UNet on the merged weights with the adapter branch
        skipped. Afterwards ``restore`` requires ``cfg.lora_alpha == alpha``
        (or 0). Recorded CUDA graphs are dropped. A quantized pipeline
        refuses: its int8 bases cannot take the merge."""
        if self.quantized is not None:
            raise ValueError("freeze_previewer() on a quantized pipeline is unsupported: the int8 base weights "
                             "can't absorb a LoRA merge")
        if self._frozen is not None:
            raise ValueError(f"the previewer is already frozen at lora_alpha={self._frozen_alpha}")
        with torch.no_grad():
            merged = merge_lora(self.unet, alpha)
        for m in self.unet.modules():
            if isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora_rank > 0:
                del m.lora_A, m.lora_B
                m.lora_rank = 0
        self._frozen, self._frozen_alpha = merged, float(alpha)
        self._graphs.clear()
        return self

    @property
    def quantized(self) -> Optional[str]:
        """"w8a8" or "w8" after ``quantize``, else None."""
        return quant.quant_mode(self.unet) or quant.quant_mode(self.aggregator)

    def quantize(self, min_size: Optional[int] = None, weight_only: bool = False) -> "InstantIRPipeline":
        """Inference-only int8 quantization of the UNet and the Aggregator
        (CLI ``--quantized``), twin of the JAX ``InstantIRPipeline.quantize``:
        every LoRA base weight of at least ``min_size`` values
        (``ops.quant.DEFAULT_MIN_SIZE`` by default) becomes int8 codes with
        per-output-channel scales, in place (``ops.quant.quantize_tree``), and
        the bf16 weight it replaces is freed. ``weight_only=False`` is W8A8
        (``--quantized w8a8``: dynamic activation quantization and int8
        products), ``True`` is W8 (``--quantized w8``: the weights
        dequantized at each use, the ordinary op). The VAE, the encoders, the
        LoRA branches, the norms and the small convolutions stay in fp; the
        dynamic previewer LoRA branch still runs. Idempotent. Refused after
        ``freeze_previewer``; ``freeze_previewer`` and
        ``fuse_previewer_lora`` are refused after it. Recorded CUDA graphs are
        dropped."""
        if self._frozen is not None:
            raise ValueError("quantize() after freeze_previewer() is unsupported: quantize first")
        if self.quantized is not None:
            return self
        if self.tp_size > 1:
            raise ValueError("quantize() after a tensor-parallel shard() would take each rank's per-channel scales "
                             "from its shard: quantize before shard(), as in the JAX package (the int8 bases then "
                             "stay whole)")
        for model in (self.unet, self.aggregator):
            quant.quantize_tree(model, min_size=min_size, weight_only=weight_only)
        self._graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self

    # ------------------------------------------------------------------
    # Checkpointing: the five models' state dicts in one file
    # ------------------------------------------------------------------

    _MODELS = ("unet", "aggregator", "vae", "resampler", "image_encoder")

    def save_params(self, path: str) -> str:
        """Write the five models' state dicts (on the CPU, each tensor in its
        own dtype) to ``<path>/params.pt``, the port's counterpart of the JAX
        package's orbax checkpoint; returns the file's path."""
        os.makedirs(path, exist_ok=True)
        file = os.path.join(path, "params.pt")
        torch.save({name: {k: v.detach().cpu() for k, v in getattr(self, name).state_dict().items()}
                    for name in self._MODELS}, file)
        return file

    def load_params(self, path: str) -> None:
        """Load ``<path>/params.pt`` into the models in place (strict), so
        recorded CUDA graphs replay on the new weights. A frozen previewer's
        merged weights are not in the file: load before ``freeze_previewer``.
        The int8 codes and scales of a quantized pipeline are in the file: a
        base that the file holds in int8 is quantized in its mode before the
        load (``ops.quant.quantize_like``)."""
        if self._frozen is not None:
            raise ValueError("load_params after freeze_previewer would leave the merged previewer weights stale")
        state = torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True)
        with torch.no_grad():
            for name in self._MODELS:
                model = getattr(self, name)
                quant.quantize_like(model, state[name])
                model.load_state_dict(state[name], strict=True)

    # ------------------------------------------------------------------
    # Encoders (run once per call, outside the denoise loop)
    # ------------------------------------------------------------------

    def _uncond_tokens(self, size: int, dtype: torch.dtype) -> torch.Tensor:
        """The image encoder's tokens of the zero image (in *preprocessed*
        pixel space; DINOv2's or the CLIP tower's), which depend on the
        encoder's weights alone: computed once per (image size, dtype,
        weights). The weights are known by every parameter's and buffer's
        ``data_ptr`` and version counter, which ``load_state_dict`` and any
        other in-place edit advance, so another encoder's tokens are never
        taken from the cache."""
        enc = self.image_encoder
        key = (size, dtype, type(enc), tuple((t.data_ptr(), t._version) for t in (*enc.parameters(), *enc.buffers())))
        if self._uncond is None or self._uncond[0] != key:
            zeros = torch.zeros((1, 3, size, size), dtype=dtype, device=self.device)
            self._uncond = (key, enc(zeros))
        return self._uncond[1]

    def encode_image_embeds(self, images01: torch.Tensor, uncond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The image encoder's tokens for (cond, uncond): ``uncond`` is
        ``_uncond_tokens``, those of a zero tensor in preprocessed pixel
        space, broadcast. The pixels are preprocessed at the encoder's own
        ``image_size`` (a CLIP tower re-normalizes them itself)."""
        cond = self.image_encoder(_nchw(preprocess_dinov2(images01, size=self.image_encoder.config.image_size)))
        return cond, uncond.expand_as(cond)

    def encode_vae_image(self, images: torch.Tensor, noise: torch.Tensor,
                         tiling: Optional[Tuple[int, float]] = None, slicing: bool = False) -> torch.Tensor:
        """[-1, 1] NHWC images -> scaled NCHW latents (sampled posterior).
        ``tiling=(tile_latent, overlap)`` encodes tile by tile (no change when
        the image fits one tile); ``slicing`` encodes one sample at a time
        (exact), sample i with ``noise[i]``."""
        if slicing and images.shape[0] > 1:
            return torch.cat([self.encode_vae_image(images[i:i + 1], noise[i:i + 1], tiling)
                              for i in range(images.shape[0])])
        x, eps = _nchw(images), _nchw(noise)
        if tiling is not None:
            z = tiled_encode(self.vae, x, eps, tile_sample=tiling[0] * vae_scale_factor(self.vae.config),
                             overlap=tiling[1])
        else:
            z = self.vae.encode(x, noise=eps)
        return scale_latents(self.vae.config, z)

    def decode_latents(self, latents: torch.Tensor, dtype: torch.dtype = torch.float32,
                       tiling: Optional[Tuple[int, float]] = None, slicing: bool = False) -> torch.Tensor:
        """Model-space NCHW latents -> NHWC images in [-1, 1], decoded in
        ``dtype`` (fp32: the reference's force_upcast; bf16 from the fp32
        weights, GroupNorm statistics fp32), tile by tile with ``tiling``, one
        sample at a time with ``slicing`` (exact)."""
        if slicing and latents.shape[0] > 1:
            return torch.cat([self.decode_latents(latents[i:i + 1], dtype, tiling) for i in range(latents.shape[0])])
        z = unscale_latents(self.vae.config, latents.to(dtype))
        if tiling is not None:
            return _nhwc(tiled_decode(self.vae, z, tile_latent=tiling[0], overlap=tiling[1], dtype=dtype))
        return _nhwc(self.vae.decode(z, dtype))

    # ------------------------------------------------------------------
    # The denoise loop
    # ------------------------------------------------------------------

    def _deepcache_zeros(self, cfg: RestoreConfig, latents: torch.Tensor) -> Dict[str, Any]:
        """DeepCache's zero-initialised cache (NCHW, the latents' dtype): the
        deep trunk's output, the Aggregator's shallow skip residuals and the
        preview. Every phase starts with a refresh, so no zero feeds a model."""
        ucfg = self.unet.config
        depth = cfg.deepcache_depth
        bsz2 = latents.shape[0] * (2 if cfg.do_cfg else 1)
        h, w = latents.shape[2], latents.shape[3]
        res_shapes = [(bsz2, ucfg.block_out_channels[0], h, w)]
        for lvl in range(depth):
            c = ucfg.block_out_channels[lvl]
            res_shapes += [(bsz2, c, h >> lvl, w >> lvl)] * ucfg.layers_per_block
            if lvl < depth - 1:
                res_shapes.append((bsz2, c, h >> (lvl + 1), w >> (lvl + 1)))

        def zeros(shape):
            return torch.zeros(shape, dtype=latents.dtype, device=latents.device)

        return {"deep": zeros((bsz2, ucfg.block_out_channels[depth], h >> (depth - 1), w >> (depth - 1))),
                "res": tuple(zeros(s) for s in res_shapes), "preview": zeros(latents.shape)}

    def _sample(self, cfg: RestoreConfig, latents: torch.Tensor, cond: Dict[str, torch.Tensor],
                image_latent: torch.Tensor, ip_base: torch.Tensor, ip_lora: torch.Tensor,
                step_noise: List[torch.Tensor], reference_latents: Optional[torch.Tensor] = None,
                prev_weights: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The step loop (JAX ``_build_sample``). ``prev_weights``: merged
        previewer weights from ``freeze_previewer``. Returns the final latents
        and, with ``save_preview_row``, the previews of the mode-B steps
        stacked ``[n, B, C, h, w]`` (else None)."""
        schedule = self.schedule
        phases = build_step_phases(cfg)
        do_cfg = cfg.do_cfg
        gs = cfg.guidance_scale
        bsz = latents.shape[0]
        dev = latents.device
        share_preview = do_cfg and not cfg.preview_cfg
        share_cnet = do_cfg and not cfg.controlnet_cfg
        deepcache = cfg.deepcache_interval > 1
        depth = cfg.deepcache_depth
        if deepcache and cfg.multistep_restore:
            raise ValueError("deepcache_interval > 1 is incompatible with multistep_restore "
                             "(the Heun lookahead needs a fresh preview every step)")
        if (prev_weights is None and cfg.fuse_previewer_lora and cfg.lora_alpha
                and any(p["mode"] == "B" for p in phases)):
            prev_weights = merge_lora(self.unet, cfg.lora_alpha)

        def double(x):
            return torch.cat([x, x], dim=0) if do_cfg else x

        def unet(lat, tb, cnd, lora_scale, ip_tokens, residuals=None, mid_residual=None, weights=None, **deepcache_kw):
            args = (lat, tb, cnd["prompt_embeds"], cnd["pooled_embeds"], cnd["time_ids"])
            kwargs = dict(ip_hidden_states=ip_tokens, down_block_additional_residuals=residuals,
                          mid_block_additional_residual=mid_residual, lora_scale=lora_scale, **deepcache_kw)
            if weights is not None:
                return torch.func.functional_call(self.unet, weights, args, kwargs)
            return self.unet(*args, **kwargs)

        def cfg_combine(noise_pred):
            if not do_cfg:
                return noise_pred
            uncond, text = noise_pred.chunk(2, dim=0)
            pred = uncond + gs * (text - uncond)
            if cfg.guidance_rescale > 0.0:
                pred = rescale_noise_cfg(pred, text, cfg.guidance_rescale)
            return pred

        def compute_preview(mode, latents, latent_in, tb):
            """(preview latent of the CFG batch, the previewer's noise or None)."""
            if mode != "B":
                return (image_latent if reference_latents is None else reference_latents), None
            if share_preview:
                p_lat, p_tb, p_ip = latents, tb[:bsz], ip_lora[-bsz:]
                p_cond = {k: v[-bsz:] for k, v in cond.items()}
            else:
                p_lat, p_tb, p_cond, p_ip = latent_in, tb, cond, ip_lora
            if prev_weights is not None:  # merged LoRA, adapter branch skipped
                preview_noise = unet(p_lat, p_tb, p_cond, 0.0, p_ip, weights=prev_weights)
            else:
                preview_noise = unet(p_lat, p_tb, p_cond, cfg.lora_alpha, p_ip)
            preview = lcm_single_step(schedule, preview_noise, p_tb, p_lat)
            return (double(preview) if share_preview else preview), preview_noise

        def run_aggregator(preview_latent, tb, dtype):
            if share_cnet:
                down_res, mid_res = self.aggregator(
                    image_latent[-bsz:], tb[:bsz], preview_latent[-bsz:].to(dtype),
                    cond["pooled_embeds"][-bsz:], cond["time_ids"][-bsz:])
                return tuple(double(r) for r in down_res), double(mid_res)
            return self.aggregator(image_latent, tb, preview_latent.to(dtype), cond["pooled_embeds"], cond["time_ids"])

        preview_factor = torch.ones((bsz, 1, 1, 1), dtype=torch.float32, device=dev)
        prev_preview = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
        cache = self._deepcache_zeros(cfg, latents) if deepcache else None
        previews = []
        step = 0
        for phase in phases:
            mode = phase["mode"]
            for t, prev_t, next_t, has_next, refresh in zip(phase["t"], phase["prev_t"], phase["next_t"],
                                                            phase["has_next"], phase["refresh"]):
                tb = torch.full((bsz * (2 if do_cfg else 1),), t, dtype=torch.long, device=dev)
                tb1 = tb[:bsz]
                prev_tb1 = torch.full((bsz,), prev_t, dtype=torch.long, device=dev)
                latent_in = double(latents)
                fresh = refresh > 0

                if mode == "C":
                    if deepcache and fresh:
                        noise_raw, deep = unet(latent_in, tb, cond, 0.0, ip_base, return_deep=True, cache_depth=depth)
                        cache["deep"] = deep.to(cache["deep"].dtype)
                    elif deepcache:
                        noise_raw = unet(latent_in, tb, cond, 0.0, ip_base, cached_deep=cache["deep"],
                                         cache_depth=depth)
                    else:
                        noise_raw = unet(latent_in, tb, cond, 0.0, ip_base)
                    latents, _ = ddpm_step(schedule, cfg_combine(noise_raw), tb1, prev_tb1, latents, step_noise[step])
                    step += 1
                    continue

                # A/B: controlnet on; adaptive restoration scaling of the residuals
                cond_scale = double(preview_factor.clamp(0.0, cfg.controlnet_conditioning_scale))

                def scaled(res):
                    return tuple(r * cond_scale.to(r.dtype) for r in res)

                if deepcache and fresh:
                    # the full previewer -> Aggregator -> main UNet, caching the deep
                    # trunk, the shallow skip residuals (unscaled) and the preview
                    preview_latent, _ = compute_preview(mode, latents, latent_in, tb)
                    down_res, mid_res = run_aggregator(preview_latent, tb, latents.dtype)
                    cache["res"] = tuple(r.to(c.dtype) for r, c in zip(down_res, cache["res"]))
                    cache["preview"] = preview_latent[-bsz:].to(cache["preview"].dtype)
                    noise_raw, deep = unet(latent_in, tb, cond, 0.0, ip_base, scaled(down_res),
                                           mid_res * cond_scale.to(mid_res.dtype), return_deep=True,
                                           cache_depth=depth)
                    cache["deep"] = deep.to(cache["deep"].dtype)
                    preview_text = cache["preview"]
                elif deepcache:
                    # stale: the shallow UNet over the cached trunk; the previewer
                    # and the Aggregator are skipped (their outputs are cached)
                    noise_raw = unet(latent_in, tb, cond, 0.0, ip_base, scaled(cache["res"]), None,
                                     cached_deep=cache["deep"], cache_depth=depth)
                    preview_text = cache["preview"]
                else:
                    preview_latent, preview_noise = compute_preview(mode, latents, latent_in, tb)
                    latent_eval, tb_eval = latent_in, tb
                    if cfg.multistep_restore and mode == "B" and has_next:
                        # Heun lookahead: a deterministic DDPM step with the previewer's
                        # text-cond noise predicts x at next_t, where the Aggregator and
                        # the main UNet are evaluated; the update still steps from (x_t, t)
                        first_prev, _ = ddpm_step(schedule, preview_noise[-bsz:], tb1, prev_tb1, latents, noise=None)
                        latent_eval = double(first_prev.to(latents.dtype))
                        tb_eval = torch.full_like(tb, next_t)
                    down_res, mid_res = run_aggregator(preview_latent, tb_eval, latents.dtype)
                    noise_raw = unet(latent_eval, tb_eval, cond, 0.0, ip_base, scaled(down_res),
                                     mid_res * cond_scale.to(mid_res.dtype))
                    preview_text = preview_latent[-bsz:]  # the text-cond half under CFG

                latents_next, pred_x0 = ddpm_step(schedule, cfg_combine(noise_raw), tb1, prev_tb1, latents,
                                                  step_noise[step])
                step += 1
                if cfg.adastep_restore and (fresh or not deepcache):
                    # preview_factor <- |preview - x0|^2 / |preview - prev_preview|^2, on
                    # fresh previews only (a stale step carries the cached one)
                    pt = preview_text.float()
                    d_pred = ((pt - pred_x0.float()) ** 2).sum(dim=(1, 2, 3))
                    d_prev = ((pt - prev_preview) ** 2).sum(dim=(1, 2, 3))
                    preview_factor = (d_pred / d_prev.clamp(min=1e-12)).reshape(-1, 1, 1, 1)
                    prev_preview = pt
                if cfg.save_preview_row and mode == "B":  # stale steps emit the cached preview
                    previews.append(preview_text)
                latents = latents_next
        return latents, (torch.stack(previews) if previews else None)

    def _restore_body(self, cfg: RestoreConfig, lq_images, prompt_embeds, pooled_embeds, neg_pe, neg_pp,
                      reference_latents, uncond, noise_vae, noise_init, noise_steps, prev_weights, decode: bool):
        """Everything from the VAE encode to the decode, on device tensors and
        with no copy from host memory, so that it can be recorded in a CUDA
        graph. Returns ``(latents, preview row, image, previews)`` (NCHW
        latents, NHWC images; the last two None unless ``decode``)."""
        b, h, w, _ = lq_images.shape
        tiling = (cfg.vae_tile_latent, cfg.vae_tile_overlap) if cfg.vae_tiling else None

        # 1. LQ -> latent (fp32 VAE encode), used as both init and condition
        image_latent = self.encode_vae_image(lq_images.float(), noise_vae, tiling=tiling, slicing=cfg.vae_slicing)
        image_latent = image_latent.to(prompt_embeds.dtype)

        # 2. image-prompt tokens (cond + uncond), both LoRA modes
        dino_cond, dino_uncond = self.encode_image_embeds((lq_images + 1.0) / 2.0, uncond)
        dino_tokens = torch.cat([dino_uncond, dino_cond], dim=0) if cfg.do_cfg else dino_cond
        ip_base = self.resampler(dino_tokens, lora_scale=0.0)
        ip_lora = self.resampler(dino_tokens, lora_scale=cfg.lora_alpha)

        # 3. prompt conditioning (+ CFG doubling; negatives default to zeros)
        if cfg.do_cfg:
            neg_pe = torch.zeros_like(prompt_embeds) if neg_pe is None else neg_pe
            neg_pp = torch.zeros_like(pooled_embeds) if neg_pp is None else neg_pp
            prompt_embeds = torch.cat([neg_pe, prompt_embeds], dim=0)
            pooled_embeds = torch.cat([neg_pp, pooled_embeds], dim=0)
        time_ids = _time_ids(h, w, prompt_embeds.dtype, prompt_embeds.device).repeat(prompt_embeds.shape[0], 1)
        cond = {"prompt_embeds": prompt_embeds, "pooled_embeds": pooled_embeds, "time_ids": time_ids}

        # 4. init latents from the noised LQ latent
        t0 = torch.full((b,), int(inference_timesteps(cfg)[0]), dtype=torch.long, device=lq_images.device)
        latents = add_noise(self.schedule, image_latent, _nchw(noise_init), t0)

        # 5. the loop
        cond_image_latent = torch.cat([image_latent] * 2, dim=0) if cfg.do_cfg else image_latent
        ref = None
        if reference_latents is not None:
            ref = _nchw(reference_latents)
            ref = torch.cat([ref, ref], dim=0) if cfg.do_cfg else ref
        latents, row = self._sample(cfg, latents, cond, cond_image_latent, ip_base, ip_lora,
                                    [_nchw(s) for s in noise_steps], ref, prev_weights)
        if not decode:
            return latents, row, None, None

        # 6. decode the image and the previews alike
        dtype = _DECODE_DTYPES[cfg.decode_dtype]
        image = self.decode_latents(latents, dtype, tiling, cfg.vae_slicing)
        previews = None if row is None else [self.decode_latents(p, dtype, tiling, cfg.vae_slicing) for p in row]
        return latents, row, image, previews

    def _graph_replay(self, cfg: RestoreConfig, tensors: List[Optional[torch.Tensor]], n_steps: int,
                      prev_weights) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """``cfg.fused``: the restore as one CUDA graph, recorded once per
        (config, shapes and dtypes of the inputs, which optional inputs are
        given, ``ops.group_norm.USE_FUSED``) and replayed: the inputs are
        copied into the graph's static buffers, the graph replays, and its
        image and previews are cloned out.

        The first call warms up (one restore on a side stream: kernels set
        their shared-memory attributes and plans, per-device constants are
        built), records, then replays; the kernels' launch counters, which
        count Python calls, count one restore at the warm-up and one at the
        recording, and stand still on a replay. The graph reads the weights
        where they lie when it replays: in-place changes (``load_state_dict``)
        are seen; ``freeze_previewer`` drops the graphs. Each recorded graph
        keeps a private memory pool of the restore's peak, so at most
        ``self.max_graphs`` are kept: recording another drops the least recently
        replayed one (its graph, static inputs and outputs) and hands its
        pool back to the card (``torch.cuda.empty_cache``), as a recording
        does with the warm-up's memory."""
        if self.device.type != "cuda":
            raise RuntimeError(f"RestoreConfig.fused=True records the restore as one CUDA graph and needs a CUDA "
                               f"device; this pipeline is on {self.device}")
        key = (cfg, group_norm.USE_FUSED,
               tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors))
        entry = self._graphs.get(key)
        if entry is None:
            while len(self._graphs) >= self.max_graphs:
                self._graphs.popitem(last=False)
                torch.cuda.empty_cache()
            static = [None if t is None else t.clone() for t in tensors]

            def run():
                return self._restore_body(cfg, *static[:7], static[7], static[8], static[9:9 + n_steps],
                                          prev_weights, decode=True)[2:]

            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                run()
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run()
            entry = self._graphs[key] = (graph, static, out)
            torch.cuda.empty_cache()  # the warm-up's blocks: only the graph's pool stays reserved
        else:
            self._graphs.move_to_end(key)
            for buf, t in zip(entry[1], tensors):
                if buf is not None:
                    buf.copy_(t)
        graph, _, (image, previews) = entry
        graph.replay()
        return image.clone(), None if previews is None else [p.clone() for p in previews]

    def draw_noise(self, cfg: RestoreConfig, batch: int, height: int, width: int,
                   generator: torch.Generator) -> RestoreNoise:
        """Every draw of one restore of ``batch`` images of ``height`` x
        ``width`` pixels from ``generator``, in ``restore``'s order: the VAE
        posterior's, the init noise's, then each step's (NHWC fp32 latents)."""
        f = vae_scale_factor(self.vae.config)
        lat_shape = (batch, height // f, width // f, self.vae.config.latent_channels)

        def draw():
            return torch.randn(lat_shape, generator=generator, dtype=torch.float32, device=self.device)

        return RestoreNoise(vae=draw(), init=draw(), steps=[draw() for _ in range(len(inference_timesteps(cfg)))])

    @torch.no_grad()
    def restore(
        self,
        lq_images: torch.Tensor,  # [B, H, W, 3] in [-1, 1]
        prompt_embeds: torch.Tensor,  # [B, 77, 2048] text-cond
        pooled_embeds: torch.Tensor,  # [B, 1280]
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_embeds: Optional[torch.Tensor] = None,
        cfg: RestoreConfig = RestoreConfig(),
        generator: Optional[torch.Generator] = None,
        noise: Optional[RestoreNoise] = None,
        reference_latents: Optional[torch.Tensor] = None,  # [B, H/8, W/8, 4] model-space, mode A's preview
        output_type: str = "np",
    ):
        """End-to-end restoration. Returns ``(image, previews)`` -- the image
        NHWC in [-1, 1], fp32, as numpy (``"np"``) or a tensor (``"pt"``), and
        with ``save_preview_row`` the list of decoded mode-B previews (else
        None) -- or ``(latents, preview row)`` in NHWC for
        ``output_type="latent"`` (the row stacked ``[n, B, h, w, 4]``).
        ``cfg.fused`` replays the whole restore as one CUDA graph
        (``_graph_replay``); ``output_type="latent"`` takes the staged path
        then, as in the JAX package. Without ``noise`` the draws come from
        ``generator`` in the same order on both paths.

        With a mesh attached (``shard``) each rank restores its rows of the
        batch, using its rows of the whole batch's draws (``noise``, or
        ``generator``'s draws for the whole batch), and every rank returns
        the whole batch (an all-gather); a graph (``fused``) holds the
        rank's own restore, the gather runs outside it. With
        ``sequence_parallel`` every rank restores the whole batch and the
        self-attentions of at least ``sp_min_seq`` tokens ring over the
        ranks. A batch the data axis does not divide, ``sequence_parallel``
        without a mesh and ``sequence_parallel`` with ``fused`` raise."""
        _check_config(cfg)
        if cfg.fuse_previewer_lora and self.quantized is not None:
            raise ValueError("fuse_previewer_lora can't merge into int8 base weights: quantized pipelines use the "
                             "dynamic LoRA branch (the default)")
        dev = self.device
        b, h, w, _ = lq_images.shape
        n_steps = len(inference_timesteps(cfg))
        seq_par = cfg.sequence_parallel and self.mesh is not None
        if self.mesh is not None and not seq_par and b % axis_size(self.mesh):
            raise ValueError(f"batch {b} not divisible by mesh data axis {axis_size(self.mesh)}")
        if cfg.sequence_parallel and self.mesh is None:
            raise ValueError("sequence_parallel=True requires an attached mesh (pipe.shard(mesh))")
        if seq_par and cfg.fused:
            raise ValueError("sequence_parallel does not compose with cfg.fused")
        if cfg.fused and self.tp_size > 1:
            raise ValueError("RestoreConfig.fused does not compose with tensor parallelism yet: a CUDA graph of the "
                             "restore would have to capture the model group's all-reduces, which no run has "
                             "recorded and replayed; restore with fused=False")
        prev_weights = None
        if self._frozen is not None and cfg.lora_alpha:
            if cfg.lora_alpha != self._frozen_alpha:
                raise ValueError(f"previewer frozen at lora_alpha={self._frozen_alpha} (the LoRA pairs were freed); "
                                 f"restore with lora_alpha={cfg.lora_alpha} is impossible: rebuild the pipeline or "
                                 f"freeze at the strength wanted")
            prev_weights = self._frozen
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            noise = self.draw_noise(cfg, b, h, w, generator)
        if len(noise.steps) != n_steps:
            raise ValueError(f"noise.steps holds {len(noise.steps)} draws for {n_steps} steps")

        inputs = [lq_images, prompt_embeds, pooled_embeds, negative_prompt_embeds, negative_pooled_embeds,
                  reference_latents]
        draws = [noise.vae, noise.init, *noise.steps]
        data_sharded = self.mesh is not None and not seq_par
        if data_sharded:  # this rank's rows of the batch and of its draws
            inputs, draws = shard_batch(inputs, self.mesh), shard_batch(draws, self.mesh)
        inputs = [None if t is None else _dense(t, dev) for t in inputs]
        draws = [t.to(dev) for t in draws]
        uncond = self._uncond_tokens(self.image_encoder.config.image_size, lq_images.dtype)
        if cfg.fused and output_type != "latent":
            with self._trace_scopes(cfg):
                image, previews = self._graph_replay(cfg, [*inputs, uncond, *draws], n_steps, prev_weights)
        else:
            with self._trace_scopes(cfg):
                latents, row, image, previews = self._restore_body(cfg, *inputs, uncond, draws[0], draws[1],
                                                                   draws[2:], prev_weights,
                                                                   decode=output_type != "latent")
            if output_type == "latent":
                if data_sharded:
                    latents = gather_batch(latents, self.mesh)
                    row = None if row is None else gather_batch(row.transpose(0, 1), self.mesh).transpose(0, 1)
                return _nhwc(latents), None if row is None else row.permute(0, 1, 3, 4, 2)
        if data_sharded:
            image = gather_batch(image, self.mesh)
            previews = None if previews is None else [gather_batch(p, self.mesh) for p in previews]
        image = image.float()
        previews = None if previews is None else [p.float() for p in previews]
        if output_type == "np":
            return image.cpu().numpy(), None if previews is None else [p.cpu().numpy() for p in previews]
        return image, previews
