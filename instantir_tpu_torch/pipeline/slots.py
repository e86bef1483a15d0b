"""Slot-based continuous batching: per-slot timesteps over one resident batch.

Twin of ``instantir_tpu/pipeline/slots.py``. The whole-request server
(``cli/serve.py::RestoreServer``) admits requests only between whole
restores; this module keeps a **resident batch of N slots** per resolution
bucket, each slot with its own step index, random stream and conditioning,
and steps them one denoise step at a time, so that a finished slot is decoded
and refilled from the queue mid-flight.

The port's schedulers and UNet already take per-sample timesteps
(``schedulers/diffusion.py``, ``models/unet.py``), so the slot math is the
staged sampler's (``pipeline/instantir.py``):

* The three phases (A: controlnet on, previewer off; B: both on; C:
  controlnet off) become per-slot masks gathered from tables built by the
  same ``build_step_phases``. A slot that is not previewing conditions the
  Aggregator on its LQ latent (phase A); a slot with the controlnet off
  multiplies its residuals by 0 before the UNet's adds, and adding zero is
  exact, so phase C stays exact inside a mixed batch.
* Where the JAX twin skips the previewer or the Aggregator with a traced
  ``lax.cond``, the port decides on the host, which knows every slot's step
  index (``SlotState.host_idx``) and so needs no device sync. A step runs one
  of three variants: previewer + Aggregator + UNet, Aggregator + UNet, or the
  plain UNet.
* Each slot draws its step noise from its own ``torch.Generator`` (or takes
  the caller's), and only on the steps it executes, so a slot's trajectory
  depends on its own progress alone, whatever else occupies the batch.
* On a CUDA pipeline each (state, variant) is recorded once as a CUDA graph
  and replayed; the variants of a sampler share one memory pool, since they
  never run at once. The graph reads and writes the ``SlotState`` tensors in
  place (the new latents are copied into the resident ones), and the noise
  is drawn outside it into the state's noise buffer. ``prelude`` (VAE encode,
  DINOv2, Resampler) and the batch-1 decode run once per request, staged.
  On the CPU the same step runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from instantir_tpu_torch.pipeline.instantir import (
    _DECODE_DTYPES,
    RestoreConfig,
    _dense,
    _nchw,
    _time_ids,
    build_step_phases,
    inference_timesteps,
    rescale_noise_cfg,
)
from instantir_tpu_torch.models.vae import vae_scale_factor
from instantir_tpu_torch.schedulers.diffusion import add_noise, ddpm_step, lcm_single_step

@dataclasses.dataclass
class SlotState:
    """Resident state of one bucket's slot batch (device tensors, NCHW
    latents). Conditioning is kept as uncond/cond halves (rows ``[N, ...]``);
    the step concatenates them into the CFG batch ``[uncond, cond]`` as the
    staged sampler does. ``host_idx`` is the host's copy of ``step_idx``,
    ``generators`` each slot's random stream and ``graphs`` the step's CUDA
    graphs recorded on these tensors, by variant."""

    latents: torch.Tensor        # [N, 4, h, w] current x_t per slot
    image_latent: torch.Tensor   # [N, 4, h, w] LQ condition latent per slot
    prompt_u: torch.Tensor       # [N, 77, 2048]
    prompt_c: torch.Tensor
    pooled_u: torch.Tensor       # [N, 1280]
    pooled_c: torch.Tensor
    ip_base_u: torch.Tensor      # [N, 64, 2048] resampler tokens, LoRA off
    ip_base_c: torch.Tensor
    ip_lora_u: torch.Tensor      # [N, 64, 2048] resampler tokens, LoRA on
    ip_lora_c: torch.Tensor
    noise: torch.Tensor          # [N, 4, h, w] fp32: this step's DDPM draws
    step_idx: torch.Tensor       # [N] int64: next step to execute; n_steps = idle
    host_idx: List[int]
    generators: List[Optional[torch.Generator]]
    graphs: Dict[str, "torch.cuda.CUDAGraph"] = dataclasses.field(default_factory=dict)


_PAYLOAD = ("latents", "image_latent", "prompt_u", "prompt_c", "pooled_u", "pooled_c",
            "ip_base_u", "ip_base_c", "ip_lora_u", "ip_lora_c")


def build_step_tables(cfg: RestoreConfig) -> Dict[str, np.ndarray]:
    """Flat per-step schedule tables, derived from the same
    ``build_step_phases`` the staged sampler runs."""
    t, prev_t, previewing, keep = [], [], [], []
    for phase in build_step_phases(cfg):
        for i in range(len(phase["t"])):
            t.append(phase["t"][i])
            prev_t.append(phase["prev_t"][i])
            previewing.append(1.0 if phase["mode"] == "B" else 0.0)
            keep.append(1.0 if phase["mode"] in ("A", "B") else 0.0)
    return {
        "t": np.asarray(t, np.int32),
        "prev_t": np.asarray(prev_t, np.int32),
        "previewing": np.asarray(previewing, np.float32),
        "keep": np.asarray(keep, np.float32),
    }


class SlotSampler:
    """The slot programs for one (pipeline, RestoreConfig, bucket) triple:
    ``prelude`` (batch-1 encode into a slot payload), ``insert``, ``step``
    (one denoise step for every active slot) and ``extract_decode``.

    ``graphs`` (default: whether the pipeline is on a CUDA device) records
    each step variant as a CUDA graph; a CPU pipeline cannot, and a CUDA
    pipeline steps eagerly only when ``graphs=False`` is asked for."""

    def __init__(self, pipe, cfg: RestoreConfig, resolution: int, n_slots: int, graphs: Optional[bool] = None):
        if cfg.deepcache_interval > 1:
            raise ValueError("slot serving is exact-schedule only: deepcache caches are "
                             "cross-step state that per-slot staggering would corrupt; "
                             "use the whole-request batcher for --deepcache_interval")
        for flag in ("multistep_restore", "adastep_restore", "save_preview_row",
                     "fused", "sequence_parallel", "fuse_previewer_lora"):
            if getattr(cfg, flag):
                raise ValueError(f"slot serving does not support RestoreConfig.{flag}")
        if pipe._frozen is not None:
            raise ValueError("slot serving does not support freeze_previewer pipelines")
        on_card = pipe.device.type == "cuda"
        graphs = on_card if graphs is None else bool(graphs)
        if graphs and not on_card:
            raise RuntimeError(f"SlotSampler(graphs=True) records each step as a CUDA graph and needs a CUDA "
                               f"device; this pipeline is on {pipe.device}")

        self.pipe = pipe
        self.cfg = cfg
        self.resolution = int(resolution)
        self.n_slots = int(n_slots)
        self.graphs = graphs
        self.tables = build_step_tables(cfg)
        self.n_steps = len(self.tables["t"])
        self._t_first = int(inference_timesteps(cfg)[0])
        dev = pipe.device
        self._t = torch.tensor(self.tables["t"], dtype=torch.long, device=dev)
        self._prev_t = torch.tensor(self.tables["prev_t"], dtype=torch.long, device=dev)
        self._previewing = torch.tensor(self.tables["previewing"], device=dev)
        self._keep = torch.tensor(self.tables["keep"], device=dev)
        self._pool = None  # the step graphs' shared memory pool, made at the first recording

    # -- the step ----------------------------------------------------------

    def variant(self, host_idx: List[int]) -> Optional[str]:
        """The step program the active slots need (None: no slot is active):
        the previewer runs if any slot previews, the Aggregator if any slot
        has the controlnet on (a previewing slot always has)."""
        active = [i for i in host_idx if i < self.n_steps]
        if not active:
            return None
        if any(self.tables["previewing"][i] > 0 for i in active):
            return "previewer"
        if any(self.tables["keep"][i] > 0 for i in active):
            return "aggregator"
        return "plain"

    def _step_body(self, state: SlotState, variant: str):
        """One denoise step of every slot on the device, without host copies
        (so that it can be recorded): returns the new latents (idle slots
        keep theirs) and the new step indices."""
        pipe, cfg = self.pipe, self.cfg
        schedule = pipe.schedule
        do_cfg = cfg.do_cfg
        gs = cfg.guidance_scale
        share_preview = do_cfg and not cfg.preview_cfg
        share_cnet = do_cfg and not cfg.controlnet_cfg
        n = state.latents.shape[0]

        def double(x):
            return torch.cat([x, x], dim=0) if do_cfg else x

        act = state.step_idx < self.n_steps
        ii = state.step_idx.clamp(max=self.n_steps - 1)
        t, prev_t = self._t[ii], self._prev_t[ii]
        pv = self._previewing[ii] * act
        kp = self._keep[ii] * act

        latents = state.latents
        latent_in = double(latents)
        tb = double(t)
        prompt = torch.cat([state.prompt_u, state.prompt_c]) if do_cfg else state.prompt_c
        pooled = torch.cat([state.pooled_u, state.pooled_c]) if do_cfg else state.pooled_c
        time_ids = _time_ids(self.resolution, self.resolution, prompt.dtype, prompt.device).repeat(prompt.shape[0], 1)
        ip_base = torch.cat([state.ip_base_u, state.ip_base_c]) if do_cfg else state.ip_base_c
        ip_lora = torch.cat([state.ip_lora_u, state.ip_lora_c]) if do_cfg else state.ip_lora_c
        image_latent = double(state.image_latent)

        def unet(lat, tt, p, pp, tids, lora_scale, ip, residuals=None, mid=None):
            return pipe.unet(lat, tt, p, pp, tids, ip_hidden_states=ip, down_block_additional_residuals=residuals,
                             mid_block_additional_residual=mid, lora_scale=lora_scale)

        # the previewer (phase-B slots); the others condition on their LQ latent
        preview_latent = image_latent
        if variant == "previewer":
            if share_preview:
                p_noise = unet(latents, t, prompt[-n:], pooled[-n:], time_ids[-n:], cfg.lora_alpha, ip_lora[-n:])
                preview = double(lcm_single_step(schedule, p_noise, t, latents))
            else:
                p_noise = unet(latent_in, tb, prompt, pooled, time_ids, cfg.lora_alpha, ip_lora)
                preview = lcm_single_step(schedule, p_noise, tb, latent_in)
            preview_latent = torch.where(double(pv).reshape(-1, 1, 1, 1) > 0, preview, image_latent)

        # the Aggregator and the main UNet; controlnet-off slots zero their residuals
        if variant in ("previewer", "aggregator"):
            if share_cnet:
                down, mid = pipe.aggregator(image_latent[-n:], t, preview_latent[-n:].to(latents.dtype),
                                            pooled[-n:], time_ids[-n:])
                down, mid = tuple(double(r) for r in down), double(mid)
            else:
                down, mid = pipe.aggregator(image_latent, tb, preview_latent.to(latents.dtype), pooled, time_ids)
            cond_scale = double(kp * cfg.controlnet_conditioning_scale).reshape(-1, 1, 1, 1)
            down = tuple(r * cond_scale.to(r.dtype) for r in down)
            mid = mid * cond_scale.to(mid.dtype)
            noise_raw = unet(latent_in, tb, prompt, pooled, time_ids, 0.0, ip_base, down, mid)
        else:
            noise_raw = unet(latent_in, tb, prompt, pooled, time_ids, 0.0, ip_base)

        if do_cfg:
            uncond, text = noise_raw.chunk(2, dim=0)
            noise_pred = uncond + gs * (text - uncond)
            if cfg.guidance_rescale > 0.0:
                noise_pred = rescale_noise_cfg(noise_pred, text, cfg.guidance_rescale)
        else:
            noise_pred = noise_raw
        new_latents, _ = ddpm_step(schedule, noise_pred, t, prev_t, latents, state.noise)
        return torch.where(act.reshape(-1, 1, 1, 1), new_latents, latents), state.step_idx + act.long()

    def _record(self, state: SlotState, variant: str) -> "torch.cuda.CUDAGraph":
        """Record ``variant``'s step on ``state``'s tensors: a warm-up on a
        side stream (kernel attributes, library plans, per-device constants;
        it writes nothing), then the capture, in ``thread_local`` mode so that
        another thread's device-to-host copy cannot break it."""
        dev = self.pipe.device
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._step_body(state, variant)
        stream.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            latents, step_idx = self._step_body(state, variant)
            state.latents.copy_(latents)
            state.step_idx.copy_(step_idx)
        state.graphs[variant] = graph
        torch.cuda.empty_cache()  # the warm-up's blocks
        return graph

    @torch.no_grad()
    def step(self, state: SlotState, noise: Optional[torch.Tensor] = None) -> SlotState:
        """Advance every active slot by one denoise step, in place. ``noise``
        ``[N, 4, h, w]`` gives every slot's draw; without it each active slot
        draws from its own generator (``(h, w, 4)``, NHWC as ``restore``
        draws, so that a slot alone follows ``restore`` with that generator)."""
        variant = self.variant(state.host_idx)
        if variant is None:
            return state
        active = [i for i, k in enumerate(state.host_idx) if k < self.n_steps]
        if noise is not None:
            state.noise.copy_(noise)
        else:
            c, h, w = state.noise.shape[1:]
            for i in active:
                if state.generators[i] is None:
                    raise ValueError(f"slot {i} has no generator: pass its step noise")
                state.noise[i].copy_(_nchw(torch.randn((1, h, w, c), generator=state.generators[i],
                                                       dtype=torch.float32, device=state.noise.device))[0])
        if self.graphs:
            graph = state.graphs.get(variant)
            if graph is None:
                graph = self._record(state, variant)
            graph.replay()
        else:
            latents, step_idx = self._step_body(state, variant)
            state.latents.copy_(latents)
            state.step_idx.copy_(step_idx)
        for i in active:
            state.host_idx[i] += 1
        return state

    # -- per request -------------------------------------------------------

    @torch.no_grad()
    def prelude(self, image: torch.Tensor, prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
                negative_prompt_embeds: Optional[torch.Tensor] = None,
                negative_pooled_embeds: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, noise_vae: Optional[torch.Tensor] = None,
                noise_init: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """Encode ONE request (``[1, r, r, 3]`` in [-1, 1], NHWC) into a slot
        payload: the VAE posterior sample, DINOv2 -> Resampler tokens with
        LoRA off and on (the pipeline's cached uncond tokens), and the init
        latents at the first timestep; rows ``[1, ...]``, NCHW latents. The
        draws ``noise_vae`` / ``noise_init`` (NHWC fp32) come from
        ``generator`` (default: seeded with 0) when not given, in
        ``restore``'s order; the generator becomes the slot's stream."""
        pipe, cfg = self.pipe, self.cfg
        dev = pipe.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        f = vae_scale_factor(pipe.vae.config)
        lat = (1, self.resolution // f, self.resolution // f, pipe.vae.config.latent_channels)
        if noise_vae is None:
            noise_vae = torch.randn(lat, generator=generator, dtype=torch.float32, device=dev)
        if noise_init is None:
            noise_init = torch.randn(lat, generator=generator, dtype=torch.float32, device=dev)
        image = _dense(image, dev)
        pe, pooled = _dense(prompt_embeds, dev), _dense(pooled_embeds, dev)
        npe = torch.zeros_like(pe) if negative_prompt_embeds is None else _dense(negative_prompt_embeds, dev)
        npooled = torch.zeros_like(pooled) if negative_pooled_embeds is None else _dense(negative_pooled_embeds, dev)

        image_latent = pipe.encode_vae_image(image.float(), noise_vae.to(dev)).to(pe.dtype)
        uncond = pipe._uncond_tokens(pipe.image_encoder.config.image_size, image.dtype)
        dino_c, dino_u = pipe.encode_image_embeds((image + 1.0) / 2.0, uncond)
        tokens = torch.cat([dino_u, dino_c]) if cfg.do_cfg else dino_c
        ip_base = pipe.resampler(tokens, lora_scale=0.0)
        ip_lora = pipe.resampler(tokens, lora_scale=cfg.lora_alpha)
        t0 = torch.full((1,), self._t_first, dtype=torch.long, device=dev)
        latents = add_noise(pipe.schedule, image_latent, _nchw(noise_init.to(dev)), t0)
        if cfg.do_cfg:
            ip_base_u, ip_base_c = ip_base.chunk(2)
            ip_lora_u, ip_lora_c = ip_lora.chunk(2)
        else:
            ip_base_u = ip_base_c = ip_base
            ip_lora_u = ip_lora_c = ip_lora
        return {"latents": latents, "image_latent": image_latent, "prompt_u": npe, "prompt_c": pe,
                "pooled_u": npooled, "pooled_c": pooled, "ip_base_u": ip_base_u, "ip_base_c": ip_base_c,
                "ip_lora_u": ip_lora_u, "ip_lora_c": ip_lora_c, "generator": generator}

    def empty_state(self, payload: Dict[str, object]) -> SlotState:
        """An all-idle slot state shaped after one ``prelude`` payload (shapes
        and dtypes follow the model configs)."""
        n = self.n_slots
        rows = {k: torch.zeros((n,) + tuple(payload[k].shape[1:]), dtype=payload[k].dtype,
                               device=payload[k].device) for k in _PAYLOAD}
        return SlotState(**rows, noise=torch.zeros(rows["latents"].shape, dtype=torch.float32,
                                                   device=rows["latents"].device),
                         step_idx=torch.full((n,), self.n_steps, dtype=torch.long, device=rows["latents"].device),
                         host_idx=[self.n_steps] * n, generators=[None] * n)

    @torch.no_grad()
    def insert(self, state: SlotState, payload: Dict[str, object], slot: int) -> SlotState:
        """Write ``payload`` into row ``slot`` of the resident tensors and
        start the slot at step 0."""
        for k in _PAYLOAD:
            getattr(state, k)[slot].copy_(payload[k][0])
        state.step_idx[slot:slot + 1].fill_(0)
        state.host_idx[slot] = 0
        state.generators[slot] = payload["generator"]
        return state

    def evict(self, state: SlotState, slot: Optional[int] = None) -> SlotState:
        """Mark ``slot`` (every slot when None) idle."""
        slots = range(self.n_slots) if slot is None else (slot,)
        for i in slots:
            state.step_idx[i:i + 1].fill_(self.n_steps)
            state.host_idx[i] = self.n_steps
            state.generators[i] = None
        return state

    @torch.no_grad()
    def extract_decode(self, state: SlotState, slot: int) -> torch.Tensor:
        """A finished slot -> its ``[1, r, r, 3]`` image in [-1, 1] (a device
        tensor; the caller fetches it). The latents are copied out of the
        resident row before a later insert or step can overwrite it."""
        lat = state.latents[slot:slot + 1].clone()
        tiling = (self.cfg.vae_tile_latent, self.cfg.vae_tile_overlap) if self.cfg.vae_tiling else None
        return self.pipe.decode_latents(lat, _DECODE_DTYPES[self.cfg.decode_dtype], tiling)
