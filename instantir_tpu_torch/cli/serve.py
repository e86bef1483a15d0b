"""Serving entry point of the PyTorch/CUDA port: batched restoration over HTTP.

Twin of ``instantir_tpu/cli/serve.py``:

  * **request microbatching** -- concurrent requests are gathered into one
    device batch (up to the bucket's batch size, waiting at most
    ``batch_wait_ms`` for stragglers);
  * **static shapes** -- inputs are resized into fixed resolution buckets
    (``--resolutions 512,768,1024``; one bucket by default) and each batch is
    padded to exactly the bucket's batch size; a request routes to the
    smallest bucket that covers it;
  * **record at warmup** -- with ``ServeConfig.fused`` (the default) every
    bucket's restore is recorded as one CUDA graph (``RestoreConfig.fused``)
    before the server takes traffic, so a request replays a graph; the
    pipeline keeps one recording per bucket (``pipe.max_graphs``) and
    ``estimate_hbm_budget`` counts one memory pool per bucket;
  * **stdlib HTTP** (ThreadingHTTPServer) -- POST an image to ``/restore``,
    GET ``/healthz`` for liveness/readiness probes, GET ``/metrics`` for
    Prometheus-format counters and request-latency quantiles (the p50
    per-request latency serving metric).

``ContinuousRestoreServer`` batches by denoise step instead
(``pipeline/slots.py``).

``--mesh`` serves over a ``(data, model)`` mesh of one process per GPU
(``torchrun --nproc_per_node N ... --mesh --model_parallel M``): every rank
loads the pipeline and takes its place on the mesh (``pipe.shard``; a
``model`` axis of M > 1 is tensor parallelism); rank 0 runs the HTTP layer
and the server, and broadcasts each batch's inputs and settings over the
whole group before its restore (``lead_mesh``); every other rank runs
``follow_mesh``, which takes each broadcast and makes the same restore call,
until the drained leader broadcasts the stop. Each bucket's batch must
divide the ``data`` axis; ``--continuous`` with ``--mesh`` is refused, as
in the JAX package. A tensor-parallel server serves the staged restore
(``--fused`` is off by default there, and refused). The batching core is
transport-independent; the HTTP layer is a thin adapter over it. On a CPU
pipeline (tests) the servers need ``fused=False``; on a CUDA pipeline the
staged restore is served only when ``fused=False`` is asked for.

Usage (on the card; on several, ``torchrun --nproc_per_node N -m
instantir_tpu_torch.cli.serve ... --mesh --model_parallel M``):
  python -m instantir_tpu_torch.cli.serve --sdxl_path /path/sdxl \\
      --instantir_path /path/instantir --vision_encoder_path /path/dinov2 \\
      --resolutions 512,1024 --batch_sizes 2,1 --port 8000
  curl --data-binary @lq.png -o restored.png 'http://localhost:8000/restore?prompt=a+photo'
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import io
import json
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from instantir_tpu_torch.cli.infer import DEFAULT_NEG_PROMPT, DEFAULT_PROMPT
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise
from instantir_tpu_torch.pipeline.slots import SlotSampler


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 4          # device batch (pad-to-full; one recording per bucket)
    batch_wait_ms: float = 25.0  # max straggler wait once a request is queued
    resolution: int = 1024       # fixed resolution bucket (static shapes)
    # optional extra buckets (e.g. (512, 768, 1024)): each input routes to the
    # smallest bucket that covers it, so small images stop paying the largest
    # bucket's step cost
    resolutions: Tuple[int, ...] = ()
    # per-bucket device batch sizes, matched to sorted(resolutions); empty ->
    # every bucket uses ``batch_size``
    batch_sizes: Tuple[int, ...] = ()
    num_inference_steps: int = 30
    guidance_scale: float = 7.0
    preview_start: float = 0.1
    creative_start: float = 0.7  # maps to control_guidance_end
    shared_cfg: bool = False     # CFG single-pass control branch
    deepcache_interval: int = 1  # DeepCache block caching; 1 = exact
    deepcache_depth: int = 1
    seed: int = 42
    # step-level continuous batching (ContinuousRestoreServer): a resident
    # slot batch per bucket, per-slot timesteps, mid-flight refill
    continuous: bool = False
    tick_steps: int = 5          # denoise steps dispatched between scheduler decisions
    # refuse configs whose estimated device memory exceeds the card (a clear
    # startup error instead of a mid-traffic out-of-memory); override to experiment
    allow_overbudget: bool = False
    # device memory the budget may fill (GB); None: the CUDA device's total
    # less _HBM_RESERVE_GB. A CPU pipeline must give it
    limit_gb: Optional[float] = None
    # the restore (or each slot step) as CUDA graphs recorded at warmup; a
    # CPU pipeline needs False
    fused: bool = True


# Device-memory planning. _HBM_ACT_GB_PER_MPIX is the memory a bucket's
# recorded restore holds beyond the weights (its graph's private pool), per
# megapixel and image, with margin: with the bf16 SDXL-width models at 4
# steps and the fp32 VAE's GroupNorms on the fused kernel, on an NVIDIA H100
# 80GB HBM3 at 700 W (chip_smoke.py phase 4d), 8.76 GB at 1024² batch 1
# (8.35 per megapixel) and 3.61-3.88 GB at 512² batch 2 (6.88-7.40). A
# restore's peak allocation over the weights is smaller (4.64 and 2.31 GB),
# but a recording keeps its whole pool reserved.
# _HBM_RESERVE_GB is held back from the card's total memory: the CUDA
# context, cuBLAS and cuDNN workspaces, allocator slack, and the two SDXL text
# towers the CLI loads beside the pipeline (1.6 GB in bf16).
_HBM_ACT_GB_PER_MPIX = 9.5
_HBM_RESERVE_GB = 4.0


def _params_gb(pipe) -> float:
    models = [pipe.unet, pipe.aggregator, pipe.vae, pipe.resampler, pipe.image_encoder]
    n = sum(t.numel() * t.element_size() for m in models for t in (*m.parameters(), *m.buffers()))
    if pipe._frozen is not None:
        n += sum(t.numel() * t.element_size() for t in pipe._frozen.values())
    return n / 1e9


def estimate_hbm_budget(pipe, buckets, bucket_batch, allow_overbudget: bool = False,
                        limit_gb: Optional[float] = None) -> Dict:
    """Estimate the device memory of serving ``buckets`` (batch
    ``bucket_batch[r]`` each) and fail fast when it exceeds the card.

    Unlike the JAX twin, whose programs share one activation arena so that
    each bucket is checked alone, a recorded CUDA graph keeps a private
    memory pool of its restore's peak for as long as it is held, and the
    server holds one per bucket: the pools of all buckets coexist. The
    estimate is the weights plus the sum over buckets of
    ``_HBM_ACT_GB_PER_MPIX`` x megapixels x batch (the continuous server's
    step pools are smaller than a restore's, so the same rows bound them).
    ``limit_gb`` defaults to the CUDA device's total memory less
    ``_HBM_RESERVE_GB``; a CPU pipeline must pass it. Returns a report (the
    rows per bucket and the total); raises ``ValueError`` when the total is
    over the limit unless ``allow_overbudget``."""
    if limit_gb is None:
        if pipe.device.type != "cuda":
            raise ValueError(f"estimate_hbm_budget needs limit_gb for a pipeline on {pipe.device}: "
                             "only a CUDA device reports its memory")
        limit_gb = torch.cuda.get_device_properties(pipe.device).total_memory / 1e9 - _HBM_RESERVE_GB
    params_gb = _params_gb(pipe)
    rows = []
    for r in buckets:
        b = bucket_batch[r]
        act_gb = _HBM_ACT_GB_PER_MPIX * (r * r / 1e6) * b
        rows.append({"bucket": r, "batch": b, "act_gb": round(act_gb, 3)})
    total = params_gb + sum(row["act_gb"] for row in rows)
    fits = total <= limit_gb
    if not fits and not allow_overbudget:
        raise ValueError(
            f"serve config exceeds the estimated HBM budget: est {total:.1f} GB > {limit_gb:.1f} GB (params "
            f"{params_gb:.1f} + one recorded pool per bucket: "
            + ", ".join(f"{row['bucket']}² batch {row['batch']} {row['act_gb']:.1f}" for row in rows)
            + ")\nreduce the buckets or the per-bucket batch (--batch_sizes), or pass --allow_overbudget "
            "to try anyway")
    return {"params_gb": round(params_gb, 3), "rows": rows, "total_gb": round(total, 3),
            "limit_gb": round(limit_gb, 3), "fits": fits}


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A restored image in [-1, 1] -> uint8 (the twin's mapping)."""
    return ((np.clip(image, -1, 1) + 1) * 127.5).astype(np.uint8)


@dataclasses.dataclass
class _Request:
    image: np.ndarray            # [H, W, 3] float32 in [-1, 1] at bucket res
    prompt: str
    neg_prompt: str
    out_size: Tuple[int, int]    # (w, h) to resize the restored image back to
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    t_submit: float = 0.0        # monotonic enqueue time (latency metrics)
    bucket: int = 0              # resolution bucket this request routed to


class RestoreServer:
    """Microbatching executor around ``InstantIRPipeline.restore``.

    ``encode_fn(list[str]) -> (prompt_embeds, pooled_embeds)`` supplies text
    conditioning (the CLIP towers, or a stub in tests); the embeddings are
    cached per prompt on the pipeline's device in its models' dtype.
    Submissions block the calling thread until their batch completes; the
    single worker thread owns every device dispatch. The draws come from one
    ``torch.Generator`` on the pipeline's device seeded with ``cfg.seed``.
    """

    def __init__(self, pipe, encode_fn: Callable, cfg: ServeConfig = ServeConfig()):
        if cfg.fused and pipe.device.type != "cuda":
            raise RuntimeError(f"ServeConfig.fused=True serves CUDA graphs and needs a CUDA device; this pipeline "
                               f"is on {pipe.device} (pass fused=False to serve the staged restore)")
        self.pipe = pipe
        self.encode_fn = encode_fn
        self.cfg = cfg
        self.restore_cfg = RestoreConfig(
            num_inference_steps=cfg.num_inference_steps,
            guidance_scale=cfg.guidance_scale,
            preview_start=cfg.preview_start,
            control_guidance_end=cfg.creative_start,
            preview_cfg=not cfg.shared_cfg,
            controlnet_cfg=not cfg.shared_cfg,
            deepcache_interval=cfg.deepcache_interval,
            deepcache_depth=cfg.deepcache_depth,
            fused=cfg.fused,
        )
        # resolution buckets: per-bucket request queues plus one notify queue
        # of bucket ids (every submit adds exactly one token, every worker
        # iteration removes exactly one -- tokens >= pending requests, so an
        # empty notify queue proves every bucket queue is drained)
        self.buckets: Tuple[int, ...] = tuple(sorted(set(cfg.resolutions))) or (cfg.resolution,)
        if cfg.batch_sizes:
            if len(cfg.batch_sizes) != len(self.buckets):
                raise ValueError(
                    f"batch_sizes {cfg.batch_sizes} must match the {len(self.buckets)} "
                    f"resolution bucket(s) {self.buckets} (sorted ascending)"
                )
            self._bucket_batch: Dict[int, int] = dict(zip(self.buckets, cfg.batch_sizes))
        else:
            self._bucket_batch = {r: cfg.batch_size for r in self.buckets}
        # one recorded restore per bucket stays on the card (the budget counts them)
        pipe.max_graphs = len(self.buckets)
        self._queues: Dict[int, "queue.Queue[_Request]"] = {r: queue.Queue() for r in self.buckets}
        self._notify: "queue.Queue[int]" = queue.Queue()
        self._stop = threading.Event()
        self._closing = threading.Event()
        self._generator = torch.Generator(device=pipe.device).manual_seed(cfg.seed)
        self._dtype = next(pipe.unet.parameters()).dtype
        self._embed_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()
        self.batches_run = 0
        self.requests_served = 0
        # bounded latency windows (seconds): per-request end-to-end
        # (enqueue -> result ready, queue wait included) and per-batch
        # execute time (restore and fetch)
        self._request_latencies: collections.deque = collections.deque(maxlen=1024)
        self._batch_seconds: collections.deque = collections.deque(maxlen=256)
        self._worker = threading.Thread(target=self._run, name="restore-worker", daemon=True)
        self.warmup_report: List[Dict] = []  # per bucket: seconds and, on a CUDA device, memory

    # -- lifecycle ---------------------------------------------------------

    def _reset_counters(self):
        """Warmup is not traffic: report clean production counters."""
        self.batches_run = 0
        self.requests_served = 0
        self._request_latencies.clear()
        self._batch_seconds.clear()

    def start(self, warmup: bool = True):
        if warmup:
            self.warmup()
            self._reset_counters()
        self._worker.start()
        return self

    def stop(self):
        """Immediate stop: the worker exits after its current batch; any
        still-queued requests are failed so their waiters unblock."""
        self._closing.set()
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=600)
        for q in self._queues.values():
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                req.error = RuntimeError("server stopped")
                req.done.set()

    def drain(self, timeout: Optional[float] = 600):
        """Graceful shutdown: refuse new submissions, finish every queued
        request (in-flight batches included), then stop the worker."""
        self._closing.set()
        if self._worker.is_alive():
            self._worker.join(timeout)
        self.stop()

    def _budget(self) -> Dict:
        budget = estimate_hbm_budget(self.pipe, self.buckets, self._bucket_batch,
                                     allow_overbudget=self.cfg.allow_overbudget, limit_gb=self.cfg.limit_gb)
        print(f"[serve] HBM budget: {json.dumps(budget)}", flush=True)
        return budget

    def _warm_bucket(self, r: int, warm: Callable[[], None]):
        """Run ``warm`` for bucket ``r`` and append to ``warmup_report`` its
        wall seconds and, on a CUDA device, its peak allocation over what was
        allocated before (``peak_gb``), the memory it left reserved
        (``held_gb``: the bucket's recorded pools, what its budget row
        covers) and the memory reserved after it."""
        dev = self.pipe.device
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        warm()
        row = {"bucket": r, "batch": self._bucket_batch[r]}
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            row.update(peak_gb=(torch.cuda.max_memory_allocated(dev) - before) / 1e9,
                       held_gb=(torch.cuda.memory_reserved(dev) - reserved) / 1e9,
                       reserved_gb=torch.cuda.memory_reserved(dev) / 1e9)
        row["seconds"] = time.perf_counter() - t0
        self.warmup_report.append(row)
        print(f"[serve] warmed {json.dumps(row)}", flush=True)

    def warmup(self):
        """Record every bucket's full-batch restore (``fused``; staged, a
        first run) before accepting traffic, on the calling thread and
        before the worker starts. Prints the memory budget first and refuses
        over-budget configs (``estimate_hbm_budget``)."""
        self._budget()
        for r in self.buckets:
            reqs = [
                _Request(
                    image=np.zeros((r, r, 3), np.float32),
                    prompt=DEFAULT_PROMPT,
                    neg_prompt=DEFAULT_NEG_PROMPT,
                    out_size=(r, r),
                    bucket=r,
                )
                for _ in range(self._bucket_batch[r])
            ]
            self._warm_bucket(r, lambda reqs=reqs: self._execute(reqs))

    # -- request path ------------------------------------------------------

    def submit(self, image: np.ndarray, prompt: Optional[str] = None,
               neg_prompt: Optional[str] = None, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking restore of ONE image ([H,W,3] uint8 or float in [-1,1]).
        Thread-safe; concurrent callers share a device batch."""
        if self._closing.is_set():
            raise RuntimeError("server is draining — not accepting new requests")
        img, out_size, bucket = self._to_bucket(image)
        req = _Request(
            image=img,
            prompt=prompt or DEFAULT_PROMPT,
            neg_prompt=neg_prompt or DEFAULT_NEG_PROMPT,
            out_size=out_size,
            t_submit=time.monotonic(),
            bucket=bucket,
        )
        self._enqueue(req)
        if not req.done.wait(timeout):
            raise TimeoutError("restore request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def _enqueue(self, req: _Request):
        """Queue a prepared request on its bucket (requests built outside
        ``submit`` -- e.g. test fixtures -- default to the largest bucket)."""
        if req.bucket not in self._queues:
            req.bucket = self.buckets[-1]
        self._queues[req.bucket].put(req)
        self._notify.put(req.bucket)

    def _to_bucket(self, image: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int], int]:
        """Resize any input into a fixed resolution bucket -- the smallest
        that covers it (largest otherwise), Pillow's LANCZOS."""
        from PIL import Image

        if image.dtype == np.uint8:
            pil = Image.fromarray(image)
        else:
            pil = Image.fromarray(to_uint8(image))
        out_size = pil.size
        side = max(out_size)
        r = next((b for b in self.buckets if b >= side), self.buckets[-1])
        if pil.size != (r, r):
            pil = pil.resize((r, r), Image.LANCZOS)
        return np.asarray(pil, np.float32) / 127.5 - 1.0, out_size, r

    def _finish(self, req: _Request, image: np.ndarray, now: float):
        """Fulfil ``req`` with ``image`` ([r, r, 3] in [-1, 1]) resized back
        to the request's size."""
        from PIL import Image

        img = to_uint8(image)
        if (img.shape[1], img.shape[0]) != req.out_size:
            img = np.asarray(Image.fromarray(img).resize(req.out_size, Image.LANCZOS))
        req.result = img
        if req.t_submit:
            self._request_latencies.append(now - req.t_submit)
        req.done.set()

    # -- worker ------------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            try:
                bucket = self._notify.get(timeout=0.1)
            except queue.Empty:
                if self._closing.is_set():
                    return  # drained: no tokens => every bucket queue is empty
                continue
            try:
                first = self._queues[bucket].get_nowait()
            except queue.Empty:
                continue  # stale token: its request left in an earlier batch
            batch = [first]
            deadline = self.cfg.batch_wait_ms / 1000.0
            while len(batch) < self._bucket_batch[bucket]:
                try:
                    batch.append(self._queues[bucket].get(timeout=deadline))
                except queue.Empty:
                    break
            try:
                self._execute(batch)
            except Exception as e:  # noqa: BLE001 -- the worker must survive; every waiter gets the error
                for req in batch:
                    req.error = e
                    req.done.set()

    def _embeds(self, prompts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-prompt embedding cache -- production traffic reuses a handful
        of prompts; each novel prompt costs one pass of the text towers."""
        missing = sorted({p for p in prompts if p not in self._embed_cache})
        if missing:
            pe, pooled = self.encode_fn(missing)
            pe, pooled = (torch.as_tensor(x).to(device=self.pipe.device, dtype=self._dtype) for x in (pe, pooled))
            for i, p in enumerate(missing):
                self._embed_cache[p] = (pe[i], pooled[i])
        pe = torch.stack([self._embed_cache[p][0] for p in prompts])
        pooled = torch.stack([self._embed_cache[p][1] for p in prompts])
        return pe, pooled

    def _execute(self, batch: List[_Request]):
        n, full = len(batch), self._bucket_batch[batch[0].bucket]
        pad = full - n
        images = np.stack([r.image for r in batch] + [batch[-1].image] * pad)
        pe, pooled = self._embeds([r.prompt for r in batch] + [batch[-1].prompt] * pad)
        npe, npooled = self._embeds([r.neg_prompt for r in batch] + [batch[-1].neg_prompt] * pad)
        b, h, w, _ = images.shape

        with self._lock:
            noise = self.pipe.draw_noise(self.restore_cfg, b, h, w, self._generator)
        t0 = time.monotonic()
        out, _ = self.pipe.restore(
            torch.from_numpy(images), pe, pooled, negative_prompt_embeds=npe, negative_pooled_embeds=npooled,
            cfg=self.restore_cfg, noise=noise,
        )  # numpy: the device-to-host copy is the completion
        now = time.monotonic()
        self.batches_run += 1
        self.requests_served += n
        self._batch_seconds.append(now - t0)
        for i, req in enumerate(batch):
            self._finish(req, out[i], now)

    # -- observability -------------------------------------------------------

    @staticmethod
    def _quantiles(window) -> Dict[str, float]:
        xs = sorted(window)
        if not xs:
            return {}
        return {q: xs[min(len(xs) - 1, int(float(q) * len(xs)))] for q in ("0.5", "0.9", "0.99")}

    def stats(self) -> Dict:
        """Serving counters + latency quantiles over the recent window.
        Request latency is end-to-end (queue wait + batch wait + device);
        batch seconds is the execute+fetch time of one full batch."""
        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "queue_depth": sum(q.qsize() for q in self._queues.values()),
            "batch_size": self.cfg.batch_size,
            "resolution": self.cfg.resolution,
            "buckets": list(self.buckets),
            "bucket_batch_sizes": [self._bucket_batch[r] for r in self.buckets],
            "fused": self.cfg.fused,
            "request_latency_seconds": self._quantiles(self._request_latencies),
            "batch_seconds": self._quantiles(self._batch_seconds),
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of ``stats()`` (no client library)."""
        s = self.stats()
        lines = [
            "# TYPE instantir_requests_served_total counter",
            f"instantir_requests_served_total {s['requests_served']}",
            "# TYPE instantir_batches_run_total counter",
            f"instantir_batches_run_total {s['batches_run']}",
            "# TYPE instantir_queue_depth gauge",
            f"instantir_queue_depth {s['queue_depth']}",
            "# TYPE instantir_request_latency_seconds summary",
        ]
        for q, v in s["request_latency_seconds"].items():
            lines.append(f'instantir_request_latency_seconds{{quantile="{q}"}} {v:.4f}')
        lines.append("# TYPE instantir_batch_seconds summary")
        for q, v in s["batch_seconds"].items():
            lines.append(f'instantir_batch_seconds{{quantile="{q}"}} {v:.4f}')
        return "\n".join(lines) + "\n"


class ContinuousRestoreServer(RestoreServer):
    """Step-level continuous batching (iteration scheduling for diffusion
    restoration).

    Each bucket keeps a RESIDENT batch of ``batch_sizes[bucket]`` slots
    (``pipeline/slots.py``), every slot with its own step index and random
    stream. The scheduler loop round-robins buckets, each tick dispatching
    ``tick_steps`` denoise steps for the bucket's active slots; finished
    slots are decoded (batch 1: only finished work pays decode) and refilled
    from the queue mid-flight. A request enters the next tick instead of the
    next whole-batch boundary. A slot's trajectory is independent of what
    else occupies the batch, so this is a scheduling change, not an
    approximation. With ``fused`` every step variant of every bucket is a
    CUDA graph recorded at warmup. Decoded results go to a completer thread,
    which fetches them, so the scheduler thread does not wait on the fetch.
    Each slot's generator is seeded at admission from the server's.
    """

    def __init__(self, pipe, encode_fn: Callable, cfg: ServeConfig = ServeConfig()):
        super().__init__(pipe, encode_fn, cfg)
        slot_cfg = dataclasses.replace(self.restore_cfg, fused=False)  # graphs are the sampler's
        self.samplers: Dict[int, SlotSampler] = {
            r: SlotSampler(pipe, slot_cfg, r, self._bucket_batch[r], graphs=cfg.fused)
            for r in self.buckets
        }
        self._states: Dict[int, object] = {}
        self._slot_reqs: Dict[int, List[Optional[_Request]]] = {
            r: [None] * self._bucket_batch[r] for r in self.buckets
        }
        self.ticks_run = 0
        self._complete_q: "queue.Queue" = queue.Queue()
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="restore-completer", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True):
        if warmup:
            self.warmup()
            self._reset_counters()
        self._completer.start()
        self._worker.start()
        return self

    def _slot_generator(self) -> torch.Generator:
        """A new slot's generator, seeded from the server's under the lock."""
        with self._lock:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._generator,
                                     device=self._generator.device).item())
        return torch.Generator(device=self.pipe.device).manual_seed(seed)

    def warmup(self):
        """Per bucket: one request of zeros through every step of the
        schedule (recording each step variant it meets, before the worker and
        completer threads start) and the batch-1 decode, leaving the
        bucket's resident state idle. Budget-gated like the whole-request
        server."""
        self._budget()
        pe, pooled = self._embeds([DEFAULT_PROMPT])
        npe, npooled = self._embeds([DEFAULT_NEG_PROMPT])

        def warm(r: int):
            s = self.samplers[r]
            payload = s.prelude(torch.zeros((1, r, r, 3)), pe, pooled, npe, npooled,
                                generator=torch.Generator(device=self.pipe.device).manual_seed(0))
            state = self._states[r] = s.empty_state(payload)
            s.insert(state, payload, 0)
            for _ in range(s.n_steps):
                s.step(state)
            s.extract_decode(state, 0).cpu()

        for r in self.buckets:
            self._warm_bucket(r, lambda r=r: warm(r))

    def stop(self):
        super().stop()
        self._complete_q.put(None)
        if self._completer.is_alive():
            self._completer.join(timeout=60)

    # -- scheduler ---------------------------------------------------------

    def _refill(self, r: int) -> bool:
        """Admit queued requests into free slots of bucket ``r``."""
        s = self.samplers[r]
        admitted = False
        for slot in range(self._bucket_batch[r]):
            if self._slot_reqs[r][slot] is not None:
                continue
            try:
                req = self._queues[r].get_nowait()
            except queue.Empty:
                break
            try:
                pe, pooled = self._embeds([req.prompt])
                npe, npooled = self._embeds([req.neg_prompt])
                payload = s.prelude(torch.from_numpy(req.image[None]), pe, pooled, npe, npooled,
                                    generator=self._slot_generator())
                if r not in self._states:  # start(warmup=False): steps record lazily
                    self._states[r] = s.empty_state(payload)
                s.insert(self._states[r], payload, slot)
            except Exception as e:  # noqa: BLE001 -- fail THIS request; the batch survives
                req.error = e
                req.done.set()
                continue
            self._slot_reqs[r][slot] = req
            admitted = True
        return admitted

    def _run(self):
        while not self._stop.is_set():
            progressed = False
            for r in self.buckets:
                s = self.samplers[r]
                self._refill(r)
                active = [i for i, q_ in enumerate(self._slot_reqs[r]) if q_ is not None]
                if not active:
                    continue
                st = self._states[r]
                remaining = max(s.n_steps - st.host_idx[i] for i in active)
                k = min(self.cfg.tick_steps, remaining)
                t0 = time.monotonic()
                try:
                    for _ in range(k):
                        s.step(st)
                    # pacing sync: bounds the host's dispatch lead to one tick
                    # and checks the device agrees with the host's count
                    idx = st.step_idx.cpu().tolist()
                    self.ticks_run += 1
                    self._batch_seconds.append(time.monotonic() - t0)
                    for i in active:
                        if idx[i] != st.host_idx[i]:
                            raise RuntimeError(f"device step_idx {idx[i]} != host {st.host_idx[i]}")
                        if st.host_idx[i] >= s.n_steps:
                            req = self._slot_reqs[r][i]
                            img = s.extract_decode(st, i)  # dispatched; the completer fetches
                            self._slot_reqs[r][i] = None
                            self.requests_served += 1
                            self._complete_q.put((req, img))
                except Exception as e:  # noqa: BLE001 -- fail the bucket's requests, keep serving
                    for i in active:
                        req = self._slot_reqs[r][i]
                        if req is not None:
                            req.error = e
                            req.done.set()
                            self._slot_reqs[r][i] = None
                    s.evict(st)
                    continue
                progressed = True
            if not progressed:
                if self._closing.is_set() and not self._pending():
                    return
                try:
                    self._notify.get(timeout=0.05)
                except queue.Empty:
                    pass

    def _pending(self) -> bool:
        return any(q.qsize() for q in self._queues.values()) or any(
            req is not None for reqs in self._slot_reqs.values() for req in reqs
        ) or not self._complete_q.empty()

    def _complete_loop(self):
        """Fetch decoded images and fulfil requests -- off the scheduler
        thread, so stepping never waits on the fetch or the resize."""
        while True:
            item = self._complete_q.get()
            if item is None:
                return
            req, image = item
            try:
                self._finish(req, image.float().cpu().numpy()[0], time.monotonic())
            except Exception as e:  # noqa: BLE001 -- the request fails, the completer lives on
                req.error = e
                req.done.set()

    def stats(self) -> Dict:
        s = super().stats()
        s["mode"] = "continuous"
        s["tick_steps"] = self.cfg.tick_steps
        s["ticks_run"] = self.ticks_run
        s["slot_occupancy"] = {
            str(r): sum(1 for q_ in reqs if q_ is not None)
            for r, reqs in self._slot_reqs.items()
        }
        return s


# ---------------------------------------------------------------------------
# HTTP layer (stdlib; POST image bytes -> PNG response)
# ---------------------------------------------------------------------------


def make_http_server(server: RestoreServer, host: str = "0.0.0.0", port: int = 8000):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._reply(200, json.dumps({"ok": True, **server.stats()}).encode(), "application/json")
            elif path == "/metrics":
                self._reply(200, server.metrics_text().encode(), "text/plain; version=0.0.4")
            else:
                self.send_error(404)

        def do_POST(self):
            from PIL import Image

            url = urlparse(self.path)
            if url.path != "/restore":
                self.send_error(404)
                return
            q = parse_qs(url.query)
            data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                out = server.submit(
                    img,
                    prompt=q.get("prompt", [None])[0],
                    neg_prompt=q.get("neg_prompt", [None])[0],
                    timeout=float(q.get("timeout", [600])[0]),
                )
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                self._reply(200, buf.getvalue(), "image/png")
            except Exception as e:  # noqa: BLE001 -- the client gets the error, the server lives on
                self._reply(500, json.dumps({"error": str(e)}).encode(), "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def _broadcast_call(pipe, header: Optional[dict], tensors: List[Optional[torch.Tensor]]) -> None:
    """Rank 0's side of one mesh call: ``header`` (None: stop) as an object,
    then every given tensor, over the whole group."""
    import torch.distributed as dist

    if header is not None:
        tensors = [None if t is None else t.to(pipe.device).contiguous() for t in tensors]
        header = dict(header, specs=[None if t is None else (tuple(t.shape), t.dtype) for t in tensors])
    dist.broadcast_object_list([header], src=0)
    for t in tensors if header is not None else ():
        if t is not None:
            dist.broadcast(t, src=0)


def lead_mesh(pipe) -> None:
    """Rank 0 of a serving mesh: from now on every ``pipe.restore`` call
    (the server's, warmup included) first broadcasts its inputs, draws and
    ``RestoreConfig`` over the whole group, so that the followers make the
    same call (``follow_mesh``). ``stop_mesh`` ends them."""
    restore = pipe.restore

    def broadcast_restore(lq_images, prompt_embeds, pooled_embeds, negative_prompt_embeds=None,
                          negative_pooled_embeds=None, cfg: RestoreConfig = RestoreConfig(), generator=None,
                          noise: Optional[RestoreNoise] = None, reference_latents=None, output_type: str = "np"):
        if noise is None:  # the followers need the draws themselves: draw them here
            b, h, w, _ = lq_images.shape
            noise = pipe.draw_noise(cfg, b, h, w, generator or torch.Generator(device=pipe.device).manual_seed(0))
        tensors = [lq_images, prompt_embeds, pooled_embeds, negative_prompt_embeds, negative_pooled_embeds,
                   reference_latents, noise.vae, noise.init, *noise.steps]
        _broadcast_call(pipe, {"cfg": cfg, "output_type": output_type}, tensors)
        return restore(lq_images, prompt_embeds, pooled_embeds, negative_prompt_embeds, negative_pooled_embeds,
                       cfg=cfg, noise=noise, reference_latents=reference_latents, output_type=output_type)

    pipe.restore = broadcast_restore


def stop_mesh(pipe) -> None:
    """Rank 0: tell the followers to stop (after the server drained)."""
    _broadcast_call(pipe, None, [])


def follow_mesh(pipe) -> int:
    """A rank other than 0 of a serving mesh: make each restore call rank 0
    broadcasts, until it broadcasts the stop. Returns the calls made."""
    import torch.distributed as dist

    calls = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        header = box[0]
        if header is None:
            return calls
        tensors = [None if spec is None else torch.empty(spec[0], dtype=spec[1], device=pipe.device)
                   for spec in header["specs"]]
        for t in tensors:
            if t is not None:
                dist.broadcast(t, src=0)
        lq, pe, pooled, npe, npooled, ref, vae, init, *steps = tensors
        pipe.restore(lq, pe, pooled, npe, npooled, cfg=header["cfg"], noise=RestoreNoise(vae=vae, init=init, steps=steps),
                     reference_latents=ref, output_type=header["output_type"])
        calls += 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="InstantIR serving (PyTorch/CUDA port)")
    p.add_argument("--sdxl_path", type=str, required=True)
    p.add_argument("--instantir_path", type=str, required=True)
    p.add_argument("--vision_encoder_path", type=str, required=True)
    p.add_argument("--adapter_model_path", type=str, default=None)
    p.add_argument("--previewer_lora_path", type=str, default=None)
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--batch_wait_ms", type=float, default=25.0)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--resolutions", type=str, default=None,
                   help="comma-separated resolution buckets (e.g. 512,768,1024): "
                   "each request routes to the smallest bucket covering it; one "
                   "recorded restore per bucket, all recorded at warmup")
    p.add_argument("--batch_sizes", type=str, default=None,
                   help="comma-separated per-bucket device batch sizes, matched "
                   "to the sorted --resolutions (e.g. 2,1 with 512,1024)")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--cfg", type=float, default=7.0)
    p.add_argument("--preview_start", type=float, default=0.1)
    p.add_argument("--creative_start", type=float, default=0.7)
    p.add_argument("--shared_cfg", action="store_true")
    p.add_argument("--deepcache_interval", type=int, default=1,
                   help="DeepCache block caching: refresh cadence (1 = exact)")
    p.add_argument("--deepcache_depth", type=int, default=1)
    p.add_argument("--fused", action=argparse.BooleanOptionalAction, default=None,
                   help="serve CUDA graphs recorded at warmup (the restore per bucket, or each slot step "
                   "variant); --no-fused serves the staged restore (default: fused, staged under "
                   "--model_parallel > 1, which does not record a graph)")
    p.add_argument("--quantized", nargs="?", const="w8a8", default=None, choices=("w8a8", "w8"),
                   help="int8 UNet+Aggregator: 'w8a8' (dynamic activation quant, int8 products) or 'w8' "
                   "(weight-only: weights dequantized at use, half the weight bytes)")
    p.add_argument("--continuous", action="store_true",
                   help="step-level continuous batching: resident slot batch per "
                   "bucket, per-slot timesteps, mid-flight refill. Exact schedule "
                   "only (no --deepcache_interval)")
    p.add_argument("--tick_steps", type=int, default=5,
                   help="with --continuous: denoise steps dispatched between "
                   "scheduler decisions (admission/finish cadence)")
    p.add_argument("--allow_overbudget", action="store_true",
                   help="skip the fail-fast device-memory budget check at warmup")
    p.add_argument("--limit_gb", type=float, default=None,
                   help="device memory the budget may fill (default: the card's total less a reserve)")
    p.add_argument("--mesh", action="store_true",
                   help="serve over a (data, model) mesh of one process per GPU (launch with torchrun "
                   "--nproc_per_node N): each bucket's batch shards over the data axis (it must divide it); rank 0 "
                   "serves HTTP and broadcasts each batch to the other ranks")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="with --mesh: tensor-parallel axis size (ranks = data x model): attention/MLP weights and "
                   "resnet/sampler conv channels split over the model axis (parallel/tp.py), cutting each GPU's "
                   "weight bytes; served staged (--fused is refused)")
    return p


def serve_config(args: argparse.Namespace) -> ServeConfig:
    """The flags as a ``ServeConfig``."""
    return ServeConfig(
        batch_size=args.batch_size, batch_wait_ms=args.batch_wait_ms,
        resolution=args.resolution,
        resolutions=tuple(int(r) for r in args.resolutions.split(",")) if args.resolutions else (),
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")) if args.batch_sizes else (),
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.cfg, preview_start=args.preview_start,
        creative_start=args.creative_start, shared_cfg=args.shared_cfg,
        deepcache_interval=args.deepcache_interval, deepcache_depth=args.deepcache_depth,
        continuous=args.continuous, tick_steps=args.tick_steps,
        allow_overbudget=args.allow_overbudget, limit_gb=args.limit_gb,
        fused=args.model_parallel == 1 if args.fused is None else args.fused,
    )


def main(argv: Optional[List[str]] = None, device="cuda"):
    from instantir_tpu_torch.cli.infer import encode_prompts
    from instantir_tpu_torch.parallel import initialize_distributed
    from instantir_tpu_torch.pipeline.load import load_instantir_pipeline, load_text_encoders

    args = build_parser().parse_args(argv)
    if args.model_parallel != 1 and not args.mesh:
        raise SystemExit("--model_parallel needs --mesh")
    if args.model_parallel > 1 and args.fused:
        raise SystemExit("--fused does not compose with --model_parallel > 1 yet (the tensor-parallel restore is "
                         "not recorded as a CUDA graph): serve with --no-fused")
    if args.mesh and args.continuous:
        raise SystemExit("--continuous does not compose with --mesh yet; scale continuous serving with one server "
                         "process per GPU (pipeline/slots.py)")
    initialize_distributed(device=device)  # a no-op without torchrun
    mesh = None
    if args.mesh:
        from instantir_tpu_torch.parallel import make_mesh
        from instantir_tpu_torch.parallel.mesh import axis_size

        mesh = make_mesh(model_parallel=args.model_parallel, device=device)
        # each bucket's batch must divide the mesh data axis, or its first restore raises: check up front
        data_size = axis_size(mesh, "data")
        cfg = serve_config(args)
        buckets = tuple(sorted(set(cfg.resolutions))) or (cfg.resolution,)
        batches = cfg.batch_sizes or (cfg.batch_size,) * len(buckets)
        for r, b in zip(buckets, batches):
            if b % data_size:
                raise SystemExit(f"--mesh: bucket {r}² batch {b} does not divide the mesh data axis ({data_size} "
                                 "ranks); adjust --batch_sizes/--batch_size")
    pipe = load_instantir_pipeline(
        args.sdxl_path, args.instantir_path,
        vision_encoder_path=args.vision_encoder_path,
        adapter_path=args.adapter_model_path,
        previewer_lora_path=args.previewer_lora_path,
        device=device,
    )
    if args.quantized:
        pipe.quantize(weight_only=args.quantized == "w8")
    if mesh is not None:
        import torch.distributed as dist

        pipe.shard(mesh)
        if dist.get_rank() != 0:
            calls = follow_mesh(pipe)
            print(f"[serve] rank {dist.get_rank()}: stopped after {calls} restore call(s)", flush=True)
            return
        lead_mesh(pipe)
    encoders = load_text_encoders(args.sdxl_path, device=device)

    def encode(prompts: List[str]):
        return encode_prompts(encoders, prompts, pipe.device)

    cfg = serve_config(args)
    server_cls = ContinuousRestoreServer if args.continuous else RestoreServer
    try:
        server = server_cls(pipe, encode, cfg).start(warmup=True)
        httpd = make_http_server(server, args.host, args.port)
    except BaseException:
        if mesh is not None:  # the followers wait for a broadcast: release them
            stop_mesh(pipe)
        raise

    # SIGTERM (preemption / redeploy) and SIGINT drain gracefully: stop
    # accepting connections, finish every accepted request, then exit
    import signal

    def _graceful(signum, frame):
        print(f"[serve] signal {signum}: draining...", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    buckets = ", ".join(f"{r}² batch {server._bucket_batch[r]}" for r in server.buckets)
    print(f"[serve] ready on {args.host}:{args.port} ({buckets}, "
          f"{'CUDA graphs' if cfg.fused else 'staged'}, {pipe.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.drain()
        if mesh is not None:
            stop_mesh(pipe)
        print(f"[serve] drained: {server.requests_served} request(s) served", flush=True)


if __name__ == "__main__":
    main()
