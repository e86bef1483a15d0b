"""What the trainers share: parameter selection, LR schedules, AdamW, timestep
draws, the EMA helpers, the degradation dispatch, batch prefetching,
preemption, checkpoints, the tracker and the trainer frame with its host loop.

Twin of ``instantir_tpu/train/common.py`` in PyTorch idiom: a path predicate
sets ``requires_grad`` on named parameters (in place of partitioned pytrees),
``torch.optim.AdamW`` with optax's global-norm clip and schedule semantics
stands in for the optax chain, and the EMA helpers work on dicts of name ->
tensor. Orbax is replaced by ``CheckpointManager`` (one ``torch.save`` of
CPU tensors per ``checkpoint-{step}/``), tensorboardX by ``EventWriter``
(TensorBoard event files written by hand: TFRecord framing, masked CRC-32C,
the ``Event`` protobuf encoded here). ``Trainer`` holds what the JAX
``Stage1Trainer``, ``Stage2Trainer`` and ``PreviewerTrainer`` repeat,
``run`` (with the validation renders every ``validation_steps``) and
``resume`` included. ``make_adamw(use_8bit=True)`` is the blockwise-int8
``train/adam8bit.py``; ``quantize_frozen_unet`` stores the frozen UNet's
bases as W8 (``ops/quant.py``).

Data parallelism (the JAX trainers' ``mesh="auto"``) runs one process per GPU
over ``torch.distributed`` (``parallel/mesh.py``): ``resolve_mesh`` takes the
launched group's ``data`` axis, each rank steps on its rows of the global
batch with its rows of the global batch's draws, and where the JAX program
gets a ``psum`` from its shardings the port makes the collectives explicit:
after the backward the mean of every gradient over the data axis
(``all_reduce_mean``, flat buckets by dtype), so that the clip sees the
global norm and accumulation the global mean; the metrics' means likewise;
ZeRO-1 (``shard_optimizer_state``) in the optimisers, each rank updating its
``zero1_spec`` shard of the moments and all-gathering the parameters; and
checkpoints gathered to rank 0, which alone writes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import re
import shutil
import signal
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from instantir_tpu_torch.data.degradation import RealESRGANDegradation
from instantir_tpu_torch.losses import build_losses
from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
from instantir_tpu_torch.parallel import mesh as pmesh
from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule

PathPred = Callable[[Tuple[str, ...]], bool]


def named_parameters(models: Dict[str, nn.Module]) -> Dict[str, nn.Parameter]:
    """``{"<model>.<parameter name>": parameter}`` over a dict of models."""
    return {f"{top}.{name}": p for top, model in models.items() for name, p in model.named_parameters()}


def set_trainable(models: Dict[str, nn.Module], pred: PathPred) -> List[str]:
    """Set ``requires_grad`` on every parameter from ``pred`` applied to its
    path ``(model, *name.split("."))``; returns the trainable names. The
    frozen majority then never enters the backward pass's parameter gradients."""
    trainable = []
    for full, p in named_parameters(models).items():
        on = bool(pred(tuple(full.split("."))))
        p.requires_grad_(on)
        if on:
            trainable.append(full)
    return trainable


def fp32_cpu(t: torch.Tensor) -> torch.Tensor:
    """An fp32 copy on the CPU (an export's leaf)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def count_params(params: Iterable[torch.Tensor]) -> int:
    return int(sum(p.numel() for p in params))


def lr_schedule(name: str, base_lr: float, warmup_steps: int = 0, total_steps: int = 1_000_000) -> Callable[[int], float]:
    """constant | cosine with linear warm-up from 0, as a function of the
    number of updates already made (the first update of a warmed-up schedule
    therefore has learning rate 0, as in the JAX package)."""
    if name == "constant":
        def main(step: int) -> float:
            return base_lr
    elif name == "cosine":
        decay_steps = max(total_steps - warmup_steps, 1)

        def main(step: int) -> float:
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * min(max(step, 0), decay_steps) / decay_steps))
    else:
        raise ValueError(f"unknown lr schedule {name}")
    if warmup_steps <= 0:
        return main

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return main(step - warmup_steps)

    return schedule


# values a rank of one flat bucket of a ZeRO-1 gather or a gradient all-reduce (256 MB in fp32)
GATHER_BUCKET = 1 << 26


def _buckets(tensors: List[torch.Tensor]) -> Iterator[Tuple[int, int]]:
    """``[i, j)`` runs of ``tensors`` of at most ``GATHER_BUCKET`` values (a larger tensor is a run of its own)."""
    i = 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (j == i or size + tensors[j].numel() <= GATHER_BUCKET):
            size += tensors[j].numel()
            j += 1
        yield i, j
        i = j


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, fp32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


class ClippedAdamW:
    """``torch.optim.AdamW`` behind optax's ``clip_by_global_norm`` and
    learning-rate schedule: ``step(grads)`` scales the gradients by
    ``max_norm / max(norm, max_norm)``, applies AdamW (decoupled decay, eps
    outside the root, bias correction) with the schedule evaluated at the
    number of updates made so far, and returns the norm before clipping.

    A leaf narrower than fp32 (a bf16 model's) trains through an fp32 master
    copy, as the JAX trainers train fp32 parameters under bf16 compute: the
    norm, the clip and the AdamW update (fp32 moments) are taken in fp32 on
    the master, whose rounding is then written back into the leaf -- the value
    the JAX modules cast their fp32 parameters to at each use. ``masters[i]``
    is ``params[i]`` itself for an fp32 leaf.

    With a ``mesh`` (ZeRO-1) the masters stay whole on every rank (the JAX
    trainers' replicated fp32 parameters) and the AdamW state is sharded:
    each leaf's update runs on this rank's slice of its ``zero1_spec`` axis
    (``shards[i]``, a copy of that slice; a leaf the data size does not
    divide updates whole on every rank), and the updated slices are
    all-gathered into the masters. The update is elementwise, so every value
    equals the unsharded optimiser's."""

    def __init__(self, params: List[nn.Parameter], lr: Union[Callable[[int], float], float], weight_decay: float,
                 b1: float, b2: float, eps: float, max_grad_norm: Optional[float], mesh=None):
        self.params = list(params)
        self.masters = [p if p.dtype == torch.float32 else p.detach().float().clone() for p in self.params]
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mesh = mesh
        self.axes = [None if mesh is None else pmesh.zero1_spec(m.shape, mesh) for m in self.masters]
        self.shards = [m if a is None else pmesh.zero1_shard(m, mesh).detach().clone()
                       for m, a in zip(self.masters, self.axes)]
        self.optimizer = torch.optim.AdamW(self.shards, lr=self.schedule(0), betas=(b1, b2), eps=eps,
                                           weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm = global_norm(grads)
        factor = None
        if self.max_grad_norm is not None:
            factor = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
        for s, m, g in zip(self.shards, self.masters, grads):  # one fp32 gradient at a time: no second copy of them all
            g = g.float()
            if s is not m:
                g = pmesh.zero1_shard(g, self.mesh).contiguous()
            s.grad = g if factor is None else g * factor
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is not None:
            sharded = [i for i, a in enumerate(self.axes) if a is not None]
            for i, full in zip(sharded, self._gather([self.shards[i] for i in sharded], sharded)):
                self.masters[i].copy_(full)
        for p, m in zip(self.params, self.masters):
            if m is not p:
                p.copy_(m)
        self.count += 1
        return norm

    def _gather(self, shards: List[torch.Tensor], leaves: List[int]) -> Iterator[torch.Tensor]:
        """The whole leaves ``leaves`` from every rank's ``shards`` of them
        (each cut on its ``zero1_spec`` axis): all-gathers of flat buckets of
        at most ``GATHER_BUCKET`` values a rank."""
        n, group = pmesh.axis_size(self.mesh), pmesh.axis_group(self.mesh)
        for i, j in _buckets(shards):
            flat = torch.cat([t.reshape(-1) for t in shards[i:j]])
            out = flat.new_empty(n * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=group)
            out = out.view(n, flat.numel())
            off = 0
            for t, leaf in zip(shards[i:j], leaves[i:j]):
                parts = out[:, off:off + t.numel()].reshape((n,) + tuple(t.shape))  # [rank, shard]
                yield parts.movedim(0, self.axes[leaf]).reshape(self.masters[leaf].shape)
                off += t.numel()

    def state_by_name(self, names: List[str]) -> Dict[str, Any]:
        """The optimiser's state under the leaves' ``names``: the update
        count and each master's AdamW state (``step``, ``exp_avg``,
        ``exp_avg_sq``; absent before its first update), whole: under
        ZeRO-1 the moments are all-gathered (every rank takes part)."""
        state = self.optimizer.state
        out = {n: dict(state[s]) for n, s in zip(names, self.shards) if s in state}
        sharded = [i for i, (a, s) in enumerate(zip(self.axes, self.shards)) if a is not None and s in state]
        for key in ("exp_avg", "exp_avg_sq"):
            for i, full in zip(sharded, self._gather([state[self.shards[i]][key] for i in sharded], sharded)):
                out[names[i]][key] = full
        return {"count": self.count, "adamw": out}

    @torch.no_grad()
    def load_state_by_name(self, names: List[str], state: Dict[str, Any]) -> None:
        """Put back a copy of ``state_by_name``'s result; the moments move to
        each master's device, ``step`` stays where ``torch.optim`` keeps it."""
        if "adamw" not in state:
            raise RuntimeError("this checkpoint holds 8-bit Adam moments: it was written with --use_8bit_adam; "
                               "resume it with --use_8bit_adam, or resume from the exported weights with a fresh "
                               "optimizer")
        self.count = int(state["count"])
        for n, m, sh, a in zip(names, self.masters, self.shards, self.axes):
            s = state["adamw"].get(n)
            if s is None:
                self.optimizer.state.pop(sh, None)
            else:
                self.optimizer.state[sh] = {
                    k: (v.clone() if k == "step" else
                        (v if a is None else pmesh.zero1_shard(v, self.mesh)).to(m.device, copy=True))
                    for k, v in s.items()}

    @torch.no_grad()
    def load_masters(self, masters: List[torch.Tensor]) -> None:
        """Copy ``masters`` into the fp32 masters (and their ZeRO-1 shards) and
        write each one's rounding back into its leaf."""
        for p, m, s, v in zip(self.params, self.masters, self.shards, masters):
            m.copy_(v)
            if s is not m:
                s.copy_(pmesh.zero1_shard(m, self.mesh))
            if m is not p:
                p.copy_(m)


def make_adamw(
    params: List[nn.Parameter],
    lr: Union[Callable[[int], float], float],
    weight_decay: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    max_grad_norm: Optional[float] = 1.0,
    use_8bit: bool = False,
    mesh=None,
):
    """``ClippedAdamW``, or with ``use_8bit`` the blockwise-int8 ``AdamW8bit``
    (the reference's optional ``bnb.optim.AdamW8bit``), which has its
    interface; with a ``mesh`` their state is ZeRO-1 sharded over its data axis."""
    if use_8bit:
        from instantir_tpu_torch.train.adam8bit import AdamW8bit

        return AdamW8bit(params, lr, weight_decay, b1, b2, eps, max_grad_norm, mesh=mesh)
    return ClippedAdamW(params, lr, weight_decay, b1, b2, eps, max_grad_norm, mesh=mesh)


def quantize_frozen_unet(unet: nn.Module, keep_pred: Optional[PathPred] = None) -> nn.Module:
    """QLoRA-style weight-only int8 storage of the frozen UNet during
    training, twin of the JAX ``quantize_frozen_unet`` (arXiv 2305.14314: a
    quantized frozen base, fp adapters): every LoRA base weight of at least
    ``ops.quant.DEFAULT_MIN_SIZE`` values becomes W8 (``weight_qw``), in place,
    dequantized to the compute dtype at each use, so gradients still flow
    through the UNet to what trains upstream (the stage-2 Aggregator).
    ``keep_pred``, a trainable-path predicate over ``("unet", *module path)``,
    keeps trained bases (the ip projections) in fp. The replaced bf16 weights
    are freed unless the caller holds them."""
    from instantir_tpu_torch.ops.quant import quantize_tree

    exclude = None
    if keep_pred is not None:
        exclude = lambda path: keep_pred(("unet",) + tuple(path))  # noqa: E731
    return quantize_tree(unet, weight_only=True, exclude=exclude)


@dataclasses.dataclass(frozen=True)
class RankRows:
    """The generator of a data-parallel rank's step: ``generator`` (the same
    stream on every rank) draws the global batch, of ``size`` times the
    rank's rows, and the rank keeps its rows, so that a step's draws do not
    depend on how many ranks share the batch."""

    generator: torch.Generator
    rank: int
    size: int

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0] // self.size
        return t[self.rank * b:(self.rank + 1) * b]


def _drawn(draw, batch: int, generator):
    """``draw(global batch, generator)``, this rank's rows of it for a ``RankRows``."""
    if isinstance(generator, RankRows):
        return generator.rows(draw(batch * generator.size, generator.generator))
    return draw(batch, generator)


def normal_draw(given: Optional[torch.Tensor], shape, generator, device) -> torch.Tensor:
    """``given`` on ``device``, or an fp32 standard-normal draw of ``shape`` from ``generator``."""
    if given is not None:
        return given.to(device)
    return _drawn(lambda b, g: torch.randn((b,) + tuple(shape[1:]), generator=g, dtype=torch.float32,
                                           device=device), shape[0], generator)


def uniform_draw(given: Optional[torch.Tensor], batch: int, generator, device) -> torch.Tensor:
    """``given`` as ``[batch]`` on ``device``, or ``batch`` fp32 uniforms in [0, 1) from ``generator``."""
    if given is not None:
        return given.to(device).reshape(batch)
    return _drawn(lambda b, g: torch.rand((b,), generator=g, dtype=torch.float32, device=device), batch, generator)


def randint_draw(high: int, batch: int, generator, device) -> torch.Tensor:
    """``batch`` integers uniform in [0, high) from ``generator``."""
    return _drawn(lambda b, g: torch.randint(0, high, (b,), generator=g, device=device), batch, generator)


def sample_timesteps(generator, batch: int, num_train_timesteps: int,
                     importance_weights=None, device=None) -> torch.Tensor:
    """Uniform or importance-weighted t ~ p(t), int64 ``[batch]``."""
    if importance_weights is None:
        return randint_draw(num_train_timesteps, batch, generator, device)
    probs = torch.as_tensor(importance_weights, dtype=torch.float32, device=device)
    return _drawn(lambda b, g: torch.multinomial(probs, b, replacement=True, generator=g), batch, generator)


# ---------------------------------------------------------------------------
# data parallelism (twins of the JAX trainers' mesh helpers)
# ---------------------------------------------------------------------------


def resolve_mesh(mesh, batch_size: int, device="cuda"):
    """A trainer's mesh argument: None -> no mesh; a mesh is kept (its data
    axis must divide ``batch_size``), one of one rank too; ``"auto"`` (every
    trainer's default, the analogue of accelerate's implicit DDP wrap) -> the
    launched group's ``data`` axis when a process group exists or a launcher
    started this process (``torchrun``), it has more than one rank and its
    size divides ``batch_size``, else no mesh (the JAX rule: a group of one
    trains as a single process, with no collective)."""
    if mesh is None:
        return None
    if mesh != "auto":
        if batch_size % pmesh.axis_size(mesh):
            raise ValueError(f"train_batch_size={batch_size} not divisible by mesh data axis "
                             f"{pmesh.axis_size(mesh)}")
        return mesh
    if not dist.is_initialized() and not pmesh.launched():
        return None
    if not pmesh.initialize_distributed(device=device):
        return None
    n = dist.get_world_size()
    if n <= 1 or batch_size % n:
        return None
    return pmesh.make_mesh(device=device)


@torch.no_grad()
def all_reduce_mean(tensors: List[torch.Tensor], mesh) -> None:
    """Each tensor <- its mean over the mesh's data axis, in place: flat fp32
    buckets of at most ``GATHER_BUCKET`` values, one a dtype at a time (a
    bf16 gradient is summed in fp32 and its mean rounded back)."""
    n = pmesh.axis_size(mesh)
    group = pmesh.axis_group(mesh)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        for i, j in _buckets(ts):
            flat = torch.cat([t.reshape(-1).float() for t in ts[i:j]])
            dist.all_reduce(flat, group=group)
            flat /= n
            off = 0
            for t in ts[i:j]:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


# ---------------------------------------------------------------------------
# EMA (dicts of name -> tensor; in place, where the JAX package returns new trees)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], decay: float) -> None:
    """``ema <- ema·d + new·(1−d)`` in place, ``new`` cast to each EMA tensor's
    dtype (reference ``update_ema_model``, ``train_stage2_aggregator.py:719-722``)."""
    for name, e in ema.items():
        e.copy_(e * decay + new[name].to(e.dtype) * (1.0 - decay))


@torch.no_grad()
def masked_ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], mask: Dict[str, bool],
                      decay: float) -> None:
    """``ema_update`` on the names ``mask`` selects; the others track ``new`` exactly."""
    for name, e in ema.items():
        n = new[name].to(e.dtype)
        e.copy_(e * decay + n * (1.0 - decay) if mask[name] else n)


def swap_masked(params: Dict[str, torch.Tensor], donor: Dict[str, torch.Tensor],
                mask: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """The tensors of ``donor`` where ``mask`` is set, those of ``params``
    elsewhere: the analogue of the reference's EMA attn-processor swap
    (``train_stage2_aggregator.py:1535-1540``)."""
    return {name: donor[name] if mask[name] else p for name, p in params.items()}


# ---------------------------------------------------------------------------
# the degradation and host-side batch pipelining
# ---------------------------------------------------------------------------


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (an array or a tensor) on ``device``; a host array bound for a
    card goes through pinned memory without a wait for the device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _host_f32(x):
    """``x`` as fp32: an array cast on the host, a tensor by ``float()`` (no copy when it is fp32 already)."""
    return x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def degradation_seed(seed: int, step: int, rank: int = 0) -> int:
    """``seed·7919 + step``, the seed of the JAX trainers' ``host_rng``, for
    data-parallel rank 0; another rank's seed is offset by ``rank·2⁴⁰`` so
    that the ranks degrade their rows of a batch independently."""
    return seed * 7919 + step + (rank << 40)


def degradation_generators(seed: int, step: int, device, rank: int = 0) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator of the chain's per-call choices, generator of its pixel
    noise on ``device``) for ``step``: both seeded from ``degradation_seed``,
    so a step's degradation does not depend on which thread prepares it or
    on what ran before."""
    base = degradation_seed(seed, step, rank)
    return (torch.Generator().manual_seed(base),
            torch.Generator(device=torch.device(device)).manual_seed(base + (1 << 32)))


def takes_traced_chain(degradation: RealESRGANDegradation, images_shape, jit_mode: bool) -> bool:
    """Whether ``run_degradation`` takes the traced chain for images of
    ``images_shape`` (``[B, H, W, C]``): ``jit_mode`` and H, W multiples of 16·sf."""
    mult = 16 * degradation.degrade_opt["sf"]
    return jit_mode and images_shape[1] % mult == 0 and images_shape[2] % mult == 0


def run_degradation(degradation: RealESRGANDegradation, images: torch.Tensor, kernels, *, jit_mode: bool,
                    host_rng: np.random.Generator, draws=None, noise=None, generator: Optional[torch.Generator] = None,
                    device_generator: Optional[torch.Generator] = None):
    """Degrade a batch with the traced chain (``jit_mode``, every trainer's
    default) when H and W are multiples of 16·sf, else with the eager chain
    and its numpy ``host_rng`` (the JAX ``run_degradation``). ``draws`` (a
    ``ChainDraws``) feeds the traced chain, ``noise`` (a pair of
    ``NoiseDraws``) the eager one."""
    if takes_traced_chain(degradation, images.shape, jit_mode):
        return degradation.traced_call(images, kernels, draws=draws, generator=generator,
                                       device_generator=device_generator)
    noise1, noise2 = noise if noise is not None else (None, None)
    return degradation(images, kernels=kernels, host_rng=host_rng, noise1=noise1, noise2=noise2,
                       generator=device_generator)


def pipelined_batches(trainer, data_iter: Iterator, cond, max_steps: int, depth: int) -> Iterator[Dict]:
    """Batches staged by a worker thread up to ``depth`` steps ahead and
    finished by the consumer. The worker does the host work of a step:
    ``next(data_iter)`` (the dataset, the image decode, the kernel triples)
    and ``trainer.stage_batch(..., step=step)`` (the pinned upload, the
    traced chain's choices). The consumer runs the device work,
    ``trainer.finish_batch`` (the caption conditioning, ``cond`` when it is
    callable, and the degradation), on its own thread between two steps, so
    the chain's precision switches (``full_fp32``) are never open while a
    step runs. A step's draws depend on its index alone
    (``degradation_generators``), so the batches equal the sequential
    loop's. A worker error is raised in the consumer; data exhaustion ends
    the stream. When the consumer leaves early (``close``), the worker stops
    at its next bounded ``put`` and is joined; up to ``depth`` staged
    batches are dropped."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    start_step = trainer.global_step

    def put_checked(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def work() -> None:
        step = start_step
        try:
            while step < max_steps and not stop.is_set():
                host_batch = next(data_iter)
                put_checked((host_batch, trainer.stage_batch(host_batch, step=step)))
                step += 1
            put_checked(None)
        except StopIteration:
            put_checked(None)
        except BaseException as e:  # surfaced in the consumer
            put_checked(e)

    worker = threading.Thread(target=work, daemon=True, name="batch-prefetch")
    worker.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            host_batch, staged = item
            yield trainer.finish_batch(staged, cond(host_batch) if callable(cond) else cond)
    finally:
        stop.set()
        worker.join(timeout=60.0)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

_PREEMPT = {"requested": False}


def install_preemption_handler() -> bool:
    """SIGTERM -> request a stop at the next step boundary; the run loops read
    ``preemption_requested`` after every step and save a checkpoint before
    they leave (resume with ``resume_from_checkpoint="latest"``). A new
    handler starts with no request pending. Returns False, and installs
    nothing, off the main thread, where Python allows no signal handler."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        _PREEMPT["requested"] = True

    _PREEMPT["requested"] = False
    signal.signal(signal.SIGTERM, _handler)
    return True


def preemption_requested() -> bool:
    return _PREEMPT["requested"]


# ---------------------------------------------------------------------------
# checkpoints: checkpoint-{step}/state.pt, total-limit GC, resume-latest
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def _to_host(tree):
    """A copy of ``tree`` (dicts, lists, tensors, scalars) with every tensor detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def tree_bytes(tree) -> int:
    """Bytes of the tensors in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


class CheckpointManager:
    """``checkpoint-{step}/`` directories under ``output_dir``, each one
    ``torch.save`` of the state's tensors on the CPU (the port's counterpart
    of the JAX orbax checkpoint, holding the same state), with total-limit GC
    before each write and resume-latest. A write goes to
    ``checkpoint-{step}.tmp/`` and is renamed when complete, so a directory
    that ``latest_step`` reports is whole.

    ``async_save``: ``save`` returns once every tensor is copied to host
    memory and the file is written by a thread; the next ``save``,
    ``restore`` or ``wait`` blocks until it is done, so at most one write is
    in flight and GC never races it. Before a write the state's bytes are
    held against the free disk. ``saves`` records each write's step, bytes,
    seconds waiting for the previous write (and the GC), seconds to copy to
    the host and seconds to write (``last_save`` the newest). An empty
    ``output_dir`` turns checkpoints off (the JAX manager would write into
    the working directory)."""

    def __init__(self, output_dir: str, total_limit: Optional[int] = None, async_save: bool = False):
        self.output_dir = output_dir
        self.total_limit = total_limit
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None
        self.saves: List[Dict[str, Any]] = []
        self.last_save: Dict[str, Any] = {}

    def wait(self) -> None:
        """Block until any in-flight write has committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread, self._pending = None, None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _ckpt_dirs(self) -> List[str]:
        if not self.output_dir or not os.path.isdir(self.output_dir):
            return []
        dirs = [d for d in os.listdir(self.output_dir)
                if re.fullmatch(r"checkpoint-\d+", d) and os.path.exists(os.path.join(self.output_dir, d, STATE_FILE))]
        return sorted(dirs, key=lambda d: int(d.split("-")[1]))

    def _path(self, step: int) -> str:
        return os.path.abspath(os.path.join(self.output_dir, f"checkpoint-{step}"))

    def _write(self, step: int, host: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        path = self._path(step)
        tmp = path + ".tmp"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, STATE_FILE))
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        except BaseException as e:
            self._error = e
        self.last_save["write_seconds"] = time.perf_counter() - t0

    def save(self, step: int, state: Dict[str, Any]) -> None:
        t_wait = time.perf_counter()
        self.wait()
        if not self.output_dir:
            return
        if self.total_limit is not None:
            dirs = self._ckpt_dirs()
            while dirs and len(dirs) >= self.total_limit:
                shutil.rmtree(os.path.join(self.output_dir, dirs.pop(0)))
        t0 = time.perf_counter()
        nbytes = tree_bytes(state)
        os.makedirs(self.output_dir, exist_ok=True)
        free = shutil.disk_usage(self.output_dir).free
        if nbytes > free:
            raise RuntimeError(f"checkpoint-{step} takes {nbytes / 1e9:.2f} GB, {os.path.abspath(self.output_dir)} "
                               f"has {free / 1e9:.2f} GB free")
        host = _to_host(state)
        self.last_save = {"step": step, "bytes": nbytes, "wait_seconds": t0 - t_wait,
                          "to_host_seconds": time.perf_counter() - t0}
        self.saves.append(self.last_save)
        if self.async_save:
            self._pending = step
            self._thread = threading.Thread(target=self._write, args=(step, host), name="checkpoint-write")
            self._thread.start()
        else:
            self._write(step, host)
            self.wait()

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or the step of the write in flight."""
        if self._pending is not None:
            return self._pending
        dirs = self._ckpt_dirs()
        return int(dirs[-1].split("-")[1]) if dirs else None

    def restore(self, step: int) -> Dict[str, Any]:
        self.wait()
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu", weights_only=True)

    def resume_latest(self) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step)


# ---------------------------------------------------------------------------
# logging: TensorBoard event files written by hand, or wandb
# ---------------------------------------------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    key = _varint((number << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def encode_event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                 values: Optional[List[bytes]] = None) -> bytes:
    """A ``tensorflow.Event`` protobuf: ``wall_time`` (1, double), ``step``
    (2, int64), ``file_version`` (3) or ``summary`` (5) of encoded
    ``Summary.Value`` messages."""
    out = _field(1, 1, struct.pack("<d", wall_time)) + _field(2, 0, _varint(step))
    if file_version is not None:
        out += _field(3, 2, file_version.encode())
    if values is not None:
        out += _field(5, 2, b"".join(_field(1, 2, v) for v in values))
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """``Summary.Value{tag (1), simple_value (2, float)}``."""
    return _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", value))


def image_value(tag: str, png: bytes, height: int, width: int, channels: int = 3) -> bytes:
    """``Summary.Value{tag (1), image (4): Image{height, width, colorspace, encoded_image_string}}``."""
    image = (_field(1, 0, _varint(height)) + _field(2, 0, _varint(width)) + _field(3, 0, _varint(channels))
             + _field(4, 2, png))
    return _field(1, 2, tag.encode()) + _field(4, 2, image)


def image_grid(images: np.ndarray, ncols: int = 8) -> np.ndarray:
    """[N, H, W, 3] in [0, 1] -> one uint8 [rows·H, cols·W, 3] grid, ``ncols``
    a row (tensorboardX's ``add_images``)."""
    n, h, w, c = images.shape
    cols = min(n, ncols)
    rows = -(-n // cols)
    canvas = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, k = divmod(i, cols)
        canvas[r * h:(r + 1) * h, k * w:(k + 1) * w] = images[i]
    return (canvas * 255.0).clip(0, 255).astype(np.uint8)


class EventWriter:
    """A TensorBoard event file ``events.out.tfevents.<time>.<host>`` under
    ``logdir``, created at the first write: TFRecord records (length, its
    masked CRC-32C, the ``Event`` bytes, their masked CRC-32C), the first one
    the ``brain.Event:2`` file version."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path: Optional[str] = None
        self._file = None

    def _record(self, event: bytes) -> None:
        if self._file is None:
            os.makedirs(self.logdir, exist_ok=True)
            self.path = os.path.join(self.logdir, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
            self._file = open(self.path, "ab")
            self._record(encode_event(time.time(), file_version="brain.Event:2"))
        header = struct.pack("<Q", len(event))
        self._file.write(header + struct.pack("<I", masked_crc32c(header)) + event
                         + struct.pack("<I", masked_crc32c(event)))
        self._file.flush()

    def add_scalars(self, step: int, values: Dict[str, float]) -> None:
        self._record(encode_event(time.time(), step, values=[scalar_value(k, float(v)) for k, v in values.items()]))

    def add_image(self, step: int, tag: str, image: np.ndarray) -> None:
        """``image`` uint8 [H, W, 3], written as a PNG (Pillow)."""
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        self._record(encode_event(time.time(), step, values=[image_value(tag, buf.getvalue(), *image.shape)]))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class Tracker:
    """Scalar and image logging to TensorBoard event files (``EventWriter``)
    and/or wandb; a no-op without ``logdir``. ``backend`` is the reference's
    ``--report_to``: tensorboard | wandb | all; wandb raises ImportError when
    the package cannot be imported (the JAX ``Tracker``)."""

    def __init__(self, logdir: Optional[str], backend: str = "tensorboard", project: str = "instantir_tpu",
                 run_name: Optional[str] = None):
        self.writer: Optional[EventWriter] = None
        self.wandb = None
        if not logdir:
            return
        if backend not in ("tensorboard", "wandb", "all"):
            raise ValueError(f"unknown tracker backend {backend!r}")
        if backend in ("tensorboard", "all"):
            self.writer = EventWriter(logdir)
        if backend in ("wandb", "all"):
            try:
                import wandb
            except ImportError as e:
                raise ImportError("Tracker(backend='wandb') requires the wandb package; "
                                  "install it or use backend='tensorboard'") from e
            self.wandb = wandb.init(project=project, name=run_name, dir=logdir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if self.writer is not None:
            self.writer.add_scalars(step, values)
        if self.wandb is not None:
            self.wandb.log({k: float(v) for k, v in values.items()}, step=step)

    def images(self, step: int, tag: str, images: np.ndarray) -> None:
        """images: [N, H, W, 3] in [0, 1]."""
        clipped = np.clip(images, 0, 1)
        if self.writer is not None:
            self.writer.add_image(step, tag, image_grid(clipped))
        if self.wandb is not None:
            import wandb

            self.wandb.log({tag: [wandb.Image(im) for im in clipped]}, step=step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.wandb is not None:
            self.wandb.finish()


# ---------------------------------------------------------------------------
# The trainer frame
# ---------------------------------------------------------------------------

# The trainers feed DINOv2 224² pixels whatever its native grid, as the JAX
# trainers do; the encoder resizes its position embeddings to fit.
DINO_TRAIN_SIZE = 224


class Trainer:
    """The models on one device, the trainable split from a path predicate,
    the losses ``loss_configs`` picks, ``ClippedAdamW`` on the trainable
    leaves, every draw of a step from a seeded ``torch.Generator`` unless
    given, gradient accumulation, the RealESRGAN degradation of raw batches,
    checkpoints, the tracker and the host loop ``run``. A subclass sets
    ``self._loss_fn(batch, draws, generator) -> (total, metrics)``.
    ``device="cuda"`` (the default) raises without a card; pass
    ``device="cpu"`` to train on the CPU. The checkpoint directory and the
    event file are made at their first write.

    ``mesh`` (``resolve_mesh``; ``"auto"`` by default) makes the step data
    parallel: every rank holds rank 0's parameters, steps on its rows of the
    global batch (``cfg.train_batch_size``, which the data axis divides) and
    its rows of the global draws, and takes the mean gradient and metrics
    over the ranks; ``shard_optimizer_state`` shards the optimiser's state
    (ZeRO-1). Only rank 0 (``is_main``) logs and writes checkpoints."""

    def __init__(self, tag: str, models: Dict[str, nn.Module], cfg, pred: PathPred,
                 losses_config: Optional[LossesConfig], schedule, device, mesh="auto"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device 'cuda' requested but no CUDA device is available "
                               "(pass device='cpu' to train on the CPU)")
        self.mesh = resolve_mesh(mesh, cfg.train_batch_size, device=self.device)
        self.cfg = cfg
        self.models = models
        for name, model in models.items():
            where = {p.device.type for p in model.parameters()}
            if where != {self.device.type}:
                raise ValueError(f"{type(self).__name__}: {name} lies on {sorted(where)}, "
                                 f"the trainer on {self.device.type}")
        self.schedule = (schedule or sdxl_schedule()).to(self.device)
        self.losses = build_losses(self.loss_configs(losses_config), device=self.device)
        if cfg.quantize_frozen_unet:
            quantize_frozen_unet(models["unet"], keep_pred=self.frozen_unet_keep)
        self.trainable_names = set_trainable(models, pred)
        if self.mesh is not None:
            for model in models.values():
                pmesh.replicate_params(model, self.mesh)
        named = self.named_parameters()
        self.trainable: List[nn.Parameter] = [named[n] for n in self.trainable_names]
        self.optimizer = make_adamw(
            self.trainable, lr_schedule(cfg.lr_scheduler, cfg.learning_rate, cfg.lr_warmup_steps, cfg.max_train_steps),
            weight_decay=cfg.weight_decay, use_8bit=cfg.use_8bit_adam, max_grad_norm=cfg.max_grad_norm,
            mesh=self.mesh if cfg.shard_optimizer_state else None)
        self._loss_fn: Optional[Callable] = None
        self.last_validation: Optional[np.ndarray] = None  # the strips of run's newest validation render
        self._accumulated: Optional[List[torch.Tensor]] = None
        self._micro_steps = 0
        self._uncond_tok: Optional[torch.Tensor] = None
        self._generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.global_step = 0
        self.tag = tag
        self.degradation = RealESRGANDegradation(resolution=cfg.resolution)
        self.ckpt = CheckpointManager(cfg.output_dir, cfg.checkpoints_total_limit, async_save=cfg.async_checkpointing)
        self.tracker = Tracker(os.path.join(cfg.output_dir, "logs") if cfg.output_dir and self.is_main else None,
                               backend=cfg.report_to)
        if self.is_main:
            print(f"[{tag}] trainable params: {count_params(self.trainable) / 1e6:.2f}M")

    @property
    def is_main(self) -> bool:
        """Whether this process logs and writes: rank 0 of the data axis, or the only process."""
        return pmesh.axis_rank(self.mesh) == 0

    def step_draws(self, draws, generator: Optional[torch.Generator]):
        """(draws, generator) of this rank's step: under a mesh the given
        draws of the global batch cut to the rank's rows and the generator
        wrapped to draw the global batch and keep its rows (``RankRows``)."""
        generator = generator or self._generator
        if self.mesh is None:
            return draws, generator
        rows = RankRows(generator, pmesh.axis_rank(self.mesh), pmesh.axis_size(self.mesh))
        if draws is not None:
            draws = dataclasses.replace(draws, **{f.name: rows.rows(getattr(draws, f.name))
                                                  for f in dataclasses.fields(draws)
                                                  if getattr(draws, f.name) is not None})
        return draws, rows

    # with ``quantize_frozen_unet``: the UNet bases kept in fp (a predicate over
    # ``("unet", *module path)``), the trained ones
    frozen_unet_keep: Optional[PathPred] = None

    def validate(self, val_batch: Dict[str, Any], cond) -> np.ndarray:
        """Render ``val_batch`` (``{"lq", "gt"}`` NHWC in [-1, 1]) on the live
        weights, log the strips to the tracker and return them (uint8
        ``[N, 24 + H, 3·W, 3]``): the stage's ``train/validation.py`` function."""
        raise NotImplementedError(f"{type(self).__name__} has no validation render")

    def loss_configs(self, losses_config: Optional[LossesConfig]) -> List[SingleLossConfig]:
        """The losses this trainer sums: ``diffusion_losses``, L2 by default
        (stages 1 and 2; the previewer reads ``lcm_losses``)."""
        return losses_config.diffusion_losses if losses_config else [SingleLossConfig(name="L2Loss")]

    def named_parameters(self) -> Dict[str, nn.Parameter]:
        """Every parameter of the models under ``<model>.<name>``."""
        return named_parameters(self.models)

    def master_parameters(self) -> Dict[str, torch.Tensor]:
        """``named_parameters`` with each trainable leaf as its fp32 master
        (``ClippedAdamW.masters``): the values the JAX trainers hold."""
        named: Dict[str, torch.Tensor] = dict(self.named_parameters())
        named.update(zip(self.trainable_names, self.optimizer.masters))
        return named

    def master_state(self, model: str) -> Dict[str, torch.Tensor]:
        """``models[model].state_dict()`` with each trainable leaf read from
        its fp32 master: what the exports are made of."""
        named = self.master_parameters()
        return {k: named.get(f"{model}.{k}", v) for k, v in self.models[model].state_dict().items()}

    @torch.no_grad()
    def _uncond_image_tokens(self) -> torch.Tensor:
        """DINOv2 tokens of the zero (preprocessed) 224² image: constant while
        the image encoder is frozen, so computed once."""
        if self._uncond_tok is None:
            self._uncond_tok = self.models["image_encoder"](
                torch.zeros((1, 3, DINO_TRAIN_SIZE, DINO_TRAIN_SIZE), dtype=torch.float32, device=self.device))
        return self._uncond_tok

    def prepare_batch(self, batch: Dict[str, Any], cond: Dict[str, Any], step: Optional[int] = None,
                      draws=None, noise=None) -> Dict[str, torch.Tensor]:
        """A host batch plus the text conditioning (``cond``, whatever the
        step reads) -> the step's batch on the trainer's device:
        ``finish_batch(stage_batch(...), cond)``. A raw batch ``{"images"
        [B, H, W, 3] in [0, 1], "kernel", "kernel2", "sinc_kernel", ...}`` is
        uploaded and degraded on the device (``run_degradation``: traced when
        H, W are multiples of 16·sf, with ``jit_degradation``), its draws
        those of ``step`` (default: the current step;
        ``degradation_generators``, and the eager chain's ``host_rng =
        default_rng(seed·7919 + step)`` as in JAX) unless given (``draws``
        for the traced chain, ``noise`` for the eager one). An already
        degraded pair ``{"lq", "gt"}`` (NHWC in [-1, 1]) is taken as it is."""
        return self.finish_batch(self.stage_batch(batch, step, draws, noise), cond)

    def stage_batch(self, batch: Dict[str, Any], step: Optional[int] = None, draws=None,
                    noise=None) -> Dict[str, Any]:
        """The host half of ``prepare_batch`` (``pipelined_batches`` runs it
        on its worker thread): the batch's upload (pinned, no wait for the
        device) and, for a raw batch on the traced chain, the step's choices
        drawn on the host. On the device it only copies (and casts a tensor
        given in another dtype than fp32)."""
        if "lq" in batch and "gt" in batch:
            return {"lq": to_device(batch["lq"], self.device), "gt": to_device(batch["gt"], self.device)}
        rank = pmesh.axis_rank(self.mesh)
        missing = [k for k in ("images", "kernel", "kernel2", "sinc_kernel") if k not in batch]
        if missing:
            raise ValueError(f"prepare_batch: a batch holds 'lq' and 'gt', or raw 'images' with their kernels; "
                             f"this one lacks {missing}")
        step = self.global_step if step is None else step
        images = to_device(_host_f32(batch["images"]), self.device)
        kernels = tuple(to_device(_host_f32(batch[k]), self.device) for k in ("kernel", "kernel2", "sinc_kernel"))
        generator, device_generator = degradation_generators(self.cfg.seed, step, self.device, rank)
        if draws is None and takes_traced_chain(self.degradation, images.shape, self.cfg.jit_degradation):
            sf = self.degradation.degrade_opt["sf"]
            draws = self.degradation.draw_choices(images.shape[0], (images.shape[1] // sf, images.shape[2] // sf),
                                                  generator)
        return {"images": images, "kernels": kernels, "step": step, "draws": draws, "noise": noise,
                "device_generator": device_generator, "rank": rank}

    def finish_batch(self, staged: Dict[str, Any], cond: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The device half of ``prepare_batch``, on the thread that runs the
        steps: the degradation of a staged raw batch, the unconditional
        image tokens and the conditioning's upload."""
        if "images" in staged:
            step = staged["step"]
            lq, gt = run_degradation(self.degradation, staged["images"], staged["kernels"],
                                     jit_mode=self.cfg.jit_degradation,
                                     host_rng=np.random.default_rng(degradation_seed(self.cfg.seed, step, staged["rank"])),
                                     draws=staged["draws"],
                                     noise=staged["noise"], device_generator=staged["device_generator"])
        else:
            lq, gt = staged["lq"], staged["gt"]
        out = {"lq": lq, "gt": gt, "uncond_tokens": self._uncond_image_tokens()}
        out.update({k: to_device(v, self.device) for k, v in cond.items()})
        return out

    def loss(self, batch, draws=None, generator: Optional[torch.Generator] = None):
        """The differentiable forward of a step on this rank's rows: (weighted loss total, metrics)."""
        return self._loss_fn(batch, *self.step_draws(draws, generator))

    # metrics that stay per rank (not means over the batch)
    LOCAL_METRICS = ("_vis_strip",)

    def loss_and_grads(self, batch, draws=None, generator: Optional[torch.Generator] = None):
        """(loss, metrics, gradients of the trainable leaves in ``trainable_names``
        order); under a mesh each the mean over the data axis, the global
        batch's (every loss is a mean over samples, so the mean of the ranks'
        equal-sized means)."""
        total, metrics = self.loss(batch, draws, generator)
        grads = list(torch.autograd.grad(total, self.trainable))
        total = total.detach()
        if self.mesh is not None:
            means = [m for k, m in metrics.items() if k not in self.LOCAL_METRICS and isinstance(m, torch.Tensor)]
            all_reduce_mean([total, *grads, *means], self.mesh)
        return total, metrics, grads

    def train_step(self, batch, draws=None, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One (micro-)step. With ``gradient_accumulation_steps = k`` the
        optimiser steps on every k-th call, on the mean of the k gradients;
        ``grad_norm`` is this call's gradient norm before clipping."""
        loss, metrics, grads = self.loss_and_grads(batch, draws, generator)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            if self._accumulated is None:
                self._accumulated = [g.float() for g in grads]
            else:
                for a, g in zip(self._accumulated, grads):
                    a += g
            self._micro_steps += 1
            if self._micro_steps == k:
                self.optimizer.step([a / k for a in self._accumulated])  # the fp32 mean
                self._accumulated, self._micro_steps = None, 0
        else:
            self.optimizer.step(grads)
        self.global_step += 1
        return metrics

    # ------------------------------------------------------------------
    # checkpoints and the host loop
    # ------------------------------------------------------------------

    def checkpoint_state(self) -> Dict[str, Any]:
        """What a checkpoint holds, the JAX trainers' state: ``trainable``
        (the fp32 masters by name), ``opt_state`` (the AdamW state by name,
        the update count, and the gradient-accumulation buffers, as optax's
        ``MultiSteps`` holds them) and ``step``."""
        opt_state = self.optimizer.state_by_name(self.trainable_names)
        opt_state["micro_steps"] = self._micro_steps
        opt_state["accumulated"] = (None if self._accumulated is None
                                    else dict(zip(self.trainable_names, self._accumulated)))
        return {"trainable": dict(zip(self.trainable_names, self.optimizer.masters)), "opt_state": opt_state,
                "step": self.global_step}

    @torch.no_grad()
    def load_checkpoint_state(self, state: Dict[str, Any]) -> None:
        """Put back ``checkpoint_state``'s result (tensors on any device)."""
        self.optimizer.load_masters([state["trainable"][n] for n in self.trainable_names])
        opt_state = state["opt_state"]
        self.optimizer.load_state_by_name(self.trainable_names, opt_state)
        self._micro_steps = int(opt_state["micro_steps"])
        acc = opt_state["accumulated"]
        self._accumulated = None if acc is None else [acc[n].to(self.device, copy=True) for n in self.trainable_names]
        self.global_step = int(state["step"])

    def resume(self) -> Optional[int]:
        """With ``resume_from_checkpoint="latest"``, load the newest
        ``checkpoint-{step}`` under ``output_dir``; returns its step."""
        if self.cfg.resume_from_checkpoint != "latest":
            return None
        step, state = self.ckpt.resume_latest()
        if state is None:
            return None
        self.load_checkpoint_state(state)
        print(f"[{self.tag}] resumed from checkpoint-{step}")
        return step

    def save_checkpoint(self) -> None:
        """Save the state at the current step, once (the in-loop save and the
        final save may meet). Under a mesh every rank gathers the state
        (ZeRO-1) and rank 0 alone writes, rank 0 deciding for all whether the
        step is saved already."""
        saved = self.ckpt.latest_step() == self.global_step if self.is_main else False
        if self.mesh is not None:
            flag = torch.tensor([int(saved)], dtype=torch.int32, device=self.device)
            group = pmesh.axis_group(self.mesh)
            dist.broadcast(flag, src=dist.get_global_rank(group, 0), group=group)
            saved = bool(flag.item())
        if saved:
            return
        state = self.checkpoint_state()
        if self.is_main:
            self.ckpt.save(self.global_step, state)

    def run(self, data_iter: Iterator, cond, val_batch=None) -> List[Dict[str, float]]:
        """The host loop (the JAX trainers' ``run``): resume, then until
        ``max_train_steps``: the next batch (prefetched ``prefetch_batches``
        ahead by ``pipelined_batches``, or prepared in turn), ``train_step``,
        the metrics and ``steps_per_sec`` to the tracker every
        ``logging_steps``, a checkpoint every ``checkpointing_steps``, and a
        stop after a SIGTERM (``handle_preemption``); then the final save.
        ``cond`` is a dict, or a callable of the host batch (per-sample
        captions). With ``val_batch`` and ``validation_steps > 0``, after
        every step whose number ``validation_steps`` divides, ``validate``
        renders it (the JAX trainers' order: after the logging, before the
        checkpoint). ``sanity_check`` takes one step and returns. The data
        running out ends the loop. Returns the logged records."""
        cfg = self.cfg
        self.resume()
        if cfg.handle_preemption:
            install_preemption_handler()
        source = (pipelined_batches(self, data_iter, cond, cfg.max_train_steps, cfg.prefetch_batches)
                  if cfg.prefetch_batches > 0 else None)
        records: List[Dict[str, float]] = []
        tic = time.time()
        try:
            while self.global_step < cfg.max_train_steps:
                try:
                    if source is not None:
                        batch = next(source)
                    else:
                        host_batch = next(data_iter)
                        batch = self.prepare_batch(host_batch, cond(host_batch) if callable(cond) else cond)
                except StopIteration:
                    break
                if cfg.sanity_check:
                    print(f"[{self.tag}] sanity check: one batch prepared",
                          {k: tuple(v.shape) for k, v in batch.items()})
                metrics = self.train_step(batch)
                if cfg.sanity_check:
                    print(f"[{self.tag}] sanity check PASS", {k: float(v) for k, v in metrics.items()})
                    return records
                if self.global_step % cfg.logging_steps == 0:
                    values = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - tic
                    tic = time.time()
                    values["steps_per_sec"] = cfg.logging_steps / dt
                    self.tracker.scalars(self.global_step, values)
                    records.append({"step": self.global_step, **values})
                if (val_batch is not None and cfg.validation_steps > 0 and self.global_step % cfg.validation_steps == 0
                        and self.is_main):
                    self.last_validation = self.validate(val_batch, cond)
                if self.global_step % cfg.checkpointing_steps == 0:
                    self.save_checkpoint()
                if preemption_requested():
                    print(f"[{self.tag}] preemption: checkpointing at step {self.global_step} and exiting")
                    break
            self.save_checkpoint()
            self.ckpt.wait()
        finally:
            if source is not None:
                source.close()
        return records
