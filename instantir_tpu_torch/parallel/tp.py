"""Tensor parallelism over the mesh's ``model`` axis.

Twin of ``instantir_tpu/parallel/tp.py``. The JAX package annotates each
parameter with a ``PartitionSpec`` (``tp_spec``) and lets GSPMD insert the
collectives; the port runs one process per GPU, so ``tp_shard_`` turns a
built model into this rank's shard in place and makes every collective
explicit, in the Megatron pairing of the JAX docstring:

* a **column-parallel** layer (``to_q/k/v``, ``to_k_ip/to_v_ip``, ``proj``,
  ``fc1``, ``to_kv``, ``conv1``, ``time_emb_proj``) keeps rank r's rows of
  the output features (and of its bias and ``lora_B``; ``lora_A`` stays
  whole) and needs no collective: its output stays sharded;
* a **row-parallel** layer (``to_out``, ``out`` -- the port's ``ff.net.2`` --,
  ``fc2``, ``conv2``, ``conv_shortcut``, the samplers' ``conv``) keeps rank
  r's columns of the input features (and of ``lora_A``). Its base partial and
  its LoRA partial (each rounded to the layer's dtype, as each rank's dot in
  the JAX bf16 program is) join before **one** all-reduce over the ``model``
  group, and the bias is added once, after it. ``conv_shortcut`` and the
  samplers' ``conv`` read a whole input and take their own slice of it.

The consumers of sharded activations change with them: an ``Attention``,
``SplitAttention`` or Resampler ``PerceiverAttention`` runs on its ``heads /
model`` local heads (the flash kernel sees local heads), the time-aware IP
``AdaLayerNorm``s (and ``SplitAttention``'s ``ln_k_ref`` / ``ln_v_ref``)
normalise the rank's features with the whole row's statistics (two
all-reduces of a ``[B, N, 1]`` sum), a ``ResnetBlock2D``'s ``norm2``
normalises the rank's channels with its share of the groups (``groups /
model``, which the shards must fall on), and GEGLU's ``proj`` and the
Resampler's ``to_kv``, whose outputs are ``[h | gate]`` and ``[k | v]``, keep
rank r's rows of *both* halves, so that the local ``chunk(2)`` pairs them. A
``model`` size that does not divide an attention's heads or a norm's groups
is refused, naming the module, and so are external K/V tokens (the training
caches of ``models/kv_cache.py``) passed to a sharded attention.

Two leaves that the JAX rule shards stay whole on every rank (``KEPT_WHOLE``),
since their consumer needs the whole output and the values are the same:
DINOv2's attention output projection (JAX ``proj``, the port's
``attention.output.dense``), which feeds the residual, and the VAE's
single-head mid-block attention (``to_q/k/v``, ``to_out.0``), where a split
of one head's 512 features would all-reduce ``[B, 1, S, S]`` logits.

An int8 base (``InstantIRPipeline.quantize``, before ``shard``) stays whole,
as the JAX package keeps its ``kernel_q`` / ``kernel_qw`` side tree, which
``tp_spec`` does not touch: a column-parallel one computes its whole output
and keeps its rows, a row-parallel one all-gathers its input; its LoRA
branches shard as above. The layout is for inference (``restore``, the
server): the collectives carry no gradient.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# modules whose weight's OUTPUT features shard over 'model' (column-parallel)
_COL_PARALLEL = (
    "to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "proj", "fc1", "to_kv",
    "conv1", "time_emb_proj",
)
# modules whose weight's INPUT features shard over 'model' (row-parallel)
_ROW_PARALLEL = ("to_out", "out", "fc2", "conv2", "conv_shortcut", "conv")

# the port's module names whose JAX twin carries another name (``convert.py``'s map)
_JAX_OWNER = (
    (re.compile(r"(^|\.)to_out\.0$"), "to_out"),
    (re.compile(r"(^|\.)net\.2$"), "out"),  # GEGLUFeedForward's output projection
    (re.compile(r"(^|\.)attention\.output\.dense$"), "proj"),  # DINOv2
    # the VAE's samplers: JAX ``down_blocks_{i}_downsample`` / ``up_blocks_{i}_upsample``
    (re.compile(r"(^|vae\.)(encoder|decoder)\.(down|up)_blocks\.\d+\.(down|up)samplers\.\d+\.conv$"), "sampler"),
)

# leaves the JAX rule shards that the port keeps whole on every rank (module docstring)
KEPT_WHOLE = (
    re.compile(r"(^|\.)attention\.output\.dense\.weight$"),  # DINOv2's attention output projection
    re.compile(r"(^|\.)mid_block\.attentions\.\d+\.(to_q|to_k|to_v|to_out\.0)\.weight$"),  # the VAE's attention
)


def _jax_owner(module: str) -> str:
    for pattern, owner in _JAX_OWNER:
        if pattern.search(module):
            return owner
    return module.rsplit(".", 1)[-1]


def tp_spec(name: str, shape: Tuple[int, ...], model_size: int) -> Optional[int]:
    """The axis of parameter ``name`` (a state-dict name of the port, which
    ``convert.py`` emits) that the JAX rule shards over ``model``: 0 (a
    column-parallel weight's output features), 1 (a row-parallel weight's
    input features), or None (replicated) -- the JAX ``tp_spec`` leaf by
    leaf, on the torch layouts (``[out, in]``, OIHW)."""
    parts = name.split(".")
    if parts[-1] != "weight" or len(shape) < 2:
        return None
    lora = parts[-2] if parts[-2] in ("lora_A", "lora_B") else None
    owner = _jax_owner(".".join(parts[:-2] if lora else parts[:-1]))
    if lora == "lora_B":  # the adapter branch follows its parent module's layout
        return 0 if owner in _COL_PARALLEL and shape[0] % model_size == 0 else None
    if lora == "lora_A":
        return 1 if owner in _ROW_PARALLEL and shape[1] % model_size == 0 else None
    if owner in _COL_PARALLEL and shape[0] % model_size == 0:
        return 0
    if owner in _ROW_PARALLEL and shape[1] % model_size == 0:
        return 1
    return None


def kept_whole(name: str) -> bool:
    """Whether the port keeps the leaf ``name`` whole though ``tp_spec`` shards it."""
    return any(p.search(name) for p in KEPT_WHOLE)


def tp_sharded_bytes(module: nn.Module, model_size: int = 2) -> Tuple[int, int]:
    """(bytes of the parameters ``tp_spec`` shards over ``model``, bytes of
    every parameter) of ``module``: a walk over its parameters' shapes and
    dtypes, so a module built on the ``meta`` device serves (the twin's
    ``eval_shape`` walk)."""
    sharded = total = 0
    for name, p in module.named_parameters():
        n = p.numel() * p.element_size()
        total += n
        if tp_spec(name, tuple(p.shape), model_size) is not None:
            sharded += n
    return sharded, total


@dataclasses.dataclass(eq=False)
class TPShard:
    """One layer's place in the tensor-parallel layout, and its forward.

    ``kind`` is "col", "row" or "norm" (a consumer that only slices and
    normalises); ``dim`` the feature axis of its activations (-1 for a
    linear, 1 for an NCHW conv); ``rows`` (col) the output features this
    rank keeps, in the whole layer's order; ``whole_input`` (row) whether
    the input arrives whole, so that the layer takes its own slice."""

    kind: str
    group: Any
    rank: int
    size: int
    dim: int = -1
    rows: Optional[torch.Tensor] = None
    whole_input: bool = False

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous share of ``t`` along ``dim``."""
        k = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * k, k)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``y`` (one all-reduce over the group)."""
        y = y.contiguous()
        dist.all_reduce(y, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole features from every rank's contiguous share of them."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def layer_norm(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """LayerNorm without affine of rows whose features lie across the
        ranks (this rank holds ``x``'s): fp32 mean, then fp32 variance of the
        deviations, each summed over the group; output in ``x.dtype``."""
        xf = x.float()
        n = xf.shape[-1] * self.size
        mean = self.reduce(xf.sum(-1, keepdim=True)) / n
        d = xf - mean
        var = self.reduce((d * d).sum(-1, keepdim=True)) / n
        return (d * torch.rsqrt(var + eps)).to(x.dtype)

    def __call__(self, m: nn.Module, x: torch.Tensor, lora_scale: float = 0.0) -> torch.Tensor:
        """The forward of layer ``m`` (``product`` / ``lora`` of a
        ``LoRALinear`` / ``LoRAConv2d``, or of a plain layer made
        ``_TPLinear`` / ``_TPConv2d``) on ``x`` in its compute dtype."""
        lora = getattr(m, "lora_rank", 0) > 0 and lora_scale != 0.0
        whole = getattr(m, "quant_mode", None) is not None  # int8 codes stay whole (module docstring)
        dim = self.dim % x.dim()
        if self.kind == "col":
            y = m.product(x)
            if whole:
                y = y.index_select(dim, self.rows)
            return y + m.lora(x, lora_scale) if lora else y
        xs = self.local(x, dim) if self.whole_input else x
        if whole:
            y = m.product(x if self.whole_input else self.gather(x, dim))
            return y + self.reduce(m.lora(xs, lora_scale)) if lora else y
        y = m.product(xs, bias=False)
        if lora:
            y = y + m.lora(xs, lora_scale)
        y = self.reduce(y)
        if m.bias is None:
            return y
        b = m.bias.to(y.dtype)
        return y + (b if dim == y.dim() - 1 else b.reshape(1, -1, 1, 1))


class _TPLinear(nn.Linear):
    """A plain ``nn.Linear`` (DINOv2's MLP) placed by ``tp_shard_``."""

    tp: Optional[TPShard] = None

    def product(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp(self, x)


class _TPConv2d(nn.Conv2d):
    """A plain ``nn.Conv2d`` (the VAE's resnets) placed by ``tp_shard_``."""

    tp: Optional[TPShard] = None

    def product(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        return self._conv_forward(x, self.weight, self.bias if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp(self, x)


class _Placer:
    """Shards one model's layers in place for this rank (``tp_shard_``)."""

    def __init__(self, model: nn.Module, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self.names = {id(m): n for n, m in model.named_modules()}
        self.done: set = set()  # names of the weights placed

    def shard(self, kind: str, **kw) -> TPShard:
        return TPShard(kind, self.group, self.rank, self.size, **kw)

    def _name(self, m: nn.Module, leaf: str) -> str:
        prefix = self.names[id(m)]
        return f"{prefix}.{leaf}" if prefix else leaf

    def _check(self, m: nn.Module, leaf: str, want: int) -> None:
        p = getattr(m, leaf)
        name = self._name(m, leaf)
        if tp_spec(name, tuple(p.shape), self.size) != want:
            raise ValueError(f"tensor parallelism: {name} {tuple(p.shape)} does not split on axis {want} over a "
                             f"'model' axis of {self.size}")
        self.done.add(name)

    @staticmethod
    def _set(m: nn.Module, leaf: str, value: torch.Tensor) -> None:
        old = getattr(m, leaf)
        setattr(m, leaf, nn.Parameter(value.contiguous().clone(), requires_grad=old.requires_grad))

    def _plain(self, m: nn.Module) -> None:
        if type(m) is nn.Linear:
            m.__class__ = _TPLinear
        elif type(m) is nn.Conv2d:
            m.__class__ = _TPConv2d

    def col(self, m: nn.Module, interleave: int = 1) -> None:
        """Column-parallel ``m``: rank r's output rows of each of its
        ``interleave`` equal halves (``[h | gate]``, ``[k | v]``)."""
        int8 = getattr(m, "quant_mode", None) is not None  # its codes stay whole
        base = m.weight_scale if int8 else m.weight
        part = base.shape[0] // interleave
        k = part // self.size
        rows = torch.cat([torch.arange(i * part + self.rank * k, i * part + (self.rank + 1) * k)
                          for i in range(interleave)]).to(base.device)
        if not int8:
            self._check(m, "weight", 0)
            self._set(m, "weight", m.weight.detach().index_select(0, rows))
            if m.bias is not None:
                self._set(m, "bias", m.bias.detach().index_select(0, rows))
        if getattr(m, "lora_rank", 0) > 0:
            self._check(m.lora_B, "weight", 0)
            self._set(m.lora_B, "weight", m.lora_B.weight.detach().index_select(0, rows))
        linear = isinstance(m, nn.Linear)
        setattr(m, "out_features" if linear else "out_channels", len(rows))
        self._plain(m)
        m.tp = self.shard("col", dim=-1 if linear else 1, rows=rows)

    def row(self, m: nn.Module, whole_input: bool = False) -> None:
        """Row-parallel ``m``: rank r's columns of its input features."""
        if getattr(m, "quant_mode", None) is None:
            self._check(m, "weight", 1)
            self._set(m, "weight", self.shard("row").local(m.weight.detach(), 1))
        if getattr(m, "lora_rank", 0) > 0:
            self._check(m.lora_A, "weight", 1)
            self._set(m.lora_A, "weight", self.shard("row").local(m.lora_A.weight.detach(), 1))
        linear = isinstance(m, nn.Linear)
        attr = "in_features" if linear else "in_channels"
        setattr(m, attr, getattr(m, attr) // self.size)
        self._plain(m)
        m.tp = self.shard("row", dim=-1 if linear else 1, whole_input=whole_input)

    def heads(self, m: nn.Module) -> None:
        """An attention over this rank's heads (``m.heads`` of them)."""
        if m.heads % self.size:
            raise ValueError(f"tensor parallelism: {type(m).__name__} {self.names[id(m)]!r} has {m.heads} heads, "
                             f"which the mesh 'model' axis ({self.size}) does not divide")
        m.heads //= self.size

    def norm(self, m: nn.Module) -> None:
        """A ``GroupNorm32`` after a column-parallel conv: this rank's
        channels, with its share of the groups."""
        if m.num_groups % self.size:
            raise ValueError(f"tensor parallelism: GroupNorm {self.names[id(m)]!r} has {m.num_groups} groups, "
                             f"which the mesh 'model' axis ({self.size}) does not divide: its channel shards would "
                             "cut a group")
        m.num_groups //= self.size
        local = self.shard("norm")
        for leaf in ("weight", "bias"):
            self._set(m, leaf, local.local(getattr(m, leaf).detach(), 0))


def _refuse_external_kv(m: nn.Module, args, kwargs) -> None:
    """A sharded attention's forward pre-hook: external K/V tokens (the
    training-only KV caches of ``models/kv_cache.py``) hold every head, and
    no caller passes them under tensor parallelism, so they are refused."""
    if inspect.signature(m.forward).bind(*args, **kwargs).arguments.get("external_kv") is not None:
        raise ValueError(f"tensor parallelism: {type(m).__name__} got external_kv; the tensor-parallel layout "
                         "is for inference, which passes no external K/V")


def tp_shard_(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Turn ``model`` into this rank's tensor-parallel shard in place (the
    twin of ``tp_shard_params``; the module docstring has the layout). Every
    weight ``tp_spec`` shards is placed or listed in ``KEPT_WHOLE``; any
    other raises. Returns ``model``."""
    from instantir_tpu_torch.models.attention import Attention, SplitAttention
    from instantir_tpu_torch.models.dinov2 import _MLP
    from instantir_tpu_torch.models.resampler import PerceiverAttention
    from instantir_tpu_torch.models.resnet import Downsample2D, ResnetBlock2D, Upsample2D
    from instantir_tpu_torch.models.transformer import GEGLUFeedForward
    from instantir_tpu_torch.models.vae import VAEResnetBlock
    from instantir_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    size = axis_size(mesh, axis)
    if size == 1:
        return model
    place = _Placer(model, axis_group(mesh, axis), axis_rank(mesh, axis), size)
    # the weights tp_spec shards (an int8 base has no ``weight``: its codes stay whole)
    sharded = [n for n, p in model.named_parameters() if tp_spec(n, tuple(p.shape), size) is not None]
    for m in list(model.modules()):
        if isinstance(m, (Attention, SplitAttention)):
            place.heads(m)
            for proj in (m.to_q, m.to_k, m.to_v):
                place.col(proj)
            place.row(m.to_out[0])
            m.register_forward_pre_hook(_refuse_external_kv, with_kwargs=True)
            if getattr(m, "with_ip", False):
                place.col(m.processor.to_k_ip)
                place.col(m.processor.to_v_ip)
                if m.time_aware_ip:
                    m.processor.ln_k_ip.tp = m.processor.ln_v_ip.tp = place.shard("norm")
            if isinstance(m, SplitAttention) and m.mode == "sep":
                m.ln_k_ref.tp = m.ln_v_ref.tp = place.shard("norm")
        elif isinstance(m, PerceiverAttention):
            place.heads(m)
            place.col(m.to_q)
            place.col(m.to_kv, interleave=2)
            place.row(m.to_out)
        elif isinstance(m, GEGLUFeedForward):
            place.col(m.net[0].proj, interleave=2)
            place.row(m.net[2])
        elif isinstance(m, (ResnetBlock2D, VAEResnetBlock)):
            place.norm(m.norm2)
            place.col(m.conv1)
            if getattr(m, "time_emb_proj", None) is not None:
                place.col(m.time_emb_proj)
            place.row(m.conv2)
            if m.conv_shortcut is not None:
                place.row(m.conv_shortcut, whole_input=True)
        elif isinstance(m, (Downsample2D, Upsample2D)):
            place.row(m.conv, whole_input=True)
        elif isinstance(m, _MLP):
            place.col(m.fc1)
            place.row(m.fc2)
    missed = [n for n in sharded if n not in place.done and not kept_whole(n)]
    if missed:
        raise ValueError(f"tensor parallelism: no placement for {len(missed)} sharded leaves, e.g. {missed[:4]}")
    return model


@torch.no_grad()
def shard_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's shards of whole ``weights`` of ``model`` (``{parameter
    name: tensor}``, e.g. ``freeze_previewer``'s merged weights) after
    ``tp_shard_``: a column-parallel layer's rows, a row-parallel layer's
    input columns, each as the layer holds its own weight."""
    modules = dict(model.named_modules())
    out = {}
    for name, w in weights.items():
        m = modules[name.rsplit(".", 1)[0]] if "." in name else model
        tp = getattr(m, "tp", None)
        if tp is None or name.rsplit(".", 1)[-1] != "weight":
            out[name] = w
        elif tp.kind == "col":
            out[name] = w.index_select(0, tp.rows.to(w.device)).contiguous()
        else:
            out[name] = tp.local(w, 1).contiguous()
    return out
