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

Which layers split follows the JAX rule leaf by leaf: ``tp_spec`` shards a
weight wherever its feature axis divides the ``model`` axis and keeps the
rest whole (at model 3 or 6 nearly the whole UNet), and so does the port.
GSPMD cuts the JAX leaves equally and reshards around a cut head or group;
the port instead splits a layer group on its consumer's boundaries, in the
nearest-to-equal shares of ``tp_shares``: an ``Attention``,
``SplitAttention`` or Resampler ``PerceiverAttention`` over whole heads
(10 heads at model 4: 3 / 3 / 2 / 2; the flash kernel sees each rank's local
heads), a ``ResnetBlock2D``'s (or the VAE's) ``conv1`` / ``time_emb_proj`` /
``conv2`` over whole groups of its ``norm2`` (32 groups at model 5: 7 / 7 /
6 / 6 / 6), which normalises the rank's channels with its own groups; a
feed-forward over features. The column-parallel rows, the row-parallel
columns, ``lora_A`` / ``lora_B``, GEGLU's ``proj`` and the Resampler's
``to_kv`` (whose outputs are ``[h | gate]`` and ``[k | v]``: rank r keeps its
share of *both* halves, so that the local ``chunk(2)`` pairs them) and the IP
projections all take the group's shares, and each Megatron pair still
closes with one all-reduce. The time-aware IP ``AdaLayerNorm``s (and
``SplitAttention``'s ``ln_k_ref`` / ``ln_v_ref``) normalise the rank's
features with the whole row's statistics (two all-reduces of a ``[B, N,
1]`` sum). A group stays whole on every rank -- no collective -- where
``tp_spec`` keeps any of its weights whole or where it has fewer heads or
groups than there are ranks (``tp_held_bytes`` counts what each rank then
holds; ``tp_sharded_bytes`` counts the JAX rule's leaves). External K/V
tokens (the training caches of ``models/kv_cache.py``) passed to a sharded
attention are refused.

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
from typing import Any, Dict, List, Optional, Tuple

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


def tp_shares(units: int, size: int) -> List[int]:
    """The nearest-to-equal split of ``units`` whole units (heads, groups,
    features) over ``size`` ranks: the first ``units % size`` ranks take one
    more (10 heads over 4 ranks: 3, 3, 2, 2; 32 groups over 5: 7, 7, 6, 6, 6)."""
    return [units // size + (r < units % size) for r in range(size)]


@dataclasses.dataclass(eq=False)
class TPShard:
    """One layer's place in the tensor-parallel layout, and its forward.

    ``kind`` is "col", "row" or "norm" (a consumer that only slices and
    normalises); ``dim`` the feature axis of its activations (-1 for a
    linear, 1 for an NCHW conv); ``spans`` every rank's (start, count) of
    the features it holds, in the whole layer's order (a column-parallel
    layer's output features, a row-parallel layer's input features, a
    norm's features); ``rows`` (col) the output features this rank keeps
    (of each ``[h | gate]`` half where the layer has two); ``whole_input``
    (row) whether the input arrives whole, so that the layer takes its own
    slice."""

    kind: str
    group: Any
    rank: int
    size: int
    spans: Tuple[Tuple[int, int], ...]
    dim: int = -1
    rows: Optional[torch.Tensor] = None
    whole_input: bool = False

    @property
    def features(self) -> int:
        """The features of every rank together: the whole layer's."""
        return sum(n for _, n in self.spans)

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's share of ``t`` (whole along ``dim``)."""
        return t.narrow(dim, *self.spans[self.rank])

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``y`` (one all-reduce over the group)."""
        y = y.contiguous()
        dist.all_reduce(y, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole features from every rank's share of them (``x``, this
        rank's), padded to the largest share for the all-gather."""
        dim %= x.dim()
        widest = max(n for _, n in self.spans)
        pad = widest - x.shape[dim]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim=dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([t.narrow(dim, 0, n) for t, (_, n) in zip(parts, self.spans)], dim=dim)

    def layer_norm(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        """LayerNorm without affine of rows whose features lie across the
        ranks (this rank holds ``x``'s): fp32 mean, then fp32 variance of the
        deviations, each summed over the group; output in ``x.dtype``."""
        xf = x.float()
        n = self.features
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


def _weight_shape(m: nn.Module) -> Tuple[int, ...]:
    """The shape of ``m``'s fp weight in the torch layout, which an int8
    base (its codes in ``weight_q`` / ``weight_qw``) has too."""
    if isinstance(m, nn.Linear):
        return (m.out_features, m.in_features)
    return (m.out_channels, m.in_channels // m.groups, *m.kernel_size)


class _Placer:
    """The tensor-parallel layout of one model (``tp_shard_``): which layers
    split, each rank's share of their features, and, with ``apply``, this
    rank's shard made in place. ``layout`` records, by parameter name, the
    axis a placed parameter is cut along and every rank's length along it
    (``tp_held_bytes``); ``kept`` the weights of the layer groups that stay
    whole."""

    def __init__(self, model: nn.Module, group, rank: int, size: int, apply: bool = True):
        self.group, self.rank, self.size, self.apply = group, rank, size, apply
        self.names = {id(m): n for n, m in model.named_modules()}
        self.done: set = set()  # names of the weights placed
        self.kept: set = set()  # names of the weights of the layer groups that stay whole
        self.layout: Dict[str, Tuple[int, List[int]]] = {}

    def shard(self, kind: str, spans, **kw) -> TPShard:
        return TPShard(kind, self.group, self.rank, self.size, tuple(spans), **kw)

    def _name(self, m: nn.Module, leaf: str) -> str:
        prefix = self.names[id(m)]
        return f"{prefix}.{leaf}" if prefix else leaf

    def spans(self, units: int, unit: int, layers) -> Optional[List[Tuple[int, int]]]:
        """Every rank's (start, count) of the features of a group of layers
        whose consumer takes ``units`` whole units of ``unit`` features each
        (an attention's heads, a norm's groups; 1 for a feed-forward's
        features), split in ``tp_shares``; None -- the group stays whole --
        where ``tp_spec`` keeps any of ``layers``' weights whole ((layer,
        axis) pairs: 0 column-, 1 row-parallel) or where the units are fewer
        than the ranks. The weights of a group that stays whole go to
        ``kept``."""
        split = units >= self.size and all(
            tp_spec(self._name(m, "weight"), _weight_shape(m), self.size) == axis for m, axis in layers)
        if not split:
            for m, axis in layers:
                self.kept.update(self._leaves(m, axis))
            return None
        out, start = [], 0
        for n in tp_shares(units, self.size):
            out.append((start * unit, n * unit))
            start += n
        return out

    def _leaves(self, m: nn.Module, axis: int) -> List[str]:
        """The names of ``m``'s weight and of the LoRA weight that follows its layout."""
        names = [self._name(m, "weight")]
        if getattr(m, "lora_rank", 0) > 0:
            names.append(self._name(m.lora_B if axis == 0 else m.lora_A, "weight"))
        return names

    def _cut(self, m: nn.Module, leaf: str, axis: int, index: List[torch.Tensor]) -> None:
        """Record leaf ``leaf`` of ``m`` as cut along ``axis``, rank r keeping
        the positions ``index[r]``; with ``apply``, keep this rank's."""
        name = self._name(m, leaf)
        self.layout[name] = (axis, [len(i) for i in index])
        if self.apply:
            old = getattr(m, leaf)
            value = old.detach().index_select(axis, index[self.rank].to(old.device))
            setattr(m, leaf, nn.Parameter(value.contiguous().clone(), requires_grad=old.requires_grad))

    def _plain(self, m: nn.Module) -> None:
        if type(m) is nn.Linear:
            m.__class__ = _TPLinear
        elif type(m) is nn.Conv2d:
            m.__class__ = _TPConv2d

    def col(self, m: nn.Module, spans, interleave: int = 1) -> None:
        """Column-parallel ``m``: rank r's ``spans[r]`` of the output
        features of each of its ``interleave`` equal halves (``[h | gate]``,
        ``[k | v]``)."""
        int8 = getattr(m, "quant_mode", None) is not None  # its codes stay whole
        part = _weight_shape(m)[0] // interleave
        rows = [torch.cat([torch.arange(i * part + a, i * part + a + n) for i in range(interleave)]) for a, n in spans]
        if not int8:
            self.done.add(self._name(m, "weight"))
            self._cut(m, "weight", 0, rows)
            if m.bias is not None:
                self._cut(m, "bias", 0, rows)
        if getattr(m, "lora_rank", 0) > 0:
            self.done.add(self._name(m.lora_B, "weight"))
            self._cut(m.lora_B, "weight", 0, rows)
        if self.apply:
            mine = rows[self.rank].to(m.weight_scale.device if int8 else m.weight.device)
            setattr(m, "out_features" if isinstance(m, nn.Linear) else "out_channels", len(mine))
            self._plain(m)
            m.tp = self.shard("col", spans, dim=-1 if isinstance(m, nn.Linear) else 1, rows=mine)

    def row(self, m: nn.Module, spans, whole_input: bool = False) -> None:
        """Row-parallel ``m``: rank r's ``spans[r]`` of its input features."""
        cols = [torch.arange(a, a + n) for a, n in spans]
        if getattr(m, "quant_mode", None) is None:
            self.done.add(self._name(m, "weight"))
            self._cut(m, "weight", 1, cols)
        if getattr(m, "lora_rank", 0) > 0:
            self.done.add(self._name(m.lora_A, "weight"))
            self._cut(m.lora_A, "weight", 1, cols)
        if self.apply:
            attr = "in_features" if isinstance(m, nn.Linear) else "in_channels"
            setattr(m, attr, spans[self.rank][1])
            self._plain(m)
            m.tp = self.shard("row", spans, dim=-1 if isinstance(m, nn.Linear) else 1, whole_input=whole_input)

    def own_row(self, m: nn.Module) -> None:
        """A row-parallel layer that reads a whole input (``conv_shortcut``,
        the samplers' ``conv``) and closes its own all-reduce: split over its
        input channels wherever ``tp_spec`` splits it."""
        spans = self.spans(_weight_shape(m)[1], 1, [(m, 1)])
        if spans is not None:
            self.row(m, spans, whole_input=True)

    def heads(self, m: nn.Module, spans) -> None:
        """An attention over this rank's heads."""
        if self.apply:
            m.heads = spans[self.rank][1] // m.head_dim

    def norm(self, m: nn.Module, spans) -> None:
        """A ``GroupNorm32`` after a column-parallel conv: this rank's
        channels, with its share of the groups."""
        cpg = sum(n for _, n in spans) // m.num_groups
        for leaf in ("weight", "bias"):
            self._cut(m, leaf, 0, [torch.arange(a, a + n) for a, n in spans])
        if self.apply:
            m.num_groups = spans[self.rank][1] // cpg


def _refuse_external_kv(m: nn.Module, args, kwargs) -> None:
    """A sharded attention's forward pre-hook: external K/V tokens (the
    training-only KV caches of ``models/kv_cache.py``) hold every head, and
    no caller passes them under tensor parallelism, so they are refused."""
    if inspect.signature(m.forward).bind(*args, **kwargs).arguments.get("external_kv") is not None:
        raise ValueError(f"tensor parallelism: {type(m).__name__} got external_kv; the tensor-parallel layout "
                         "is for inference, which passes no external K/V")


def _place(model: nn.Module, place: _Placer) -> None:
    """Walk ``model`` and place every layer group that splits (``_Placer.spans``)."""
    from instantir_tpu_torch.models.attention import Attention, SplitAttention
    from instantir_tpu_torch.models.dinov2 import _MLP
    from instantir_tpu_torch.models.resampler import PerceiverAttention
    from instantir_tpu_torch.models.resnet import Downsample2D, ResnetBlock2D, Upsample2D
    from instantir_tpu_torch.models.transformer import GEGLUFeedForward
    from instantir_tpu_torch.models.vae import VAEResnetBlock

    for m in list(model.modules()):
        if isinstance(m, (Attention, SplitAttention)):
            layers = [(m.to_q, 0), (m.to_k, 0), (m.to_v, 0), (m.to_out[0], 1)]
            if getattr(m, "with_ip", False):
                layers += [(m.processor.to_k_ip, 0), (m.processor.to_v_ip, 0)]
            spans = place.spans(m.heads, m.head_dim, layers)
            if spans is None:
                continue
            place.heads(m, spans)
            for proj, axis in layers:
                (place.col if axis == 0 else place.row)(proj, spans)
            if place.apply:
                m.register_forward_pre_hook(_refuse_external_kv, with_kwargs=True)
                if getattr(m, "with_ip", False) and m.time_aware_ip:
                    m.processor.ln_k_ip.tp = m.processor.ln_v_ip.tp = place.shard("norm", spans)
                if isinstance(m, SplitAttention) and m.mode == "sep":
                    m.ln_k_ref.tp = m.ln_v_ref.tp = place.shard("norm", spans)
        elif isinstance(m, PerceiverAttention):
            spans = place.spans(m.heads, m.head_dim, [(m.to_q, 0), (m.to_kv, 0), (m.to_out, 1)])
            if spans is not None:
                place.heads(m, spans)
                place.col(m.to_q, spans)
                place.col(m.to_kv, spans, interleave=2)
                place.row(m.to_out, spans)
        elif isinstance(m, GEGLUFeedForward):
            proj, out = m.net[0].proj, m.net[2]
            spans = place.spans(_weight_shape(out)[1], 1, [(proj, 0), (out, 1)])
            if spans is not None:
                place.col(proj, spans, interleave=2)
                place.row(out, spans)
        elif isinstance(m, (ResnetBlock2D, VAEResnetBlock)):
            layers = [(m.conv1, 0), (m.conv2, 1)]
            if getattr(m, "time_emb_proj", None) is not None:
                layers.append((m.time_emb_proj, 0))
            cpg = m.norm2.weight.shape[0] // m.norm2.num_groups
            spans = place.spans(m.norm2.num_groups, cpg, layers)
            if spans is not None:
                place.norm(m.norm2, spans)
                for layer, axis in layers:
                    (place.col if axis == 0 else place.row)(layer, spans)
            if m.conv_shortcut is not None:
                place.own_row(m.conv_shortcut)
        elif isinstance(m, (Downsample2D, Upsample2D)):
            place.own_row(m.conv)
        elif isinstance(m, _MLP):
            spans = place.spans(m.fc1.out_features, 1, [(m.fc1, 0), (m.fc2, 1)])
            if spans is not None:
                place.col(m.fc1, spans)
                place.row(m.fc2, spans)


def tp_shard_(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Turn ``model`` into this rank's tensor-parallel shard in place (the
    twin of ``tp_shard_params``; the module docstring has the layout). Every
    weight ``tp_spec`` shards is placed, kept whole with its layer group, or
    listed in ``KEPT_WHOLE``; any other raises. Returns ``model``."""
    from instantir_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    size = axis_size(mesh, axis)
    if size == 1:
        return model
    place = _Placer(model, axis_group(mesh, axis), axis_rank(mesh, axis), size)
    # the weights tp_spec shards (an int8 base has no ``weight``: its codes stay whole)
    sharded = [n for n, p in model.named_parameters() if tp_spec(n, tuple(p.shape), size) is not None]
    _place(model, place)
    missed = [n for n in sharded if n not in place.done and n not in place.kept and not kept_whole(n)]
    if missed:
        raise ValueError(f"tensor parallelism: no placement for {len(missed)} sharded leaves, e.g. {missed[:4]}")
    return model


def tp_held_bytes(module: nn.Module, model_size: int) -> List[int]:
    """Bytes of the parameters and buffers each rank of a ``model`` axis of
    ``model_size`` holds under the port's layout (``tp_shard_``): a placed
    parameter its rank's share along its cut axis, every other whole. A walk
    of the placement on the shapes alone (the module is not changed), so a
    module built on the ``meta`` device serves. ``tp_sharded_bytes`` counts
    the JAX rule's leaves instead."""
    place = _Placer(module, None, 0, model_size, apply=False)
    if model_size > 1:
        _place(module, place)
    held = [0] * model_size
    for name, t in (*module.named_parameters(), *module.named_buffers()):
        nbytes = t.numel() * t.element_size()
        axis, lengths = place.layout.get(name, (None, None))
        for r in range(model_size):
            held[r] += nbytes if axis is None else nbytes // t.shape[axis] * lengths[r]
    return held


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
