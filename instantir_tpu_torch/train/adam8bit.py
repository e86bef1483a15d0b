"""Block-quantized 8-bit AdamW (the reference's optional ``bnb.optim.AdamW8bit``).

Twin of ``instantir_tpu/train/adam8bit.py``: both Adam moments are stored as
signed blockwise-absmax int8 ``[nblocks, BLOCK]`` with fp32 scales
``[nblocks, 1]`` (a block of zeros has scale 1.0), one byte a value plus 4 /
2048 bytes of scale where ``torch.optim.AdamW`` keeps eight. The update keeps
optax's order (``adamw8bit``): the global-norm clip, m and n in fp32 from the
dequantized moments, bias correction, ``m̂ / (√n̂ + eps)``, ``+ wd·p``,
``·(−lr)``, then both moments requantized.

The state is laid out flat: each leaf takes ``ceil(numel / BLOCK)`` whole
blocks of one int8 buffer per moment (a block never spans two leaves, so the
quantization is the JAX package's leaf by leaf), and the fp32 masters are
views of one flat fp32 buffer in the same layout (an fp32 leaf's storage
moves into it; a narrower leaf gets its master's rounding after each update,
as ``common.ClippedAdamW`` does). The update runs as a few large ops over
runs of whole leaves of at most ``CHUNK`` values, not as a dozen ops per leaf:
a stage-2 Aggregator has thousands of leaves, and the steps are host-bound.

``BLOCK`` is part of the state's layout: a checkpoint written at another
block size does not load (``AdamW8bit.load_state_by_name`` says so). Under
ZeRO-1 each rank keeps and updates the moments of an equal run of whole
blocks and the masters are all-gathered; a checkpoint holds the whole
moments, in the same layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import nn

BLOCK = 2048
# values of one run of the update: its fp32 temporaries stay at 4 x 128 MB
CHUNK = 1 << 25


def quantize_blocks(x: torch.Tensor):
    """fp32 ``[nblocks, BLOCK]`` -> (int8 codes, fp32 scales ``[nblocks, 1]``):
    signed absmax per block, round half to even, a zero block scale 1.0."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8), scale


class AdamW8bit:
    """The 8-bit counterpart of ``common.ClippedAdamW``, with its interface:
    ``step(grads)`` clips by the global norm, updates the fp32 masters and
    returns the norm before clipping; ``state_by_name`` /
    ``load_state_by_name`` carry the int8 moments by leaf name;
    ``load_masters`` puts masters back. ``mu_q``/``nu_q`` (int8) and
    ``mu_scale``/``nu_scale`` (fp32) are the flat moment buffers of the
    blocks this rank updates (``owned``), ``blocks[i]`` the block range of
    leaf i.

    With a ``mesh`` (ZeRO-1) the blocks are split in equal runs over the
    data axis, on block boundaries: rank r updates and keeps the moments of
    blocks ``owned = [r·c, (r+1)·c)`` (the flat buffer padded with zero
    blocks to ``n·c``), then the updated masters are all-gathered. A block
    is quantized whole on one rank, so codes and scales equal the unsharded
    optimiser's."""

    def __init__(self, params: List[nn.Parameter], lr: Union[Callable[[int], float], float], weight_decay: float,
                 b1: float, b2: float, eps: float, max_grad_norm: Optional[float], mesh=None):
        from instantir_tpu_torch.parallel.mesh import axis_rank, axis_size

        self.params = list(params)
        self.schedule = lr if callable(lr) else (lambda step: float(lr))
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.mesh = mesh
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.blocks = []
        start = 0
        for p in self.params:
            n = -(-p.numel() // BLOCK)
            self.blocks.append((start, start + n))
            start += n
        ranks, rank = axis_size(mesh), axis_rank(mesh)
        per = -(-start // ranks)
        self.owned = (min(rank * per, start), min((rank + 1) * per, start))
        self._slot = (rank * per, per)  # this rank's rows of the padded flat buffer in the gather
        self.flat = torch.zeros((per * ranks, BLOCK), dtype=torch.float32, device=dev)
        flat1d = self.flat.view(-1)
        self.masters: List[torch.Tensor] = []
        with torch.no_grad():
            for p, (b0, _) in zip(self.params, self.blocks):
                view = flat1d[b0 * BLOCK:b0 * BLOCK + p.numel()].view(p.shape)
                view.copy_(p.detach())
                if p.dtype == torch.float32:
                    p.data = view  # the fp32 leaf is its own master, stored in the flat buffer
                    self.masters.append(p)
                else:
                    self.masters.append(view)
        mine = self.owned[1] - self.owned[0]
        self.mu_q = torch.zeros((mine, BLOCK), dtype=torch.int8, device=dev)
        self.nu_q = torch.zeros_like(self.mu_q)
        self.mu_scale = torch.ones((mine, 1), dtype=torch.float32, device=dev)
        self.nu_scale = torch.ones_like(self.mu_scale)
        # runs of the owned blocks: (first block, end block, [(leaf, first block, end block)]) of at most
        # CHUNK values each, cut on leaf boundaries (a larger leaf is a run of its own)
        self.runs = []
        lo, hi = self.owned
        for i, (b0, b1) in enumerate(self.blocks):
            c0, c1 = max(b0, lo), min(b1, hi)
            if c0 >= c1:
                continue
            if self.runs and (c1 - self.runs[-1][0]) * BLOCK <= CHUNK:
                r0, _, leaves = self.runs[-1]
                self.runs[-1] = (r0, c1, leaves + [(i, c0, c1)])
            else:
                self.runs.append((c0, c1, [(i, c0, c1)]))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        from instantir_tpu_torch.train.common import global_norm

        norm = global_norm(grads)
        self.count += 1
        lr = self.schedule(self.count - 1)
        b1, b2 = self.b1, self.b2
        count = torch.tensor(float(self.count), dtype=torch.float32)
        c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** count).to(self.flat.device)
        c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** count).to(self.flat.device)
        lo = self.owned[0]
        for r0, r1, leaves in self.runs:
            g = torch.zeros((r1 - r0, BLOCK), dtype=torch.float32, device=self.flat.device)
            g1d = g.view(-1)
            views, parts = [], []
            for i, c0, c1_ in leaves:
                b0 = self.blocks[i][0]
                v0, v1 = (c0 - b0) * BLOCK, min(self.params[i].numel(), (c1_ - b0) * BLOCK)
                views.append(g1d[(c0 - r0) * BLOCK:(c0 - r0) * BLOCK + v1 - v0])
                parts.append(grads[i].reshape(-1)[v0:v1])
            torch._foreach_copy_(views, parts)
            if self.max_grad_norm is not None:  # optax's clip: (g / norm) * max_norm past the bound
                g = torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
            mu_q, mu_s = self.mu_q[r0 - lo:r1 - lo], self.mu_scale[r0 - lo:r1 - lo]
            nu_q, nu_s = self.nu_q[r0 - lo:r1 - lo], self.nu_scale[r0 - lo:r1 - lo]
            m = b1 * (mu_q.float() * mu_s) + (1 - b1) * g
            n = b2 * (nu_q.float() * nu_s) + (1 - b2) * torch.square(g)
            del g, g1d, views, parts
            p = self.flat[r0:r1]
            u = (m / c1) / (torch.sqrt(n / c2) + self.eps)
            u.add_(self.weight_decay * p)
            p.add_(u.mul_(-lr))
            del u
            q, s = quantize_blocks(m)
            mu_q.copy_(q)
            mu_s.copy_(s)
            q, s = quantize_blocks(n)
            nu_q.copy_(q)
            nu_s.copy_(s)
        if self.mesh is not None:
            row0, per = self._slot
            self._all_gather(self.flat, self.flat[row0:row0 + per].clone())
        narrow = [(p, m) for p, m in zip(self.params, self.masters) if m is not p]
        if narrow:
            torch._foreach_copy_([p.data for p, _ in narrow], [m for _, m in narrow])
        return norm

    def _all_gather(self, out: torch.Tensor, mine: torch.Tensor) -> None:
        """``out`` (``n·c`` rows) <- every rank's ``mine`` (``c`` rows), in rank order."""
        import torch.distributed as dist

        from instantir_tpu_torch.parallel.mesh import axis_group

        dist.all_gather_into_tensor(out.view(-1), mine.reshape(-1), group=axis_group(self.mesh))

    def _whole_moments(self) -> Dict[str, torch.Tensor]:
        """The four moment buffers over every block (under ZeRO-1 all-gathered; every rank takes part)."""
        own = {"mu_q": self.mu_q, "mu_scale": self.mu_scale, "nu_q": self.nu_q, "nu_scale": self.nu_scale}
        if self.mesh is None:
            return own
        rows = self._slot[1]
        out = {}
        for key, t in own.items():
            mine = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
            mine[:t.shape[0]] = t
            out[key] = t.new_empty((self.flat.shape[0],) + tuple(t.shape[1:]))
            self._all_gather(out[key], mine)
        return out

    def _leaf_state(self, i: int, whole: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        b0, b1 = self.blocks[i]
        whole = self._whole_moments() if whole is None else whole
        return {key: t[b0:b1] for key, t in whole.items()}

    def state_by_name(self, names: List[str]) -> Dict[str, Any]:
        """The update count and each leaf's int8 moments and scales by name
        (views of the flat buffers, or under ZeRO-1 of their all-gather; a
        checkpoint copies them)."""
        whole = self._whole_moments()
        return {"count": self.count, "block": BLOCK,
                "adamw8bit": {n: self._leaf_state(i, whole) for i, n in enumerate(names)}}

    @torch.no_grad()
    def load_state_by_name(self, names: List[str], state: Dict[str, Any]) -> None:
        """Put back a copy of ``state_by_name``'s result (this rank's blocks of it under ZeRO-1)."""
        if "adamw8bit" not in state:
            raise RuntimeError("this checkpoint holds the fp32 AdamW state: it was written without "
                               "--use_8bit_adam; resume it without --use_8bit_adam, or resume from the "
                               "exported weights with a fresh optimizer")
        if state.get("block") != BLOCK:
            raise RuntimeError(f"this checkpoint's 8-bit Adam moments use blocks of {state.get('block')} values, "
                               f"the optimiser {BLOCK}: resume from the exported weights with a fresh optimizer")
        self.count = int(state["count"])
        lo, hi = self.owned
        own = {"mu_q": self.mu_q, "mu_scale": self.mu_scale, "nu_q": self.nu_q, "nu_scale": self.nu_scale}
        for i, n in enumerate(names):
            b0, b1 = self.blocks[i]
            c0, c1 = max(b0, lo), min(b1, hi)
            if c0 < c1:
                for key, t in own.items():
                    t[c0 - lo:c1 - lo].copy_(state["adamw8bit"][n][key][c0 - b0:c1 - b0])

    @torch.no_grad()
    def load_masters(self, masters: List[torch.Tensor]) -> None:
        """Copy ``masters`` into the fp32 masters and write each one's rounding back into its leaf."""
        for p, m, v in zip(self.params, self.masters, masters):
            m.copy_(v)
            if m is not p:
                p.copy_(m)
