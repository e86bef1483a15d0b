"""Analytic matmul/conv FLOP counting of the port's functions.

Twin of ``instantir_tpu/utils/flops.py``. ``flops(fn, *args)`` runs ``fn``
under a dispatch mode that applies ``torch.utils.flop_counter``'s formulas
and counts what ``jaxpr_flops`` counts: 2·M·N·K for every product (``mm``, ``addmm``,
``bmm``, the einsums and linears that lower to them) and
2·|out|·k_h·k_w·C_in/groups for every convolution, forward and backward.
Elementwise and reduction FLOPs are ignored by design: an MFU number is
normalised by the tensor cores' term.

The flash kernels are ctypes launches that a dispatch-level counter cannot
see, so their wrappers (``ops/attention.py``) are counted by formula while
``flops`` runs, and what they do inside is not counted again: the forward
(``flash_attention``, ``flash_attention_lse``) is its two products,
2·(2·B·H·Sq·Skv·D), as ``jaxpr_flops`` counts a Pallas kernel (body × grid);
the backward kernels recompute S and count three products (dQ: S, dP, dQ)
and four (dK/dV: S, dP, dV, dK). A restore through the kernels on the card
therefore counts what the plain path counts on the CPU.

Unlike the jaxpr walk, the count runs ``fn``: count on a small input, on
the CPU, or once beside a timed run.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

# products of each flash kernel's wrapper: 2·B·H·Sq·Skv·D FLOPs each
KERNEL_PRODUCTS: Dict[str, int] = {
    "flash_attention": 2,
    "flash_attention_lse": 2,
    "flash_backward_dq": 3,
    "flash_backward_dkv": 4,
}


def attention_flops(q_shape, kv_len: int, products: int = 2) -> int:
    """FLOPs of ``products`` attention products at ``q [B, Sq, H, D]`` over ``kv_len`` keys."""
    b, sq, h, d = (int(x) for x in q_shape)
    return products * 2 * b * h * sq * int(kv_len) * d


@contextlib.contextmanager
def _counted_kernels(total: list):
    """Count each flash wrapper's products by formula, and nothing inside it."""
    from torch.utils._python_dispatch import _disable_current_modes

    from instantir_tpu_torch.ops import attention

    originals = {name: getattr(attention, name) for name in KERNEL_PRODUCTS}

    def counted(name, fn):
        def call(q, k, *args, **kwargs):
            total[0] += attention_flops(q.shape, k.shape[1], KERNEL_PRODUCTS[name])
            with _disable_current_modes():
                return fn(q, k, *args, **kwargs)

        return call

    for name, fn in originals.items():
        setattr(attention, name, counted(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(attention, name, fn)


def _flop_mode():
    """A dispatch mode summing ``FlopCounterMode``'s formulas (its
    ``flop_registry``) over every op it sees, without ``FlopCounterMode``'s
    per-module tracker (whose hooks refuse a module input that is a view of
    a parameter made under ``no_grad``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.total += int(count(*args, **kwargs, out_val=out))
            return out

    return FlopMode()


def count_flops(fn, *args, **kwargs) -> Tuple[int, Any]:
    """(matmul/conv FLOPs of ``fn(*args, **kwargs)``, its result)."""
    kernel_total = [0]
    with _counted_kernels(kernel_total):
        with _flop_mode() as counter:
            out = fn(*args, **kwargs)
    return counter.total + kernel_total[0], out


def flops(fn, *args, **kwargs) -> int:
    """Total matmul/conv FLOPs of ``fn(*args, **kwargs)`` (it runs)."""
    return count_flops(fn, *args, **kwargs)[0]
