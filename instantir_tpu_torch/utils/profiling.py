"""Profiling helpers: per-phase wall time and ``torch.profiler`` traces.

Twin of ``instantir_tpu/utils/profiling.py``. ``PhaseTimer`` accumulates
wall time per named phase; a phase given ``sync_on`` waits for the device
work behind it first (``device_sync``: a synchronisation of the tensor's
CUDA device, nothing on the CPU), so a phase's time holds its kernels and
not only their launches. ``trace(logdir)`` wraps ``torch.profiler`` and
writes a Chrome trace (``logdir/trace.json``) that Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None) -> None:
    """Wait for outstanding device work: that of the CUDA device of ``x``'s
    first tensor (``x`` a tensor or a nested list / tuple / dict), or of the
    current CUDA device without one; nothing for a CPU tensor or without
    CUDA."""
    t = _first_tensor(x) if x is not None else None
    if t is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulate wall time per named phase; report averages."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the CUDA device
    when there is one), written to ``logdir/trace.json`` (Chrome trace
    format: open it in Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
