#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``instantir_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (4 denoise steps)
or ``python3 chip_smoke.py --steps 30`` (BASELINE config #4: 1024², 30 DDPM
steps, CFG 7, preview_start 0.1, control_guidance_end 0.7). Phases, each of
which ends the script with a nonzero exit on failure:

1. environment: the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, TF32 switched off for matmuls and cuDNN convolutions;
2. build: every kernel under ``instantir_tpu_torch/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all started together;
3. kernel check: each of the five kernels (flash forward, flash forward with
   lse, flash dQ, flash dK/dV, fused GroupNorm+SiLU) against its plain PyTorch
   version on the card at the main paths' shapes (plus ragged ones, a cross
   shape with Sq != Skv, a kv tail of 72 keys, an odd batch x heads and an odd
   S; for GroupNorm every shape of the restore in bf16, fp16 and fp32, a
   ragged one and one past a cluster's shared memory), with time, bound, the
   plain version's time and a one-call library yardstick; the wrappers' host
   time per call; GroupNorm's device time from a CUDA-graph replay;
4. restore at full SDXL width with synthetic weights: a UNet forward with the
   flash path against the plain attention path, then ``restore`` with the
   fused GroupNorm off and on, every launch counter set to 0 just before each
   and read just after; the counts must match the schedule, the images must be
   finite, 1024² RGB and close to each other (``RESTORE_TOL``);
5. stage-1 training at full SDXL width: three ``Stage1Trainer.train_step``s at
   512² (batch 2) and one at 1024² (batch 1, gradient checkpointing); loss and
   gradient norm finite, every trainable leaf moved, no frozen leaf changed,
   and the launch counters of every step equal to the counts derived from the
   config;
6. summary: one JSON line of kernels, the card line, and the result line.

``--only kernels`` stops after phase 3 (exit 0, no result line): the quick
check of a kernel edit; ``--only group_norm`` runs phase 3 for K5 alone.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FLASH_TOL = 4e-3  # max abs error, bf16: the band stated for the Pallas kernel vs the XLA path
LSE_TOL = 1e-3  # max abs error of the fp32 log2-domain logsumexp (values of order 10)
GRAD_TOL = 2e-2  # dq/dk/dv: max abs error over the largest reference value (bf16 has 8 bits)
# max abs error of the kernel's normalised (O(1)) outputs against the plain version's fp32 values (before
# their rounding to x's dtype): half an ulp of outputs below 8 plus the fp32 difference; fp16 the bf16 band
# over its 8x finer ulp. Two values rounded apart can differ by a whole ulp (0.031 in bf16 above 4).
GN_TOL = {"bfloat16": 2e-2, "float16": 2.5e-3, "float32": 1e-4}
FORWARD_TOL = 5e-2  # relative L2 of one UNet forward through a kernel against the same forward through its plain path
# relative L2 of two whole restores that differ in one kernel: four CFG-7 steps
# amplify a one-ulp bf16 difference a few thousand-fold (5.2e-2 measured for the
# fused GroupNorm on vs off, whose single forward differs by 2e-2)
RESTORE_TOL = 1e-1
# (B, S, H) of the flash kernel on the restore path: UNet S=4096/1024, Aggregator
# H-concat S=8192/2048, CFG batch 2
RESTORE_SHAPES = [(2, 4096, 10), (2, 1024, 20), (2, 8192, 10), (2, 2048, 20)]
# the training path's own shapes: 512² batch 2, then 1024² batch 1
TRAIN_SHAPES = [(2, 1024, 10), (1, 4096, 10), (1, 1024, 20)]
# (B, Sq, Skv, H) checked beside them, off every main path: a ragged 768² shape,
# S % 64 != 0, a cross shape (Sq != Skv, neither a multiple of the tiles), a kv
# tail of 72 keys after 129 full tiles, batch x heads = 15, and an odd S (the
# fp32 lse and D rows of a (batch, head) start off 16-byte alignment)
EXTRA_SHAPES = [(2, 2304, 2304, 10), (2, 1000, 1000, 10), (1, 200, 520, 10), (2, 8264, 8264, 10), (3, 1024, 1024, 5),
                (1, 1001, 1001, 10)]
FLASH_SHAPES = [(b, s, s, h) for b, s, h in RESTORE_SHAPES] + EXTRA_SHAPES
HOST_TIMING_SHAPE = RESTORE_SHAPES[1]  # most of a restore's launches
# (C, H, W) of GroupNorm32 on the restore path at 1024², CFG batch 2: the UNet's twelve shapes, then the
# Aggregator's five (its H-concat doubles H); beside them a ragged shape (a group's slab is 40,500 bytes in
# bf16, so slabs start off 16-byte alignment) and one whose slabs exceed a cluster's shared memory in bf16
# and fp32 (the kernel's "reread" path). Phase 3 holds the first seventeen to the shapes derived from the config.
GN_UNET_SHAPES = [(320, 128, 128), (640, 128, 128), (960, 128, 128), (320, 64, 64), (640, 64, 64), (960, 64, 64),
                  (1280, 64, 64), (1920, 64, 64), (640, 32, 32), (1280, 32, 32), (1920, 32, 32), (2560, 32, 32)]
GN_AGG_SHAPES = [(320, 256, 128), (320, 128, 64), (640, 128, 64), (640, 64, 32), (1280, 64, 32)]
GN_SHAPES = GN_UNET_SHAPES + GN_AGG_SHAPES + [(320, 45, 45), (128, 512, 512)]
GN_BATCH = 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2, groups: int = 3) -> float:
    """Milliseconds per call: ``groups`` runs of ``iters`` back-to-back calls,
    each run between two CUDA events; the median of the runs' means. Back to
    back the launches queue up, so a short kernel's time is the device's and
    not the host's launch gap -- unless the host needs longer to issue a call
    than the device to run it (``graph_ms`` reads the device alone)."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take: operations over the peak bf16 rate
    or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b: int, sq: int, skv: int, h: int, products: int = 2, q_tensors: int = 2, kv_tensors: int = 2,
                   rows_fp32: int = 0, d: int = 64):
    """``products`` Sq x Skv x d matrix products (2 flops per multiply-add)
    against ``q_tensors`` bf16 [B, Sq, H, d] and ``kv_tensors`` bf16
    [B, Skv, H, d] operands and ``rows_fp32`` fp32 [B, H, Sq] ones, each read
    or written once."""
    return bound_ms(2.0 * products * b * h * sq * skv * d,
                    (q_tensors * sq + kv_tensors * skv) * b * h * d * 2.0 + rows_fp32 * b * h * sq * 4.0)


def host_us_per_call(torch, fn, calls: int = 200, runs: int = 5) -> float:
    """Host microseconds a wrapper takes per call: the wall time of ``calls``
    un-synchronised calls over their number (the device queue absorbs them),
    each run followed by one synchronize; the median of ``runs`` runs (the
    host shares its cores, so single runs spread by tens of percent)."""
    fn()
    torch.cuda.synchronize()
    per_run = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_run.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_run)


def check_flash(torch, attention) -> list:
    """Phase 3, K1: the flash forward against its plain version at every shape."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, skv, h in FLASH_SHAPES:
        q = torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, skv, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        out = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.flash_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: attention.flash_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: attention.flash_attention_reference(q, k, v), iters=2, warmup=1, groups=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound, bound_by = flash_bound_ms(b, s, skv, h)
        row = dict(B=b, S=s, Skv=skv, H=h, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, library_ms=library_ms)
        rows.append(row)
        log(f"  flash B={b} Sq={s} Skv={skv} H={h}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  bound {bound:.4f} ms "
            f"({bound_by})  plain {plain_ms:.3f} ms  sdpa {library_ms:.4f} ms  "
            f"({4.0 * b * h * s * skv * 64 / ms / 1e9:.1f} TFLOP/s)")
        if not err <= FLASH_TOL:
            fail(f"flash kernel disagrees with flash_attention_reference at B={b} Sq={s} Skv={skv} H={h}: "
                 f"max abs error {err} > {FLASH_TOL}")
    b, s, h = HOST_TIMING_SHAPE
    q, k, v = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    log(f"  host time per call at B={b} S={s} H={h} (median of 5 runs of 200 calls): flash_attention "
        f"{host_us_per_call(torch, lambda: attention.flash_attention(q, k, v)):.2f} us, flash_attention_lse "
        f"{host_us_per_call(torch, lambda: attention.flash_attention_lse(q, k, v)):.2f} us")
    return rows


def check_flash_training(torch, attention) -> dict:
    """Phase 3, K2-K4: the forward with lse and the two backward kernels
    against their plain versions, at the restore's shapes, the trainer's and
    the extra ones. The backward kernels are fed the forward kernel's own
    output and lse, their plain version the plain forward's. On the card the
    plain backward runs with 1024-wide blocks (the kernel's rounding points; a
    64-wide Python sweep of S=8192 would take minutes)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {"fwd_lse": [], "bwd_dq": [], "bwd_dkv": []}
    for b, s, skv, h in FLASH_SHAPES + [(b, s, s, h) for b, s, h in TRAIN_SHAPES]:
        q, do = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, skv, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        shape = dict(B=b, S=s, Skv=skv, H=h)
        where = f"B={b} Sq={s} Skv={skv} H={h}"

        out, lse = attention.flash_attention_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention.flash_attention_lse_reference(q, k, v)
        err_o = (out.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if not (err_o <= FLASH_TOL and err_lse <= LSE_TOL):
            fail(f"flash forward-with-lse disagrees with its plain version at {where}: o {err_o} (> {FLASH_TOL}?) "
                 f"lse {err_lse} (> {LSE_TOL}?)")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt)
        bound, bound_by = flash_bound_ms(b, s, skv, h, rows_fp32=1)
        rows["fwd_lse"].append(dict(
            **shape, max_abs_err=max(err_o, err_lse), ms=time_ms(torch, lambda: attention.flash_attention_lse(q, k, v)),
            plain_ms=time_ms(torch, lambda: attention.flash_attention_lse_reference(q, k, v), iters=2, warmup=1, groups=2),
            bound_ms=bound, bound_by=bound_by,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))))

        delta = attention.flash_delta(out, do)
        dq = attention.flash_backward_dq(q, k, v, do, lse, delta)
        dk, dv = attention.flash_backward_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()

        def plain():
            return attention.flash_backward_reference(q, k, v, ref_o, ref_lse, do, block_q=1024, block_k=1024)

        refs = plain()
        errs = [((x.float() - r.float()).abs().max() / r.float().abs().max()).item() for x, r in zip((dq, dk, dv), refs)]
        if not all(e <= GRAD_TOL for e in errs):
            fail(f"flash backward disagrees with flash_backward_reference at {where}: relative max errors "
                 f"dq {errs[0]}, dk {errs[1]}, dv {errs[2]} (> {GRAD_TOL})")
        plain_ms = time_ms(torch, plain, iters=1, warmup=0, groups=2)
        dlib = torch.randn_like(lib_out)
        library_ms = time_ms(
            torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dlib, retain_graph=True), iters=5, warmup=1)
        for name, fn, err, products, q_tensors, kv_tensors in (
            ("bwd_dq", lambda: attention.flash_backward_dq(q, k, v, do, lse, delta), errs[0], 3, 3, 2),
            ("bwd_dkv", lambda: attention.flash_backward_dkv(q, k, v, do, lse, delta), max(errs[1:]), 4, 2, 4),
        ):
            bound, bound_by = flash_bound_ms(b, s, skv, h, products=products, q_tensors=q_tensors,
                                             kv_tensors=kv_tensors, rows_fp32=2)
            rows[name].append(dict(**shape, max_abs_err=err, ms=time_ms(torch, fn), plain_ms=plain_ms,
                                   bound_ms=bound, bound_by=bound_by, library_ms=library_ms))
        r2, r3, r4 = (rows[n][-1] for n in ("fwd_lse", "bwd_dq", "bwd_dkv"))
        log(f"  {where}: fwd+lse err {r2['max_abs_err']:.2e} {r2['ms']:.4f} ms (bound {r2['bound_ms']:.4f}, sdpa "
            f"{r2['library_ms']:.4f}) | dq err {r3['max_abs_err']:.2e} {r3['ms']:.4f} ms (bound {r3['bound_ms']:.4f}) | "
            f"dkv err {r4['max_abs_err']:.2e} {r4['ms']:.4f} ms (bound {r4['bound_ms']:.4f}) | plain bwd "
            f"{plain_ms:.2f} ms, sdpa bwd {library_ms:.4f} ms")
        del lib_out
    b, s, h = TRAIN_SHAPES[0]
    q, k, v, do = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = attention.flash_attention_lse(q, k, v)
    delta = attention.flash_delta(out, do)
    dq_us = host_us_per_call(torch, lambda: attention.flash_backward_dq(q, k, v, do, lse, delta))
    dkv_us = host_us_per_call(torch, lambda: attention.flash_backward_dkv(q, k, v, do, lse, delta))
    log(f"  host time per call at B={b} S={s} H={h} (median of 5 runs of 200 calls): flash_backward_dq "
        f"{dq_us:.2f} us, flash_backward_dkv {dkv_us:.2f} us")
    return rows


def graph_ms(torch, fn, calls: int = 10, replays: int = 3) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, each replay between two CUDA events; the median of ``replays``
    replays over ``calls``. A replay issues the kernels without the host's
    launch path, so the reading is the device's even where the host takes
    longer per call than the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as torch.cuda.graph asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    means = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(means)


def check_group_norm(torch, group_norm, gn_by_shape: dict) -> list:
    """Phase 3, K5: the fused GroupNorm(+SiLU) against ``group_norm_silu_nchw``
    (its fp32 values: see ``GN_TOL``) at every shape of the restore path and
    the extra ones, bf16, fp16 and fp32, with and without SiLU: back-to-back
    and device (CUDA graph) time, the host time of the dispatch under
    ``torch.no_grad()`` (bf16 and fp16: the dtypes it sends to the kernel),
    bound, plain version, ``F.group_norm`` and the launch plan (cluster size
    and path; "-" for a package without one)."""
    import torch.nn.functional as F

    if sorted(gn_by_shape) != sorted(GN_UNET_SHAPES + GN_AGG_SHAPES):
        fail(f"GroupNorm shapes derived from the config {sorted(gn_by_shape)} differ from GN_SHAPES' restore shapes")
    plan_of = getattr(group_norm, "gn_plan", None)
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for c, hh, ww in GN_SHAPES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            name = str(dtype).split(".")[-1]
            x = (torch.randn(GN_BATCH, c, hh, ww, generator=g, device="cuda") * 1.5 + 0.5).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            bias = 0.1 * torch.randn(c, generator=g, device="cuda")
            scale_d, bias_d = scale.to(dtype), bias.to(dtype)
            plan = plan_of(GN_BATCH, c, hh * ww, 32, x.element_size()) if plan_of else None
            for silu in (False, True):
                y = group_norm.group_norm_silu_fused(x, scale, bias, 32, 1e-5, silu)
                torch.cuda.synchronize()
                ref = group_norm.group_norm_silu_nchw(x.float(), scale, bias, 32, 1e-5, silu)
                err = (y.float() - ref).abs().max().item()
                where = f"C={c} {hh}x{ww} {name} silu={silu}"
                if y.dtype != dtype or not err <= GN_TOL[name]:
                    fail(f"fused GroupNorm disagrees with group_norm_silu_nchw at {where}: {err} > {GN_TOL[name]}")
                del y, ref

                def fused():
                    return group_norm.group_norm_silu_fused(x, scale, bias, 32, 1e-5, silu)

                def dispatch():
                    return group_norm.group_norm_silu(x, scale, bias, 32, 1e-5, silu)

                with torch.no_grad():
                    host_us = host_us_per_call(torch, dispatch) if dtype != torch.float32 else None
                bound, bound_by = bound_ms(8.0 * x.numel(), 2.0 * x.numel() * x.element_size())
                row = dict(C=c, H=hh, W=ww, dtype=name, silu=silu, max_abs_err=err, bound_ms=bound, bound_by=bound_by,
                           cs=plan.cs if plan else None, path=plan.path if plan else None,
                           ms=time_ms(torch, fused), device_ms=graph_ms(torch, fused),
                           host_us=host_us,
                           plain_ms=time_ms(torch, lambda: group_norm.group_norm_silu_nchw(x, scale, bias, 32, 1e-5, silu),
                                            iters=5, warmup=1),
                           library_ms=None if silu else time_ms(
                               torch, lambda: F.group_norm(x, 32, scale_d, bias_d, 1e-5)))
                rows.append(row)
                lib = "-" if silu else f"{row['library_ms']:.4f}"
                host = "-" if row["host_us"] is None else f"{row['host_us']:.1f}"
                log(f"  group_norm {where}: max_abs_err {err:.2e}  kernel {row['ms']:.4f} ms  device "
                    f"{row['device_ms']:.4f} ms ({bound / row['device_ms']:.0%} of bound)  host {host} us  bound "
                    f"{bound:.4f} ms ({bound_by})  plain {row['plain_ms']:.4f} ms  F.group_norm {lib} ms  cs "
                    f"{row['cs'] or '-'} {row['path'] or '-'}")
            del x
    return rows


def group_norm_shapes_per_forward(cfg, lat_h: int, lat_w: int, with_up: bool, concat: int = 1) -> dict:
    """GroupNorm32 calls of one UNet (``with_up``) or Aggregator (``concat=2``:
    its H-concat; no up path, no ``conv_norm_out``) forward, by (C, H, W): each
    resnet normalises its input (a skip connection added on the up path) and
    its output channels, each Transformer2D its channels."""
    from instantir_tpu_torch.models.unet import down_stack_channels

    counts: dict = {}
    chans = cfg.block_out_channels

    def add(c: int, level: int, k: int = 1):
        key = (c, (lat_h * concat) >> level, lat_w >> level)
        counts[key] = counts.get(key, 0) + k

    c_in = chans[0]
    for i, kind in enumerate(cfg.down_block_types):
        for _ in range(cfg.layers_per_block):
            add(c_in, i)
            add(chans[i], i, 2 if kind == "CrossAttnDownBlock2D" else 1)
            c_in = chans[i]
    add(chans[-1], len(chans) - 1, 5)  # the mid block: two resnets and a transformer
    if with_up:
        skips = list(down_stack_channels(cfg))
        for i, kind in enumerate(cfg.up_block_types):
            level = len(chans) - 1 - i
            for _ in range(cfg.layers_per_block + 1):
                add(c_in + skips.pop(), level)
                c_in = chans[level]
                add(c_in, level, 2 if kind == "CrossAttnUpBlock2D" else 1)
        add(chans[0], 0)  # conv_norm_out
    return counts


def forwards_per_restore(phases):
    """(UNet forwards, Aggregator forwards) of one restore: a step of mode A
    runs the Aggregator and the main UNet, B adds the previewer UNet, C runs
    the UNet."""
    n_unet = sum({"A": 1, "B": 2, "C": 1}[p["mode"]] * len(p["t"]) for p in phases)
    n_agg = sum(len(p["t"]) for p in phases if p["mode"] != "C")
    return n_unet, n_agg


def group_norm_launches_by_shape(cfg, phases, lat: int) -> dict:
    """K5 launches of one restore by (C, H, W) (batch 2 throughout)."""
    n_unet, n_agg = forwards_per_restore(phases)
    out: dict = {}
    for counts, n in ((group_norm_shapes_per_forward(cfg, lat, lat, with_up=True), n_unet),
                      (group_norm_shapes_per_forward(cfg, lat, lat, with_up=False, concat=2), n_agg)):
        for shape, k in counts.items():
            out[shape] = out.get(shape, 0) + k * n
    return out


def flash_calls_per_forward(cfg, lat_h: int, lat_w: int, with_up: bool, concat: int = 1) -> dict:
    """Flash-kernel launches of one UNet (``with_up``) or Aggregator
    (``concat=2``, no up path) forward, by sequence length: every
    self-attention whose sequence is >= 512 tokens (q >= 128 too)."""
    counts: dict = {}
    n = len(cfg.block_out_channels)

    def add(level: int, blocks: int):
        s = (lat_h * concat >> level) * (lat_w >> level)
        if s >= 512 and blocks:
            counts[s] = counts.get(s, 0) + blocks

    for i, kind in enumerate(cfg.down_block_types):
        if kind == "CrossAttnDownBlock2D":
            add(i, cfg.layers_per_block * cfg.transformer_layers_per_block[i])
    add(n - 1, cfg.transformer_layers_per_block[-1])  # mid block
    if with_up:
        for i, kind in enumerate(cfg.up_block_types):
            if kind == "CrossAttnUpBlock2D":
                add(n - 1 - i, (cfg.layers_per_block + 1) * cfg.transformer_layers_per_block[n - 1 - i])
    return counts


def flash_launches_by_seq(phases, unet_calls: dict, agg_calls: dict) -> dict:
    """Launches per sequence length in one restore: a step of mode A runs the
    Aggregator and the main UNet, B adds the previewer UNet, C runs the UNet."""
    by_seq: dict = {}
    for p in phases:
        n_unet, n_agg = {"A": (1, 1), "B": (2, 1), "C": (1, 0)}[p["mode"]]
        for calls, n in ((unet_calls, n_unet), (agg_calls, n_agg)):
            for s, c in calls.items():
                by_seq[s] = by_seq.get(s, 0) + c * n * len(p["t"])
    return by_seq


def group_norms_per_forward(cfg, with_up: bool = True) -> dict:
    """GroupNorm32 calls of one UNet forward (two per resnet, one per
    Transformer2D, plus ``conv_norm_out``), in all and in the first down block
    alone; the Aggregator (``with_up=False``) has the down and mid path only."""
    down0 = 2 * cfg.layers_per_block + (cfg.layers_per_block if cfg.down_block_types[0] != "DownBlock2D" else 0)
    total = 2  # the mid block's transformer and conv_norm_out
    total += 2 * 2  # mid resnets
    for kind in cfg.down_block_types:
        total += cfg.layers_per_block * (3 if kind == "CrossAttnDownBlock2D" else 2)
    if with_up:
        for kind in cfg.up_block_types:
            total += (cfg.layers_per_block + 1) * (3 if kind == "CrossAttnUpBlock2D" else 2)
    else:
        total -= 1  # no conv_norm_out
    return {"total": total, "down0": down0}


def expected_train_launches(cfg, lat: int, checkpointing: bool) -> dict:
    """Kernel launches of one stage-1 ``train_step`` (no accumulation). Only the
    image-prompt projections and the Resampler train, so the first transformer
    block's self-attention precedes every trainable leaf: it needs no gradient
    and runs the inference forward (K1); every later long self-attention runs
    the forward with lse (K2) and, once, dQ (K3) and dK/dV (K4). Gradient
    checkpointing runs every block that holds or follows a trainable leaf a
    second time (all but the first down block, which has no attention)."""
    n_long = sum(flash_calls_per_forward(cfg, lat, lat, with_up=True).values())
    first_level = next(i for i, kind in enumerate(cfg.down_block_types) if kind == "CrossAttnDownBlock2D")
    first_is_long = (lat >> first_level) ** 2 >= 512
    no_grad = 1 if first_is_long else 0
    passes = 2 if checkpointing else 1
    gn = group_norms_per_forward(cfg)
    gn_launches = gn["total"] + ((gn["total"] - gn["down0"] - 1) if checkpointing else 0)
    return {"flash_attention_fwd": no_grad * passes, "flash_attention_fwd_lse": (n_long - no_grad) * passes,
            "flash_attention_bwd_dq": n_long - no_grad, "flash_attention_bwd_dkv": n_long - no_grad,
            "group_norm_silu": gn_launches}


COUNTERS = {
    "flash_attention_fwd": ("attention", "flash_attention_launches"),
    "flash_attention_fwd_lse": ("attention", "flash_attention_lse_launches"),
    "flash_attention_bwd_dq": ("attention", "flash_backward_dq_launches"),
    "flash_attention_bwd_dkv": ("attention", "flash_backward_dkv_launches"),
    "group_norm_silu": ("group_norm", "group_norm_launches"),
}


def zero_counters(mods: dict) -> None:
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counters(mods: dict) -> dict:
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in COUNTERS.items()}


def restore_config(steps: int):
    """The restore's settings: BASELINE config #4 at ``steps`` denoise steps."""
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig

    return RestoreConfig(num_inference_steps=steps, guidance_scale=7.0, preview_start=0.1, control_guidance_end=0.7)


def run_restore(torch, steps: int, mods: dict, ucfg):
    """Phase 4: the port's restore path at full SDXL width on the card, with
    the fused GroupNorm off and on."""
    from instantir_tpu_torch.models.attention import Attention
    from instantir_tpu_torch.models.dinov2 import dinov2_large_config
    from instantir_tpu_torch.models.resampler import instantir_resampler_config
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    group_norm = mods["group_norm"]
    res = 1024
    t0 = time.time()
    pipe = build_pipeline(ucfg, sdxl_vae_config(), instantir_resampler_config(lora_rank=64), dinov2_large_config(),
                          seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.aggregator, pipe.vae, pipe.resampler, pipe.image_encoder)
                   for p in m.parameters())
    log(f"  built SDXL-width pipeline ({n_params / 1e9:.3f} B parameters) in {time.time() - t0:.1f} s")

    g = torch.Generator(device="cuda").manual_seed(1)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)

    # a UNet forward (CFG batch 2, 512² latents -> S=4096/1024) through the flash
    # path against the same forward through the plain attention path
    lat = torch.randn(2, 4, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    ip = torch.randn(2, 64, 2048, generator=g, device="cuda").to(torch.bfloat16)
    text = torch.cat([pe, pe])
    tids = torch.tensor([[512, 512, 0, 0, 512, 512]] * 2, dtype=torch.bfloat16, device="cuda")
    attns = [m for m in pipe.unet.modules() if isinstance(m, Attention)]
    default_fused = group_norm.USE_FUSED

    def forward(use_flash: bool, fused: bool):
        for m in attns:
            m.use_flash = use_flash
        group_norm.USE_FUSED = fused
        with torch.no_grad():
            out = pipe.unet(lat, torch.tensor([501, 501], device="cuda"), text, torch.cat([pooled, pooled]), tids,
                            ip_hidden_states=ip, lora_scale=1.0).float()
        for m in attns:
            m.use_flash = True
        group_norm.USE_FUSED = default_fused
        return out

    plain = forward(use_flash=False, fused=False)
    for what, out in (("flash vs plain attention path", forward(True, False)),
                      ("fused vs plain GroupNorm", forward(False, True))):
        rel = ((out - plain).norm() / plain.norm()).item()
        log(f"  UNet forward, {what}: relative L2 difference {rel:.3e}")
        if not (torch.isfinite(out).all() and rel <= FORWARD_TOL):
            fail(f"UNet forward, {what}: relative L2 {rel} > {FORWARD_TOL}")
    del plain, out

    cfg = restore_config(steps)
    phases = build_step_phases(cfg)
    lat_hw = res // 8
    unet_calls = flash_calls_per_forward(ucfg, lat_hw, lat_hw, with_up=True)
    agg_calls = flash_calls_per_forward(ucfg, lat_hw, lat_hw, with_up=False, concat=2)
    by_seq = flash_launches_by_seq(phases, unet_calls, agg_calls)
    n_unet, n_agg = forwards_per_restore(phases)
    expected = {"flash_attention_fwd": sum(by_seq.values()),
                "group_norm_silu": n_unet * group_norms_per_forward(ucfg)["total"]
                + n_agg * group_norms_per_forward(ucfg, with_up=False)["total"]}
    by_shape = sum(group_norm_launches_by_shape(ucfg, phases, lat_hw).values())
    if by_shape != expected["group_norm_silu"]:
        fail(f"GroupNorm launches derived by shape ({by_shape}) differ from those derived by block "
             f"({expected['group_norm_silu']})")
    log(f"  phases {[(p['mode'], len(p['t'])) for p in phases]}; flash launches per UNet forward {unet_calls}, "
        f"per Aggregator forward {agg_calls}; expected per restore: {expected}")

    def restore_once():
        t0 = time.time()
        image, _ = pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt",
                                generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        return image, time.time() - t0

    # one warm-up each (cuDNN/cuBLAS plans, allocator), then the
    # timed runs in turns, because the eager restore is bound by the host, whose
    # speed drifts by tens of percent within a call (it shares its CPU cores); a
    # setting's time is the smallest of its runs, contention only ever adding
    runs = {}
    for fused in (False, True):
        group_norm.USE_FUSED = fused
        runs[fused] = dict(warm=restore_once()[1], secs=[])
    for fused in (False, True, True, False) * (2 if steps <= 8 else 1):
        group_norm.USE_FUSED = fused
        zero_counters(mods)
        torch.cuda.reset_peak_memory_stats()
        image, sec = restore_once()
        launches = read_counters(mods)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"  restore {res}² {steps} steps, fused GroupNorm {'on' if fused else 'off'}: {sec:.3f} s/image "
            f"(first call {runs[fused]['warm']:.3f} s), peak memory {peak_gb:.2f} GB, launches {launches}")
        if tuple(image.shape) != (1, res, res, 3):
            fail(f"restored image has shape {tuple(image.shape)}, expected (1, {res}, {res}, 3)")
        if not torch.isfinite(image).all():
            fail("restored image is not finite")
        want = dict(expected, group_norm_silu=expected["group_norm_silu"] if fused else 0)
        for name, n in launches.items():
            if n != want.get(name, 0):
                fail(f"{name} launched {n} times in the restore (fused GroupNorm {fused}), expected {want.get(name, 0)}")
        runs[fused]["secs"].append(sec)
        runs[fused].update(sec=min(runs[fused]["secs"]), image=image.float(), launches=launches)
    group_norm.USE_FUSED = default_fused
    rel = ((runs[True]["image"] - runs[False]["image"]).norm() / runs[False]["image"].norm()).item()
    faster = min(runs, key=lambda f: runs[f]["sec"])
    gap = abs(runs[True]["sec"] - runs[False]["sec"]) / runs[not faster]["sec"]
    spread = max((max(r["secs"]) - min(r["secs"])) / min(r["secs"]) for r in runs.values())
    log(f"  fused GroupNorm on vs off: {runs[True]['sec']:.3f} vs {runs[False]['sec']:.3f} s/image (best of "
        f"{['%.3f' % x for x in runs[True]['secs']]} vs {['%.3f' % x for x in runs[False]['secs']]}): "
        f"{'on' if faster else 'off'} is faster by {gap:.1%}, against a spread of {spread:.1%} between one setting's "
        f"own runs{' (unresolved: the gap is inside the spread)' if gap < spread else ''}; relative L2 difference "
        f"of the images {rel:.3e}; the port's default: {'on' if default_fused else 'off'}")
    if not rel <= RESTORE_TOL:
        fail(f"restores with the fused GroupNorm on and off differ by relative L2 {rel} > {RESTORE_TOL}")
    chosen = runs[default_fused]
    return (pipe, chosen["launches"], chosen["sec"], by_seq, {f: runs[f]["sec"] for f in runs},
            runs[True]["launches"])


def _checksums(torch, params: dict) -> dict:
    """Per-leaf (sum, sum of squares) in fp64: changes with any element."""
    out = {}
    for name, p in params.items():
        x = p.detach().double()
        out[name] = (x.sum().item(), (x * x).sum().item())
    return out


def run_training(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 5: stage-1 (DCP adapter) training steps at full SDXL width."""
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

    cfg = Stage1Config(train_batch_size=2, resolution=512, lr_warmup_steps=0, max_train_steps=1000, output_dir="")
    del pipe.aggregator  # stage 1 trains without it
    torch.cuda.empty_cache()
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
    named = dict(trainer.named_parameters())
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    log(f"  stage-1 trainer: {sum(p.numel() for p in trainable.values()) / 1e6:.2f} M trainable parameters in "
        f"{len(trainable)} leaves, {sum(p.numel() for p in frozen.values()) / 1e9:.3f} B frozen in {len(frozen)}")
    before_train, before_frozen = _checksums(torch, trainable), _checksums(torch, frozen)

    g = torch.Generator(device="cuda").manual_seed(3)

    def make_batch(bsz: int, res: int):
        gt = torch.rand(bsz, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
        lq = (gt + 0.2 * torch.randn(gt.shape, generator=g, device="cuda")).clamp(-1.0, 1.0)
        cond = {"prompt_embeds": (torch.randn(bsz, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16),
                "pooled_embeds": (torch.randn(bsz, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16),
                "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * bsz, dtype=torch.bfloat16, device="cuda")}
        return trainer.prepare_batch({"lq": lq, "gt": gt}, cond)

    def step(batch, expected: dict, what: str):
        zero_counters(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        metrics = trainer.train_step(batch, generator=g)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = read_counters(mods)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        log(f"  {what}: loss {loss:.5f}  grad_norm {gnorm:.4e}  {sec:.3f} s/step  peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  launches {launches}  on {card_line}")
        if not (loss == loss and abs(loss) != float("inf") and gnorm == gnorm and abs(gnorm) != float("inf")):
            fail(f"{what}: loss {loss} or grad_norm {gnorm} is not finite")
        if launches != expected:
            fail(f"{what}: kernel launches {launches} differ from the counts derived from the config {expected}")
        return launches, sec

    fused = mods["group_norm"].USE_FUSED
    expected = expected_train_launches(ucfg, 512 // 8, checkpointing=False)
    if not fused:
        expected["group_norm_silu"] = 0
    log(f"  512² batch 2, no checkpointing; expected launches per step {expected}")
    batch = make_batch(2, 512)
    total = {name: 0 for name in COUNTERS}
    secs = []
    for i in range(3):
        launches, sec = step(batch, expected, f"train_step {i + 1}/3 at 512² batch 2")
        secs.append(sec)
        for name, n in launches.items():
            total[name] += n

    trainer.unet.gradient_checkpointing = True
    expected_big = expected_train_launches(ucfg, 1024 // 8, checkpointing=True)
    if not fused:
        expected_big["group_norm_silu"] = 0
    log(f"  1024² batch 1, gradient checkpointing; expected launches {expected_big}")
    big, big_sec = step(make_batch(1, 1024), expected_big, "train_step at 1024² batch 1, checkpointing")
    trainer.unet.gradient_checkpointing = False

    after_train, after_frozen = _checksums(torch, trainable), _checksums(torch, frozen)
    stuck = [n for n in trainable if after_train[n] == before_train[n]]
    changed = [n for n in frozen if after_frozen[n] != before_frozen[n]]
    if stuck:
        fail(f"{len(stuck)} trainable leaves did not move in 4 steps, e.g. {stuck[:5]}")
    if changed:
        fail(f"{len(changed)} frozen leaves changed, e.g. {changed[:5]}")
    log(f"  all {len(trainable)} trainable leaves moved, none of the {len(frozen)} frozen leaves changed; "
        f"512² steps {['%.3f' % s for s in secs]} s (the first includes warm-up), 1024² step {big_sec:.3f} s")
    return {"train_512": total, "train_1024": big, "sec_512": secs, "sec_1024": big_sec}


def _weighted(rows, key, weights):
    total = sum(weights)
    return sum(r[key] * w for r, w in zip(rows, weights)) / total


def kernel_entry(name, route, source, replaces, rows, weights, launches, by_path) -> dict:
    """One ``kernels`` entry: per-launch numbers averaged over the shapes the
    kernel's main path gives it, weighted by ``weights`` (one per row; the
    ragged and other check shapes carry 0); every shape's own numbers are
    under ``shapes``."""
    main = [(r, w) for r, w in zip(rows, weights) if w]
    mrows, mw = [r for r, _ in main], [w for _, w in main]
    libs = [(r, w) for r, w in main if r["library_ms"] is not None]
    bound_by = "operations" if all(r["bound_by"] == "operations" for r in mrows) else "bytes"
    extra = {"device_ms": _weighted(mrows, "device_ms", mw)} if "device_ms" in mrows[0] else {}
    return {
        "name": name, "route": route, "source": source, "replaces": replaces, "launches": launches,
        "launches_by_path": by_path, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": _weighted(mrows, "ms", mw), "plain_ms": _weighted(mrows, "plain_ms", mw),
        "bound_ms": _weighted(mrows, "bound_ms", mw), "bound_by": bound_by,
        "library_ms": _weighted([r for r, _ in libs], "library_ms", [w for _, w in libs]) if libs else None,
        **extra, "shapes": rows,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps of the full-width restore (30 = config #4)")
    ap.add_argument("--only", choices=["kernels", "group_norm"], default=None,
                    help="'kernels': stop after the kernel check (no result line); 'group_norm': check K5 alone")
    args = ap.parse_args()

    if not (REPO / "instantir_tpu_torch" / "csrc").is_dir():
        fail(f"no instantir_tpu_torch/ beside {Path(__file__).name}: run it from the root of a checkout")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, str(REPO))

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    card_line = smi[0] if smi else torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    from instantir_tpu_torch import kernels

    t0 = time.time()
    try:
        kernels.build()
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    log(f"[2] built {list(kernels.SOURCES)} in {time.time() - t0:.2f} s")
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                log(f"    {name}: {line.strip()}")

    # 3. kernel check
    from instantir_tpu_torch.models.unet import sdxl_base_config
    from instantir_tpu_torch.ops import attention, group_norm
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    mods = {"attention": attention, "group_norm": group_norm}
    ucfg = sdxl_base_config(with_ip=True, lora_rank=64)
    gn_by_shape = group_norm_launches_by_shape(ucfg, build_step_phases(restore_config(args.steps)), 1024 // 8)
    log("[3] kernel check against the plain versions")
    if args.only != "group_norm":
        k1_rows = check_flash(torch, attention)
        train_rows = check_flash_training(torch, attention)
    gn_rows = check_group_norm(torch, group_norm, gn_by_shape)
    if args.only:
        log(f"kernel check passed (--only {args.only}: no restore, no training, no result line)")
        return

    # 4. restore
    log(f"[4] restore at SDXL width, {args.steps} steps, fused GroupNorm off and on")
    pipe, restore_launches, sec, by_seq, restore_secs, fused_launches = run_restore(torch, args.steps, mods, ucfg)

    # 5. training
    log("[5] stage-1 training at SDXL width")
    train = run_training(torch, pipe, ucfg, mods, card_line)

    # 6. summary
    def by_path(name):
        return {"restore": restore_launches[name], "restore_fused_group_norm": fused_launches[name],
                "train_512": train["train_512"][name], "train_1024": train["train_1024"][name]}

    src = "instantir_tpu_torch/csrc/"
    jax_attn = "instantir_tpu/ops/attention.py"
    def shape_of(r):
        return (r["B"], r["S"], r["H"]) if r["S"] == r["Skv"] else None

    train_weights = [1 if shape_of(r) == TRAIN_SHAPES[0] else 0 for r in train_rows["fwd_lse"]]
    gn_weights = [gn_by_shape.get((r["C"], r["H"], r["W"]), 0) if r["dtype"] == "bfloat16" else 0 for r in gn_rows]
    entries = [
        kernel_entry("flash_attention_fwd", "cuda", src + "flash_fwd.cu", jax_attn + ":221", k1_rows,
                     [by_seq.get(r["S"], 0) if shape_of(r) in RESTORE_SHAPES else 0 for r in k1_rows],
                     restore_launches["flash_attention_fwd"],
                     by_path("flash_attention_fwd")),
        kernel_entry("flash_attention_fwd_lse", "cuda", src + "flash_fwd.cu", jax_attn + ":504", train_rows["fwd_lse"],
                     train_weights, train["train_512"]["flash_attention_fwd_lse"], by_path("flash_attention_fwd_lse")),
        kernel_entry("flash_attention_bwd_dq", "cuda", src + "flash_bwd.cu", jax_attn + ":597", train_rows["bwd_dq"],
                     train_weights, train["train_512"]["flash_attention_bwd_dq"], by_path("flash_attention_bwd_dq")),
        kernel_entry("flash_attention_bwd_dkv", "cuda", src + "flash_bwd.cu", jax_attn + ":617", train_rows["bwd_dkv"],
                     train_weights, train["train_512"]["flash_attention_bwd_dkv"], by_path("flash_attention_bwd_dkv")),
        kernel_entry("group_norm_silu", "cuda", src + "group_norm.cu",
                     "instantir_tpu/ops/group_norm.py:72", gn_rows, gn_weights,
                     fused_launches["group_norm_silu"],
                     by_path("group_norm_silu")),
    ]
    for e in entries:
        if not sum(e["launches_by_path"].values()) > 0:
            fail(f"kernel {e['name']} was launched no time on any main path")
    log(f"[6] {args.steps}-step restore: {sec:.3f} s/image (fused GroupNorm off {restore_secs[False]:.3f}, on "
        f"{restore_secs[True]:.3f}); stage-1 step at 512² batch 2: {min(train['sec_512']):.3f} s; at 1024² batch 1 "
        f"with checkpointing: {train['sec_1024']:.3f} s; on {card_line}")
    log(json.dumps({"kernels": entries}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
