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
3. kernel check: each kernel against its plain PyTorch version on the card at
   the main path's shapes (plus ragged ones), with time, bound, the plain
   version's time and a one-call library yardstick;
4. restore at full SDXL width with synthetic weights: a UNet forward with the
   flash path against the plain attention path, then ``restore`` with every
   launch counter set to 0 just before and read just after; the counts must
   match the schedule, the image must be finite and 1024² RGB;
5. summary: one JSON line of kernels, the card line, and the result line.

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
# (B, S, H) of the flash kernel on the main path -- UNet S=4096/1024, Aggregator
# H-concat S=8192/2048, CFG batch 2 -- plus a ragged 768² shape and S % 64 != 0
FLASH_SHAPES = [(2, 4096, 10), (2, 1024, 20), (2, 8192, 10), (2, 2048, 20), (2, 2304, 10), (2, 1000, 10)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound_ms(b: int, s: int, h: int, d: int = 64):
    flops = 4.0 * b * h * s * s * d  # Q·K^T and P·V, 2 flops per multiply-add
    nbytes = 4.0 * b * s * h * d * 2  # q, k, v read once, o written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_flash(torch, attention) -> list:
    """Phase 3: the flash kernel against its plain version at every shape."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, h in FLASH_SHAPES:
        q, k, v = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        out = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.flash_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: attention.flash_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: attention.flash_attention_reference(q, k, v), iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound, bound_by = flash_bound_ms(b, s, h)
        row = dict(B=b, S=s, H=h, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   library_ms=library_ms)
        rows.append(row)
        log(f"  flash B={b} S={s} H={h}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  bound {bound:.4f} ms "
            f"({bound_by})  plain {plain_ms:.3f} ms  sdpa {library_ms:.4f} ms  "
            f"({4.0 * b * h * s * s * 64 / ms / 1e9:.1f} TFLOP/s)")
        if not err <= FLASH_TOL:
            fail(f"flash kernel disagrees with flash_attention_reference at B={b} S={s} H={h}: "
                 f"max abs error {err} > {FLASH_TOL}")
    return rows


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


def run_restore(torch, steps: int, attention):
    """Phase 4: the port's main path at full SDXL width on the card."""
    from instantir_tpu_torch.models.attention import Attention
    from instantir_tpu_torch.models.dinov2 import dinov2_large_config
    from instantir_tpu_torch.models.resampler import instantir_resampler_config
    from instantir_tpu_torch.models.unet import sdxl_base_config
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig, build_step_phases

    res = 1024
    ucfg = sdxl_base_config(with_ip=True, lora_rank=64)
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
    outs = []
    with torch.no_grad():
        for use_flash in (True, False):
            for m in attns:
                m.use_flash = use_flash
            outs.append(pipe.unet(lat, torch.tensor([501, 501], device="cuda"), text, torch.cat([pooled, pooled]),
                                  tids, ip_hidden_states=ip, lora_scale=1.0).float())
    for m in attns:
        m.use_flash = True
    rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    log(f"  UNet forward, flash vs plain attention path: relative L2 difference {rel:.3e}")
    if not (torch.isfinite(outs[0]).all() and rel <= 5e-2):
        fail(f"UNet forward through the flash kernel disagrees with the plain path (relative L2 {rel})")
    del outs

    cfg = RestoreConfig(num_inference_steps=steps, guidance_scale=7.0, preview_start=0.1, control_guidance_end=0.7)
    phases = build_step_phases(cfg)
    lat_hw = res // 8
    unet_calls = flash_calls_per_forward(ucfg, lat_hw, lat_hw, with_up=True)
    agg_calls = flash_calls_per_forward(ucfg, lat_hw, lat_hw, with_up=False, concat=2)
    by_seq = flash_launches_by_seq(phases, unet_calls, agg_calls)
    expected = sum(by_seq.values())
    log(f"  phases {[(p['mode'], len(p['t'])) for p in phases]}; flash launches per UNet forward {unet_calls}, "
        f"per Aggregator forward {agg_calls}; expected per restore: {expected}")

    t0 = time.time()
    pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt")  # warm-up: cuDNN/cuBLAS plans, allocator
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    attention.flash_attention_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    image, _ = pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt")
    torch.cuda.synchronize()
    sec = time.time() - t0
    launches = {"flash_attention_fwd": attention.flash_attention_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  restore {res}² {steps} steps: {sec:.3f} s/image (first call {warm_s:.3f} s), peak memory {peak_gb:.2f} GB, "
        f"flash launches {launches['flash_attention_fwd']}")
    if tuple(image.shape) != (1, res, res, 3):
        fail(f"restored image has shape {tuple(image.shape)}, expected (1, {res}, {res}, 3)")
    if not torch.isfinite(image).all():
        fail("restored image is not finite")
    if launches["flash_attention_fwd"] != expected:
        fail(f"flash kernel launched {launches['flash_attention_fwd']} times in the restore, expected {expected}")
    return launches, sec, by_seq


def kernel_entry(rows, launches: int, weight: dict) -> dict:
    """One ``kernels`` entry: per-launch numbers averaged over the main
    path's launches, weighted by the launches at each sequence length (the
    ragged check shapes carry no weight); every shape's own numbers are under
    ``shapes``."""
    main = [r for r in rows if r["S"] in weight]
    total = sum(weight[r["S"]] for r in main)

    def mean(key):
        return sum(r[key] * weight[r["S"]] for r in main) / total

    bound_by = "operations" if all(r["bound_by"] == "operations" for r in main) else "bytes"
    return {
        "name": "flash_attention_fwd", "route": "cuda", "source": "instantir_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "instantir_tpu/ops/attention.py:221", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": bound_by, "library_ms": mean("library_ms"), "shapes": rows,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="denoise steps of the full-width restore (30 = config #4)")
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
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # 3. kernel check
    from instantir_tpu_torch.ops import attention

    log("[3] kernel check against the plain versions")
    rows = check_flash(torch, attention)

    # 4. restore
    log(f"[4] restore at SDXL width, {args.steps} steps")
    launches, sec, by_seq = run_restore(torch, args.steps, attention)

    # 5. summary
    entry = kernel_entry(rows, launches["flash_attention_fwd"], by_seq)
    log(f"[5] {args.steps}-step restore: {sec:.3f} s/image on {card_line}")
    log(json.dumps({"kernels": [entry]}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
