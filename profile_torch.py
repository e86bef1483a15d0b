#!/usr/bin/env python3
"""Where the time of one restore of the PyTorch/CUDA port goes, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 profile_torch.py [--steps 4]``.
It builds the pipeline ``chip_smoke.py`` drives (SDXL width, synthetic
weights, bf16 models and an fp32 VAE, 1024², CFG 7, preview_start 0.1,
control_guidance_end 0.7), runs one warm-up restore, then reports

1. host wall time of one restore and the device time of each stage (CUDA
   events around every model call, summed over the restore; a stage's time
   includes any device idle inside it);
2. a ``torch.profiler`` trace of one more restore: device kernel time by
   kernel name (top 25) and the device busy share (kernel time / wall time).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: FAILED: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(REPO))
    from instantir_tpu_torch.models.dinov2 import dinov2_large_config
    from instantir_tpu_torch.models.resampler import instantir_resampler_config
    from instantir_tpu_torch.models.unet import sdxl_base_config
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(f"card: {card[0] if card else torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pipe = build_pipeline(sdxl_base_config(with_ip=True, lora_rank=64), sdxl_vae_config(),
                          instantir_resampler_config(lora_rank=64), dinov2_large_config(), seed=0,
                          dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    lq = torch.rand(1, 1024, 1024, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    cfg = RestoreConfig(num_inference_steps=args.steps, guidance_scale=7.0, preview_start=0.1,
                        control_guidance_end=0.7)

    def restore():
        pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt")
        torch.cuda.synchronize()

    restore()  # warm-up

    # 1. per-stage device time
    events = []
    stages = {
        "unet (previewer, LoRA on)": None, "unet (main)": None, "aggregator": pipe.aggregator,
        "vae encoder": pipe.vae.encoder, "vae decoder": pipe.vae.decoder, "dinov2": pipe.image_encoder,
        "resampler": pipe.resampler,
    }
    handles = []

    def hooks(label_of):
        def pre(module, a, kw):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            module._stage_start = (label_of(kw), start)

        def post(module, a, kw, out):
            label, start = module._stage_start
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((label, start, end))

        return pre, post

    for label, module in stages.items():
        if module is not None:
            pre, post = hooks(lambda kw, label=label: label)
            handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
            handles.append(module.register_forward_hook(post, with_kwargs=True))
    pre, post = hooks(lambda kw: "unet (previewer, LoRA on)" if kw.get("lora_scale", 0.0) else "unet (main)")
    handles.append(pipe.unet.register_forward_pre_hook(pre, with_kwargs=True))
    handles.append(pipe.unet.register_forward_hook(post, with_kwargs=True))

    t0 = time.time()
    restore()
    wall = time.time() - t0
    for h in handles:
        h.remove()
    per_stage, calls = defaultdict(float), defaultdict(int)
    for label, start, end in events:
        per_stage[label] += start.elapsed_time(end)
        calls[label] += 1
    print(f"\n{args.steps}-step restore: {wall:.3f} s host wall time", flush=True)
    print(f"{'stage':<28}{'calls':>6}{'device ms':>12}{'ms/call':>10}{'share':>8}")
    for label in stages:
        if calls[label]:
            ms = per_stage[label]
            print(f"{label:<28}{calls[label]:>6}{ms:>12.1f}{ms / calls[label]:>10.2f}{ms / (wall * 1e3):>8.1%}")
    rest = wall * 1e3 - sum(per_stage.values())
    print(f"{'outside the stages':<28}{'':>6}{rest:>12.1f}{'':>10}{rest / (wall * 1e3):>8.1%}", flush=True)

    # 2. profiler trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        restore()
        wall = time.time() - t0
    kernel_us = defaultdict(float)
    kernel_n = defaultdict(int)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernel_us[evt.name] += evt.time_range.elapsed_us()
            kernel_n[evt.name] += 1
    busy = sum(kernel_us.values()) / 1e3
    print(f"\nprofiled restore: {wall:.3f} s wall, device kernel time {busy:.1f} ms "
          f"-> busy share {busy / (wall * 1e3):.1%} (profiler on)")
    if busy == 0:
        print("the profiler recorded no device time on this machine")
        return
    print(f"{'kernel':<90}{'calls':>7}{'ms':>10}{'share':>8}")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{name[:88]:<90}{kernel_n[name]:>7}{us / 1e3:>10.1f}{us / 1e3 / busy:>8.1%}")


if __name__ == "__main__":
    main()
