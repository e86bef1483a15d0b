#!/usr/bin/env python3
"""Where the time of one restore, or of one stage-1 training step, of the
PyTorch/CUDA port goes, on one NVIDIA GPU.

Run from the root of a checkout: ``python3 profile_torch.py [--steps 4]
[--fused] [--fuse-lora]`` or ``python3 profile_torch.py --train [--resolution
512 --batch 2]``.
It builds the models ``chip_smoke.py`` drives (SDXL width, synthetic weights,
bf16 models and an fp32 VAE), warms up, then reports

1. host wall time of one restore (1024², CFG 7, preview_start 0.1,
   control_guidance_end 0.7) or one ``Stage1Trainer`` step and the device time
   of each stage (CUDA events around every model call -- for a step also around
   the backward pass and the optimiser; a stage's time includes any device idle
   inside it);
2. a ``torch.profiler`` trace of one more restore or step: device kernel time
   by kernel name (top 25) and the device busy share (kernel time / wall time).

``--fused`` profiles the restore as one CUDA graph (``RestoreConfig.fused``),
recorded during the warm-up: a replay runs no Python, so part 1 (module hooks)
is skipped and part 2 traces a replay. ``--fuse-lora`` sets
``fuse_previewer_lora``.

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
    ap.add_argument("--steps", type=int, default=4, help="denoise steps of the restore")
    ap.add_argument("--train", action="store_true", help="profile one stage-1 training step, not a restore")
    ap.add_argument("--resolution", type=int, default=512, help="--train: image size")
    ap.add_argument("--batch", type=int, default=2, help="--train: batch size")
    ap.add_argument("--checkpointing", action="store_true", help="--train: gradient checkpointing in the UNet")
    ap.add_argument("--fused", action="store_true", help="restore: replay it as one CUDA graph (part 2 only)")
    ap.add_argument("--fuse-lora", action="store_true", help="restore: merge the previewer LoRA (fuse_previewer_lora)")
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
                        control_guidance_end=0.7, fused=args.fused, fuse_previewer_lora=args.fuse_lora)

    events = []

    def timed(label, fn):
        """Run ``fn`` between two CUDA events recorded under ``label``."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events.append((label, start, end))
        return out

    if args.train:
        from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

        del pipe.aggregator
        res, bsz = args.resolution, args.batch
        trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder,
                                Stage1Config(train_batch_size=bsz, resolution=res, lr_warmup_steps=0, output_dir=""),
                                device="cuda")
        trainer.unet.gradient_checkpointing = args.checkpointing
        gt = torch.rand(bsz, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
        noisy = (gt + 0.2 * torch.randn(gt.shape, generator=g, device="cuda")).clamp(-1.0, 1.0)
        batch = trainer.prepare_batch({"lq": noisy, "gt": gt}, {
            "prompt_embeds": pe.expand(bsz, -1, -1), "pooled_embeds": pooled.expand(bsz, -1),
            "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * bsz, dtype=torch.bfloat16, device="cuda")})
        what = f"stage-1 step at {res}², batch {bsz}" + (", gradient checkpointing" if args.checkpointing else "")

        def restore():  # one training step, in the pieces ``train_step`` is made of
            total, _ = trainer.loss(batch, generator=g)
            grads = timed("backward", lambda: torch.autograd.grad(total, trainer.trainable))
            timed("optimiser", lambda: trainer.optimizer.step(list(grads)))
            torch.cuda.synchronize()

        stages = {"vae encoder": pipe.vae.encoder, "dinov2": pipe.image_encoder, "resampler": pipe.resampler,
                  "unet forward": pipe.unet, "backward": None, "optimiser": None}
    else:
        what = f"{args.steps}-step restore" + (", one CUDA graph" if args.fused else "") + (
            ", merged LoRA" if args.fuse_lora else "")

        def restore():
            pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt")
            torch.cuda.synchronize()

        stages = {
            "unet (previewer, LoRA on)": None, "unet (main)": None, "aggregator": pipe.aggregator,
            "vae encoder": pipe.vae.encoder, "vae decoder": pipe.vae.decoder, "dinov2": pipe.image_encoder,
            "resampler": pipe.resampler,
        }

    restore()  # warm-up (with --fused: warm-up, recording and a replay)
    restore()
    events.clear()
    if args.fused:
        t0 = time.time()
        restore()
        print(f"\n{what}: {time.time() - t0:.3f} s host wall time (a replay)", flush=True)
    else:
        profile_stages(torch, restore, stages, events, what, args.train, pipe)
    profile_kernels(torch, restore, what)


def profile_stages(torch, restore, stages: dict, events: list, what: str, train: bool, pipe) -> None:
    """Part 1: device time per stage, from CUDA events around every model call."""
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
    if not train:
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
    print(f"\n{what}: {wall:.3f} s host wall time", flush=True)
    print(f"{'stage':<28}{'calls':>6}{'device ms':>12}{'ms/call':>10}{'share':>8}")
    for label in stages:
        if calls[label]:
            ms = per_stage[label]
            print(f"{label:<28}{calls[label]:>6}{ms:>12.1f}{ms / calls[label]:>10.2f}{ms / (wall * 1e3):>8.1%}")
    rest = wall * 1e3 - sum(per_stage.values())
    print(f"{'outside the stages':<28}{'':>6}{rest:>12.1f}{'':>10}{rest / (wall * 1e3):>8.1%}", flush=True)


def profile_kernels(torch, restore, what: str) -> None:
    """Part 2: a ``torch.profiler`` trace: device time by kernel and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        restore()
        wall = time.time() - t0
    kernel_us = defaultdict(float)
    kernel_n = defaultdict(int)
    for evt in prof.events():
        # device activity only: the optimiser's range annotation is mirrored onto the device timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.name.startswith("Optimizer."):
            kernel_us[evt.name] += evt.time_range.elapsed_us()
            kernel_n[evt.name] += 1
    busy = sum(kernel_us.values()) / 1e3
    print(f"\nprofiled {what}: {wall:.3f} s wall, device kernel time {busy:.1f} ms "
          f"-> busy share {busy / (wall * 1e3):.1%} (profiler on)")
    if busy == 0:
        print("the profiler recorded no device time on this machine")
        return
    print(f"{'kernel':<90}{'calls':>7}{'ms':>10}{'share':>8}")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:25]:
        print(f"{name[:88]:<90}{kernel_n[name]:>7}{us / 1e3:>10.1f}{us / 1e3 / busy:>8.1%}")
    print("\nthe port's own kernels:")
    for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1]):
        if any(tag in name for tag in ("flash_fwd", "flash_bwd", "group_norm_silu_kernel")):
            print(f"{name[:88]:<90}{kernel_n[name]:>7}{us / 1e3:>10.1f}{us / 1e3 / busy:>8.1%}")


if __name__ == "__main__":
    main()
