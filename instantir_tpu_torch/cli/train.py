"""Training CLI of the PyTorch/CUDA port: twin of ``instantir_tpu/cli/train.py``.

``python -m instantir_tpu_torch.cli.train stage1|previewer|stage2 ...`` runs
from raw images to exported weights: the dataset (an image-folder mix from
``--data_config``, or ``--synthetic_data``), the RealESRGAN degradation on the
device, the trainer's ``run`` (prefetch, logging, checkpoints, resume,
preemption), then the export (``adapter_ckpt.pt``,
``previewer_lora_weights.bin`` or ``aggregator.pt``) and
``instantir_config.json``. Without ``--sdxl_path`` the models are drawn at
SDXL width in bf16 from ``--seed`` and the text conditioning is zero
embeddings; with it they are loaded from the checkpoint tree and each
batch's captions are encoded by the two text towers (a host cache keeps
repeated captions). One process a device: under ``torchrun --nproc_per_node
N`` the process group is joined at startup (``parallel.initialize_distributed``),
each process loads its rows of the global ``--train_batch_size`` (the
datasets' ``process_index`` / ``process_count`` from the group), the trainer
takes the group's data axis (``mesh="auto"``: the mean gradient, ZeRO-1),
and only rank 0 logs, writes checkpoints and exports.

Usage (on the card):
  python -m instantir_tpu_torch.cli.train stage1 --synthetic_data --resolution 512 \\
      --train_batch_size 2 --max_train_steps 100 --output_dir out
  torchrun --nproc_per_node 2 -m instantir_tpu_torch.cli.train stage1 --synthetic_data ...

``--validation_steps N --validation_image a.png b.png`` renders those images
(resized to ``--resolution``, LQ and GT alike) every N steps into the event
file (``train/validation.py``); ``--use_8bit_adam`` stores the Adam moments
in blockwise int8; ``--quantize_frozen_unet`` keeps the frozen UNet's bases
in int8, dequantized at use. ``stage2 --aggregator_adapter
[--adapter_tokens N]`` trains the Aggregator with its own image-prompt adapter
(``train/stage2_aggregator.py::enable_aggregator_adapter``: a Resampler of N
queries and a time-aware IP branch on every self-attention); its validation
render raises ``ValueError``, as the JAX CLI's does (the restore has no image
tokens for the Aggregator).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from instantir_tpu_torch.models.dinov2 import dinov2_large_config
from instantir_tpu_torch.models.resampler import instantir_resampler_config
from instantir_tpu_torch.models.unet import sdxl_base_config
from instantir_tpu_torch.models.vae import sdxl_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="InstantIR trainers on the PyTorch/CUDA port")
    p.add_argument("stage", choices=["stage1", "previewer", "stage2"])
    p.add_argument("--sdxl_path", type=str, default=None, help="diffusers SDXL dir (omit for random init)")
    p.add_argument("--vision_encoder_path", type=str, default=None)
    p.add_argument("--adapter_path", type=str, default=None, help="adapter.pt from stage 1")
    p.add_argument("--previewer_lora_path", type=str, default=None)
    p.add_argument("--data_config", type=str, default="config_files/IR_dataset.yaml")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--losses_config", type=str, default="config_files/losses.yaml")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--max_train_steps", type=int, default=10000)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="cosine")
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sanity_check", action="store_true")
    p.add_argument("--resume_from_checkpoint", type=str, default="latest")
    p.add_argument("--prompt", type=str, default="", help="training caption (default empty)")
    # stage-specific knobs
    p.add_argument("--image_drop_rate", type=float, default=0.05)
    p.add_argument("--text_drop_rate", type=float, default=0.85)
    p.add_argument("--cond_drop_rate", type=float, default=0.15)
    p.add_argument("--CFG_scale", type=float, default=1.0)
    p.add_argument("--use_ema_adapter", action="store_true")
    p.add_argument("--optimize_adapter", action="store_true")
    p.add_argument("--aggregator_adapter", action="store_true",
                   help="stage2: give the aggregator its own image-prompt adapter (a Resampler over the encoder "
                        "tokens + a TA-IP branch on each attn1), trained with it")
    p.add_argument("--adapter_tokens", type=int, default=64)
    p.add_argument("--importance_sampling", action="store_true")
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--w_min", type=float, default=3.0)
    p.add_argument("--w_max", type=float, default=15.0)
    p.add_argument("--synthetic_data", action="store_true", help="procedural data (smoke tests)")
    p.add_argument("--validation_steps", type=int, default=0, help="0 disables periodic validation")
    p.add_argument("--validation_image", type=str, nargs="*", default=None,
                   help="LQ image path(s) rendered every --validation_steps")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="blockwise-int8 Adam moment storage (reference --use_8bit_adam / bnb AdamW8bit)")
    p.add_argument("--quantize_frozen_unet", action="store_true",
                   help="QLoRA storage: the frozen UNet's base weights int8, dequantized at use; the trained "
                        "ip/LoRA weights stay fp")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="a worker thread prepares this many batches ahead (0: in turn; the batches are the same)")
    p.add_argument("--scale_lr", action="store_true",
                   help="scale lr by gradient_accumulation_steps x batch (reference train_stage1_adapter.py:817-820)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute UNet/Aggregator blocks in the backward pass")
    p.add_argument("--handle_preemption", action="store_true",
                   help="SIGTERM -> checkpoint at the next step boundary and exit; resume with "
                        "--resume_from_checkpoint latest")
    p.add_argument("--async_checkpointing", action="store_true",
                   help="write checkpoints from a thread, overlapping the next train steps")
    p.add_argument("--report_to", type=str, default="tensorboard", choices=["tensorboard", "wandb", "all"],
                   help="tracker backend (wandb when the package is importable)")
    return p


def _val_batch(args: argparse.Namespace) -> Optional[Dict[str, torch.Tensor]]:
    """``{"lq", "gt"}``: the ``--validation_image`` files resized to
    ``--resolution`` (bicubic), NHWC in [-1, 1]; GT is the LQ image, as the
    reference renders LQ-only validation sets. None without
    ``--validation_steps > 0`` and images."""
    if not (args.validation_steps > 0 and args.validation_image):
        return None
    from PIL import Image

    imgs = []
    for path in args.validation_image:
        im = Image.open(path).convert("RGB").resize((args.resolution, args.resolution), Image.BICUBIC)
        imgs.append(np.asarray(im, np.float32) / 127.5 - 1.0)
    arr = torch.from_numpy(np.stack(imgs))
    return {"lq": arr, "gt": arr}


def _build_models(args: argparse.Namespace, device="cuda") -> InstantIRPipeline:
    """The pipeline from ``--sdxl_path`` (bf16), else drawn at SDXL width in
    bf16 from ``--seed``: UNet with ip attention and LoRA rank 64, the
    InstantIR Resampler (LoRA rank 64), DINOv2-large, the fp32 VAE."""
    if args.sdxl_path:
        from instantir_tpu_torch.pipeline.load import load_instantir_pipeline

        return load_instantir_pipeline(args.sdxl_path, instantir_path=None, vision_encoder_path=args.vision_encoder_path,
                                       adapter_path=args.adapter_path, previewer_lora_path=args.previewer_lora_path,
                                       device=device)
    return build_pipeline(sdxl_base_config(with_ip=True, lora_rank=64), sdxl_vae_config(),
                          instantir_resampler_config(lora_rank=64), dinov2_large_config(), seed=args.seed,
                          dtype=torch.bfloat16, device=device)


def _conditioning(args: argparse.Namespace, pipe: InstantIRPipeline, batch_size: int):
    """Prompt conditioning, in the UNet's dtype on its device. Without
    ``--sdxl_path``: zero embeddings. With it: a callable ``cond(host_batch)``
    that encodes the batch's captions through the two text towers (an empty
    caption falls back to ``--prompt``), encoded captions cached on the host
    (the JAX CLI's ``lookup``)."""
    ucfg = pipe.unet.config
    dtype = next(pipe.unet.parameters()).dtype
    dev = pipe.device
    pooled_dim = ucfg.projection_class_embeddings_input_dim - ucfg.addition_time_embed_dim * 6
    res = args.resolution
    cond = {
        "prompt_embeds": torch.zeros((batch_size, 77, ucfg.cross_attention_dim), dtype=dtype, device=dev),
        "uncond_prompt_embeds": torch.zeros((batch_size, 77, ucfg.cross_attention_dim), dtype=dtype, device=dev),
        "pooled_embeds": torch.zeros((batch_size, pooled_dim), dtype=dtype, device=dev),
        "uncond_pooled_embeds": torch.zeros((batch_size, pooled_dim), dtype=dtype, device=dev),
        "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * batch_size, dtype=dtype, device=dev),
    }
    if not args.sdxl_path:
        return cond

    from instantir_tpu_torch.cli.infer import encode_prompts
    from instantir_tpu_torch.pipeline.load import load_text_encoders

    text_encoders = load_text_encoders(args.sdxl_path, device=dev)
    cache: Dict[str, Any] = {}

    def lookup(texts: List[str]):
        missing = [t for t in dict.fromkeys(texts) if t not in cache]
        for group in range(0, len(missing), batch_size):
            chunk = missing[group:group + batch_size]
            padded = chunk + [""] * (batch_size - len(chunk))  # one batch shape for the towers
            pe, pooled = encode_prompts(text_encoders, padded, dev)
            pe, pooled = pe.float().cpu().numpy(), pooled.float().cpu().numpy()
            for i, t in enumerate(chunk):
                cache[t] = (pe[i], pooled[i])
        if len(cache) > 8192:  # bound host memory on huge caption sets
            cache.clear()
            return lookup(texts)
        pe = np.stack([cache[t][0] for t in texts])
        pooled = np.stack([cache[t][1] for t in texts])
        return (torch.from_numpy(pe).to(dev, dtype), torch.from_numpy(pooled).to(dev, dtype))

    npe, npooled = lookup([""] * batch_size)

    def cond_fn(host_batch):
        captions = list(host_batch.get("captions") or [])
        captions = [(c if c else args.prompt) for c in captions] or [args.prompt] * batch_size
        pe, pooled = lookup(captions)
        return {**cond, "prompt_embeds": pe, "pooled_embeds": pooled, "uncond_prompt_embeds": npe,
                "uncond_pooled_embeds": npooled}

    return cond_fn


def _process() -> Tuple[int, int]:
    """(this process's rank, the process count) of the group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_batch(args: argparse.Namespace) -> int:
    """This process's rows of the global ``--train_batch_size``, which the process count must divide."""
    _, pc = _process()
    if args.train_batch_size % pc:
        raise ValueError(f"train_batch_size={args.train_batch_size} must divide by the process count {pc}")
    return args.train_batch_size // pc


def _data_iter(args: argparse.Namespace):
    """An endless stream of this process's raw batches at ``--resolution``
    (the GT crops the degradation takes, reference
    ``utils/train_utils.py:123-127``): per-process dataset sharding, the
    analogue of accelerate's sharded dataloader."""
    pi, pc = _process()
    if args.synthetic_data:
        from instantir_tpu_torch.data.dataset import SyntheticImageDataset

        ds = SyntheticImageDataset(seed=args.seed, process_index=pi, process_count=pc)
    else:
        from instantir_tpu_torch.data.dataset import WeightedImageDataset, load_data_config

        ds = WeightedImageDataset(load_data_config(args.data_config, args.data_dir), seed=args.seed,
                                  process_index=pi, process_count=pc)
    return ds.batches(batch_size=_local_batch(args), gt_size=args.resolution)


def _export_instantir_config(pipe: InstantIRPipeline, output_dir: str) -> str:
    """``instantir_config.json`` beside the exports: the LoRA rank and the
    Resampler's config, from which ``load_instantir_pipeline`` rebuilds the
    architecture (the reference hard-codes them, ``infer.py:269-273``)."""
    path = os.path.join(output_dir, "instantir_config.json")
    with open(path, "w") as f:
        json.dump({"lora_rank": pipe.unet.config.lora_rank, "resampler": dataclasses.asdict(pipe.resampler.config)},
                  f, indent=2)
    return path


def main(argv: Optional[List[str]] = None, device="cuda", pipe: Optional[InstantIRPipeline] = None) -> Dict[str, Any]:
    """Train one stage and export its weights. ``pipe`` (an
    ``InstantIRPipeline`` on its device) spares a caller that trains several
    times the building or loading of the models, which it then trains in
    place. Returns ``{"trainer", "records" (the logged metrics of ``run``),
    "exports" (the written files)}``."""
    args = build_parser().parse_args(argv)
    from instantir_tpu_torch.losses import load_losses_config
    from instantir_tpu_torch.parallel import initialize_distributed

    initialize_distributed(device=pipe.device if pipe is not None else device)  # a no-op without torchrun

    losses_cfg = load_losses_config(args.losses_config) if os.path.exists(args.losses_config) else None
    if pipe is None:
        pipe = _build_models(args, device)
    if args.gradient_checkpointing:
        pipe.unet.gradient_checkpointing = True
        if getattr(pipe, "aggregator", None) is not None:
            pipe.aggregator.gradient_checkpointing = True
    cond = _conditioning(args, pipe, _local_batch(args))
    data = _data_iter(args)
    if args.scale_lr:
        args.learning_rate *= args.gradient_accumulation_steps * args.train_batch_size

    shared = dict(
        output_dir=args.output_dir, max_train_steps=args.max_train_steps, train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps, learning_rate=args.learning_rate,
        use_8bit_adam=args.use_8bit_adam, quantize_frozen_unet=args.quantize_frozen_unet,
        prefetch_batches=args.prefetch_batches, validation_steps=args.validation_steps,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps, resolution=args.resolution,
        checkpointing_steps=args.checkpointing_steps, checkpoints_total_limit=args.checkpoints_total_limit,
        seed=args.seed, sanity_check=args.sanity_check, resume_from_checkpoint=args.resume_from_checkpoint,
        handle_preemption=args.handle_preemption, async_checkpointing=args.async_checkpointing,
        report_to=args.report_to,
    )
    models = (pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder)
    if args.stage == "stage1":
        from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

        cfg = Stage1Config(image_drop_rate=args.image_drop_rate, importance_sampling=args.importance_sampling, **shared)
        trainer = Stage1Trainer(*models, cfg, losses_cfg, device=pipe.device)
        export, name = trainer.export_adapter, "adapter_ckpt.pt"
    elif args.stage == "previewer":
        from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer

        cfg = PreviewerConfig(num_ddim_timesteps=args.num_ddim_timesteps, w_min=args.w_min, w_max=args.w_max,
                              image_drop_rate=args.image_drop_rate, **shared)
        trainer = PreviewerTrainer(*models, cfg, losses_cfg, device=pipe.device)
        export, name = trainer.export_lora, "previewer_lora_weights.bin"
    else:
        from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

        cfg = Stage2Config(image_drop_rate=args.image_drop_rate, text_drop_rate=args.text_drop_rate,
                           cond_drop_rate=args.cond_drop_rate, cfg_scale=args.CFG_scale,
                           use_ema_adapter=args.use_ema_adapter, optimize_adapter=args.optimize_adapter,
                           aggregator_adapter=args.aggregator_adapter, adapter_tokens=args.adapter_tokens,
                           importance_sampling=args.importance_sampling, **shared)
        aggregator, agg_resampler = pipe.aggregator, None
        if cfg.aggregator_adapter:
            from instantir_tpu_torch.train.stage2_aggregator import enable_aggregator_adapter

            aggregator, agg_resampler = enable_aggregator_adapter(
                pipe.aggregator, pipe.aggregator.state_dict(), pipe.image_encoder.config.hidden_size, cfg,
                seed=args.seed)
        trainer = Stage2Trainer(pipe.unet, aggregator, *models[1:], cfg, losses_cfg, device=pipe.device,
                                agg_resampler=agg_resampler)
        export, name = trainer.export_aggregator, "aggregator.pt"
    records = trainer.run(data, cond, val_batch=_val_batch(args))
    exports = []
    if trainer.is_main:  # the reference's accelerator.is_main_process gating
        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir, name)
        export(path)
        exports = [path, _export_instantir_config(pipe, args.output_dir)]
        print(f"[train] {args.stage}: {trainer.global_step} steps, wrote {exports}")
    return {"trainer": trainer, "records": records, "exports": exports}


if __name__ == "__main__":
    main()
