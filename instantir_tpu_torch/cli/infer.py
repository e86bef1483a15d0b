"""Restoration CLI of the PyTorch/CUDA port: twin of ``instantir_tpu/cli/infer.py``.

Batch restoration: list the images, resize each to a /64-aligned size (min side
768, max 1024: the reference's ``resize_img``, ``infer.py:31-66``), encode the
default quality prompts with the two SDXL text towers, restore, resize back
to the input's size and save. Images of one batch that resize to different
sizes are restored in groups of one size. The file handling (Pillow) lives in
``main``; ``restore_arrays`` does the work on arrays.

Usage (on the card; ``--fused`` replays one CUDA graph per image size):
  python -m instantir_tpu_torch.cli.infer \\
      --sdxl_path /path/sdxl --instantir_path /path/instantir \\
      --vision_encoder_path /path/dinov2 --test_path lq_dir --out_path out

``--quantized w8a8|w8`` quantizes the UNet and the Aggregator to int8 after
the load (``InstantIRPipeline.quantize``; on a pipeline passed in as
``models``, in place). ``--use_clip_encoder`` reads ``--vision_encoder_path``
as an HF CLIP vision tower (``load_instantir_pipeline(use_clip_encoder=True)``).
``--sequence_parallel`` (under ``torchrun --nproc_per_node N``, one process
a GPU) restores each image on every rank and rings every self-attention of at
least ``--sp_min_seq`` tokens over the ranks (``InstantIRPipeline.shard``);
rank 0 writes the images. The process group is joined at startup
(``parallel.initialize_distributed``, a no-op without torchrun). The noise
comes from a ``torch.Generator`` seeded with ``--seed``: the same seed draws
other noise than the JAX CLI's ``jax.random.PRNGKey``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from instantir_tpu_torch.models.clip_text import encode_sdxl_prompt
from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreConfig
from instantir_tpu_torch.pipeline.load import load_instantir_pipeline, load_text_encoders
from instantir_tpu_torch.utils.text import tokenize_prompt
from instantir_tpu_torch.utils.watermark import embed_watermark

DEFAULT_PROMPT = (
    "Photorealistic, highly detailed, hyper detailed photo - realistic maximum detail, 32k, "
    "ultra HD, extreme meticulous detailing, skin pore detailing, "
    "hyper sharpness, perfect without deformations, "
    "taken using a Canon EOS R camera, Cinematic, High Contrast, Color Grading. "
)
DEFAULT_NEG_PROMPT = (
    "blurry, out of focus, unclear, depth of field, over-smooth, "
    "sketch, oil painting, cartoon, CG Style, 3D render, unreal engine, "
    "dirty, messy, worst quality, low quality, frames, painting, illustration, drawing, art, "
    "watermark, signature, jpeg artifacts, deformed, lowres"
)


def resize_img(pil_image, max_side: int = 1024, min_side: int = 768, width: Optional[int] = None,
               height: Optional[int] = None, base_pixel_number: int = 64):
    """Reference ``resize_img`` (``infer.py:31-66``): fit the image to
    [min_side, max_side], then floor each side to a multiple of
    ``base_pixel_number``. Returns (the resized image, the size to save at)."""
    from PIL import Image

    w, h = pil_image.size
    if width is not None and height is not None:
        out_w, out_h = width, height
    elif width is not None:
        out_w, out_h = width, round(h * width / w)
    elif height is not None:
        out_w, out_h = round(w * height / h), height
    else:
        out_w, out_h = w, h
    w, h = out_w, out_h
    if min(w, h) < min_side:
        ratio = min_side / min(w, h)
        w, h = round(ratio * w), round(ratio * h)
    if max(w, h) > max_side:
        ratio = max_side / max(w, h)
        w, h = round(ratio * w), round(ratio * h)
    size = [(w // base_pixel_number) * base_pixel_number, (h // base_pixel_number) * base_pixel_number]
    return pil_image.resize(size, Image.BILINEAR), (out_w, out_h)


def read_image(path: str):
    """The image at ``path`` as an RGB Pillow image, read in full."""
    from PIL import Image

    with Image.open(path) as src:
        return src.convert("RGB")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="InstantIR restoration (PyTorch/CUDA port)")
    p.add_argument("--sdxl_path", type=str, required=True)
    p.add_argument("--instantir_path", type=str, required=True)
    p.add_argument("--vision_encoder_path", type=str, required=True)
    p.add_argument("--adapter_model_path", type=str, default=None)
    p.add_argument("--previewer_lora_path", type=str, default=None)
    p.add_argument("--test_path", type=str, required=True)
    p.add_argument("--out_path", type=str, default="./output")
    p.add_argument("--post_fix", type=str, default=None)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--cfg", type=float, default=7.0)
    p.add_argument("--preview_start", type=float, default=0.0)
    p.add_argument("--creative_start", type=float, default=1.0, help="maps to control_guidance_end")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--min_side", type=int, default=768, help="resize_img min side (infer.py:31-66)")
    p.add_argument("--max_side", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--neg_prompt", type=str, default=None)
    p.add_argument("--save_preview_row", action="store_true")
    p.add_argument(
        "--watermark", action="store_true",
        help="embed the standard 48-bit SD invisible watermark in outputs "
        "(the reference applies this automatically when the optional "
        "invisible_watermark package is installed; rebuilt DCT-QIM codec, "
        "utils/watermark.py)",
    )
    p.add_argument(
        "--use_clip_encoder", action="store_true",
        help="read "
        "--vision_encoder_path as an HF CLIP vision tower instead "
        "of DINOv2 and condition on its penultimate-layer tokens "
        "(infer.py:275-279; the released InstantIR adapters are DINOv2-based)",
    )
    p.add_argument(
        "--denoising_start", type=int, default=1000,
        help="truncate the denoise schedule: <1000 spaces the steps evenly "
        "over [steps_offset, denoising_start) instead of the full range — "
        "the LQ-latent init is already partially clean. Implements the "
        "INTENDED semantics of the reference flag (its own computed list is "
        "dead code, overwritten at infer.py:189-190 — SURVEY §2.5).",
    )
    p.add_argument(
        "--multistep_restore", action="store_true",
        help="Heun lookahead on previewing steps: evaluate aggregator+UNet at "
        "the first-order-predicted next latent (working rebuild of the "
        "reference's broken multistep_restore path, sdxl_instantir.py:1569).",
    )
    p.add_argument(
        "--shared_cfg", action="store_true",
        help="CFG single-pass control branch: previewer+aggregator run on the "
        "text-cond half only (an approximation). Default follows the "
        "reference's doubled-batch exact path.",
    )
    p.add_argument(
        "--fused", action="store_true",
        help="record the whole restore (encoders, denoise loop, decode) as one "
        "CUDA graph per image size and replay it (the same images as the "
        "staged restore); at most MAX_GRAPHS recordings are kept.",
    )
    p.add_argument(
        "--quantized", nargs="?", const="w8a8", default=None, choices=("w8a8", "w8"),
        help="int8 inference on the UNet+Aggregator: 'w8a8' (dynamic "
        "activation quant, int8 products) or 'w8' (weight-only: weights "
        "dequantized at use). The VAE, encoders and LoRA stay fp.",
    )
    p.add_argument(
        "--deepcache_interval", type=int, default=1,
        help="DeepCache block caching (arXiv 2312.03209): refresh the deep "
        "UNet trunk + previewer + aggregator every N steps, run only the "
        "shallow UNet levels in between. 1 = exact (off); 2-3 trade "
        "quality for speed.",
    )
    p.add_argument(
        "--deepcache_depth", type=int, default=1,
        help="number of shallow UNet levels recomputed on cached steps "
        "(higher = closer to exact, less speedup)",
    )
    p.add_argument(
        "--sequence_parallel", action="store_true",
        help="long-context mode for ≥2K² inputs (under torchrun, one process "
        "a GPU): replicate the batch over the ranks and ring-attend long "
        "self-attention sequences over them",
    )
    p.add_argument(
        "--sp_min_seq", type=int, default=8192,
        help="with --sequence_parallel: minimum self-attention sequence "
        "length that takes the ring path",
    )
    p.add_argument(
        "--vae_tiling", action="store_true",
        help="constant-memory tiled VAE encode/decode with blended overlaps "
        "(the reference's diffusers-VAE enable_tiling), for large images "
        "whose whole fp32 decode would set the memory peak. No-op when the "
        "image fits one tile.",
    )
    p.add_argument(
        "--vae_tile_latent", type=int, default=96,
        help="with --vae_tiling: latent-space tile edge (×8 pixels)",
    )
    p.add_argument(
        "--vae_slicing", action="store_true",
        help="VAE encode/decode one sample at a time (exact; batch-"
        "independent activation memory — the reference's enable_slicing)",
    )
    return p


def restore_config(args: argparse.Namespace) -> RestoreConfig:
    """The flags as a ``RestoreConfig``; ``--denoising_start`` below 1000
    spaces the steps evenly over [steps_offset, denoising_start), descending
    (the reference's intended truncated schedule, ``infer.py:184-188``), the
    step count clamped so that every timestep stays below it."""
    custom_timesteps = None
    num_steps = args.num_inference_steps
    if args.denoising_start < 1000:
        offset = RestoreConfig().steps_offset
        num_steps = min(num_steps, max(args.denoising_start - offset, 1))
        stride = max((args.denoising_start - offset) // num_steps, 1)
        custom_timesteps = tuple(i * stride + offset for i in range(num_steps))[::-1]
    return RestoreConfig(
        timesteps=custom_timesteps,
        num_inference_steps=num_steps,
        guidance_scale=args.cfg,
        preview_start=args.preview_start,
        control_guidance_end=args.creative_start,
        save_preview_row=args.save_preview_row,
        multistep_restore=args.multistep_restore,
        lora_alpha=1.0,
        preview_cfg=not args.shared_cfg,
        controlnet_cfg=not args.shared_cfg,
        fused=args.fused,
        deepcache_interval=args.deepcache_interval,
        deepcache_depth=args.deepcache_depth,
        vae_tiling=args.vae_tiling,
        vae_tile_latent=args.vae_tile_latent,
        vae_slicing=args.vae_slicing,
        sequence_parallel=args.sequence_parallel,
        sp_min_seq=args.sp_min_seq,
    )


def load_models(args: argparse.Namespace, device="cuda"):
    """The pipeline and the two (text encoder, tokenizer) pairs the flags name."""
    pipe = load_instantir_pipeline(args.sdxl_path, args.instantir_path, vision_encoder_path=args.vision_encoder_path,
                                   adapter_path=args.adapter_model_path, previewer_lora_path=args.previewer_lora_path,
                                   use_clip_encoder=args.use_clip_encoder, device=device)
    return pipe, load_text_encoders(args.sdxl_path, device=device)


@torch.no_grad()
def encode_prompts(text_encoders, prompts: Sequence[str], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prompt embeddings [B, 77, 2048], pooled [B, 1280]) of ``prompts``."""
    (enc1, tok1), (enc2, tok2) = text_encoders
    return encode_sdxl_prompt(enc1, enc2, tokenize_prompt(tok1, prompts, 77, device),
                              tokenize_prompt(tok2, prompts, 77, device))


def restore_arrays(pipe: InstantIRPipeline, text_encoders, images: np.ndarray, prompt: str, neg_prompt: str,
                   cfg: RestoreConfig, seed: int, watermark: bool = False) -> np.ndarray:
    """The CLI's work on arrays: ``images`` [B, H, W, 3] in [-1, 1] (one
    size) -> restored uint8 [B, H, W, 3]. Encodes the prompts, restores with
    noise from ``torch.Generator(device).manual_seed(seed)``, clips to [0, 1]
    and embeds the watermark when asked."""
    n = images.shape[0]
    pe, pooled = encode_prompts(text_encoders, [prompt] * n, pipe.device)
    npe, npooled = encode_prompts(text_encoders, [neg_prompt] * n, pipe.device)
    image, _ = pipe.restore(torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(pipe.device), pe, pooled,
                            negative_prompt_embeds=npe, negative_pooled_embeds=npooled, cfg=cfg,
                            generator=torch.Generator(device=pipe.device).manual_seed(seed))
    image01 = (np.clip(image, -1.0, 1.0) + 1.0) / 2.0
    if watermark:
        image01 = embed_watermark(image01)
    return (image01 * 255.0).astype(np.uint8)


def main(argv: Optional[List[str]] = None, device="cuda", models=None) -> List[Dict[str, Any]]:
    """Restore every image of ``--test_path`` not yet in the output folder.
    ``models`` (``load_models``' result) spares a caller that restores
    several folders the loading. Returns a record per group restored: its
    files, size, ``seconds`` from reading its files to writing them (the
    read, resize, restore, resize back and PNG encode), ``restore_seconds``
    (``restore_arrays`` alone: text encoding, restore, uint8), the recorded
    graphs held after it and, on a CUDA device, ``torch.cuda.memory_reserved``
    in GB."""
    from PIL import Image

    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh

    args = build_parser().parse_args(argv)
    initialize_distributed(device=models[0].device if models is not None else device)  # a no-op without torchrun
    pipe, text_encoders = models if models is not None else load_models(args, device)
    if args.quantized:
        pipe.quantize(weight_only=args.quantized == "w8")
    cfg = restore_config(args)
    if args.sequence_parallel:
        pipe.shard(make_mesh(device=pipe.device))
    writes = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0

    post_fix = f"_{args.post_fix}" if args.post_fix else ""
    out_dir = os.path.join(args.out_path, post_fix)
    os.makedirs(out_dir, exist_ok=True)
    processed = set(os.listdir(out_dir))
    if os.path.isfile(args.test_path):
        all_inputs, base_dir = [os.path.basename(args.test_path)], os.path.dirname(args.test_path)
    else:
        all_inputs, base_dir = sorted(os.listdir(args.test_path)), args.test_path
    files = [f for f in all_inputs if f not in processed]
    prompt = args.prompt or DEFAULT_PROMPT
    neg = args.neg_prompt or DEFAULT_NEG_PROMPT

    records = []
    for i in range(0, len(files), args.batch_size):
        groups: Dict[Tuple[int, ...], list] = {}
        for f in files[i:i + args.batch_size]:
            t0 = time.perf_counter()
            im, out_size = resize_img(read_image(os.path.join(base_dir, f)), width=args.width, height=args.height,
                                      min_side=args.min_side, max_side=args.max_side)
            arr = np.asarray(im, np.float32) / 127.5 - 1.0
            groups.setdefault(arr.shape, []).append((f, arr, out_size, time.perf_counter() - t0))
        for (h, w, _), items in groups.items():
            t0 = time.perf_counter()
            restored = restore_arrays(pipe, text_encoders, np.stack([it[1] for it in items]), prompt, neg, cfg,
                                      args.seed, args.watermark)
            restore_sec = time.perf_counter() - t0
            for (f, _, size, _), im in zip(items, restored):
                if writes:
                    Image.fromarray(im).resize(size, Image.BILINEAR).save(os.path.join(out_dir, f))
            sec = time.perf_counter() - t0 + sum(it[3] for it in items)
            record = {"files": [it[0] for it in items], "size": (w, h), "seconds": sec,
                      "restore_seconds": restore_sec, "graphs": len(pipe._graphs)}
            if pipe.device.type == "cuda":
                record["reserved_gb"] = torch.cuda.memory_reserved(pipe.device) / 1e9
            records.append(record)
            print(f"[infer] wrote {len(items)} images ({w}x{h}) in {sec:.3f} s -> {out_dir}")
    return records

if __name__ == "__main__":
    main()
