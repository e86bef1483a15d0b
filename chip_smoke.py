#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``instantir_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (4 denoise steps)
or ``python3 chip_smoke.py --steps 30`` (BASELINE config #4: 1024², 30 DDPM
steps, CFG 7, preview_start 0.1, control_guidance_end 0.7). Phases, each of
which ends the script with a nonzero exit on failure:

1. environment: the card (``nvidia-smi`` name and power limit), torch/CUDA
   versions, TF32 switched off for matmuls and cuDNN convolutions;
2. build: every kernel under ``instantir_tpu_torch/csrc`` from the checkout's
   sources, one ``nvcc`` per source, all started together; ptxas's register
   report and each kernel's SASS counts (HGMMA / HMMA with their types, FFMA,
   LDL / STL); a ``flash_f32`` kernel that spills fails;
3. kernel check: each of the five kernels (flash forward, flash forward with
   lse, flash dQ, flash dK/dV, fused GroupNorm+SiLU) and the four fp32 entry
   points of the flash kernels against their plain PyTorch versions on the
   card at the main paths' shapes (plus ragged ones, a cross shape with Sq !=
   Skv, a kv tail of 72 keys, an odd batch x heads and an odd S; for GroupNorm
   every shape of the restore in bf16, fp16 and fp32, a ragged one, one past a
   cluster's shared memory, and the fp32 paths' shapes in fp32), and at the
   model variants' shapes (``VARIANT_SHAPES``: K1 at pad_concat's ragged
   Aggregator maps, 2080 and 528 at 512², 8256 at 1024², and at external_kv's
   cross shapes, 4096 queries over 8192, 6144 or 2048 keys; K2-K4 at 2080 and
   528; K5 at pad_concat's Aggregator maps at 1024² and 512², batch 2, bf16;
   ZeroSFT's GroupNorm shapes are derived and found among the restore's), with time,
   bound (fp32: the 3xTF32 rate, the FFMA rate's share beside it), the plain
   version's time and a one-call library yardstick (SDPA's own fp32 error is
   logged too); the wrappers' host time per call;
   GroupNorm's device time from a CUDA-graph replay;
4. restore at full SDXL width with synthetic weights: a UNet forward with the
   flash path against the plain attention path, then ``restore`` with the
   fused GroupNorm off and on, every launch counter set to 0 just before each
   and read just after; the counts must match the schedule, the images must be
   finite, 1024² RGB and close to each other (``RESTORE_TOL``);
4b. the restore options on phase 4's models at 1024², 4 steps: ``fused`` (the
   whole restore as one CUDA graph) against the staged restore on the same
   noise (image within 1e-3 of its scale, 0 expected; staged and graph
   s/image over 3 calls each after the recording, in turns; the recording's
   time; both peaks), ``fuse_previewer_lora`` and ``freeze_previewer`` (on a
   copy of the UNet) close to the dynamic LoRA branch, DeepCache (interval
   2, depth 1: a stale step launches no K1), ``multistep_restore``, the bf16
   decode against the fp32 one and its time, VAE tiling against the untiled
   decode and restore, and VAE slicing at 512², batch 2, against the
   unsliced encode, decode and restore; every count derived from the config
   (``expected_restore_launches``). With ``--steps 30`` also config #4 staged
   and as a graph, with the dynamic and the merged LoRA, in turns. Then the
   VAE's GroupNorms on the plain version (the port before K5 took them)
   against K5, in turns: the 1024² fp32 encode and decode (ms, peaks) and
   the graph replay at 4 steps (s/image; with ``--steps 30`` config #4's),
   each setting's graph on a pipeline of its own, its recording's launches
   derived (the plain one's without the VAE's K5);
4c. phase 4's models written as a checkpoint tree in the released layout
   (diffusers SDXL folder with two synthetic full-width CLIP towers and
   tokenizers, ``adapter.pt``, ``previewer_lora_weights.bin``,
   ``aggregator.pt``, DINOv2) under a temporary directory, loaded back with
   ``load_instantir_pipeline`` and ``load_text_encoders`` (every parameter
   equal to its twin; read and copy times), the loaded pipeline's 1024²
   4-step restore staged and as a graph equal to the in-memory one's on the
   same noise, text encoding per prompt pair (the bf16 towers finite and
   within ``TEXT_TOL`` of fp32), then ``cli.infer.main --fused`` over three
   PNGs of three sizes and two of them again (first calls and replays; each
   image written at its size; ``memory_reserved`` within ``MAX_GRAPHS``
   pools of one size), and ``main`` with its own load on one PNG, its output
   equal to ``restore`` of the same pixels; with ``--steps 30`` config #4
   through the CLI too; launch counts derived from each size;
4d. serving on phase 4's models (synthetic text embeddings): ``RestoreServer``
   over buckets 512² / 1024² at batch 2 / 1 as CUDA graphs (the warmup's
   launches derived per bucket, each bucket's budget row within 1x-1.5x of
   the larger of its measured peak increment and the pool its recording
   holds, six concurrent requests of four sizes
   replayed without a launch, a lone 1024² request equal to ``restore`` of
   its bucket pixels with the server's generator state), the demo app's
   ``set_adapter`` followed by the replayed graph (equal to the staged
   restore under each adapter), ``SlotSampler`` at 1024² (one slot against a
   staged restore's latents on the same draws, launches derived per step
   variant) and at 512² (two slots: a mid-flight admission leaves both
   bitwise equal to each alone), ``ContinuousRestoreServer`` over the same
   buckets (five concurrent requests); with ``--steps 30`` config #4 through
   both servers, two requests each, in turns;
4e. the quantized restore on phase 4's models at 1024², 4 steps: a copy of
   the UNet and the Aggregator quantized W8 and one W8A8
   (``InstantIRPipeline.quantize``; weight bytes before and after,
   ``memory_allocated`` falling by at least 40% of the quantized weights'
   bf16 bytes), the int8 products on the card bitwise against the CPU op's
   int32 (a dense layer and a 3x3 convolution; their ms beside the bf16 op's),
   each pipeline staged and as one CUDA graph on one noise (the graph equal
   to the staged restore), PSNR against the bf16 image (W8 no further from
   it than W8A8), s/image of bf16, W8 and W8A8 in one pass, peaks, launches
   derived (the bf16 path's); ``RestoreServer`` on the W8 pipeline (its
   budget's weights against bf16's, a request replayed without a launch);
   ``cli.infer.main --quantized w8 --fused`` on phase 4c's loaded pipeline
   (run at the end of 4c); with ``--steps 30`` config #4 as graphs in W8 and
   W8A8 (a recording and a replay each) against a bf16 staged restore;
4f. the model variants on phase 4's models at 1024², batch 2 (as under
   CFG), each against the plain path (attention ``use_flash=False``, the
   GroupNorm's plain version), every count derived from the config: the
   Aggregator with ``pad_concat`` off / on x ``attn1_mode`` ``plain`` /
   ``split`` / ``sep_split`` (phase 4's weights, sep_split's ``ln_*_ref``
   drawn; ``variant_flash_calls``: plain 4 K1 at 8192 and 30 at 2048, 8256
   and 2080 with the pad; split 8192 and 2048 either way, equal to plain
   without the pad; sep_split 16 at 4096 and 120 at 1024, four attentions a
   block over one stream; 21 K5 a forward) and ``global_pool_conditions``
   (the mean of the unpooled residuals); a ``residual_fusion="zero_sft"``
   UNet (its ZeroSFT leaves drawn) fed the plain Aggregator's residuals: a
   forward (70 K1, 46 + 10 K5) and a forward and backward of the residuals
   with checkpointing (K1 in the down and mid blocks, 34; K2 twice and
   K3 / K4 once in the up blocks, 72 / 36 / 36; K5 56 + 33 recomputed), s/forward,
   s/step and peaks in turns with the ``add`` UNet; ``Attention`` with
   ``external_kv`` ``concat`` / ``additive`` / ``ta_additive`` at the UNet's
   /16 shape over a ``KVCopy`` cache of a second image, whole and thinned by
   ``drop_kvs(0.5)`` (one K1 at 4096 x 8192 or 6144; two, at 4096 x 4096 and
   4096 x 4096 or 2048);
4g. the CLIP image-prompt encoder (``--use_clip_encoder``) on phase 4's UNet,
   Aggregator and VAE, run on phase 4c's tree before it is deleted: a
   synthetic ViT-B/16 ``CLIPImageEncoder`` in bf16 (its penultimate layer's
   tokens) and a Resampler at ``embedding_dim`` 768; 1024², 4 steps, staged
   and as one CUDA graph on the same noise (the launches phase 4's, the
   graph within 1e-3 of its scale of the staged image; s/image in turns),
   the encoder's ms per call; the tower written as an HF folder beside an
   InstantIR folder for the 768-wide Resampler, and ``cli.infer.main
   --use_clip_encoder --fused`` with its own load on one 1024² PNG (launches
   derived as in 4c, its PNG equal to the in-memory restore's);
4j. tensor parallelism, on phase 4c's tree before it is deleted: K1 at the
   local heads of a ``model`` axis of 2 and of 4 at 512² (half the heads; 3
   or 2 of the 10 heads, 5 of the 20) and K5 at the resnets' local ``norm2``
   shapes (16 and 8 groups; the VAE's in fp32) against their plain versions
   (phase 3 checks K1 at both axes' local heads at 1024²); the analytic FLOPs per 1024²
   image of config #4 and of the 4-step restore (``utils/flops.py``, counted
   on ``meta`` by a process started beside phase 2, ``--count_flops``) and the
   4-step graph replay's achieved TFLOP/s; ``PhaseTimer`` over a staged
   restore; an NCCL group of two ranks on the card (``--tp_probe``, beside
   phase 2; NCCL takes one rank a device), then two ranks in an explicit
   gloo group over the CUDA tensors (``--tp_worker``) running ``cli.serve
   --mesh --model_parallel 2 --no-fused`` on the tree: each loads and shards
   the pipeline, restores at the warmup (512², 2 steps, CFG 7) and for one
   request; each rank's launches per restore derived at the local shapes,
   both ranks' inputs equal, each image within ``TP_TOL`` of the one-rank
   restore of its inputs, the served PNG the request's image as uint8, the
   per-rank weight bytes against ``tp_held_bytes`` (the seconds are not TP
   speed: the ranks share the card); four ranks at ``--model_parallel 4``
   the same way, started first (the two once the four have sharded), every
   rank's image against the one-rank restore of its inputs;
5. stage-2 (Aggregator) training at full SDXL width: two
   ``Stage2Trainer.train_step``s at 512² (batch 2) and one at 1024² (batch 1,
   gradient checkpointing on the UNet and the Aggregator); loss,
   ``preview_error_latent`` and gradient norm finite, every Aggregator leaf
   moved, no frozen leaf changed, and every step's launch counters equal to
   the counts derived from the config;
5b. stage 2 with ``aggregator_adapter``: ``enable_aggregator_adapter`` on
   phase 4's Aggregator (1.466 B trainable values against 1.005 B) and its
   steps at 512², batch 2, in turns with phase 5's trainer (the plain step's
   launches: the ip branches attend over 64 keys on the plain path; every
   master moved, the ip leaves' and the agg_resampler's too, no frozen leaf
   changed); the pad_concat Aggregator's parameter gradients at 512², batch
   2, with sep_split (16 K2-K4 at one stream's 1024 tokens) and plain (4 at
   2080 and 30 at 528), against the plain path within ``VARIANT_GRAD_TOL``;
   ``cli.train.main stage2 --aggregator_adapter`` 2 steps with a checkpoint
   (read back bitwise), resumed to 4 (2 x the plain step's launches each
   run), ``aggregator.pt`` strictly onto an adapter Aggregator;
6. stage-1 training at full SDXL width: three ``Stage1Trainer.train_step``s at
   512² (batch 2) and one at 1024² (batch 1, gradient checkpointing); the same
   checks;
7. previewer (LCM-LoRA distillation) training at full SDXL width: two
   ``PreviewerTrainer.train_step``s at 512² (batch 2) with the default Huber
   loss, one with ``[HuberLoss 1, DINOLoss 1e-3, LCMVisualization k=1]`` (the
   image branch: fp32 VAE decodes, DINOv2 on both images, the strip), one at
   1024² (batch 1, gradient checkpointing); loss, each loss term and the
   gradient norm finite, the strip finite of shape (2, 512, 1536, 3), every
   LoRA leaf moved, no frozen leaf changed, every step's launch counters equal
   to the counts derived from the config. In phases 5-7 each bf16 trainable
   leaf trains through an fp32 master with fp32 AdamW moments: every master
   must move and every bf16 leaf must hold its master's rounding. Each of
   phases 5-7 ends with one more 512² batch-2 step on a trainer with
   ``quantize_frozen_unet`` and ``use_8bit_adam`` over a copy of the UNet,
   in turns with the bf16 trainer's step (bf16, QLoRA, QLoRA, bf16): the
   launches of the bf16 step, finite metrics, every master moved, each bf16
   leaf its rounding, no frozen leaf or int8 buffer changed, the moments
   int8; s/step and each step's peak net of the other trainer's UNet and
   optimiser;
7c. the perceptual losses: three previewer steps at 512² batch 2 with
   ``[HuberLoss 1, LPIPSLoss 1, DreamSIMLoss 1]`` (a full-width synthetic
   VGG16 LPIPS; DreamSim's ``embed_fns`` a synthetic ViT-B/16 projection), a
   warm-up and two in turns with a Huber-only trainer (the launches of phase 7's 512² step,
   every LoRA master moved, no frozen leaf changed, the masters fp32; s/step
   and peaks); a forward and a backward through ``pred_image`` at 512²
   batch 2 for each of LPIPSLoss, CLIPLoss (4 augmentations), IDLoss
   (IR-SE50, fixed landmarks) and DreamSIMLoss (finite, nonzero gradients;
   < 1e-5 on identical images; ms per call; no K1-K5 launch), and
   ``MTCNN.detect`` on a 512² image with synthetic weights;
7b. training from raw images on the same models, under cuDNN's TF32 default
   (on): the traced and the eager RealESRGAN degradation at 512² batch 2 and
   1024² batch 1 against the same call on the CPU (the first JPEG's input
   within CHAIN_TOL, the JPEG flips counted by block; ms per call; no K1-K5
   launch); stage 1 through ``cli.train.main`` (``--synthetic_data``, 2
   steps, a checkpoint every 2, a limit of 1, prefetch 2), resumed to 4
   steps (the restored state bitwise that of ``checkpoint-2``; only
   ``checkpoint-4`` left; ``adapter_ckpt.pt`` maps strictly onto the
   models), stage 1 from eight PNGs of mixed sizes with captions and a data
   config, the previewer (``config_files/losses.yaml``) and stage 2 on a
   fresh Aggregator with one async checkpoint and the EMA adapter, 2 steps
   each (checkpoint bytes and seconds; each read back bitwise, every tensor
   of the state, with its read and put-back seconds); stage 1's s/step of
   ``run`` with ``prefetch_batches`` 0 and 2 in turns from one state beside
   the bare ``train_step`` (the masters after every turn bitwise equal);
   the first stage-1 run, the previewer and stage 2 also render
   ``--validation_image`` (two PNGs) at step 2 (strips (2, 536, 1536, 3), the
   tag in the event file, one more render timed with its launches derived
   from ``Stage1Config`` / ``RestoreConfig``); stage 1 with
   ``--use_8bit_adam --quantize_frozen_unet`` on a copy of the UNet, 2
   steps, its checkpoint resumed bitwise; every launch count derived, every
   trainable master moved, no frozen leaf changed;
8. fp32, after the bf16 models are freed: ``build_pipeline`` with its default
   dtype restores a 512² image in 4 steps and one fp32 ``Stage1Trainer`` step
   runs at 512², batch 1, both through the fp32 flash entry points and the
   fused GroupNorm (the VAE's norms too) with launch counts derived from the
   config;
9. summary: one JSON line of kernels, the card line, and the result line.

Every K5 count includes the fp32 VAE's GroupNorms, each a K5 launch
(``vae_group_norm_shapes``, ``vae_restore_k5``).

``--only kernels`` stops after phase 3 (exit 0, no result line): the quick
check of a kernel edit; ``--only group_norm`` runs phase 3 for K5 alone,
``--only flash_f32`` for the four fp32 flash entry points alone.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# H100 SXM fp32 FFMA rate outside the tensor cores: 132 SMs x 128 lanes x 2 operations x 1.98 GHz
PEAK_FP32_FLOPS = 66.9e12
# fp32 products at fp32 accuracy on the tensor cores: three TF32 products of split operands (3xTF32, the
# fp32 backward kernels' route and PyTorch's fp32 SDPA's) at the dense TF32 rate. The fp32 entry points'
# bound; their share of the FFMA bound is kept beside it.
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FLASH_TOL = 4e-3  # max abs error, bf16: the band stated for the Pallas kernel vs the XLA path
LSE_TOL = 1e-3  # max abs error of the fp32 log2-domain logsumexp (values of order 10)
GRAD_TOL = 2e-2  # dq/dk/dv: max abs error over the largest reference value (bf16 has 8 bits)
# fp32 entry points against the plain fp32 version on the same card: only the summation order differs
F32_REL_L2 = 1e-5  # relative L2 error of outputs and gradients
F32_REL_MAX = 1e-4  # max abs error over the reference's max abs
F32_LSE_TOL = 1e-5  # max abs error of lse (values near 10: a few fp32 ulps)
# max abs error of the kernel's normalised (O(1)) outputs against the plain version's fp32 values (before
# their rounding to x's dtype): half an ulp of outputs below 8 plus the fp32 difference; fp16 the bf16 band
# over its 8x finer ulp. Two values rounded apart can differ by a whole ulp (0.031 in bf16 above 4).
GN_TOL = {"bfloat16": 2e-2, "float16": 2.5e-3, "float32": 1e-4}
# max abs error of the kernel's and of the plain version's outputs against the same formula evaluated in fp64
# (``gn_f64``), at the VAE's slabs of up to 8.4 M elements (normalised outputs |y| < 8): bf16 half an ulp
# above 4 (1.56e-2) plus the statistics' error; fp32 about three times the largest error measured on an H100 at
# the VAE's shapes (kernel 7.2e-7 to 1.64e-6, plain version 9.7e-7 to 1.52e-6: the fp32 statistics of the
# E[x²] − μ² form and the output's rounding; half an ulp of |y| ~ 6 is 2.4e-7)
GN_F64_TOL = {"bfloat16": 2e-2, "float16": 2.5e-3, "float32": 5e-6}
FORWARD_TOL = 5e-2  # relative L2 of one UNet forward through a kernel against the same forward through its plain path
# relative L2 of two whole restores that differ in one kernel: four CFG-7 steps
# amplify a one-ulp bf16 difference a few thousand-fold (5.2e-2 measured for the
# fused GroupNorm on vs off, whose single forward differs by 2e-2)
RESTORE_TOL = 1e-1
TEXT_TOL = 5e-2  # relative L2 of the bf16 CLIP towers' prompt embeddings against the same weights run in fp32
# (B, S, H) of the flash kernel on the restore path: UNet S=4096/1024, Aggregator
# H-concat S=8192/2048, CFG batch 2
RESTORE_SHAPES = [(2, 4096, 10), (2, 1024, 20), (2, 8192, 10), (2, 2048, 20)]
# the training path's own shapes: 512² batch 2, then 1024² batch 1
TRAIN_SHAPES = [(2, 1024, 10), (1, 4096, 10), (1, 1024, 20)]
# stage 2's Aggregator (H-concat) shapes: W, X at 1024² batch 1, Y, Z at 512² batch 2
STAGE2_SHAPES = [(1, 8192, 10), (1, 2048, 20), (2, 2048, 10), (2, 512, 20)]
# the fp32 paths' shapes: the 512² restore (UNet S=1024, Aggregator 2048 and 512; CFG batch 2) and the
# fp32 stage-1 step at 512² batch 1
F32_PATH_SHAPES = [(2, 1024, 10), (2, 2048, 10), (2, 512, 20), (1, 1024, 10)]
F32_RES = 512
# (B, Sq, Skv, H) checked beside them, off every main path: a ragged 768² shape,
# S % 64 != 0, a cross shape (Sq != Skv, neither a multiple of the tiles), a kv
# tail of 72 keys after 129 full tiles, batch x heads = 15, and an odd S (the
# fp32 lse and D rows of a (batch, head) start off 16-byte alignment)
EXTRA_SHAPES = [(2, 2304, 2304, 10), (2, 1000, 1000, 10), (1, 200, 520, 10), (2, 8264, 8264, 10), (3, 1024, 1024, 5),
                (1, 1001, 1001, 10)]
FLASH_SHAPES = [(b, s, s, h) for b, s, h in RESTORE_SHAPES] + EXTRA_SHAPES
# (B, Sq, Skv, H) of the model variants (phases 4f and 5b), derived from the config in phase 3: pad_concat's
# ragged Aggregator maps at 512² (65x32 = 2080 at /16, 33x16 = 528 at /32) and at 1024² (129x64 = 8256, past the
# JAX kernel's resident limit of 8192), and external_kv at the UNet's /16 shape (4096 queries): the K/V cache of
# a second image appended (concat: 4096 + 4096 keys; thinned by drop_kvs(0.5): 4096 + 2048) or attended on its own
# (additive, ta_additive: 4096; thinned 2048). K1 checks them all; K2-K4 the ragged 512² ones (phase 5b's
# Aggregator gradients; its per-stream sep_split shape, 1024, is TRAIN_SHAPES[0])
VARIANT_SHAPES = [(2, 2080, 2080, 10), (2, 528, 528, 20), (2, 8256, 8256, 10), (2, 4096, 8192, 10),
                  (2, 4096, 6144, 10), (2, 4096, 2048, 10)]
VARIANT_TRAIN_SHAPES = VARIANT_SHAPES[:2]
# relative L2 of a backward pass through the bf16 kernels (and the fused GroupNorm) against the same backward
# through the plain path: twice FORWARD_TOL, the backward adding three bf16 products per attention to the forward's
VARIANT_GRAD_TOL = 1e-1
F32_SHAPES = [(b, s, s, h) for b, s, h in F32_PATH_SHAPES] + EXTRA_SHAPES
# the lengths at which the JAX kernels switch to their streamed bodies (past RESIDENT_MAX_SEQ = 8192,
# instantir_tpu/ops/attention.py:128): the 2048² restore's. K1 bf16 at the CFG restore's (B, S, H): the UNet's
# /16 and /32 maps, then the Aggregator's H-concat of them; K2-K4 bf16 and K1-K4 fp32 at a batch-1 step's
# 16,384 and 32,768 tokens; K2 alone at the sequence-parallel 2048² restore's rung maps on one rank
# (CFG batch 2: the UNet's 16,384, the Aggregator's 32,768 and 8192)
LONG_RES = 2048
LONG_RESTORE_SHAPES = [(2, 16384, 10), (2, 4096, 20), (2, 32768, 10), (2, 8192, 20)]
LONG_TRAIN_SHAPES = [(1, 16384, 10), (1, 32768, 10)]
LONG_SP_SHAPES = [(2, 16384, 10), (2, 32768, 10), (2, 8192, 20)]
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
# the tensor-parallel phase (4j): two ranks on the one card, a (1, 2) mesh, at TP_RES²; K1 runs at half the heads,
# the resnets' norm2 (K5) at half the channels with 16 of the 32 groups; the restore and the server take BASELINE
# config #4's settings at TP_STEPS steps. Phase 3 checks K1 at the 1024² restore's halved heads
# ((2, 4096, 5), (2, 1024, 10), (2, 8192, 5), (2, 2048, 10))
TP_SIZE = 2
TP_STEPS = 2
TP_RES = 512
TP_RESTORE_SHAPES = [(b, s, h // TP_SIZE) for b, s, h in RESTORE_SHAPES]
# relative L2 of the two-rank restore's image against the one-rank restore's on the same inputs: each
# row-parallel layer rounds its two bf16 partials before their sum where one rank rounds once, a one-ulp
# difference at some outputs of every such layer, which two CFG-7 steps amplify as they do the fused GroupNorm's
# (RESTORE_TOL's 5.2e-2 at four steps): 5e-2 predicted, RESTORE_TOL the bound
TP_TOL = RESTORE_TOL
TP_TIMEOUT = 900  # seconds the two ranks may take, loads, restore and server included
# model axes whose splits are uneven at SDXL width: 4 cuts the 10-head attentions 3 / 3 / 2 / 2 (phase 4j runs
# it: four ranks on the one card, TP_RES², TP_STEPS steps); 5 cuts the resnets' 32 groups 7 / 7 / 6 / 6 / 6
# (phase 3 checks K5 at its local shapes)
TP_MODEL4 = 4
TP_UNEVEN = 5


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


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """The least time the card could take: operations over the peak rate of
    their type (bf16 tensor cores unless given) or bytes over the memory rate,
    whichever is larger."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b: int, sq: int, skv: int, h: int, products: int = 2, q_tensors: int = 2, kv_tensors: int = 2,
                   rows_fp32: int = 0, d: int = 64, f32: bool = False, peak_f32: float = PEAK_TF32X3_FLOPS):
    """``products`` Sq x Skv x d matrix products (2 flops per multiply-add)
    against ``q_tensors`` [B, Sq, H, d] and ``kv_tensors`` [B, Skv, H, d]
    operands (bf16, or fp32 at ``peak_f32``, the 3xTF32 rate unless given,
    with ``f32``) and ``rows_fp32`` fp32 [B, H, Sq] ones, each read or
    written once."""
    itemsize = 4.0 if f32 else 2.0
    return bound_ms(2.0 * products * b * h * sq * skv * d,
                    (q_tensors * sq + kv_tensors * skv) * b * h * d * itemsize + rows_fp32 * b * h * sq * 4.0,
                    peak_f32 if f32 else PEAK_BF16_FLOPS)


def sass_summary(paths: dict) -> dict:
    """Log, for each kernel of each built library, its counts of tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync, with their shape and
    types), FFMA and local-memory loads and stores (LDL / STL: spills), read
    with the CUDA toolkit's ``cuobjdump -sass``; return them by library and
    kernel (empty without ``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("    cuobjdump not found: no SASS summary")
        return {}
    by_lib = {}
    op = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?((HGMMA|HMMA|FFMA|LDL|STL)[.\w]*)")
    for name, path in paths.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=False).stdout
        counts = {}
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = re.search(r"\d((?:flash|group_norm)\w*?_kernel)", line)  # after the mangled length
                key = kernel.group(1) if kernel else line.split("Function :")[1].strip()
                key += f" #{sum(k.startswith(key) for k in counts) + 1}" if key in counts else ""  # template instances
                counts[key] = fn = collections.Counter()
            elif counts and (m := op.search(line)):
                fn[m.group(1) if m.group(2) in ("HGMMA", "HMMA") else m.group(2)] += 1
        for kernel, c in counts.items():
            log(f"    {name} {kernel}: " + (", ".join(f"{k} {n}" for k, n in sorted(c.items())) or "none of them"))
        by_lib[name] = counts
    return by_lib


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


def check_flash(torch, attention, shapes=None, host_timing: bool = True, plain_calls=(2, 1, 2)) -> list:
    """Phase 3, K1: the flash forward against its plain version at every
    shape: the restore's, the extra ones, the training paths' (stage 1's
    first self-attention; stage 2's previewer and the main UNet's down and
    mid blocks) and the model variants' (``VARIANT_SHAPES``); or at
    ``shapes`` (B, Sq, Skv, H). ``plain_calls`` (iterations, warm-up calls,
    groups) times the plain version."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if shapes is None:
        shapes = FLASH_SHAPES + [(b, s, s, h) for b, s, h in TRAIN_SHAPES] + VARIANT_SHAPES
    for b, s, skv, h in shapes:
        q = torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, skv, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        out = attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.flash_attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ms = time_ms(torch, lambda: attention.flash_attention(q, k, v))
        plain_ms = time_ms(torch, lambda: attention.flash_attention_reference(q, k, v), *plain_calls)
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
        del q, k, v, qt, kt, vt, out, ref
    if not host_timing:
        return rows
    b, s, h = HOST_TIMING_SHAPE
    q, k, v = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    log(f"  host time per call at B={b} S={s} H={h} (median of 5 runs of 200 calls): flash_attention "
        f"{host_us_per_call(torch, lambda: attention.flash_attention(q, k, v)):.2f} us, flash_attention_lse "
        f"{host_us_per_call(torch, lambda: attention.flash_attention_lse(q, k, v)):.2f} us")
    return rows


def check_flash_training(torch, attention, shapes=None, host_timing: bool = True, forward_only=(),
                         plain_calls=((2, 1, 2), (1, 0, 2))) -> dict:
    """Phase 3, K2-K4: the forward with lse and the two backward kernels
    against their plain versions, at the restore's shapes, the trainer's, the
    extra ones and the ragged ones of phase 5b (``VARIANT_TRAIN_SHAPES``). The backward kernels are fed the forward kernel's own
    output and lse, their plain version the plain forward's. On the card the
    plain backward runs with 1024-wide blocks (the kernel's rounding points; a
    64-wide Python sweep of S=8192 would take minutes): no S x S tensor at
    any length. ``shapes`` replaces the list; at the ``forward_only`` ones
    only K2 runs. ``plain_calls`` (iterations, warm-up calls, groups) time
    the plain forward and backward."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {"fwd_lse": [], "bwd_dq": [], "bwd_dkv": []}
    if shapes is None:
        shapes = (FLASH_SHAPES + [(b, s, s, h) for b, s, h in TRAIN_SHAPES + STAGE2_SHAPES]
                  + VARIANT_TRAIN_SHAPES)
    for b, s, skv, h in list(shapes) + list(forward_only):
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
            plain_ms=time_ms(torch, lambda: attention.flash_attention_lse_reference(q, k, v), *plain_calls[0]),
            bound_ms=bound, bound_by=bound_by,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))))
        if (b, s, skv, h) in forward_only:
            r2 = rows["fwd_lse"][-1]
            log(f"  {where}: fwd+lse err {r2['max_abs_err']:.2e} {r2['ms']:.4f} ms (bound {r2['bound_ms']:.4f}, sdpa "
                f"{r2['library_ms']:.4f}), plain {r2['plain_ms']:.2f} ms")
            del lib_out, q, k, v, do, out, lse, ref_o, ref_lse, qt, kt, vt
            continue

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
        plain_ms = time_ms(torch, plain, *plain_calls[1])
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
        del lib_out, refs, q, k, v, do, out, lse, ref_o, ref_lse, dq, dk, dv, qt, kt, vt, dlib
    if not host_timing:
        return rows
    b, s, h = TRAIN_SHAPES[0]
    q, k, v, do = (torch.randn(b, s, h, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    out, lse = attention.flash_attention_lse(q, k, v)
    delta = attention.flash_delta(out, do)
    dq_us = host_us_per_call(torch, lambda: attention.flash_backward_dq(q, k, v, do, lse, delta))
    dkv_us = host_us_per_call(torch, lambda: attention.flash_backward_dkv(q, k, v, do, lse, delta))
    log(f"  host time per call at B={b} S={s} H={h} (median of 5 runs of 200 calls): flash_backward_dq "
        f"{dq_us:.2f} us, flash_backward_dkv {dkv_us:.2f} us")
    return rows


def f32_errors(got, want):
    """(relative L2 error, max abs error over the reference's max abs, max abs error) in fp64."""
    diff = got.double() - want.double()
    return ((diff.norm() / want.double().norm()).item(), (diff.abs().max() / want.double().abs().max()).item(),
            diff.abs().max().item())


def check_flash_f32(torch, attention, shapes=None, plain_calls=((2, 1, 2), (1, 0, 2))) -> dict:
    """Phase 3, the fp32 entry points of K1-K4 (``csrc/flash_f32.cu``) against
    the plain fp32 versions at the fp32 paths' shapes and the extra ones:
    outputs and gradients to ``F32_REL_L2`` / ``F32_REL_MAX``, lse to
    ``F32_LSE_TOL``. Bound: operations at the 3xTF32 rate, the FFMA rate's
    beside it (``ffma_bound_ms``); library: SDPA and its backward in fp32
    with TF32 off, whose own error against the plain version is logged (it
    takes its products in 3xTF32 too). The plain backward runs with
    1024-wide blocks (in fp32 the blocking moves no rounding point, only the
    order of the sums). ``shapes`` replaces ``F32_SHAPES``; ``plain_calls``
    as in ``check_flash_training``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {"fwd": [], "fwd_lse": [], "bwd_dq": [], "bwd_dkv": []}
    for b, s, skv, h in (F32_SHAPES if shapes is None else shapes):
        q, do = (torch.randn(b, s, h, 64, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(b, skv, h, 64, generator=g, device="cuda") for _ in range(2))
        shape = dict(B=b, S=s, Skv=skv, H=h)
        where = f"B={b} Sq={s} Skv={skv} H={h}"
        out = attention.flash_attention(q, k, v)
        out_lse, lse = attention.flash_attention_lse(q, k, v)
        delta = attention.flash_delta(out_lse, do)
        dq = attention.flash_backward_dq(q, k, v, do, lse, delta)
        dk, dv = attention.flash_backward_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        ref_o, ref_lse = attention.flash_attention_lse_reference(q, k, v)

        def plain_bwd():
            return attention.flash_backward_reference(q, k, v, ref_o, ref_lse, do, block_q=1024, block_k=1024)

        refs = plain_bwd()
        errs = {}
        for name, got, want in (("o", out, ref_o), ("o_lse", out_lse, ref_o), ("dq", dq, refs[0]),
                                ("dk", dk, refs[1]), ("dv", dv, refs[2])):
            errs[name] = f32_errors(got, want)
            rel_l2, rel_max, _ = errs[name]
            if not (got.dtype == torch.float32 and rel_l2 <= F32_REL_L2 and rel_max <= F32_REL_MAX):
                fail(f"fp32 flash {name} disagrees with its plain fp32 version at {where}: relative L2 {rel_l2} "
                     f"(> {F32_REL_L2}?), max abs over the reference's {rel_max} (> {F32_REL_MAX}?), dtype {got.dtype}")
        err_lse = (lse - ref_lse).abs().max().item()
        if not err_lse <= F32_LSE_TOL:
            fail(f"fp32 flash lse disagrees with its plain fp32 version at {where}: {err_lse} > {F32_LSE_TOL}")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        # SDPA's memory-efficient kernel, its pick for fp32 here: never its S x S math path at 32,768 keys
        no_math = sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION])
        no_math.__enter__()
        lib_out = F.scaled_dot_product_attention(qt, kt, vt)
        lib_grads = torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
        lib_errs = [f32_errors(x.transpose(1, 2), want)[0] for x, want in zip((lib_out,) + lib_grads, (ref_o,) + refs)]
        log(f"  sdpa fp32 at {where}, relative L2 against the plain fp32 version: o {lib_errs[0]:.2e}, dq "
            f"{lib_errs[1]:.2e}, dk {lib_errs[2]:.2e}, dv {lib_errs[3]:.2e} (the kernels': dq {errs['dq'][0]:.2e}, "
            f"dk {errs['dk'][0]:.2e}, dv {errs['dv'][0]:.2e})")
        del lib_grads
        dlib = torch.randn_like(lib_out)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        lib_bwd = time_ms(
            torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dlib, retain_graph=True), iters=5, warmup=1)
        no_math.__exit__(None, None, None)
        plain_fwd = time_ms(torch, lambda: attention.flash_attention_lse_reference(q, k, v), *plain_calls[0])
        plain_bwd_ms = time_ms(torch, plain_bwd, *plain_calls[1])
        for name, fn, err, plain_ms, library_ms, bound_args in (
            ("fwd", lambda: attention.flash_attention(q, k, v), errs["o"], plain_fwd, lib_fwd, {}),
            ("fwd_lse", lambda: attention.flash_attention_lse(q, k, v), errs["o_lse"], plain_fwd, lib_fwd,
             dict(rows_fp32=1)),
            ("bwd_dq", lambda: attention.flash_backward_dq(q, k, v, do, lse, delta), errs["dq"], plain_bwd_ms, lib_bwd,
             dict(products=3, q_tensors=3, kv_tensors=2, rows_fp32=2)),
            ("bwd_dkv", lambda: attention.flash_backward_dkv(q, k, v, do, lse, delta),
             max(errs["dk"], errs["dv"], key=lambda e: e[0]), plain_bwd_ms, lib_bwd,
             dict(products=4, q_tensors=2, kv_tensors=4, rows_fp32=2)),
        ):
            bound, bound_by = flash_bound_ms(b, s, skv, h, f32=True, **bound_args)
            ffma_bound, _ = flash_bound_ms(b, s, skv, h, f32=True, peak_f32=PEAK_FP32_FLOPS, **bound_args)
            max_abs = max(err[2], err_lse) if name == "fwd_lse" else err[2]
            rows[name].append(dict(**shape, max_abs_err=max_abs, rel_l2_err=err[0], ms=time_ms(torch, fn),
                                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, ffma_bound_ms=ffma_bound,
                                   library_ms=library_ms))
        r1, r2, r3, r4 = (rows[n][-1] for n in ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv"))

        def share(r):
            return f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of 3xTF32, {r['ffma_bound_ms'] / r['ms']:.1%} of FFMA"

        log(f"  fp32 {where}: fwd rel L2 {r1['rel_l2_err']:.2e} {share(r1)} (sdpa {lib_fwd:.4f}) | fwd+lse lse err "
            f"{err_lse:.2e} {r2['ms']:.4f} ms | dq rel L2 {r3['rel_l2_err']:.2e} {share(r3)} | dkv rel L2 "
            f"{r4['rel_l2_err']:.2e} {share(r4)} | dq+dkv {r3['ms'] + r4['ms']:.4f} ms, sdpa bwd {lib_bwd:.4f} ms | "
            f"plain fwd {plain_fwd:.3f} ms, bwd {plain_bwd_ms:.2f} ms")
        del lib_out, refs, q, k, v, do, out, out_lse, lse, dq, dk, dv, ref_o, ref_lse, qt, kt, vt, dlib
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


def gn_f64(torch, x, scale, bias, groups: int, eps: float, silu: bool):
    """GroupNorm(+SiLU) of channels-first ``x`` evaluated in fp64: the
    formula both the kernel and the plain version compute (E[x²] − μ²
    clamped at 0, eps, the affine, SiLU), without their fp32 roundings."""
    b, c = x.shape[:2]
    xd = x.double().reshape(b, groups, -1)
    mean = xd.mean(dim=-1, keepdim=True)
    var = ((xd * xd).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
    y = ((xd - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    del xd
    affine = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.double().reshape(affine) + bias.double().reshape(affine)
    return y * torch.sigmoid(y) if silu else y


def check_group_norm(torch, group_norm, gn_by_shape: dict, path_cases: list, base: bool = True,
                     host: bool = True, groups: int = 32) -> list:
    """Phase 3, K5: the fused GroupNorm(+SiLU) against ``group_norm_silu_nchw``
    (its fp32 values: see ``GN_TOL``) at every shape of the 1024² restore
    path and the extra ones in bf16, fp16 and fp32, and at the other main
    paths' ``path_cases`` ((B, (C, H, W), dtypes) or (B, (C, H, W), dtypes,
    options): training, the fp32 paths, the VAE's), with and without SiLU:
    back-to-back and device (CUDA graph) time, the host time of the dispatch
    under ``torch.no_grad()`` (bf16 and fp16), bound, plain version,
    ``F.group_norm`` and the launch plan (cluster size and path; "-" for a
    package without one). ``base=False`` checks the ``path_cases`` alone,
    ``host=False`` leaves out the host timing; ``groups`` is the GroupNorm's
    (16 at the tensor-parallel resnets' ``norm2`` of model 2). A case's
    options: ``groups`` (its own), ``silus`` (the SiLU settings to check),
    ``f64`` (hold the kernel and the plain version each to ``gn_f64`` within
    ``GN_F64_TOL``: the VAE's long slabs, where the fp32 summation order
    alone moves the statistics past ``GN_TOL``'s half ulp)."""
    import torch.nn.functional as F

    if sorted(gn_by_shape) != sorted(GN_UNET_SHAPES + GN_AGG_SHAPES):
        fail(f"GroupNorm shapes derived from the config {sorted(gn_by_shape)} differ from GN_SHAPES' restore shapes")
    plan_of = getattr(group_norm, "gn_plan", None)
    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    every_dtype = (torch.bfloat16, torch.float16, torch.float32)
    cases = ([(GN_BATCH, shape, every_dtype) for shape in GN_SHAPES] if base else []) + path_cases
    for case in cases:
        batch, (c, hh, ww), dtypes = case[:3]
        opts = case[3] if len(case) > 3 else {}
        grp = opts.get("groups", groups)
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            x = (torch.randn(batch, c, hh, ww, generator=g, device="cuda") * 1.5 + 0.5).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            bias = 0.1 * torch.randn(c, generator=g, device="cuda")
            scale_d, bias_d = scale.to(dtype), bias.to(dtype)
            plan = plan_of(batch, c, hh * ww, grp, x.element_size()) if plan_of else None
            big = x.numel() * x.element_size() > 2**28  # past 256 MB: the plain version timed at fewer calls
            for silu in opts.get("silus", (False, True)):
                y = group_norm.group_norm_silu_fused(x, scale, bias, grp, 1e-5, silu)
                torch.cuda.synchronize()
                ref = group_norm.group_norm_silu_nchw(x.float(), scale, bias, grp, 1e-5, silu)
                err = (y.float() - ref).abs().max().item()
                del ref
                where = f"B={batch} C={c} {hh}x{ww} G={grp} {name} silu={silu}"
                if y.dtype != dtype or not err <= GN_TOL[name]:
                    fail(f"fused GroupNorm disagrees with group_norm_silu_nchw at {where}: {err} > {GN_TOL[name]}")
                f64 = {}
                if opts.get("f64"):
                    ref = gn_f64(torch, x, scale, bias, grp, 1e-5, silu)
                    f64["f64_err"] = (y.double() - ref).abs().max().item()
                    plain = group_norm.group_norm_silu_nchw(x, scale, bias, grp, 1e-5, silu)
                    f64["plain_f64_err"] = (plain.double() - ref).abs().max().item()
                    f64["f64_scale"] = ref.abs().max().item()
                    del ref, plain
                    if not max(f64["f64_err"], f64["plain_f64_err"]) <= GN_F64_TOL[name]:
                        fail(f"GroupNorm at {where} against its fp64 evaluation: kernel {f64['f64_err']:.3e}, plain "
                             f"version {f64['plain_f64_err']:.3e} (> {GN_F64_TOL[name]})")
                del y

                def fused():
                    return group_norm.group_norm_silu_fused(x, scale, bias, grp, 1e-5, silu)

                def dispatch():
                    return group_norm.group_norm_silu(x, scale, bias, grp, 1e-5, silu)

                with torch.no_grad():
                    host_us = host_us_per_call(torch, dispatch) if host and dtype != torch.float32 else None
                bound, bound_by = bound_ms(8.0 * x.numel(), 2.0 * x.numel() * x.element_size())
                plain_iters = (2, 0, 2) if big else (5, 1, 3)
                row = dict(B=batch, C=c, H=hh, W=ww, G=grp, dtype=name, silu=silu, max_abs_err=err, bound_ms=bound,
                           bound_by=bound_by, cs=plan.cs if plan else None, path=plan.path if plan else None,
                           ms=time_ms(torch, fused), device_ms=graph_ms(torch, fused, calls=4 if big else 10),
                           host_us=host_us, **f64,
                           plain_ms=time_ms(torch, lambda: group_norm.group_norm_silu_nchw(x, scale, bias, grp, 1e-5, silu),
                                            iters=plain_iters[0], warmup=plain_iters[1], groups=plain_iters[2]),
                           library_ms=None if silu else time_ms(
                               torch, lambda: F.group_norm(x, grp, scale_d, bias_d, 1e-5)))
                rows.append(row)
                lib = "-" if silu else f"{row['library_ms']:.4f}"
                host_txt = "-" if row["host_us"] is None else f"{row['host_us']:.1f}"
                f64_txt = (f"  fp64: kernel {f64['f64_err']:.2e}, plain {f64['plain_f64_err']:.2e} (|y| <= "
                           f"{f64['f64_scale']:.2f})" if f64 else "")
                log(f"  group_norm {where}: max_abs_err {err:.2e}{f64_txt}  kernel {row['ms']:.4f} ms  device "
                    f"{row['device_ms']:.4f} ms ({bound / row['device_ms']:.0%} of bound)  host {host_txt} us  bound "
                    f"{bound:.4f} ms ({bound_by})  plain {row['plain_ms']:.4f} ms  F.group_norm {lib} ms  cs "
                    f"{row['cs'] or '-'} {row['path'] or '-'}")
                torch.cuda.empty_cache()
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


def vae_group_norm_shapes(vcfg, h: int, w: int, part: str, tp: int = 1, rank: int = 0) -> dict:
    """GroupNorm32 calls of one VAE encode of an ``h`` x ``w`` image
    (``part="encoder"``) or decode of ``h`` x ``w`` latents ("decoder"), by
    (C, H, W, groups, silu), from ``VAEConfig``: each resnet normalises its
    input and its ``conv1`` output (both with SiLU), the mid block's attention
    its input (no SiLU), then ``conv_norm_out``. The encoder halves the map
    after every block but the last, the decoder doubles it. With tensor
    parallelism (a ``model`` axis of ``tp``) a resnet whose channels ``tp``
    divides and whose groups are at least ``tp`` normalises at ``norm2``
    rank ``rank``'s share of its groups (``tp_shares``) and their channels;
    every other norm is whole."""
    counts: dict = {}
    g = vcfg.norm_num_groups

    def add(c: int, hh: int, ww: int, silu: bool = True, local: bool = False):
        key = (c, hh, ww, g, silu)
        if local and tp > 1 and c % tp == 0 and g >= tp:
            mine = tp_shares(g, tp)[rank]
            key = (c // g * mine, hh, ww, mine, silu)
        counts[key] = counts.get(key, 0) + 1

    def resnet(c_in: int, c_out: int, hh: int, ww: int):
        add(c_in, hh, ww)
        add(c_out, hh, ww, local=True)

    def mid(c: int, hh: int, ww: int):
        resnet(c, c, hh, ww)
        add(c, hh, ww, silu=False)
        resnet(c, c, hh, ww)

    chans = vcfg.block_out_channels
    if part == "encoder":
        c_in = chans[0]
        for i, c in enumerate(chans):
            for _ in range(vcfg.layers_per_block):
                resnet(c_in, c, h, w)
                c_in = c
            if i < len(chans) - 1:
                h, w = h // 2, w // 2
        mid(chans[-1], h, w)
        add(chans[-1], h, w)
    else:
        rev = tuple(reversed(chans))
        mid(rev[0], h, w)
        c_in = rev[0]
        for i, c in enumerate(rev):
            for _ in range(vcfg.layers_per_block + 1):
                resnet(c_in, c, h, w)
                c_in = c
            if i < len(rev) - 1:
                h, w = 2 * h, 2 * w
        add(rev[-1], h, w)
    return counts


def tp_shares(units: int, tp: int) -> list:
    from instantir_tpu_torch.parallel.tp import tp_shares as shares

    return shares(units, tp)


def vae_k5(vcfg, h: int, w: int, part: str) -> int:
    """K5 launches of one VAE encode (``h`` x ``w`` pixels) or decode (``h`` x
    ``w`` latents): one a GroupNorm call."""
    return sum(vae_group_norm_shapes(vcfg, h, w, part).values())


def vae_gn_cases(torch, vcfg, res: int = 1024, tile: int = 96) -> list:
    """Phase 3's VAE cases: every (C, H, W) of the encode of a ``res``²
    image and of the decode of its latents (batch 1), in fp32 (the restore's
    VAE) and bf16 (``decode_dtype="bfloat16"``), with and without SiLU, the
    decoder's 1 GiB fp32 row included; then the shapes a ``tile``-latent
    tile adds (``vae_tiling``, the 2048² restore), fp32. Each is held to its
    fp64 evaluation."""
    from instantir_tpu_torch.models.vae import vae_scale_factor

    f = vae_scale_factor(vcfg)
    shapes = set()
    for part, hw in (("encoder", res), ("decoder", res // f)):
        shapes |= {k[:3] for k in vae_group_norm_shapes(vcfg, hw, hw, part)}
    cases = [(1, shape, (torch.float32, torch.bfloat16), {"f64": True}) for shape in sorted(shapes)]
    tiles = set()
    for part, hw in (("encoder", tile * f), ("decoder", tile)):
        tiles |= {k[:3] for k in vae_group_norm_shapes(vcfg, hw, hw, part)}
    cases += [(1, shape, (torch.float32,), {"f64": True, "silus": (True,)}) for shape in sorted(tiles - shapes)]
    return cases


def vae_restore_k5_by_shape(rcfg, h: int, w: int, batch: int = 1, decode: bool = True, vcfg=None) -> dict:
    """K5 launches of a restore's VAE by the input's shape (B, C, H, W): the
    encode of its ``batch`` of ``h`` x ``w`` images and, with ``decode``, the
    decode of its latents, in ``rcfg.decode_dtype``; tile by tile with
    ``vae_tiling`` (``_tile_starts``' tiles where the image passes a tile),
    one sample at a time with ``vae_slicing``; each GroupNorm call a
    launch."""
    from instantir_tpu_torch.models.vae import _tile_starts, sdxl_vae_config, vae_scale_factor

    if rcfg.save_preview_row:
        fail("vae_restore_k5 derives no preview row's decodes (no phase asks for one)")
    vcfg = vcfg or sdxl_vae_config()
    f = vae_scale_factor(vcfg)
    enc_tiles = dec_tiles = 1
    enc_hw, dec_hw = (h, w), (h // f, w // f)
    if rcfg.vae_tiling:
        tile = rcfg.vae_tile_latent
        if h // f > tile or w // f > tile:
            t = min(tile, h // f, w // f)
            stride = max(1, int(t * (1.0 - rcfg.vae_tile_overlap)))
            dec_tiles = len(_tile_starts(h // f, t, stride)) * len(_tile_starts(w // f, t, stride))
            dec_hw = (t, t)
        ts = tile * f
        if h > ts or w > ts:
            t = min(ts, h, w)
            t -= t % f
            stride = max(f, int(t * (1.0 - rcfg.vae_tile_overlap)))
            stride -= stride % f
            enc_tiles = len(_tile_starts(h, t, stride)) * len(_tile_starts(w, t, stride))
            enc_hw = (t, t)
    per, b = (batch, 1) if rcfg.vae_slicing else (1, batch)
    out: dict = {}
    for part, hw, tiles in (("encoder", enc_hw, enc_tiles), ("decoder", dec_hw, dec_tiles)):
        if part == "decoder" and not decode:
            continue
        for (c, hh, ww, _, _), n in vae_group_norm_shapes(vcfg, *hw, part).items():
            out[(b, c, hh, ww)] = out.get((b, c, hh, ww), 0) + per * tiles * n
    return out


def vae_restore_k5(rcfg, h: int, w: int, batch: int = 1, decode: bool = True, vcfg=None) -> int:
    """The launches of ``vae_restore_k5_by_shape`` in all."""
    return sum(vae_restore_k5_by_shape(rcfg, h, w, batch, decode, vcfg).values())


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


def aggregator_levels(cfg, lat: int, pad: bool) -> list:
    """(H, W) of the Aggregator's H-concatenated map at each level: 2·lat rows
    (2·lat + 1 with ``pad_concat``'s zero row), each stride-2 downsample
    taking H to ceil(H / 2) (the pad rebuild keeps an odd H), W = lat >> level."""
    h, out = 2 * lat + (1 if pad else 0), []
    for i in range(len(cfg.block_out_channels)):
        out.append((h, lat >> i))
        h = (h + 1) // 2
    return out


def variant_flash_calls(cfg, lat: int, pad: bool, mode: str) -> dict:
    """Flash launches of one Aggregator forward with ``pad_concat=pad`` and
    ``attn1_mode=mode``, by (Sq, Skv): ``plain`` attends over the whole map
    (the pad row included), ``split`` over both streams without it, and
    ``sep_split`` four times per block over one stream's (H // 2)·W tokens
    (each stream with itself and with the other); every attention with
    Skv >= 512 and Sq >= 128 (``dot_product_attention``'s rule)."""
    levels = aggregator_levels(cfg, lat, pad)
    counts: dict = {}

    def add(level: int, blocks: int):
        h, w = levels[level]
        s, per_block = {"plain": (h * w, 1), "split": (2 * (h // 2) * w, 1), "sep_split": ((h // 2) * w, 4)}[mode]
        if s >= 512 and blocks:
            counts[(s, s)] = counts.get((s, s), 0) + blocks * per_block

    for i, kind in enumerate(cfg.down_block_types):
        if kind == "CrossAttnDownBlock2D":
            add(i, cfg.layers_per_block * cfg.transformer_layers_per_block[i])
    add(len(cfg.block_out_channels) - 1, cfg.transformer_layers_per_block[-1])
    return counts


def aggregator_group_norm_shapes(cfg, lat: int, pad: bool) -> dict:
    """GroupNorm32 calls of one Aggregator forward by (C, H, W) on the maps
    of ``aggregator_levels`` (``group_norm_shapes_per_forward``'s count)."""
    levels = aggregator_levels(cfg, lat, pad)
    counts: dict = {}
    chans = cfg.block_out_channels

    def add(c: int, level: int, k: int = 1):
        key = (c,) + levels[level]
        counts[key] = counts.get(key, 0) + k

    c_in = chans[0]
    for i, kind in enumerate(cfg.down_block_types):
        for _ in range(cfg.layers_per_block):
            add(c_in, i)
            add(chans[i], i, 2 if kind == "CrossAttnDownBlock2D" else 1)
            c_in = chans[i]
    add(chans[-1], len(chans) - 1, 5)
    return counts


def zero_sft_group_norms(cfg, lat: int) -> dict:
    """The GroupNorm32 calls a ``residual_fusion="zero_sft"`` UNet adds to one
    forward, by (C, H, W): each up-block resnet's ZeroSFT normalises the
    concatenation its resnet's ``norm1`` sees, and ``mid_zero_sft`` the mid
    block's output."""
    from instantir_tpu_torch.models.unet import down_stack_channels

    chans = cfg.block_out_channels
    n = len(chans)
    counts = {(chans[-1], lat >> (n - 1), lat >> (n - 1)): 1}
    skips, c_in = list(down_stack_channels(cfg)), chans[-1]
    for i in range(len(cfg.up_block_types)):
        level = n - 1 - i
        for _ in range(cfg.layers_per_block + 1):
            key = (c_in + skips.pop(), lat >> level, lat >> level)
            counts[key] = counts.get(key, 0) + 1
            c_in = chans[level]
    return counts


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


def vae_train_k5(lat: int, encodes: int = 1, decodes: int = 0) -> int:
    """K5 launches of a training step's fp32 VAE at ``lat`` latents (8·lat
    pixels): ``encodes`` encodes of its images under ``no_grad`` and
    ``decodes`` decodes (the previewer's image branch), each norm a launch
    where the dispatch takes its shape."""
    from instantir_tpu_torch.models.vae import sdxl_vae_config

    vcfg = sdxl_vae_config()
    return encodes * vae_k5(vcfg, 8 * lat, 8 * lat, "encoder") + decodes * vae_k5(vcfg, lat, lat, "decoder")


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
    gn_launches = gn["total"] + ((gn["total"] - gn["down0"] - 1) if checkpointing else 0) + vae_train_k5(lat)
    return {"flash_attention_fwd": no_grad * passes, "flash_attention_fwd_lse": (n_long - no_grad) * passes,
            "flash_attention_bwd_dq": n_long - no_grad, "flash_attention_bwd_dkv": n_long - no_grad,
            "group_norm_silu": gn_launches}


def up_group_norms(cfg) -> int:
    """GroupNorm32 calls of one UNet's up blocks (two per resnet, one per Transformer2D)."""
    return sum((cfg.layers_per_block + 1) * (3 if kind == "CrossAttnUpBlock2D" else 2) for kind in cfg.up_block_types)


def expected_stage2_launches(cfg, s2cfg, lat: int, checkpointing: bool) -> dict:
    """Kernel launches of one stage-2 ``train_step`` (no accumulation) with
    the adapter frozen: only the Aggregator trains. The previewer (one UNet
    forward, two with ``cfg_scale > 1``) runs under ``no_grad``: K1. The main
    UNet's down and mid blocks see no input and no parameter that needs a
    gradient: K1. Its up blocks take the skips that carry the Aggregator's
    residuals, and every Aggregator attention has trainable inputs: each of
    those long self-attentions runs the forward with lse (K2) and, once, dQ
    (K3) and dK/dV (K4). K5 follows the same split between forwards.
    Gradient checkpointing recomputes the blocks whose outputs need a gradient
    (the UNet's up blocks, every Aggregator block): their K2 and K5 run twice;
    a block whose outputs need none is not recomputed."""
    if s2cfg.optimize_adapter:
        fail("expected_stage2_launches derives the counts for a frozen adapter (optimize_adapter=False)")
    full = sum(flash_calls_per_forward(cfg, lat, lat, with_up=True).values())
    down_mid = sum(flash_calls_per_forward(cfg, lat, lat, with_up=False).values())
    agg = sum(flash_calls_per_forward(cfg, lat, lat, with_up=False, concat=2).values())
    previewer = 2 if s2cfg.cfg_scale > 1.0 else 1
    passes = 2 if checkpointing else 1
    grad_attn = full - down_mid + agg
    gn_unet = group_norms_per_forward(cfg)["total"]
    gn_agg = group_norms_per_forward(cfg, with_up=False)["total"]
    gn_again = up_group_norms(cfg) + gn_agg if checkpointing else 0
    return {"flash_attention_fwd": previewer * full + down_mid, "flash_attention_fwd_lse": grad_attn * passes,
            "flash_attention_bwd_dq": grad_attn, "flash_attention_bwd_dkv": grad_attn,
            "group_norm_silu": (previewer + 1) * gn_unet + gn_agg + gn_again + vae_train_k5(lat, encodes=2)}


def expected_previewer_launches(cfg, lat: int, checkpointing: bool, image_branch: bool = False) -> dict:
    """Kernel launches of one previewer ``train_step`` (no accumulation). The
    teacher's cond and uncond passes and the target run under ``no_grad``:
    three UNet forwards, K1 on every long self-attention. The student runs
    under gradient, and the LoRA on every self-attention's q, k and v trains,
    so each of its long self-attentions runs the forward with lse (K2) and,
    once, dQ (K3) and dK/dV (K4). K5 runs in all four forwards. Gradient
    checkpointing recomputes every block of the student (each holds LoRA
    leaves): K2 twice, and K5 again but for ``conv_norm_out``, which lies
    outside the blocks. The fp32 VAE encodes the batch (K5 at every norm the
    dispatch takes); the image branch (``image_branch``: a loss that reads
    images) decodes the target under ``no_grad`` and the prediction under
    gradient checkpointing, which decodes it again in the backward: three
    decodes' K5. Neither the VAE's nor DINOv2's attention is long enough for
    the flash kernels."""
    n_long = sum(flash_calls_per_forward(cfg, lat, lat, with_up=True).values())
    passes = 2 if checkpointing else 1
    gn = group_norms_per_forward(cfg)["total"]
    return {"flash_attention_fwd": 3 * n_long, "flash_attention_fwd_lse": n_long * passes,
            "flash_attention_bwd_dq": n_long, "flash_attention_bwd_dkv": n_long,
            "group_norm_silu": 4 * gn + ((gn - 1) if checkpointing else 0)
            + vae_train_k5(lat, decodes=3 if image_branch else 0)}


def heads_by_seq(cfg, lat: int, concat: int = 1) -> dict:
    """Heads (head_dim 64) of each level's self-attention, by its sequence
    length, in a UNet (``concat=1``) or the Aggregator's H-concat (2)."""
    return {((lat * concat) >> i) * (lat >> i): c // 64 for i, c in enumerate(cfg.block_out_channels)}


def _add_by_shape(out: dict, cfg, lat: int, batch: int, by_seq: dict, n: int, concat: int = 1) -> None:
    heads = heads_by_seq(cfg, lat, concat)
    for s, c in by_seq.items():
        out[(batch, s, heads[s])] = out.get((batch, s, heads[s]), 0) + c * n


def flash_launches_by_shape(cfg, s2cfg) -> dict:
    """{path: {kernel: {(B, S, H): launches}}} of the bf16 flash kernels on
    the six training paths as phases 5-7 drive them (stage 1: three steps at
    512² batch 2, one at 1024² batch 1 checkpointed; stage 2: two and one;
    the previewer: three and one), split by shape as
    ``expected_train_launches``, ``expected_stage2_launches`` and
    ``expected_previewer_launches`` count them in all."""
    first_level = next(i for i, kind in enumerate(cfg.down_block_types) if kind == "CrossAttnDownBlock2D")
    out = {}
    for path, stage, res, batch, steps, checkpointing in (
            ("train_512", 1, 512, 2, 3, False), ("train_1024", 1, 1024, 1, 1, True),
            ("train_stage2_512", 2, 512, 2, 2, False), ("train_stage2_1024", 2, 1024, 1, 1, True),
            ("train_previewer_512", "previewer", 512, 2, 3, False),
            ("train_previewer_1024", "previewer", 1024, 1, 1, True)):
        lat, passes = res // 8, 2 if checkpointing else 1
        full = flash_calls_per_forward(cfg, lat, lat, with_up=True)
        kernels = {name: {} for name in COUNTERS if name.startswith("flash_") and not name.endswith("_f32")}
        if stage == "previewer":  # teacher cond and uncond, target: K1; the student: K2-K4
            _add_by_shape(kernels["flash_attention_fwd"], cfg, lat, batch, full, 3 * steps)
            unet_grad, agg = full, {}
        elif stage == 1:
            s0 = (lat >> first_level) ** 2
            no_grad = {s0: 1} if s0 >= 512 else {}
            _add_by_shape(kernels["flash_attention_fwd"], cfg, lat, batch, no_grad, steps * passes)
            unet_grad, agg = {s: c - no_grad.get(s, 0) for s, c in full.items()}, {}
        else:
            down_mid = flash_calls_per_forward(cfg, lat, lat, with_up=False)
            previewer = 2 if s2cfg.cfg_scale > 1.0 else 1
            _add_by_shape(kernels["flash_attention_fwd"], cfg, lat, batch,
                          {s: previewer * c + down_mid.get(s, 0) for s, c in full.items()}, steps)
            unet_grad = {s: c - down_mid.get(s, 0) for s, c in full.items()}
            agg = flash_calls_per_forward(cfg, lat, lat, with_up=False, concat=2)
        for name, n in (("flash_attention_fwd_lse", steps * passes), ("flash_attention_bwd_dq", steps),
                        ("flash_attention_bwd_dkv", steps)):
            _add_by_shape(kernels[name], cfg, lat, batch, unet_grad, n)
            _add_by_shape(kernels[name], cfg, lat, batch, agg, n, concat=2)
        out[path] = kernels
    return out


COUNTERS = {
    "flash_attention_fwd": ("attention", "flash_attention_launches"),
    "flash_attention_fwd_lse": ("attention", "flash_attention_lse_launches"),
    "flash_attention_bwd_dq": ("attention", "flash_backward_dq_launches"),
    "flash_attention_bwd_dkv": ("attention", "flash_backward_dkv_launches"),
    "group_norm_silu": ("group_norm", "group_norm_launches"),
    "flash_attention_fwd_f32": ("attention", "flash_attention_f32_launches"),
    "flash_attention_fwd_lse_f32": ("attention", "flash_attention_lse_f32_launches"),
    "flash_attention_bwd_dq_f32": ("attention", "flash_backward_dq_f32_launches"),
    "flash_attention_bwd_dkv_f32": ("attention", "flash_backward_dkv_f32_launches"),
}


def every_counter(expected: dict) -> dict:
    """``expected`` with a 0 for every counter it does not name."""
    return {name: expected.get(name, 0) for name in COUNTERS}


def as_f32(expected: dict) -> dict:
    """The counts of a bf16 path for the same path in fp32: each flash count
    moves to its fp32 entry point; K5 takes every dtype, so its count stays."""
    return every_counter({(f"{name}_f32" if name.startswith("flash_") else name): n for name, n in expected.items()})


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
    expected = expected_restore_launches(ucfg, cfg, phases, lat_hw)
    by_shape = sum(group_norm_launches_by_shape(ucfg, phases, lat_hw).values()) + vae_restore_k5(cfg, res, res)
    if (by_shape, sum(by_seq.values())) != (expected["group_norm_silu"], expected["flash_attention_fwd"]):
        fail(f"launches derived by shape (K5 {by_shape}) and by sequence (K1 {sum(by_seq.values())}) differ from "
             f"those derived by block ({expected})")
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
    for fused in (False, True, True, False):
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


def stale_step_launches(cfg, lat: int, depth: int, lat_w: Optional[int] = None) -> dict:
    """K1 and K5 launches of one shallow UNet forward (a DeepCache stale
    step: the first ``depth`` down blocks, the last ``depth`` up blocks and
    ``conv_norm_out``; the previewer and the Aggregator do not run). In SDXL
    at depth 1 those are ``DownBlock2D`` and ``UpBlock2D``: no attention, so
    no K1, and 4 + 6 + 1 GroupNorms."""
    n = len(cfg.block_out_channels)
    lat_w = lat if lat_w is None else lat_w
    k1, gn = 0, 1  # conv_norm_out
    for i in range(depth):
        cross = cfg.down_block_types[i] == "CrossAttnDownBlock2D"
        gn += cfg.layers_per_block * (3 if cross else 2)
        if cross and (lat >> i) * (lat_w >> i) >= 512:
            k1 += cfg.layers_per_block * cfg.transformer_layers_per_block[i]
    for i in range(n - depth, n):
        level, cross = n - 1 - i, cfg.up_block_types[i] == "CrossAttnUpBlock2D"
        gn += (cfg.layers_per_block + 1) * (3 if cross else 2)
        if cross and (lat >> level) * (lat_w >> level) >= 512:
            k1 += (cfg.layers_per_block + 1) * cfg.transformer_layers_per_block[level]
    return {"flash_attention_fwd": k1, "group_norm_silu": gn}


def forward_launches(cfg, lat: int, lat_w: Optional[int] = None):
    """K1 and K5 launches of one bf16 UNet forward and of one Aggregator
    forward (its H-concat) at ``lat`` x ``lat_w`` latents, fused GroupNorm on."""
    lat_w = lat if lat_w is None else lat_w
    unet = {"flash_attention_fwd": sum(flash_calls_per_forward(cfg, lat, lat_w, with_up=True).values()),
            "group_norm_silu": group_norms_per_forward(cfg)["total"]}
    agg = {"flash_attention_fwd": sum(flash_calls_per_forward(cfg, lat, lat_w, with_up=False, concat=2).values()),
           "group_norm_silu": group_norms_per_forward(cfg, with_up=False)["total"]}
    return unet, agg


def expected_restore_launches(cfg, rcfg, phases, lat: int, lat_w: Optional[int] = None, batch: int = 1,
                              decode: bool = True) -> dict:
    """K1 and K5 launches of one bf16 restore with the fused GroupNorm on, by
    step: a fresh step of mode A runs the Aggregator and the main UNet, B adds
    the previewer UNet, C runs the main UNet; a DeepCache stale step runs the
    shallow UNet alone (``stale_step_launches``); then the fp32 VAE's K5
    launches (``vae_restore_k5``: the encode of a ``batch`` of images, the
    decode unless ``decode`` is False, ``output_type="latent"``; tiled,
    sliced or in bf16 as ``rcfg`` says). The Heun lookahead and the merged
    LoRA change no count. ``lat`` x ``lat_w`` is the latent's height x width
    (square when ``lat_w`` is None)."""
    lat_w = lat if lat_w is None else lat_w
    unet, agg = forward_launches(cfg, lat, lat_w)
    stale = stale_step_launches(cfg, lat, rcfg.deepcache_depth, lat_w)
    out = {"flash_attention_fwd": 0, "group_norm_silu": 0}
    for p in phases:
        n_unet, n_agg = {"A": (1, 1), "B": (2, 1), "C": (1, 0)}[p["mode"]]
        for refresh in p["refresh"]:
            for name in out:
                if refresh or rcfg.deepcache_interval <= 1:
                    out[name] += n_unet * unet[name] + n_agg * agg[name]
                else:
                    out[name] += stale[name]
    out["group_norm_silu"] += vae_restore_k5(rcfg, 8 * lat, 8 * lat_w, batch, decode)
    return out


def run_restore_options(torch, pipe, steps: int, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4b: the restore options on phase 4's bf16 models, at 1024² and 4
    steps (slicing at 512², batch 2), each restore's launch counters set to 0
    just before it and read just after, each image finite RGB: the whole
    restore as one CUDA graph (``fused``) against the staged restore on the
    same noise (s/image over 3 calls each after the recording, in turns; the
    recording's time; both peaks), the merged previewer LoRA
    (``fuse_previewer_lora``) and ``freeze_previewer`` on a copy of the UNet,
    DeepCache (interval 2, depth 1), the Heun lookahead, the bf16 decode, VAE
    tiling (96-latent tiles over 128 latents: 2 x 2 tiles) and slicing. With
    ``steps`` other than 4, config #4 at ``steps`` staged and as a graph, with
    the dynamic and the merged LoRA, in turns. Then the VAE's GroupNorms on
    the plain version against K5 in turns: the encode, the decode and the
    graph replay at ``steps`` steps."""
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreNoise, build_step_phases

    group_norm = mods["group_norm"]
    if not group_norm.USE_FUSED:
        fail("phase 4b derives its counts with the fused GroupNorm on")
    g = torch.Generator(device="cuda").manual_seed(11)

    def inputs(res: int, batch: int, n_steps: int):
        lq = torch.rand(batch, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
        pe = (torch.randn(batch, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        pooled = (torch.randn(batch, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        lat = (batch, res // 8, res // 8, 4)
        noise = RestoreNoise(*(torch.randn(lat, generator=g, device="cuda") for _ in range(2)),
                             [torch.randn(lat, generator=g, device="cuda") for _ in range(n_steps)])
        return lq, pe, pooled, noise

    out = {"launches": {}}

    def restore(what: str, p, cfg, args, expected: dict, output_type: str = "pt"):
        """One restore between counter reads and two synchronizes; fails on a
        count other than ``expected`` or an image that is not finite RGB. The
        counts read are kept under ``out["launches"][what]``."""
        lq, pe, pooled, noise = args
        zero_counters(mods)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        image, previews = p.restore(lq, pe, pooled, cfg=cfg, noise=noise, output_type=output_type)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = out["launches"][what] = read_counters(mods)
        if launches != every_counter(expected):
            fail(f"{what}: kernel launches {launches} differ from the counts derived from the config "
                 f"{every_counter(expected)}")
        if output_type == "pt":
            want = (lq.shape[0], lq.shape[1], lq.shape[2], 3)
            if tuple(image.shape) != want or not torch.isfinite(image).all():
                fail(f"{what}: the image is not finite RGB of shape {want}: {tuple(image.shape)}")
        return image, sec, torch.cuda.max_memory_allocated() / 1e9

    def rel_l2(a, b) -> float:
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def close(what: str, got, want, tol: float = RESTORE_TOL) -> float:
        rel = rel_l2(got, want)
        log(f"  {what}: relative L2 difference {rel:.3e}, max abs {(got.float() - want.float()).abs().max().item():.3e}")
        if not rel <= tol:
            fail(f"{what}: relative L2 {rel} > {tol}")
        return rel

    res, lat = 1024, 1024 // 8
    base = restore_config(4)
    expected = expected_restore_launches(ucfg, base, build_step_phases(base), lat)
    args = inputs(res, 1, 4)
    fused_cfg = dataclasses.replace(base, fused=True)

    # 1. the staged restore and the graph on the same noise, in turns after the recording
    staged_img, _, staged_peak = restore("staged restore", pipe, base, args, expected)
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved() / 1e9
    graph_img, record_sec, record_peak = restore("graph recording", pipe, fused_cfg, args,
                                                 {k: 2 * n for k, n in expected.items()})
    torch.cuda.empty_cache()  # what stays reserved is the graph's private pool (and its output)
    pool = torch.cuda.memory_reserved() / 1e9 - reserved0
    secs = {"staged": [], "graph": []}
    for kind in ("staged", "graph", "graph", "staged", "staged", "graph"):
        img, sec, peak = restore(f"{kind} restore", pipe, base if kind == "staged" else fused_cfg, args,
                                 expected if kind == "staged" else {})
        secs[kind].append(sec)
        if kind == "graph":
            graph_img = img
    diff = (graph_img.float() - staged_img.float()).abs().max().item()
    scale = max(1.0, staged_img.float().abs().max().item())
    log(f"  fused (one CUDA graph) vs staged, 1024² 4 steps: {min(secs['graph']):.3f} vs {min(secs['staged']):.3f} "
        f"s/image (runs {['%.3f' % x for x in secs['graph']]} vs {['%.3f' % x for x in secs['staged']]}); the "
        f"recording call (warm-up, capture, replay) {record_sec:.3f} s; peak memory staged {staged_peak:.2f} GB, "
        f"recording {record_peak:.2f} GB, the graph's pool {pool:.2f} GB; image max abs difference "
        f"{diff:.3e} (scale {scale:.3f}) on {card_line}")
    if not diff <= 1e-3 * scale:
        fail(f"the graph-replayed image differs from the staged one by {diff} > 1e-3 x {scale}")
    out.update(staged_sec=min(secs["staged"]), graph_sec=min(secs["graph"]), record_sec=record_sec,
               staged_peak=staged_peak, record_peak=record_peak, pool_gb=pool, graph_diff=diff)

    # 2. the merged previewer LoRA, per restore and frozen (on a copy of the UNet)
    merged_cfg = dataclasses.replace(base, fuse_previewer_lora=True)
    merged_secs = []
    for _ in range(2):
        merged_img, sec, _ = restore("fuse_previewer_lora restore", pipe, merged_cfg, args, expected)
        merged_secs.append(sec)
    close("fuse_previewer_lora vs the dynamic LoRA branch, image", merged_img, staged_img)
    unet_copy = copy.deepcopy(pipe.unet)
    frozen = InstantIRPipeline(unet_copy, pipe.aggregator, pipe.vae, pipe.resampler, pipe.image_encoder,
                               pipe.schedule, device="cuda").freeze_previewer(base.lora_alpha)
    frozen_secs = []
    for _ in range(2):
        frozen_img, sec, frozen_peak = restore("freeze_previewer restore", frozen, base, args, expected)
        frozen_secs.append(sec)
    close("freeze_previewer vs the dynamic LoRA branch, image", frozen_img, staged_img)
    del frozen, unet_copy
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  fuse_previewer_lora {['%.3f' % x for x in merged_secs]} s/image, freeze_previewer "
        f"{['%.3f' % x for x in frozen_secs]} (peak {frozen_peak:.2f} GB with the merged copy)")
    out.update(merged_sec=min(merged_secs), frozen_sec=min(frozen_secs))

    # 3. DeepCache, interval 2, depth 1: a stale step runs the shallow UNet alone
    dc_cfg = dataclasses.replace(base, deepcache_interval=2, deepcache_depth=1)
    dc_phases = build_step_phases(dc_cfg)
    dc_expected = expected_restore_launches(ucfg, dc_cfg, dc_phases, lat)
    stale = stale_step_launches(ucfg, lat, 1)
    log(f"  DeepCache interval 2 depth 1: refresh {[(p['mode'], p['refresh']) for p in dc_phases]}; a stale step "
        f"launches {stale}; expected per restore {dc_expected}")
    if stale["flash_attention_fwd"] != 0:
        fail(f"a DeepCache stale step at depth 1 was derived to launch K1 {stale['flash_attention_fwd']} times")
    dc_img, dc_sec, _ = restore("DeepCache restore", pipe, dc_cfg, args, dc_expected)
    log(f"  DeepCache restore {dc_sec:.3f} s/image; image against the exact restore: relative L2 "
        f"{rel_l2(dc_img, staged_img):.3e}")

    # 4. the Heun lookahead
    heun_img, heun_sec, _ = restore("multistep_restore", pipe, dataclasses.replace(base, multistep_restore=True),
                                    args, expected)
    log(f"  multistep_restore {heun_sec:.3f} s/image; image against the default: relative L2 "
        f"{rel_l2(heun_img, staged_img):.3e}")

    # 5. the bf16 decode: against the fp32 decode of the same latents, and its time
    latents, _, _ = restore("latent restore", pipe, base, args,
                            expected_restore_launches(ucfg, base, build_step_phases(base), lat, decode=False),
                            output_type="latent")
    z = latents.permute(0, 3, 1, 2)
    with torch.no_grad():
        dec32 = pipe.decode_latents(z)
        dec16 = pipe.decode_latents(z, torch.bfloat16)
        ms32 = time_ms(torch, lambda: pipe.decode_latents(z), iters=3, warmup=1)
        ms16 = time_ms(torch, lambda: pipe.decode_latents(z, torch.bfloat16), iters=3, warmup=1)
    close("bf16 decode vs fp32 decode", dec16, dec32)
    bf16_cfg = dataclasses.replace(base, decode_dtype="bfloat16")
    bf16_img, bf16_sec, _ = restore("decode_dtype=bfloat16 restore", pipe, bf16_cfg, args,
                                    expected_restore_launches(ucfg, bf16_cfg, build_step_phases(bf16_cfg), lat))
    log(f"  decode 1024²: fp32 {ms32:.2f} ms, bf16 {ms16:.2f} ms; decode_dtype=bfloat16 restore {bf16_sec:.3f} s/image")
    out.update(decode_ms_f32=ms32, decode_ms_bf16=ms16, bf16_sec=bf16_sec)

    # 6. VAE tiling: 96-latent tiles over 128 latents (2 x 2 tiles to encode and to decode)
    with torch.no_grad():
        tiled_dec = pipe.decode_latents(z, tiling=(96, 0.25))
    close("tiled vs untiled decode of the same latents", tiled_dec, dec32)
    tiled_cfg = dataclasses.replace(base, vae_tiling=True)
    tiled_img, tiled_sec, tiled_peak = restore("vae_tiling restore", pipe, tiled_cfg, args,
                                               expected_restore_launches(ucfg, tiled_cfg, build_step_phases(base), lat))
    close("vae_tiling restore vs the untiled one", tiled_img, staged_img)
    log(f"  vae_tiling restore {tiled_sec:.3f} s/image, peak {tiled_peak:.2f} GB (untiled {staged_peak:.2f})")

    # 7. VAE slicing at 512², batch 2: the fp32 encode and decode against the unsliced ones (only the
    # convolutions' batch differs), then the restore against the unsliced one fed the same per-sample draws
    small = inputs(512, 2, 4)
    with torch.no_grad():
        z_whole = pipe.encode_vae_image(small[0], small[3].vae)
        close("sliced vs unsliced fp32 encode, batch 2 at 512²", pipe.encode_vae_image(small[0], small[3].vae,
                                                                                      slicing=True), z_whole, 1e-4)
        close("sliced vs unsliced fp32 decode, batch 2 at 512²", pipe.decode_latents(z_whole, slicing=True),
              pipe.decode_latents(z_whole), 1e-4)
    sliced_cfg = dataclasses.replace(base, vae_slicing=True)
    sliced_img, sliced_sec, sliced_peak = restore(
        "vae_slicing restore", pipe, sliced_cfg, small,
        expected_restore_launches(ucfg, sliced_cfg, build_step_phases(base), 512 // 8, batch=2))
    whole_img, whole_sec, whole_peak = restore(
        "unsliced batch-2 restore", pipe, base, small,
        expected_restore_launches(ucfg, base, build_step_phases(base), 512 // 8, batch=2))
    close("vae_slicing vs unsliced, batch 2 at 512²", sliced_img, whole_img)
    log(f"  512² batch 2: sliced {sliced_sec:.3f} s, peak {sliced_peak:.2f} GB; unsliced {whole_sec:.3f} s, peak "
        f"{whole_peak:.2f} GB")
    out["expected"] = expected

    # 8. config #4 at the steps asked for: staged and graph, dynamic and merged LoRA, in turns
    if steps != 4:
        c4 = restore_config(steps)
        c4_expected = expected_restore_launches(ucfg, c4, build_step_phases(c4), lat)
        c4_args = inputs(res, 1, steps)
        runs = {}
        for merged in (False, True):
            cfg = dataclasses.replace(c4, fuse_previewer_lora=merged)
            _, rec_sec, rec_peak = restore(f"{steps}-step graph recording", pipe, dataclasses.replace(cfg, fused=True),
                                           c4_args, {k: 2 * n for k, n in c4_expected.items()})
            log(f"  config #4, {steps} steps, {'merged' if merged else 'dynamic'} LoRA: the graph's recording call "
                f"{rec_sec:.3f} s, peak {rec_peak:.2f} GB")
            for kind in ("staged", "graph", "graph", "staged"):
                _, sec, _ = restore(f"{steps}-step {kind} restore", pipe, dataclasses.replace(cfg, fused=kind == "graph"),
                                    c4_args, c4_expected if kind == "staged" else {})
                runs.setdefault((kind, merged), []).append(sec)
        for (kind, merged), secs in runs.items():
            log(f"  config #4, {steps} steps, {kind}, {'merged' if merged else 'dynamic'} LoRA: "
                f"{['%.3f' % x for x in secs]} s/image on {card_line}")
        out["config4"] = {f"{kind}_{'merged' if merged else 'dynamic'}": min(v) for (kind, merged), v in runs.items()}

    # 9. the VAE's GroupNorms on the plain version (as the port ran them before K5 took them: hooks on the encoder
    # and the decoder turn USE_FUSED off while they run) against K5, in turns -- plain, K5, K5, plain: the fp32
    # encode and decode at 1024² (ms and the peak above what was allocated) and the graph replay of config #4 at
    # ``steps`` steps (``--steps 30``: config #4 itself), each setting's graph recorded on a pipeline of its own
    # over the same models
    def switch(on: bool):
        def hook(*_):
            group_norm.USE_FUSED = on
        return hook

    def vae_call(fn):
        with torch.no_grad():
            ms = time_ms(torch, fn, iters=3, warmup=1, groups=1)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
        return ms, (torch.cuda.max_memory_allocated() - before) / 1e9

    c4 = restore_config(steps)
    c4_graph = dataclasses.replace(c4, fused=True)
    c4_args = inputs(res, 1, steps)
    c4_k5 = expected_restore_launches(ucfg, c4, build_step_phases(c4), lat)
    vae_n = vae_restore_k5(c4, res, res)
    pipes = {setting: InstantIRPipeline(pipe.unet, pipe.aggregator, pipe.vae, pipe.resampler, pipe.image_encoder,
                                        pipe.schedule, device="cuda") for setting in ("plain", "K5")}
    vae_lq, vae_noise = c4_args[0], c4_args[3].vae
    with torch.no_grad():
        z = pipe.encode_vae_image(vae_lq, vae_noise)
    turns = []
    for setting in ("plain", "K5", "K5", "plain"):
        hooks = ([h for m in (pipe.vae.encoder, pipe.vae.decoder)
                  for h in (m.register_forward_pre_hook(switch(False)), m.register_forward_hook(switch(True)))]
                 if setting == "plain" else [])
        enc_ms, enc_peak = vae_call(lambda: pipe.encode_vae_image(vae_lq, vae_noise))
        dec_ms, dec_peak = vae_call(lambda: pipe.decode_latents(z))
        if not any(t["setting"] == setting for t in turns):  # the VAE's K5 launches only in K5's recording
            want = dict(c4_k5, group_norm_silu=c4_k5["group_norm_silu"] - (vae_n if setting == "plain" else 0))
            restore(f"{steps}-step graph recording, VAE norms {setting}", pipes[setting], c4_graph, c4_args,
                    {k: 2 * n for k, n in want.items()})
        _, sec, _ = restore(f"{steps}-step graph replay, VAE norms {setting}", pipes[setting], c4_graph, c4_args, {})
        for h in hooks:
            h.remove()
        turns.append(dict(setting=setting, encode_ms=enc_ms, encode_peak_gb=enc_peak, decode_ms=dec_ms,
                          decode_peak_gb=dec_peak, replay_sec=sec))
        log(f"  VAE norms {setting}: encode 1024² {enc_ms:.2f} ms (peak +{enc_peak:.2f} GB), decode {dec_ms:.2f} ms "
            f"(peak +{dec_peak:.2f} GB), {steps}-step graph replay {sec:.3f} s/image; on {card_line}")
    if group_norm.USE_FUSED is not True:
        fail("phase 4b: the VAE turns left USE_FUSED off")
    del pipes, z
    gc.collect()
    torch.cuda.empty_cache()
    out["vae_turns"] = turns
    return out


def write_png(path, rgb) -> None:
    """An 8-bit RGB PNG from a ``[H, W, 3]`` uint8 array (zlib, no filter)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    return struct.unpack(">II", head[16:24])


def read_png(data: bytes):
    """``[H, W, 3]`` uint8 pixels of an 8-bit RGB or RGBA PNG (not
    interlaced; every filter type), with zlib alone."""
    import struct
    import zlib

    import numpy as np

    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    if head is None or head[2] != 8 or head[3] not in (2, 6) or head[6]:
        fail(f"read_png: not an 8-bit RGB / RGBA PNG without interlace: IHDR {head}")
    w, h, ch = head[0], head[1], 3 if head[3] == 2 else 4
    raw, stride = zlib.decompress(b"".join(idat)), w * ch
    rows, prev = [], [0] * stride
    for y in range(h):
        kind, line = raw[y * (stride + 1)], list(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for i in range(stride):
            a = line[i - ch] if i >= ch else 0
            b, c = prev[i], (prev[i - ch] if i >= ch else 0)
            if kind == 4:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                a = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + (0, a, b, (a + b) // 2, a)[kind]) & 255
        rows.append(line)
        prev = line
    return np.array(rows, np.uint8).reshape(h, w, ch)[..., :3]


def write_tokenizer(folder: str, pad_token: Optional[str] = None) -> None:
    """A tokenizer folder with a small synthetic vocabulary: CLIP's 256 byte
    characters with and without ``</w>`` at ids 0-511, no merges, the special
    tokens at CLIP's ids 49406/49407; ``pad_token`` (SDXL's ``tokenizer_2``
    pads with ``!``, id 0) when given."""
    from instantir_tpu_torch.utils.tokenizer import bytes_to_unicode

    os.makedirs(folder, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    settings = {"model_max_length": 77, "tokenizer_class": "CLIPTokenizer"}
    if pad_token is not None:
        settings["pad_token"] = pad_token
    with open(os.path.join(folder, "tokenizer_config.json"), "w") as f:
        json.dump(settings, f)


def write_checkpoint_tree(torch, pipe, encoders, root: str) -> dict:
    """Phase 4c, step 1: ``pipe``'s models and the two text towers written in
    the released layout under ``root``: the diffusers SDXL folder (UNet, VAE
    and towers as ``.safetensors`` with ``config.json``s, two tokenizer
    folders), ``adapter.pt`` (``convert.export_adapter``),
    ``previewer_lora_weights.bin`` (``convert.export_previewer_lora``: the
    UNet's LoRA under ``PreviewerTrainer.lora_state``'s names and the
    Resampler's), ``aggregator.pt`` and a DINOv2 folder; each tensor in its
    model's dtype (bf16, norms and the VAE fp32), so that loading gives the
    same values back. Fails first if the disk cannot hold it."""
    from instantir_tpu_torch import convert

    models = {"unet": pipe.unet, "aggregator": pipe.aggregator, "vae": pipe.vae, "resampler": pipe.resampler,
              "image_encoder": pipe.image_encoder, "text_encoder": encoders[0], "text_encoder_2": encoders[1]}
    need = sum(t.numel() * t.element_size() for m in models.values() for t in m.state_dict().values())
    free = shutil.disk_usage(root).free
    if free < need * 1.1 + 2e9:
        fail(f"phase 4c: the checkpoint tree takes {need / 1e9:.2f} GB, {root} has {free / 1e9:.2f} GB free")
    sdxl, inst, dino = (os.path.join(root, d) for d in ("sdxl", "instantir", "dinov2"))
    for d in ("unet", "vae", "text_encoder", "text_encoder_2"):
        os.makedirs(os.path.join(sdxl, d))
    os.makedirs(inst)
    os.makedirs(dino)

    def cpu_state(m):
        return {k: v.detach().cpu() for k, v in m.state_dict().items()}

    def dump(path, obj):
        with open(path, "w") as f:
            json.dump(obj, f)

    ucfg, vcfg = pipe.unet.config, pipe.vae.config
    unet_sd = cpu_state(pipe.unet)
    convert.write_safetensors(os.path.join(sdxl, "unet", "diffusion_pytorch_model.safetensors"),
                              {k: v for k, v in unet_sd.items() if "lora_" not in k and ".processor." not in k})
    dump(os.path.join(sdxl, "unet", "config.json"), {
        "sample_size": ucfg.sample_size, "in_channels": ucfg.in_channels, "out_channels": ucfg.out_channels,
        "down_block_types": list(ucfg.down_block_types), "up_block_types": list(ucfg.up_block_types),
        "block_out_channels": list(ucfg.block_out_channels), "layers_per_block": ucfg.layers_per_block,
        "transformer_layers_per_block": list(ucfg.transformer_layers_per_block),
        "attention_head_dim": list(ucfg.num_attention_heads), "num_attention_heads": None,
        "cross_attention_dim": ucfg.cross_attention_dim, "addition_time_embed_dim": ucfg.addition_time_embed_dim,
        "projection_class_embeddings_input_dim": ucfg.projection_class_embeddings_input_dim,
        "norm_num_groups": ucfg.norm_num_groups})
    convert.write_safetensors(os.path.join(sdxl, "vae", "diffusion_pytorch_model.safetensors"), cpu_state(pipe.vae))
    dump(os.path.join(sdxl, "vae", "config.json"), {
        "block_out_channels": list(vcfg.block_out_channels), "layers_per_block": vcfg.layers_per_block,
        "latent_channels": vcfg.latent_channels, "norm_num_groups": vcfg.norm_num_groups,
        "scaling_factor": vcfg.scaling_factor})
    for sub, enc in zip(("text_encoder", "text_encoder_2"), encoders):
        c = enc.config
        convert.write_safetensors(os.path.join(sdxl, sub, "model.safetensors"), cpu_state(enc))
        dump(os.path.join(sdxl, sub, "config.json"), {
            "architectures": ["CLIPTextModelWithProjection" if c.projection_dim else "CLIPTextModel"],
            "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads, "intermediate_size": c.intermediate_size,
            "max_position_embeddings": c.max_length, "hidden_act": c.hidden_act,
            "projection_dim": c.projection_dim or 768, "eos_token_id": c.eos_token_id})
    write_tokenizer(os.path.join(sdxl, "tokenizer"))
    write_tokenizer(os.path.join(sdxl, "tokenizer_2"), pad_token="!")
    res_sd = cpu_state(pipe.resampler)
    torch.save(convert.export_adapter(unet_sd, res_sd), os.path.join(inst, "adapter.pt"))
    torch.save(convert.export_previewer_lora(unet_sd, res_sd), os.path.join(inst, "previewer_lora_weights.bin"))
    del unet_sd
    torch.save(cpu_state(pipe.aggregator), os.path.join(inst, "aggregator.pt"))
    dump(os.path.join(inst, "instantir_config.json"),
         {"lora_rank": ucfg.lora_rank, "resampler": dataclasses.asdict(pipe.resampler.config)})
    dcfg = pipe.image_encoder.config
    convert.write_safetensors(os.path.join(dino, "model.safetensors"), cpu_state(pipe.image_encoder))
    dump(os.path.join(dino, "config.json"), {
        "hidden_size": dcfg.hidden_size, "num_hidden_layers": dcfg.num_layers, "num_attention_heads": dcfg.num_heads,
        "mlp_ratio": dcfg.mlp_ratio, "patch_size": dcfg.patch_size, "image_size": dcfg.image_size})
    return {"sdxl": sdxl, "instantir": inst, "dinov2": dino, "gb": need / 1e9}


def run_load_and_cli(torch, pipe, steps: int, mods: dict, ucfg, card_line: str, after_tree=None) -> dict:
    """Phase 4c: phase 4's bf16 models written as a checkpoint tree in the
    released layout (with two synthetic full-width CLIP towers), loaded back
    with ``load_instantir_pipeline`` / ``load_text_encoders`` (every parameter
    equal to its twin), restored at 1024² in 4 steps staged and as a graph
    against the in-memory pipeline on the same noise (images equal), then the
    inference CLI (``cli.infer.main``, ``--fused``, 4 steps) over three PNGs
    of three sizes, and over two of them again (replays): every image
    written at its size, the launch counts derived from the config, and
    ``torch.cuda.memory_reserved`` within ``MAX_GRAPHS`` pools of the
    one-size figure; then ``main`` as a user runs it, its PNG equal to the
    loaded pipeline's restore of the same pixels. The bf16 text towers'
    outputs are held to the same weights in fp32. With ``steps`` other than
    4, config #4 through the CLI (a recording and a replay). ``after_tree(paths,
    towers)``, when given, runs last on the tree and the in-memory text towers
    (phase 4g); its result is kept under ``"after_tree"``. The tree is deleted
    at the end."""
    import tempfile

    import numpy as np

    from instantir_tpu_torch.cli import infer
    from instantir_tpu_torch.models.clip_text import CLIPTextModel, clip_vit_l_text_config, open_clip_bigg_text_config
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from instantir_tpu_torch.pipeline.instantir import MAX_GRAPHS, RestoreNoise, build_step_phases
    from instantir_tpu_torch.pipeline.load import load_instantir_pipeline, load_text_encoders

    bf16 = torch.bfloat16
    pipe._graphs.clear()  # phase 4b's recordings: their pools are not needed here
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(5)
    towers = [synthesize_weights(CLIPTextModel(c, dtype=bf16, device="cuda").requires_grad_(False).eval(), g)
              for c in (clip_vit_l_text_config(), open_clip_bigg_text_config())]
    root = tempfile.mkdtemp(prefix="instantir_ckpt_")
    out = {}
    try:
        # 1. the tree, 2. loaded back
        t0 = time.perf_counter()
        paths = write_checkpoint_tree(torch, pipe, towers, root)
        write_sec = time.perf_counter() - t0
        timings, text_timings = {}, {}
        lp = load_instantir_pipeline(paths["sdxl"], paths["instantir"], vision_encoder_path=paths["dinov2"],
                                     dtype=bf16, device="cuda", timings=timings)
        encoders = load_text_encoders(paths["sdxl"], dtype=bf16, device="cuda", timings=text_timings)
        log(f"  wrote a {paths['gb']:.2f} GB checkpoint tree in {write_sec:.1f} s; load_instantir_pipeline read "
            f"{timings['read_s']:.2f} s, copied to the card {timings['to_device_s']:.2f} s; load_text_encoders "
            f"read {text_timings['read_s']:.2f} s, copied {text_timings['to_device_s']:.2f} s on {card_line}")
        pairs = [(name, getattr(lp, name), getattr(pipe, name))
                 for name in ("unet", "aggregator", "vae", "resampler", "image_encoder")]
        pairs += [(f"text_encoder{s}", enc, twin) for s, (enc, _), twin in zip(("", "_2"), encoders, towers)]
        n_leaves = 0
        for name, loaded, twin in pairs:
            want = dict(twin.named_parameters())
            got = dict(loaded.named_parameters())
            if set(got) != set(want):
                fail(f"phase 4c: the loaded {name} has other parameters than its twin: "
                     f"{sorted(set(got) ^ set(want))[:5]}")
            for k, p in got.items():
                n_leaves += 1
                if p.dtype != want[k].dtype or not torch.equal(p, want[k]):
                    fail(f"phase 4c: the loaded {name}.{k} differs from its twin "
                         f"({p.dtype} vs {want[k].dtype})")
        log(f"  every loaded parameter ({n_leaves} leaves) equals its twin (max abs difference 0)")

        # 3. the loaded and the in-memory pipeline on the same noise, staged and as a graph
        res, lat = 1024, 1024 // 8
        cfg = restore_config(4)
        expected = expected_restore_launches(ucfg, cfg, build_step_phases(cfg), lat)
        lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
        pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(bf16)
        pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(bf16)
        shape = (1, lat, lat, 4)
        noise = RestoreNoise(*(torch.randn(shape, generator=g, device="cuda") for _ in range(2)),
                             [torch.randn(shape, generator=g, device="cuda") for _ in range(4)])
        for fused in (False, True):
            c = dataclasses.replace(cfg, fused=fused)
            images = []
            for what, p in (("loaded", lp), ("in-memory", pipe)):
                zero_counters(mods)
                image, _ = p.restore(lq, pe, pooled, cfg=c, noise=noise, output_type="pt")
                torch.cuda.synchronize()
                launches = read_counters(mods)
                if what == "loaded" and launches != every_counter({k: (2 if fused else 1) * n
                                                                    for k, n in expected.items()}):
                    fail(f"phase 4c: the loaded pipeline's {'graph recording' if fused else 'staged restore'} "
                         f"launched {launches}, derived {expected}")
                images.append(image.float())
            diff = (images[0] - images[1]).abs().max().item()
            log(f"  1024² 4 steps {'as one CUDA graph' if fused else 'staged'}: loaded vs in-memory image max abs "
                f"difference {diff:.3e}")
            if not (diff == 0 and torch.isfinite(images[0]).all()):
                fail(f"phase 4c: the loaded pipeline's image differs from the in-memory one's by {diff}")
        lp._graphs.clear()
        pipe._graphs.clear()
        del images, image
        gc.collect()
        torch.cuda.empty_cache()

        # text encoding, per prompt pair (the prompt and the negative prompt)
        def encode_pair():
            infer.encode_prompts(encoders, [infer.DEFAULT_PROMPT], "cuda")
            infer.encode_prompts(encoders, [infer.DEFAULT_NEG_PROMPT], "cuda")
            torch.cuda.synchronize()

        encode_pair()
        text_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode_pair()
            text_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  text encoding, both towers, per prompt pair: {min(text_ms):.2f} ms "
            f"(runs {['%.2f' % x for x in text_ms]}) on {card_line}")
        prompts = [infer.DEFAULT_PROMPT, infer.DEFAULT_NEG_PROMPT]
        got = infer.encode_prompts(encoders, prompts, "cuda")
        f32 = []
        for enc, tok in encoders:
            twin = CLIPTextModel(enc.config, dtype=torch.float32, device="cuda").requires_grad_(False).eval()
            twin.load_state_dict({k: v.float() for k, v in enc.state_dict().items()})
            f32.append((twin, tok))
        want = infer.encode_prompts(f32, prompts, "cuda")
        del f32
        for what, a, b in zip(("prompt embeddings", "pooled embeddings"), got, want):
            rel = ((a.float() - b).norm() / b.norm()).item()
            log(f"  bf16 towers' {what} {tuple(a.shape)} against the same weights in fp32: relative L2 {rel:.3e}")
            if not (torch.isfinite(a).all() and rel <= TEXT_TOL):
                fail(f"phase 4c: the bf16 towers' {what} are not finite or {rel} from fp32 (tolerance {TEXT_TOL})")

        # 4. the CLI over three sizes (recordings), then over two of them again (replays)
        rng = torch.Generator().manual_seed(7)
        sizes = {"a.png": (1024, 1024), "b.png": (1280, 960), "c.png": (960, 1280)}
        folders = {"first": os.path.join(root, "lq"), "again": os.path.join(root, "lq_again")}
        for folder in folders.values():
            os.makedirs(folder)
        pixels = {}
        for name, (w, h) in sizes.items():
            rgb = pixels[name] = (torch.rand(h, w, 3, generator=rng) * 255).to(torch.uint8).numpy()
            write_png(os.path.join(folders["first"], name), rgb)
            if name != "a.png":
                write_png(os.path.join(folders["again"], name), rgb)
        models = (lp, encoders)

        def argv(folder, out_dir, n_steps, extra=()):
            return ["--sdxl_path", paths["sdxl"], "--instantir_path", paths["instantir"],
                    "--vision_encoder_path", paths["dinov2"], "--test_path", folder, "--out_path", out_dir,
                    "--fused", "--num_inference_steps", str(n_steps), "--batch_size", "1", *extra]

        def cli_run(what, args, recordings: bool):
            """One ``main`` between counter reads; the launches derived from each
            group's size (a recording counts the warm-up and the capture, a
            replay nothing)."""
            cli_cfg = infer.restore_config(infer.build_parser().parse_args(args))
            phases = build_step_phases(cli_cfg)
            zero_counters(mods)
            torch.cuda.reset_peak_memory_stats()
            records = infer.main(args, models=models)
            launches = read_counters(mods)
            want = {}
            for r in records:
                w, h = r["size"]
                per = expected_restore_launches(ucfg, cli_cfg, phases, h // 8, w // 8)
                if recordings:
                    for k, n in per.items():
                        want[k] = want.get(k, 0) + 2 * n
            if launches != every_counter(want):
                fail(f"phase 4c, {what}: the CLI launched {launches}, derived {every_counter(want)}")
            out_dir = args[args.index("--out_path") + 1]
            for r in records:
                for f in r["files"]:
                    if png_size(os.path.join(out_dir, f)) != sizes[f]:
                        fail(f"phase 4c, {what}: {f} written at {png_size(os.path.join(out_dir, f))}, "
                             f"not {sizes[f]}")
            for r in records:
                log(f"  CLI {what}: {r['files'][0]} at {r['size'][0]}x{r['size'][1]}: {r['seconds']:.3f} s/image "
                    f"PNG read to PNG written ({r['restore_seconds']:.3f} in restore_arrays), {r['graphs']} recorded "
                    f"graph(s) held, memory_reserved {r['reserved_gb']:.2f} GB")
            return records, launches, torch.cuda.max_memory_allocated() / 1e9

        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved() / 1e9
        first, launches, peak = cli_run("first call", argv(folders["first"], os.path.join(root, "out"), 4), True)
        again, _, peak_again = cli_run("replay", argv(folders["again"], os.path.join(root, "out_again"), 4), False)
        one = first[0]["reserved_gb"] - base
        bound = base + MAX_GRAPHS * one * 1.05
        worst = max(r["reserved_gb"] for r in first + again)
        log(f"  memory_reserved before the CLI {base:.2f} GB; one 1024² graph {one:.2f} GB; highest after a size "
            f"{worst:.2f} GB, bound {bound:.2f} GB ({MAX_GRAPHS} pools); graphs held at most "
            f"{max(r['graphs'] for r in first + again)}; peak allocated {max(peak, peak_again):.2f} GB on {card_line}")
        if worst > bound or max(r["graphs"] for r in first + again) > MAX_GRAPHS:
            fail(f"phase 4c: memory_reserved reached {worst:.2f} GB, past {MAX_GRAPHS} pools of one size ({bound:.2f})")
        out.update(load=timings, text_load=text_timings, text_ms=min(text_ms), launches=launches,
                   cli_first={r["files"][0]: r["seconds"] for r in first},
                   cli_replay={r["files"][0]: r["seconds"] for r in again},
                   reserved=[r["reserved_gb"] for r in first + again], base_gb=base, one_graph_gb=one,
                   peak_gb=max(peak, peak_again))

        # the CLI as a user runs it (its own load from the tree's folders), one 1024² image whose resizes
        # are the identity: the PNG it writes against the loaded pipeline's restore of the same pixels with
        # the same prompt embeddings, the same seeded generator and the same uint8 mapping, exactly. The
        # pixels go in as ``arr[None]``, whose batch stride is 0 where the CLI's ``np.stack`` has H*W*3:
        # equal values must give the same image whatever the input's strides
        lp._graphs.clear()
        torch.cuda.empty_cache()
        user_in, user_out = os.path.join(root, "lq_user"), os.path.join(root, "out_user")
        os.makedirs(user_in)
        shutil.copy(os.path.join(folders["first"], "a.png"), user_in)
        user_args = argv(user_in, user_out, 4)
        user_parsed = infer.build_parser().parse_args(user_args)
        cli_cfg = infer.restore_config(user_parsed)
        per = expected_restore_launches(ucfg, cli_cfg, build_step_phases(cli_cfg), lat)
        zero_counters(mods)
        t0 = time.perf_counter()
        records = infer.main(user_args)
        user_sec = time.perf_counter() - t0
        launches = read_counters(mods)
        if launches != every_counter({k: 2 * n for k, n in per.items()}):
            fail(f"phase 4c, the CLI with its own load: launched {launches}, derived 2 x {per}")
        gc.collect()
        torch.cuda.empty_cache()
        got = np.asarray(infer.read_image(os.path.join(user_out, "a.png")))
        arr = pixels["a.png"].astype(np.float32) / 127.5 - 1.0
        pe, pooled = infer.encode_prompts(encoders, [infer.DEFAULT_PROMPT], "cuda")
        npe, npooled = infer.encode_prompts(encoders, [infer.DEFAULT_NEG_PROMPT], "cuda")
        image, _ = lp.restore(torch.from_numpy(arr[None]).cuda(), pe, pooled, negative_prompt_embeds=npe,
                              negative_pooled_embeds=npooled, cfg=cli_cfg,
                              generator=torch.Generator(device="cuda").manual_seed(user_parsed.seed))
        want = (((np.clip(image[0], -1.0, 1.0) + 1.0) / 2.0) * 255.0).astype(np.uint8)
        diff = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) if got.shape == want.shape else -1
        log(f"  CLI with its own load, 1024², 4 steps: {user_sec:.3f} s from main() to its return (load, warm-up, "
            f"capture, replay; the image {records[0]['seconds']:.3f} s PNG read to PNG written); its PNG "
            f"{got.shape} against the loaded pipeline's restore of the same pixels: max abs difference {diff} "
            f"(uint8), {len(np.unique(got))} distinct values on {card_line}")
        if diff != 0 or len(np.unique(got)) < 2:
            fail(f"phase 4c: the PNG the CLI wrote differs from the restore of its input (max abs difference {diff})")
        lp._graphs.clear()
        del image
        gc.collect()
        torch.cuda.empty_cache()
        out.update(user_sec=user_sec, cli_first_restore={r["files"][0]: r["restore_seconds"] for r in first},
                   cli_replay_restore={r["files"][0]: r["restore_seconds"] for r in again})

        # 5. config #4 through the CLI: a recording and a replay
        if steps != 4:
            c4 = os.path.join(root, "lq_c4")
            os.makedirs(c4)
            for name in ("x.png", "y.png"):
                sizes[name] = (1024, 1024)
                write_png(os.path.join(c4, name), (torch.rand(1024, 1024, 3, generator=rng) * 255).to(torch.uint8).numpy())
            lp._graphs.clear()
            torch.cuda.empty_cache()
            c4_args = argv(c4, os.path.join(root, "out_c4"), steps,
                           ("--preview_start", "0.1", "--creative_start", "0.7"))
            cli_cfg = infer.restore_config(infer.build_parser().parse_args(c4_args))
            per = expected_restore_launches(ucfg, cli_cfg, build_step_phases(cli_cfg), lat)
            zero_counters(mods)
            torch.cuda.reset_peak_memory_stats()
            records = infer.main(c4_args, models=models)
            launches = read_counters(mods)
            if launches != every_counter({k: 2 * n for k, n in per.items()}):
                fail(f"phase 4c, config #4: the CLI launched {launches}, derived 2 x {per}")
            log(f"  CLI config #4 ({steps} steps, 1024², --fused): first call {records[0]['seconds']:.3f} s/image "
                f"({records[0]['restore_seconds']:.3f} in restore_arrays), replay {records[1]['seconds']:.3f} s/image "
                f"({records[1]['restore_seconds']:.3f} in restore_arrays), PNG read to PNG written; peak allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card_line}")
            out["config4"] = {"first": records[0]["seconds"], "replay": records[1]["seconds"],
                              "first_restore": records[0]["restore_seconds"],
                              "replay_restore": records[1]["restore_seconds"]}

        # phase 4e's CLI run: --quantized w8 --fused on the loaded pipeline (quantized in place by main), the
        # 1024² PNG of the run with its own load; its PNG against that run's bf16 PNG
        lp._graphs.clear()
        torch.cuda.empty_cache()
        q_args = argv(user_in, os.path.join(root, "out_w8"), 4, ("--quantized", "w8"))
        cli_cfg = infer.restore_config(infer.build_parser().parse_args(q_args))
        per = expected_restore_launches(ucfg, cli_cfg, build_step_phases(cli_cfg), lat)
        zero_counters(mods)
        t0 = time.perf_counter()
        records = infer.main(q_args, models=models)
        q_sec = time.perf_counter() - t0
        launches = read_counters(mods)
        if lp.quantized != "w8" or launches != every_counter({k: 2 * n for k, n in per.items()}):
            fail(f"phase 4e, the CLI with --quantized w8: the pipeline is {lp.quantized}, launched {launches}, "
                 f"derived 2 x {per}")
        got_w8 = np.asarray(infer.read_image(os.path.join(root, "out_w8", "a.png")))
        psnr = psnr01(torch, got_w8, got) if got_w8.shape == got.shape else -1.0
        log(f"  phase 4e, CLI --quantized w8 --fused, 1024² 4 steps: {q_sec:.3f} s from main() to its return "
            f"(quantize, warm-up, capture, replay; the image {records[0]['seconds']:.3f} s PNG read to PNG written), "
            f"launches {launches}; its PNG against the bf16 CLI's: PSNR {psnr:.2f} dB on {card_line}")
        if not (got_w8.shape == got.shape and len(np.unique(got_w8)) > 1):
            fail(f"phase 4e: the CLI with --quantized w8 wrote {got_w8.shape}, {len(np.unique(got_w8))} values")
        out["cli_w8"] = {"seconds": q_sec, "image_seconds": records[0]["seconds"], "psnr_db": psnr,
                         "launches": launches}
        lp._graphs.clear()
        del lp, encoders, models
        gc.collect()
        torch.cuda.empty_cache()
        if after_tree is not None:
            out["after_tree"] = after_tree(paths, towers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del towers
    gc.collect()
    torch.cuda.empty_cache()
    return out


def slot_step_launches(cfg, lat: int) -> dict:
    """K1 and K5 launches of one slot step by variant (``pipeline/slots.py``):
    ``previewer`` runs two UNet forwards and the Aggregator (a mode-B step),
    ``aggregator`` one of each (mode A), ``plain`` the UNet (mode C)."""
    unet, agg = forward_launches(cfg, lat)
    return {variant: {k: n_unet * unet[k] + n_agg * agg[k] for k in unet}
            for variant, (n_unet, n_agg) in {"previewer": (2, 1), "aggregator": (1, 1), "plain": (1, 0)}.items()}


def recorded_slot_launches(cfg, lat: int, variants) -> dict:
    """Launches of slot steps that run ``variants`` in turn on one state: a
    variant's first step records it (warm-up and capture: twice its
    launches), a later one replays it (none)."""
    per = slot_step_launches(cfg, lat)
    out = {"flash_attention_fwd": 0, "group_norm_silu": 0}
    for variant in dict.fromkeys(variants):
        for k in out:
            out[k] += 2 * per[variant][k]
    return out


def run_serving(torch, pipe, steps: int, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4d: serving on phase 4's bf16 models (synthetic text
    embeddings, one seeded draw per prompt). (a) ``RestoreServer`` over
    buckets 512² / 1024² at batch 2 / 1 with ``fused``: the warmup records
    one graph per bucket (launches 2x each bucket's derived counts), each
    bucket's budget row covers its measured peak increment and the pool its
    recording holds, within 1.5x of the larger, six
    concurrent requests of four sizes come back as uint8 at their sizes
    without a launch (replays), and a lone 1024² request equals ``restore``
    of its bucket pixels with a generator cloned from the server's (0).
    (d) ``InstantIRApp.set_adapter`` to a synthetic "lcm" variant and back:
    the replayed graph equals the staged restore under each adapter. (b)
    ``SlotSampler`` at 1024², one slot, on a staged ``restore``'s draws
    (relative L2 of the final latents within 1e-3), launches derived per
    variant; at 512², two slots, a request admitted three steps into
    another leaves both bitwise equal to each alone. (c)
    ``ContinuousRestoreServer`` over the same buckets with (2, 1) slots and
    ``tick_steps`` 2: five concurrent requests finish at their sizes, the
    traffic replays only. With ``steps`` other than 4, (e) config #4 through
    both servers at 1024², two requests each, in turns."""
    import threading
    import zlib

    import numpy as np

    from instantir_tpu_torch.cli.app import InstantIRApp, extract_unet_lora
    from instantir_tpu_torch.cli.infer import DEFAULT_NEG_PROMPT
    from instantir_tpu_torch.cli.serve import (ContinuousRestoreServer, RestoreServer, ServeConfig,
                                               estimate_hbm_budget, to_uint8)
    from instantir_tpu_torch.pipeline.instantir import build_step_phases
    from instantir_tpu_torch.pipeline.slots import SlotSampler

    bf16 = torch.bfloat16
    pipe._graphs.clear()  # phase 4c's recordings
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": {}}

    def encode(prompts):
        """Synthetic text embeddings: one seeded draw per prompt (phase 4c freed the towers)."""
        pe, pooled = [], []
        for p in prompts:
            g = torch.Generator(device="cuda").manual_seed(zlib.crc32(p.encode()))
            pe.append(torch.randn(77, 2048, generator=g, device="cuda") * 0.1)
            pooled.append(torch.randn(1280, generator=g, device="cuda") * 0.1)
        return torch.stack(pe).to(bf16), torch.stack(pooled).to(bf16)

    rng = torch.Generator().manual_seed(3)

    def png_pixels(w: int, h: int):
        return (torch.rand(h, w, 3, generator=rng) * 255).to(torch.uint8).numpy()

    def counted(what: str, fn, want: dict):
        """``fn()`` between counter reads (synchronized); fails on other counts."""
        zero_counters(mods)
        result = fn()
        torch.cuda.synchronize()
        launches = out["launches"][what] = read_counters(mods)
        if launches != every_counter(want):
            fail(f"phase 4d, {what}: kernel launches {launches}, derived {every_counter(want)}")
        return result

    def concurrent(server, images, what: str):
        """Submit ``images`` from one thread each; every result uint8 at its input's size."""
        results, errors = {}, []

        def client(i):
            try:
                results[i] = server.submit(images[i], prompt=f"p{i % 2}", timeout=900)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        sec = time.perf_counter() - t0
        if errors or len(results) != len(images):
            fail(f"phase 4d, {what}: {len(results)} of {len(images)} requests served, errors {errors[:2]}")
        for i, img in enumerate(images):
            got = results[i]
            if got.shape != img.shape or got.dtype != np.uint8 or np.ptp(got) == 0:
                fail(f"phase 4d, {what}: request {i} came back {got.shape} {got.dtype}, sent {img.shape}")
        return sec

    buckets, batches = (512, 1024), (2, 1)
    cfg = restore_config(4)
    phases = build_step_phases(cfg)
    per_bucket = {r: expected_restore_launches(ucfg, cfg, phases, r // 8) for r in buckets}
    base = dict(num_inference_steps=4, resolutions=buckets, batch_sizes=batches)

    # (a) the whole-request server
    server = RestoreServer(pipe, encode, ServeConfig(batch_wait_ms=100.0, **base))
    if server.restore_cfg != dataclasses.replace(cfg, fused=True):
        fail(f"phase 4d: the server's restore config {server.restore_cfg} is not config #4 at 4 steps, fused")
    counted("serve warmup", lambda: server.start(warmup=True),
            {k: 2 * sum(per_bucket[r][k] for r in buckets) for k in per_bucket[1024]})
    if len(pipe._graphs) != len(buckets) or pipe.max_graphs != len(buckets):
        fail(f"phase 4d: {len(pipe._graphs)} recorded restores held, bound {pipe.max_graphs}, buckets {buckets}")
    budget = estimate_hbm_budget(pipe, server.buckets, server._bucket_batch)
    log(f"  budget {json.dumps(budget)} on {card_line}")
    # a bucket's budget row covers what its warmup left on the card (its graph's pool) and its peak allocation
    for row, rep in zip(budget["rows"], server.warmup_report):
        mpix = rep["bucket"] ** 2 / 1e6 * rep["batch"]
        need = max(rep["peak_gb"], rep["held_gb"])
        log(f"  bucket {rep['bucket']}² batch {rep['batch']}: warmup (record and replay) {rep['seconds']:.3f} s, "
            f"peak increment {rep['peak_gb']:.3f} GB ({rep['peak_gb'] / mpix:.3f} GB per megapixel and image), held "
            f"(the graph's pool) {rep['held_gb']:.3f} GB ({rep['held_gb'] / mpix:.3f} per megapixel and image), budget "
            f"row {row['act_gb']:.3f} GB ({row['act_gb'] / need:.3f}x), reserved after {rep['reserved_gb']:.2f} GB")
        if not need <= row["act_gb"] <= 1.5 * need:
            fail(f"phase 4d: bucket {rep['bucket']}'s budget row {row['act_gb']} GB does not cover its measured "
                 f"peak increment and pool {need:.3f} GB within 1.5x")
    out["warmup"] = server.warmup_report
    sizes = [(512, 512), (480, 512), (512, 512), (1024, 1024), (1024, 768), (1024, 1024)]
    images = [png_pixels(w, h) for w, h in sizes]
    sec = counted("serve traffic", lambda: concurrent(server, images, "six concurrent requests"), {})
    log(f"  six concurrent requests {sizes} (w, h): {sec:.3f} s, no launch (graph replays); stats "
        f"{json.dumps(server.stats())}")
    lone = png_pixels(1024, 1024)
    pixels, _, _ = server._to_bucket(lone)
    gen = torch.Generator(device="cuda").set_state(server._generator.get_state())
    got = server.submit(lone, prompt="lone", timeout=900)
    pe, pooled = server._embeds(["lone"])
    npe, npooled = server._embeds([DEFAULT_NEG_PROMPT])
    want, _ = counted("direct restore", lambda: pipe.restore(
        torch.from_numpy(pixels[None]), pe, pooled, negative_prompt_embeds=npe, negative_pooled_embeds=npooled,
        cfg=server.restore_cfg, generator=gen), {})
    diff = int(np.abs(got.astype(np.int16) - to_uint8(want[0]).astype(np.int16)).max())
    log(f"  a lone 1024² request against restore of its bucket pixels with the server's generator state: max abs "
        f"difference {diff} (uint8), {len(np.unique(got))} distinct values")
    if diff != 0:
        fail(f"phase 4d: the served 1024² image differs from restore of its pixels by {diff}")

    # (d) the demo app's adapter swap, on the server's 1024² recording
    # a synthetic "lcm" variant: each LoRA-B doubled (negating A and B alike would leave B·A as it was)
    app = InstantIRApp(pipe, encode, {"lcm": {k: 2.0 * v if ".lora_B." in k else v
                                              for k, v in extract_unet_lora(pipe.unet).items()}})
    g = torch.Generator(device="cuda").manual_seed(8)
    lq = torch.rand(1, 1024, 1024, 3, generator=g, device="cuda") * 2.0 - 1.0
    noise = pipe.draw_noise(cfg, 1, 1024, 1024, g)
    pe, pooled = server._embeds(["app"])
    swapped = {}
    for adapter in ("lcm", "previewer"):
        app.set_adapter(adapter)
        kw = dict(negative_prompt_embeds=npe, negative_pooled_embeds=npooled, noise=noise, output_type="pt")
        graph = counted(f"app {adapter} replay", lambda: pipe.restore(lq, pe, pooled, cfg=server.restore_cfg, **kw)[0],
                        {})
        staged = pipe.restore(lq, pe, pooled, cfg=cfg, **kw)[0]
        diff = (graph - staged).abs().max().item()
        log(f"  InstantIRApp adapter {adapter!r}: the replayed graph against the staged restore, max abs difference "
            f"{diff:.3e}")
        if diff != 0 or not torch.isfinite(graph).all():
            fail(f"phase 4d: under adapter {adapter!r} the replayed graph differs from the staged restore by {diff}")
        swapped[adapter] = graph
    moved = (swapped["lcm"] - swapped["previewer"]).abs().max().item()
    back = all(torch.equal(p, app.lora_variants["previewer"][n]) for n, p in pipe.unet.named_parameters()
               if n in app.lora_variants["previewer"])
    log(f"  the lcm and previewer images differ by {moved:.3e} (max abs); LoRA restored exactly: {back}")
    if not (moved > 0 and back):
        fail("phase 4d: set_adapter did not reach the recorded graph, or did not restore the previewer's LoRA")
    server.stop()
    del server, app, swapped, graph, staged
    pipe._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the slot sampler: one 1024² slot on a staged restore's draws
    g = torch.Generator(device="cuda").manual_seed(21)
    lq = torch.rand(1, 1024, 1024, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe, pooled = encode(["slot"])
    npe, npooled = encode([DEFAULT_NEG_PROMPT])
    noise = pipe.draw_noise(cfg, 1, 1024, 1024, g)
    staged, _ = pipe.restore(lq, pe, pooled, negative_prompt_embeds=npe, negative_pooled_embeds=npooled, cfg=cfg,
                             noise=noise, output_type="latent")
    sampler = SlotSampler(pipe, cfg, 1024, 1)
    variants = [sampler.variant([i]) for i in range(sampler.n_steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = sampler.prelude(lq, pe, pooled, npe, npooled, noise_vae=noise.vae, noise_init=noise.init)
    torch.cuda.synchronize()
    prelude_sec = time.perf_counter() - t0
    state = sampler.insert(sampler.empty_state(payload), payload, 0)

    def run_steps():
        for draw in noise.steps:
            sampler.step(state, noise=draw.permute(0, 3, 1, 2))

    counted("slot steps 1024", run_steps, recorded_slot_launches(ucfg, 128, variants))
    rel = ((state.latents.permute(0, 2, 3, 1).float() - staged.float()).norm() / staged.float().norm()).item()
    t0 = time.perf_counter()
    image = sampler.extract_decode(state, 0)
    torch.cuda.synchronize()
    decode_sec = time.perf_counter() - t0
    sampler.insert(state, payload, 0)
    step_sec = {}
    for draw, variant in zip(noise.steps, variants):
        t0 = time.perf_counter()
        sampler.step(state, noise=draw.permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        step_sec.setdefault(variant, []).append(time.perf_counter() - t0)
    log(f"  SlotSampler 1024², one slot, variants {variants}: final latents against the staged restore's, relative "
        f"L2 {rel:.3e}; prelude {prelude_sec:.3f} s, decode {decode_sec:.3f} s, replayed steps "
        f"{json.dumps({k: [round(x, 4) for x in v] for k, v in step_sec.items()})} s on {card_line}")
    if not (rel <= 1e-3 and torch.isfinite(image).all() and tuple(image.shape) == (1, 1024, 1024, 3)):
        fail(f"phase 4d: the slot's final latents are {rel} (relative L2) from the staged restore's")
    out.update(slot_rel=rel, prelude_sec=prelude_sec, decode_sec=decode_sec, step_sec=step_sec)
    del sampler, state, payload, image, staged
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two 512² slots: a request admitted three steps into another changes neither
    sampler = SlotSampler(pipe, cfg, 512, 2)

    def payload_of(seed: int):
        cpu = torch.Generator().manual_seed(seed)
        lq = (torch.rand(1, 512, 512, 3, generator=cpu) * 2.0 - 1.0).cuda()
        return sampler.prelude(lq, pe, pooled, npe, npooled, generator=torch.Generator(device="cuda").manual_seed(seed))

    state = sampler.empty_state(payload_of(1))

    def alone():
        lat = []
        for slot, seed in ((0, 1), (1, 2)):
            sampler.insert(state, payload_of(seed), slot)
            for _ in range(sampler.n_steps):
                sampler.step(state)
            lat.append(state.latents[slot].clone())
        return lat

    # each prelude encodes its image (the fp32 VAE's K5 launches); the steps record or replay
    enc512 = vae_restore_k5(cfg, 512, 512, decode=False)
    slot512 = recorded_slot_launches(ucfg, 64, variants)
    alone_a, alone_b = counted("slot steps 512", alone, dict(slot512, group_norm_silu=slot512["group_norm_silu"]
                                                             + 2 * enc512))

    def mixed():
        sampler.insert(state, payload_of(1), 0)
        for _ in range(3):
            sampler.step(state)
        sampler.insert(state, payload_of(2), 1)
        mixed_variants = []
        for _ in range(sampler.n_steps):
            mixed_variants.append(sampler.variant(state.host_idx))
            sampler.step(state)
        return mixed_variants

    mixed_variants = counted("slot steps 512 mixed", mixed, {"group_norm_silu": 2 * enc512})
    same_a, same_b = torch.equal(state.latents[0], alone_a), torch.equal(state.latents[1], alone_b)
    log(f"  SlotSampler 512², two slots, B admitted three steps into A (variants {mixed_variants}): A bitwise equal "
        f"to A alone {same_a}, B to B alone {same_b}")
    if not (same_a and same_b):
        fail("phase 4d: a mid-flight admission changed a slot's latents")
    del sampler, state, alone_a, alone_b
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the continuous server
    cont = ContinuousRestoreServer(pipe, encode, ServeConfig(continuous=True, tick_steps=2, **base))
    # per bucket: a prelude (the VAE encode), every step variant recorded, the batch-1 decode
    warm = {k: sum(recorded_slot_launches(ucfg, r // 8, variants)[k] for r in buckets)
            for k in ("flash_attention_fwd", "group_norm_silu")}
    warm["group_norm_silu"] += sum(vae_restore_k5(cfg, r, r) for r in buckets)
    counted("serve continuous warmup", lambda: cont.start(warmup=True), warm)
    for rep in cont.warmup_report:
        log(f"  continuous bucket {rep['bucket']}² {rep['batch']} slot(s): warmup {rep['seconds']:.3f} s, peak "
            f"increment {rep['peak_gb']:.3f} GB, held {rep['held_gb']:.3f} GB, reserved after "
            f"{rep['reserved_gb']:.2f} GB")
    out["continuous_warmup"] = cont.warmup_report
    sizes = [(512, 512), (400, 512), (1024, 1024), (1024, 768), (512, 512)]
    images = [png_pixels(w, h) for w, h in sizes]
    # the steps replay; each request's prelude encodes and its decode decodes at its bucket (the smallest that
    # covers its longer side)
    traffic = sum(vae_restore_k5(cfg, *(2 * (next(b for b in buckets if b >= max(size)),))) for size in sizes)
    sec = counted("serve continuous traffic", lambda: concurrent(cont, images, "five concurrent requests"),
                  {"group_norm_silu": traffic})
    log(f"  continuous server, five concurrent requests {sizes}: {sec:.3f} s, no step launch (replays; the preludes' "
        f"and decodes' K5 {traffic}); stats "
        f"{json.dumps(cont.stats())} on {card_line}")
    cont.stop()
    del cont
    gc.collect()
    torch.cuda.empty_cache()

    # (e) config #4 through both servers at 1024², in turns
    if steps != 4:
        c4 = dict(num_inference_steps=steps, resolutions=(1024,), batch_sizes=(1,))
        servers = {"whole-request": RestoreServer(pipe, encode, ServeConfig(**c4)).start(),
                   "continuous": ContinuousRestoreServer(pipe, encode, ServeConfig(continuous=True, **c4)).start()}
        secs = {k: [] for k in servers}
        for _ in range(2):
            for name, srv in servers.items():
                t0 = time.perf_counter()
                got = srv.submit(png_pixels(1024, 1024), prompt="config 4", timeout=900)
                secs[name].append(time.perf_counter() - t0)
                if got.shape != (1024, 1024, 3):
                    fail(f"phase 4d, config #4: the {name} server returned {got.shape}")
        out["config4"] = {}
        for name, srv in servers.items():
            st = srv.stats()
            out["config4"][name] = {"request_seconds": secs[name], "batch_seconds_p50": st["batch_seconds"]["0.5"],
                                    "request_latency_p50": st["request_latency_seconds"]["0.5"],
                                    "warmup_seconds": srv.warmup_report[0]["seconds"]}
            log(f"  config #4 ({steps} steps, 1024²) through the {name} server: request seconds "
                f"{['%.3f' % x for x in secs[name]]}, batch_seconds p50 {st['batch_seconds']['0.5']:.3f} "
                f"(a tick of {srv.cfg.tick_steps} steps for the continuous one), request latency p50 "
                f"{st['request_latency_seconds']['0.5']:.3f} s (the graph alone: phase 4b's config #4 line); warmup "
                f"{srv.warmup_report[0]['seconds']:.3f} s, peak increment {srv.warmup_report[0]['peak_gb']:.3f} GB "
                f"on {card_line}")
            srv.stop()
        del servers
        pipe._graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def psnr01(torch, a, b) -> float:
    """PSNR in dB of two images in [-1, 1] (tensors or uint8 arrays in [0, 255]), on [0, 1]."""
    def unit(x):
        x = torch.as_tensor(x)
        return x.float() / 255.0 if x.dtype == torch.uint8 else (x.float().clamp(-1.0, 1.0) + 1.0) / 2.0

    mse = ((unit(a).cpu() - unit(b).cpu()) ** 2).mean().item()
    return float("inf") if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def model_bytes(models) -> int:
    """Bytes of every parameter and buffer of ``models``."""
    return sum(t.numel() * t.element_size() for m in models for t in (*m.parameters(), *m.buffers()))


def check_int8_products(torch, p88, card_line: str) -> dict:
    """The int8 products of the W8A8 pipeline's layers on the card against the
    same codes through the CPU op, the int32 before scaling, bitwise: a dense
    layer (an ``attn1.to_q`` of 1280 x 1280, 2 x 1024 tokens: CFG batch 2 at
    the 1024² restore's 32² level) and a 3x3 convolution (the first resnet's
    ``conv1``, 320 channels, batch 2 at 64², the 512² restore's level). Their
    times on the card at the 1024² restore's shapes beside the bf16 op's."""
    import torch.nn.functional as F

    from instantir_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(21)
    dense = next(m for n, m in p88.unet.named_modules()
                 if n.endswith("attn1.to_q") and m.quant_mode == "w8a8" and tuple(m.weight_q.shape) == (1280, 1280))
    conv = p88.unet.down_blocks[0].resnets[0].conv1
    if conv.quant_mode != "w8a8" or tuple(conv.weight_q.shape) != (320, 320, 3, 3):
        fail(f"phase 4e: down_blocks.0.resnets.0.conv1 is {conv.quant_mode}, not a W8A8 320-channel 3x3 convolution")
    a = torch.randint(-127, 128, (2 * 1024, 1280), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (2, 320, 64, 64), generator=g).to(torch.bfloat16)
    cases = {"dense 2048x1280 @ 1280x1280": (quant.int_mm(a.cuda(), dense.weight_q).cpu(),
                                              quant.int_mm(a, dense.weight_q.cpu())),
             "3x3 conv 320->320 at 2x64x64": (quant.conv_int32(codes.cuda(), conv.weight_q, 1, 1).cpu(),
                                              quant.conv_int32(codes, conv.weight_q.cpu(), 1, 1))}
    for what, (got, want) in cases.items():
        if got.dtype != torch.int32 or not torch.equal(got, want):
            fail(f"phase 4e: the int8 product ({what}) on the card differs from the CPU's: "
                 f"{(got.long() - want.long()).abs().max().item()} at most")
    log(f"  int8 products on the card equal the CPU op's int32, bitwise: {list(cases)}")
    x = torch.randn(2, 4096, 1280, device="cuda").to(torch.bfloat16)  # 1024²: the 64² level, S = 4096
    xc = torch.randn(2, 320, 128, 128, device="cuda").to(torch.bfloat16)
    wd, wc = dense.weight_q.float().to(torch.bfloat16), conv.weight_q.float().to(torch.bfloat16)
    ms = {"dense w8a8": time_ms(torch, lambda: quant.w8a8_dense(x, dense.weight_q, dense.weight_scale)),
          "dense bf16": time_ms(torch, lambda: F.linear(x, wd)),
          "conv w8a8": time_ms(torch, lambda: quant.w8a8_conv(xc, conv.weight_q, conv.weight_scale, 1, 1)),
          "conv int32 product": time_ms(torch, lambda: quant.conv_int32(xc, conv.weight_q, 1, 1)),
          "conv bf16": time_ms(torch, lambda: F.conv2d(xc, wc, padding=1))}
    log(f"  ms per call, dense 2x4096x1280 @ 1280x1280 and 3x3 conv 320->320 at 2x128x128: "
        f"{json.dumps({k: round(v, 4) for k, v in ms.items()})} on {card_line}")
    return ms


def run_quantized(torch, pipe, steps: int, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4e: the quantized restore on phase 4's bf16 models at 1024², 4
    steps. A copy of the UNet and the Aggregator quantized in W8 and one in
    W8A8 (``InstantIRPipeline.quantize``): the weight bytes before and after,
    and ``memory_allocated`` falling by at least 40% of the quantized weights'
    bf16 bytes; the int8 products on the card against the CPU op
    (``check_int8_products``); each pipeline's restore staged and as one CUDA
    graph on the bf16 restore's noise (the graph equal to the staged
    restore), images finite, their PSNR against the bf16 image (W8 no
    further from it than W8A8), s/image of bf16, W8 and W8A8 in one pass
    (staged and replayed), peaks, launch counts derived from the config (the same as
    bf16's: quantization touches neither attention nor GroupNorm);
    ``RestoreServer`` on the W8 pipeline at 1024² (its budget row against
    bf16's, one request replayed without a launch). With ``steps`` other
    than 4, config #4 as graphs in W8 and W8A8, each recorded and replayed
    once, against a bf16 staged restore on the same noise."""
    import numpy as np

    from instantir_tpu_torch.cli.serve import RestoreServer, ServeConfig, estimate_hbm_budget
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreNoise, build_step_phases

    bf16 = torch.bfloat16
    pipe._graphs.clear()  # phase 4d's recordings
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": {}}
    g = torch.Generator(device="cuda").manual_seed(17)
    res, lat = 1024, 1024 // 8
    base = restore_config(4)
    fused_cfg = dataclasses.replace(base, fused=True)
    expected = expected_restore_launches(ucfg, base, build_step_phases(base), lat)

    def inputs(n_steps: int):
        lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
        pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(bf16)
        pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(bf16)
        shape = (1, lat, lat, 4)
        noise = RestoreNoise(*(torch.randn(shape, generator=g, device="cuda") for _ in range(2)),
                             [torch.randn(shape, generator=g, device="cuda") for _ in range(n_steps)])
        return lq, pe, pooled, noise

    def restore(what: str, p, cfg, args, want: dict):
        """One restore between counter reads: (image, seconds, peak GB, peak GB over what was allocated before)."""
        lq, pe, pooled, noise = args
        zero_counters(mods)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        image, _ = p.restore(lq, pe, pooled, cfg=cfg, noise=noise, output_type="pt")
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = out["launches"][what] = read_counters(mods)
        if launches != every_counter(want):
            fail(f"phase 4e, {what}: kernel launches {launches}, derived {every_counter(want)}")
        if tuple(image.shape) != (1, res, res, 3) or not torch.isfinite(image).all():
            fail(f"phase 4e, {what}: the image is not finite RGB of shape (1, {res}, {res}, 3)")
        peak = torch.cuda.max_memory_allocated()
        return image, sec, peak / 1e9, (peak - before) / 1e9

    # 1. the two quantized copies: bytes and memory
    pipes, weights = {"bf16": pipe}, {}
    weights["bf16"] = model_bytes([pipe.unet, pipe.aggregator])
    for mode in ("w8", "w8a8"):
        p = InstantIRPipeline(copy.deepcopy(pipe.unet), copy.deepcopy(pipe.aggregator), pipe.vae, pipe.resampler,
                              pipe.image_encoder, pipe.schedule, device="cuda")
        gc.collect()
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        t0 = time.time()
        p.quantize(weight_only=mode == "w8")
        torch.cuda.synchronize()
        q_sec = time.time() - t0
        gc.collect()
        drop = alloc0 - torch.cuda.memory_allocated()
        n_q = sum(quant.quantized_bytes(m)[0] for m in (p.unet, p.aggregator))
        weights[mode] = model_bytes([p.unet, p.aggregator])
        if p.quantized != mode:
            fail(f"phase 4e: the pipeline quantized as {mode} reports {p.quantized}")
        log(f"  {mode}: quantized in {q_sec:.2f} s: {n_q / 1e9:.3f} B weight values int8 (their bf16 bytes "
            f"{2 * n_q / 1e9:.3f} GB); UNet + Aggregator bytes {weights['bf16'] / 1e9:.3f} -> {weights[mode] / 1e9:.3f} "
            f"GB; memory_allocated fell by {drop / 1e9:.3f} GB ({drop / (2 * n_q):.1%} of the quantized weights' bf16 "
            f"bytes)")
        if not drop >= 0.4 * 2 * n_q:
            fail(f"phase 4e: quantize ({mode}) freed {drop / 1e9:.3f} GB, less than 40% of the quantized weights' bf16 "
                 f"bytes {2 * n_q / 1e9:.3f} GB")
        pipes[mode] = p
        out[f"quantize_{mode}"] = {"seconds": q_sec, "values": n_q, "freed_gb": drop / 1e9}
    out["weight_gb"] = {k: v / 1e9 for k, v in weights.items()}
    out["int8_ms"] = check_int8_products(torch, pipes["w8a8"], card_line)

    # 2. staged and recorded restores on one noise; PSNR against bf16; s/image in one pass
    args = inputs(4)
    images, peaks = {}, {}
    for mode, p in pipes.items():
        images[mode], _, peaks[mode], act = restore(f"{mode} staged restore", p, base, args, expected)
        torch.cuda.empty_cache()
        graph_img, rec_sec, rec_peak, _ = restore(f"{mode} graph recording", p, fused_cfg, args,
                                                  {k: 2 * n for k, n in expected.items()})
        diff = (graph_img.float() - images[mode].float()).abs().max().item()
        scale = max(1.0, images[mode].float().abs().max().item())
        log(f"  {mode}: staged peak {peaks[mode]:.2f} GB ({act:.2f} over what was allocated before), recording "
            f"{rec_sec:.3f} s, peak {rec_peak:.2f} GB; graph vs staged image max abs difference {diff:.3e}")
        if not diff <= 1e-3 * scale:
            fail(f"phase 4e, {mode}: the replayed image differs from the staged one by {diff} > 1e-3 x {scale}")
    psnr = {mode: psnr01(torch, images[mode], images["bf16"]) for mode in ("w8", "w8a8")}
    log(f"  PSNR against the bf16 image on [0, 1]: W8 {psnr['w8']:.2f} dB, W8A8 {psnr['w8a8']:.2f} dB")
    if not psnr["w8"] >= psnr["w8a8"]:
        fail(f"phase 4e: the W8 image is further from bf16 ({psnr['w8']:.2f} dB) than the W8A8 one "
             f"({psnr['w8a8']:.2f} dB)")
    secs = {}
    for mode in ("bf16", "w8", "w8a8"):
        for kind in ("staged", "graph"):
            _, sec, _, _ = restore(f"{mode} {kind} restore", pipes[mode], base if kind == "staged" else fused_cfg,
                                   args, expected if kind == "staged" else {})
            secs.setdefault(f"{mode}_{kind}", []).append(sec)
    log(f"  1024² 4 steps, s/image in one pass: "
        f"{json.dumps({k: ['%.3f' % x for x in v] for k, v in secs.items()})} on {card_line}")
    out.update(psnr=psnr, peak_gb=peaks, sec={k: min(v) for k, v in secs.items()})

    # 3. RestoreServer on the W8 pipeline: its budget row against bf16's, one request replayed without a launch
    for p in pipes.values():
        p._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    def encode(prompts):
        pe = torch.stack([(torch.randn(77, 2048, generator=g, device="cuda") * 0.1) for _ in prompts]).to(bf16)
        return pe, torch.stack([(torch.randn(1280, generator=g, device="cuda") * 0.1) for _ in prompts]).to(bf16)

    server = RestoreServer(pipes["w8"], encode, ServeConfig(num_inference_steps=4, resolutions=(res,),
                                                            batch_sizes=(1,)))
    zero_counters(mods)
    server.start(warmup=True)
    launches = out["launches"]["w8 serve warmup"] = read_counters(mods)
    if launches != every_counter({k: 2 * n for k, n in expected.items()}):
        fail(f"phase 4e: the W8 server's warmup launched {launches}, derived 2 x {expected}")
    budget = {mode: estimate_hbm_budget(pipes[mode], server.buckets, server._bucket_batch) for mode in ("bf16", "w8")}
    rep = server.warmup_report[0]
    lone = (torch.rand(res, res, 3, generator=torch.Generator().manual_seed(4)) * 255).to(torch.uint8).numpy()
    zero_counters(mods)
    t0 = time.time()
    got = server.submit(lone, prompt="lone", timeout=900)
    sec = time.time() - t0
    launches = out["launches"]["w8 serve request"] = read_counters(mods)
    server.stop()
    log(f"  W8 RestoreServer 1024² batch 1: warmup {rep['seconds']:.3f} s, peak increment {rep['peak_gb']:.3f} GB, "
        f"held {rep['held_gb']:.3f} GB; budget params {budget['bf16']['params_gb']} -> {budget['w8']['params_gb']} GB, "
        f"total {budget['bf16']['total_gb']} -> {budget['w8']['total_gb']} GB; one request {sec:.3f} s, launches "
        f"{launches}")
    if launches != every_counter({}) or got.shape != lone.shape or got.dtype != np.uint8:
        fail(f"phase 4e: the W8 server's request launched {launches} or came back {got.shape} {got.dtype}")
    freed = (weights["bf16"] - weights["w8"]) / 1e9
    if not budget["w8"]["params_gb"] <= budget["bf16"]["params_gb"] - 0.9 * freed:
        fail(f"phase 4e: the W8 budget's params {budget['w8']['params_gb']} GB did not shrink by the {freed:.3f} GB "
             "the quantization freed")
    out["serve_w8"] = {"budget": budget, "warmup": rep, "request_sec": sec}
    pipes["w8"]._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # 4. config #4 as graphs in W8 and W8A8 (bf16's graph: phase 4b's config #4 line, this call), each recorded
    # and replayed once, its image against the bf16 staged restore's on the same noise (a bf16 graph replays
    # the staged image exactly, phase 4b)
    if steps != 4:
        c4 = restore_config(steps)
        c4_graph = dataclasses.replace(c4, fused=True)
        c4_expected = expected_restore_launches(ucfg, c4, build_step_phases(c4), lat)
        c4_args = inputs(steps)
        bf16_img, bf16_sec, _, _ = restore(f"bf16 {steps}-step staged restore", pipe, c4, c4_args, c4_expected)
        c4_secs, c4_psnr = {}, {}
        for mode in ("w8", "w8a8"):
            p = pipes[mode]
            img, rec_sec, rec_peak, _ = restore(f"{mode} {steps}-step graph recording", p, c4_graph, c4_args,
                                                {k: 2 * n for k, n in c4_expected.items()})
            _, c4_secs[mode], _, _ = restore(f"{mode} {steps}-step graph replay", p, c4_graph, c4_args, {})
            c4_psnr[mode] = psnr01(torch, img, bf16_img)
            p._graphs.clear()
            torch.cuda.empty_cache()
            log(f"  config #4, {steps} steps, {mode}: recording {rec_sec:.3f} s, peak {rec_peak:.2f} GB; a replay "
                f"{c4_secs[mode]:.3f} s/image; PSNR against the bf16 image {c4_psnr[mode]:.2f} dB (bf16 staged "
                f"{bf16_sec:.3f} s) on {card_line}")
        out["config4"] = {"sec": c4_secs, "psnr": c4_psnr}
    for p in pipes.values():
        p._graphs.clear()
    del pipes, images
    gc.collect()
    torch.cuda.empty_cache()
    return out


def variant_aggregator(torch, pipe, ucfg, g, **variant):
    """An Aggregator built with ``variant`` (``pad_concat``, ``attn1_mode``,
    ...) on the card in bf16, holding phase 4's Aggregator weights; the
    leaves those lack (sep_split's ``ln_k_ref`` / ``ln_v_ref``) drawn from
    ``g`` (weights N(0, 1/fan_in), biases N(0, 0.01)) so that they act."""
    from instantir_tpu_torch.models.aggregator import Aggregator

    agg = Aggregator(ucfg, dtype=torch.bfloat16, device="meta", **variant)
    agg.to_empty(device="cuda")
    own = pipe.aggregator.state_dict()
    with torch.no_grad():
        for name, p in agg.named_parameters():
            if name in own:
                p.copy_(own[name])
            else:
                std = p.shape[-1] ** -0.5 if p.dim() >= 2 else 0.1
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * std)
    return agg.requires_grad_(False).eval()


def set_plain(model, group_norm, plain: bool) -> None:
    """Route every attention of ``model`` to the plain path (``use_flash``
    off) and the GroupNorms to the plain version, or both back."""
    from instantir_tpu_torch.models.attention import Attention, SplitAttention

    for m in model.modules():
        if isinstance(m, (Attention, SplitAttention)):
            m.use_flash = not plain
    group_norm.USE_FUSED = not plain


def rel_l2(torch, got, want) -> float:
    """Relative L2 of two tensors, or of two sequences of tensors taken as one vector."""
    if isinstance(got, (tuple, list)):
        got = torch.cat([t.float().reshape(-1) for t in got])
        want = torch.cat([t.float().reshape(-1) for t in want])
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def run_variants(torch, pipe, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4f: the model variants at SDXL width on phase 4's bf16 models,
    1024², batch 2 (as under CFG). Every launch count is derived from the
    config, every kernel path held against the plain path.

    1. The Aggregator with ``pad_concat`` off and on x ``attn1_mode``
       ``plain`` / ``split`` / ``sep_split`` (``variant_flash_calls``; the
       K5 count is the plain Aggregator's); ``split`` without a pad equals
       ``plain``; ``global_pool_conditions`` is the mean of the unpooled
       residuals.
    2. A ``residual_fusion="zero_sft"`` UNet (phase 4's weights, its ZeroSFT
       leaves drawn so the branch acts) fed the plain Aggregator's
       residuals: a forward, and a forward and backward of a scalar loss with
       respect to the residuals (gradient checkpointing on), each against the
       plain path; s/forward, s/step and peaks against the ``add`` UNet in
       turns.
    3. ``Attention`` with ``external_kv`` in each mode at the UNet's /16
       shape, fed a ``KVCopy`` cache of a second image whole and thinned by
       ``drop_kvs(0.5)``."""
    from instantir_tpu_torch.models.attention import Attention
    from instantir_tpu_torch.models.kv_cache import AttentionCache, KVCopy, drop_kvs, init_kv_copy
    from instantir_tpu_torch.models.unet import UNet2DConditionModel
    from instantir_tpu_torch.models.zero_sft import ZeroSFT
    from instantir_tpu_torch.pipeline.factory import synthesize_weights

    group_norm = mods["group_norm"]
    if not group_norm.USE_FUSED:
        fail("phase 4f derives its counts with the fused GroupNorm on")
    pipe._graphs.clear()  # phase 4e's recordings
    gc.collect()
    torch.cuda.empty_cache()
    res, b = 1024, 2
    lat = res // 8
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(31)
    sample = torch.randn(b, 4, lat, lat, generator=g, device="cuda").to(bf16)
    preview = torch.randn(b, 4, lat, lat, generator=g, device="cuda").to(bf16)
    t = torch.tensor([501, 501], device="cuda")
    pooled_dim = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    pooled = (torch.randn(b, pooled_dim, generator=g, device="cuda") * 0.1).to(bf16)
    tids = torch.tensor([[res, res, 0, 0, res, res]] * b, dtype=bf16, device="cuda")
    gn_agg = group_norms_per_forward(ucfg, with_up=False)["total"]
    if (aggregator_group_norm_shapes(ucfg, lat, False) != group_norm_shapes_per_forward(ucfg, lat, lat, False, 2)
            or {s: n for (s, _), n in variant_flash_calls(ucfg, lat, False, "plain").items()}
            != flash_calls_per_forward(ucfg, lat, lat, with_up=False, concat=2)
            or sum(aggregator_group_norm_shapes(ucfg, lat, True).values()) != gn_agg):
        fail("phase 4f: the variant derivations disagree with phase 4's for the plain Aggregator")
    out = {"launches": {name: 0 for name in COUNTERS}, "aggregator": {}}

    def counted(what: str, fn, want: dict):
        zero_counters(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = read_counters(mods)
        if launches != every_counter(want):
            fail(f"phase 4f, {what}: kernel launches {launches}, derived {every_counter(want)}")
        for name, n in launches.items():
            out["launches"][name] += n
        return result, sec, torch.cuda.max_memory_allocated() / 1e9

    def plain_run(model, fn):
        set_plain(model, group_norm, True)
        try:
            zero_counters(mods)
            result = fn()
            if any(read_counters(mods).values()):
                fail(f"phase 4f: the plain path launched {read_counters(mods)}")
            return result
        finally:
            set_plain(model, group_norm, False)

    # 1. the Aggregator in six settings
    kept = {}
    for pad in (False, True):
        for mode in ("plain", "split", "sep_split"):
            what = f"Aggregator pad_concat={pad} attn1_mode={mode}"
            agg = variant_aggregator(torch, pipe, ucfg, g, pad_concat=pad, attn1_mode=mode)
            calls = variant_flash_calls(ucfg, lat, pad, mode)
            want = {"flash_attention_fwd": sum(calls.values()), "group_norm_silu": gn_agg}

            def fwd():
                with torch.no_grad():
                    down, mid = agg(sample, t, preview, pooled, tids, ref_scale=0.5)
                return list(down) + [mid]

            counted(f"{what}, first call", fwd, want)
            got, _, peak = counted(what, fwd, want)
            sec = time_ms(torch, fwd, iters=3, warmup=0) / 1e3
            ref = plain_run(agg, fwd)
            rel = rel_l2(torch, got, ref)
            shapes = [tuple(r.shape) for r in got]
            if kept and shapes != kept["plain"]["shapes"]:
                fail(f"phase 4f, {what}: residual shapes {shapes} differ from the plain Aggregator's")
            if not (all(torch.isfinite(r).all() for r in got) and rel <= FORWARD_TOL):
                fail(f"phase 4f, {what}: the residuals are not finite or {rel} (relative L2) from the plain path "
                     f"(> {FORWARD_TOL})")
            row = {"launches_by_shape": {f"{sq}x{skv}": n for (sq, skv), n in calls.items()}, "rel_l2": rel,
                   "sec": sec, "peak_gb": peak}
            if not pad and mode == "split":
                same = rel_l2(torch, got, kept["plain"]["out"])
                diff = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, kept["plain"]["out"]))
                row["vs_plain"] = same
                log(f"  split without a pad against plain: relative L2 {same:.3e}, max abs difference {diff:.3e}")
                if not same <= 1e-6:
                    fail(f"phase 4f: split without a pad row differs from plain by {same} (relative L2)")
            if not pad and mode == "plain":
                kept["plain"] = {"out": got, "shapes": shapes}
                agg.global_pool_conditions = True
                pooled_out, _, _ = counted("Aggregator global_pool_conditions", fwd, want)
                agg.global_pool_conditions = False
                if not all(torch.equal(p, r.mean(dim=(2, 3), keepdim=True)) for p, r in zip(pooled_out, got)):
                    fail("phase 4f: global_pool_conditions is not the mean of the unpooled residuals")
                log("  global_pool_conditions: every residual the mean of its unpooled map over H and W "
                    f"({[tuple(p.shape) for p in pooled_out][:2]} ...)")
            log(f"  {what}: K1 by (Sq, Skv) {row['launches_by_shape']}, K5 {gn_agg}; relative L2 against the plain "
                f"path {rel:.3e}; {sec * 1e3:.1f} ms per forward, peak {peak:.2f} GB; on {card_line}")
            out["aggregator"][f"{'pad_' if pad else ''}{mode}"] = row
            del agg, got, ref
            gc.collect()
            torch.cuda.empty_cache()

    # 2. a zero_sft UNet fed the plain Aggregator's residuals
    residuals = kept.pop("plain")["out"]
    down_res, mid_res = residuals[:-1], residuals[-1]
    zcfg = dataclasses.replace(ucfg, residual_fusion="zero_sft")
    zunet = UNet2DConditionModel(zcfg, dtype=bf16, device="meta")
    zunet.to_empty(device="cuda")
    own = pipe.unet.state_dict()
    with torch.no_grad():
        for name, p in zunet.named_parameters():
            if name in own:
                p.copy_(own[name])
    for m in zunet.modules():
        if isinstance(m, ZeroSFT):
            synthesize_weights(m, g)
    zunet.requires_grad_(False).eval()
    n_zero = sum(p.numel() for n, p in zunet.named_parameters() if n not in own)
    text = (torch.randn(b, 77, ucfg.cross_attention_dim, generator=g, device="cuda") * 0.1).to(bf16)
    ip = torch.randn(b, 64, ucfg.cross_attention_dim, generator=g, device="cuda").to(bf16)
    weight = torch.randn(b, 4, lat, lat, generator=g, device="cuda")
    unet_calls = flash_calls_per_forward(ucfg, lat, lat, with_up=True)
    down_mid = sum(flash_calls_per_forward(ucfg, lat, lat, with_up=False).values())
    up_calls = sum(unet_calls.values()) - down_mid
    gn_unet = group_norms_per_forward(ucfg)["total"]
    zero_gn = zero_sft_group_norms(ucfg, lat)
    n_zero_gn = sum(zero_gn.values())
    n_up_zero = n_zero_gn - 1  # all but mid_zero_sft lie inside the up blocks
    fwd_want = {"flash_attention_fwd": sum(unet_calls.values()), "group_norm_silu": gn_unet + n_zero_gn}
    add_fwd_want = {"flash_attention_fwd": sum(unet_calls.values()), "group_norm_silu": gn_unet}
    # the backward: down and mid blocks see no gradient (K1, not recomputed); the up blocks take the residuals,
    # so each of their attentions runs K2 twice (checkpointing recomputes it) and K3 / K4 once, and their K5
    # (ZeroSFT's included) runs again in the recomputation
    step_want = {"flash_attention_fwd": down_mid, "flash_attention_fwd_lse": 2 * up_calls,
                 "flash_attention_bwd_dq": up_calls, "flash_attention_bwd_dkv": up_calls,
                 "group_norm_silu": gn_unet + n_zero_gn + up_group_norms(ucfg) + n_up_zero}
    add_step_want = dict(step_want, group_norm_silu=gn_unet + up_group_norms(ucfg))
    log(f"  zero_sft UNet: {n_zero / 1e6:.2f} M ZeroSFT parameters (drawn) beside phase 4's UNet weights; its ZeroSFT "
        f"GroupNorms by (C, H, W) {zero_gn}; derived forward {fwd_want}, forward and backward {step_want}")

    def unet_fwd(model):
        def fn():
            with torch.no_grad():
                return model(sample, t, text, pooled, tids, ip_hidden_states=ip,
                             down_block_additional_residuals=down_res, mid_block_additional_residual=mid_res)
        return fn

    def unet_step(model):
        def fn():
            leaves = [r.detach().requires_grad_() for r in residuals]
            model.gradient_checkpointing = True
            try:
                o = model(sample, t, text, pooled, tids, ip_hidden_states=ip,
                          down_block_additional_residuals=leaves[:-1], mid_block_additional_residual=leaves[-1])
                loss = (o.float() * weight).mean()
                grads = torch.autograd.grad(loss, leaves)
            finally:
                model.gradient_checkpointing = False
            return loss.detach(), grads
        return fn

    zout, _, _ = counted("zero_sft UNet forward", unet_fwd(zunet), fwd_want)
    zref = plain_run(zunet, unet_fwd(zunet))
    rel_fwd = rel_l2(torch, zout, zref)
    (loss, zgrads), _, _ = counted("zero_sft UNet forward and backward", unet_step(zunet), step_want)
    _, ref_grads = plain_run(zunet, unet_step(zunet))
    rel_grad = rel_l2(torch, zgrads, ref_grads)
    per_res = [rel_l2(torch, a, r) for a, r in zip(zgrads, ref_grads)]
    if not (torch.isfinite(zout).all() and rel_fwd <= FORWARD_TOL):
        fail(f"phase 4f: the zero_sft UNet's output is not finite or {rel_fwd} from the plain path (> {FORWARD_TOL})")
    if not (all(torch.isfinite(x).all() and x.abs().max() > 0 for x in zgrads) and rel_grad <= VARIANT_GRAD_TOL):
        fail(f"phase 4f: the zero_sft UNet's residual gradients are zero, not finite or {rel_grad} from the plain "
             f"path (> {VARIANT_GRAD_TOL})")
    log(f"  zero_sft UNet at {res}² batch {b}: output {tuple(zout.shape)}, relative L2 against the plain path "
        f"{rel_fwd:.3e}; gradients of the 10 residuals {rel_grad:.3e} (worst residual {max(per_res):.3e}); loss "
        f"{float(loss):.5g}")
    del zout, zref, zgrads, ref_grads
    # in turns, each turn's launches checked on one call, its time the median of three runs of three calls
    # (forward) or of one call (forward and backward) between CUDA events
    timing = {"fwd": {"add": [], "zero_sft": []}, "step": {"add": [], "zero_sft": []},
              "peak_gb": {"add": [], "zero_sft": []}}
    for kind in ("add", "zero_sft", "zero_sft", "add"):
        model = pipe.unet if kind == "add" else zunet
        counted(f"{kind} UNet forward", unet_fwd(model), fwd_want if kind == "zero_sft" else add_fwd_want)
        timing["fwd"][kind].append(time_ms(torch, unet_fwd(model), iters=3, warmup=0) / 1e3)
        _, _, peak = counted(f"{kind} UNet step", unet_step(model), step_want if kind == "zero_sft" else add_step_want)
        timing["step"][kind].append(time_ms(torch, unet_step(model), iters=1, warmup=0) / 1e3)
        timing["peak_gb"][kind].append(peak)
    out["zero_sft"] = {"rel_l2_fwd": rel_fwd, "rel_l2_grad": rel_grad, "timing": timing}
    log(f"  zero_sft vs add UNet at {res}² batch {b} in turns (add, zero_sft, zero_sft, add; CUDA events): s/forward "
        f"{json.dumps({k: [round(x, 4) for x in v] for k, v in timing['fwd'].items()})}, s/(forward + backward of "
        f"the residuals, checkpointing) {json.dumps({k: [round(x, 4) for x in v] for k, v in timing['step'].items()})}"
        f", peak {json.dumps({k: [round(x, 2) for x in v] for k, v in timing['peak_gb'].items()})} GB; on {card_line}")
    del zunet, residuals, down_res, mid_res
    gc.collect()
    torch.cuda.empty_cache()

    # 3. external K/V at the UNet's /16 shape: a KVCopy cache of a second image, whole and thinned
    src = pipe.unet.down_blocks[1].attentions[0].transformer_blocks[0].attn1
    dim, heads = ucfg.block_out_channels[1], ucfg.num_attention_heads[1]
    kv = KVCopy(dim, dtype=bf16, device="cuda").requires_grad_(False)
    init_kv_copy(kv, src)
    second = torch.randn(b, (lat // 2) ** 2, dim, generator=g, device="cuda").to(bf16)
    x = torch.randn(b, (lat // 2) ** 2, dim, generator=g, device="cuda").to(bf16)
    temb = torch.randn(b, ucfg.time_embed_dim, generator=g, device="cuda").to(bf16)
    with torch.no_grad():
        cache = kv(second)
        thinned = drop_kvs({"attn1": AttentionCache(cache, cache)}, 0.5,
                           generator=torch.Generator(device="cuda").manual_seed(3))["attn1"].self_attention
    if thinned.k.shape[1] != round(cache.k.shape[1] * 0.5):
        fail(f"phase 4f: drop_kvs(0.5) kept {thinned.k.shape[1]} of {cache.k.shape[1]} tokens")
    out["external_kv"] = {}
    for mode in ("concat", "additive", "ta_additive"):
        attn = Attention(dim, heads, dim // heads, external_kv_mode=mode, temb_dim=ucfg.time_embed_dim, dtype=bf16,
                         device="cuda")
        missing = attn.load_state_dict(src.state_dict(), strict=False).missing_keys
        with torch.no_grad():
            for name in missing:
                p = attn.get_parameter(name)
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * (p.shape[-1] ** -0.5 if p.dim() >= 2 else 0.1))
        attn.requires_grad_(False)
        for which, ext in (("whole", cache), ("thinned", thinned)):
            n_kv = ext.k.shape[1]
            shapes = [(x.shape[1], x.shape[1] + n_kv)] if mode == "concat" else [(x.shape[1], x.shape[1]),
                                                                                 (x.shape[1], n_kv)]

            def fn():
                with torch.no_grad():
                    return attn(x, temb=temb, external_kv=ext)

            got, sec, _ = counted(f"external_kv {mode} {which}", fn, {"flash_attention_fwd": len(shapes)})
            ref = plain_run(attn, fn)
            rel = rel_l2(torch, got, ref)
            if not (torch.isfinite(got).all() and rel <= FORWARD_TOL):
                fail(f"phase 4f: external_kv {mode} ({which}) is not finite or {rel} from the plain path")
            out["external_kv"][f"{mode}_{which}"] = {"shapes": shapes, "rel_l2": rel}
            log(f"  Attention external_kv={mode}, cache {which} ({n_kv} tokens): K1 at (Sq, Skv) {shapes}, relative "
                f"L2 against the plain path {rel:.3e}")
        del attn
    log(f"  phase 4f launches {out['launches']}; on {card_line}")
    return out


def run_clip_encoder(torch, pipe, paths: dict, towers, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4g: the restore with a CLIP image-prompt encoder (``--use_clip_encoder``)
    on phase 4's UNet, Aggregator and VAE: a synthetic ViT-B/16
    ``CLIPImageEncoder`` in bf16 (the penultimate layer's 197 tokens, the
    plain attention) and a Resampler at ``embedding_dim`` 768. 1024², 4
    steps, staged and as one CUDA graph on the same noise (the launches those
    of phase 4's restore, the graph's image within 1e-3 of its scale of the
    staged one; s/image in turns); the encoder's ms per call. Then the whole
    tower written as an HF folder (``config.json``, ``model.safetensors``)
    and an InstantIR folder for the 768-wide Resampler beside phase 4c's
    tree, and ``cli.infer.main --use_clip_encoder --fused`` with its own load
    on one 1024² PNG: its launches derived as in phase 4c, its PNG equal to
    the in-memory restore of the same pixels."""
    import numpy as np

    from instantir_tpu_torch import convert
    from instantir_tpu_torch.cli import infer
    from instantir_tpu_torch.models.clip_vision import CLIPImageEncoder, CLIPVisionModel, clip_vit_b16_config
    from instantir_tpu_torch.models.resampler import Resampler, instantir_resampler_config
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreNoise, build_step_phases
    from instantir_tpu_torch.utils.tokenizer import CLIPTokenizer

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(13)
    ccfg = clip_vit_b16_config()
    tower = synthesize_weights(CLIPVisionModel(ccfg, dtype=bf16, device="cuda").requires_grad_(False).eval(), g)
    tower_sd = {k: v.detach().cpu() for k, v in tower.state_dict().items()}
    del tower
    enc = CLIPImageEncoder(ccfg, dtype=bf16, device="cuda").requires_grad_(False).eval()
    enc.load_state_dict(convert.import_clip_vision(tower_sd, [n for n, _ in enc.named_parameters()]), strict=True)
    rcfg = instantir_resampler_config(lora_rank=ucfg.lora_rank, embedding_dim=ccfg.hidden_size)
    resampler = synthesize_weights(Resampler(rcfg, dtype=bf16, device="cuda").requires_grad_(False).eval(), g)
    cpipe = InstantIRPipeline(pipe.unet, pipe.aggregator, pipe.vae, resampler, enc, pipe.schedule, device="cuda")
    log(f"  CLIP ViT-B/16 image encoder: {sum(p.numel() for p in enc.parameters()) / 1e6:.1f} M parameters "
        f"({ccfg.num_layers - 1} of {ccfg.num_layers} layers), Resampler at embedding_dim {rcfg.embedding_dim}")

    pixels = torch.randn(1, 3, ccfg.image_size, ccfg.image_size, generator=g, device="cuda").to(bf16)
    with torch.no_grad():
        tokens = enc(pixels)
        enc_ms = time_ms(torch, lambda: enc(pixels))
    if tuple(tokens.shape) != (1, 197, 768) or not torch.isfinite(tokens).all():
        fail(f"phase 4g: the CLIP encoder's tokens are not finite of shape (1, 197, 768): {tuple(tokens.shape)}")

    res, lat = 1024, 1024 // 8
    base = restore_config(4)
    fused_cfg = dataclasses.replace(base, fused=True)
    expected = expected_restore_launches(ucfg, base, build_step_phases(base), lat)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(bf16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(bf16)
    shape = (1, lat, lat, 4)
    noise = RestoreNoise(*(torch.randn(shape, generator=g, device="cuda") for _ in range(2)),
                         [torch.randn(shape, generator=g, device="cuda") for _ in range(4)])
    out = {"launches": {}}

    def restore(what: str, cfg, want: dict):
        zero_counters(mods)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        image, _ = cpipe.restore(lq, pe, pooled, cfg=cfg, noise=noise, output_type="pt")
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = out["launches"][what] = read_counters(mods)
        if launches != every_counter(want):
            fail(f"phase 4g, {what}: kernel launches {launches} differ from the counts derived from the config "
                 f"{every_counter(want)}")
        if tuple(image.shape) != (1, res, res, 3) or not torch.isfinite(image).all():
            fail(f"phase 4g, {what}: the image is not finite RGB of shape (1, {res}, {res}, 3)")
        return image, sec, torch.cuda.max_memory_allocated() / 1e9

    staged_img, _, staged_peak = restore("staged restore", base, expected)
    graph_img, record_sec, _ = restore("graph recording", fused_cfg, {k: 2 * n for k, n in expected.items()})
    secs = {"staged": [], "graph": []}
    for kind in ("staged", "graph", "graph", "staged"):
        img, sec, _ = restore(f"{kind} turn", base if kind == "staged" else fused_cfg,
                              expected if kind == "staged" else {})
        secs[kind].append(sec)
        if kind == "graph":
            graph_img = img
    diff = (graph_img.float() - staged_img.float()).abs().max().item()
    scale = max(1.0, staged_img.float().abs().max().item())
    log(f"  CLIP-encoder restore 1024² 4 steps: staged {['%.3f' % x for x in secs['staged']]} s/image, one CUDA graph "
        f"{['%.3f' % x for x in secs['graph']]} (recording {record_sec:.3f} s); peak {staged_peak:.2f} GB; graph vs "
        f"staged image max abs difference {diff:.3e} (scale {scale:.3f}); encoder {enc_ms:.3f} ms per call at 224² "
        f"batch 1; launches per restore {every_counter(expected)} on {card_line}")
    if not diff <= 1e-3 * scale:
        fail(f"phase 4g: the graph-replayed image differs from the staged one by {diff} > 1e-3 x {scale}")
    cpipe._graphs.clear()
    del staged_img, graph_img, img
    gc.collect()
    torch.cuda.empty_cache()

    # the tower as an HF folder and an InstantIR folder for the 768-wide Resampler beside phase 4c's tree
    root = os.path.dirname(paths["dinov2"])
    clip_dir, inst = os.path.join(root, "clip_vision"), os.path.join(root, "instantir_clip")
    os.makedirs(clip_dir)
    os.makedirs(inst)
    convert.write_safetensors(os.path.join(clip_dir, "model.safetensors"), tower_sd)
    with open(os.path.join(clip_dir, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPVisionModelWithProjection"], "hidden_size": ccfg.hidden_size,
                   "num_hidden_layers": ccfg.num_layers, "num_attention_heads": ccfg.num_heads,
                   "intermediate_size": ccfg.intermediate_size, "image_size": ccfg.image_size,
                   "patch_size": ccfg.patch_size, "projection_dim": ccfg.projection_dim,
                   "hidden_act": ccfg.hidden_act, "layer_norm_eps": ccfg.eps}, f)
    res_sd = {k: v.detach().cpu() for k, v in resampler.state_dict().items()}
    adapter = torch.load(os.path.join(paths["instantir"], "adapter.pt"), map_location="cpu", weights_only=True)
    adapter["image_proj"] = {k: v for k, v in res_sd.items() if "lora_" not in k}
    torch.save(adapter, os.path.join(inst, "adapter.pt"))
    prefix = "unet.encoder_hid_proj.image_projection_layers.0."
    lora = torch.load(os.path.join(paths["instantir"], "previewer_lora_weights.bin"), map_location="cpu",
                      weights_only=True)
    lora = {k: v for k, v in lora.items() if not k.startswith(prefix)}
    lora.update({prefix + k: v for k, v in res_sd.items() if "lora_" in k})
    torch.save(lora, os.path.join(inst, "previewer_lora_weights.bin"))
    os.symlink(os.path.join(paths["instantir"], "aggregator.pt"), os.path.join(inst, "aggregator.pt"))
    with open(os.path.join(inst, "instantir_config.json"), "w") as f:
        json.dump({"lora_rank": ucfg.lora_rank, "resampler": dataclasses.asdict(rcfg)}, f)
    del adapter, lora, tower_sd

    # cli.infer.main --use_clip_encoder --fused with its own load, one 1024² PNG
    lq_dir, out_dir = os.path.join(root, "lq_clip"), os.path.join(root, "out_clip")
    os.makedirs(lq_dir)
    rgb = (torch.rand(res, res, 3, generator=torch.Generator().manual_seed(17)) * 255).to(torch.uint8).numpy()
    write_png(os.path.join(lq_dir, "a.png"), rgb)
    argv = ["--sdxl_path", paths["sdxl"], "--instantir_path", inst, "--vision_encoder_path", clip_dir,
            "--use_clip_encoder", "--test_path", lq_dir, "--out_path", out_dir, "--fused", "--num_inference_steps",
            "4", "--batch_size", "1"]
    parsed = infer.build_parser().parse_args(argv)
    cli_cfg = infer.restore_config(parsed)
    per = expected_restore_launches(ucfg, cli_cfg, build_step_phases(cli_cfg), lat)
    zero_counters(mods)
    t0 = time.perf_counter()
    records = infer.main(argv)
    cli_sec = time.perf_counter() - t0
    launches = out["launches"]["cli"] = read_counters(mods)
    if launches != every_counter({k: 2 * n for k, n in per.items()}):
        fail(f"phase 4g, the CLI with --use_clip_encoder: launched {launches}, derived 2 x {per}")
    gc.collect()
    torch.cuda.empty_cache()
    got = np.asarray(infer.read_image(os.path.join(out_dir, "a.png")))
    encoders = [(t, CLIPTokenizer.from_pretrained(os.path.join(paths["sdxl"], sub)))
                for t, sub in zip(towers, ("tokenizer", "tokenizer_2"))]
    pe, pooled = infer.encode_prompts(encoders, [infer.DEFAULT_PROMPT], "cuda")
    npe, npooled = infer.encode_prompts(encoders, [infer.DEFAULT_NEG_PROMPT], "cuda")
    arr = rgb.astype(np.float32) / 127.5 - 1.0
    image, _ = cpipe.restore(torch.from_numpy(arr[None]).cuda(), pe, pooled, negative_prompt_embeds=npe,
                             negative_pooled_embeds=npooled, cfg=cli_cfg,
                             generator=torch.Generator(device="cuda").manual_seed(parsed.seed))
    want = (((np.clip(image[0], -1.0, 1.0) + 1.0) / 2.0) * 255.0).astype(np.uint8)
    diff = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) if got.shape == want.shape else -1
    log(f"  CLI --use_clip_encoder --fused with its own load, 1024² 4 steps: {cli_sec:.3f} s from main() to its "
        f"return (load, warm-up, capture, replay; the image {records[0]['seconds']:.3f} s PNG read to PNG written), "
        f"launches {launches}; its PNG against the in-memory CLIP-encoder restore of the same pixels: max abs "
        f"difference {diff} (uint8), {len(np.unique(got))} distinct values on {card_line}")
    if diff != 0 or len(np.unique(got)) < 2:
        fail(f"phase 4g: the CLI's PNG differs from the in-memory restore of its input (max abs difference {diff})")
    cpipe._graphs.clear()
    del cpipe, enc, resampler, image
    gc.collect()
    torch.cuda.empty_cache()
    out.update(staged_sec=min(secs["staged"]), graph_sec=min(secs["graph"]), record_sec=record_sec, enc_ms=enc_ms,
               cli_sec=cli_sec, cli_image_sec=records[0]["seconds"], peak_gb=staged_peak,
               total={k: sum(out["launches"][w][k] for w in ("staged restore", "graph recording", "cli"))
                      for k in COUNTERS})
    return out


def _checksums(torch, params: dict) -> dict:
    """Per-leaf (sum, sum of squares) in fp64: changes with any element. One
    copy to the host for all leaves."""
    sums = []
    for p in params.values():
        x = p.detach().double()
        sums.append(torch.stack([x.sum(), (x * x).sum()]))
    if not sums:
        return {}
    return dict(zip(params, map(tuple, torch.stack(sums).cpu().tolist())))


def training_batch(torch, g, bsz: int, res: int, dtype, uncond: bool = False):
    """A degraded pair (gt uniform in [-1, 1], lq = gt plus noise) and the text
    conditioning, drawn from ``g``; with ``uncond`` also the stage-2 uncond
    text embeds (zeros, as for an empty prompt)."""
    gt = torch.rand(bsz, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    lq = (gt + 0.2 * torch.randn(gt.shape, generator=g, device="cuda")).clamp(-1.0, 1.0)
    cond = {"prompt_embeds": (torch.randn(bsz, 77, 2048, generator=g, device="cuda") * 0.1).to(dtype),
            "pooled_embeds": (torch.randn(bsz, 1280, generator=g, device="cuda") * 0.1).to(dtype),
            "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * bsz, dtype=dtype, device="cuda")}
    if uncond:
        cond.update(uncond_prompt_embeds=torch.zeros_like(cond["prompt_embeds"]),
                    uncond_pooled_embeds=torch.zeros_like(cond["pooled_embeds"]))
    return {"lq": lq, "gt": gt}, cond


def train_step_checked(torch, trainer, batch, g, mods: dict, expected: dict, what: str, card_line: str):
    """One ``train_step`` with every counter set to 0 just before it and read
    just after: the metrics must be finite and the counts equal ``expected``.
    Returns (launches, seconds, metrics)."""
    zero_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    metrics = trainer.train_step(batch, generator=g)
    torch.cuda.synchronize()
    sec = time.time() - t0
    launches = read_counters(mods)
    values = {k: float(v) for k, v in metrics.items()}
    shown = "  ".join(f"{k} {v:.5g}" for k, v in values.items())
    log(f"  {what}: {shown}  {sec:.3f} s/step  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB  "
        f"launches {launches}  on {card_line}")
    if not all(v == v and abs(v) != float("inf") for v in values.values()):
        fail(f"{what}: metrics {values} are not all finite")
    if launches != expected:
        fail(f"{what}: kernel launches {launches} differ from the counts derived from the config {expected}")
    return launches, sec, values


def trainer_masters(torch, trainer, what: str) -> dict:
    """``{name: master}`` of the trainer's trainable leaves
    (``ClippedAdamW.masters``): a bf16 leaf trains through an fp32 copy with
    fp32 moments (the JAX trainers' fp32 parameters), an fp32 leaf is its own."""
    narrow = [p for p in trainer.trainable if p.dtype != torch.float32]
    if not narrow:
        fail(f"{what}: no bf16 trainable leaf")
    log(f"  {what}: {len(narrow)} bf16 trainable leaves ({sum(p.numel() for p in narrow) / 1e6:.2f} M parameters) "
        f"train through fp32 masters, {len(trainer.trainable) - len(narrow)} fp32 leaves are their own")
    return dict(zip(trainer.trainable_names, trainer.optimizer.masters))


def check_masters(torch, trainer, what: str) -> None:
    """After the steps: each bf16 leaf has a separate fp32 master, every
    master's AdamW moments are fp32, and each bf16 leaf holds its master's
    bf16 rounding."""
    opt = trainer.optimizer
    for n, p, m in zip(trainer.trainable_names, trainer.trainable, opt.masters):
        state = opt.optimizer.state.get(m, {})
        moments = {state[k].dtype for k in ("exp_avg", "exp_avg_sq") if k in state}
        if m.dtype != torch.float32 or (m is p) != (p.dtype == torch.float32) or moments != {torch.float32}:
            fail(f"{what}: {n} has no fp32 master with fp32 moments of its own")
        if p is not m and not torch.equal(p.detach(), m.to(p.dtype)):
            fail(f"{what}: the bf16 leaf {n} is not its fp32 master's rounding")
    log(f"  {what}: every master and its AdamW moments fp32, every bf16 leaf its master's rounding")


def check_leaves(torch, before_train: dict, before_frozen: dict, trainable: dict, frozen: dict, what: str) -> None:
    """Every trainable leaf (its fp32 master) moved, no frozen leaf changed (``_checksums``)."""
    after_train, after_frozen = _checksums(torch, trainable), _checksums(torch, frozen)
    stuck = [n for n in trainable if after_train[n] == before_train[n]]
    changed = [n for n in frozen if after_frozen[n] != before_frozen[n]]
    if stuck:
        fail(f"{what}: {len(stuck)} trainable leaves did not move, e.g. {stuck[:5]}")
    if changed:
        fail(f"{what}: {len(changed)} frozen leaves changed, e.g. {changed[:5]}")
    log(f"  {what}: all {len(trainable)} trainable leaves' masters moved, none of the {len(frozen)} frozen leaves "
        "changed")


def optimizer_bytes(torch, trainer) -> int:
    """Bytes the trainer's optimiser holds beside the model: fp32 masters that
    are not the leaves themselves, and the moments (fp32 AdamW's, or the
    8-bit one's flat buffers)."""
    opt = trainer.optimizer
    if hasattr(opt, "flat"):
        own = [opt.flat, opt.mu_q, opt.nu_q, opt.mu_scale, opt.nu_scale]
    else:
        own = [m for p, m in zip(opt.params, opt.masters) if m is not p]
        own += [t for s in opt.optimizer.state.values() for t in s.values() if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in own)


def qlora_turns(torch, trainer, make_qlora, batch, g, mods: dict, expected: dict, what: str, card_line: str) -> dict:
    """One more 512² batch-2 step with ``quantize_frozen_unet`` and
    ``use_8bit_adam`` (``make_qlora(unet)``: a trainer over a copy of the
    UNet, which it quantizes in place): the bf16 trainer's step and the QLoRA
    step in turns (bf16, QLoRA, QLoRA, bf16), each with the launches of the
    bf16 step and finite metrics; the QLoRA trainer's bases W8, its moments
    int8, every master moved, each bf16 leaf its master's rounding, no frozen
    leaf or int8 buffer changed. Each step's peak is also given net of what
    the other trainer alone holds (its UNet and its optimiser), the peak a
    run of that trainer alone would reach."""
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.train.adam8bit import AdamW8bit

    unet = copy.deepcopy(trainer.unet)
    q = make_qlora(unet)
    if quant.quant_mode(q.unet) != "w8" or not isinstance(q.optimizer, AdamW8bit):
        fail(f"{what}: the QLoRA trainer's UNet is {quant.quant_mode(q.unet)}, its optimiser "
             f"{type(q.optimizer).__name__}")
    named = q.named_parameters()
    masters = dict(zip(q.trainable_names, q.optimizer.masters))
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    frozen.update({f"unet.{n}": b for n, b in q.unet.named_buffers() if n.rsplit(".", 1)[-1].startswith("weight_")})
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)
    held = {id(trainer): model_bytes([trainer.unet]) + optimizer_bytes(torch, trainer),
            id(q): model_bytes([q.unet]) + optimizer_bytes(torch, q)}
    n_q = quant.quantized_bytes(q.unet)[0]
    log(f"  {what}: {n_q / 1e9:.3f} B UNet weight values W8 (UNet {model_bytes([trainer.unet]) / 1e9:.2f} -> "
        f"{model_bytes([q.unet]) / 1e9:.2f} GB), optimiser state {optimizer_bytes(torch, trainer) / 1e9:.2f} GB fp32 "
        f"AdamW -> {optimizer_bytes(torch, q) / 1e9:.2f} GB 8-bit ({len(q.trainable_names)} leaves, "
        f"{q.optimizer.mu_q.shape[0]} blocks of {q.optimizer.mu_q.shape[1]})")
    out = {"sec": {"bf16": [], "qlora": []}, "peak_gb": {"bf16": [], "qlora": []}, "launches": None}
    for kind in ("bf16", "qlora", "qlora", "bf16"):
        t = trainer if kind == "bf16" else q
        other = q if kind == "bf16" else trainer
        launches, sec, _ = train_step_checked(torch, t, batch, g, mods, expected, f"{what}, {kind} step", card_line)
        peak = torch.cuda.max_memory_allocated()
        out["sec"][kind].append(sec)
        out["peak_gb"][kind].append((peak - held[id(other)]) / 1e9)
        if kind == "qlora":
            out["launches"] = {k: n + (out["launches"] or {}).get(k, 0) for k, n in launches.items()}
            if t is q and len(out["sec"]["qlora"]) == 2:
                check_leaves(torch, before_train, before_frozen, masters, frozen, f"{what}, 2 QLoRA steps")
                for n, p, m in zip(q.trainable_names, q.trainable, q.optimizer.masters):
                    if m.dtype != torch.float32 or (p is not m and not torch.equal(p.detach(), m.to(p.dtype))):
                        fail(f"{what}: the leaf {n} is not its fp32 master's rounding")
                opt = q.optimizer
                if opt.mu_q.dtype != torch.int8 or opt.nu_q.dtype != torch.int8 or not opt.mu_q.abs().sum() > 0:
                    fail(f"{what}: the 8-bit moments are {opt.mu_q.dtype} / {opt.nu_q.dtype}, or all zero")
    log(f"  {what}: s/step in turns bf16 {['%.3f' % x for x in out['sec']['bf16']]}, QLoRA "
        f"{['%.3f' % x for x in out['sec']['qlora']]}; peak net of the other trainer bf16 "
        f"{['%.2f' % x for x in out['peak_gb']['bf16']]} GB, QLoRA {['%.2f' % x for x in out['peak_gb']['qlora']]} GB; "
        f"every master fp32 (each bf16 leaf its rounding), moments int8; on {card_line}")
    del q, unet
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_stage2(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 5: stage-2 (Aggregator) training steps at full SDXL width."""
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

    cfg = Stage2Config(train_batch_size=2, resolution=512, lr_warmup_steps=0, output_dir="")
    trainer = Stage2Trainer(pipe.unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder, cfg,
                            device="cuda")
    named = trainer.named_parameters()
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    if not all(n.startswith("aggregator.") for n in trainable):
        fail("stage 2 with a frozen adapter trains leaves outside the Aggregator")
    log(f"  stage-2 trainer: {sum(p.numel() for p in trainable.values()) / 1e6:.2f} M trainable parameters in "
        f"{len(trainable)} leaves, {sum(p.numel() for p in frozen.values()) / 1e9:.3f} B frozen in {len(frozen)}; "
        f"fp32 EMA adapter copy of {len(trainer.ema_adapter)} leaves")
    masters = trainer_masters(torch, trainer, "stage 2")
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"train_stage2_512": {name: 0 for name in COUNTERS}, "sec_512": []}
    expected = every_counter(expected_stage2_launches(ucfg, cfg, 512 // 8, checkpointing=False))
    if not mods["group_norm"].USE_FUSED:
        expected["group_norm_silu"] = 0
    log(f"  512² batch 2, no checkpointing; expected launches per step {expected}")
    batch = trainer.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True))
    for i in range(2):
        launches, sec, _ = train_step_checked(torch, trainer, batch, g, mods, expected,
                                              f"stage-2 train_step {i + 1}/2 at 512² batch 2", card_line)
        out["sec_512"].append(sec)
        for name, n in launches.items():
            out["train_stage2_512"][name] += n
    out["peak_gb_512"] = torch.cuda.max_memory_allocated() / 1e9

    trainer.unet.gradient_checkpointing = trainer.aggregator.gradient_checkpointing = True
    expected = every_counter(expected_stage2_launches(ucfg, cfg, 1024 // 8, checkpointing=True))
    if not mods["group_norm"].USE_FUSED:
        expected["group_norm_silu"] = 0
    log(f"  1024² batch 1, gradient checkpointing on the UNet and the Aggregator; expected launches {expected}")
    batch = trainer.prepare_batch(*training_batch(torch, g, 1, 1024, torch.bfloat16, uncond=True))
    out["train_stage2_1024"], out["sec_1024"], _ = train_step_checked(
        torch, trainer, batch, g, mods, expected, "stage-2 train_step at 1024² batch 1, checkpointing", card_line)
    out["peak_gb_1024"] = torch.cuda.max_memory_allocated() / 1e9
    trainer.unet.gradient_checkpointing = trainer.aggregator.gradient_checkpointing = False
    check_leaves(torch, before_train, before_frozen, masters, frozen, "stage 2, 3 steps")
    check_masters(torch, trainer, "stage 2")
    out["cfg"] = cfg
    qcfg = dataclasses.replace(cfg, quantize_frozen_unet=True, use_8bit_adam=True)
    expected = every_counter(expected_stage2_launches(ucfg, cfg, 512 // 8, checkpointing=False))
    if not mods["group_norm"].USE_FUSED:
        expected["group_norm_silu"] = 0
    out["qlora"] = qlora_turns(
        torch, trainer, lambda unet: Stage2Trainer(unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder,
                                                   qcfg, device="cuda"),
        trainer.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True)), g, mods, expected,
        "stage-2 QLoRA at 512² batch 2", card_line)
    log(f"  stage-2 512² steps {['%.3f' % x for x in out['sec_512']]} s (the first includes warm-up), peak "
        f"{out['peak_gb_512']:.2f} GB; 1024² step {out['sec_1024']:.3f} s, peak {out['peak_gb_1024']:.2f} GB; "
        f"on {card_line}")
    out["trainer"] = trainer  # phase 5b takes its steps in turns with this one's
    return out


def run_stage2_adapter(torch, pipe, stage2: dict, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 5b: stage 2 with ``aggregator_adapter`` at SDXL width.

    1. ``enable_aggregator_adapter`` on phase 4's Aggregator, then two
       ``train_step``s at 512², batch 2, in turns with phase 5's plain
       trainer (``stage2["trainer"]``, freed after them; plain, adapter,
       adapter, plain, plain, adapter) on one batch: finite
       metrics, every master moved (the Aggregator's, its new ip leaves' and
       the agg_resampler's), no frozen leaf changed, masters and moments fp32,
       the launches of the plain step (the ip branches attend over
       ``adapter_tokens`` = 64 keys and take the plain path); s/step and peaks
       (each with both trainers' models and optimisers held).
    2. One forward and backward of the Aggregator alone at 512², batch 2,
       with ``pad_concat`` and ``attn1_mode="sep_split"`` (K2-K4 at one
       stream's 32x32 = 1024 tokens; sep_split drops the pad row), and with
       ``pad_concat`` and ``plain`` (K2-K4 at the ragged 2080 and 528), each
       against the plain path (``use_flash=False``, GroupNorm plain).
    3. ``cli.train.main stage2 --aggregator_adapter --synthetic_data`` for 2
       steps with a checkpoint, then resumed to 4: the first run's state
       equals ``checkpoint-2`` bitwise, the second run resumes from it and
       leaves ``checkpoint-4``, ``aggregator.pt`` maps strictly onto an
       adapter Aggregator; launches 2 x the plain step's each run."""
    import contextlib
    import io
    import tempfile

    from instantir_tpu_torch.cli import train as cli_mod
    from instantir_tpu_torch.models.aggregator import Aggregator
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Trainer, enable_aggregator_adapter

    group_norm = mods["group_norm"]
    plain = stage2.pop("trainer")
    out = {"launches": {name: 0 for name in COUNTERS}, "grads_launches": {name: 0 for name in COUNTERS}}
    cfg = dataclasses.replace(plain.cfg, aggregator_adapter=True)
    per_step = every_counter(expected_stage2_launches(ucfg, plain.cfg, 512 // 8, checkpointing=False))
    if not group_norm.USE_FUSED:
        per_step["group_norm_silu"] = 0

    # 1. the adapter's steps in turns with the plain ones
    t0 = time.time()
    agg, agg_res = enable_aggregator_adapter(pipe.aggregator, pipe.aggregator.state_dict(),
                                             pipe.image_encoder.config.hidden_size, cfg, seed=0)
    trainer = Stage2Trainer(pipe.unet, agg, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda",
                            agg_resampler=agg_res)
    torch.cuda.synchronize()
    named = trainer.named_parameters()
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    ip_leaves = [n for n in trainer.trainable_names if ".processor." in n]
    res_leaves = [n for n in trainer.trainable_names if n.startswith("agg_resampler.")]
    if not (ip_leaves and res_leaves and all(n.startswith(("aggregator.", "agg_resampler."))
                                            for n in trainer.trainable_names)):
        fail("phase 5b: the adapter trainer does not train the Aggregator's ip leaves and the agg_resampler alone")
    log(f"  enable_aggregator_adapter + trainer in {time.time() - t0:.2f} s: {len(trainer.trainable_names)} trainable "
        f"leaves ({len(ip_leaves)} attn1 ip leaves, {len(res_leaves)} agg_resampler leaves, "
        f"{sum(named[n].numel() for n in res_leaves) / 1e6:.2f} M agg_resampler parameters, "
        f"{agg_res.config.num_queries} queries), {len(frozen)} frozen")
    masters = trainer_masters(torch, trainer, "stage 2 with the adapter")
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)
    g = torch.Generator(device="cuda").manual_seed(37)
    batch = trainer.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True))
    turns = {"sec": {"plain": [], "adapter": []}, "peak_gb": {"plain": [], "adapter": []}}
    for kind in ("plain", "adapter", "adapter", "plain", "plain", "adapter"):
        t = plain if kind == "plain" else trainer
        launches, sec, _ = train_step_checked(torch, t, batch, g, mods, per_step,
                                              f"stage-2 train_step ({kind}) at 512² batch 2", card_line)
        turns["sec"][kind].append(sec)
        turns["peak_gb"][kind].append(torch.cuda.max_memory_allocated() / 1e9)
        if kind == "adapter":
            for name, n in launches.items():
                out["launches"][name] += n
    check_leaves(torch, before_train, before_frozen, masters, frozen, "stage 2 with the adapter, 3 steps")
    check_masters(torch, trainer, "stage 2 with the adapter")
    out["turns"] = turns
    log(f"  stage 2 plain vs adapter at 512² batch 2 in turns (the first of each warms up): s/step "
        f"{json.dumps({k: [round(x, 3) for x in v] for k, v in turns['sec'].items()})}, peak "
        f"{json.dumps({k: [round(x, 2) for x in v] for k, v in turns['peak_gb'].items()})} GB (both trainers' "
        f"models and optimisers held); on {card_line}")
    del trainer, agg, agg_res, masters, batch, plain
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the Aggregator's gradients at the per-stream and ragged shapes
    lat, b = 512 // 8, 2
    bf16 = torch.bfloat16
    sample = torch.randn(b, 4, lat, lat, generator=g, device="cuda").to(bf16)
    preview = torch.randn(b, 4, lat, lat, generator=g, device="cuda").to(bf16)
    t = torch.tensor([301, 701], device="cuda")
    pooled_dim = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    pooled = (torch.randn(b, pooled_dim, generator=g, device="cuda") * 0.1).to(bf16)
    tids = torch.tensor([[512, 512, 0, 0, 512, 512]] * b, dtype=bf16, device="cuda")
    gn_agg = group_norms_per_forward(ucfg, with_up=False)["total"]
    out["grads"] = {}
    for mode in ("sep_split", "plain"):
        agg = variant_aggregator(torch, pipe, ucfg, g, pad_concat=True, attn1_mode=mode).requires_grad_(True)
        params = [p for _, p in agg.named_parameters()]
        names = [n for n, _ in agg.named_parameters()]
        calls = variant_flash_calls(ucfg, lat, True, mode)
        n = sum(calls.values())
        want = every_counter({"flash_attention_fwd_lse": n, "flash_attention_bwd_dq": n,
                              "flash_attention_bwd_dkv": n, "group_norm_silu": gn_agg})

        def grads():
            down, mid = agg(sample, t, preview, pooled, tids, ref_scale=0.5)
            loss = sum(r.float().square().mean() for r in down) + mid.float().square().mean()
            return torch.autograd.grad(loss, params)

        zero_counters(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = grads()
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = read_counters(mods)
        if launches != want:
            fail(f"phase 5b, Aggregator pad_concat {mode} gradients: launches {launches}, derived {want}")
        for name, k in launches.items():
            out["grads_launches"][name] += k
        peak = torch.cuda.max_memory_allocated() / 1e9
        set_plain(agg, group_norm, True)
        try:
            ref = grads()
        finally:
            set_plain(agg, group_norm, False)
        rel = rel_l2(torch, got, ref)
        per_leaf = sorted(((rel_l2(torch, a, r), nm) for a, r, nm in zip(got, ref, names) if r.float().norm() > 0),
                          reverse=True)
        if not (all(torch.isfinite(x).all() for x in got) and rel <= VARIANT_GRAD_TOL):
            fail(f"phase 5b: the pad_concat {mode} Aggregator's gradients are not finite or {rel} from the plain "
                 f"path (> {VARIANT_GRAD_TOL})")
        out["grads"][mode] = {"launches_by_shape": {f"{sq}x{skv}": k for (sq, skv), k in calls.items()},
                              "rel_l2": rel, "worst_leaf": per_leaf[0], "sec": sec, "peak_gb": peak}
        log(f"  Aggregator pad_concat {mode} forward + backward at 512² batch 2: K2-K4 by (Sq, Skv) "
            f"{out['grads'][mode]['launches_by_shape']}, K5 {gn_agg}; parameter gradients {rel:.3e} (relative L2) "
            f"from the plain path, worst leaf {per_leaf[0][1]} {per_leaf[0][0]:.3e}; {sec:.3f} s, peak {peak:.2f} GB")
        del agg, params, got, ref
        gc.collect()
        torch.cuda.empty_cache()

    # 3. the training CLI with --aggregator_adapter, checkpointed and resumed
    root = tempfile.mkdtemp(prefix="chip_smoke_adapter_")
    try:
        free = shutil.disk_usage(root).free
        if free < 40e9:
            fail(f"phase 5b: the checkpoints need 40 GB, {root} has {free / 1e9:.2f} GB free")
        flags = ["stage2", "--aggregator_adapter", "--synthetic_data", "--resolution", "512", "--train_batch_size",
                 "2", "--lr_warmup_steps", "0", "--checkpointing_steps", "2", "--checkpoints_total_limit", "1",
                 "--output_dir", root, "--losses_config", str(REPO / "config_files" / "losses.yaml")]
        shared = _checksums(torch, dict(pipe.aggregator.named_parameters()))
        out["cli"] = {}
        for steps in (2, 4):
            text = io.StringIO()
            zero_counters(mods)
            t0 = time.time()
            with contextlib.redirect_stdout(text):
                result = cli_mod.main(flags + ["--max_train_steps", str(steps)], pipe=pipe)
            torch.cuda.synchronize()
            sec = time.time() - t0
            launches = read_counters(mods)
            for line in text.getvalue().rstrip().splitlines():
                log(f"    | {line}")
            trainer = result["trainer"]
            want = every_counter({k: 2 * n for k, n in per_step.items()})
            if launches != want or trainer.global_step != steps:
                fail(f"phase 5b, the CLI to {steps} steps: launches {launches} (derived {want}), ended at step "
                     f"{trainer.global_step}")
            for name, k in launches.items():
                out["launches"][name] += k
            left = sorted(d for d in os.listdir(root) if d.startswith("checkpoint-"))
            if left != [f"checkpoint-{steps}"]:
                fail(f"phase 5b: the CLI run to {steps} steps left {left}")
            if steps == 2:
                out["cli"]["restore"] = restore_checked(torch, trainer, 2, "stage 2 with the adapter", card_line)
                masters = dict(zip(trainer.trainable_names, trainer.optimizer.masters))
                moved = _checksums(torch, {n: masters["aggregator." + n] for n in shared})
                stuck = [n for n in shared if moved[n] == shared[n]]
                if stuck:
                    fail(f"phase 5b: {len(stuck)} Aggregator masters did not move in the CLI run, e.g. {stuck[:3]}")
            elif "resumed from checkpoint-2" not in text.getvalue():
                fail("phase 5b: the second CLI run did not resume from checkpoint-2")
            out["cli"][f"sec_{steps}"] = sec
            log(f"  CLI stage2 --aggregator_adapter to {steps} steps: {sec:.2f} s for the run and its export, launches "
                f"{launches}, checkpoint writes {trainer.ckpt.saves}; on {card_line}")
            del result, trainer
            gc.collect()
            torch.cuda.empty_cache()
        exported = torch.load(os.path.join(root, "aggregator.pt"), map_location="cpu", weights_only=True)
        Aggregator(ucfg, dtype=torch.bfloat16, device="meta", aggregator_adapter=True).load_state_dict(
            exported, strict=True, assign=True)
        if not any(".attn1.processor.to_k_ip." in k for k in exported):
            fail("phase 5b: aggregator.pt holds no attn1 ip leaf")
        log(f"  aggregator.pt ({len(exported)} tensors) maps strictly onto an adapter Aggregator")
        del exported
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  phase 5b launches: adapter steps and CLI {out['launches']}, gradient checks {out['grads_launches']}")
    return out


def run_training(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 6: stage-1 (DCP adapter) training steps at full SDXL width."""
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

    cfg = Stage1Config(train_batch_size=2, resolution=512, lr_warmup_steps=0, max_train_steps=1000, output_dir="")
    del pipe.aggregator  # stage 1 trains without it
    gc.collect()
    torch.cuda.empty_cache()
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
    named = dict(trainer.named_parameters())
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    log(f"  stage-1 trainer: {sum(p.numel() for p in trainable.values()) / 1e6:.2f} M trainable parameters in "
        f"{len(trainable)} leaves, {sum(p.numel() for p in frozen.values()) / 1e9:.3f} B frozen in {len(frozen)}")
    masters = trainer_masters(torch, trainer, "stage 1")
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)

    g = torch.Generator(device="cuda").manual_seed(3)

    def make_batch(bsz: int, res: int):
        return trainer.prepare_batch(*training_batch(torch, g, bsz, res, torch.bfloat16))

    def step(batch, expected: dict, what: str):
        return train_step_checked(torch, trainer, batch, g, mods, expected, what, card_line)

    fused = mods["group_norm"].USE_FUSED
    expected = every_counter(expected_train_launches(ucfg, 512 // 8, checkpointing=False))
    if not fused:
        expected["group_norm_silu"] = 0
    log(f"  512² batch 2, no checkpointing; expected launches per step {expected}")
    batch = make_batch(2, 512)
    total = {name: 0 for name in COUNTERS}
    secs = []
    for i in range(3):
        launches, sec, _ = step(batch, expected, f"train_step {i + 1}/3 at 512² batch 2")
        secs.append(sec)
        for name, n in launches.items():
            total[name] += n

    trainer.unet.gradient_checkpointing = True
    expected_big = every_counter(expected_train_launches(ucfg, 1024 // 8, checkpointing=True))
    if not fused:
        expected_big["group_norm_silu"] = 0
    log(f"  1024² batch 1, gradient checkpointing; expected launches {expected_big}")
    big, big_sec, _ = step(make_batch(1, 1024), expected_big, "train_step at 1024² batch 1, checkpointing")
    trainer.unet.gradient_checkpointing = False
    check_leaves(torch, before_train, before_frozen, masters, frozen, "stage 1, 4 steps")
    check_masters(torch, trainer, "stage 1")
    log(f"  512² steps {['%.3f' % s for s in secs]} s (the first includes warm-up), 1024² step {big_sec:.3f} s")
    qcfg = dataclasses.replace(cfg, quantize_frozen_unet=True, use_8bit_adam=True)
    qlora = qlora_turns(torch, trainer, lambda unet: Stage1Trainer(unet, pipe.resampler, pipe.vae, pipe.image_encoder,
                                                                   qcfg, device="cuda"),
                        make_batch(2, 512), g, mods, expected, "stage-1 QLoRA at 512² batch 2", card_line)
    return {"train_512": total, "train_1024": big, "sec_512": secs, "sec_1024": big_sec, "qlora": qlora}


def run_previewer(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 7: previewer (LCM-LoRA distillation) training steps at full SDXL
    width: two at 512² batch 2 with the default Huber loss, one with the
    image branch ([HuberLoss 1, DINOLoss 1e-3, LCMVisualization k=1], a
    second trainer over the same models), one at 1024² batch 1 with gradient
    checkpointing on the UNet."""
    from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
    from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer

    cfg = PreviewerConfig(train_batch_size=2, resolution=512, lr_warmup_steps=0, output_dir="")
    trainer = PreviewerTrainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
    named = trainer.named_parameters()
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    if not all(".lora_A." in n or ".lora_B." in n for n in trainable):
        fail("the previewer trains leaves that are not LoRA")
    if not any(n.startswith("resampler.") for n in trainable):
        fail("the previewer does not train the Resampler's LoRA")
    log(f"  previewer trainer: {sum(p.numel() for p in trainable.values()) / 1e6:.2f} M trainable LoRA parameters in "
        f"{len(trainable)} leaves, {sum(p.numel() for p in frozen.values()) / 1e9:.3f} B frozen in {len(frozen)}")
    masters = trainer_masters(torch, trainer, "previewer")
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)
    g = torch.Generator(device="cuda").manual_seed(8)
    fused = mods["group_norm"].USE_FUSED

    def expected_for(res: int, checkpointing: bool, image_branch: bool = False) -> dict:
        expected = every_counter(expected_previewer_launches(ucfg, res // 8, checkpointing, image_branch))
        if not fused:
            expected["group_norm_silu"] = 0
        return expected

    out = {"train_previewer_512": {name: 0 for name in COUNTERS}, "sec_512": []}
    expected = expected_for(512, False)
    log(f"  512² batch 2, no checkpointing; expected launches per step {expected}")
    batch = trainer.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True))
    for i in range(2):
        launches, sec, _ = train_step_checked(torch, trainer, batch, g, mods, expected,
                                              f"previewer train_step {i + 1}/2 at 512² batch 2, Huber", card_line)
        out["sec_512"].append(sec)
        for name, n in launches.items():
            out["train_previewer_512"][name] += n
    out["peak_gb_512"] = torch.cuda.max_memory_allocated() / 1e9

    losses = LossesConfig(lcm_losses=[
        SingleLossConfig(name="HuberLoss", weight=1.0, init_params={"huber_c": 0.001}),
        SingleLossConfig(name="DINOLoss", weight=1e-3),
        SingleLossConfig(name="LCMVisualization", weight=1.0, visualize_every_k=1)])
    image_trainer = PreviewerTrainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, losses,
                                     device="cuda")
    launches, out["sec_dino"], metrics = train_step_checked(
        torch, image_trainer, batch, g, mods, expected_for(512, False, image_branch=True),
        "previewer train_step at 512² batch 2, Huber + DINOLoss + LCMVisualization", card_line)
    out["peak_gb_dino"] = torch.cuda.max_memory_allocated() / 1e9
    for name, n in launches.items():
        out["train_previewer_512"][name] += n
    strip, center = image_trainer.last_vis_strip, image_trainer.dino_center
    if not {"HuberLoss", "DINOLoss", "LCMVisualization"} <= set(metrics):
        fail(f"the image-branch step's metrics {sorted(metrics)} lack a loss")
    if strip is None or tuple(strip.shape) != (2, 512, 1536, 3) or not torch.isfinite(strip).all():
        fail(f"the visualisation strip is not finite of shape (2, 512, 1536, 3): "
             f"{None if strip is None else tuple(strip.shape)}")
    if not (torch.isfinite(center).all() and center.abs().max() > 0):
        fail("the DINOLoss center did not move to finite values")
    del image_trainer, strip
    torch.cuda.empty_cache()

    trainer.unet.gradient_checkpointing = True
    expected = expected_for(1024, True)
    log(f"  1024² batch 1, gradient checkpointing on the UNet; expected launches {expected}")
    batch = trainer.prepare_batch(*training_batch(torch, g, 1, 1024, torch.bfloat16, uncond=True))
    out["train_previewer_1024"], out["sec_1024"], _ = train_step_checked(
        torch, trainer, batch, g, mods, expected, "previewer train_step at 1024² batch 1, checkpointing", card_line)
    out["peak_gb_1024"] = torch.cuda.max_memory_allocated() / 1e9
    trainer.unet.gradient_checkpointing = False
    check_leaves(torch, before_train, before_frozen, masters, frozen, "previewer, 4 steps")
    check_masters(torch, trainer, "previewer")
    qcfg = dataclasses.replace(cfg, quantize_frozen_unet=True, use_8bit_adam=True)
    out["qlora"] = qlora_turns(
        torch, trainer, lambda unet: PreviewerTrainer(unet, pipe.resampler, pipe.vae, pipe.image_encoder, qcfg,
                                                      device="cuda"),
        trainer.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True)), g, mods,
        expected_for(512, False), "previewer QLoRA at 512² batch 2", card_line)
    log(f"  previewer 512² Huber steps {['%.3f' % x for x in out['sec_512']]} s (the first includes warm-up), peak "
        f"{out['peak_gb_512']:.2f} GB; DINOLoss step {out['sec_dino']:.3f} s, peak {out['peak_gb_dino']:.2f} GB; "
        f"1024² step {out['sec_1024']:.3f} s, peak {out['peak_gb_1024']:.2f} GB; on {card_line}")
    return out


def synthetic_insightface_state(torch, cfg, g) -> dict:
    """A synthetic IR-SE50 state dict in InsightFace's names: every
    BatchNorm's weight, bias and running statistics drawn from ``g`` (folded
    on load by ``IDLoss``), the other weights fan-in scaled."""
    from instantir_tpu_torch.losses.arcface import Affine, ArcFaceBackbone
    from instantir_tpu_torch.pipeline.factory import synthesize_weights

    model = synthesize_weights(ArcFaceBackbone(cfg, device="cuda"), g)
    affines = {name: m.scale.numel() for name, m in model.named_modules() if isinstance(m, Affine)}
    sd = {k: v for k, v in model.state_dict().items() if k.rsplit(".", 1)[0] not in affines}
    for name, n in affines.items():
        def draw(shift, std):
            return shift + std * torch.randn(n, generator=g, device="cuda")

        sd.update({f"{name}.weight": draw(1.0, 0.1), f"{name}.bias": draw(0.0, 0.1),
                   f"{name}.running_mean": draw(0.0, 0.1), f"{name}.running_var": draw(1.0, 0.1).abs()})
    return sd


def run_perceptual(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 7c: the perceptual losses at full width. Three previewer steps at
    512² batch 2 with ``[HuberLoss 1, LPIPSLoss 1, DreamSIMLoss 1]`` (a
    full-width synthetic VGG16 LPIPS; DreamSim's ``embed_fns`` one synthetic
    ViT-B/16 ``CLIPVisionModel`` projection, fp32) in turns with a Huber-only
    trainer over the same models (Huber, perceptual, perceptual, Huber, after
    one perceptual warm-up step): the launches of phase 7's 512² step and of
    the image branch's three VAE decodes (the towers launch no kernel: their
    attention runs the plain version), every
    LoRA master moved, no frozen leaf changed, the masters fp32; s/step and
    peaks. Then a forward and a backward through ``pred_image`` at 512²
    batch 2 for each of LPIPSLoss, CLIPLoss (ViT-B/16 towers, 4
    augmentations, random prompt ids), IDLoss (IR-SE50, a fixed-landmark
    detector) and DreamSIMLoss: finite losses, finite nonzero gradients, <
    1e-5 on identical images (LPIPS, ID, DreamSim), ms per call; and
    ``MTCNN.detect`` on a 512² image with synthetic weights, its ms."""
    import numpy as np

    from instantir_tpu_torch.losses import CLIPLoss, DiffusionLossInputs, DreamSIMLoss, IDLoss, LPIPSLoss
    from instantir_tpu_torch.losses.arcface import ir_se_50_config
    from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
    from instantir_tpu_torch.losses.lpips import LPIPS
    from instantir_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from instantir_tpu_torch.models.clip_vision import CLIPVisionModel, clip_vit_b16_config, preprocess_clip
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer
    from instantir_tpu_torch.utils.mtcnn import MTCNN

    g = torch.Generator(device="cuda").manual_seed(19)
    lpips_sd = {k: v.abs() if k.startswith("lin") else v  # the published heads are nonnegative
                for k, v in synthesize_weights(LPIPS(device="cuda"), g).state_dict().items()}
    vcfg = clip_vit_b16_config()
    vit = synthesize_weights(CLIPVisionModel(vcfg, device="cuda").requires_grad_(False).eval(), g)

    def embed(images01):  # [B, 224, 224, 3] in [0, 1] -> the projected class token
        return vit(preprocess_clip(images01, vcfg.image_size).permute(0, 3, 1, 2))[1]

    cfg = PreviewerConfig(train_batch_size=2, resolution=512, lr_warmup_steps=0, output_dir="")
    losses = LossesConfig(lcm_losses=[
        SingleLossConfig(name="HuberLoss", weight=1.0, init_params={"huber_c": 0.001}),
        SingleLossConfig(name="LPIPSLoss", weight=1.0, init_params={"params": lpips_sd}),
        SingleLossConfig(name="DreamSIMLoss", weight=1.0, init_params={"embed_fns": [embed]})])
    models = (pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder)
    huber = PreviewerTrainer(*models, cfg, device="cuda")
    perceptual = PreviewerTrainer(*models, cfg, losses, device="cuda")
    named = perceptual.named_parameters()
    frozen = {n: p for n, p in named.items() if not p.requires_grad}
    masters = trainer_masters(torch, perceptual, "previewer with LPIPS + DreamSim")
    before_train, before_frozen = _checksums(torch, masters), _checksums(torch, frozen)
    # the perceptual steps decode images (the image branch: three fp32 VAE decodes' K5), the Huber steps do not
    expected = {branch: every_counter(expected_previewer_launches(ucfg, 512 // 8, False, image_branch=branch))
                for branch in (False, True)}
    batch = perceptual.prepare_batch(*training_batch(torch, g, 2, 512, torch.bfloat16, uncond=True))
    out = {"sec": {"huber": [], "perceptual": []}, "peak_gb": {"huber": [], "perceptual": []},
           "train_previewer_perceptual": {name: 0 for name in COUNTERS}}
    # the first perceptual step warms up the towers (cuDNN plans for VGG16 and the ViT); the turns follow
    for kind in ("warm-up", "huber", "perceptual", "perceptual", "huber"):
        t = huber if kind == "huber" else perceptual
        launches, sec, metrics = train_step_checked(torch, t, batch, g, mods, expected[kind != "huber"],
                                                    f"previewer step at 512² batch 2, {kind}", card_line)
        if kind != "warm-up":
            out["sec"][kind].append(sec)
            out["peak_gb"][kind].append(torch.cuda.max_memory_allocated() / 1e9)
        if kind != "huber":
            if not {"HuberLoss", "LPIPSLoss", "DreamSIMLoss"} <= set(metrics):
                fail(f"phase 7c: the perceptual step's metrics {sorted(metrics)} lack a loss")
            for name, n in launches.items():
                out["train_previewer_perceptual"][name] += n
            if len(out["sec"]["perceptual"]) == 2:  # before the Huber trainer writes its masters' rounding
                check_leaves(torch, before_train, before_frozen, masters, frozen, "phase 7c, 3 perceptual steps")
                check_masters(torch, perceptual, "phase 7c")
    log(f"  previewer 512² batch 2 in turns: Huber {['%.3f' % x for x in out['sec']['huber']]} s/step (peak "
        f"{['%.2f' % x for x in out['peak_gb']['huber']]} GB), Huber + LPIPS + DreamSim "
        f"{['%.3f' % x for x in out['sec']['perceptual']]} s/step (peak "
        f"{['%.2f' % x for x in out['peak_gb']['perceptual']]} GB) on {card_line}")
    lpips_loss = next(loss for loss, _ in perceptual.losses if isinstance(loss, LPIPSLoss))
    dreamsim = next(loss for loss, _ in perceptual.losses if isinstance(loss, DreamSIMLoss))
    del huber, perceptual, batch
    gc.collect()
    torch.cuda.empty_cache()

    # each loss alone: a forward and a backward through pred_image
    text_cfg = CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8, intermediate_size=2048, projection_dim=512)
    text = synthesize_weights(CLIPTextModel(text_cfg, device="cuda"), g)
    clip = CLIPLoss(params=(vit.state_dict(), text.state_dict(), 100.0), augmentations_number=4, device="cuda")
    del text

    def landmarks(images):  # fixed plausible 5-point landmarks for every image
        s = images.shape[1]
        base = np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6], [0.35, 0.8], [0.65, 0.8]]) * s
        return np.tile(base[None], (images.shape[0], 1, 1)).astype(np.float32), []

    idl = IDLoss(params=synthetic_insightface_state(torch, ir_se_50_config(), g), detect_fn=landmarks, device="cuda")
    pred = torch.rand(2, 512, 512, 3, generator=g, device="cuda") * 2.0 - 1.0
    target = torch.rand(2, 512, 512, 3, generator=g, device="cuda") * 2.0 - 1.0
    ids = torch.randint(1, 49406, (2, 77), generator=g, device="cuda")
    ids[:, 0], ids[:, 20] = 49406, 49407  # start and end of text
    out["ms"] = {}
    for name, loss in (("LPIPSLoss", lpips_loss), ("CLIPLoss", clip), ("IDLoss", idl), ("DreamSIMLoss", dreamsim)):
        def call():
            x = pred.clone().requires_grad_(True)
            val = loss(DiffusionLossInputs(predicted=x, target=x, pred_image=x, target_image=target, prompt_ids=ids,
                                           generator=g))
            val.backward()
            return val.detach(), x.grad

        zero_counters(mods)
        val, grad = call()
        launches = read_counters(mods)
        ms = time_ms(torch, call, iters=3, warmup=1)
        same = None
        if name != "CLIPLoss":
            with torch.no_grad():
                same = loss(DiffusionLossInputs(predicted=pred, target=pred, pred_image=pred, target_image=pred)).item()
        log(f"  {name} at 512² batch 2: loss {val.item():.6g}, gradient max {grad.abs().max().item():.3e}, "
            f"identical images {same}, {ms:.2f} ms per forward + backward, launches {launches} on {card_line}")
        if not (torch.isfinite(val) and torch.isfinite(grad).all() and grad.abs().max() > 0):
            fail(f"phase 7c: {name}'s loss or its gradient through pred_image is not finite and nonzero")
        if same is not None and not abs(same) < 1e-5:
            fail(f"phase 7c: {name} of identical images is {same}, not < 1e-5")
        if any(launches.values()):
            fail(f"phase 7c: {name} launched {launches}; its tower runs the plain versions")
        out["ms"][name] = ms
    del clip, idl, lpips_loss, dreamsim, vit, pred, target, grad
    gc.collect()
    torch.cuda.empty_cache()

    torch.manual_seed(23)
    detector = MTCNN(device="cuda")
    img = (torch.rand(512, 512, 3, generator=torch.Generator().manual_seed(29)) * 255).numpy()
    detector.detect(img)
    t0 = time.perf_counter()
    boxes, probs, lms = detector.detect(img)
    out["mtcnn_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  MTCNN.detect on a 512² image, synthetic weights: {len(boxes)} faces, {out['mtcnn_ms']:.1f} ms (the "
        f"second call) on {card_line}")
    if not (len(boxes) == len(probs) == len(lms) and lms.shape[1:] == (5, 2)):
        fail(f"phase 7c: MTCNN.detect returned {boxes.shape}, {probs.shape}, {lms.shape}")
    return out


# the degraded pair on the card against the same port function on the CPU, same choices and Gaussian draws. Fed the
# CPU run's Poisson counts, the first JPEG's input must agree within CHAIN_TOL ([-1, 1] scale; the ops' own
# difference is ~1e-6) everywhere, and the pair may differ further only by JPEG flips: a DCT coefficient at a
# rounding edge rounds the other way under another summation order and moves its whole 8x8 block (16x16 pixels for
# a chroma block) by up to a quantisation step; the bicubic resize back spreads a flipped lq block over ~36² gt
# pixels. With its own Poisson draws the card draws from rates ~1e-7 away from the CPU's: torch.poisson's rejection
# sampler takes a data-dependent number of uniforms, so a rate that crosses an acceptance edge changes its count and
# every later count of the stream. Measured on an H100 80GB HBM3 (700 W), the traced chain at 1024² (Poisson in both
# noise stages) alone differs past CHAIN_TOL: with its own draws 1.19% of the pixels, max 0.06; fed the counts 0.24%,
# max 0.0036, each JPEG flipping one 8x8 block (the first of an input 6e-8 away). The limits: about three times (own
# draws) and four to six times (fed) those readings.
CHAIN_TOL = 1e-4
CHAIN_FLIP_SHARE, CHAIN_FLIP_MAX = 0.04, 0.2  # own Poisson draws
CHAIN_FED_SHARE, CHAIN_FED_MAX = 0.01, 0.02  # the CPU's Poisson counts
# two JPEG round trips of one input on [0, 1] agree within JPEG_SAME_TOL but for flipped blocks; the least move of
# a flipped coefficient is ~0.0095 q / 255 >= 3.7e-5
JPEG_SAME_TOL = 1e-5


def jpeg_blocks_flipped(torch, got, want):
    """(flipped 8x8 blocks, blocks, share of the pixels past
    ``JPEG_SAME_TOL`` inside the flipped blocks) of two JPEG round trips of
    one input, NHWC: a rounding flip moves a whole block (four of them for a
    chroma block)."""
    diff = (got - want).abs().amax(dim=-1)  # [B, H, W]
    b, h, w = diff.shape
    blocks = (diff > JPEG_SAME_TOL).reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 64)
    flipped = blocks.any(dim=-1)
    inside = float(blocks[flipped].float().mean()) if bool(flipped.any()) else None
    return int(flipped.sum()), flipped.numel(), inside


def chain_recorder(torch, tdeg, call):
    """``recorded(images, kernels, counts=None)``: ``call(images, kernels,
    where)`` with every JPEG round trip's input, quality and output kept
    (on the host) and every Poisson stage's counts drawn in the chain's own
    order (the image's, then its channel mean's) and kept with the state
    they leave the generator in, or, with ``counts``, taken from that list
    instead (the generator then set to the kept state). Returns (the pair,
    the JPEG records, the counts)."""
    real_jpeg, real_poisson = tdeg.jpeg_compress, tdeg.add_poisson_noise

    def recorded(images, kernels, counts=None, where="cpu"):
        jpegs, drawn = [], []
        fed = iter(counts) if counts is not None else None

        def jpeg_spy(img, quality):
            result = real_jpeg(img, quality)
            jpegs.append((img.cpu(), quality.cpu(), result.cpu()))
            return result

        def poisson_spy(img, scale, gray_mask, counts=None, gray_counts=None, generator=None, vals=256.0):
            if fed is not None:
                counts, gray_counts, after = next(fed)
                counts, gray_counts = counts.to(img.device), gray_counts.to(img.device)
                generator.set_state(after)  # where the CPU run's draws left the generator
            else:
                def rate(x):
                    return (torch.clamp(x, 0.0, 1.0) * vals).to(generator.device)

                counts = torch.poisson(rate(img), generator=generator)
                gray_counts = torch.poisson(rate(img.mean(dim=-1, keepdim=True)), generator=generator)
                drawn.append((counts.cpu(), gray_counts.cpu(), generator.get_state()))
            return real_poisson(img, scale, gray_mask, counts, gray_counts, generator, vals)

        tdeg.jpeg_compress, tdeg.add_poisson_noise = jpeg_spy, poisson_spy
        try:
            return call(images, kernels, where), jpegs, drawn
        finally:
            tdeg.jpeg_compress, tdeg.add_poisson_noise = real_jpeg, real_poisson

    return recorded


def pair_errors(torch, got, want, shape, what: str, limits) -> dict:
    """Share of the pixels past CHAIN_TOL and max abs difference of the lq
    and the gt of ``got`` (on the card) against ``want`` (the CPU's); fails
    past ``limits`` (share, max), on another shape or a value that is not
    finite."""
    max_share, max_err = limits
    errs = {}
    for name, g, w in zip(("lq", "gt"), got, want):
        diff = (g.cpu() - w).abs()
        share, peak = float((diff > CHAIN_TOL).float().mean()), float(diff.max())
        errs[name] = (share, peak)
        if tuple(g.shape) != shape or not bool(torch.isfinite(g).all()) or share > max_share or peak > max_err:
            fail(f"phase 7b: {what}'s {name} on the card: shape {tuple(g.shape)}, {share:.2%} of pixels past "
                 f"{CHAIN_TOL} from the CPU's (allowed {max_share:.0%}), max {peak:.3g} (allowed {max_err})")
    return errs


def check_degradation(torch, mods: dict, card_line: str) -> dict:
    """Phase 7b, step 1: the traced and the eager degradation at 512² batch 2
    and 1024² batch 1 on the card against the same call on the CPU (the
    choices from the same seeds, the Gaussian noise from the same CPU
    generator): with the card's own Poisson draws, and fed the CPU's Poisson
    counts (the first JPEG's input then within CHAIN_TOL everywhere); each
    JPEG round trip fed the CPU's own input on the card, its flipped 8x8
    blocks counted. Then ms per call as training runs it (the noise from a
    generator on the card) over 10 calls between CUDA events, the host's
    time beside; no K1-K5 launch."""
    import numpy as np

    from instantir_tpu_torch.data import degradation as tdeg
    from instantir_tpu_torch.data.dataset import SyntheticImageDataset

    out = {}
    for res, bsz in ((512, 2), (1024, 1)):
        deg = tdeg.RealESRGANDegradation(resolution=res)
        host = next(SyntheticImageDataset(seed=res).batches(bsz, res))
        cpu = (torch.from_numpy(host["images"]), tuple(torch.from_numpy(host[k]) for k in
                                                       ("kernel", "kernel2", "sinc_kernel")))
        card = (cpu[0].cuda(), tuple(k.cuda() for k in cpu[1]))
        final = (res // deg.degrade_opt["sf"],) * 2
        for chain in ("traced", "eager"):
            def call(images, kernels, where="cpu", seed=res + 1):
                noise = torch.Generator(device=where).manual_seed(seed)
                if chain == "traced":
                    draws = deg.draw_choices(bsz, final, torch.Generator().manual_seed(seed + 1))
                    return deg.traced_call(images, kernels, draws=draws, device_generator=noise)
                return deg(images, kernels, host_rng=np.random.default_rng(seed), generator=noise)

            recorded = chain_recorder(torch, tdeg, call)
            what = f"the {chain} chain at {res}²"
            want, want_jpeg, counts = recorded(*cpu)
            zero_counters(mods)
            own = pair_errors(torch, call(*card), want, (bsz, res, res, 3), what + " (its own Poisson draws)",
                              (CHAIN_FLIP_SHARE, CHAIN_FLIP_MAX))
            got, got_jpeg, _ = recorded(*card, counts=counts)
            fed = pair_errors(torch, got, want, (bsz, res, res, 3), what + " (the CPU's Poisson counts)",
                              (CHAIN_FED_SHARE, CHAIN_FED_MAX))
            # fed: each JPEG's input against the CPU's, and the 8x8 blocks its output flipped
            fed_jpegs = [(float((g[0] - w[0]).abs().max()), jpeg_blocks_flipped(torch, g[2], w[2])[0])
                         for g, w in zip(got_jpeg, want_jpeg)]
            torch.cuda.synchronize()
            first_in = float((got_jpeg[0][0] - want_jpeg[0][0]).abs().max())
            if first_in > CHAIN_TOL:
                fail(f"phase 7b: {what}, fed the CPU's Poisson counts: the first JPEG's input differs from the "
                     f"CPU's by {first_in:.3g} (allowed {CHAIN_TOL} everywhere)")
            flips = []
            for img, quality, result in want_jpeg:
                again = tdeg.jpeg_compress(img.cuda(), quality.cuda()).cpu()
                n, total, inside = jpeg_blocks_flipped(torch, again, result)
                flips.append({"flipped": n, "blocks": total, "inside": inside,
                              "max": float((again - result).abs().max())})
            if any(f["max"] > CHAIN_FLIP_MAX / 2 for f in flips):
                fail(f"phase 7b: {what}: a JPEG round trip of the CPU's input on the card moves a pixel further "
                     f"than a quantisation step allows ({flips})")
            ms = time_ms(torch, lambda: call(*card, where="cuda"), iters=10, warmup=2, groups=1)
            t0 = time.perf_counter()
            for _ in range(10):
                call(*card, where="cuda")
            host_ms = (time.perf_counter() - t0) * 100.0
            torch.cuda.synchronize()
            launches = read_counters(mods)
            if any(launches.values()):
                fail(f"phase 7b: the degradation launched {launches}")
            out[f"{chain}_{res}"] = {"ms": ms, "host_ms": host_ms, "max_abs_err": own["lq"][1], "own_draws": own,
                                     "fed_counts": fed, "fed_jpegs": fed_jpegs, "poisson_stages": len(counts),
                                     "first_jpeg_input_err": first_in, "jpeg_flips": flips}

            def fmt(errs):
                return ", ".join(f"{k} {v[0]:.4%} past {CHAIN_TOL}, max {v[1]:.3g}" for k, v in errs.items())

            log(f"  {chain} degradation {res}² batch {bsz}: {ms:.2f} ms per call (10 calls between CUDA events), "
                f"{host_ms:.2f} ms of host time per call; {len(counts)} Poisson stage(s); against the CPU with "
                f"its own Poisson draws: {fmt(own)}; fed the CPU's counts: {fmt(fed)}, each JPEG's input max and "
                f"its output's flipped 8x8 blocks {[(float('%.3g' % e), n) for e, n in fed_jpegs]}; the JPEG round trips fed the CPU's input: flipped 8x8 blocks "
                f"{[(f['flipped'], f['blocks']) for f in flips]} ({[f['inside'] and round(f['inside'], 3) for f in flips]}"
                f" of their pixels past {JPEG_SAME_TOL}, max {[round(f['max'], 4) for f in flips]}); no K1-K5 "
                f"launch; on {card_line}")
    return out


def cli_train(torch, argv: list, pipe, mods: dict, per_step: dict, steps: int, pred, what: str, card_line: str,
              before_train: Optional[dict] = None, extra: Optional[dict] = None) -> dict:
    """``cli.train.main(argv, pipe=pipe)`` with every counter set to 0 just
    before and read just after: the launches must be ``steps`` x
    ``per_step`` (plus ``extra``: the validation renders'), every trainable master (the stage's ``pred``) must move
    from ``before_train`` (default: the leaves' values before the run, a
    fresh trainer's masters) and no frozen leaf may change."""
    import contextlib
    import io

    from instantir_tpu_torch.cli import train as cli
    from instantir_tpu_torch.train.common import named_parameters

    models = {"unet": pipe.unet, "resampler": pipe.resampler, "vae": pipe.vae, "image_encoder": pipe.image_encoder}
    if argv[0] == "stage2":
        models["aggregator"] = pipe.aggregator
    named = named_parameters(models)
    trainable = {n: p for n, p in named.items() if pred(tuple(n.split(".")))}
    frozen = {n: p for n, p in named.items() if n not in trainable}
    if before_train is None:
        before_train = _checksums(torch, {n: p.float() for n, p in trainable.items()})
    before_frozen = _checksums(torch, frozen)
    text = io.StringIO()
    zero_counters(mods)
    t0 = time.time()
    with contextlib.redirect_stdout(text):
        result = cli.main(argv, pipe=pipe)
    torch.cuda.synchronize()
    sec = time.time() - t0
    launches = read_counters(mods)
    for line in text.getvalue().rstrip().splitlines():
        log(f"    | {line}")
    want = every_counter({k: n * steps + (extra or {}).get(k, 0) for k, n in per_step.items()})
    if launches != want:
        fail(f"phase 7b, {what}: kernel launches {launches}, derived {steps} x {per_step} + {extra}")
    trainer = result["trainer"]
    if trainer.global_step != int(argv[argv.index("--max_train_steps") + 1]):
        fail(f"phase 7b, {what}: the run ended at step {trainer.global_step}")
    check_leaves(torch, before_train, before_frozen, dict(zip(trainer.trainable_names, trainer.optimizer.masters)),
                 frozen, what)
    saves = [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in s.items()} for s in trainer.ckpt.saves]
    log(f"  {what}: {sec:.2f} s for the run and its export, launches {launches}, checkpoint writes {saves}; on "
        f"{card_line}")
    return {"result": result, "text": text.getvalue(), "sec": sec, "launches": launches, "saves": saves}


def tree_differences(torch, live, saved, path: str = "") -> list:
    """The paths at which ``saved`` (a checkpoint read back, CPU tensors)
    differs from ``live`` (the trainer's ``checkpoint_state``): keys, types,
    dtypes, shapes or any bit of a tensor."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(live) != set(saved):
            return [f"{path}: keys"]
        return [d for k in live for d in tree_differences(torch, live[k], saved[k], f"{path}/{k}")]
    if isinstance(live, torch.Tensor):
        same = (isinstance(saved, torch.Tensor) and saved.dtype == live.dtype and saved.shape == live.shape
                and torch.equal(saved.to(live.device), live))
        return [] if same else [path]
    return [] if live == saved else [path]


def restore_checked(torch, trainer, step: int, what: str, card_line: str) -> dict:
    """``checkpoint-{step}`` read back into the run's own trainer: every
    entry of its state (the masters, the AdamW count and moments, the step,
    stage 2's EMA adapter) must equal the trainer's ``checkpoint_state``
    bitwise; seconds to read the file and to put the state back on the card."""
    live = trainer.checkpoint_state()
    t0 = time.time()
    state = trainer.ckpt.restore(step)
    read = time.time() - t0
    bad = tree_differences(torch, live, state)
    if bad:
        fail(f"phase 7b, {what}: checkpoint-{step} differs from the trainer's state at {bad[:5]}")
    t0 = time.time()
    trainer.load_checkpoint_state(state)
    torch.cuda.synchronize()
    put = time.time() - t0
    log(f"  {what}: checkpoint-{step} read in {read:.2f} s and put back in {put:.2f} s; its "
        f"{sorted(state)} equal the trainer's state bitwise ({len(state['trainable'])} masters, "
        f"{len(state['opt_state']['adamw'])} moment pairs"
        f"{', %d EMA tensors' % len(state['ema_adapter']) if 'ema_adapter' in state else ''}); on {card_line}")
    return {"read_seconds": read, "put_back_seconds": put}


def write_image_folder(root: str) -> str:
    """Eight PNGs of mixed sizes under ``root/photos`` (captions in
    ``metadata.jsonl`` for five, ``.txt`` sidecars for two, none for one) and
    a data config naming the folder; returns the config's path."""
    import numpy as np

    folder = os.path.join(root, "photos")
    os.makedirs(folder)
    rng = np.random.default_rng(11)
    sizes = [(512, 512), (600, 520), (768, 512), (520, 700), (1024, 640), (530, 530), (640, 960), (700, 560)]
    meta = []
    for i, (w, h) in enumerate(sizes):
        low = rng.uniform(size=(h // 32 + 1, w // 32 + 1, 3))
        img = np.kron(low, np.ones((32, 32, 1)))[:h, :w]
        write_png(os.path.join(folder, f"p{i}.png"), (img * 255).astype(np.uint8))
        if i < 5:
            meta.append({"file_name": f"p{i}.png", "text": f"photo number {i}"})
        elif i < 7:
            with open(os.path.join(folder, f"p{i}.txt"), "w") as f:
                f.write(f"sidecar caption {i}\n")
    with open(os.path.join(folder, "metadata.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(m) for m in meta) + "\n")
    config = os.path.join(root, "data.yaml")
    with open(config, "w") as f:
        f.write("# one folder of photographs\ndatasets:\n  - dataset_folder: 'photos'\n    dataset_weight: 1.0\n")
    return config


def validation_checked(torch, trainer, val: dict, cond: dict, tag: str, expected: dict, what: str, mods: dict,
                       card_line: str) -> float:
    """The validation render of a ``cli.train`` run: ``last_validation``
    holds uint8 strips ``(N, 24 + H, 3·H, 3)`` and the event file a ``tag``
    image; then one more render between counter reads, its launches
    ``expected`` (derived from ``Stage1Config`` / ``RestoreConfig``).
    Returns its seconds."""
    import numpy as np

    n, h = val["lq"].shape[0], val["lq"].shape[1]
    strips = trainer.last_validation
    if strips is None or strips.shape != (n, h + 24, 3 * h, 3) or strips.dtype != np.uint8:
        fail(f"phase 7b, {what}: the run's validation strips are "
             f"{None if strips is None else (strips.shape, strips.dtype)}, not uint8 {(n, h + 24, 3 * h, 3)}")
    with open(trainer.tracker.writer.path, "rb") as f:
        if tag.encode() not in f.read():
            fail(f"phase 7b, {what}: the event file {trainer.tracker.writer.path} holds no {tag} image")
    zero_counters(mods)
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.validate(val, cond)
    torch.cuda.synchronize()
    sec = time.time() - t0
    launches = read_counters(mods)
    if launches != every_counter(expected):
        fail(f"phase 7b, {what}: the validation render launched {launches}, derived {every_counter(expected)}")
    log(f"  {what}: the run logged {tag} strips {strips.shape}; a render of the {n} validation images {sec:.3f} s, "
        f"launches {launches} (derived); on {card_line}")
    return sec


def run_train_cli(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 7b: training from raw images on phase 4's bf16 models, with
    cuDNN's TF32 switch at its default (on) as a user's run has it: the
    degradation on the card (``check_degradation``), stage 1 through
    ``cli.train.main`` (2 steps with a checkpoint every 2 and a limit of 1,
    resumed to 4; the restored state equals the saved one bitwise;
    ``adapter_ckpt.pt`` maps strictly onto the models), stage 1 from a
    folder of PNGs, the previewer (``config_files/losses.yaml``) and stage 2
    (a fresh Aggregator; one async checkpoint; the EMA adapter), then stage
    1's s/step of ``run`` with ``prefetch_batches`` 0 and 2 in turns beside
    the bare ``train_step``. Every launch count derived; checkpoints under a
    temporary directory, deleted at the end."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return train_cli_phases(torch, pipe, ucfg, mods, card_line)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32


def train_cli_phases(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """The body of ``run_train_cli``."""
    import tempfile

    from instantir_tpu_torch import convert
    from instantir_tpu_torch.cli import train as cli_mod
    from instantir_tpu_torch.models.aggregator import Aggregator
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, build_step_phases
    from instantir_tpu_torch.train.common import quantize_frozen_unet
    from instantir_tpu_torch.train.previewer_lora import lora_trainable_pred
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer, stage1_trainable_pred
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, stage2_trainable_pred

    out = {"chain": check_degradation(torch, mods, card_line)}
    fused = mods["group_norm"].USE_FUSED

    def derived(counts: dict) -> dict:
        counts = every_counter(counts)
        if not fused:
            counts["group_norm_silu"] = 0
        return counts

    s1_step = derived(expected_train_launches(ucfg, 512 // 8, checkpointing=False))
    # the validation renders at 512², batch 2: stage 1 samples 30 steps (Stage1Config: one UNet forward a step) and
    # decodes, the previewer encodes, takes one UNet forward and decodes (the fp32 VAE's K5 each), stage 2
    # restores with config #4 at 30 steps (RestoreConfig)
    unet_fwd, _ = forward_launches(ucfg, 512 // 8)
    val_cfg = restore_config(30)
    dec512 = vae_train_k5(512 // 8, encodes=0, decodes=1)
    val_launches = {"stage1": derived({k: 30 * n + (dec512 if k == "group_norm_silu" else 0)
                                       for k, n in unet_fwd.items()}),
                    "previewer": derived({k: n + (vae_train_k5(512 // 8, 1, 1) if k == "group_norm_silu" else 0)
                                          for k, n in unet_fwd.items()}),
                    "stage2": derived(expected_restore_launches(ucfg, val_cfg, build_step_phases(val_cfg), 512 // 8))}
    out["validation_sec"] = {}
    g = torch.Generator(device="cuda").manual_seed(23)
    val_cond = training_batch(torch, g, 2, 512, torch.bfloat16)[1]
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free = shutil.disk_usage(root).free
    if free < 40e9:
        fail(f"phase 7b: the checkpoints need 40 GB, {root} has {free / 1e9:.2f} GB free")
    losses = str(REPO / "config_files" / "losses.yaml")
    common_flags = ["--resolution", "512", "--train_batch_size", "2", "--lr_warmup_steps", "0", "--losses_config",
                    losses]
    try:
        val_dir = os.path.join(root, "val")
        os.makedirs(val_dir)
        rng = torch.Generator().manual_seed(29)
        val_pngs = []
        for name, (w, h) in (("v0.png", (640, 480)), ("v1.png", (512, 512))):
            val_pngs.append(os.path.join(val_dir, name))
            write_png(val_pngs[-1], (torch.rand(h, w, 3, generator=rng) * 255).to(torch.uint8).numpy())
        val_flags = ["--validation_steps", "2", "--validation_image", *val_pngs]
        val = cli_mod._val_batch(cli_mod.build_parser().parse_args(["stage1", "--resolution", "512", *val_flags]))

        s1_dir = os.path.join(root, "stage1")
        flags = ["stage1", "--synthetic_data", *common_flags, "--checkpointing_steps", "2",
                 "--checkpoints_total_limit", "1", "--prefetch_batches", "2", "--output_dir", s1_dir]
        run = cli_train(torch, flags + ["--max_train_steps", "2", *val_flags], pipe, mods, s1_step, 2,
                        stage1_trainable_pred, "stage-1 CLI, 2 steps, validation at step 2", card_line,
                        extra=val_launches["stage1"])
        out["validation_sec"]["stage1"] = validation_checked(
            torch, run["result"]["trainer"], val, val_cond, "validation/stage1", val_launches["stage1"],
            "stage-1 validation (30 steps, CFG 5)", mods, card_line)
        out["launches_stage1"] = dict(run["launches"])
        out["stage1_saves"] = run["saves"]
        first = run["result"]["trainer"]
        del run
        if sorted(d for d in os.listdir(s1_dir) if d.startswith("checkpoint-")) != ["checkpoint-2"]:
            fail(f"phase 7b: the stage-1 run left {sorted(os.listdir(s1_dir))}, not checkpoint-2 alone")

        # the resume on a trainer of its own: its state bitwise the one the first run saved
        cfg = Stage1Config(output_dir=s1_dir, train_batch_size=2, resolution=512, lr_warmup_steps=0)
        trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
        t0 = time.time()
        step = trainer.resume()
        torch.cuda.synchronize()
        out["resume_sec"] = time.time() - t0
        bad = tree_differences(torch, first.checkpoint_state(), trainer.checkpoint_state())
        if bad or step != 2:
            fail(f"phase 7b: resumed at step {step}; the resumed state differs from the saved one at {bad[:5]}")
        before = _checksums(torch, dict(zip(trainer.trainable_names, trainer.optimizer.masters)))
        log(f"  resume: checkpoint-2 ({out['stage1_saves'][-1]['bytes'] / 1e9:.2f} GB of masters and moments) read "
            f"and put back in {out['resume_sec']:.2f} s; the {len(trainer.trainable_names)} masters, their moments, "
            "the count and the step equal the ones the first run saved, bitwise")
        del trainer, first
        gc.collect()
        torch.cuda.empty_cache()
        run = cli_train(torch, flags + ["--max_train_steps", "4"], pipe, mods, s1_step, 2, stage1_trainable_pred,
                        "stage-1 CLI resumed to 4 steps", card_line, before_train=before)
        if "resumed from checkpoint-2" not in run["text"]:
            fail("phase 7b: the second stage-1 run did not resume from checkpoint-2")
        if sorted(d for d in os.listdir(s1_dir) if d.startswith("checkpoint-")) != ["checkpoint-4"]:
            fail(f"phase 7b: the resumed stage-1 run left {sorted(os.listdir(s1_dir))}, not checkpoint-4 alone")
        out["launches_stage1"] = {k: n + run["launches"][k] for k, n in out["launches_stage1"].items()}
        out["stage1_saves"] += run["saves"]
        del run
        gc.collect()
        torch.cuda.empty_cache()
        payload = torch.load(os.path.join(s1_dir, "adapter_ckpt.pt"), map_location="cpu", weights_only=True)
        mapped = convert.import_ip_adapter(payload["ip_adapter"], [n for n, _ in pipe.unet.named_parameters()],
                                           strict=True)
        res_names = {n for n in pipe.resampler.state_dict() if "lora_" not in n}
        if set(payload["image_proj"]) != res_names or not mapped:
            fail("phase 7b: adapter_ckpt.pt does not map strictly onto the Resampler and the UNet")
        log(f"  adapter_ckpt.pt maps strictly: {len(payload['image_proj'])} Resampler and {len(mapped)} UNet tensors")
        del payload, mapped
        shutil.rmtree(s1_dir)

        # stage 1 with 8-bit Adam and the W8 frozen UNet (on a copy of the UNet, quantized before the run so
        # that the frozen leaves checked are the run's), a checkpoint at 2, resumed bitwise
        qpipe = InstantIRPipeline(copy.deepcopy(pipe.unet), None, pipe.vae, pipe.resampler, pipe.image_encoder,
                                  pipe.schedule, device="cuda")
        quantize_frozen_unet(qpipe.unet, keep_pred=stage1_trainable_pred)
        q_dir = os.path.join(root, "stage1_qlora")
        q_flags = ["stage1", "--synthetic_data", *common_flags, "--checkpointing_steps", "2",
                   "--checkpoints_total_limit", "1", "--use_8bit_adam", "--quantize_frozen_unet", "--output_dir",
                   q_dir, "--max_train_steps", "2"]
        run = cli_train(torch, q_flags, qpipe, mods, s1_step, 2, stage1_trainable_pred,
                        "stage-1 CLI, 8-bit Adam and the W8 frozen UNet, 2 steps", card_line)
        first = run["result"]["trainer"]
        out["launches_qlora_cli"], out["qlora_saves"] = run["launches"], run["saves"]
        del run
        cfg = Stage1Config(output_dir=q_dir, train_batch_size=2, resolution=512, lr_warmup_steps=0,
                           use_8bit_adam=True, quantize_frozen_unet=True)
        trainer = Stage1Trainer(qpipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
        t0 = time.time()
        step = trainer.resume()
        torch.cuda.synchronize()
        out["qlora_resume_sec"] = time.time() - t0
        bad = tree_differences(torch, first.checkpoint_state(), trainer.checkpoint_state())
        if bad or step != 2 or trainer.optimizer.mu_q.dtype != torch.int8:
            fail(f"phase 7b: the 8-bit run resumed at step {step}; its state differs from the saved one at {bad[:5]}")
        n_train = sum(p.numel() for p in trainer.trainable)
        log(f"  8-bit resume: checkpoint-2 ({out['qlora_saves'][-1]['bytes'] / 1e9:.2f} GB, "
            f"{out['qlora_saves'][-1]['bytes'] / n_train:.2f} bytes a trainable value) read and put back in "
            f"{out['qlora_resume_sec']:.2f} s; masters, int8 moments and scales, count and step bitwise the saved ones")
        del trainer, first, qpipe
        shutil.rmtree(q_dir)
        gc.collect()
        torch.cuda.empty_cache()

        # stage 1 from a folder of PNGs (Pillow decode, captions, the port's YAML reader)
        config = write_image_folder(root)
        run = cli_train(torch, ["stage1", "--data_config", config, "--data_dir", root, *common_flags,
                                "--max_train_steps", "2", "--output_dir", os.path.join(root, "folder")],
                        pipe, mods, s1_step, 2, stage1_trainable_pred, "stage-1 CLI from 8 PNGs, 2 steps", card_line)
        out["launches_stage1"] = {k: n + run["launches"][k] for k, n in out["launches_stage1"].items()}
        del run
        shutil.rmtree(os.path.join(root, "folder"))
        gc.collect()
        torch.cuda.empty_cache()

        # the previewer, its losses from config_files/losses.yaml
        pv_dir = os.path.join(root, "previewer")
        run = cli_train(torch, ["previewer", "--synthetic_data", *common_flags, "--max_train_steps", "2",
                                "--output_dir", pv_dir, *val_flags],
                        pipe, mods, derived(expected_previewer_launches(ucfg, 512 // 8, False)), 2,
                        lora_trainable_pred, "previewer CLI, 2 steps, validation at step 2", card_line,
                        extra=val_launches["previewer"])
        out["validation_sec"]["previewer"] = validation_checked(
            torch, run["result"]["trainer"], val, val_cond, "validation/previewer_one_step",
            val_launches["previewer"], "previewer validation (one step at t = 999)", mods, card_line)
        lora = torch.load(os.path.join(pv_dir, "previewer_lora_weights.bin"), map_location="cpu", weights_only=True)
        if set(lora) != set(run["result"]["trainer"].lora_state()):
            fail("phase 7b: previewer_lora_weights.bin holds other tensors than the trainer's LoRA")
        out["previewer_restore"] = restore_checked(torch, run["result"]["trainer"], 2, "previewer", card_line)
        out["launches_previewer"], out["previewer_saves"] = run["launches"], run["saves"]
        del run, lora
        shutil.rmtree(pv_dir)
        gc.collect()
        torch.cuda.empty_cache()

        # stage 2 on a fresh Aggregator (phase 6 freed the first), checkpoints written from a thread
        pipe.aggregator = synthesize_weights(Aggregator(ucfg, dtype=torch.bfloat16, device="cuda").requires_grad_(False)
                                             .eval(), torch.Generator(device="cuda").manual_seed(13))
        s2_dir = os.path.join(root, "stage2")
        s2_flags = ["stage2", "--synthetic_data", *common_flags, "--max_train_steps", "2", "--checkpointing_steps",
                    "2", "--checkpoints_total_limit", "1", "--async_checkpointing", "--use_ema_adapter",
                    "--output_dir", s2_dir, *val_flags]
        s2cfg = Stage2Config(optimize_adapter=False, cfg_scale=1.0)
        run = cli_train(torch, s2_flags, pipe, mods, derived(expected_stage2_launches(ucfg, s2cfg, 512 // 8, False)),
                        2, stage2_trainable_pred(s2cfg), "stage-2 CLI, 2 steps, async checkpoints, validation at "
                        "step 2", card_line, extra=val_launches["stage2"])
        out["validation_sec"]["stage2"] = validation_checked(
            torch, run["result"]["trainer"], val, val_cond, "validation/instantir", val_launches["stage2"],
            "stage-2 validation (config #4, 30 steps)", mods, card_line)
        for name in ("aggregator.pt", "instantir_config.json", "checkpoint-2"):
            if not os.path.exists(os.path.join(s2_dir, name)):
                fail(f"phase 7b: the stage-2 run wrote no {name}")
        out["stage2_restore"] = restore_checked(torch, run["result"]["trainer"], 2, "stage 2", card_line)
        out["launches_stage2"], out["stage2_saves"] = run["launches"], run["saves"]
        del run
        shutil.rmtree(s2_dir)
        del pipe.aggregator
        gc.collect()
        torch.cuda.empty_cache()

        out.update(run_turns(torch, pipe, mods, s1_step, card_line))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def clone_tree(torch, tree):
    """A copy of ``tree`` (dicts of tensors and scalars), each tensor cloned where it lies."""
    if isinstance(tree, dict):
        return {k: clone_tree(torch, v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def run_turns(torch, pipe, mods: dict, s1_step: dict, card_line: str, steps: int = 3) -> dict:
    """Phase 7b, step 6: stage-1 s/step of ``run`` (logging every step, so
    each step ends on the host reading its metrics) with
    ``prefetch_batches`` 0 and 2 in turns (0, 2, 2, 0), beside the bare
    ``train_step`` on an already degraded batch (first and last); no
    checkpoints (no output directory). The first step of each turn fills the
    pipeline and is left out. Every turn starts from the same state (masters,
    moments, step, the step's generator) and the same data, under the
    caller's cuDNN TF32 setting (the card's default, on, in phase 7b): its
    masters after the turn must equal the first turn's bitwise, so the
    prefetch changes nothing that a step computes."""
    from instantir_tpu_torch.cli import train as cli
    from instantir_tpu_torch.data.dataset import SyntheticImageDataset
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

    cfg = Stage1Config(output_dir="", train_batch_size=2, resolution=512, lr_warmup_steps=0, logging_steps=1,
                       max_train_steps=0)
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cuda")
    cond = cli._conditioning(cli.build_parser().parse_args(["stage1", "--resolution", "512"]), pipe, 2)
    batch = trainer.prepare_batch(next(SyntheticImageDataset(seed=21).batches(2, 512)), cond)
    bare, turns = [], {0: [], 2: []}

    def bare_steps():
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            float(metrics["loss"])
            bare.append(time.perf_counter() - t0)

    zero_counters(mods)
    bare_steps()
    start, start_rng = clone_tree(torch, trainer.checkpoint_state()), trainer._generator.get_state()
    first = None
    for depth in (0, 2, 2, 0):
        trainer.load_checkpoint_state(start)
        trainer._generator.set_state(start_rng)
        cfg.prefetch_batches = depth
        cfg.max_train_steps = trainer.global_step + steps
        records = trainer.run(SyntheticImageDataset(seed=22).batches(2, 512), cond)
        turns[depth].append([1.0 / r["steps_per_sec"] for r in records[1:]])
        if first is None:
            first = [m.clone() for m in trainer.optimizer.masters]
            continue
        moved = [n for n, a, b in zip(trainer.trainable_names, first, trainer.optimizer.masters) if not torch.equal(a, b)]
        if moved:
            fail(f"phase 7b, s/step turns: after the turn with prefetch {depth} {len(moved)} masters differ from the "
                 f"first turn's (prefetch 0), e.g. {moved[:3]}")
    bare_steps()
    launches = read_counters(mods)
    want = every_counter({k: n * steps * 6 for k, n in s1_step.items()})
    if launches != want:
        fail(f"phase 7b, s/step turns: kernel launches {launches}, derived {steps * 6} x {s1_step}")
    med = {name: statistics.median(v) for name, v in (("bare", bare[1:steps] + bare[steps + 1:]),
                                                      ("prefetch_0", sum(turns[0], [])),
                                                      ("prefetch_2", sum(turns[2], [])))}
    log(f"  stage-1 s/step at 512² batch 2, medians: bare train_step {med['bare']:.4f}, run with prefetch 0 "
        f"{med['prefetch_0']:.4f}, with prefetch 2 {med['prefetch_2']:.4f} (turns 0, 2, 2, 0: "
        f"{[[round(x, 4) for x in t] for t in turns[0][:1] + turns[2] + turns[0][1:]]}; bare "
        f"{[round(x, 4) for x in bare]}); every turn from the same state: the masters after each equal the first "
        f"turn's bitwise (cuDNN TF32 {torch.backends.cudnn.allow_tf32}); launches {launches}; on {card_line}")
    del trainer, batch, start, first
    return {"turns": med, "launches_turns": launches}


def run_fp32(torch, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 8: the default (fp32) ``build_pipeline`` restores a 512² image in
    4 steps, then one fp32 ``Stage1Trainer`` step at 512², batch 1; both
    through the fp32 flash entry points and K5 (fp32 UNet, Aggregator and VAE
    GroupNorms), counts derived from the config."""
    from instantir_tpu_torch.models.dinov2 import dinov2_large_config
    from instantir_tpu_torch.models.resampler import instantir_resampler_config
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import build_step_phases
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

    res, lat = F32_RES, F32_RES // 8
    t0 = time.time()
    pipe = build_pipeline(ucfg, sdxl_vae_config(), instantir_resampler_config(lora_rank=64), dinov2_large_config(),
                          seed=0, device="cuda")
    torch.cuda.synchronize()
    dtypes = {p.dtype for m in (pipe.unet, pipe.aggregator, pipe.resampler, pipe.image_encoder) for p in m.parameters()}
    if dtypes != {torch.float32}:
        fail(f"build_pipeline's default dtype built {dtypes}, expected fp32")
    log(f"  built the default (fp32) SDXL-width pipeline in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    cfg = restore_config(4)
    phases = build_step_phases(cfg)
    by_seq = flash_launches_by_seq(phases, flash_calls_per_forward(ucfg, lat, lat, with_up=True),
                                   flash_calls_per_forward(ucfg, lat, lat, with_up=False, concat=2))
    fused = mods["group_norm"].USE_FUSED
    # K5: the fp32 UNet's and Aggregator's norms and the VAE's encode and decode
    expected = every_counter({"flash_attention_fwd_f32": sum(by_seq.values()), "group_norm_silu": sum(
        group_norm_launches_by_shape(ucfg, phases, lat).values()) + vae_restore_k5(cfg, res, res) if fused else 0})
    g = torch.Generator(device="cuda").manual_seed(6)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1
    pooled = torch.randn(1, 1280, generator=g, device="cuda") * 0.1
    out = {"by_seq": by_seq, "restore_sec": []}
    for i in range(2):  # the first call includes warm-up
        zero_counters(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        image, _ = pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt",
                                generator=torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        out["restore_sec"].append(time.time() - t0)
        out["restore"] = read_counters(mods)
        log(f"  fp32 restore {res}² 4 steps ({i + 1}/2): {out['restore_sec'][-1]:.3f} s/image, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {out['restore']} on {card_line}")
        if out["restore"] != expected:
            fail(f"fp32 restore: kernel launches {out['restore']} differ from the counts derived from the config "
                 f"{expected}")
        if tuple(image.shape) != (1, res, res, 3) or image.dtype != torch.float32 or not torch.isfinite(image).all():
            fail(f"fp32 restore: the image is not finite fp32 RGB of shape (1, {res}, {res}, 3): "
                 f"{tuple(image.shape)} {image.dtype}")
    out["peak_gb_restore"] = torch.cuda.max_memory_allocated() / 1e9

    del pipe.aggregator  # stage 1 trains without it
    torch.cuda.empty_cache()
    scfg = Stage1Config(train_batch_size=1, resolution=res, lr_warmup_steps=0, max_train_steps=1000, output_dir="")
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, scfg, device="cuda")
    expected = as_f32(expected_train_launches(ucfg, lat, checkpointing=False))
    if not fused:
        expected["group_norm_silu"] = 0
    batch = trainer.prepare_batch(*training_batch(torch, g, 1, res, torch.float32))
    out["train"], out["train_sec"], _ = train_step_checked(
        torch, trainer, batch, g, mods, expected, f"fp32 stage-1 train_step at {res}² batch 1", card_line)
    out["peak_gb_train"] = torch.cuda.max_memory_allocated() / 1e9
    return out


@contextlib.contextmanager
def one_rank_group(torch):
    """torchrun's environment for one process (``MASTER_ADDR`` / ``MASTER_PORT``
    on a free local port, ``WORLD_SIZE`` 1, ``RANK`` and ``LOCAL_RANK`` 0),
    under which ``parallel.initialize_distributed`` joins an NCCL group of one
    rank; at the end the group is destroyed and the environment put back, so
    that the other phases run without a group."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ring_counter(torch):
    """Wrap ``parallel.ring_attention.ring_attention`` to record each call's
    (batch, global sequence, heads); returns (calls, restore)."""
    from instantir_tpu_torch.parallel import ring_attention as ring
    from instantir_tpu_torch.parallel.mesh import axis_size

    orig, calls = ring.ring_attention, []

    def counting(q, k, v, mesh, axis="data", scale=None):
        calls.append((q.shape[0], q.shape[1] * axis_size(mesh, axis), q.shape[2]))
        return orig(q, k, v, mesh, axis=axis, scale=scale)

    ring.ring_attention = counting

    def restore():
        ring.ring_attention = orig

    return calls, restore


def check_ring(torch, attention, shapes, card_line: str) -> None:
    """The ring (``parallel/ring_attention.py``) on CUDA tensors, forward and
    backward, on a one-rank NCCL group at ``shapes`` (B, S, H), head_dim 64,
    bf16, against ``flash_attention_diff`` on the same inputs. At one rank the
    ring is one block: K2's forward, and K3/K4's backward from K2's lse taken
    to the natural log for the merge and back, so the output is K2's own and
    the gradients agree within ``GRAD_TOL`` of the largest reference value
    (bitwise where that round trip is exact)."""
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh
    from instantir_tpu_torch.parallel import ring_attention as ring

    scale = 64 ** -0.5
    with one_rank_group(torch):
        initialize_distributed(device="cuda")
        mesh = make_mesh(device="cuda")
        for b, s, h in shapes:
            g = torch.Generator(device="cuda").manual_seed(s + h)
            q, k, v, do = (torch.randn((b, s, h, 64), generator=g, device="cuda", dtype=torch.bfloat16)
                           for _ in range(4))

            def run(fn):
                x = [t.clone().requires_grad_(True) for t in (q, k, v)]
                o = fn(*x)
                o.backward(do)
                return [o.detach()] + [t.grad for t in x]

            got = run(lambda q, k, v: ring.ring_attention(q, k, v, mesh, scale=scale))
            want = run(lambda q, k, v: attention.flash_attention_diff(q, k, v, scale))
            torch.cuda.synchronize()
            errs = [((a.float() - w.float()).abs().max() / (w.float().abs().max() if i else 1.0)).item()
                    for i, (a, w) in enumerate(zip(got, want))]
            exact = all(torch.equal(a, w) for a, w in zip(got, want))
            log(f"  ring_attention at one rank ({torch.distributed.get_backend()}), {(b, s, h)} bf16: output max abs "
                f"{errs[0]:.3e} (tolerance {FLASH_TOL}), dq/dk/dv max abs over the largest {errs[1]:.3e} / "
                f"{errs[2]:.3e} / {errs[3]:.3e} (tolerance {GRAD_TOL}) against flash_attention_diff; bitwise: "
                f"{exact}; on {card_line}")
            if not all(torch.isfinite(t).all() for t in got) or errs[0] > FLASH_TOL or max(errs[1:]) > GRAD_TOL:
                fail(f"phase 3: ring_attention at {(b, s, h)} on CUDA tensors differs from flash_attention_diff: {errs}")
            del q, k, v, do, got, want


def sp_launches(cfg, ucfg, lat: int, min_seq: int, batch: int = 2):
    """(K1 and K5 counts, ring calls by (B, S, H)) of a sequence-parallel restore
    at ``lat``² latents on one rank: every self-attention of at least
    ``min_seq`` tokens rings (one K2 launch each at one rank), the rest stay
    on K1; the GroupNorms are the dense restore's."""
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    phases = build_step_phases(cfg)
    unet = flash_calls_per_forward(ucfg, lat, lat, with_up=True)
    agg = flash_calls_per_forward(ucfg, lat, lat, with_up=False, concat=2)
    by_seq = flash_launches_by_seq(phases, unet, agg)
    heads = {**heads_by_seq(ucfg, lat), **heads_by_seq(ucfg, lat, concat=2)}
    rung = {(batch, s, heads[s]): n for s, n in by_seq.items() if s >= min_seq}
    dense = expected_restore_launches(ucfg, cfg, phases, lat)
    k1 = {(batch, s, heads[s]): n for s, n in by_seq.items() if s < min_seq}
    return dict(dense, flash_attention_fwd=sum(k1.values()), flash_attention_fwd_lse=sum(rung.values())), rung, k1


def run_cli_sequence_parallel(torch, pipe, paths: dict, towers, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4c's tree, after 4g: ``cli.infer.main --sequence_parallel`` at
    1024², 4 steps, one rank under torchrun's environment for one process
    (``one_rank_group``), on phase 4's models and the tree's text towers: the
    Aggregator's 8192-token maps ring (one K2 launch each), the UNet's stay on
    K1, every count derived; the PNG finite RGB of its size."""
    import tempfile

    import numpy as np

    from instantir_tpu_torch.cli import infer
    from instantir_tpu_torch.utils.tokenizer import CLIPTokenizer

    res = 1024
    root = tempfile.mkdtemp(prefix="cli_sp_")
    try:
        lq_dir, out_dir = os.path.join(root, "lq"), os.path.join(root, "out")
        os.makedirs(lq_dir)
        rgb = (torch.rand(res, res, 3, generator=torch.Generator().manual_seed(23)) * 255).to(torch.uint8).numpy()
        write_png(os.path.join(lq_dir, "a.png"), rgb)
        argv = ["--sdxl_path", paths["sdxl"], "--instantir_path", paths["instantir"], "--vision_encoder_path",
                paths["dinov2"], "--test_path", lq_dir, "--out_path", out_dir, "--sequence_parallel",
                "--num_inference_steps", "4", "--batch_size", "1"]
        cli_cfg = infer.restore_config(infer.build_parser().parse_args(argv))
        want, rung, _ = sp_launches(cli_cfg, ucfg, res // 8, cli_cfg.sp_min_seq)
        encoders = [(t, CLIPTokenizer.from_pretrained(os.path.join(paths["sdxl"], sub)))
                    for t, sub in zip(towers, ("tokenizer", "tokenizer_2"))]
        calls, unpatch = ring_counter(torch)
        try:
            with one_rank_group(torch):
                zero_counters(mods)
                t0 = time.perf_counter()
                records = infer.main(argv, models=(pipe, encoders))
                sec = time.perf_counter() - t0
                launches = read_counters(mods)
                backend = torch.distributed.get_backend()
        finally:
            unpatch()
            pipe.shard(None)
        by_call = dict(collections.Counter(calls))
        got = np.asarray(infer.read_image(os.path.join(out_dir, "a.png")))
        log(f"  CLI --sequence_parallel, 1024² 4 steps, one rank ({backend}): {sec:.3f} s from main() to its return "
            f"(the image {records[0]['seconds']:.3f} s PNG read to PNG written), ring calls {by_call} (derived "
            f"{rung}), launches {launches}; PNG {got.shape}, {len(np.unique(got))} distinct values; on {card_line}")
        if backend != "nccl" or by_call != rung or launches != every_counter(want):
            fail(f"phase 4c, the CLI with --sequence_parallel: backend {backend}, ring calls {by_call}, launches "
                 f"{launches}; derived {rung} and {every_counter(want)}")
        if got.shape != (res, res, 3) or len(np.unique(got)) < 2:
            fail(f"phase 4c, the CLI with --sequence_parallel wrote {got.shape}, {len(np.unique(got))} values")
        return {"launches": launches, "seconds": sec, "ring_calls": by_call}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_restore_2048(torch, pipe, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4h: the 2048² restore on phase 4's models at SDXL width (4 steps,
    CFG 7, batch 1, ``vae_tiling``; phase 4b-4g's recorded pools freed
    first): staged with K1 and K5 counted by shape against the counts derived
    from the config, as one CUDA graph on the same noise (its image equal to
    the staged one), s/image and ``max_memory_allocated`` of each; then
    ``sequence_parallel`` with ``sp_min_seq=8192`` on a one-rank NCCL group,
    staged: the UNet's 16,384 and the Aggregator's 32,768 and 8192 maps ring
    (one K2 launch each), the UNet's 4096 map stays on K1, and the image is
    within ``RESTORE_TOL`` of the dense one."""
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    attention, group_norm = mods["attention"], mods["group_norm"]
    res, lat = LONG_RES, LONG_RES // 8
    pipe._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(restore_config(4), vae_tiling=True)
    phases = build_step_phases(cfg)
    expected = expected_restore_launches(ucfg, cfg, phases, lat)
    by_seq = flash_launches_by_seq(phases, flash_calls_per_forward(ucfg, lat, lat, with_up=True),
                                   flash_calls_per_forward(ucfg, lat, lat, with_up=False, concat=2))
    heads = {**heads_by_seq(ucfg, lat), **heads_by_seq(ucfg, lat, concat=2)}
    k1_want = {(2, s, heads[s]): n for s, n in by_seq.items()}
    gn_want = {(2,) + shape: n for shape, n in group_norm_launches_by_shape(ucfg, phases, lat).items()}
    for shape, n in vae_restore_k5_by_shape(cfg, LONG_RES, LONG_RES).items():  # the VAE's tiles
        gn_want[shape] = gn_want.get(shape, 0) + n
    if sorted(k1_want) != sorted(LONG_RESTORE_SHAPES) or sum(k1_want.values()) != expected["flash_attention_fwd"]:
        fail(f"phase 4h: K1 shapes derived {k1_want} are not LONG_RESTORE_SHAPES or do not add up to {expected}")
    g = torch.Generator(device="cuda").manual_seed(11)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    noise = pipe.draw_noise(cfg, 1, res, res, torch.Generator(device="cuda").manual_seed(12))

    def restore(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image, _ = pipe.restore(lq, pe, pooled, cfg=c, noise=noise, output_type="pt")
        torch.cuda.synchronize()
        return image.float(), time.perf_counter() - t0

    # staged, K1 and K5 counted by shape (wrappers around the two kernel entry points)
    k1_seen, gn_seen = collections.Counter(), collections.Counter()
    fa, gnf = attention.flash_attention, group_norm.group_norm_silu_fused

    def fa_count(q, k, v, scale=None):
        k1_seen[(q.shape[0], q.shape[1], q.shape[2])] += 1
        return fa(q, k, v, scale)

    def gn_count(x, *args, **kwargs):
        gn_seen[tuple(x.shape)] += 1
        return gnf(x, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    zero_counters(mods)
    attention.flash_attention, group_norm.group_norm_silu_fused = fa_count, gn_count
    try:
        staged, first_sec = restore(cfg)
    finally:
        attention.flash_attention, group_norm.group_norm_silu_fused = fa, gnf
    launches = read_counters(mods)
    peak_staged = torch.cuda.max_memory_allocated() / 1e9
    log(f"  2048² 4 steps staged: first call {first_sec:.3f} s, peak {peak_staged:.2f} GB, launches {launches}; K1 by "
        f"(B, S, H) {dict(k1_seen)} (derived {k1_want}); K5 by shape {dict(gn_seen)}")
    if dict(k1_seen) != k1_want or dict(gn_seen) != gn_want or launches != every_counter(expected):
        fail(f"phase 4h: the staged 2048² restore launched {launches}, K1 {dict(k1_seen)}, K5 {dict(gn_seen)}; "
             f"derived {expected}, {k1_want}, {gn_want}")
    if tuple(staged.shape) != (1, res, res, 3) or not torch.isfinite(staged).all():
        fail(f"phase 4h: the staged 2048² image has shape {tuple(staged.shape)} or is not finite")
    staged_secs = [restore(cfg)[1]]

    # one CUDA graph on the same noise: a recording (warm-up and capture), then replays
    gcfg = dataclasses.replace(cfg, fused=True)
    zero_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    graph_image, record_sec = restore(gcfg)
    record_launches = read_counters(mods)
    peak_graph = torch.cuda.max_memory_allocated() / 1e9
    graph_secs = [restore(gcfg)[1]]
    pool_gb = torch.cuda.memory_reserved() / 1e9
    diff = ((graph_image - staged).abs().max() / staged.abs().max()).item()
    log(f"  2048² 4 steps as one CUDA graph: recording {record_sec:.3f} s (launches {record_launches}), replays "
        f"{['%.3f' % x for x in graph_secs]} s/image against staged {['%.3f' % x for x in staged_secs]}; peaks "
        f"staged {peak_staged:.2f} / recording {peak_graph:.2f} GB, reserved after {pool_gb:.2f} GB; the graph's "
        f"image against the staged one: max abs difference {diff:.3e} of its scale; on {card_line}")
    if record_launches != every_counter({k: 2 * n for k, n in expected.items()}) or not diff <= 1e-3:
        fail(f"phase 4h: the graph recording launched {record_launches} (derived 2 x {expected}) or its image is "
             f"{diff} of scale from the staged one")
    pipe._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # sequence parallel on one rank: the long maps ring, one K2 launch each
    scfg = dataclasses.replace(cfg, sequence_parallel=True, sp_min_seq=8192)
    want, rung, k1_sp = sp_launches(scfg, ucfg, lat, scfg.sp_min_seq)
    if sorted(rung) != sorted(LONG_SP_SHAPES):
        fail(f"phase 4h: the rung maps derived {rung} are not LONG_SP_SHAPES {LONG_SP_SHAPES}")
    calls, unpatch = ring_counter(torch)
    k1_seen.clear()
    try:
        with one_rank_group(torch):
            initialize_distributed(device="cuda")
            pipe.shard(make_mesh(device="cuda"))
            backend = torch.distributed.get_backend()
            zero_counters(mods)
            torch.cuda.reset_peak_memory_stats()
            attention.flash_attention = fa_count
            try:
                sp_image, sp_sec = restore(scfg)
            finally:
                attention.flash_attention = fa
            sp_launches_read = read_counters(mods)
            peak_sp = torch.cuda.max_memory_allocated() / 1e9
            pipe.shard(None)
    finally:
        unpatch()
    by_call = dict(collections.Counter(calls))
    rel = ((sp_image - staged).norm() / staged.norm()).item()
    log(f"  2048² 4 steps sequence parallel on one rank ({backend}), staged: {sp_sec:.3f} s, peak {peak_sp:.2f} GB, "
        f"ring calls {by_call} (derived {rung}), K1 by (B, S, H) {dict(k1_seen)} (derived {k1_sp}), launches "
        f"{sp_launches_read}; against the dense image: relative L2 {rel:.3e} (tolerance {RESTORE_TOL}); on "
        f"{card_line}")
    if backend != "nccl" or by_call != rung or dict(k1_seen) != k1_sp or sp_launches_read != every_counter(want):
        fail(f"phase 4h: the sequence-parallel restore rang {by_call}, K1 {dict(k1_seen)}, launched "
             f"{sp_launches_read} on {backend}; derived {rung}, {k1_sp}, {every_counter(want)}")
    if not (torch.isfinite(sp_image).all() and rel <= RESTORE_TOL):
        fail(f"phase 4h: the sequence-parallel 2048² image is {rel} (relative L2) from the dense one")
    return {"staged_sec": staged_secs, "graph_sec": graph_secs, "record_sec": record_sec, "sp_sec": sp_sec,
            "peak_gb": {"staged": peak_staged, "recording": peak_graph, "sp": peak_sp}, "sp_rel_l2": rel,
            "launches": {"restore_2048": launches, "restore_2048_graph_recording": record_launches,
                         "restore_2048_sp": sp_launches_read},
            "k1_by_shape": k1_want, "k2_by_shape": rung}


def run_sharded_restore(torch, pipe, mods: dict, ucfg, card_line: str) -> dict:
    """Phase 4i: the batch-sharded restore (``pipe.shard(make_mesh())``) on a
    one-rank NCCL group at 1024², 4 steps, on phase 4's restore settings and
    noise: bitwise the unsharded staged image, the launches the restore's."""
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    res = 1024
    cfg = restore_config(4)
    g = torch.Generator(device="cuda").manual_seed(13)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    noise = pipe.draw_noise(cfg, 1, res, res, torch.Generator(device="cuda").manual_seed(14))
    expected = every_counter(expected_restore_launches(ucfg, cfg, build_step_phases(cfg), res // 8))

    def restore():
        image, _ = pipe.restore(lq, pe, pooled, cfg=cfg, noise=noise, output_type="pt")
        torch.cuda.synchronize()
        return image

    plain = restore()
    with one_rank_group(torch):
        initialize_distributed(device="cuda")
        pipe.shard(make_mesh(device="cuda"))
        try:
            zero_counters(mods)
            t0 = time.perf_counter()
            sharded = restore()
            sec = time.perf_counter() - t0
            launches = read_counters(mods)
        finally:
            pipe.shard(None)
    same = torch.equal(sharded, plain)
    log(f"  sharded restore, 1024² 4 steps, one rank (nccl): {sec:.3f} s, launches {launches}; bitwise the "
        f"unsharded staged image: {same} (max abs difference {(sharded - plain).abs().max().item():.3e}); on "
        f"{card_line}")
    if not same or launches != expected:
        fail(f"phase 4i: the sharded restore differs from the unsharded one or launched {launches} (derived {expected})")
    return {"launches": launches, "seconds": sec}


def run_stage1_dp(torch, pipe, ucfg, mods: dict, card_line: str) -> dict:
    """Phase 5c: stage 1 at 512² batch 2 on a one-rank NCCL group. Two steps
    with the group's mesh (``make_mesh()``, given explicitly: ``mesh="auto"``
    takes none at one rank; the gradient all-reduce and ZeRO-1 on) against two
    plain steps from the same state and draws: the masters bitwise equal;
    the same with ``use_8bit_adam`` (and the int8 moments). Meanwhile, in a
    process of its own (started first, so that its start-up overlaps the
    steps; its ~25 GB fit beside theirs), ``python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m instantir_tpu_torch.cli.train stage1
    --synthetic_data --use_8bit_adam``, 2 steps with a checkpoint; then its
    resume to 3 steps under torchrun's environment for one process: the state
    right after the resume bitwise the checkpoint's, rank 0 the only writer."""
    import tempfile

    import torch.distributed as dist

    from instantir_tpu_torch.cli import train as ct
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh
    from instantir_tpu_torch.train import common
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer

    expected = every_counter(expected_train_launches(ucfg, 512 // 8, checkpointing=False))
    if not mods["group_norm"].USE_FUSED:
        expected["group_norm_silu"] = 0
    base = Stage1Config(train_batch_size=2, resolution=512, lr_warmup_steps=0, max_train_steps=1000, output_dir="")
    models = (pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder)
    pair, cond = training_batch(torch, torch.Generator(device="cuda").manual_seed(21), 2, 512, torch.bfloat16)
    out = {"launches": {name: 0 for name in COUNTERS}}

    # the training CLI under torchrun, 2 steps with a checkpoint, started now and awaited after the steps
    root = tempfile.mkdtemp(prefix="train_dp_")
    out_dir = os.path.join(root, "out")
    argv = ["stage1", "--synthetic_data", "--resolution", "512", "--train_batch_size", "2", "--use_8bit_adam",
            "--checkpointing_steps", "2", "--prefetch_batches", "0", "--lr_warmup_steps", "0", "--output_dir",
            out_dir]
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                                              "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    t_cli = time.perf_counter()
    cli_out = open(os.path.join(root, "torchrun.log"), "w")  # a file: a pipe read only at the end could fill up
    cli_proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                 "1", "-m", "instantir_tpu_torch.cli.train", *argv, "--max_train_steps", "2"],
                                cwd=str(REPO), env=env, stdout=cli_out, stderr=subprocess.STDOUT)

    def two_steps(cfg, mesh, what):
        trainer = Stage1Trainer(*models, cfg, device="cuda", mesh=mesh)
        start = [p.detach().clone() for p in trainer.trainable]
        batch = trainer.prepare_batch(pair, cond)
        for i in range(2):
            launches, _, _ = train_step_checked(torch, trainer, batch, torch.Generator(device="cuda").manual_seed(30 + i),
                                                mods, expected, f"{what}, step {i + 1}/2", card_line)
            if mesh is not None:
                for name, n in launches.items():
                    out["launches"][name] += n
        state = {"masters": [m.detach().clone() for m in trainer.optimizer.masters],
                 "opt": trainer.optimizer.state_by_name(trainer.trainable_names), "mesh": trainer.mesh}
        with torch.no_grad():  # the models back to where this pair of runs started
            for p, s in zip(trainer.trainable, start):
                p.copy_(s)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return state

    try:
        with one_rank_group(torch):
            initialize_distributed(device="cuda")
            for tag, extra in (("AdamW", {}), ("8-bit AdamW", {"use_8bit_adam": True})):
                cfg = dataclasses.replace(base, **extra)
                dp = two_steps(cfg, make_mesh(device="cuda"), f"stage 1 DP ({tag}, one-rank mesh, ZeRO-1) at 512² "
                               "batch 2")
                plain = two_steps(cfg, None, f"stage 1 plain ({tag}) at 512² batch 2")
                same = (dp["mesh"] is not None
                        and all(torch.equal(a, b) for a, b in zip(dp["masters"], plain["masters"]))
                        and tree_differences(torch, dp["opt"], plain["opt"]) == [])
                log(f"  stage 1 with {tag}: two steps with the one-rank mesh ({dist.get_backend()}) against two "
                    f"plain steps from the same state and draws: masters and optimiser state bitwise equal: {same}")
                if not same:
                    fail(f"phase 5c: stage 1 with {tag} under the one-rank mesh differs from the plain steps")
                del dp, plain

        # the training CLI's torchrun run, then the resume to 3 steps
        cli_proc.wait(timeout=600)
        cli_sec = time.perf_counter() - t_cli
        cli_out.close()
        if cli_proc.returncode != 0:
            with open(cli_out.name) as f:
                fail(f"phase 5c: torchrun cli.train exited {cli_proc.returncode}:\n{f.read()[-4000:]}")
        ckpts = sorted(d for d in os.listdir(out_dir) if d.startswith("checkpoint-"))
        exports = sorted(f for f in os.listdir(out_dir) if f.endswith((".pt", ".json")))
        log(f"  torchrun --nproc_per_node 1 cli.train stage1 --use_8bit_adam, 2 steps: {cli_sec:.2f} s from its start "
            f"(beside the steps above), wrote {ckpts} and {exports}")
        if ckpts != ["checkpoint-2"] or "adapter_ckpt.pt" not in exports:
            fail(f"phase 5c: the torchrun CLI run left {ckpts} and {exports}")
        written = torch.load(os.path.join(out_dir, "checkpoint-2", common.STATE_FILE), map_location="cpu",
                             weights_only=True)
        resumed = {}
        orig_resume, orig_save = common.Trainer.resume, common.CheckpointManager.save
        saves = []

        def capture(self):
            step = orig_resume(self)
            resumed.update(step=step, state=common._to_host(self.checkpoint_state()), rank=dist.get_rank(),
                           mesh=self.mesh is not None)
            return step

        common.Trainer.resume = capture
        common.CheckpointManager.save = lambda self, step, state: (saves.append((step, dist.get_rank())),
                                                                    orig_save(self, step, state))[1]
        try:
            with one_rank_group(torch):
                t0 = time.perf_counter()
                result = ct.main([*argv, "--max_train_steps", "3"], device="cuda")
                resume_sec = time.perf_counter() - t0
        finally:
            common.Trainer.resume, common.CheckpointManager.save = orig_resume, orig_save
        diffs = tree_differences(torch, resumed.get("state"), written)
        log(f"  the resume to 3 steps under torchrun's environment (one rank, mesh {resumed.get('mesh')}): "
            f"{resume_sec:.2f} s; resumed at step {resumed.get('step')}, its state against checkpoint-2: "
            f"{'bitwise equal' if not diffs else diffs[:5]}; checkpoint writes (step, rank) {saves}; on {card_line}")
        if resumed.get("step") != 2 or diffs or saves != [(3, 0)] or result["trainer"].global_step != 3:
            fail(f"phase 5c: the resumed CLI run: step {resumed.get('step')}, differences {diffs[:5]}, writes {saves}, "
                 f"{result['trainer'].global_step} steps")
        del result, written, resumed
        out.update(cli_sec=cli_sec, resume_sec=resume_sec)
    finally:
        if cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
        cli_out.close()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def norm2_shapes_per_forward(cfg, lat_h: int, lat_w: int, with_up: bool, concat: int = 1) -> dict:
    """The resnets' ``norm2`` calls of one UNet (``with_up``) or Aggregator
    (``concat=2``) forward, by (C, H, W): the GroupNorm after ``conv1``, whose
    channels tensor parallelism splits (a subset of
    ``group_norm_shapes_per_forward``)."""
    counts: dict = {}
    chans = cfg.block_out_channels

    def add(c: int, level: int, k: int):
        key = (c, (lat_h * concat) >> level, lat_w >> level)
        counts[key] = counts.get(key, 0) + k

    for i in range(len(chans)):
        add(chans[i], i, cfg.layers_per_block)
    add(chans[-1], len(chans) - 1, 2)  # the mid block's two resnets
    if with_up:
        for i in range(len(cfg.up_block_types)):
            add(chans[len(chans) - 1 - i], len(chans) - 1 - i, cfg.layers_per_block + 1)
    return counts


def local_heads(heads: int, tp: int, rank: int) -> int:
    """Rank ``rank``'s heads of an attention of ``heads`` heads of 64 under a
    ``model`` axis of ``tp``: its ``tp_shares`` share where ``tp`` divides the
    features and the heads are at least ``tp``, else all (the layer stays
    whole)."""
    return tp_shares(heads, tp)[rank] if (heads * 64) % tp == 0 and heads >= tp else heads


def tp_launches_by_shape(cfg, phases, lat: int, tp: int = TP_SIZE, rank: int = 0):
    """K1 and K5 launches of one tensor-parallel restore (UNet and
    Aggregator) on rank ``rank``, by shape: K1 by (B, S, local heads), K5 by
    (C, H, W, groups) -- a resnet's ``norm2`` at its share of the groups
    (``tp_shares``) where ``tp`` divides its channels, every other GroupNorm
    whole."""
    unet = flash_calls_per_forward(cfg, lat, lat, with_up=True)
    agg = flash_calls_per_forward(cfg, lat, lat, with_up=False, concat=2)
    heads = {**heads_by_seq(cfg, lat), **heads_by_seq(cfg, lat, concat=2)}
    k1 = {(2, s, local_heads(heads[s], tp, rank)): n for s, n in flash_launches_by_seq(phases, unet, agg).items()}
    n_unet, n_agg = forwards_per_restore(phases)
    g = cfg.norm_num_groups
    k5: dict = {}
    for with_up, concat, n in ((True, 1, n_unet), (False, 2, n_agg)):
        norm2 = norm2_shapes_per_forward(cfg, lat, lat, with_up, concat)
        for (c, h, w), k in group_norm_shapes_per_forward(cfg, lat, lat, with_up, concat).items():
            mine = tp_shares(g, tp)[rank] if c % tp == 0 and g >= tp else g
            for key, m in (((c, h, w, g), k - norm2.get((c, h, w), 0)),
                           ((c // g * mine, h, w, mine), norm2.get((c, h, w), 0))):
                if m:
                    k5[key] = k5.get(key, 0) + m * n
    return k1, k5


def flops_main(out: str) -> None:
    """``--count_flops OUT``: the analytic FLOPs of one 1024² restore at SDXL
    width (``utils/flops.py``), config #4 and the 4-step one, counted on the
    ``meta`` device -- shapes only, no card -- so that the count runs on one
    CPU core beside the card's phases; written to OUT as JSON. On ``meta``
    every attention takes the plain path, whose two products the flash
    wrappers' formula counts on the card: the same number (CPU-checked
    against ``jaxpr_flops`` in ``tests/test_torch_port_utils.py``). The image
    encoder's tokens of the zero image are cached first, as a served restore
    has them."""
    import torch

    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    from instantir_tpu_torch.models.aggregator import Aggregator
    from instantir_tpu_torch.models.dinov2 import DINOv2Model, dinov2_large_config
    from instantir_tpu_torch.models.resampler import Resampler, instantir_resampler_config
    from instantir_tpu_torch.models.unet import UNet2DConditionModel, sdxl_base_config
    from instantir_tpu_torch.models.vae import AutoencoderKL, sdxl_vae_config
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline, RestoreNoise, inference_timesteps
    from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule
    from instantir_tpu_torch.utils.flops import count_flops

    meta, bf16, res = torch.device("meta"), torch.bfloat16, 1024
    ucfg = sdxl_base_config(with_ip=True, lora_rank=64)
    pipe = InstantIRPipeline(UNet2DConditionModel(ucfg, dtype=bf16, device=meta), Aggregator(ucfg, dtype=bf16, device=meta),
                             AutoencoderKL(sdxl_vae_config(), device=meta),
                             Resampler(instantir_resampler_config(lora_rank=64), dtype=bf16, device=meta),
                             DINOv2Model(dinov2_large_config(), dtype=bf16, device=meta), sdxl_schedule(), device=meta)
    pipe._uncond_tokens(pipe.image_encoder.config.image_size, torch.float32)
    counts = {}
    for steps in (4, 30):
        cfg = restore_config(steps)
        lat = torch.zeros(1, res // 8, res // 8, 4, device=meta)
        noise = RestoreNoise(vae=lat, init=lat, steps=[lat] * len(inference_timesteps(cfg)))
        t0 = time.perf_counter()
        counts[steps], _ = count_flops(pipe.restore, torch.zeros(1, res, res, 3, device=meta),
                                       torch.zeros(1, 77, 2048, dtype=bf16, device=meta),
                                       torch.zeros(1, 1280, dtype=bf16, device=meta), cfg=cfg, noise=noise,
                                       output_type="pt")
        counts[f"sec_{steps}"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(counts, f)


def phase_times(torch, pipe, cfg, res: int) -> dict:
    """``utils/profiling.PhaseTimer`` over one staged restore: the VAE encode,
    the denoise loop and the decode, each synchronised on the card."""
    from instantir_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    g = torch.Generator(device="cuda").manual_seed(42)
    lq = torch.rand(1, res, res, 3, generator=g, device="cuda") * 2.0 - 1.0
    pe = (torch.randn(1, 77, 2048, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    pooled = (torch.randn(1, 1280, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    wrapped = {"encode": "encode_vae_image", "denoise": "_sample", "decode": "decode_latents"}
    for phase, attr in wrapped.items():
        def timed(*a, _fn=getattr(pipe, attr), _phase=phase, **k):
            with timer.phase(_phase, sync_on=lq):
                return _fn(*a, **k)
        setattr(pipe, attr, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.restore(lq, pe, pooled, cfg=cfg, generator=torch.Generator(device="cuda").manual_seed(0), output_type="pt")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for attr in wrapped.values():
            delattr(pipe, attr)
    return {**timer.summary(), "restore": total}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn_ranks(flag: str, world: int, args: list, log_dir: str):
    """Start ``world`` processes of this script (``flag RANK WORLD *args``)
    under torchrun's environment on a free port, every one on GPU 0; returns
    (processes, their log files) for ``_wait_ranks``."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world), PYTHONPATH=str(REPO))
    procs, logs = [], []
    for r in range(world):
        f = open(os.path.join(log_dir, f"{flag.strip('-')}_{r}.log"), "w")
        logs.append(f)
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r), str(world), *args],
                                      cwd=str(REPO), env=dict(env, RANK=str(r)), stdout=f, stderr=subprocess.STDOUT))
    return procs, logs


def _wait_ranks(started, timeout: float):
    """Wait for ``_spawn_ranks``' processes (killing all past ``timeout``);
    returns their exit codes and logs."""
    procs, logs = started
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [open(f.name).read() for f in logs]
    return [p.returncode for p in procs], texts


def tp_probe_main(rank: int, world: int) -> None:
    """``--tp_probe``: an NCCL group of ``world`` ranks on the one card and
    one all-reduce (NCCL takes one rank a device: this is expected to fail)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", world_size=world, rank=rank)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(f"nccl all_reduce at {world} ranks on one card: {x.tolist()}", flush=True)


def tp_worker_main(rank: int, world: int, out: str, backend: str) -> None:
    """``--tp_worker``: one rank of phase 4j. Joins a ``backend`` group of
    ``world`` ranks on the one card and runs ``cli.serve.main --mesh
    --model_parallel world`` on phase 4c's tree: each rank loads the
    pipeline and shards it (``InstantIRPipeline.shard(make_mesh(
    model_parallel=world))``); rank 0 serves one request from a client thread
    and drains on SIGTERM, the other ranks follow. Every restore call the
    server makes (its warmup's and the request's) is recorded with its
    inputs, image and launches; writes ``tp_rank{rank}.pt``."""
    import signal
    import threading
    from http.client import HTTPConnection

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from instantir_tpu_torch import kernels
    from instantir_tpu_torch.cli import serve
    from instantir_tpu_torch.ops import attention, group_norm
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline

    kernels.build()
    mods = {"attention": attention, "group_norm": group_norm}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(os.path.join(out, "tp_job.pt"), weights_only=False)
    # the group made here, explicitly (serve.main then finds it joined; the mesh's groups take its backend)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, world_size=world, rank=rank)

    calls = []
    restore = InstantIRPipeline.restore

    def recorded(self, *a, **k):
        if not calls:  # the shard's weight bytes and the model group's backend, before the first restore
            res.update(bytes_rank=model_bytes([getattr(self, n) for n in self._MODELS]),
                       backend=dist.get_backend(self.mesh.get_group("model")),
                       allocated_gb=torch.cuda.memory_allocated() / 1e9)
            Path(os.path.join(out, f"sharded{rank}")).touch()  # loaded and sharded: its whole copy freed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(mods)
        t0 = time.perf_counter()
        image = restore(self, *a, **k)
        torch.cuda.synchronize()
        cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v  # noqa: E731
        noise = k["noise"]
        calls.append({"args": [cpu(t) for t in a], "kwargs": {kk: cpu(vv) for kk, vv in k.items() if kk != "noise"},
                      "noise": [t.cpu() for t in (noise.vae, noise.init, *noise.steps)], "image": image[0],
                      "launches": read_counters(mods), "sec": time.perf_counter() - t0,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return image

    res, got = {}, {}
    InstantIRPipeline.restore = recorded
    port = _free_port()
    if rank == 0:
        def client():
            deadline = time.time() + TP_TIMEOUT
            while time.time() < deadline:
                try:
                    conn = HTTPConnection("127.0.0.1", port, timeout=600)
                    conn.request("GET", "/healthz")
                    if conn.getresponse().status == 200:
                        break
                except OSError:
                    time.sleep(0.5)
            conn = HTTPConnection("127.0.0.1", port, timeout=600)
            t1 = time.perf_counter()
            conn.request("POST", "/restore", body=job["png"])
            resp = conn.getresponse()
            got.update(status=resp.status, body=resp.read(), sec=time.perf_counter() - t1)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=client, daemon=True).start()
    t0 = time.perf_counter()
    try:
        serve.main(job["serve_argv"] + ["--port", str(port)], device="cuda")
    finally:
        InstantIRPipeline.restore = restore
    res["serve_sec"] = time.perf_counter() - t0
    res["fingerprints"] = [[float(t.double().sum()) for t in (*c["args"], *c["noise"]) if isinstance(t, torch.Tensor)]
                           for c in calls]
    res["calls"] = [{k: c[k] for k in ("launches", "sec", "peak_gb")} for c in calls]
    res["images"] = [c["image"] for c in calls]
    if rank == 0:
        res["served"] = got
        res["restores"] = [{k: c[k] for k in ("args", "kwargs", "noise")} for c in calls]
    torch.save(res, os.path.join(out, f"tp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "instantir_tpu")]
    if banned:
        fail(f"a tensor-parallel rank imported {banned[:5]}")
    log(f"[4j rank {rank}] done: {len(calls)} restores {[round(c['sec'], 2) for c in calls]} s, server run "
        f"{res['serve_sec']:.1f} s")


def start_background(root: str) -> dict:
    """The work phase 4j reads that needs neither the card's time nor its
    memory, started beside phase 2's build: the NCCL probe of two ranks on
    the card (``--tp_probe``) and the FLOP count on ``meta``
    (``--count_flops``, no CUDA). Every process is killed at exit."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = {"flops_out": os.path.join(root, "flops.json"), "probe": _spawn_ranks("--tp_probe", TP_SIZE, [], root)}
    out["flops"] = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--count_flops", out["flops_out"]],
                                    cwd=str(REPO), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)

    def stop():
        for p in [out["flops"], *out["probe"][0]]:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(root, ignore_errors=True)

    atexit.register(stop)
    return out


def tp_restore_launches(ucfg, tp: int, res: int, rank: int):
    """Rank ``rank``'s launches in one tensor-parallel restore at ``res``²
    (``restore_config(TP_STEPS)``, batch 1, CFG batch 2) on a ``model`` axis
    of ``tp``: K1 by (B, S, local heads) and K5 by (C, H, W, groups) of the
    UNet and the Aggregator (``tp_launches_by_shape``), the fp32 VAE's K5 by
    (C, H, W, groups) at its local ``norm2`` shapes, and the counts in all."""
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    cfg = restore_config(TP_STEPS)
    phases = build_step_phases(cfg)
    k1, k5 = tp_launches_by_shape(ucfg, phases, res // 8, tp, rank)
    vae: dict = {}
    for part, hw in (("encoder", res), ("decoder", res // 8)):
        for (c, h, w, g, _), n in vae_group_norm_shapes(sdxl_vae_config(), hw, hw, part, tp, rank).items():
            vae[(c, h, w, g)] = vae.get((c, h, w, g), 0) + n
    want = expected_restore_launches(ucfg, cfg, phases, res // 8)
    if (sum(k1.values()), sum(k5.values()) + sum(vae.values())) != (want["flash_attention_fwd"],
                                                                     want["group_norm_silu"]):
        fail(f"phase 4j: the launches by shape at model {tp} rank {rank} ({k1}, {k5}, {vae}) do not add up to {want}")
    return k1, k5, vae, every_counter(want)


def start_tp_ranks(torch, paths: dict, tp: int, res: int, backend: str) -> dict:
    """Start ``tp`` ranks in a ``backend`` group on the one card
    (``--tp_worker``) serving ``res``² through ``cli.serve --mesh
    --model_parallel tp --no-fused`` on the tree (``finish_tp_ranks`` waits
    for them and checks them)."""
    import tempfile

    root = tempfile.mkdtemp(prefix=f"tp{tp}_")
    rgb = (torch.rand(res, res, 3, generator=torch.Generator().manual_seed(33 + tp)) * 255).to(torch.uint8).numpy()
    write_png(os.path.join(root, "request.png"), rgb)
    serve_argv = ["--sdxl_path", paths["sdxl"], "--instantir_path", paths["instantir"], "--vision_encoder_path",
                  paths["dinov2"], "--resolution", str(res), "--batch_size", "1", "--num_inference_steps",
                  str(TP_STEPS), "--cfg", "7", "--no-fused", "--host", "127.0.0.1", "--mesh", "--model_parallel",
                  str(tp)]
    torch.save({"png": open(os.path.join(root, "request.png"), "rb").read(), "serve_argv": serve_argv},
               os.path.join(root, "tp_job.pt"))
    return {"tp": tp, "res": res, "root": root, "t0": time.perf_counter(),
            "started": _spawn_ranks("--tp_worker", tp, [root, backend], root)}


def wait_sharded(run: dict, timeout: float) -> None:
    """Wait until every rank of ``start_tp_ranks``' ``run`` has loaded and
    sharded its pipeline (its whole copy freed), or one has exited."""
    deadline = time.time() + timeout
    procs = run["started"][0]
    while time.time() < deadline:
        if all(os.path.exists(os.path.join(run["root"], f"sharded{r}")) for r in range(run["tp"])):
            return
        if any(p.poll() is not None for p in procs):
            return  # finish_tp_ranks reports it
        time.sleep(1.0)


def finish_tp_ranks(torch, pipe, ucfg, run: dict, backend: str, card_line: str) -> dict:
    """``tp`` ranks in a ``backend`` group on the one card (``--tp_worker``),
    each running ``cli.serve --mesh --model_parallel tp --no-fused`` on the
    tree: each loads and shards the pipeline and restores ``res``² (CFG 7,
    ``TP_STEPS`` steps, staged) at the server's warmup and for one request.
    Checked: each rank's launches per restore against the counts derived at
    its local shapes (``tp_restore_launches``), every rank's restores on the
    same inputs, every rank's image within ``TP_TOL`` of the one-rank restore
    of those inputs (made here, on phase 4's models, which the tree holds),
    the served PNG the request's image as uint8, each rank's weight bytes
    those ``tp_held_bytes`` derives for it (beside the JAX rule's share,
    ``tp_spec``). The seconds are not TP speed: the ranks share one card and
    gloo copies through the host."""
    import numpy as np

    from instantir_tpu_torch.cli.serve import to_uint8
    from instantir_tpu_torch.parallel.tp import kept_whole, tp_held_bytes, tp_spec
    from instantir_tpu_torch.pipeline.instantir import RestoreNoise

    tp, res, root = run["tp"], run["res"], run["root"]
    try:
        rcs, texts = _wait_ranks(run["started"], max(1.0, TP_TIMEOUT - (time.perf_counter() - run["t0"])))
        sec = time.perf_counter() - run["t0"]
        os.makedirs(REPO / "chiprun_out", exist_ok=True)
        for r, t in enumerate(texts):
            (REPO / "chiprun_out" / f"tp{tp}_rank{r}.log").write_text(t)
        if any(rc != 0 for rc in rcs):
            fail(f"phase 4j: the {tp} tensor-parallel ranks exited {rcs}; rank logs in chiprun_out/tp{tp}_rank*.log:\n"
                 + "\n".join(t[-3000:] for t in texts))
        ranks = [torch.load(os.path.join(root, f"tp_rank{r}.pt"), weights_only=False) for r in range(tp)]

        # launches: every rank's two restores (the server's warmup and the request) those derived at its local shapes
        derived = [tp_restore_launches(ucfg, tp, res, r)[3] for r in range(tp)]
        for r, out in enumerate(ranks):
            if [c["launches"] for c in out["calls"]] != [derived[r], derived[r]]:
                fail(f"phase 4j, model {tp}, rank {r}: launches {[c['launches'] for c in out['calls']]} (warmup, "
                     f"request), derived {derived[r]} each")
            if out["backend"] != backend:
                fail(f"phase 4j, model {tp}, rank {r}: the model group is {out['backend']}, not {backend}")
        if any(o["fingerprints"] != ranks[0]["fingerprints"] for o in ranks):
            fail(f"phase 4j, model {tp}: the ranks' restores differ in their inputs")

        # every rank's TP restores against the one-rank restore of their inputs; the answer is the request's image
        rels = []
        for i, call in enumerate(ranks[0]["restores"]):
            args = [t.cuda() if isinstance(t, torch.Tensor) else t for t in call["args"]]
            kwargs = {k: (v.cuda() if isinstance(v, torch.Tensor) else v) for k, v in call["kwargs"].items()}
            vae, init, *steps = (t.cuda() for t in call["noise"])
            one = torch.as_tensor(pipe.restore(*args, noise=RestoreNoise(vae=vae, init=init, steps=steps), **kwargs)[0])
            for r, out in enumerate(ranks):
                tp_image = torch.as_tensor(out["images"][i])
                if not (torch.isfinite(tp_image).all() and tp_image.shape == (1, res, res, 3)):
                    fail(f"phase 4j, model {tp}, rank {r}: a TP restore gave {tuple(tp_image.shape)}, finite "
                         f"{torch.isfinite(tp_image).all()}")
                rels.append(rel_l2(torch, tp_image, one))
        served = ranks[0]["served"]
        if served.get("status") != 200:
            fail(f"phase 4j, model {tp}: the TP server answered {served.get('status')}: "
                 f"{served.get('body', b'')[:300]!r}")
        png = read_png(served["body"])
        same_png = np.array_equal(png, to_uint8(ranks[0]["images"][-1][0]))
        calls = ranks[0]["calls"]
        log(f"  model {tp}: TP restores (the server's InstantIRPipeline.shard(make_mesh(model_parallel={tp})), "
            f"{backend}, {res}² {TP_STEPS} steps CFG 7, staged): every rank's warmup and request images "
            f"{', '.join(f'{x:.3e}' for x in rels)} relative L2 from the one-rank restores of the same inputs (TP_TOL "
            f"{TP_TOL}); the served PNG {png.shape} the request's uint8 image: {same_png}; launches per restore, "
            f"rank 0 {calls[0]['launches']}; on {card_line}")
        log(f"  model {tp}, not TP speed ({tp} ranks share the card"
            f"{', gloo copies through the host' if backend == 'gloo' else ''}): rank 0's restores "
            f"{[round(c['sec'], 2) for c in calls]} s, peaks {[round(c['peak_gb'], 2) for c in calls]} GB, the request "
            f"answered in {served['sec']:.2f} s, the server runs (load, shard, warmup, request, drain) "
            f"{[round(o['serve_sec'], 1) for o in ranks]} s, the ranks {sec:.1f} s")
        if not same_png or max(rels) > TP_TOL:
            fail(f"phase 4j, model {tp}: the served PNG is its restore's image: {same_png}; relative L2 {rels} "
                 f"(> {TP_TOL}?)")

        # weight bytes per rank: the port's layout (tp_held_bytes) exactly, the JAX rule's even share beside it
        held = [0] * tp
        jax_rule = whole = 0
        for name in pipe._MODELS:
            model = getattr(pipe, name)
            held = [h + m for h, m in zip(held, tp_held_bytes(model, tp))]
            for n, p in model.named_parameters():
                nbytes = p.numel() * p.element_size()
                split = tp_spec(n, tuple(p.shape), tp) is not None and not kept_whole(n)
                jax_rule += nbytes // tp if split else nbytes
                whole += nbytes
            bufs = sum(b.numel() * b.element_size() for b in model.buffers())
            jax_rule, whole = jax_rule + bufs, whole + bufs
        per_rank = [o["bytes_rank"] for o in ranks]
        log(f"  model {tp}, weight bytes: one rank {whole / 1e9:.3f} GB; each of {tp} ranks "
            f"{[round(b / 1e9, 3) for b in per_rank]} GB ({per_rank[0] / whole:.1%} on rank 0), tp_held_bytes "
            f"{[round(b / 1e9, 3) for b in held]} GB; the JAX rule's leaves split evenly (tp_spec) "
            f"{jax_rule / 1e9:.3f} GB a rank; allocated before the first restore "
            f"{[round(o['allocated_gb'], 2) for o in ranks]} GB")
        if per_rank != held:
            fail(f"phase 4j, model {tp}: per-rank weight bytes {per_rank} differ from tp_held_bytes {held}")
        return {"launches": calls[0]["launches"], "serve_launches": {k: 2 * v for k, v in calls[0]["launches"].items()},
                "rel_l2": rels, "bytes": {"whole": whole, "rank": per_rank, "held": held, "jax_rule": jax_rule},
                "seconds": sec, "restore_sec": [c["sec"] for c in calls]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_tensor_parallel(torch, pipe, paths: dict, mods: dict, ucfg, gn_by_shape: dict, graph_sec: float,
                        card_line: str, background: dict) -> dict:
    """Phase 4j, on phase 4c's tree and phase 4's models: tensor parallelism
    on the one card at ``TP_RES``², at a ``model`` axis of 2 and of 4 (where
    the 10-head attentions split 3 / 3 / 2 / 2). K1 at the local heads and
    K5 at the local ``norm2`` shapes (the UNet's and the Aggregator's in
    bf16, the VAE's in fp32) against their plain versions; config #4's
    analytic FLOPs per image (``utils/flops.py``) and the 4-step graph
    replay's achieved rate; ``PhaseTimer`` over one restore. Then an NCCL
    group of two ranks on the card is tried (``--tp_probe``); where NCCL
    refuses, the ranks run in an explicit gloo group over the CUDA tensors
    (``start_tp_ranks`` / ``finish_tp_ranks``: ``cli.serve --mesh
    --model_parallel`` on the tree), the four model-4 ranks first and the two
    model-2 ranks beside them once the four have sharded."""
    from instantir_tpu_torch.ops import attention, group_norm

    k1_rows, gn_rows, shapes = [], [], {}
    for tp, res in ((TP_SIZE, TP_RES), (TP_MODEL4, TP_RES)):
        k1_by_shape, k5_by_shape, vae_by_shape = {}, {}, {}
        for rank in range(tp):
            k1, k5, vae, _ = tp_restore_launches(ucfg, tp, res, rank)
            for acc, d in ((k1_by_shape, k1), (k5_by_shape, k5), (vae_by_shape, vae)):
                for key, n in d.items():
                    acc[key] = acc.get(key, 0) + n
        shapes[tp] = {"k1": k1_by_shape, "k5": k5_by_shape, "vae": vae_by_shape}
        local5 = sorted(k for k in k5_by_shape if k[3] != 32)
        local_vae = sorted(k for k in vae_by_shape if k[3] != 32)
        log(f"  model {tp} at {res}²: K1 at the local heads {sorted(k1_by_shape)}, K5 at the local norm2 shapes "
            f"{local5} (bf16) and the VAE's {local_vae} (fp32), against their plain versions")
        k1_rows += check_flash(torch, attention, [(b, s, s, h) for b, s, h in sorted(k1_by_shape)], host_timing=False)
        gn_rows += check_group_norm(torch, group_norm, gn_by_shape,
                                    [(GN_BATCH, k[:3], (torch.bfloat16,), {"groups": k[3]}) for k in local5]
                                    + [(1, k[:3], (torch.float32,), {"groups": k[3], "silus": (True,), "f64": True})
                                       for k in local_vae], base=False, host=False)

    # the FLOP counter (counted on meta since phase 2, --count_flops) and the phase timer, on one rank
    try:
        background["flops"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("phase 4j: the FLOP count on meta (--count_flops) took more than 600 s past phase 2")
    if background["flops"].returncode != 0:
        fail(f"phase 4j: the FLOP count on meta exited {background['flops'].returncode}")
    with open(background["flops_out"]) as f:
        counted = json.load(f)
    flops4, flops30 = counted["4"], counted["30"]
    tflops = flops4 / graph_sec / 1e12
    log(f"  analytic FLOPs per 1024² image (utils/flops.py, on meta beside the card's phases: "
        f"{counted['sec_4'] + counted['sec_30']:.0f} s of one core): config #4 (30 steps) {flops30 / 1e12:.2f} TFLOP, "
        f"the 4-step restore {flops4 / 1e12:.2f} TFLOP; the 4-step graph replay ({graph_sec:.3f} s, phase 4b) achieves "
        f"{tflops:.1f} TFLOP/s, {tflops / (PEAK_BF16_FLOPS / 1e12):.1%} of 989; on {card_line}")
    times = phase_times(torch, pipe, restore_config(4), 1024)
    log(f"  PhaseTimer over one staged 4-step 1024² restore (s): {json.dumps({k: round(v, 4) for k, v in times.items()})}"
        f"; on {card_line}")

    rcs, texts = _wait_ranks(background["probe"], 90)
    nccl_ok = all(rc == 0 for rc in rcs)
    nccl_error = next((line.strip() for t in texts for line in t.splitlines()
                       if "rror" in line and "Traceback" not in line), f"exit codes {rcs}")
    log(f"  NCCL group of {TP_SIZE} ranks on the one card (tried beside phase 2): "
        f"{'works' if nccl_ok else 'refused: ' + nccl_error[:400]}")
    backend = "nccl" if nccl_ok else "gloo"
    # the four model-4 ranks first; once each has loaded and sharded (its whole 10 GB copy freed), the two
    # model-2 ranks beside them: the groups overlap on the card and its host, each within the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    started = {TP_MODEL4: start_tp_ranks(torch, paths, TP_MODEL4, TP_RES, backend)}
    wait_sharded(started[TP_MODEL4], TP_TIMEOUT / 2)
    started[TP_SIZE] = start_tp_ranks(torch, paths, TP_SIZE, TP_RES, backend)
    runs = {tp: finish_tp_ranks(torch, pipe, ucfg, started[tp], backend, card_line) for tp in (TP_SIZE, TP_MODEL4)}
    two = runs[TP_SIZE]
    return {"k1_rows": k1_rows, "gn_rows": gn_rows, "shapes": shapes, "runs": runs,
            "launches": two["launches"], "serve_launches": {k: sum(r["serve_launches"][k] for r in runs.values())
                                                            for k in two["serve_launches"]},
            "rel_l2": two["rel_l2"], "backend": backend, "nccl_error": None if nccl_ok else nccl_error,
            "flops4": flops4, "flops30": flops30, "tflops": tflops, "phase_times": times, "bytes": two["bytes"]}


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
    ap.add_argument("--only", choices=["kernels", "group_norm", "flash_f32"], default=None,
                    help="'kernels': stop after the kernel check (no result line); 'group_norm': check K5 alone; "
                         "'flash_f32': check the fp32 flash entry points alone")
    args = ap.parse_args()
    t_start = time.time()

    def phase(msg: str) -> None:
        log(f"{msg} (at {time.time() - t_start:.0f} s)")

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
    phase(f"[1] card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s); TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build; beside it, phase 4j's NCCL probe and its FLOP count on meta (no card time)
    from instantir_tpu_torch import kernels

    background = None if args.only else start_background(tempfile.mkdtemp(prefix="chip_smoke_bg_"))
    t0 = time.time()
    try:
        paths = kernels.build()
    except RuntimeError as e:
        fail(f"kernel build failed: {e}")
    phase(f"[2] built {list(kernels.SOURCES)} in {time.time() - t0:.2f} s")
    for name, text in kernels.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                log(f"    {name}: {line.strip()}")
    for kernel, c in sass_summary(paths).get("flash_f32", {}).items():
        if c["LDL"] or c["STL"]:
            fail(f"flash_f32 {kernel} spills: {c['LDL']} LDL, {c['STL']} STL in its SASS")

    # 3. kernel check
    from instantir_tpu_torch.models.unet import sdxl_base_config
    from instantir_tpu_torch.models.vae import sdxl_vae_config
    from instantir_tpu_torch.ops import attention, group_norm
    from instantir_tpu_torch.pipeline.instantir import build_step_phases

    mods = {"attention": attention, "group_norm": group_norm}
    ucfg = sdxl_base_config(with_ip=True, lora_rank=64)
    gn_by_shape = group_norm_launches_by_shape(ucfg, build_step_phases(restore_config(args.steps)), 1024 // 8)
    # K5's other main-path shapes: the UNet's and the Aggregator's at 512² (bf16 training and the fp32 restore,
    # batch 2, where not already among GN_SHAPES; the fp32 stage-1 step, batch 1, the UNet's) and at 1024²
    # batch 1 (bf16 training)
    bf16, fp32 = torch.bfloat16, torch.float32

    def gn_shapes(res: int, aggregator: bool = True) -> list:
        lat = res // 8
        shapes = set(group_norm_shapes_per_forward(ucfg, lat, lat, with_up=True))
        if aggregator:
            shapes |= set(group_norm_shapes_per_forward(ucfg, lat, lat, with_up=False, concat=2))
        return sorted(shapes)

    gn_cases = ([(GN_BATCH, shape, (bf16, fp32)) for shape in gn_shapes(F32_RES) if shape not in GN_SHAPES]
                + [(1, shape, (fp32,)) for shape in gn_shapes(F32_RES, aggregator=False)]
                + [(1, shape, (bf16,)) for shape in gn_shapes(1024)])
    # the model variants' (phases 4f and 5b, batch 2, bf16): pad_concat's Aggregator maps at 1024² and 512²; a
    # zero_sft UNet's ZeroSFT norms take the shapes its up resnets' norm1 and its mid block take, already among
    # GN_UNET_SHAPES at 1024²
    zero_sft_shapes = sorted(zero_sft_group_norms(ucfg, 1024 // 8))
    if not set(zero_sft_shapes) <= set(GN_UNET_SHAPES):
        fail(f"ZeroSFT's GroupNorm shapes {zero_sft_shapes} are not all among GN_UNET_SHAPES")
    pad_shapes = sorted(set(aggregator_group_norm_shapes(ucfg, 1024 // 8, True))
                        | set(aggregator_group_norm_shapes(ucfg, 512 // 8, True)))
    gn_cases += [(GN_BATCH, shape, (bf16,)) for shape in pad_shapes]
    log(f"  the variants' K5 shapes: pad_concat {pad_shapes}; ZeroSFT {zero_sft_shapes} (checked among the "
        "restore's)")
    phase("[3] kernel check against the plain versions")
    if args.only not in ("group_norm", "flash_f32"):
        k1_rows = check_flash(torch, attention)
        train_rows = check_flash_training(torch, attention)
    if args.only != "group_norm":
        f32_rows = check_flash_f32(torch, attention)
    if args.only != "flash_f32":
        gn_rows = check_group_norm(torch, group_norm, gn_by_shape, gn_cases)
    # the lengths past which the JAX kernels stream (RESIDENT_MAX_SEQ = 8192): the 2048² restore's
    phase("[3] K1-K5 at the 2048² restore's lengths: K1 bf16 at its CFG shapes, K2-K4 bf16 and K1-K4 fp32 at a "
          "batch-1 step's 16,384 and 32,768 tokens, K2 at the sequence-parallel restore's rung maps, K5 at its "
          "GroupNorm shapes")
    long_gn = sorted(set(gn_shapes(LONG_RES)) - set(GN_SHAPES))
    once = (1, 0, 1)  # a plain version at these lengths takes up to a second a call: timed once
    if args.only not in ("group_norm", "flash_f32"):
        k1_rows += check_flash(torch, attention, [(b, s, s, h) for b, s, h in LONG_RESTORE_SHAPES], host_timing=False,
                               plain_calls=once)
        long_rows = check_flash_training(torch, attention, [(b, s, s, h) for b, s, h in LONG_TRAIN_SHAPES],
                                         host_timing=False, forward_only=[(b, s, s, h) for b, s, h in LONG_SP_SHAPES],
                                         plain_calls=(once, once))
        for name, rows in long_rows.items():
            train_rows[name] += rows
        phase("[3] ring attention on CUDA tensors, forward and backward, at one rank of an NCCL group")
        check_ring(torch, attention, LONG_TRAIN_SHAPES, card_line)
    if args.only != "group_norm":
        for name, rows in check_flash_f32(torch, attention, [(b, s, s, h) for b, s, h in LONG_TRAIN_SHAPES],
                                          plain_calls=(once, once)).items():
            f32_rows[name] += rows
    if args.only != "flash_f32":
        gn_rows += check_group_norm(torch, group_norm, gn_by_shape, [(GN_BATCH, shape, (bf16,)) for shape in long_gn],
                                    base=False, host=False)
    # the VAE's shapes (batch 1: the restore's fp32 encode and decode, the bf16 decode, the 2048² restore's tiles),
    # each held to its fp64 evaluation; the uneven local shapes of a model axis of 5 (the 1024² restore's resnets'
    # norm2 at 7 and at 6 of the 32 groups) and K1 at a model axis of 4's local heads (3 and 2 of 10, 5 of 20)
    vcfg = sdxl_vae_config()
    tp_phases = build_step_phases(restore_config(4))
    uneven = sorted({key for rank in (0, TP_UNEVEN - 1)
                     for key in tp_launches_by_shape(ucfg, tp_phases, 1024 // 8, TP_UNEVEN, rank)[1] if key[3] != 32})
    tp4_heads = sorted({key for rank in range(TP_MODEL4)
                        for key in tp_launches_by_shape(ucfg, tp_phases, 1024 // 8, TP_MODEL4, rank)[0]})
    tp2_heads = sorted(tp_launches_by_shape(ucfg, tp_phases, 1024 // 8, TP_SIZE)[0])
    if sorted(k[:3] for k in tp2_heads) != sorted(TP_RESTORE_SHAPES):
        fail(f"phase 3: K1's derived model-2 shapes {tp2_heads} are not TP_RESTORE_SHAPES {TP_RESTORE_SHAPES}")
    if args.only != "flash_f32":
        phase(f"[3] K5 at the VAE's shapes, fp32 and bf16, against the plain version and fp64; at a model axis of "
              f"{TP_UNEVEN}'s uneven local norm2 shapes {uneven}")
        gn_rows += check_group_norm(torch, group_norm, gn_by_shape, vae_gn_cases(torch, vcfg), base=False, host=False)
        gn_rows += check_group_norm(torch, group_norm, gn_by_shape,
                                    [(GN_BATCH, key[:3], (bf16,), {"groups": key[3]}) for key in uneven],
                                    base=False, host=False)
    if args.only not in ("group_norm", "flash_f32"):
        phase(f"[3] K1 at the 1024² restore's local heads of a model axis of {TP_MODEL4} {tp4_heads} and of "
              f"{TP_SIZE} {tp2_heads}")
        k1_rows += check_flash(torch, attention, [(b, s, s, h) for b, s, h in tp4_heads + tp2_heads],
                               host_timing=False)
    if args.only:
        log(f"kernel check passed (--only {args.only}: no restore, no training, no result line)")
        return

    # 4. restore
    phase(f"[4] restore at SDXL width, {args.steps} steps, fused GroupNorm off and on")
    pipe, restore_launches, sec, by_seq, restore_secs, fused_launches = run_restore(torch, args.steps, mods, ucfg)

    # 4b. the restore options
    phase("[4b] restore options at SDXL width: one CUDA graph, merged LoRA, DeepCache, Heun, bf16 decode, tiling, slicing")
    options = run_restore_options(torch, pipe, args.steps, mods, ucfg, card_line)

    # 4c. a checkpoint tree in the released layout, loaded back, and the inference CLI; then on that tree
    # 4g. the CLIP image-prompt encoder: the restore staged and as a graph, and the CLI with --use_clip_encoder
    phase("[4c] load a checkpoint tree in the released layout and restore through the inference CLI at SDXL width")

    def phase_4g(paths, towers):
        log("[4g] the CLIP image-prompt encoder at SDXL width: a ViT-B/16 CLIPImageEncoder and a 768-wide "
            "Resampler on phase 4's models, staged and as one CUDA graph, the CLI with --use_clip_encoder")
        clip = run_clip_encoder(torch, pipe, paths, towers, mods, ucfg, card_line)
        phase("[4c] cli.infer.main --sequence_parallel at 1024² on the tree, one rank under torchrun's environment")
        clip["cli_sp"] = run_cli_sequence_parallel(torch, pipe, paths, towers, mods, ucfg, card_line)
        phase(f"[4j] tensor parallelism on the tree: K1 / K5 at the local shapes, the FLOP counter, then {TP_MODEL4} "
              f"and {TP_SIZE} ranks on the one card restore {TP_RES}² ({TP_STEPS} steps, CFG 7) and serve one request "
              f"(cli.serve --mesh --model_parallel {TP_MODEL4} and {TP_SIZE})")
        clip["tp"] = run_tensor_parallel(torch, pipe, paths, mods, ucfg, gn_by_shape, options["graph_sec"], card_line,
                                         background)
        return clip

    cli = run_load_and_cli(torch, pipe, args.steps, mods, ucfg, card_line, after_tree=phase_4g)
    clip_enc = cli["after_tree"]
    tp = clip_enc["tp"]
    k1_rows += tp["k1_rows"]
    gn_rows += tp["gn_rows"]

    # 4d. serving
    phase("[4d] serving at SDXL width: the whole-request server, the demo app's adapter swap, the slot sampler, "
        "the continuous server")
    serving = run_serving(torch, pipe, args.steps, mods, ucfg, card_line)

    # 4e. the quantized restore
    phase("[4e] quantized restore at SDXL width: W8 and W8A8 copies of the UNet and the Aggregator, the int8 products, "
        "staged and graph restores against bf16, the W8 server")
    quantized = run_quantized(torch, pipe, args.steps, mods, ucfg, card_line)

    # 4f. the model variants
    phase("[4f] model variants at SDXL width: the Aggregator's pad_concat x attn1_mode and global_pool_conditions, a "
        "zero_sft UNet forward and backward, external_kv in three modes")
    variants = run_variants(torch, pipe, mods, ucfg, card_line)

    # 4h. the 2048² restore, dense (staged and one graph) and sequence parallel on one rank
    phase("[4h] the 2048² restore at SDXL width, 4 steps, CFG 7, vae_tiling: staged and as one CUDA graph, then "
          "sequence parallel (sp_min_seq 8192) on a one-rank NCCL group")
    long_restore = run_restore_2048(torch, pipe, mods, ucfg, card_line)

    # 4i. the batch-sharded restore on a one-rank NCCL group
    phase("[4i] the sharded restore (pipe.shard(make_mesh())) at 1024², 4 steps, on a one-rank NCCL group")
    sharded = run_sharded_restore(torch, pipe, mods, ucfg, card_line)

    # 5. stage-2 training (before stage 1, which frees the Aggregator)
    phase("[5] stage-2 (Aggregator) training at SDXL width")
    stage2 = run_stage2(torch, pipe, ucfg, mods, card_line)

    # 5b. stage 2 with the Aggregator's own image-prompt adapter
    phase("[5b] stage 2 with --aggregator_adapter at SDXL width: steps in turns with phase 5's, the variant "
        "Aggregator's gradients, the training CLI with a checkpoint and its resume")
    adapter = run_stage2_adapter(torch, pipe, stage2, ucfg, mods, card_line)
    gc.collect()
    torch.cuda.empty_cache()

    # 5c. data-parallel stage 1 on a one-rank NCCL group, and the training CLI under torchrun
    phase("[5c] stage 1 data parallel (make_mesh(), ZeRO-1) on a one-rank NCCL group at 512² batch 2, with AdamW "
          "and 8-bit AdamW, against the plain steps; the training CLI under torchrun, its checkpoint and resume")
    stage1_dp = run_stage1_dp(torch, pipe, ucfg, mods, card_line)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. stage-1 training
    phase("[6] stage-1 training at SDXL width")
    train = run_training(torch, pipe, ucfg, mods, card_line)
    gc.collect()
    torch.cuda.empty_cache()

    # 7. previewer training
    phase("[7] previewer (LCM-LoRA distillation) training at SDXL width")
    previewer = run_previewer(torch, pipe, ucfg, mods, card_line)
    gc.collect()
    torch.cuda.empty_cache()

    # 7c. the perceptual losses
    phase("[7c] the perceptual losses at full width: previewer steps with LPIPS + DreamSim in turns with Huber, each "
        "loss's forward and backward through pred_image, MTCNN.detect")
    perceptual = run_perceptual(torch, pipe, ucfg, mods, card_line)
    gc.collect()
    torch.cuda.empty_cache()

    # 7b. training from raw images: the degradation, the training CLI, checkpoints and resume
    phase("[7b] training from raw images at SDXL width: the degradation on the card, the training CLI (stage 1 with "
        "checkpoints and resume, stage 1 from PNGs, the previewer, stage 2 with async checkpoints), s/step of run")
    train_cli = run_train_cli(torch, pipe, ucfg, mods, card_line)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # 8. fp32
    phase(f"[8] fp32: default build_pipeline, 512² restore and a stage-1 step ({torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB still allocated)")
    f32 = run_fp32(torch, ucfg, mods, card_line)

    # 9. summary
    def by_path(name):
        return {"restore": restore_launches[name], "restore_fused_group_norm": fused_launches[name],
                "restore_graph_recording": options["launches"]["graph recording"][name],
                "restore_deepcache": options["launches"]["DeepCache restore"][name],
                "restore_cli": cli["launches"][name],
                "restore_clip_encoder": clip_enc["total"][name],
                "serve_warmup": serving["launches"]["serve warmup"][name],
                "serve_traffic": serving["launches"]["serve traffic"][name],
                "slot_steps": serving["launches"]["slot steps 1024"][name],
                "serve_continuous_warmup": serving["launches"]["serve continuous warmup"][name],
                "serve_continuous_traffic": serving["launches"]["serve continuous traffic"][name],
                "train_512": train["train_512"][name], "train_1024": train["train_1024"][name],
                "train_stage2_512": stage2["train_stage2_512"][name],
                "train_stage2_1024": stage2["train_stage2_1024"][name],
                "train_previewer_512": previewer["train_previewer_512"][name],
                "train_previewer_1024": previewer["train_previewer_1024"][name],
                "train_previewer_perceptual": perceptual["train_previewer_perceptual"][name],
                "train_cli_stage1": train_cli["launches_stage1"][name],
                "train_cli_previewer": train_cli["launches_previewer"][name],
                "train_cli_stage2": train_cli["launches_stage2"][name],
                "train_run_turns": train_cli["launches_turns"][name],
                "restore_w8_w8a8": sum(quantized["launches"][f"{m} {k}"][name] for m in ("w8", "w8a8")
                                       for k in ("staged restore", "graph recording")),
                "restore_cli_w8": cli["cli_w8"]["launches"][name],
                "serve_w8_warmup": quantized["launches"]["w8 serve warmup"][name],
                "train_stage2_qlora": stage2["qlora"]["launches"][name],
                "train_qlora": train["qlora"]["launches"][name],
                "train_previewer_qlora": previewer["qlora"]["launches"][name],
                "train_cli_qlora": train_cli["launches_qlora_cli"][name],
                "variants": variants["launches"][name],
                "train_stage2_adapter": adapter["launches"][name],
                "aggregator_variant_grads": adapter["grads_launches"][name],
                "fp32": f32["restore"][name] + f32["train"][name],
                "restore_2048": long_restore["launches"]["restore_2048"][name],
                "restore_2048_graph_recording": long_restore["launches"]["restore_2048_graph_recording"][name],
                "restore_2048_sp": long_restore["launches"]["restore_2048_sp"][name],
                "restore_cli_sp": clip_enc["cli_sp"]["launches"][name],
                "restore_sharded": sharded["launches"][name],
                "train_stage1_dp": stage1_dp["launches"][name],
                "serve_tp_rank0": tp["serve_launches"][name]}

    src = "instantir_tpu_torch/csrc/"
    jax_attn = "instantir_tpu/ops/attention.py"
    def shape_of(r):
        return (r["B"], r["S"], r["H"]) if r["S"] == r["Skv"] else None

    # the bf16 flash kernels' numbers are weighted by their launches at each shape on every main path: the
    # restore's (twice: with the fused GroupNorm off and on) and the training paths', whose split by shape
    # must add up to the counts read in phases 5-7
    by_shape = flash_launches_by_shape(ucfg, stage2["cfg"])
    for path, kernels_of_path in by_shape.items():
        for name, counts in kernels_of_path.items():
            if sum(counts.values()) != by_path(name)[path]:
                fail(f"{name} on {path}: launches split by shape {counts} do not add up to the {by_path(name)[path]} "
                     "read in the run")

    def train_weights(name, rows):
        return [sum(by_shape[p][name].get(shape_of(r), 0) for p in by_shape) for r in rows]

    # the tensor-parallel servers' (phase 4j: two restores on each rank at its local heads; models 2 and 4)
    tp_k1, tp_k5, tp_vae = {}, {}, {}
    for shapes in tp["shapes"].values():
        for acc, d in ((tp_k1, shapes["k1"]), (tp_k5, shapes["k5"]), (tp_vae, shapes["vae"])):
            for key, n in d.items():
                acc[key] = acc.get(key, 0) + 2 * n
    k1_weights = [w + (2 * by_seq.get(r["S"], 0) if shape_of(r) in RESTORE_SHAPES else 0)
                  + long_restore["k1_by_shape"].get(shape_of(r), 0) + tp_k1.get(shape_of(r), 0)
                  for r, w in zip(k1_rows, train_weights("flash_attention_fwd", k1_rows))]
    k2_weights = [w + long_restore["k2_by_shape"].get(shape_of(r), 0)
                  for r, w in zip(train_rows["fwd_lse"], train_weights("flash_attention_fwd_lse", train_rows["fwd_lse"]))]
    # K5: weighted over the 1024² restore (bf16 UNet and Aggregator at CFG batch 2; the fp32 VAE at batch 1, by
    # SiLU setting), the path its entry's launches count, the 2048² restore's and the tensor-parallel servers'
    gn_long = group_norm_launches_by_shape(ucfg, build_step_phases(restore_config(4)), LONG_RES // 8)
    vae_restore = {}
    for part, hw in (("encoder", 1024), ("decoder", 1024 // 8)):
        for (c, h, w, _, silu), n in vae_group_norm_shapes(vcfg, hw, hw, part).items():
            vae_restore[(c, h, w, silu)] = vae_restore.get((c, h, w, silu), 0) + n

    def gn_weight(r) -> int:
        key = (r["C"], r["H"], r["W"])
        if (r["dtype"], r["B"]) == ("bfloat16", GN_BATCH):
            if r["G"] == 32:
                return gn_by_shape.get(key, 0) + (gn_long.get(key, 0) if key in long_gn else 0)
            return tp_k5.get(key + (r["G"],), 0)
        if (r["dtype"], r["B"]) == ("float32", 1) and "f64_err" in r:  # the VAE's rows
            return vae_restore.get(key + (r["silu"],), 0) if r["G"] == 32 else tp_vae.get(key + (r["G"],), 0)
        return 0

    gn_weights = [gn_weight(r) for r in gn_rows]
    # fp32: K1 by the 512² restore's launches per sequence (all CFG batch 2), K2-K4 by the stage-1 step's shape
    f32_fwd_weights = [f32["by_seq"].get(r["S"], 0) if shape_of(r) in F32_PATH_SHAPES[:3] else 0
                       for r in f32_rows["fwd"]]
    f32_train_weights = [1 if shape_of(r) == F32_PATH_SHAPES[3] else 0 for r in f32_rows["fwd_lse"]]
    f32_src = src + "flash_f32.cu"
    entries = [
        kernel_entry("flash_attention_fwd", "cuda", src + "flash_fwd.cu", jax_attn + ":221", k1_rows, k1_weights,
                     restore_launches["flash_attention_fwd"],
                     by_path("flash_attention_fwd")),
        kernel_entry("flash_attention_fwd_lse", "cuda", src + "flash_fwd.cu", jax_attn + ":504", train_rows["fwd_lse"],
                     k2_weights, train["train_512"]["flash_attention_fwd_lse"],
                     by_path("flash_attention_fwd_lse")),
        kernel_entry("flash_attention_bwd_dq", "cuda", src + "flash_bwd.cu", jax_attn + ":597", train_rows["bwd_dq"],
                     train_weights("flash_attention_bwd_dq", train_rows["bwd_dq"]), train["train_512"]["flash_attention_bwd_dq"],
                     by_path("flash_attention_bwd_dq")),
        kernel_entry("flash_attention_bwd_dkv", "cuda", src + "flash_bwd.cu", jax_attn + ":617", train_rows["bwd_dkv"],
                     train_weights("flash_attention_bwd_dkv", train_rows["bwd_dkv"]), train["train_512"]["flash_attention_bwd_dkv"],
                     by_path("flash_attention_bwd_dkv")),
        kernel_entry("group_norm_silu", "cuda", src + "group_norm.cu",
                     "instantir_tpu/ops/group_norm.py:72", gn_rows, gn_weights,
                     fused_launches["group_norm_silu"],
                     by_path("group_norm_silu")),
        kernel_entry("flash_attention_fwd_f32", "cuda", f32_src, jax_attn + ":221", f32_rows["fwd"], f32_fwd_weights,
                     f32["restore"]["flash_attention_fwd_f32"], by_path("flash_attention_fwd_f32")),
        kernel_entry("flash_attention_fwd_lse_f32", "cuda", f32_src, jax_attn + ":504", f32_rows["fwd_lse"],
                     f32_train_weights, f32["train"]["flash_attention_fwd_lse_f32"],
                     by_path("flash_attention_fwd_lse_f32")),
        kernel_entry("flash_attention_bwd_dq_f32", "cuda", f32_src, jax_attn + ":597", f32_rows["bwd_dq"],
                     f32_train_weights, f32["train"]["flash_attention_bwd_dq_f32"],
                     by_path("flash_attention_bwd_dq_f32")),
        kernel_entry("flash_attention_bwd_dkv_f32", "cuda", f32_src, jax_attn + ":617", f32_rows["bwd_dkv"],
                     f32_train_weights, f32["train"]["flash_attention_bwd_dkv_f32"],
                     by_path("flash_attention_bwd_dkv_f32")),
    ]
    for e in entries:
        if not sum(e["launches_by_path"].values()) > 0:
            fail(f"kernel {e['name']} was launched no time on any main path")
    phase(f"[9] {args.steps}-step restore: {sec:.3f} s/image (fused GroupNorm off {restore_secs[False]:.3f}, on "
        f"{restore_secs[True]:.3f}); at 4 steps staged {options['staged_sec']:.3f}, one CUDA graph "
        f"{options['graph_sec']:.3f} (recording {options['record_sec']:.3f} s; peaks {options['staged_peak']:.2f} / "
        f"{options['record_peak']:.2f} GB, pool {options['pool_gb']:.2f} GB), merged LoRA {options['merged_sec']:.3f}, frozen {options['frozen_sec']:.3f}, "
        f"bf16 decode {options['bf16_sec']:.3f} (decode {options['decode_ms_f32']:.1f} -> {options['decode_ms_bf16']:.1f} "
        f"ms){'; config #4 ' + json.dumps(options['config4']) if 'config4' in options else ''}; load "
        f"{cli['load']['read_s']:.2f} s read + {cli['load']['to_device_s']:.2f} s to the card, text towers "
        f"{cli['text_load']['read_s']:.2f} + {cli['text_load']['to_device_s']:.2f} s, text encoding "
        f"{cli['text_ms']:.2f} ms per prompt pair, CLI (--fused, 4 steps) s/image first call "
        f"{json.dumps({k: round(v, 3) for k, v in cli['cli_first'].items()})}, replay "
        f"{json.dumps({k: round(v, 3) for k, v in cli['cli_replay'].items()})} (PNG read to PNG written), "
        f"with its own load {cli['user_sec']:.3f} s to the first image"
        f"{'; CLI config #4 ' + json.dumps(cli['config4']) if 'config4' in cli else ''}; serving (4 steps): warmup "
        f"{json.dumps([(r['bucket'], round(r['seconds'], 3), round(r['peak_gb'], 3)) for r in serving['warmup']])} "
        f"(bucket, s, peak GB), slot prelude {serving['prelude_sec']:.3f} s, decode {serving['decode_sec']:.3f} s"
        f"{'; serving config #4 ' + json.dumps(serving['config4']) if 'config4' in serving else ''}; stage-2 step at 512² batch 2: {min(stage2['sec_512']):.3f} s, peak "
        f"{stage2['peak_gb_512']:.2f} GB; at 1024² batch 1 with checkpointing: {stage2['sec_1024']:.3f} s, peak "
        f"{stage2['peak_gb_1024']:.2f} GB; stage-1 step at 512² batch 2: {min(train['sec_512']):.3f} s; at 1024² "
        f"batch 1 with checkpointing: {train['sec_1024']:.3f} s; previewer step at 512² batch 2: "
        f"{min(previewer['sec_512']):.3f} s, peak {previewer['peak_gb_512']:.2f} GB, with DINOLoss "
        f"{previewer['sec_dino']:.3f} s, peak {previewer['peak_gb_dino']:.2f} GB; at 1024² batch 1 with "
        f"checkpointing: {previewer['sec_1024']:.3f} s, peak {previewer['peak_gb_1024']:.2f} GB; "
        f"degradation ms per call {json.dumps({k: round(v['ms'], 3) for k, v in train_cli['chain'].items()})}; "
        f"stage-1 s/step of run {json.dumps({k: round(v, 4) for k, v in train_cli['turns'].items()})}; "
        f"checkpoint writes stage 1 {json.dumps(train_cli['stage1_saves'])}, previewer "
        f"{json.dumps(train_cli['previewer_saves'])}, stage 2 {json.dumps(train_cli['stage2_saves'])}; stage-1 "
        f"resume {train_cli['resume_sec']:.2f} s; restores: previewer "
        f"{json.dumps({k: round(v, 3) for k, v in train_cli['previewer_restore'].items()})}, stage 2 "
        f"{json.dumps({k: round(v, 3) for k, v in train_cli['stage2_restore'].items()})}; "
        f"fp32 512² 4-step restore "
        f"{min(f32['restore_sec']):.3f} s/image (peak {f32['peak_gb_restore']:.2f} GB), fp32 stage-1 step at 512² "
        f"batch 1 {f32['train_sec']:.3f} s (peak {f32['peak_gb_train']:.2f} GB); on {card_line}")
    def qlora_line(q):
        return {k: {"s_per_step": round(min(q["sec"][k]), 3), "peak_gb": round(max(q["peak_gb"][k]), 2)}
                for k in ("bf16", "qlora")}

    phase(f"[9] int8: UNet + Aggregator weights {json.dumps({k: round(v, 3) for k, v in quantized['weight_gb'].items()})} "
        f"GB; 1024² 4-step s/image {json.dumps({k: round(v, 3) for k, v in quantized['sec'].items()})}, staged peaks "
        f"{json.dumps({k: round(v, 2) for k, v in quantized['peak_gb'].items()})} GB, PSNR against bf16 "
        f"{json.dumps({k: round(v, 2) for k, v in quantized['psnr'].items()})} dB"
        f"{'; config #4 graphs ' + json.dumps(quantized['config4']) if 'config4' in quantized else ''}; int8 ops ms "
        f"{json.dumps({k: round(v, 4) for k, v in quantized['int8_ms'].items()})}; CLI --quantized w8 "
        f"{cli['cli_w8']['image_seconds']:.3f} s/image; W8 server budget params "
        f"{quantized['serve_w8']['budget']['bf16']['params_gb']} -> {quantized['serve_w8']['budget']['w8']['params_gb']} "
        f"GB; 512² batch-2 steps bf16 vs QLoRA (8-bit AdamW + W8 UNet), peak net of the other trainer: stage 2 "
        f"{json.dumps(qlora_line(stage2['qlora']))}, stage 1 {json.dumps(qlora_line(train['qlora']))}, previewer "
        f"{json.dumps(qlora_line(previewer['qlora']))}; validation renders s "
        f"{json.dumps({k: round(v, 3) for k, v in train_cli['validation_sec'].items()})}; 8-bit stage-1 checkpoint "
        f"{train_cli['qlora_saves'][-1]['bytes'] / 1e9:.2f} GB; on {card_line}")
    phase(f"[9] variants: Aggregator per setting (1024² batch 2) "
        f"{json.dumps({k: {'ms': round(v['sec'] * 1e3, 1), 'rel_l2': v['rel_l2']} for k, v in variants['aggregator'].items()})}; "
        f"zero_sft vs add UNet s/forward {json.dumps({k: round(min(v), 4) for k, v in variants['zero_sft']['timing']['fwd'].items()})}, "
        f"s/(forward + backward) {json.dumps({k: round(min(v), 4) for k, v in variants['zero_sft']['timing']['step'].items()})}, "
        f"peak GB {json.dumps({k: round(max(v), 2) for k, v in variants['zero_sft']['timing']['peak_gb'].items()})}; "
        f"stage 2 at 512² batch 2, s/step plain vs adapter "
        f"{json.dumps({k: round(min(v), 3) for k, v in adapter['turns']['sec'].items()})}, peak "
        f"{json.dumps({k: round(max(v), 2) for k, v in adapter['turns']['peak_gb'].items()})} GB; the CLI with the "
        f"adapter {adapter['cli']['sec_2']:.2f} s (2 steps) and {adapter['cli']['sec_4']:.2f} s (resumed to 4); on "
        f"{card_line}")
    phase(f"[9] CLIP image-prompt encoder (ViT-B/16, 1024² 4 steps): staged {clip_enc['staged_sec']:.3f} s/image, "
        f"one CUDA graph {clip_enc['graph_sec']:.3f} (recording {clip_enc['record_sec']:.3f} s), encoder "
        f"{clip_enc['enc_ms']:.3f} ms, CLI --use_clip_encoder with its own load {clip_enc['cli_sec']:.2f} s (image "
        f"{clip_enc['cli_image_sec']:.3f} s); previewer 512² batch 2 s/step Huber "
        f"{json.dumps([round(x, 3) for x in perceptual['sec']['huber']])} vs Huber + LPIPS + DreamSim "
        f"{json.dumps([round(x, 3) for x in perceptual['sec']['perceptual']])}, peaks "
        f"{json.dumps({k: [round(x, 2) for x in v] for k, v in perceptual['peak_gb'].items()})} GB; ms per forward + "
        f"backward at 512² batch 2 {json.dumps({k: round(v, 2) for k, v in perceptual['ms'].items()})}; MTCNN.detect "
        f"512² {perceptual['mtcnn_ms']:.1f} ms; on {card_line}")
    phase(f"[9] 2048² 4-step restore (vae_tiling): staged {json.dumps([round(x, 3) for x in long_restore['staged_sec']])} "
          f"s/image, one CUDA graph {json.dumps([round(x, 3) for x in long_restore['graph_sec']])} (recording "
          f"{long_restore['record_sec']:.3f} s), peaks {json.dumps({k: round(v, 2) for k, v in long_restore['peak_gb'].items()})} "
          f"GB; sequence parallel on one rank {long_restore['sp_sec']:.3f} s, relative L2 to the dense image "
          f"{long_restore['sp_rel_l2']:.3e}; sharded 1024² restore on one rank {sharded['seconds']:.3f} s; CLI "
          f"--sequence_parallel 1024² {clip_enc['cli_sp']['seconds']:.2f} s; torchrun stage-1 CLI 2 steps "
          f"{stage1_dp['cli_sec']:.2f} s, its resume to 3 {stage1_dp['resume_sec']:.2f} s; on {card_line}")
    tp_text = "; ".join(
        f"model {m}: images {max(r['rel_l2']):.3e} at most (relative L2 from one rank's), weights per rank "
        f"{[round(b / 1e9, 3) for b in r['bytes']['rank']]} of {r['bytes']['whole'] / 1e9:.3f} GB (the JAX rule's even "
        f"share {r['bytes']['jax_rule'] / 1e9:.3f}), restores {[round(x, 2) for x in r['restore_sec']]} s"
        for m, r in tp["runs"].items())
    phase(f"[9] tensor parallelism (ranks on one card, {tp['backend']}): {tp_text}; analytic "
          f"FLOPs per 1024² image {tp['flops30'] / 1e12:.2f} TFLOP (config #4), the 4-step graph replay "
          f"{tp['tflops']:.1f} TFLOP/s ({tp['tflops'] / (PEAK_BF16_FLOPS / 1e12):.1%} of 989); PhaseTimer "
          f"{json.dumps({k: round(v, 4) for k, v in tp['phase_times'].items()})} s; on {card_line}")
    log(json.dumps({"kernels": entries}))
    log(card_line)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--count_flops":
        flops_main(sys.argv[2])
    elif len(sys.argv) >= 4 and sys.argv[1] == "--tp_probe":
        tp_probe_main(int(sys.argv[2]), int(sys.argv[3]))
    elif len(sys.argv) == 6 and sys.argv[1] == "--tp_worker":
        tp_worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
