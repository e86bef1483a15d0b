"""CPU parity of the port's validation renders with the JAX package's.

``pipeline/stage1_sdxl.py``, ``train/validation.py`` and ``utils/vis.py``
against their JAX twins on the slimmer tiny models of
``tests/test_torch_port_restore_options.py`` (one resnet and one transformer
layer a UNet block; JAX trees from a numpy seed carried across by
``convert.py``), the port fed the JAX functions' own ``jax.random`` draws
(their ``PRNGKey(0)`` key schedules); stage 2's render, one JAX restore
compile, has a file of its own (``test_torch_port_validation_stage2.py``),
which takes this file's fixture. Each JAX render compiles once; the
pipeline-level comparisons call the programs the renders compiled. Latents
within 1e-4 of their scale, the uint8 strips at most one level apart with
their caption rows bitwise. Then the port alone: ``run`` renders on the
steps ``validation_steps`` divides, and ``cli.train --validation_steps``
writes the tags into the event file.
"""

from __future__ import annotations

import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.pipeline.stage1_sdxl import Stage1Config as JStage1Config
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu.train import common as jcommon
from instantir_tpu.train import validation as jval
from instantir_tpu.utils import vis as jvis
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreNoise
from instantir_tpu_torch.pipeline.stage1_sdxl import Stage1Config, Stage1SDXLPipeline
from instantir_tpu_torch.schedulers.diffusion import sdxl_schedule
from instantir_tpu_torch.train import validation as tval
from instantir_tpu_torch.utils import vis as tvis

IMAGE, LATENT, BATCH = 32, 16, 2
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
STAGE1_STEPS = 2
# stage 2 renders config #4 (preview_start 0.1, control_guidance_end 0.7) in 10 steps: modes A, B and C
STAGE2_STEPS = 10
ALPHA = 0.8  # the previewer's LoRA strength (the trainers' cfg.lora_alpha)


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _init_random(module, seed, *args, **kwargs):
    return _random_tree(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)), seed)


class _Tracker:
    """Keeps what the renders log: ``{tag: (step, images in [0, 1])}``."""

    def __init__(self):
        self.logged = {}

    def images(self, step, tag, images):
        self.logged[tag] = (step, np.asarray(images))


@pytest.fixture(scope="module")
def trainers():
    """(JAX trainer stand-in, port trainer stand-in, inputs): the attributes
    the validation functions read, over the same weights."""
    ucfg = j_unet_cfg(**SLIM)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    unet, agg, vae, res, dino = JUNet(ucfg), JAggregator(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(vae, 3, np.zeros((1, IMAGE, IMAGE, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    trainable, frozen = jcommon.partition_params(params, lambda path: False)
    jtr = types.SimpleNamespace(unet=unet, aggregator=agg, vae=vae, resampler=res, image_encoder=dino,
                                schedule=j_sdxl_schedule(), trainable=trainable, frozen=frozen,
                                cfg=types.SimpleNamespace(lora_alpha=ALPHA))
    pipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(), device="cpu")
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    pipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    ttr = types.SimpleNamespace(unet=pipe.unet, aggregator=pipe.aggregator, vae=pipe.vae, resampler=pipe.resampler,
                                image_encoder=pipe.image_encoder, schedule=sdxl_schedule(), device=torch.device("cpu"),
                                cfg=types.SimpleNamespace(lora_alpha=ALPHA))
    rng = np.random.default_rng(9)
    lq = rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[IMAGE, IMAGE, 0, 0, IMAGE, IMAGE]], np.float32), (BATCH, 1))}
    return jtr, ttr, dict(lq=lq, gt=gt, cond=cond)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _stage1_draws():
    """The JAX ``Stage1SDXLPipeline`` draws for ``PRNGKey(0)``: the initial
    latents from the first split, each step's noise from the next split of
    the carried key."""
    key, k_init = jax.random.split(jax.random.PRNGKey(0))
    shape = (BATCH, LATENT, LATENT, 4)
    steps = []
    for _ in range(STAGE1_STEPS):
        key, sub = jax.random.split(key)
        steps.append(_t(jax.random.normal(sub, shape, jnp.float32)))
    return _t(jax.random.normal(k_init, shape, jnp.float32)), steps


def _stage2_noise():
    """The JAX staged restore's draws for ``PRNGKey(0)``."""
    key, k_vae, k_init = jax.random.split(jax.random.PRNGKey(0), 3)
    shape = (BATCH, LATENT, LATENT, 4)
    steps = []
    for _ in range(STAGE2_STEPS):
        key, sub = jax.random.split(key)
        steps.append(_t(jax.random.normal(sub, shape, jnp.float32)))
    return RestoreNoise(vae=_t(jax.random.normal(k_vae, shape, jnp.float32)),
                        init=_t(jax.random.normal(k_init, shape, jnp.float32)), steps=steps)


def _strips_close(got, want):
    """uint8 strips of equal shape: the 24 caption rows bitwise, the images at most one level apart."""
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :24], want[:, :24])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()


@pytest.fixture(scope="module")
def stage1_renders(trainers):
    jtr, ttr, x = trainers
    jtracker, ttracker = _Tracker(), _Tracker()
    jval.validate_stage1(jtr, x["lq"], x["gt"], x["cond"], jtracker, 7, num_steps=STAGE1_STEPS)
    latents, steps = _stage1_draws()
    strips = tval.validate_stage1(ttr, x["lq"], x["gt"], {k: _t(v) for k, v in x["cond"].items()}, ttracker, 7,
                                  num_steps=STAGE1_STEPS, latents=latents, step_noise=steps)
    return jtracker, ttracker, strips


def test_validate_stage1_strips_match_jax(stage1_renders):
    jtracker, ttracker, strips = stage1_renders
    step, jimages = jtracker.logged["validation/stage1"]
    assert step == 7 and strips.shape == (BATCH, 24 + IMAGE, 3 * IMAGE, 3)
    want = np.rint(jimages * 255.0).astype(np.uint8)
    _strips_close(strips, want)
    assert ttracker.logged["validation/stage1"][0] == 7
    np.testing.assert_array_equal(ttracker.logged["validation/stage1"][1], strips.astype(np.float32) / 255.0)


def test_stage1_pipeline_latents_match_jax(trainers, stage1_renders):
    """``Stage1SDXLPipeline`` (2 steps, CFG 5: zero negative embeddings, the
    ip tokens repeated) against the JAX pipeline the render compiled, on the
    same tokens and draws: the latents within 1e-4 of their scale."""
    jtr, ttr, x = trainers
    jpipe = jtr._val_cache["stage1_pipe"]
    ip = jval._ip_tokens_fn(jtr, 0.0)(jpipe.params, x["lq"])
    want = jpipe(x["cond"]["prompt_embeds"], x["cond"]["pooled_embeds"], ip, height=IMAGE, width=IMAGE,
                 cfg=JStage1Config(num_inference_steps=STAGE1_STEPS, guidance_scale=5.0), key=jax.random.PRNGKey(0))
    latents, steps = _stage1_draws()
    tpipe = Stage1SDXLPipeline(ttr.unet, ttr.vae, ttr.resampler, ttr.image_encoder, ttr.schedule, device="cpu")
    got = tpipe(_t(x["cond"]["prompt_embeds"]), _t(x["cond"]["pooled_embeds"]), _t(ip), height=IMAGE, width=IMAGE,
                cfg=Stage1Config(num_inference_steps=STAGE1_STEPS, guidance_scale=5.0), latents=latents,
                step_noise=steps)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.fixture(scope="module")
def previewer_renders(trainers):
    jtr, ttr, x = trainers
    jtracker = _Tracker()
    jval.validate_previewer(jtr, x["lq"], x["gt"], x["cond"], jtracker, 3)
    noise = _t(jax.random.normal(jax.random.PRNGKey(0), (BATCH, LATENT, LATENT, 4), jnp.float32))
    strips = tval.validate_previewer(ttr, x["lq"], x["gt"], {k: _t(v) for k, v in x["cond"].items()}, None, 3,
                                     noise=noise)
    return jtracker, strips, noise


def test_validate_previewer_strips_match_jax(previewer_renders):
    jtracker, strips, _ = previewer_renders
    step, jimages = jtracker.logged["validation/previewer_one_step"]
    assert step == 3
    _strips_close(strips, np.rint(jimages * 255.0).astype(np.uint8))


def test_one_step_preview_matches_jax(trainers, previewer_renders):
    """``one_step_preview`` at t = 999 (LoRA strength ``ALPHA``) on the JAX
    render's own noised LQ latent and ip tokens, against the program the JAX
    render compiled: within 1e-4 of the latents' scale."""
    jtr, ttr, x = trainers
    jpipe = jtr._val_cache["stage1_pipe"]
    noisy = jtr._val_cache["previewer_encode"](jpipe.params, x["lq"], jax.random.PRNGKey(0))
    ip = jval._ip_tokens_fn(jtr, ALPHA)(jpipe.params, x["lq"])
    want = np.asarray(jpipe.one_step_preview(noisy, 999, x["cond"], ip, lora_scale=ALPHA))
    tpipe = Stage1SDXLPipeline(ttr.unet, ttr.vae, ttr.resampler, ttr.image_encoder, ttr.schedule, device="cpu")
    got = tpipe.one_step_preview(_t(noisy), 999, {k: _t(v) for k, v in x["cond"].items()}, _t(ip), lora_scale=ALPHA)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_merge_previewer_lora_inplace_matches_the_dynamic_branch(trainers):
    """The merged previewer LoRA at strength 0.7, sampled with
    ``lora_scale=0``, against the dynamic branch at 0.7 (fp32: summation
    order only); the pairs are gone afterwards, and a quantized UNet refuses
    the merge."""
    import copy

    from instantir_tpu_torch.ops import quant

    _, ttr, x = trainers
    latents, steps = _stage1_draws()
    cond = (_t(x["cond"]["prompt_embeds"]), _t(x["cond"]["pooled_embeds"]), torch.zeros(BATCH, 8, 32))
    unet = copy.deepcopy(ttr.unet)
    dynamic = Stage1SDXLPipeline(unet, ttr.vae, ttr.resampler, ttr.image_encoder, ttr.schedule, device="cpu")
    want = dynamic(*cond, height=IMAGE, width=IMAGE, latents=latents, step_noise=steps,
                   cfg=Stage1Config(num_inference_steps=STAGE1_STEPS, lora_scale=0.7))
    assert dynamic.merge_previewer_lora_inplace(0.7) is dynamic
    assert not any("lora_" in n for n in unet.state_dict())
    got = dynamic(*cond, height=IMAGE, width=IMAGE, latents=latents, step_noise=steps,
                  cfg=Stage1Config(num_inference_steps=STAGE1_STEPS, lora_scale=0.0))
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max().item())
    qunet = quant.quantize_tree(copy.deepcopy(ttr.unet), min_size=2048, weight_only=True)
    with pytest.raises(ValueError, match="quantized"):
        Stage1SDXLPipeline(qunet, ttr.vae, ttr.resampler, ttr.image_encoder, ttr.schedule,
                           device="cpu").merge_previewer_lora_inplace(1.0)


# ---------------------------------------------------------------------------
# utils/vis.py
# ---------------------------------------------------------------------------


def test_vis_helpers_match_jax():
    rng = np.random.default_rng(11)
    a, b, c = (rng.integers(0, 256, (20, 28, 3), dtype=np.uint8) for _ in range(3))
    np.testing.assert_array_equal(tvis.add_text_to_image(a, "restored"), jvis.add_text_to_image(a, "restored"))
    np.testing.assert_array_equal(tvis.triplet_strip(a, b, c), jvis.triplet_strip(a, b, c))
    np.testing.assert_array_equal(tvis.triplet_strip(a, b), jvis.triplet_strip(a, b))
    for cols in (None, 2):
        np.testing.assert_array_equal(tvis.image_grid([a, b, c], cols), jvis.image_grid([a, b, c], cols))
    content = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)  # NHWC for the JAX twin
    style = (2.0 + 3.0 * rng.standard_normal((2, 4, 7, 3))).astype(np.float32)
    nchw = lambda v: torch.from_numpy(v).permute(0, 3, 1, 2)  # noqa: E731
    for got, want in zip(tvis.calc_mean_std(nchw(style)), jvis.calc_mean_std(jnp.asarray(style))):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got = tvis.adaptive_instance_normalization(nchw(content), nchw(style)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jvis.adaptive_instance_normalization(jnp.asarray(content),
                                                                                   jnp.asarray(style))),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the host loop and the training CLI
# ---------------------------------------------------------------------------


def _tiny_pipe():
    return build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(), device="cpu")


def test_run_renders_on_the_steps_validation_steps_divides(monkeypatch):
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config as TrainConfig
    from instantir_tpu_torch.train.stage1_adapter import Stage1Trainer

    pipe = _tiny_pipe()
    cfg = TrainConfig(output_dir="", max_train_steps=5, train_batch_size=1, resolution=IMAGE, lr_warmup_steps=0,
                      validation_steps=2, prefetch_batches=0, logging_steps=100)
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cpu")
    seen = []
    monkeypatch.setattr(trainer, "validate", lambda val, cond: seen.append((trainer.global_step, cond)) or "strips")
    cond = {"prompt_embeds": torch.zeros(1, 7, 32), "pooled_embeds": torch.zeros(1, 16),
            "time_ids": torch.tensor([[IMAGE, IMAGE, 0, 0, IMAGE, IMAGE]], dtype=torch.float32)}
    x = torch.zeros(1, IMAGE, IMAGE, 3)
    data = iter([{"lq": x, "gt": x}] * 5)
    trainer.run(data, cond, val_batch={"lq": x, "gt": x})
    assert [s for s, _ in seen] == [2, 4] and seen[0][1] is cond and trainer.last_validation == "strips"
    trainer.run(iter([]), cond)  # no val_batch: no render
    assert len(seen) == 2


def _events(path):
    """The ``Event`` protos of a TFRecord event file."""
    from tensorboardX.proto import event_pb2

    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        out.append(event_pb2.Event.FromString(data[i + 12:i + 12 + n]))
        i += 12 + n + 4
    return out


@pytest.mark.parametrize("stage,tag", [("stage1", "validation/stage1"), ("previewer", "validation/previewer_one_step"),
                                       ("stage2", "validation/instantir")])
def test_cli_train_validation_writes_the_tag(tmp_path, stage, tag):
    """``cli.train --validation_steps 1 --validation_image a b`` on the tiny
    models (CPU, 64² synthetic data, 1 step): the event file holds the
    stage's validation image, a grid of the two strips of the images resized
    to ``--resolution``."""
    from PIL import Image

    from instantir_tpu_torch.cli import train as ct

    paths = []
    for i, size in enumerate(((80, 48), (64, 64))):
        paths.append(str(tmp_path / f"v{i}.png"))
        Image.fromarray(np.random.default_rng(i).integers(0, 256, size[::-1] + (3,), dtype=np.uint8)).save(paths[-1])
    out = tmp_path / "out"
    result = ct.main([stage, "--synthetic_data", "--resolution", "64", "--train_batch_size", "2", "--max_train_steps",
                      "1", "--lr_warmup_steps", "0", "--prefetch_batches", "0", "--losses_config", "none",
                      "--output_dir", str(out), "--validation_steps", "1", "--validation_image", *paths],
                     device="cpu", pipe=_tiny_pipe())
    trainer = result["trainer"]
    assert trainer.last_validation.shape == (2, 24 + 64, 3 * 64, 3)
    logs = out / "logs"
    (name,) = os.listdir(logs)
    images = [(e.step, v) for e in _events(logs / name) for v in e.summary.value if v.HasField("image")]
    assert [(s, v.tag) for s, v in images] == [(1, tag)]
    assert (images[0][1].image.height, images[0][1].image.width) == (24 + 64, 2 * 3 * 64)
