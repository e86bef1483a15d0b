"""CPU parity of the port's restore options with the JAX pipeline's.

The tiny pipeline of ``tests/test_torch_port_pipeline.py`` with one resnet
and one transformer layer a UNet block (JAX parameter trees drawn from a
numpy seed, carried into the port by ``convert.py``); the
port is fed the JAX run's own ``jax.random`` draws. Compatible options share
one JAX restore: the Heun lookahead on a frozen previewer with the preview
row; and a batch-2 restore with DeepCache, adastep, reference latents, the
preview row, the merged previewer LoRA and VAE slicing. Latents
and images are held to the restore's tolerance, 1e-4 of their scale, unless a
test says otherwise.
"""

from __future__ import annotations

import copy
import dataclasses

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
from instantir_tpu.models.vae import tiled_decode as j_tiled_decode
from instantir_tpu.models.vae import tiled_encode_moments as j_tiled_encode_moments
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.pipeline.instantir import InstantIRPipeline as JPipeline
from instantir_tpu.pipeline.instantir import RestoreConfig as JRestoreConfig
from instantir_tpu.pipeline.instantir import build_step_phases as j_build_step_phases
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.layers import LoRAConv2d, LoRALinear
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiled_decode, tiled_encode_moments, tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise, build_step_phases

IMAGE, LATENT, SEED = 32, 16, 11


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


def _jax_noise(seed, n_steps, batch=1, sliced=False):
    """The draws of the JAX staged restore for ``PRNGKey(seed)`` as a
    ``RestoreNoise``: split into (key, k_vae, k_init), one split of ``key``
    per step; a sliced encode draws sample i's posterior noise from the i-th
    split of ``k_vae``."""
    key, k_vae, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (batch, LATENT, LATENT, 4)
    if sliced and batch > 1:
        vae = jnp.concatenate([jax.random.normal(k, (1,) + shape[1:], jnp.float32)
                               for k in jax.random.split(k_vae, batch)])
    else:
        vae = jax.random.normal(k_vae, shape, jnp.float32)
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(jax.random.normal(sub, shape, jnp.float32))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return RestoreNoise(vae=t(vae), init=t(jax.random.normal(k_init, shape, jnp.float32)), steps=[t(s) for s in steps])


# the tiny UNet with one resnet and one transformer layer a block: the same
# topology at half the ops, which halves the JAX compiles that bound this file
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))


@pytest.fixture(scope="module")
def pipelines():
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
    jpipe = JPipeline(unet, agg, vae, res, dino, j_sdxl_schedule(), params)

    tpipe = build_pipeline(tiny_unet_config(**SLIM),
                           tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                           tiny_dinov2_config(), device="cpu")
    tpipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    tpipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    tpipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    tpipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    tpipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def inputs():
    """(lq, prompt, pooled, reference latents) of batch 2, numpy; batch-1 tests take the first row."""
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.standard_normal((2, 7, 32)).astype(np.float32),
            rng.standard_normal((2, 16)).astype(np.float32),
            rng.standard_normal((2, LATENT, LATENT, 4)).astype(np.float32))


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _port(tpipe, inputs, cfg, batch=1, **kw):
    lq, pe, pp, _ = (torch.from_numpy(x[:batch]) for x in inputs)
    return tpipe.restore(lq, pe, pp, cfg=cfg, **kw)


def _jax(jpipe, inputs, cfg, batch=1, **kw):
    lq, pe, pp, _ = (x[:batch] for x in inputs)
    return jpipe.restore(lq, pe, pp, cfg=cfg, key=jax.random.PRNGKey(SEED), **kw)


# ---------------------------------------------------------------------------
# build_step_phases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_inference_steps=6, preview_start=0.25, deepcache_interval=2),
    dict(num_inference_steps=10, control_guidance_end=0.5, deepcache_interval=3, multistep_restore=False),
    dict(num_inference_steps=7, preview_start=0.3, control_guidance_start=0.1, preview_end=0.8,
         multistep_restore=True),
])
def test_build_step_phases_every_key_matches_jax(kw):
    got = build_step_phases(RestoreConfig(**kw))
    assert got == j_build_step_phases(JRestoreConfig(**kw))
    assert all(p["refresh"][0] == 1.0 for p in got) and got[-1]["has_next"][-1] == 0.0


# ---------------------------------------------------------------------------
# The UNet's DeepCache split
# ---------------------------------------------------------------------------


def _unet_inputs(seed=7, b=2):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((b, LATENT, LATENT, 4)).astype(np.float32),
                t=np.array([501, 301][:b], np.int32),
                text=rng.standard_normal((b, 7, 32)).astype(np.float32),
                pooled=rng.standard_normal((b, 16)).astype(np.float32),
                tids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (b, 1)),
                ip=rng.standard_normal((b, 8, 32)).astype(np.float32))


def _torch_unet(tpipe, a, **kw):
    return tpipe.unet(torch.from_numpy(a["x"]).permute(0, 3, 1, 2), torch.from_numpy(a["t"]).long(),
                      torch.from_numpy(a["text"]), torch.from_numpy(a["pooled"]), torch.from_numpy(a["tids"]),
                      ip_hidden_states=torch.from_numpy(a["ip"]), **kw)


@pytest.mark.parametrize("depth", [1, 2])
def test_unet_deepcache_split_matches_jax_and_is_exact(pipelines, depth):
    """The port's split is bit-exact (``shallow(x, deep(x)) == full(x)``, and
    ``return_deep`` leaves the output alone), and its shallow forward over
    that trunk, with the shallow slice's skip residuals added, matches the JAX
    UNet's on the same trunk (the full forward's parity is
    ``test_torch_port_models.py``'s)."""
    jpipe, tpipe = pipelines
    a = _unet_inputs()
    rng = np.random.default_rng(depth)
    # the shallow skip slice at one resnet a block: conv_in, resnet 0 (+ downsample 0, resnet 1 at depth 2)
    shapes = [(32, LATENT), (32, LATENT), (32, LATENT // 2), (64, LATENT // 2)][:2 * depth]
    res = [rng.standard_normal((2, n, n, c)).astype(np.float32) * 0.1 for c, n in shapes]
    with torch.no_grad():
        t_full, t_deep = _torch_unet(tpipe, a, return_deep=True, cache_depth=depth)
        t_plain = _torch_unet(tpipe, a)
        t_again = _torch_unet(tpipe, a, cached_deep=t_deep, cache_depth=depth)
        t_shallow = _torch_unet(tpipe, a, cached_deep=t_deep, cache_depth=depth,
                                down_block_additional_residuals=[torch.from_numpy(r).permute(0, 3, 1, 2) for r in res])
    assert torch.equal(t_full, t_plain) and torch.equal(t_again, t_full)
    j_shallow = jax.jit(lambda p, deep, r: jpipe.unet.apply(
        p, a["x"], a["t"], a["text"], a["pooled"], a["tids"], ip_hidden_states=a["ip"], cache_depth=depth,
        cached_deep=deep, down_block_additional_residuals=r))(jpipe.params["unet"], t_deep.permute(0, 2, 3, 1).numpy(),
                                                              tuple(res))
    _close(t_shallow.permute(0, 2, 3, 1).numpy(), j_shallow)


def test_unet_deepcache_bounds_errors_match_jax(pipelines):
    jpipe, tpipe = pipelines
    a = _unet_inputs(b=1)
    for depth in (0, 3):
        with pytest.raises(ValueError, match=r"cache_depth must be in \[1, 2\]"):
            jpipe.unet.apply(jpipe.params["unet"], a["x"], a["t"], a["text"], a["pooled"], a["tids"],
                             ip_hidden_states=a["ip"], return_deep=True, cache_depth=depth)
        with torch.no_grad(), pytest.raises(ValueError, match=r"cache_depth must be in \[1, 2\]"):
            _torch_unet(tpipe, a, return_deep=True, cache_depth=depth)
    with torch.no_grad(), pytest.raises(ValueError, match="shallow mode expects 2 residuals"):
        _torch_unet(tpipe, a, cached_deep=torch.zeros(1, 64, LATENT, LATENT),
                    down_block_additional_residuals=[torch.zeros(1, 32, LATENT, LATENT)] * 3)


# ---------------------------------------------------------------------------
# The sampler's options against the JAX restore
# ---------------------------------------------------------------------------

# mode B on both steps (the lookahead on step 0, none on the last); the
# previewer frozen at strength 0.7, which takes the place of
# fuse_previewer_lora in both packages
HEUN = dict(num_inference_steps=2, guidance_scale=7.0, lora_alpha=0.7, multistep_restore=True,
            fuse_previewer_lora=True, save_preview_row=True)


@pytest.fixture(scope="module")
def frozen_restores(pipelines, inputs):
    """The HEUN restore (latents) by a JAX and a port pipeline frozen at 0.7:
    (JAX latents, JAX preview row, port latents, port preview row, the port
    pipeline)."""
    jpipe, tpipe = pipelines
    jfrozen = JPipeline(jpipe.unet, jpipe.aggregator, jpipe.vae, jpipe.resampler, jpipe.image_encoder,
                        jpipe.schedule, jpipe.params).freeze_previewer(0.7)
    j_lat, j_row = _jax(jfrozen, inputs, JRestoreConfig(**HEUN), output_type="latent")
    frozen = copy.deepcopy(tpipe).freeze_previewer(0.7)
    t_lat, t_row = _port(frozen, inputs, RestoreConfig(**HEUN), noise=_jax_noise(SEED, 2), output_type="latent")
    return j_lat, j_row, t_lat.numpy(), t_row.numpy(), frozen


def test_heun_frozen_restore_matches_jax(frozen_restores):
    j_lat, _, t_lat, _, _ = frozen_restores
    assert t_lat.shape == (1, LATENT, LATENT, 4)
    _close(t_lat, j_lat)


def test_preview_row_matches_jax(frozen_restores):
    _, j_row, _, t_row, _ = frozen_restores
    assert t_row.shape == (2, 1, LATENT, LATENT, 4)  # the mode-B steps only
    _close(t_row, j_row)


def test_freeze_previewer_frees_the_pairs_and_checks_alpha(frozen_restores, inputs):
    frozen = frozen_restores[4]
    assert not any(isinstance(m, (LoRALinear, LoRAConv2d)) and m.lora_rank for m in frozen.unet.modules())
    assert not any("lora_" in name for name in frozen.unet.state_dict())
    with pytest.raises(ValueError, match="frozen"):
        _port(frozen, inputs, RestoreConfig(num_inference_steps=1, lora_alpha=1.0), output_type="latent")
    with pytest.raises(ValueError, match="already frozen"):
        frozen.freeze_previewer(0.7)


def test_merged_lora_matches_the_dynamic_branch(pipelines, inputs):
    """fuse_previewer_lora against the port's own dynamic LoRA branch (the
    JAX package's test of the same, at its tolerance)."""
    _, tpipe = pipelines
    kw = dict(num_inference_steps=2, guidance_scale=5.0, lora_alpha=0.7)
    merged, _ = _port(tpipe, inputs, RestoreConfig(**kw, fuse_previewer_lora=True), noise=_jax_noise(SEED, 2),
                      output_type="latent")
    dynamic, _ = _port(tpipe, inputs, RestoreConfig(**kw), noise=_jax_noise(SEED, 2), output_type="latent")
    np.testing.assert_allclose(merged.numpy(), dynamic.numpy(), atol=5e-4, rtol=5e-3)


def test_deepcache_with_multistep_raises(pipelines, inputs):
    _, tpipe = pipelines
    cfg = RestoreConfig(num_inference_steps=4, preview_start=0.25, deepcache_interval=2, multistep_restore=True)
    with pytest.raises(ValueError, match="incompatible"):
        _port(tpipe, inputs, cfg, output_type="latent")


# batch 2 under CFG: A on steps 0-1 (fresh, stale; the reference latents as
# its preview), B on steps 2-4 (fresh at the phase start, stale, fresh);
# adastep moves only on fresh steps; the LoRA merged at 0.7; the VAE sliced
# (sample i encoded with its own JAX draw)
OPTIONS = dict(num_inference_steps=5, guidance_scale=7.0, preview_start=0.4, deepcache_interval=2,
               deepcache_depth=1, adastep_restore=True, save_preview_row=True, fuse_previewer_lora=True,
               lora_alpha=0.7, vae_slicing=True)


@pytest.fixture(scope="module")
def option_restores(pipelines, inputs):
    jpipe, tpipe = pipelines
    phases = build_step_phases(RestoreConfig(**OPTIONS))
    assert [(p["mode"], p["refresh"]) for p in phases] == [("A", [1.0, 0.0]), ("B", [1.0, 0.0, 1.0])]
    ref = inputs[3]
    j_img, j_prev = _jax(jpipe, inputs, JRestoreConfig(**OPTIONS), batch=2, reference_latents=ref)
    t_img, t_prev = _port(tpipe, inputs, RestoreConfig(**OPTIONS), batch=2, reference_latents=torch.from_numpy(ref),
                          noise=_jax_noise(SEED, 5, batch=2, sliced=True))
    return j_img, j_prev, t_img, t_prev


def test_deepcache_reference_merged_lora_sliced_restore_matches_jax(option_restores):
    j_img, _, t_img, _ = option_restores
    assert t_img.shape == (2, IMAGE, IMAGE, 3)
    _close(t_img, j_img)


def test_deepcache_preview_row_matches_jax(option_restores):
    """The fresh B steps' previews and the stale one's (the cached preview)."""
    _, j_prev, _, t_prev = option_restores
    assert len(t_prev) == len(j_prev) == 3
    for t, j in zip(t_prev, j_prev):
        _close(t, j)
    np.testing.assert_array_equal(t_prev[0], t_prev[1])


# ---------------------------------------------------------------------------
# The VAE: tiling and the bf16 decode
# ---------------------------------------------------------------------------


def test_tiled_decode_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    z = np.random.default_rng(3).standard_normal((1, LATENT, 12, 4)).astype(np.float32)
    want = j_tiled_decode(jpipe.vae, jpipe.params["vae"], z, tile_latent=8, overlap=0.25)
    with torch.no_grad():
        got = tiled_decode(tpipe.vae, torch.from_numpy(z).permute(0, 3, 1, 2), tile_latent=8, overlap=0.25)
    assert got.shape == (1, 3, IMAGE, 24)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_tiled_encode_moments_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    x = np.random.default_rng(4).uniform(-1, 1, (1, IMAGE, 24, 3)).astype(np.float32)
    j_mean, j_logvar = j_tiled_encode_moments(jpipe.vae, jpipe.params["vae"], x, tile_sample=16, overlap=0.25)
    with torch.no_grad():
        mean, logvar = tiled_encode_moments(tpipe.vae, torch.from_numpy(x).permute(0, 3, 1, 2), tile_sample=16,
                                            overlap=0.25)
    assert mean.shape == (1, 4, LATENT, 12)
    _close(mean.permute(0, 2, 3, 1).numpy(), j_mean)
    _close(logvar.permute(0, 2, 3, 1).numpy(), j_logvar)


def test_pipeline_tiling_and_slicing_wire_the_vae(pipelines):
    """``encode_vae_image`` / ``decode_latents`` with ``tiling=(8, 0.25)``
    run the tiled VAE at 8 latents (16 pixels here) a tile; slicing is the
    batched result."""
    from instantir_tpu_torch.models.vae import scale_latents, tiled_encode, unscale_latents

    _, tpipe = pipelines
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, LATENT, LATENT, 4)).astype(np.float32))
    vae = tpipe.vae
    with torch.no_grad():
        z = tpipe.encode_vae_image(x, eps, tiling=(8, 0.25))
        want = scale_latents(vae.config, tiled_encode(vae, x.permute(0, 3, 1, 2), eps.permute(0, 3, 1, 2),
                                                      tile_sample=16))
        torch.testing.assert_close(z, want, rtol=0, atol=0)
        img = tpipe.decode_latents(z, tiling=(8, 0.25))
        want_img = tiled_decode(vae, unscale_latents(vae.config, z), tile_latent=8).permute(0, 2, 3, 1)
        torch.testing.assert_close(img, want_img, rtol=0, atol=0)
        torch.testing.assert_close(tpipe.encode_vae_image(x, eps, slicing=True), tpipe.encode_vae_image(x, eps),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(tpipe.decode_latents(z, slicing=True), tpipe.decode_latents(z), rtol=1e-5,
                                   atol=1e-5)


# bf16 on both sides, each rounding every layer's output to bf16 after fp32
# sums in another order: measured 2.3e-2 at an output scale of 2.3, about one
# bf16 ulp there (the JAX bf16 decode is itself 2.2e-2 from its fp32 one); a
# wiring fault moves the image by O(1)
BF16_DECODE_TOL = 2e-2


def test_bf16_decode_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    z = np.random.default_rng(5).standard_normal((1, LATENT, LATENT, 4)).astype(np.float32)
    want = np.asarray(jpipe.decode_latents(jpipe.params, z, dtype=jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        got = tpipe.decode_latents(torch.from_numpy(z).permute(0, 3, 1, 2), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tpipe.vae.parameters())
    _close(got.float().numpy(), want, tol=BF16_DECODE_TOL)


def test_decode_dtype_must_be_known(pipelines, inputs):
    _, tpipe = pipelines
    with pytest.raises(ValueError, match="decode_dtype"):
        _port(tpipe, inputs, RestoreConfig(num_inference_steps=1, decode_dtype="float16"))


# ---------------------------------------------------------------------------
# The uncond DINOv2 tokens and the CUDA-graph restore
# ---------------------------------------------------------------------------


def test_uncond_tokens_are_cached_until_the_weights_change(pipelines, inputs):
    _, tpipe = pipelines
    pipe = copy.deepcopy(tpipe)
    calls = []
    pipe.image_encoder.register_forward_hook(lambda m, a, out: calls.append(bool((a[0] == 0).all())))
    cfg = RestoreConfig(num_inference_steps=1)
    first, _ = _port(pipe, inputs, cfg, output_type="latent")
    again, _ = _port(pipe, inputs, cfg, output_type="latent")
    assert calls == [True, False, False] and torch.equal(first, again)
    pipe.image_encoder.load_state_dict(pipe.image_encoder.state_dict())
    _port(pipe, inputs, cfg, output_type="latent")
    assert calls[3:] == [True, False]


def test_fused_needs_a_cuda_device(pipelines, inputs):
    _, tpipe = pipelines
    cfg = dataclasses.replace(RestoreConfig(num_inference_steps=1), fused=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _port(tpipe, inputs, cfg)
