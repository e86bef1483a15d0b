"""CPU parity of the PyTorch port's restore with the JAX pipeline's restore.

One tiny pipeline (the ``tests/test_pipeline.py`` configs) is shared by the
module: JAX parameter trees with the structure of each module's ``init`` and
every leaf drawn from a numpy seed, carried into the port through its
``convert.py``. Both restores run 4 steps at CFG 7 with preview_start 0.1 and
control_guidance_end 0.7, so phases A, B and C all run; the port is fed the
JAX run's own ``jax.random`` draws (key schedule of the staged restore).
"""

from __future__ import annotations

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
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.pipeline.instantir import InstantIRPipeline as JPipeline
from instantir_tpu.pipeline.instantir import RestoreConfig as JRestoreConfig
from instantir_tpu.pipeline.instantir import build_step_phases as j_build_step_phases
from instantir_tpu.pipeline.instantir import rescale_noise_cfg as j_rescale_noise_cfg
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise, build_step_phases, rescale_noise_cfg

IMAGE, LATENT, STEPS, SEED = 32, 16, 4, 11
RESTORE = dict(num_inference_steps=STEPS, guidance_scale=7.0, preview_start=0.1, control_guidance_end=0.7)


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


def _jax_noise(seed, n_steps=STEPS):
    """The draws of ``InstantIRPipeline.restore`` (staged) for ``PRNGKey(seed)``:
    split into (key, k_vae, k_init), then one split of ``key`` per step."""
    key, k_vae, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (1, LATENT, LATENT, 4)
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(jax.random.normal(sub, shape, jnp.float32))
    draws = [jax.random.normal(k_vae, shape, jnp.float32), jax.random.normal(k_init, shape, jnp.float32)] + steps
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.fixture(scope="module")
def pipelines():
    ucfg = j_unet_cfg(with_ip=True, lora_rank=4)
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

    tpipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4),
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
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.standard_normal((1, 7, 32)).astype(np.float32),
            rng.standard_normal((1, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def restored(pipelines, inputs):
    """(JAX latents, JAX image, port latents, port image) of one restore each."""
    jpipe, tpipe = pipelines
    lq, pe, pp = inputs
    jcfg = JRestoreConfig(**RESTORE)
    j_lat, _ = jpipe.restore(lq, pe, pp, cfg=jcfg, key=jax.random.PRNGKey(SEED), output_type="latent")
    j_img, _ = jpipe.restore(lq, pe, pp, cfg=jcfg, key=jax.random.PRNGKey(SEED))
    vae_draw, init_draw, *steps = _jax_noise(SEED)
    noise = RestoreNoise(vae=vae_draw, init=init_draw, steps=steps)
    cfg = RestoreConfig(**RESTORE)
    t_lat, _ = tpipe.restore(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pp), cfg=cfg, noise=noise,
                             output_type="latent")
    t_img, _ = tpipe.restore(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pp), cfg=cfg, noise=noise)
    return np.asarray(j_lat), np.asarray(j_img), t_lat.numpy(), t_img


def test_phases_cover_a_b_c():
    assert [p["mode"] for p in build_step_phases(RestoreConfig(**RESTORE))] == ["A", "B", "C"]


@pytest.mark.parametrize("kw", [
    RESTORE,
    dict(num_inference_steps=30, preview_start=0.1, control_guidance_end=0.7),
    dict(num_inference_steps=10, control_guidance_start=0.2, preview_end=0.5),
    dict(num_inference_steps=5),
    dict(timesteps=(999, 700, 300, 1)),
])
def test_build_step_phases_matches_jax(kw):
    assert build_step_phases(RestoreConfig(**kw)) == j_build_step_phases(JRestoreConfig(**kw))


@pytest.mark.parametrize("guidance_rescale", [0.0, 0.7])
def test_rescale_noise_cfg_matches_jax(guidance_rescale):
    rng = np.random.default_rng(12)
    cfg_pred, text = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_rescale_noise_cfg(cfg_pred, text * 1.5, guidance_rescale))
    got = rescale_noise_cfg(torch.from_numpy(cfg_pred), torch.from_numpy(text * 1.5), guidance_rescale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# fp32 on both sides; 4 steps with CFG 7 amplify the text-uncond difference
# sevenfold each step, so the bound is 1e-4 of the latents' scale (measured:
# 1.2e-4 at a scale of 25, i.e. 5e-6 relative; the image 1e-5 at 2.2) -- a
# wiring fault moves them by O(1).
def test_restore_latents_match_jax(restored):
    j_lat, _, t_lat, _ = restored
    assert t_lat.shape == j_lat.shape == (1, LATENT, LATENT, 4)
    assert np.isfinite(t_lat).all()
    assert np.abs(t_lat - j_lat).max() <= 1e-4 * max(1.0, np.abs(j_lat).max())


def test_restore_image_matches_jax(restored):
    _, j_img, _, t_img = restored
    assert t_img.shape == j_img.shape == (1, IMAGE, IMAGE, 3)
    assert np.isfinite(t_img).all()
    assert np.abs(t_img - j_img).max() <= 1e-4 * max(1.0, np.abs(j_img).max())


def test_restore_options_match_jax(pipelines, inputs):
    """adastep_restore with the CFG single-pass control branch
    (preview_cfg=False, controlnet_cfg=False): 2 steps, phases A and B."""
    jpipe, tpipe = pipelines
    lq, pe, pp = inputs
    kw = dict(num_inference_steps=2, guidance_scale=7.0, preview_start=0.5, adastep_restore=True,
              preview_cfg=False, controlnet_cfg=False)
    assert [p["mode"] for p in build_step_phases(RestoreConfig(**kw))] == ["A", "B"]
    j_lat, _ = jpipe.restore(lq, pe, pp, cfg=JRestoreConfig(**kw), key=jax.random.PRNGKey(SEED), output_type="latent")
    vae_draw, init_draw, *steps = _jax_noise(SEED, n_steps=2)
    t_lat, _ = tpipe.restore(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pp), cfg=RestoreConfig(**kw),
                             noise=RestoreNoise(vae=vae_draw, init=init_draw, steps=steps), output_type="latent")
    j_lat = np.asarray(j_lat)
    assert np.abs(t_lat.numpy() - j_lat).max() <= 1e-4 * max(1.0, np.abs(j_lat).max())


def test_restore_draws_its_own_noise_without_injection(pipelines, inputs):
    _, tpipe = pipelines
    lq, pe, pp = (torch.from_numpy(x) for x in inputs)
    cfg = RestoreConfig(**RESTORE)
    a, _ = tpipe.restore(lq, pe, pp, cfg=cfg, generator=torch.Generator().manual_seed(1), output_type="latent")
    b, _ = tpipe.restore(lq, pe, pp, cfg=cfg, generator=torch.Generator().manual_seed(1), output_type="latent")
    c, _ = tpipe.restore(lq, pe, pp, cfg=cfg, generator=torch.Generator().manual_seed(2), output_type="latent")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-6


@pytest.mark.parametrize("field,value", [("sequence_parallel", True)])
def test_unported_options_raise(pipelines, inputs, field, value):
    """``sequence_parallel`` is ported: without a mesh (``pipe.shard``) it is
    refused as in the JAX package, naming itself."""
    _, tpipe = pipelines
    lq, pe, pp = (torch.from_numpy(x) for x in inputs)
    cfg = dataclasses.replace(RestoreConfig(**RESTORE), **{field: value})
    with pytest.raises(ValueError, match=field):
        tpipe.restore(lq, pe, pp, cfg=cfg)


def test_build_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline(tiny_unet_config(), tiny_vae_config(), tiny_resampler_config(output_dim=32),
                       tiny_dinov2_config())
