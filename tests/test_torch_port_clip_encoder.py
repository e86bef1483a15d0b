"""CPU parity of the restore with a CLIP image-prompt encoder (``--use_clip_encoder``).

The slim tiny pipeline of ``tests/test_torch_port_restore_options.py`` with
its DINOv2 replaced by a CLIP vision tower (``CLIPImageEncoder``: the
penultimate layer's tokens) at a width of its own (24), and the Resampler
built with ``embedding_dim`` = that width, as the loaders build it. JAX
parameter trees drawn from a numpy seed, carried into the port by
``convert.py``; the port is fed the JAX run's own draws. Latents and images
are held to the restore's tolerance, 1e-4 of their scale.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.clip_vision import CLIPImageEncoder as JCLIPImageEncoder
from instantir_tpu.models.clip_vision import tiny_clip_vision_config as j_clip_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.pipeline.instantir import InstantIRPipeline as JPipeline
from instantir_tpu.pipeline.instantir import RestoreConfig as JRestoreConfig
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.clip_vision import CLIPImageEncoder, tiny_clip_vision_config
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, build_step_phases
from test_torch_port_restore_options import IMAGE, LATENT, SEED, SLIM, _close, _init_random, _jax_noise

CLIP = dict(hidden_size=24, num_heads=2, num_layers=3)
# mode A on step 0, mode B (the previewer) on step 1, under CFG
STEPS = dict(num_inference_steps=2, guidance_scale=7.0, preview_start=0.5)


@pytest.fixture(scope="module")
def clip_pipelines():
    ucfg, ccfg = j_unet_cfg(**SLIM), j_clip_cfg(**CLIP)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, embedding_dim=ccfg.hidden_size, lora_rank=2)
    unet, agg, vae = JUNet(ucfg), JAggregator(ucfg), JVAE(j_vae_cfg())
    res, enc = JResampler(rcfg), JCLIPImageEncoder(ccfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(vae, 3, np.zeros((1, IMAGE, IMAGE, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(enc, 5, np.zeros((1, ccfg.image_size, ccfg.image_size, 3), np.float32)),
    }
    jpipe = JPipeline(unet, agg, vae, res, enc, j_sdxl_schedule(), params)

    tpipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(),
                           tiny_resampler_config(output_dim=32, embedding_dim=CLIP["hidden_size"], lora_rank=2),
                           tiny_dinov2_config(), device="cpu")
    tpipe.image_encoder = CLIPImageEncoder(tiny_clip_vision_config(**CLIP)).requires_grad_(False).eval()
    tpipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    tpipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    tpipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    tpipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    tpipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_clip_image_encoder(params["image_encoder"], CLIP["num_layers"])), strict=True)
    return jpipe, tpipe


def test_clip_encoder_restore_matches_jax(clip_pipelines):
    """One staged CFG restore with the preview on its second step."""
    jpipe, tpipe = clip_pipelines
    assert [p["mode"] for p in build_step_phases(RestoreConfig(**STEPS))] == ["A", "B"]
    rng = np.random.default_rng(0)
    lq = rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    pe, pp = rng.standard_normal((1, 7, 32)).astype(np.float32), rng.standard_normal((1, 16)).astype(np.float32)
    j_img, _ = jpipe.restore(lq, pe, pp, cfg=JRestoreConfig(**STEPS), key=jax.random.PRNGKey(SEED))
    with torch.no_grad():
        t_img, _ = tpipe.restore(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pp),
                                 cfg=RestoreConfig(**STEPS), noise=_jax_noise(SEED, 2))
    assert t_img.shape == (1, IMAGE, IMAGE, 3)
    _close(t_img, j_img)


def test_clip_encoder_tokens_and_uncond_cache(clip_pipelines):
    """The image tokens and the zero image's tokens against JAX's; the
    uncond cache's key names the encoder's class beside its weights."""
    jpipe, tpipe = clip_pipelines
    lq01 = np.random.default_rng(1).uniform(size=(1, 40, 40, 3)).astype(np.float32)
    j_cond, j_uncond = jpipe.encode_image_embeds(jpipe.params, lq01)
    with torch.no_grad():
        uncond = tpipe._uncond_tokens(32, torch.float32)
        cond, unc = tpipe.encode_image_embeds(torch.from_numpy(lq01), uncond)
    assert cond.shape == (1, 17, CLIP["hidden_size"])
    _close(cond.numpy(), j_cond)
    _close(unc.numpy(), j_uncond)
    key = tpipe._uncond[0]
    assert key[2] is CLIPImageEncoder
