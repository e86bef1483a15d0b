"""The merged previewer LoRA under bf16 storage against JAX's fp32 storage.

The JAX ``build_pipeline(dtype=jnp.bfloat16)`` builds its modules with bf16
compute and keeps their parameters in fp32 (``instantir_tpu/pipeline/
factory.py``): every kernel is rounded to bf16 at each use, and
``fuse_previewer_lora`` merges ``W + s·B·A`` from the fp32 values and
rounds once. The port's ``build_pipeline`` stores bf16 (norms fp32) and
``merge_lora`` merges the bf16 values. Here the JAX modules are built as
``build_pipeline`` builds them (bf16 compute, fp32 parameters drawn from a
numpy seed; its own ``init`` is left out for its cost) and the same fp32
values are exported into the port's bf16 modules. A one-step CFG restore
with the merged LoRA is then held against JAX's, beside the same restore with
the dynamic LoRA branch, where storage cannot matter for the kernels (JAX
rounds them to bf16 at each use, the port once), and beside JAX's own fused
restore from parameters stored in bf16 (the JAX loader's convention).

The fp32 restore tolerance (1e-4 of scale) cannot hold for a bf16 restore in
either branch: both packages round every layer's output to bf16 after fp32
sums in other orders, and a CFG-7 step amplifies one-ulp differences. The
test holds the merged-LoRA restore to ``BF16_RESTORE_TOL`` of its scale and
to no more than the dynamic branch's distance from JAX: the bf16 merge adds
nothing that the packages' bf16 arithmetic does not already exceed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.layers import merge_lora_tree
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
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.layers import merge_lora
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, build_step_phases
from test_torch_port_restore_options import IMAGE, LATENT, SEED, SLIM, _init_random, _jax_noise

# a one-step CFG-7 restore in bf16 across the two packages, the latents' largest difference over max(1, scale):
# measured 1.78e-2 (merged LoRA) and 2.36e-2 (dynamic LoRA) at a 0.77 scale on the CPU; JAX's fused restore
# against itself with the parameters stored in bf16 instead of fp32, 1.49e-2. A wiring fault moves the latents
# by O(1).
BF16_RESTORE_TOL = 5e-2
STEP = dict(num_inference_steps=1, guidance_scale=7.0)


@pytest.fixture(scope="module")
def bf16_pipelines():
    """(JAX pipeline, fp32 parameters; JAX pipeline, the same rounded to bf16
    (the VAE fp32); the port's bf16 pipeline with the same values)."""
    bf16 = jnp.bfloat16
    ucfg, rcfg, vcfg, dcfg = j_unet_cfg(**SLIM), j_res_cfg(output_dim=32, lora_rank=2), j_vae_cfg(), j_dino_cfg()
    unet, agg, vae = JUNet(ucfg, dtype=bf16), JAggregator(ucfg, dtype=bf16), JVAE(vcfg)
    res, dino = JResampler(rcfg, dtype=bf16), JDINO(dcfg, dtype=bf16)
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
    assert {x.dtype for x in jax.tree_util.tree_leaves(params)} == {np.dtype(np.float32)}
    stored16 = {k: v if k == "vae" else jax.tree_util.tree_map(lambda x: jnp.asarray(x, bf16), v)
                for k, v in params.items()}
    j32 = JPipeline(unet, agg, vae, res, dino, j_sdxl_schedule(), params)
    j16 = JPipeline(unet, agg, vae, res, dino, j_sdxl_schedule(), stored16)

    tpipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(),
                           tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(),
                           dtype=torch.bfloat16, device="cpu")
    tpipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    tpipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    tpipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    tpipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    tpipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    assert tpipe.unet.conv_in.weight.dtype == torch.bfloat16
    return j32, j16, tpipe


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.standard_normal((1, 7, 32)).astype(np.float32), rng.standard_normal((1, 16)).astype(np.float32))


def _jax_latents(jpipe, inputs, **kw):
    lat, _ = jpipe.restore(*inputs, cfg=JRestoreConfig(**STEP, **kw), key=jax.random.PRNGKey(SEED),
                           output_type="latent")
    return np.asarray(lat, np.float32)


def _port_latents(tpipe, inputs, **kw):
    with torch.no_grad():
        lat, _ = tpipe.restore(*(torch.from_numpy(x) for x in inputs), cfg=RestoreConfig(**STEP, **kw),
                               noise=_jax_noise(SEED, 1), output_type="latent")
    return lat.float().numpy()


def _err(got, want) -> float:
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_merged_lora_weights_round_once_in_jax_and_from_bf16_in_the_port(bf16_pipelines):
    """Where the two storages differ: JAX merges the fp32 values and rounds
    once, the port merges values already rounded to bf16. They differ, each
    merged weight by at most one bf16 ulp of its layer's largest value."""
    j32, _, tpipe = bf16_pipelines
    alpha = j32.unet.config.lora_alpha
    jmerged = convert.export_unet(jax.tree_util.tree_map(np.asarray, merge_lora_tree(j32.params["unet"], 1.0,
                                                                                     lora_alpha=alpha)))
    with torch.no_grad():
        tmerged = merge_lora(tpipe.unet, 1.0)
    assert len(tmerged) > 50
    differ = total = 0
    worst = 0.0
    for name, t in tmerged.items():
        got = t.float().numpy()
        want = torch.from_numpy(np.asarray(jmerged[name], np.float32)).bfloat16().float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        worst = max(worst, float(np.abs(got - want).max() / ulp))
        differ += int((got != want).sum())
        total += got.size
    print(f"merged LoRA weights: {differ / total:.3f} of {total} values differ from JAX's fp32 merge, by at most "
          f"{worst} bf16 ulp of their layer's largest value")
    assert differ > 0 and worst <= 1.0


def test_bf16_merged_lora_restore_against_jax_fp32_storage(bf16_pipelines, inputs):
    """A one-step CFG restore with ``fuse_previewer_lora``: the port (bf16
    storage) against JAX's ``build_pipeline`` storage (fp32), within
    ``BF16_RESTORE_TOL`` and no further than the dynamic LoRA branch of the
    same restore is from JAX's; JAX's own fused restore from bf16 storage is
    printed beside it."""
    j32, j16, tpipe = bf16_pipelines
    assert [p["mode"] for p in build_step_phases(RestoreConfig(**STEP))] == ["B"]
    fused = _err(_port_latents(tpipe, inputs, fuse_previewer_lora=True),
                 want := _jax_latents(j32, inputs, fuse_previewer_lora=True))
    dynamic = _err(_port_latents(tpipe, inputs), _jax_latents(j32, inputs))
    jax_storage = _err(_jax_latents(j16, inputs, fuse_previewer_lora=True), want)
    print(f"bf16 one-step CFG restore, max error / scale against JAX (fp32 storage): merged LoRA {fused:.4g}, "
          f"dynamic LoRA {dynamic:.4g}; JAX with bf16 storage, merged {jax_storage:.4g}")
    assert fused <= BF16_RESTORE_TOL and dynamic <= BF16_RESTORE_TOL
    assert fused <= dynamic
