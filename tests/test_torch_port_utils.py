"""CPU parity of the port's FLOP counter, profiling helpers and native loader.

* ``utils/flops.py`` against the JAX ``jaxpr_flops``, exactly: the closed
  forms of ``tests/test_flops.py`` (a matmul, a batched einsum, a conv, the
  flash kernel's two products), the tiny UNet forward (LoRA on and off) and a
  tiny restore (the slim tiny UNet of ``tests/test_torch_port_parallel.py``,
  phase A and B with CFG, encode to decode), counted on the port's run on the
  CPU and on the trace of the JAX ``_fused_restore_fn``. The restore's
  image-encoder tokens of the zero image are an input of the JAX program and
  a cached constant of the port's restore: the port's cache is filled before
  the count, so neither side counts them. The flash kernels are counted by
  formula, through the wrappers a CUDA run launches (a restore through the
  kernels counts what the plain one counts).
* ``utils/profiling.py``: ``PhaseTimer`` as ``tests/test_utils.py`` holds
  the JAX one, plus ``sync_on`` and averages; ``device_sync`` on CPU tensors
  and nested structures; ``trace`` writes a Chrome trace Perfetto opens.
* ``data/native_loader.py`` against the JAX binding, bitwise
  (``decode_crop``, ``probe``, ``NativePrefetchLoader``, the corrupt file),
  skipped as ``tests/test_native_loader.py`` is when the library is absent.
No JAX program is compiled: ``jaxpr_flops`` traces.
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instantir_tpu.data import native_loader as jax_native
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.ops.attention import flash_attention as j_flash
from instantir_tpu.pipeline.instantir import RestoreConfig as JRestoreConfig
from instantir_tpu.utils.flops import jaxpr_flops
from instantir_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from instantir_tpu_torch import convert
from instantir_tpu_torch.data import native_loader
from instantir_tpu_torch.models.unet import UNet2DConditionModel, tiny_unet_config
from instantir_tpu_torch.ops.attention import flash_attention
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise
from instantir_tpu_torch.utils import profiling
from instantir_tpu_torch.utils.flops import attention_flops, count_flops, flops
from test_torch_port_parallel import _export_weights, _jax_pipeline, _port_pipeline

RES, BATCH = 32, 2
RESTORE = dict(num_inference_steps=2, guidance_scale=7.0, preview_start=0.5, control_guidance_end=1.0)


# --------------------------------------------------------------------------
# the FLOP counter
# --------------------------------------------------------------------------


def test_closed_forms_match_jaxpr_flops():
    a, b = np.zeros((8, 32), np.float32), np.zeros((32, 16), np.float32)
    assert flops(lambda a, b: a @ b, torch.from_numpy(a), torch.from_numpy(b)) == \
        jaxpr_flops(lambda a, b: a @ b, a, b) == 2 * 8 * 16 * 32
    a, b = np.zeros((4, 8, 32), np.float32), np.zeros((4, 32, 16), np.float32)
    ein = "bik,bkj->bij"
    assert flops(lambda a, b: torch.einsum(ein, a, b), torch.from_numpy(a), torch.from_numpy(b)) == \
        jaxpr_flops(lambda a, b: jnp.einsum(ein, a, b), a, b) == 2 * 4 * 8 * 16 * 32
    x, k = np.zeros((2, 16, 16, 8), np.float32), np.zeros((3, 3, 8, 24), np.float32)
    want = jaxpr_flops(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")), x, k)
    got = flops(lambda x, w: F.conv2d(x, w, padding=1), torch.zeros(2, 8, 16, 16), torch.zeros(24, 8, 3, 3))
    assert got == want == 2 * (2 * 16 * 16 * 24) * 3 * 3 * 8
    # grouped: the weight's input channels are per group on both sides
    got = flops(lambda x, w: F.conv2d(x, w, padding=1, groups=4), torch.zeros(2, 8, 16, 16), torch.zeros(24, 2, 3, 3))
    assert got == 2 * (2 * 16 * 16 * 24) * 3 * 3 * 2


def test_flash_kernel_counts_its_two_products_as_jax():
    b, s, h, d = 2, 512, 4, 64
    q = np.zeros((b, s, h, d), np.float32)
    want = jaxpr_flops(lambda q: j_flash(q, q, q, interpret=True), q)
    tq = torch.from_numpy(q)
    assert flops(lambda q: flash_attention(q, q, q), tq) == want == attention_flops(q.shape, s) == 4 * b * h * s * s * d


def _unet_inputs(cfg, b: int):
    rng = np.random.default_rng(5)
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return dict(sample=rng.normal(size=(b, 16, 16, 4)).astype(np.float32), timesteps=np.full((b,), 500, np.int32),
                encoder_hidden_states=rng.normal(size=(b, 7, cfg.cross_attention_dim)).astype(np.float32),
                added_text_embeds=rng.normal(size=(b, pooled)).astype(np.float32),
                added_time_ids=np.tile(np.float32([[16, 16, 0, 0, 16, 16]]), (b, 1)),
                ip_hidden_states=rng.normal(size=(b, 8, cfg.cross_attention_dim)).astype(np.float32))


@pytest.mark.parametrize("lora_scale", [0.0, 1.0])
def test_tiny_unet_forward_flops_equal_jaxpr_flops(lora_scale):
    jcfg = j_unet_cfg(with_ip=True, lora_rank=4)
    junet = JUNet(jcfg)
    x = _unet_inputs(jcfg, 2)
    params = jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(0), **x))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), params)
    want = jaxpr_flops(lambda p: junet.apply(p, **x, lora_scale=lora_scale), params)
    unet = UNet2DConditionModel(tiny_unet_config(with_ip=True, lora_rank=4))
    unet.load_state_dict(convert.to_torch(convert.export_unet(params)), strict=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        got = flops(lambda: unet(t["sample"].permute(0, 3, 1, 2), t["timesteps"], t["encoder_hidden_states"],
                                 t["added_text_embeds"], t["added_time_ids"], ip_hidden_states=t["ip_hidden_states"],
                                 lora_scale=lora_scale))
    assert got == want, (got, want)
    assert want > 1e6


def test_tiny_restore_flops_equal_jaxpr_flops(tmp_path):
    bundle = _jax_pipeline()
    rng = np.random.default_rng(9)
    ucfg = bundle.unet.config
    pooled_dim = ucfg.projection_class_embeddings_input_dim - ucfg.addition_time_embed_dim * 6
    lq = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    pe = (0.1 * rng.normal(size=(BATCH, 7, ucfg.cross_attention_dim))).astype(np.float32)
    pooled = (0.1 * rng.normal(size=(BATCH, pooled_dim))).astype(np.float32)
    jcfg = JRestoreConfig(**RESTORE)
    size = bundle.image_encoder.config.image_size
    uncond = bundle._ensure_uncond_tokens(bundle.params, (size, size, 3), jnp.float32)
    want = jaxpr_flops(bundle._fused_restore_fn(jcfg), bundle.params, lq, pe, pooled, None, None, uncond,
                       jax.random.PRNGKey(0), None, None)

    _export_weights(bundle, str(tmp_path / "weights.pt"))
    pipe = _port_pipeline(str(tmp_path))
    cfg = RestoreConfig(**RESTORE)
    lat = RES // 2
    noise = RestoreNoise(vae=torch.randn(BATCH, lat, lat, 4), init=torch.randn(BATCH, lat, lat, 4),
                         steps=[torch.randn(BATCH, lat, lat, 4) for _ in range(RESTORE["num_inference_steps"])])
    pipe._uncond_tokens(pipe.image_encoder.config.image_size, torch.float32)  # the JAX program's input
    got, (image, _) = count_flops(pipe.restore, torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pooled),
                                  cfg=cfg, noise=noise)
    assert image.shape == (BATCH, RES, RES, 3)
    assert got == want, (got, want, got - want)


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


@pytest.mark.parametrize("timer_cls", [JPhaseTimer, profiling.PhaseTimer], ids=["jax", "port"])
def test_phase_timer_as_the_jax_one(timer_cls):
    """``tests/test_utils.py::test_phase_timer`` on both timers."""
    t = timer_cls()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    s = t.summary()
    assert "a" in s and s["a"] >= 0


def test_phase_timer_averages_and_syncs_on_tensors():
    t = profiling.PhaseTimer()
    x = torch.ones(4)
    for nap in (0.01, 0.03):
        with t.phase("wait", sync_on={"out": [x * 2]}):
            time.sleep(nap)
    with t.phase("other", sync_on=x):
        pass
    s = t.summary()
    assert set(s) == {"wait", "other"} and t.counts["wait"] == 2 and t.counts["other"] == 1
    assert 0.02 <= s["wait"] < 0.5 and s["wait"] == pytest.approx(t.totals["wait"] / 2)
    profiling.device_sync(x)
    profiling.device_sync((None, [x]))
    profiling.device_sync()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# --------------------------------------------------------------------------
# the native loader
# --------------------------------------------------------------------------


native = pytest.mark.skipif(not native_loader.available(), reason="native loader not built")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, ext in enumerate(["jpg", "png", "jpg"]):
        arr = (rng.uniform(size=(97 + i * 7, 123, 3)) * 255).astype(np.uint8)
        p = str(d / f"img{i}.{ext}")
        Image.fromarray(arr).save(p, quality=95) if ext == "jpg" else Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def test_native_loader_availability_matches_jax():
    assert native_loader.available() == jax_native.available()


@native
def test_decode_crop_and_probe_bitwise_as_jax(image_dir):
    for path in image_dir:
        assert native_loader.probe(path) == jax_native.probe(path)
        for size, seed in ((64, 7), (32, 8), (97, 0)):
            got, want = native_loader.decode_crop(path, size, seed=seed), jax_native.decode_crop(path, size, seed=seed)
            assert got.dtype == np.uint8 and got.shape == (size, size, 3)
            np.testing.assert_array_equal(got, want)


@native
def test_prefetch_loader_bitwise_as_jax(image_dir, tmp_path):
    got = native_loader.NativePrefetchLoader(image_dir, [1.0, 2.0, 1.0], gt_size=32, batch=4, seed=3)
    want = jax_native.NativePrefetchLoader(image_dir, [1.0, 2.0, 1.0], gt_size=32, batch=4, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(got.next(), want.next())
    got.close()
    want.close()
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8garbagegarbage")
    assert native_loader.decode_crop(bad, 32) is None and jax_native.decode_crop(bad, 32) is None
    loader = native_loader.NativePrefetchLoader([bad], None, gt_size=16, batch=2, seed=0)
    assert (loader.next() == 128).all()
    loader.close()
