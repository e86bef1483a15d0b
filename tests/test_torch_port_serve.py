"""Serving in the PyTorch port: the slot sampler, the two servers and the demo app.

The slot sampler (``pipeline/slots.py``) is held to the JAX ``SlotSampler``
at the slim tiny configs of ``tests/test_torch_port_restore_options.py``
(one resnet and one transformer layer a UNet block; JAX parameter trees drawn
from a numpy seed, carried into the port by ``convert.py``): the step tables
exactly, ``prelude`` fed the JAX draws (1e-5 relative) and one slot stepped
to the end on JAX's per-slot draws (1e-4 of the latents' scale). One JAX
``prelude`` and one JAX ``step`` are compiled for the file. The rest holds
the port alone: slot invariance, the guards, the whole-request and
continuous servers (``fused=False`` on the CPU, a stub text encoder), the
memory budget, the HTTP layers and the demo app's adapter swap, whose
``load_lcm_lora_variant`` is held to the JAX one on the same file.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import io
import json
import os
import sys
import threading
import zlib
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.cli.app import extract_unet_lora as j_extract_unet_lora
from instantir_tpu.cli.app import load_lcm_lora_variant as j_load_lcm_lora_variant
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
from instantir_tpu.pipeline.slots import SlotSampler as JSlotSampler
from instantir_tpu.pipeline.slots import build_step_tables as j_build_step_tables
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu.train.common import LORA_PARAM_PRED, merge_params, partition_params
from instantir_tpu_torch import convert
from instantir_tpu_torch.cli.infer import DEFAULT_NEG_PROMPT
from instantir_tpu_torch.cli.app import InstantIRApp, extract_unet_lora, load_lcm_lora_variant, make_demo_http_server
from instantir_tpu_torch.cli.serve import (
    ContinuousRestoreServer,
    RestoreServer,
    ServeConfig,
    _Request,
    estimate_hbm_budget,
    make_http_server,
    to_uint8,
)
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import MAX_GRAPHS, RestoreConfig
from instantir_tpu_torch.pipeline.slots import SlotSampler, build_step_tables

IMAGE, LATENT = 32, 16  # the tiny VAE halves the image
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
# steps 0 -> A, 1 -> B, 2-3 -> C
SLOT_CFG = dict(num_inference_steps=4, guidance_scale=7.0, preview_start=0.1, control_guidance_end=0.7)
# steps 0-1 -> A, 2-3 -> B, 4-5 -> C (the JAX slot tests' schedule)
MIXED_CFG = dict(num_inference_steps=6, guidance_scale=7.0, preview_start=0.2, control_guidance_end=0.7)
SEED = 11


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


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline on the CPU) on the same random weights."""
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

    tpipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                           tiny_dinov2_config(), device="cpu")
    tpipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    tpipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    tpipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    tpipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    tpipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    return jpipe, tpipe


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
            (0.1 * rng.standard_normal((1, 7, 32))).astype(np.float32),
            (0.1 * rng.standard_normal((1, 16))).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _nchw(x) -> np.ndarray:
    return np.asarray(x).transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# The slot sampler against the JAX one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    SLOT_CFG,
    MIXED_CFG,
    dict(num_inference_steps=10, preview_start=0.3, control_guidance_start=0.1, preview_end=0.8,
         control_guidance_end=0.9),
    dict(num_inference_steps=30, preview_start=0.1, control_guidance_end=0.7),
])
def test_step_tables_equal_jax(kw):
    got, want = build_step_tables(RestoreConfig(**kw)), j_build_step_tables(JRestoreConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    keep, pv = got["keep"], got["previewing"]
    assert (keep == 1).any() and (pv == 1).any() and (keep == 0).any() and ((keep == 1) & (pv == 0)).any()


@pytest.fixture(scope="module")
def jax_slot(pipelines):
    """The JAX sampler's prelude payload and a slot's final latents for
    ``PRNGKey(SEED)``, with the draws it made: (payload, final latents,
    k_vae draw, k_init draw, per-step draws), NHWC."""
    jpipe, _ = pipelines
    lq, pe, pooled = _inputs()
    sampler = JSlotSampler(jpipe, JRestoreConfig(**SLOT_CFG), IMAGE, n_slots=1)
    key = jax.random.PRNGKey(SEED)
    payload = sampler.prelude(jnp.asarray(lq), jnp.asarray(pe), jnp.asarray(pooled), None, None, key)
    state = sampler.insert(sampler.empty_state(payload), payload, 0)
    for _ in range(sampler.n_steps):
        state = sampler.step(state)
    key, k_vae, k_init = jax.random.split(key, 3)
    shape = (1, LATENT, LATENT, 4)
    steps = []
    for _ in range(sampler.n_steps):  # the twin's per-slot split: (new key, sub) per executed step
        key, sub = jax.random.split(key, 2)
        steps.append(np.array(jax.random.normal(sub, shape, jnp.float32)[0]))
    assert int(np.asarray(state.step_idx)[0]) == sampler.n_steps
    return ({k: np.array(v) for k, v in payload.items()}, np.array(state.latents),
            np.array(jax.random.normal(k_vae, shape, jnp.float32)),
            np.array(jax.random.normal(k_init, shape, jnp.float32)), steps)


def _port_payload(sampler, jax_draws, seed=0):
    lq, pe, pooled = _inputs(seed)
    return sampler.prelude(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pooled),
                           noise_vae=torch.from_numpy(jax_draws[2]), noise_init=torch.from_numpy(jax_draws[3]))


def test_prelude_matches_jax(pipelines, jax_slot):
    _, tpipe = pipelines
    sampler = SlotSampler(tpipe, RestoreConfig(**SLOT_CFG), IMAGE, n_slots=1)
    got = _port_payload(sampler, jax_slot)
    want = jax_slot[0]
    for name in ("latents", "image_latent"):
        _close(got[name].permute(0, 2, 3, 1).numpy(), want[name], 1e-5)
    for name in ("ip_base_u", "ip_base_c", "ip_lora_u", "ip_lora_c"):
        _close(got[name].numpy(), want[name], 1e-5)
    assert not np.allclose(want["ip_base_c"], want["ip_lora_c"])  # the LoRA is on in one set


def test_slot_matches_jax_slot(pipelines, jax_slot):
    """One slot stepped to the end on the JAX slot's own draws ends at the
    JAX slot's latents; every step's draw is taken only by the active slot."""
    _, tpipe = pipelines
    sampler = SlotSampler(tpipe, RestoreConfig(**SLOT_CFG), IMAGE, n_slots=1)
    payload = _port_payload(sampler, jax_slot)
    state = sampler.insert(sampler.empty_state(payload), payload, 0)
    variants = []
    for draw in jax_slot[4]:
        variants.append(sampler.variant(state.host_idx))
        sampler.step(state, noise=torch.from_numpy(draw).permute(2, 0, 1)[None])
    assert variants == ["aggregator", "previewer", "plain", "plain"]
    assert state.host_idx == [4] and state.step_idx.tolist() == [4]
    _close(state.latents.permute(0, 2, 3, 1).numpy(), jax_slot[1], 1e-4)


# ---------------------------------------------------------------------------
# The port's own slot invariants and guards
# ---------------------------------------------------------------------------


def _own_payload(sampler, seed):
    lq, pe, pooled = _inputs(seed)
    return sampler.prelude(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pooled),
                           generator=torch.Generator().manual_seed(seed))


def _run_alone(sampler, seed, slot):
    payload = _own_payload(sampler, seed)
    state = sampler.insert(sampler.empty_state(payload), payload, slot)
    for _ in range(sampler.n_steps):
        sampler.step(state)
    return state.latents[slot].clone()


def test_slot_invariant_to_batch_composition(pipelines):
    """B admitted three steps into A leaves A's latents bitwise equal to A
    alone, and B ends equal to B alone; each slot draws from its own
    generator only on the steps it executes."""
    _, tpipe = pipelines
    sampler = SlotSampler(tpipe, RestoreConfig(**MIXED_CFG), IMAGE, n_slots=2)
    alone_a, alone_b = _run_alone(sampler, 1, 0), _run_alone(sampler, 2, 1)

    pay_a, pay_b = _own_payload(sampler, 1), _own_payload(sampler, 2)
    state = sampler.insert(sampler.empty_state(pay_a), pay_a, 0)
    for _ in range(3):
        sampler.step(state)
    sampler.insert(state, pay_b, 1)
    variants = []
    for _ in range(sampler.n_steps - 3):
        variants.append(sampler.variant(state.host_idx))
        sampler.step(state)
    assert state.host_idx == [6, 3] and state.step_idx.tolist() == [6, 3]
    # (A, B) in modes (B, A), (C, A), (C, B)
    assert variants == ["previewer", "aggregator", "previewer"]
    assert torch.equal(state.latents[0], alone_a)
    for _ in range(3):
        sampler.step(state)
    assert torch.equal(state.latents[1], alone_b)


def test_lone_slot_follows_restore_with_its_generator(pipelines):
    """A slot's draws continue its prelude's generator in ``restore``'s
    order, so one slot alone ends at ``restore(generator=...)``'s latents."""
    _, tpipe = pipelines
    cfg = RestoreConfig(**SLOT_CFG)
    sampler = SlotSampler(tpipe, cfg, IMAGE, n_slots=1)
    got = _run_alone(sampler, 5, 0)
    lq, pe, pooled = _inputs(5)
    want, _ = tpipe.restore(torch.from_numpy(lq), torch.from_numpy(pe), torch.from_numpy(pooled), cfg=cfg,
                            generator=torch.Generator().manual_seed(5), output_type="latent")
    assert torch.equal(got, want[0].permute(2, 0, 1))


def test_idle_slots_are_inert(pipelines):
    _, tpipe = pipelines
    sampler = SlotSampler(tpipe, RestoreConfig(**MIXED_CFG), IMAGE, n_slots=2)
    payload = _own_payload(sampler, 3)
    state = sampler.insert(sampler.empty_state(payload), payload, 1)
    state.latents[0].normal_(generator=torch.Generator().manual_seed(0))
    before = state.latents[0].clone()
    sampler.step(state)
    assert torch.equal(state.latents[0], before)
    assert state.step_idx.tolist() == [6, 1] and state.host_idx == [6, 1]
    sampler.evict(state)
    assert sampler.variant(state.host_idx) is None and sampler.step(state) is state
    assert state.step_idx.tolist() == [6, 6]


@pytest.mark.parametrize("kw,match", [
    (dict(deepcache_interval=2), "deepcache"),
    (dict(multistep_restore=True), "slot serving does not support RestoreConfig.multistep_restore"),
    (dict(adastep_restore=True), "slot serving does not support RestoreConfig.adastep_restore"),
    (dict(save_preview_row=True), "slot serving does not support RestoreConfig.save_preview_row"),
    (dict(fused=True), "slot serving does not support RestoreConfig.fused"),
    (dict(fuse_previewer_lora=True), "slot serving does not support RestoreConfig.fuse_previewer_lora"),
])
def test_slot_sampler_guards(pipelines, kw, match):
    _, tpipe = pipelines
    with pytest.raises(ValueError, match=match):
        SlotSampler(tpipe, RestoreConfig(**kw), IMAGE, 1)
    with pytest.raises(ValueError, match=match):  # the JAX twin's message
        JSlotSampler(pipelines[0], JRestoreConfig(**kw), IMAGE, 1)


def test_slot_sampler_refuses_frozen_previewer_and_cpu_graphs(pipelines):
    _, tpipe = pipelines
    frozen = copy.deepcopy(tpipe).freeze_previewer()
    with pytest.raises(ValueError, match="slot serving does not support freeze_previewer pipelines"):
        SlotSampler(frozen, RestoreConfig(), IMAGE, 1)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        SlotSampler(tpipe, RestoreConfig(), IMAGE, 1, graphs=True)
    assert not SlotSampler(tpipe, RestoreConfig(), IMAGE, 1).graphs


# ---------------------------------------------------------------------------
# The servers (port alone, fused=False on the CPU)
# ---------------------------------------------------------------------------


def _encode(prompts):
    """Stub text encoder: deterministic embeddings per prompt."""
    rngs = [np.random.default_rng(zlib.crc32(p.encode())) for p in prompts]
    pe = np.stack([r.normal(size=(7, 32)).astype(np.float32) * 0.1 for r in rngs])
    pooled = np.stack([r.normal(size=(16,)).astype(np.float32) * 0.1 for r in rngs])
    return pe, pooled


SERVE = dict(num_inference_steps=2, preview_start=0.0, creative_start=1.0, fused=False, limit_gb=1.0)


@pytest.fixture(scope="module")
def server(pipelines):
    _, tpipe = pipelines
    calls = []

    def encode(prompts):
        calls.append(list(prompts))
        return _encode(prompts)

    srv = RestoreServer(tpipe, encode, ServeConfig(batch_size=2, batch_wait_ms=50.0, resolution=IMAGE, **SERVE))
    srv.start(warmup=True)
    srv._encode_calls = calls
    yield srv
    srv.stop()


def test_server_single_request_roundtrip(server):
    img = (np.random.default_rng(0).uniform(0, 255, size=(48, 40, 3))).astype(np.uint8)
    out = server.submit(img, prompt="a cat", timeout=300)
    assert out.shape == (48, 40, 3) and out.dtype == np.uint8  # back at the input's size


def test_server_concurrent_requests_share_a_batch(server):
    before = server.batches_run
    results = {}

    def call(i):
        results[i] = server.submit(np.full((IMAGE, IMAGE, 3), 10 * i, np.uint8), prompt="same prompt", timeout=300)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert all(results[i].shape == (IMAGE, IMAGE, 3) for i in range(2))
    assert server.batches_run - before <= 2  # one batch unless the worker took the first alone


def test_server_prompt_embed_cache(server):
    n_before = sum(len(c) for c in server._encode_calls)
    img = np.zeros((IMAGE, IMAGE, 3), np.uint8)
    server.submit(img, prompt="a cached prompt", timeout=300)
    server.submit(img, prompt="a cached prompt", timeout=300)
    assert "a cached prompt" in {p for c in server._encode_calls for p in c}
    assert sum(len(c) for c in server._encode_calls) - n_before <= 2  # 1 novel prompt + possibly its negative


def _queued_request(i=0):
    return _Request(image=np.full((IMAGE, IMAGE, 3), 0.01 * i, np.float32), prompt="drain test", neg_prompt="",
                    out_size=(IMAGE, IMAGE))


def test_server_drain_finishes_queued_requests(server):
    srv2 = RestoreServer(server.pipe, server.encode_fn, server.cfg)
    reqs = [_queued_request(i) for i in range(3)]  # > batch_size=2: two batches
    for r in reqs:
        srv2._enqueue(r)
    srv2._worker.start()
    srv2.drain(timeout=600)
    for r in reqs:
        assert r.done.is_set() and r.error is None
        assert r.result.shape == (IMAGE, IMAGE, 3)
    with pytest.raises(RuntimeError, match="draining"):
        srv2.submit(np.zeros((IMAGE, IMAGE, 3), np.uint8))


def test_server_stop_unblocks_queued_waiters(server):
    srv2 = RestoreServer(server.pipe, server.encode_fn, server.cfg)
    req = _queued_request()
    srv2._enqueue(req)
    srv2.stop()  # the worker never started: the request can only be flushed
    assert req.done.is_set() and isinstance(req.error, RuntimeError)


def _serve_http(srv):
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)


def test_server_http_roundtrip(server):
    from PIL import Image

    httpd, conn = _serve_http(server)
    try:
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        assert health.status == 200 and b'"ok": true' in health.read()
        buf = io.BytesIO()
        Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(buf, format="PNG")
        conn.request("POST", "/restore?prompt=hello", body=buf.getvalue(),
                     headers={"Content-Length": str(buf.getbuffer().nbytes)})
        resp = conn.getresponse()
        assert resp.status == 200
        assert Image.open(io.BytesIO(resp.read())).size == (40, 40)
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_server_metrics_latency_quantiles(server):
    img = np.zeros((IMAGE, IMAGE, 3), np.uint8)
    for _ in range(3):
        server.submit(img, prompt="metrics probe")
    s = server.stats()
    assert s["requests_served"] >= 3 and s["batches_run"] >= 1 and s["queue_depth"] == 0
    lat, bat = s["request_latency_seconds"], s["batch_seconds"]
    assert set(lat) == {"0.5", "0.9", "0.99"}
    assert 0 < lat["0.5"] <= lat["0.99"] and 0 < bat["0.5"] <= lat["0.99"] + 1e-9
    text = server.metrics_text()
    assert "# TYPE instantir_requests_served_total counter" in text
    assert 'instantir_request_latency_seconds{quantile="0.5"}' in text and text.endswith("\n")
    httpd, conn = _serve_http(server)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type", "").startswith("text/plain")
        assert b"instantir_batches_run_total" in resp.read()
        conn.request("GET", "/healthz")
        assert b"request_latency_seconds" in conn.getresponse().read()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_server_resolution_buckets_and_graph_bound(server):
    """Each request routes to the smallest bucket that covers it; the
    server sets the pipeline's bound on recorded restores to its bucket
    count."""
    pipe = server.pipe
    srv = RestoreServer(pipe, server.encode_fn, ServeConfig(batch_size=2, batch_wait_ms=50.0, resolution=IMAGE,
                                                            resolutions=(16, IMAGE, 64), **SERVE))
    assert pipe.max_graphs == 3
    srv = RestoreServer(pipe, server.encode_fn, ServeConfig(batch_size=2, batch_wait_ms=50.0, resolution=IMAGE,
                                                            resolutions=(16, IMAGE), **SERVE)).start(warmup=True)
    try:
        assert srv.buckets == (16, IMAGE) and pipe.max_graphs == 2
        img_small, _, b_small = srv._to_bucket(np.zeros((10, 12, 3), np.uint8))
        img_big, _, b_big = srv._to_bucket(np.zeros((28, 28, 3), np.uint8))
        assert b_small == 16 and img_small.shape == (16, 16, 3)
        assert b_big == IMAGE and img_big.shape == (IMAGE, IMAGE, 3)
        assert srv._to_bucket(np.zeros((64, 64, 3), np.uint8))[2] == IMAGE  # oversized: the largest bucket
        out_small = srv.submit(np.zeros((10, 12, 3), np.uint8), prompt="small")
        out_big = srv.submit(np.zeros((28, 28, 3), np.uint8), prompt="big")
        assert out_small.shape == (10, 12, 3) and out_big.shape == (28, 28, 3)
        assert srv.stats()["buckets"] == [16, IMAGE]
        assert srv.requests_served == 2 and srv.batches_run == 2
    finally:
        srv.drain()
        pipe.max_graphs = MAX_GRAPHS


def test_server_per_bucket_batch_sizes(server):
    srv = RestoreServer(server.pipe, server.encode_fn,
                        ServeConfig(batch_wait_ms=200.0, resolution=IMAGE, resolutions=(16, IMAGE),
                                    batch_sizes=(2, 1), **SERVE)).start(warmup=True)
    try:
        assert srv._bucket_batch == {16: 2, IMAGE: 1} and srv.stats()["bucket_batch_sizes"] == [2, 1]
        results = [None, None]

        def client(i):
            results[i] = srv.submit(np.zeros((10, 12, 3), np.uint8), prompt=f"p{i}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert all(r is not None and r.shape == (10, 12, 3) for r in results)
        assert srv.batches_run == 1 and srv.requests_served == 2  # one batch-2 run
        assert srv.submit(np.zeros((IMAGE, IMAGE, 3), np.uint8), prompt="big").shape == (IMAGE, IMAGE, 3)
        assert srv.batches_run == 2
    finally:
        srv.drain()
        server.pipe.max_graphs = MAX_GRAPHS
    with pytest.raises(ValueError):
        RestoreServer(server.pipe, server.encode_fn,
                      ServeConfig(resolutions=(16, IMAGE), batch_sizes=(2,), **SERVE))


def test_served_image_equals_restore_of_its_bucket_pixels(server):
    """A request's image is ``restore`` of its bucket pixels with the
    server's cached embeddings and a generator cloned from the server's
    state just before it, mapped to uint8 the server's way (exact)."""
    pipe = server.pipe
    img = (np.random.default_rng(9).uniform(0, 255, size=(IMAGE, IMAGE, 3))).astype(np.uint8)
    pixels, _, _ = server._to_bucket(img)
    g = torch.Generator().set_state(server._generator.get_state())
    got = server.submit(img, prompt="exact", timeout=300)
    pe, pooled = server._embeds(["exact", "exact"])
    npe, npooled = server._embeds([DEFAULT_NEG_PROMPT] * 2)
    want, _ = pipe.restore(torch.from_numpy(np.stack([pixels, pixels])), pe, pooled, negative_prompt_embeds=npe,
                           negative_pooled_embeds=npooled, cfg=server.restore_cfg, generator=g)
    np.testing.assert_array_equal(got, to_uint8(want[0]))


def test_serve_refuses_fused_on_cpu_and_budget(pipelines):
    _, tpipe = pipelines
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        RestoreServer(tpipe, _encode, ServeConfig(resolution=IMAGE))
    with pytest.raises(ValueError, match="needs limit_gb"):
        estimate_hbm_budget(tpipe, (IMAGE,), {IMAGE: 1})
    with pytest.raises(ValueError, match="HBM budget"):
        estimate_hbm_budget(tpipe, (4096,), {4096: 8}, limit_gb=80.0)
    report = estimate_hbm_budget(tpipe, (4096,), {4096: 8}, allow_overbudget=True, limit_gb=80.0)
    assert report["fits"] is False
    ok = estimate_hbm_budget(tpipe, (512, 1024), {512: 2, 1024: 1}, limit_gb=80.0)
    rows = {r["bucket"]: r["act_gb"] for r in ok["rows"]}
    assert ok["fits"] and 0 < ok["params_gb"] < 0.1
    assert ok["total_gb"] == pytest.approx(ok["params_gb"] + rows[512] + rows[1024], abs=1e-3)  # pools add up
    assert rows[512] == pytest.approx(rows[1024] / 2, rel=1e-3)  # per megapixel and image


@pytest.fixture(scope="module")
def cont_server(pipelines):
    _, tpipe = pipelines
    cfg = ServeConfig(resolutions=(IMAGE,), batch_sizes=(2,), tick_steps=2, num_inference_steps=4,
                      guidance_scale=7.0, continuous=True, preview_start=0.0, creative_start=0.75, fused=False,
                      limit_gb=1.0)
    srv = ContinuousRestoreServer(tpipe, _encode, cfg).start(warmup=True)
    yield srv
    srv.stop()


def test_continuous_server_completes_concurrent_requests(cont_server):
    rng = np.random.default_rng(3)
    images = [rng.uniform(0, 255, size=(IMAGE, IMAGE, 3)).astype(np.uint8) for _ in range(5)]
    results, errors = {}, []

    def client(i):
        try:
            results[i] = cont_server.submit(images[i], prompt=f"p{i % 2}", timeout=300)
        except Exception as e:  # noqa: BLE001 -- collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and len(results) == 5
    for out in results.values():
        assert out.shape == (IMAGE, IMAGE, 3) and out.dtype == np.uint8
    stats = cont_server.stats()
    assert stats["mode"] == "continuous" and stats["requests_served"] >= 5
    assert stats["ticks_run"] >= 2 and stats["request_latency_seconds"]
    assert set(stats["slot_occupancy"]) == {str(IMAGE)}
    assert "instantir_requests_served_total" in cont_server.metrics_text()


def test_continuous_server_under_more_clients_than_cores(cont_server):
    """More client threads than cores, with a short switch interval: every
    request is served once (the served counter and the latency window each
    grow by exactly the number sent)."""
    n = (os.cpu_count() or 1) + 1
    served, window = cont_server.requests_served, len(cont_server._request_latencies)
    results, errors = [None] * n, []

    def client(i):
        try:
            results[i] = cont_server.submit(np.full((IMAGE, IMAGE, 3), 3 * i, np.uint8), prompt="stress", timeout=300)
        except Exception as e:  # noqa: BLE001 -- collected and asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(r is not None and r.shape == (IMAGE, IMAGE, 3) for r in results)
    assert cont_server.requests_served - served == n
    assert len(cont_server._request_latencies) - window == n


def test_continuous_server_drain_refuses_new(pipelines):
    _, tpipe = pipelines

    def encode(prompts):
        return np.zeros((len(prompts), 7, 32), np.float32), np.zeros((len(prompts), 16), np.float32)

    cfg = ServeConfig(resolutions=(IMAGE,), batch_sizes=(1,), tick_steps=3, num_inference_steps=3,
                      guidance_scale=1.0, continuous=True, fused=False, limit_gb=1.0)
    srv = ContinuousRestoreServer(tpipe, encode, cfg).start(warmup=False)
    img = np.zeros((IMAGE, IMAGE, 3), np.uint8)
    assert srv.submit(img, timeout=300).shape == (IMAGE, IMAGE, 3)
    srv.drain(timeout=60)
    with pytest.raises(RuntimeError, match="draining"):
        srv.submit(img, timeout=10)


# ---------------------------------------------------------------------------
# The demo app
# ---------------------------------------------------------------------------


def test_set_adapter_swaps_only_lora_tensors_in_place(pipelines):
    _, tpipe = pipelines
    previewer = extract_unet_lora(tpipe.unet)
    assert previewer and all(".lora_A." in k or ".lora_B." in k for k in previewer)
    lcm = {k: v + 0.05 for k, v in previewer.items()}
    app = InstantIRApp(tpipe, encode_fn=None, lora_variants={"lcm": lcm})
    params = dict(tpipe.unet.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    others = {k: p.clone() for k, p in params.items() if k not in previewer}
    try:
        app.set_adapter("lcm")
        assert app.active_adapter == "lcm"
        for k, v in lcm.items():
            assert torch.equal(params[k], v)
        assert all(torch.equal(params[k], v) for k, v in others.items())
        assert {k: p.data_ptr() for k, p in tpipe.unet.named_parameters()} == ptrs
        assert not torch.equal(app.lora_variants["previewer"][next(iter(previewer))], params[next(iter(previewer))])
        with pytest.raises(KeyError):
            app.set_adapter("nope")
    finally:
        app.set_adapter("previewer")
    assert all(torch.equal(params[k], v) for k, v in previewer.items())
    frozen = copy.deepcopy(tpipe).freeze_previewer()
    with pytest.raises(ValueError, match="frozen"):
        InstantIRApp(frozen, None, lora_variants={"lcm": lcm}).set_adapter("lcm")


def test_load_lcm_lora_variant_matches_jax(pipelines, tmp_path):
    """The same diffusers-format ``.bin`` gives the JAX variant's LoRA
    tensors, transposed by name (exact)."""
    jpipe, tpipe = pipelines
    np_unet = jax.tree_util.tree_map(np.asarray, jpipe.params["unet"])
    lora_sd = {f"unet.{k}": v + 0.25 for k, v in convert.export_unet(np_unet).items() if "lora_" in k}
    path = tmp_path / "lcm_lora.bin"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lora_sd.items()}, path)

    got = load_lcm_lora_variant(tpipe.unet, str(path))
    j_variant = j_load_lcm_lora_variant(jpipe.params["unet"], str(path), jpipe.unet.config)
    assert set(j_variant) == set(j_extract_unet_lora(jpipe.params["unet"]))
    _, base = partition_params(np_unet["params"], LORA_PARAM_PRED)
    want = {k: v for k, v in convert.export_unet({"params": merge_params(base, j_variant)}).items() if "lora_" in k}
    assert set(got) == set(want) == set(extract_unet_lora(tpipe.unet))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(ValueError, match="no LoRA tensors"):
        empty = tmp_path / "empty.bin"
        torch.save({"unet.nothing.weight": torch.zeros(1)}, empty)
        load_lcm_lora_variant(tpipe.unet, str(empty))


def test_demo_page_restores_over_http(pipelines):
    from PIL import Image

    _, tpipe = pipelines
    previewer = extract_unet_lora(tpipe.unet)
    app = InstantIRApp(tpipe, _encode, lora_variants={"lcm": {k: v + 0.03 for k, v in previewer.items()}})
    httpd = make_demo_http_server(app, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
        conn.request("GET", "/")
        page = conn.getresponse()
        html = page.read().decode()
        assert page.status == 200 and "Creative Restoration" in html and "/api/restore" in html
        buf = io.BytesIO()
        Image.fromarray(np.zeros((40, 40, 3), np.uint8)).save(buf, format="PNG")
        png = buf.getvalue()
        tiny = "width=32&height=32&min_side=16&max_side=64&base_pixel_number=16"
        conn.request("POST", f"/api/restore?steps=2&previews=1&{tiny}", body=png,
                     headers={"Content-Length": str(len(png))})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        assert resp.status == 200, data
        assert Image.open(io.BytesIO(base64.b64decode(data["image"]))).size == (32, 32)
        assert data["adapter"] == "previewer" and len(data["previews"]) >= 1
        Image.open(io.BytesIO(base64.b64decode(data["previews"][0])))
        conn.request("POST", f"/api/restore?steps=2&creative=1&{tiny}", body=png,
                     headers={"Content-Length": str(len(png))})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        assert resp.status == 200 and data["adapter"] == "lcm", data
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.set_adapter("previewer")
