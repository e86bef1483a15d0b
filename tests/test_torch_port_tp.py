"""CPU parity of the port's tensor parallelism: the mesh's ``model`` axis,
``parallel/tp.py``, ``InstantIRPipeline.shard`` on a ``(data, model)`` mesh
and ``cli.serve --mesh --model_parallel``.

The port side runs in gloo process groups, as in
``tests/test_torch_port_parallel.py``: this file run as a script (``python
tests/test_torch_port_tp.py --worker GROUP RANK WORLD DIR``) is one rank,
reads its inputs and the JAX trees' weights (through ``convert.py``) from
``DIR``, writes rank 0's results there and asserts at its end that it
imported no JAX. The groups, started once and together:

* ``tp2`` (a ``(1, 2)`` mesh): the tiny UNet's TP forward (LoRA off and on,
  every leaf drawn from a numpy seed, ``lora_B`` included) against the
  port's one-rank forward and JAX's TP forward; W8 bases, which stay whole,
  against JAX's quantized TP forward and the one-rank quantized forward, and
  W8A8 bases against the one-rank quantized forward; the restore at
  ``(1, 2)``; a frozen previewer sharded or frozen on the shards; a UNet
  with fewer heads or groups than ranks (sharded: those layers stay whole);
  the refusals: a world ``model_parallel`` does not divide, ``quantize``
  after a TP ``shard``, ``fused`` under TP, external K/V tokens on a sharded
  attention;
  then the serving CLI: ``cli.serve.main`` alone on rank 0, then with
  ``--mesh --model_parallel 2`` on both ranks, each answering one request
  on a tiny checkpoint tree (``chip_smoke.write_checkpoint_tree``).
* ``tp4`` (a ``(2, 2)`` mesh): the restore at ``(2, 2)`` and the refusal of
  a batch the ``data`` axis does not divide (as in JAX).
* ``tpm4`` (a ``(1, 4)`` mesh): the restore at model 4, which cuts the tiny
  pipeline's heads and groups unevenly (``M4``), each rank's local heads and
  groups, and the bytes it holds against ``tp_held_bytes``.

The JAX side runs beside them in one process (``--jax DIR``) on the suite's
virtual 8-device CPU mesh at XLA's lowest CPU level: the TP forward of the
UNet (``tp_shard_params`` on a ``(1, 2)`` mesh), fp32 and W8
(``quantize_tree`` before ``tp_shard_params``, as ``InstantIRPipeline.quantize``
before ``shard``), and the TP restore on a
``(1, 4)`` mesh (``pipe.shard(make_mesh(num_devices=4, model_parallel=4))``:
GSPMD cuts the ``M4`` pipeline's heads and groups, the port splits them on
their boundaries), phase A with CFG 7, fed the same ``jax.random`` draws as
the port. The
layout (``tp_spec`` leaf by leaf over every model of the tiny pipeline,
through ``convert.py``'s name map) and the byte share of the SDXL UNet are
checked in the test process itself, the byte share against the JAX
process's ``jax.eval_shape`` walk (a port model on ``meta``).
"""

from __future__ import annotations

import io
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

B, RES, LATENT, STEPS = 2, 32, 16, 2
TINY_UNET = dict(with_ip=True, lora_rank=4)
# the restore's tiny pipeline: heads and groups that a model axis of 4 does not divide while it divides the
# features (the UNet's and the Aggregator's 40 / 80 channels in 10 groups, their 80-channel attentions in 10 heads
# of 8: 3 / 3 / 2 / 2 a rank; the VAE's 24 / 48 channels in 6 groups: 2 / 2 / 1 / 1; the Resampler's 6 heads of 8),
# so that the (1, 4) group and JAX's (1, 4) mesh (GSPMD cuts heads and groups) run the uneven layout
M4 = dict(unet=dict(block_out_channels=(40, 80, 80), num_attention_heads=(5, 10, 10), norm_num_groups=10),
          vae=dict(block_out_channels=(24, 48), norm_num_groups=6), resampler=dict(heads=6))
# phase A (the Aggregator and the main UNet) with CFG 7, as the sharded restore of tests/test_torch_port_parallel.py
RESTORE_CFG = dict(num_inference_steps=STEPS, guidance_scale=7.0, preview_start=1.0, control_guidance_end=1.0)
# every step previews (phase B): the previewer UNet on freeze_previewer's merged weights
PREVIEW_CFG = dict(num_inference_steps=STEPS, guidance_scale=7.0, preview_start=0.0, control_guidance_end=1.0)
WORKER_TIMEOUT = 600
JAX_FAST_FLAGS = ("--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
                  "--xla_llvm_disable_expensive_passes=true")
SERVE_ARGS = ["--resolution", str(RES), "--batch_size", "1", "--num_inference_steps", "2", "--cfg", "7",
              "--preview_start", "0.5", "--no-fused", "--limit_gb", "4", "--host", "127.0.0.1"]


# --------------------------------------------------------------------------
# the workers (no JAX)
# --------------------------------------------------------------------------


def _unet_inputs(b: int):
    rng = np.random.default_rng(5)
    return dict(sample=rng.normal(size=(b, 16, 16, 4)).astype(np.float32), timesteps=np.full((b,), 500, np.int32),
                encoder_hidden_states=rng.normal(size=(b, 7, 32)).astype(np.float32),
                added_text_embeds=rng.normal(size=(b, 16)).astype(np.float32),
                added_time_ids=np.tile(np.float32([[16, 16, 0, 0, 16, 16]]), (b, 1)),
                ip_hidden_states=rng.normal(size=(b, 8, 32)).astype(np.float32))


def _port_unet(out: str, **overrides):
    import torch

    from instantir_tpu_torch.models.unet import UNet2DConditionModel, tiny_unet_config

    unet = UNet2DConditionModel(tiny_unet_config(**{**TINY_UNET, **overrides}))
    if not overrides:
        unet.load_state_dict(torch.load(os.path.join(out, "unet_weights.pt"), weights_only=True), strict=True)
    return unet.eval()


def _unet_forward(unet, lora_scale: float):
    import torch

    x = {k: torch.from_numpy(v) for k, v in _unet_inputs(B).items()}
    with torch.no_grad():
        y = unet(x["sample"].permute(0, 3, 1, 2), x["timesteps"], x["encoder_hidden_states"], x["added_text_embeds"],
                 x["added_time_ids"], ip_hidden_states=x["ip_hidden_states"], lora_scale=lora_scale)
    return y.permute(0, 2, 3, 1).numpy()


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _restore(pipe, data, mesh, batch: int = B, cfg: dict = RESTORE_CFG):
    import torch

    from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise

    t = lambda k: torch.from_numpy(data[k])[:batch]  # noqa: E731
    noise = RestoreNoise(vae=t("vae"), init=t("init"), steps=[t(f"step{i}") for i in range(STEPS)])
    lat, _ = pipe.restore(t("lq"), t("pe"), t("pooled"), cfg=RestoreConfig(**cfg), noise=noise, output_type="latent")
    return lat.numpy()


def _tp2_worker(mesh, rank: int, out: str) -> dict:
    import torch

    from instantir_tpu_torch.models.kv_cache import KVCache
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.parallel import make_mesh
    from instantir_tpu_torch.parallel.mesh import axis_size
    from instantir_tpu_torch.parallel.tp import tp_shard_
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig
    from test_torch_port_parallel import _port_pipeline

    res = {}
    unet = _port_unet(out)
    for s in (0.0, 1.0):
        res[f"unet_one_{s}"] = _unet_forward(unet, s)
    heads = lambda: np.asarray([m.heads for n, m in unet.named_modules() if n.endswith(("attn1", "attn2"))])  # noqa: E731
    res["heads_one"] = heads()
    tp_shard_(unet, mesh)
    for s in (0.0, 1.0):
        res[f"unet_tp_{s}"] = _unet_forward(unet, s)
    res["heads_tp"] = heads()
    res["unet_bytes"] = np.asarray([sum(p.numel() for p in unet.parameters()),
                                    sum(p.numel() for p in _port_unet(out).parameters())])
    # the int8 bases stay whole, their LoRA branches shard: W8 through the whole UNet; W8A8 through a resnet
    # block and a GEGLU feed-forward (conv1, time_emb_proj and proj column-parallel, conv2, conv_shortcut and
    # net.2 row-parallel), whose int8 products see the same codes and the same whole activations as on one rank.
    # Not through the UNet: TP sums an fp32 partial in another order, an ulp that can take the other int8 code at
    # a rounding edge, which W8A8 amplifies (as it does against JAX: a 1e-6 change moves a restore by percents)
    q = quant.quantize_tree(_port_unet(out), min_size=256, weight_only=True)
    res["w8_one"] = _unet_forward(q, 1.0)
    res["w8_tp"] = _unet_forward(tp_shard_(q, mesh), 1.0)
    res.update(_w8a8_blocks(mesh))

    data = np.load(os.path.join(out, "inputs.npz"))
    pipe = _port_pipeline(out, **M4)
    res["restore_one"] = _restore(pipe, data, None)
    pipe.shard(mesh)
    res["restore_tp"] = _restore(pipe, data, mesh)
    # the frozen previewer's merged weights: merged from the shards, or merged whole and then sharded
    frozen = {}
    for order in ("one", "freeze_then_shard", "shard_then_freeze"):
        p = _port_pipeline(out, **M4)
        if order == "shard_then_freeze":
            p.shard(mesh)
        p.freeze_previewer(1.0)
        if order == "freeze_then_shard":
            p.shard(mesh)
        frozen[order] = _restore(p, data, mesh, cfg=PREVIEW_CFG)
    res.update({f"frozen_{k}": v for k, v in frozen.items()})
    res["refused_quantize"] = np.asarray(_refusal(lambda: pipe.quantize(min_size=256)))
    res["refused_fused"] = np.asarray(_refusal(lambda: pipe.restore(
        torch.zeros(2, RES, RES, 3), torch.zeros(2, 7, 32), torch.zeros(2, 16), cfg=RestoreConfig(fused=True))))
    res["refused_reshard"] = np.asarray(_refusal(lambda: pipe.shard(None)))
    res["refused_heads"] = np.asarray(_refusal(lambda: tp_shard_(_port_unet(out, num_attention_heads=(1, 1, 1)), mesh)))
    res["refused_groups"] = np.asarray(_refusal(lambda: tp_shard_(_port_unet(out, norm_num_groups=1), mesh)))
    res["refused_world"] = np.asarray(_refusal(lambda: make_mesh(model_parallel=3, device="cpu")))
    kv = KVCache(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8))
    attn = next(m for n, m in unet.named_modules() if n.endswith("attn1"))
    res["refused_external_kv"] = np.asarray(_refusal(lambda: attn(torch.zeros(1, 4, 8), external_kv=kv)))
    assert axis_size(mesh, "model") == 2
    res.update(_serve(rank, out))
    return res


def _w8a8_blocks(mesh) -> dict:
    import torch

    from instantir_tpu_torch.models.resnet import ResnetBlock2D
    from instantir_tpu_torch.models.transformer import GEGLUFeedForward
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from instantir_tpu_torch.parallel.tp import tp_shard_

    res = {}
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    temb = torch.randn(2, 24, generator=torch.Generator().manual_seed(4))
    tokens = torch.randn(2, 10, 16, generator=torch.Generator().manual_seed(2))
    for lora_scale in (0.0, 1.0):
        for name, build, call in (
                ("resnet", lambda: ResnetBlock2D(16, 32, 24, norm_num_groups=8, lora_rank=4),
                 lambda m: m(x, temb, lora_scale)),
                ("geglu", lambda: GEGLUFeedForward(16, lora_rank=4), lambda m: m(tokens, lora_scale))):
            outs = []
            for tp in (False, True):
                m = quant.quantize_tree(synthesize_weights(build(), torch.Generator().manual_seed(3)), min_size=64)
                assert quant.quant_mode(m) == "w8a8"
                with torch.no_grad():
                    outs.append(call(tp_shard_(m, mesh) if tp else m).numpy())
            res[f"w8a8_{name}_{lora_scale}_one"], res[f"w8a8_{name}_{lora_scale}_tp"] = outs
    return res


def _recording_restore(calls: list):
    """Wrap ``InstantIRPipeline.restore`` so that each call appends the
    fingerprints of its tensors (float64 sums) and its image; returns the
    method it wrapped."""
    import torch

    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline

    restore = InstantIRPipeline.restore

    def recorded(self, *args, **kwargs):
        out = restore(self, *args, **kwargs)
        tensors = [t for t in (*args, kwargs.get("negative_prompt_embeds"), kwargs.get("negative_pooled_embeds"))
                   if isinstance(t, torch.Tensor)]
        noise = kwargs["noise"]
        tensors += [noise.vae, noise.init, *noise.steps]
        calls.append((np.asarray([float(t.double().sum()) for t in tensors]), out[0], args, kwargs))
        return out

    InstantIRPipeline.restore = recorded
    return restore


def _serve(rank: int, out: str) -> dict:
    """``cli.serve.main`` alone on rank 0, then on the (1, 2) mesh; one request each."""
    import torch
    import torch.distributed as dist

    from instantir_tpu_torch.cli import serve

    paths = {k: os.path.join(out, "tree", k) for k in ("sdxl", "instantir", "dinov2")}
    argv = ["--sdxl_path", paths["sdxl"], "--instantir_path", paths["instantir"], "--vision_encoder_path",
            paths["dinov2"], *SERVE_ARGS]
    png = open(os.path.join(out, "request.png"), "rb").read()
    from instantir_tpu_torch.pipeline.instantir import InstantIRPipeline

    res = {}
    one, tp = [], []
    restore = _recording_restore(one)
    try:
        if rank == 0:
            res["served_one"] = _serve_once(serve, argv, png)
        dist.barrier()
        InstantIRPipeline.restore = restore
        _recording_restore(tp)
        if rank == 0:
            res["served_tp"] = _serve_once(serve, argv + ["--mesh", "--model_parallel", "2"], png)
        else:
            serve.main(argv + ["--mesh", "--model_parallel", "2", "--port", "1"], device="cpu")
    finally:
        InstantIRPipeline.restore = restore
    # every rank's calls: the warmup's and the request's, on the same inputs
    prints = [None] * dist.get_world_size()
    dist.all_gather_object(prints, [c[0].tolist() for c in tp])
    res["tp_fingerprints"] = np.asarray(prints)
    if rank == 0:
        res["one_images"], res["tp_images"] = np.stack([c[1] for c in one]), np.stack([c[1] for c in tp])
        # the request's restore on the fp32 weights the tree was written from (bf16 inputs taken exactly)
        from test_torch_port_parallel import _port_pipeline

        args, kwargs = one[-1][2], one[-1][3]
        f32 = lambda t: t.float() if isinstance(t, torch.Tensor) else t  # noqa: E731
        res["fp32_image"] = _port_pipeline(out, **M4).restore(*map(f32, args), **{k: f32(v) for k, v in kwargs.items()})[0]
    return res


def _serve_once(serve, argv, png: bytes) -> np.ndarray:
    """Run ``serve.main`` on this thread; a client thread posts ``png`` once
    ready, keeps the answer, then SIGTERMs this process (a graceful drain)."""
    import signal
    import socket
    import threading
    from http.client import HTTPConnection

    from PIL import Image

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {}

    def client():
        deadline = time.time() + 300
        while time.time() < deadline:
            try:
                conn = HTTPConnection("127.0.0.1", port, timeout=300)
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                time.sleep(0.2)
        conn = HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/restore", body=png)
        resp = conn.getresponse()
        got["status"], got["body"] = resp.status, resp.read()
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
    serve.main(argv + ["--port", str(port)], device="cpu")
    assert got.get("status") == 200, got
    return np.asarray(Image.open(io.BytesIO(got["body"])).convert("RGB"))


def _tp4_worker(mesh, rank: int, out: str) -> dict:
    from test_torch_port_parallel import _port_pipeline

    data = np.load(os.path.join(out, "inputs.npz"))
    pipe = _port_pipeline(out, **M4).shard(mesh)
    res = {"restore_tp": _restore(pipe, data, mesh)}
    res["refused_batch"] = np.asarray(_refusal(lambda: _restore(pipe, data, mesh, batch=1)))
    return res


def _tpm4_worker(mesh, rank: int, out: str) -> dict:
    """The restore on a (1, 4) mesh: every head count and group count of the
    tiny pipeline cut unevenly. Records this rank's local heads and groups,
    the bytes it holds against ``tp_held_bytes``, and (rank 0) the restore."""
    import torch.distributed as dist

    from instantir_tpu_torch.models.attention import Attention
    from instantir_tpu_torch.models.layers import GroupNorm32
    from instantir_tpu_torch.models.resampler import PerceiverAttention
    from instantir_tpu_torch.parallel.tp import tp_held_bytes
    from test_torch_port_parallel import _port_pipeline

    data = np.load(os.path.join(out, "inputs.npz"))
    pipe = _port_pipeline(out, **M4)
    predicted = [tp_held_bytes(getattr(pipe, name), 4)[rank] for name in pipe._MODELS]
    pipe.shard(mesh)
    held = [sum(t.numel() * t.element_size() for t in (*getattr(pipe, name).parameters(),
                                                          *getattr(pipe, name).buffers())) for name in pipe._MODELS]
    local = {"unet_heads": [m.heads for m in pipe.unet.modules() if isinstance(m, Attention)],
             "resampler_heads": [m.heads for m in pipe.resampler.modules() if isinstance(m, PerceiverAttention)],
             "unet_groups": [m.num_groups for n, m in pipe.unet.named_modules()
                             if isinstance(m, GroupNorm32) and n.endswith("norm2")],
             "vae_groups": [m.num_groups for n, m in pipe.vae.named_modules()
                            if isinstance(m, GroupNorm32) and n.endswith("norm2")],
             "vae_norms": sum(isinstance(m, GroupNorm32) for m in pipe.vae.modules())}
    every = [None] * 4
    dist.all_gather_object(every, local, group=mesh.get_group("model"))
    res = {"restore_tp": _restore(pipe, data, mesh), "held": np.asarray(held), "predicted": np.asarray(predicted)}
    for key in local:
        res[f"local_{key}"] = np.asarray([e[key] for e in every])
    return res


def worker_main(group: str, rank: int, world: int, out: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist

    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(init_method="file://" + os.path.join(out, f"{group}.rendezvous"), device="cpu")
    mesh = make_mesh(model_parallel=4 if group == "tpm4" else 2, device="cpu")
    t0 = time.perf_counter()
    res = {"tp2": _tp2_worker, "tp4": _tp4_worker, "tpm4": _tpm4_worker}[group](mesh, rank, out)
    if group == "tpm4":  # every rank's held bytes against its own prediction
        np.savez(os.path.join(out, f"{group}.rank{rank}.npz"), held=res["held"], predicted=res["predicted"])
    if rank == 0:
        np.savez(os.path.join(out, f"{group}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "instantir_tpu")]
    assert not banned, f"a worker imported {banned[:5]}"
    print(f"[{group} {rank}] done in {time.perf_counter() - t0:.1f} s", flush=True)


# --------------------------------------------------------------------------
# the parent: inputs, the JAX side, the comparisons
# --------------------------------------------------------------------------


def _random_tree(shapes, seed: int):
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if str(getattr(path[-1], "key", path[-1])) == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_unet():
    import jax

    from instantir_tpu.models.unet import UNet2DConditionModel, tiny_unet_config

    unet = UNet2DConditionModel(tiny_unet_config(**TINY_UNET), use_flash=False)
    shapes = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), **_unet_inputs(1)))
    return unet, _random_tree(shapes, 11)


def jax_main(out: str) -> None:
    """The JAX side: the UNet's TP forward on a (1, 2) mesh and the TP
    restore on a (1, 4) mesh (GSPMD cuts the uneven heads and groups), into
    ``jax.npz``."""
    import jax

    assert len(jax.devices()) == 8, "the JAX process runs on the suite's virtual 8-device CPU mesh"
    import jax.numpy as jnp

    from instantir_tpu.ops.quant import quantize_tree
    from instantir_tpu.parallel import make_mesh
    from instantir_tpu.parallel.tp import tp_shard_params
    from instantir_tpu.pipeline.instantir import InstantIRPipeline, RestoreConfig
    from test_torch_port_parallel import _jax_pipeline

    want = {}
    unet, params = _jax_unet()
    x = _unet_inputs(B)
    mesh = make_mesh(num_devices=2, model_parallel=2)
    forward = jax.jit(lambda p, kw: unet.apply(p, **kw, lora_scale=1.0))
    want["unet_tp"] = np.asarray(forward(tp_shard_params(params, mesh), x))
    # W8 as InstantIRPipeline.quantize leaves it (eager, as the port's scales), then the TP layout: the int8
    # side tree stays whole, the LoRA branches shard
    want["w8_tp"] = np.asarray(forward(tp_shard_params(quantize_tree(params, min_size=256, weight_only=True), mesh), x))

    bundle = _jax_pipeline(**M4)
    data = np.load(os.path.join(out, "inputs.npz"))
    pipe = InstantIRPipeline(bundle.unet, bundle.aggregator, bundle.vae, bundle.resampler, bundle.image_encoder,
                             bundle.schedule, bundle.params).shard(make_mesh(num_devices=4, model_parallel=4))
    want["restore_tp"] = np.asarray(pipe.restore(*(jnp.asarray(data[k]) for k in ("lq", "pe", "pooled")),
                                                 cfg=RestoreConfig(**RESTORE_CFG), key=jax.random.PRNGKey(7),
                                                 output_type="latent")[0])
    want["sdxl_bytes"] = np.asarray(_jax_sdxl_bytes())
    want["sdxl_bytes4"] = np.asarray(_jax_sdxl_bytes(4))
    np.savez(os.path.join(out, "jax.npz"), **want)


def _jax_sdxl_bytes(model_size: int = 2):
    """(sharded, total) bytes of the SDXL UNet (ip branch, LoRA rank 64, bf16) at ``model_size``, by the JAX walk of
    its ``eval_shape`` tree (``tests/test_tensor_parallel.py``)."""
    import jax
    import jax.numpy as jnp

    from instantir_tpu.models.unet import UNet2DConditionModel, sdxl_base_config
    from instantir_tpu.parallel.tp import tp_sharded_bytes

    unet = UNet2DConditionModel(sdxl_base_config(with_ip=True, lora_rank=64), dtype=jnp.bfloat16,
                                param_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 4), jnp.bfloat16), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 2048), jnp.bfloat16), jnp.zeros((1, 1280), jnp.bfloat16), jnp.zeros((1, 6), jnp.bfloat16),
        ip_hidden_states=jnp.zeros((1, 64, 2048), jnp.bfloat16)))
    return tp_sharded_bytes(shapes, model_size=model_size)


def _write_tree(bundle, out: str) -> None:
    """The tiny pipeline (the JAX trees' weights) and two tiny text towers as a checkpoint tree, and the request."""
    import torch

    import chip_smoke
    from instantir_tpu_torch.models.clip_text import CLIPTextModel, tiny_clip_text_config
    from instantir_tpu_torch.pipeline.factory import synthesize_weights
    from test_torch_port_parallel import _port_pipeline

    pipe = _port_pipeline(out, **M4)
    g = torch.Generator().manual_seed(6)
    encoders = [synthesize_weights(CLIPTextModel(tiny_clip_text_config(vocab_size=49408, eos_token_id=49407, **kw),
                                                 device=torch.device("cpu")), g)
                for kw in ({"projection_dim": None}, {})]
    os.makedirs(os.path.join(out, "tree"))
    chip_smoke.write_checkpoint_tree(torch, pipe, encoders, os.path.join(out, "tree"))
    rgb = (np.random.default_rng(8).uniform(0, 1, (RES, RES, 3)) * 255).astype(np.uint8)
    chip_smoke.write_png(os.path.join(out, "request.png"), rgb)


def _spawn(args, world: int, out: str, **env):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root, **env)
    ranks = (lambda r: [str(r), str(world)]) if args[0] == "--worker" else (lambda r: [])
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args, *ranks(r), out], cwd=root, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs, what: str):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def bundle():
    """The JAX tiny pipeline (``tests/test_torch_port_parallel.py``'s, every leaf from a numpy seed)."""
    from test_torch_port_parallel import _jax_pipeline

    return _jax_pipeline(**M4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, bundle):
    """The two gloo groups and the JAX process, started once and together."""
    import torch

    from instantir_tpu_torch import convert
    from test_torch_port_parallel import _export_weights, _jax_noise

    out = str(tmp_path_factory.mktemp("tp"))
    t0 = time.perf_counter()
    jax_proc = _spawn(["--jax"], 1, out, XLA_FLAGS=JAX_FAST_FLAGS, JAX_PLATFORMS="cpu")
    _export_weights(bundle, os.path.join(out, "weights.pt"))
    torch.save(convert.to_torch(convert.export_unet(_jax_unet()[1])), os.path.join(out, "unet_weights.pt"))
    rng = np.random.default_rng(2)
    ucfg = bundle.unet.config
    pooled_dim = ucfg.projection_class_embeddings_input_dim - ucfg.addition_time_embed_dim * 6
    inputs = {"lq": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
              "pe": (0.1 * rng.normal(size=(B, 7, ucfg.cross_attention_dim))).astype(np.float32),
              "pooled": (0.1 * rng.normal(size=(B, pooled_dim))).astype(np.float32),
              **_jax_noise(7, STEPS, B, LATENT)}
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    tp4 = _spawn(["--worker", "tp4"], 4, out)
    tpm4 = _spawn(["--worker", "tpm4"], 4, out)
    _write_tree(bundle, out)
    tp2 = _spawn(["--worker", "tp2"], 2, out)
    _wait(jax_proc, "jax")
    _wait(tp4, "tp4")
    _wait(tpm4, "tpm4")
    _wait(tp2, "tp2")
    want = dict(np.load(os.path.join(out, "jax.npz")))
    got = {f"{g}.{k}": v for g in ("tp2", "tp4", "tpm4") for k, v in np.load(os.path.join(out, f"{g}.npz")).items()}
    for r in range(4):
        got.update({f"tpm4.rank{r}.{k}": v for k, v in np.load(os.path.join(out, f"tpm4.rank{r}.npz")).items()})
    print(f"[tp] groups and JAX side in {time.perf_counter() - t0:.1f} s")
    return want, got


# -- layout ------------------------------------------------------------------


def _jax_codes(tree, model_size: int):
    """Each leaf's JAX ``tp_spec`` as a constant array: 0 replicated, 1 column, 2 row."""
    import jax

    from instantir_tpu.parallel.tp import tp_spec as j_tp_spec

    def code(path, x):
        spec = j_tp_spec(tuple(getattr(p, "key", p) for p in path), np.shape(x), model_size)
        c = 0.0 if "model" not in tuple(spec) else 1.0 if spec[-1] == "model" else 2.0
        return np.full(np.shape(x), c, np.float32)

    return jax.tree_util.tree_map_with_path(code, tree)


@pytest.mark.parametrize("model_size", [2, 4])
def test_tp_spec_matches_jax_leaf_by_leaf(bundle, model_size):
    """The JAX decision of every leaf of the tiny pipeline, carried to the
    port's names by the exporters (a constant array stays constant through a
    re-layout), equals the port's ``tp_spec`` at a model axis of 2 and of 4
    (whose heads and groups the tiny pipeline's do not all divide), except
    the leaves the port keeps whole, which JAX shards; every sharded leaf is
    placed by ``tp_shard_`` (a leaf without a placement raises)."""
    from instantir_tpu_torch import convert
    from instantir_tpu_torch.parallel.tp import kept_whole, tp_spec

    codes = _jax_codes(bundle.params, model_size)
    exported = {"unet": convert.export_unet(codes["unet"]), "aggregator": convert.export_aggregator(codes["aggregator"]),
                "vae": convert.export_vae(codes["vae"]), "resampler": convert.export_resampler(codes["resampler"]),
                "image_encoder": convert.export_dinov2(codes["image_encoder"], bundle.image_encoder.config.num_layers)}
    kept, sharded = [], 0
    for model, state in exported.items():
        for name, arr in state.items():
            values = np.unique(arr)
            assert values.size == 1, (model, name, values)
            want = {0.0: None, 1.0: 0, 2.0: 1}[float(values[0])]
            got = tp_spec(name, arr.shape, model_size)
            assert got == want, (model, name, arr.shape, got, want)
            sharded += want is not None
            if want is not None and kept_whole(name):
                kept.append(f"{model}.{name}")
    assert sharded > 100
    assert all(re.search(r"^(image_encoder\..*attention\.output\.dense|vae\..*mid_block\.attentions\.0\.)", n)
               for n in kept), kept
    assert any(n.startswith("image_encoder.") for n in kept) and any(n.startswith("vae.") for n in kept)


@pytest.mark.parametrize("model", ["unet", "aggregator"])
def test_quantize_tree_takes_the_bases_jax_takes(bundle, model):
    """At ``min_size`` 1 the port's ``quantize_tree`` quantizes the bases the
    JAX ``quantize_tree`` does, the stems among them (the UNet's ``conv_in``
    and ``conv_out``, the Aggregator's ``conv_in`` and ``ref_conv_in``,
    LoRA-less LoRA convolutions in both packages), which the W8 forward against
    JAX above meets at ``min_size`` 256."""
    import jax

    from instantir_tpu.ops.quant import quantize_tree as j_quantize_tree
    from instantir_tpu_torch import convert
    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from test_torch_port_parallel import SLIM

    jtree = jax.tree_util.tree_map(np.asarray, j_quantize_tree(bundle.params[model], min_size=1, weight_only=True))
    want = convert.export_quantized(getattr(convert, f"export_{model}"), jtree)
    pipe = build_pipeline(tiny_unet_config(**SLIM, **M4["unet"]), tiny_vae_config(**M4["vae"]),
                          tiny_resampler_config(output_dim=32, lora_rank=2, **M4["resampler"]), tiny_dinov2_config(),
                          device="cpu")
    got = quant.quantize_tree(getattr(pipe, model), min_size=1, weight_only=True).state_dict()
    bases = lambda state: sorted(k[:-len(".weight_qw")] for k in state if k.endswith(".weight_qw"))  # noqa: E731
    assert bases(got) == bases(want)
    stems = ("conv_in", "conv_out") if model == "unet" else ("conv_in", "ref_conv_in")
    assert set(stems) <= set(bases(got))


@pytest.mark.parametrize("model_size", [2, 4])
def test_sdxl_unet_sharded_bytes_equal_jax_eval_shape(runs, model_size):
    """``tp_sharded_bytes`` of the SDXL UNet (ip branch, LoRA rank 64, bf16)
    built on ``meta`` equals the JAX walk of its ``eval_shape`` tree (in the
    JAX process), and exceeds the 0.75 of ``tests/test_tensor_parallel.py``;
    ``tp_held_bytes`` (what each rank holds under the port's layout) adds up
    to the whole UNet's bytes plus the leaves kept whole on every rank, each
    rank holding its share of the sharded leaves within one head's or one
    group's bytes."""
    import torch

    from instantir_tpu_torch.models.unet import UNet2DConditionModel, sdxl_base_config
    from instantir_tpu_torch.parallel.tp import tp_held_bytes, tp_sharded_bytes

    unet = UNet2DConditionModel(sdxl_base_config(with_ip=True, lora_rank=64), dtype=torch.bfloat16,
                                device=torch.device("meta"))
    got = tp_sharded_bytes(unet, model_size=model_size)
    want = runs[0]["sdxl_bytes" if model_size == 2 else "sdxl_bytes4"]
    assert got == tuple(want.tolist()), (got, want)
    assert got[0] / got[1] > 0.75
    held = tp_held_bytes(unet, model_size)
    whole = got[1] - got[0]
    assert all(whole + got[0] // model_size * 0.97 <= h <= whole + got[0] // model_size * 1.03 for h in held), held
    assert held == sorted(held, reverse=True) and (model_size == 2) == (len(set(held)) == 1)


# -- the groups ------------------------------------------------------------------


@pytest.mark.parametrize("lora_scale", [0.0, 1.0])
def test_tp_unet_forward_matches_one_rank_and_jax(runs, lora_scale):
    want, got = runs
    tp = got[f"tp2.unet_tp_{lora_scale}"]
    np.testing.assert_allclose(tp, got[f"tp2.unet_one_{lora_scale}"], rtol=2e-4, atol=2e-4)
    if lora_scale:
        np.testing.assert_allclose(tp, want["unet_tp"], rtol=2e-4, atol=2e-4)
    assert got["tp2.heads_one"].size > 10 and (got["tp2.heads_tp"] * 2 == got["tp2.heads_one"]).all()
    n_tp, n_one = got["tp2.unet_bytes"]
    assert n_tp < 0.7 * n_one, (n_tp, n_one)


def test_tp_keeps_int8_bases_whole_and_matches_one_rank(runs):
    """W8 through the UNet with the LoRA on, against JAX's W8 TP forward
    (``quantize_tree`` then ``tp_shard_params``) and the port's one-rank W8
    forward; W8A8 bitwise through a resnet block and a GEGLU feed-forward
    with the LoRA off, and at 2e-4 with it on, against the one-rank W8A8."""
    want, got = runs
    np.testing.assert_allclose(got["tp2.w8_tp"], want["w8_tp"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["tp2.w8_tp"], got["tp2.w8_one"], rtol=2e-4, atol=2e-4)
    assert np.abs(want["w8_tp"] - want["unet_tp"]).max() > 1e-2  # the int8 bases ran (7.6e-2 apart)
    for name in ("resnet", "geglu"):
        np.testing.assert_array_equal(got[f"tp2.w8a8_{name}_0.0_tp"], got[f"tp2.w8a8_{name}_0.0_one"])
        np.testing.assert_allclose(got[f"tp2.w8a8_{name}_1.0_tp"], got[f"tp2.w8a8_{name}_1.0_one"], rtol=2e-4,
                                   atol=2e-4)
        assert np.abs(got[f"tp2.w8a8_{name}_1.0_one"] - got[f"tp2.w8a8_{name}_0.0_one"]).max() > 1e-3  # LoRA ran


@pytest.mark.parametrize("group", ["tp2", "tp4", "tpm4"])
def test_tp_restore_matches_jax(runs, group):
    """At (data 1, model 2), (data 2, model 2) and (data 1, model 4: heads
    and groups cut unevenly) against JAX's TP restore on a (1, 4) mesh:
    ``tests/test_sharded_inference.py``'s tolerance. The module's one JAX
    compile is that model-only restore, so the data axis is held only
    through the port's own (2, 2) run against JAX's (1, 4) answer."""
    want, got = runs
    lat = got[f"{group}.restore_tp"]
    assert lat.shape == want["restore_tp"].shape == (B, LATENT, LATENT, 4)
    np.testing.assert_allclose(lat, want["restore_tp"], atol=1e-4, rtol=5e-3)
    np.testing.assert_allclose(lat, got["tp2.restore_one"], atol=1e-4, rtol=5e-3)


@pytest.mark.parametrize("order", ["freeze_then_shard", "shard_then_freeze"])
def test_tp_frozen_previewer_matches_one_rank(runs, order):
    """``freeze_previewer`` before ``shard`` (the merged weights sharded
    by ``shard_weights``) or after it (merged from the shards), through two
    previewing steps, against the one-rank frozen restore."""
    _, got = runs
    np.testing.assert_allclose(got[f"tp2.frozen_{order}"], got["tp2.frozen_one"], atol=1e-4, rtol=5e-3)


def test_tp_refusals(runs):
    """What the tensor-parallel layout refuses, and what it no longer
    does: heads or groups the ``model`` axis does not divide, fewer than its
    ranks even, shard (the group stays whole, as JAX runs them)."""
    _, got = runs
    assert str(got["tp2.refused_heads"]) == "" and str(got["tp2.refused_groups"]) == "", (
        got["tp2.refused_heads"], got["tp2.refused_groups"])
    assert "2 devices not divisible by model_parallel=3" in str(got["tp2.refused_world"])
    assert "not divisible by mesh data axis" in str(got["tp4.refused_batch"])
    assert "quantize before shard()" in str(got["tp2.refused_quantize"])
    assert "tensor parallelism" in str(got["tp2.refused_fused"]) and "fused=False" in str(got["tp2.refused_fused"])
    assert "Attention got external_kv" in str(got["tp2.refused_external_kv"]), got["tp2.refused_external_kv"]
    from instantir_tpu_torch.cli import serve

    with pytest.raises(SystemExit, match="--fused does not compose with --model_parallel"):
        serve.main(["--sdxl_path", "-", "--instantir_path", "-", "--vision_encoder_path", "-", "--mesh",
                    "--model_parallel", "2", "--fused"],
                   device="cpu")
    assert "rebuild the pipeline" in str(got["tp2.refused_reshard"])


def test_tp_shares_and_uneven_gather(monkeypatch):
    """``tp_shares`` splits heads and groups nearest to equal, the first
    ranks one more; ``TPShard.gather`` (a row-parallel int8 base's whole
    input) pads each rank's uneven share to the widest for the all-gather and
    trims it back, so that the features come back whole and in order; and
    ``local`` takes each rank's own span."""
    import torch

    from instantir_tpu_torch.parallel import tp as ttp

    assert ttp.tp_shares(10, 4) == [3, 3, 2, 2] and ttp.tp_shares(32, 5) == [7, 7, 6, 6, 6]
    assert ttp.tp_shares(20, 4) == [5] * 4 and ttp.tp_shares(6, 4) == [2, 2, 1, 1]
    spans, starts = [], 0
    for n in ttp.tp_shares(10, 4):
        spans.append((8 * starts, 8 * n))
        starts += n
    whole = torch.arange(2 * 3 * 80, dtype=torch.float32).reshape(2, 3, 80)
    shards = [whole.narrow(-1, a, n) for a, n in spans]

    def all_gather(parts, x, group=None):
        for r, part in enumerate(parts):
            mine = shards[r]
            part.copy_(torch.cat([mine, mine.new_zeros(*mine.shape[:-1], x.shape[-1] - mine.shape[-1])], dim=-1))

    monkeypatch.setattr(ttp.dist, "all_gather", all_gather)
    for rank in range(4):
        shard = ttp.TPShard("row", None, rank, 4, tuple(spans))
        assert shard.features == 80
        torch.testing.assert_close(shard.local(whole, -1), shards[rank], rtol=0, atol=0)
        torch.testing.assert_close(shard.gather(shards[rank].clone(), -1), whole, rtol=0, atol=0)


def test_tp_model4_cuts_heads_and_groups_unevenly(runs):
    """At a model axis of 4 the tiny pipeline's 10-head attentions run 3 /
    3 / 2 / 2 heads a rank, the Resampler's 6 heads 2 / 2 / 1 / 1, the
    UNet's 10-group ``norm2``s 3 / 3 / 2 / 2 groups and the VAE's 6-group
    ones 2 / 2 / 1 / 1 (every VAE norm still a GroupNorm32, so that the
    dispatch sees each); each rank holds the bytes ``tp_held_bytes``
    predicts for it, the first ranks more than the last."""
    _, got = runs
    heads = got["tpm4.local_unet_heads"]
    assert heads.shape[0] == 4 and heads.shape[1] > 4 and (heads.T == [3, 3, 2, 2]).all(), heads
    assert (got["tpm4.local_resampler_heads"].T == [2, 2, 1, 1]).all(), got["tpm4.local_resampler_heads"]
    assert (got["tpm4.local_unet_groups"].T == [3, 3, 2, 2]).all(), got["tpm4.local_unet_groups"]
    assert (got["tpm4.local_vae_groups"].T == [2, 2, 1, 1]).all(), got["tpm4.local_vae_groups"]
    assert len(set(got["tpm4.local_vae_norms"].tolist())) == 1
    for r in range(4):
        np.testing.assert_array_equal(got[f"tpm4.rank{r}.held"], got[f"tpm4.rank{r}.predicted"])
    totals = [int(got[f"tpm4.rank{r}.held"].sum()) for r in range(4)]
    assert totals[0] == totals[1] > totals[2] == totals[3], totals


def test_serve_cli_mesh_answers_with_the_one_rank_servers_image(runs):
    """The same request to ``cli.serve`` alone and on the (1, 2) mesh. Each
    server made two restores (warmup, request); on the mesh both ranks made
    them on the same inputs (fingerprints of every tensor, broadcast from
    rank 0); each answer is its restore's image as uint8. The two servers
    restore on the loader's bf16 models with the same draws and prompts, so
    they differ by bf16 rounding alone: the TP sums round each rank's partial
    (the tiny pipeline amplifies bf16 rounding to percents: measured 3.9%
    relative L2 from one rank's bf16 restore to its fp32 one, 5.1% from the
    TP one). So the TP image is held to the fp32 restore of the same inputs
    (the weights the tree was written from) no further than twice the
    one-rank bf16 image's distance; a wrong broadcast (other noise, prompts
    or settings) lands at tens of percent."""
    from instantir_tpu_torch.cli.serve import to_uint8

    _, got = runs
    prints = got["tp2.tp_fingerprints"]
    assert prints.shape[:2] == (2, 2) and np.array_equal(prints[0], prints[1])
    one, tp = got["tp2.one_images"], got["tp2.tp_images"]
    assert one.shape == tp.shape == (2, 1, RES, RES, 3)
    np.testing.assert_array_equal(got["tp2.served_one"], to_uint8(one[1, 0]))
    np.testing.assert_array_equal(got["tp2.served_tp"], to_uint8(tp[1, 0]))
    f32 = got["tp2.fp32_image"]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    one_err, tp_err = rel(one[1], f32), rel(tp[1], f32)
    print(f"[tp] served images: relative L2 to the fp32 restore one rank {one_err:.4f}, TP {tp_err:.4f}; "
          f"TP to one rank {rel(tp[1], one[1]):.4f}")
    assert one_err < 0.1 and tp_err <= 2 * one_err, (one_err, tp_err)


if __name__ == "__main__" and len(sys.argv) == 6 and sys.argv[1] == "--worker":
    worker_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
elif __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--jax":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jax_main(sys.argv[2])
