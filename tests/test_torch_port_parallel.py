"""CPU parity of the port's mesh ``data`` axis at the restore: ring attention,
the sequence-parallel restore and the batch-sharded restore.

The port side runs in gloo process groups: this file run as a script
(``python tests/test_torch_port_parallel.py --worker GROUP RANK WORLD DIR``)
is one rank. The module fixture starts both groups once, together: four
ranks for ring attention and two for the restores. A worker imports torch,
numpy and the port only; it reads its inputs (numpy arrays, and the restore's
weights exported from the JAX trees through ``convert.py``) from ``DIR``,
writes rank 0's results as ``.npz`` there, and asserts at its end that no
module of JAX or of the JAX package was imported. The JAX side runs beside
them in one more process (``--jax DIR``) on the suite's virtual CPU mesh, at
XLA's lowest CPU optimisation level:

* the ring at 4 ranks against JAX's ``ring_attention`` and ``attention_xla``
  at ``tests/test_ring_attention.py``'s shapes and tolerances, its gradient
  too, and the refusal of a sequence the axis does not divide;
* the sequence-parallel restore at 2 ranks (a 64² input, ``sp_min_seq=64``:
  the UNet's 256- and 64-token and the Aggregator's 512- and 128-token
  self-attentions ring) against the JAX SP restore on a 2-device mesh and the
  port's dense restore, the ring calls counted; its composition with
  ``vae_tiling`` / ``vae_slicing``;
* the sharded restore at 2 ranks against JAX's ``pipe.shard(make_mesh(2))``,
  and the refusal of a batch the data axis does not divide.

The tiny UNet is the slim one of ``tests/test_torch_port_restore_options.py``
(one resnet and one transformer layer a block), and both restores run phase
A alone: the JAX restore compiles bound this file.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

B, S, HEADS, D = 2, 64, 4, 16  # tests/test_ring_attention.py
RING_RANKS, RESTORE_RANKS = 4, 2
SP_RES, SP_LATENT, SP_STEPS = 64, 32, 2
SHARD_RES, SHARD_LATENT, SHARD_BATCH, SHARD_STEPS = 32, 16, 2, 2
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
# phase A (the Aggregator and the main UNet, no previewer), CFG 7: the smallest JAX programs that run
# every self-attention the mesh touches
SP_BASE = dict(num_inference_steps=SP_STEPS, guidance_scale=7.0, preview_start=1.0, control_guidance_end=1.0)
SHARD_CFG = dict(num_inference_steps=SHARD_STEPS, guidance_scale=7.0, preview_start=1.0, control_guidance_end=1.0)
MODELS = ("unet", "aggregator", "vae", "resampler", "image_encoder")
WORKER_TIMEOUT = 600
# the JAX process: the suite's virtual 8-device CPU mesh (as conftest.py sets it), compiling at XLA's lowest
# CPU level (its restore compiles bound this file)
JAX_FAST_FLAGS = ("--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
                  "--xla_llvm_disable_expensive_passes=true")


def _qkv():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, S, HEADS, D)).astype(np.float32) for _ in range(3)]


# --------------------------------------------------------------------------
# the workers (no JAX)
# --------------------------------------------------------------------------


def _gather(x, mesh):
    from instantir_tpu_torch.parallel.ring_attention import gather_sequence

    return gather_sequence(x.detach().contiguous(), mesh).numpy()


def _ring_worker(mesh, rank: int, out: str) -> None:
    import torch

    from instantir_tpu_torch.parallel import ring_attention as ring
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    res = {}
    for tag, scale in (("default", None), ("half", 0.5)):
        local = [ring.shard_sequence(x, mesh).clone().requires_grad_(True) for x in (q, k, v)]
        o = ring.ring_attention(*local, mesh, scale=scale)
        o.sum().backward()
        res[f"out_{tag}"] = _gather(o, mesh)
        for name, x in zip("qkv", local):
            res[f"d{name}_{tag}"] = _gather(x.grad, mesh)
    try:
        ring.shard_sequence(q[:, :S - 2], mesh)
        res["refused"] = np.asarray("")
    except ValueError as e:
        res["refused"] = np.asarray(str(e))
    if rank == 0:
        np.savez(os.path.join(out, "ring.npz"), **res)


def _port_pipeline(out: str, unet: dict = None, vae: dict = None, resampler: dict = None):
    """The port's tiny pipeline (``_jax_pipeline``'s configs, with the same
    overrides) holding the JAX trees' weights written to ``out``."""
    import torch

    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline

    pipe = build_pipeline(tiny_unet_config(**{**SLIM, **(unet or {})}), tiny_vae_config(**(vae or {})),
                          tiny_resampler_config(output_dim=32, lora_rank=2, **(resampler or {})), tiny_dinov2_config(),
                          device="cpu")
    state = torch.load(os.path.join(out, "weights.pt"), weights_only=True)
    for name in MODELS:
        getattr(pipe, name).load_state_dict(state[name], strict=True)
    return pipe


def _noise(data, prefix: str):
    import torch

    from instantir_tpu_torch.pipeline.instantir import RestoreNoise

    steps = sorted(k for k in data.files if k.startswith(prefix + "step"))
    t = lambda k: torch.from_numpy(data[k])  # noqa: E731
    return RestoreNoise(vae=t(prefix + "vae"), init=t(prefix + "init"), steps=[t(k) for k in steps])


def _restore_worker(mesh, rank: int, out: str) -> None:
    import torch

    from instantir_tpu_torch.parallel.mesh import axis_size
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig

    from instantir_tpu_torch.parallel import ring_attention as ring
    data = np.load(os.path.join(out, "inputs.npz"))
    t = lambda k: torch.from_numpy(data[k])  # noqa: E731
    pipe = _port_pipeline(out)
    res = {}
    sp_noise = _noise(data, "sp_")
    dense, _ = pipe.restore(t("sp_lq"), t("sp_pe"), t("sp_pooled"), cfg=RestoreConfig(**SP_BASE), noise=sp_noise,
                            output_type="latent")
    res["sp_dense"] = dense.numpy()
    pipe.shard(mesh)

    calls = []
    orig = ring.ring_attention

    def counting(q, k, v, mesh, axis="data", scale=None):
        calls.append(q.shape[1] * axis_size(mesh, axis))  # the global sequence of the shards
        return orig(q, k, v, mesh, axis=axis, scale=scale)

    ring.ring_attention = counting
    try:
        sp, _ = pipe.restore(t("sp_lq"), t("sp_pe"), t("sp_pooled"),
                             cfg=RestoreConfig(sequence_parallel=True, sp_min_seq=64, **SP_BASE), noise=sp_noise,
                             output_type="latent")
    finally:
        ring.ring_attention = orig
    res["sp"], res["sp_calls"] = sp.numpy(), np.asarray(calls)
    sp_cfg = dict(sequence_parallel=True, sp_min_seq=64, **SP_BASE)
    plain, _ = pipe.restore(t("sp_lq"), t("sp_pe"), t("sp_pooled"), cfg=RestoreConfig(**sp_cfg), noise=sp_noise)
    tiled, _ = pipe.restore(t("sp_lq"), t("sp_pe"), t("sp_pooled"),
                            cfg=RestoreConfig(vae_tiling=True, vae_tile_latent=24, vae_tile_overlap=0.5,
                                              vae_slicing=True, **sp_cfg), noise=sp_noise)
    res["sp_image"], res["sp_tiled"] = plain, tiled

    sharded, _ = pipe.restore(t("sh_lq"), t("sh_pe"), t("sh_pooled"), cfg=RestoreConfig(**SHARD_CFG),
                              noise=_noise(data, "sh_"), output_type="latent")
    res["sharded"] = sharded.numpy()
    try:
        pipe.restore(t("sh_lq")[:1], t("sh_pe")[:1], t("sh_pooled")[:1], cfg=RestoreConfig(num_inference_steps=2))
        res["refused"] = np.asarray("")
    except ValueError as e:
        res["refused"] = np.asarray(str(e))
    if rank == 0:
        np.savez(os.path.join(out, "restore.npz"), **res)


def worker_main(group: str, rank: int, world: int, out: str) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    import torch
    import torch.distributed as dist

    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(init_method="file://" + os.path.join(out, f"{group}.rendezvous"), device="cpu")
    mesh = make_mesh(device="cpu")
    t0 = time.perf_counter()
    (_ring_worker if group == "ring" else _restore_worker)(mesh, rank, out)
    dist.barrier()
    dist.destroy_process_group()
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "instantir_tpu")]
    assert not banned, f"a worker imported {banned[:5]}"
    print(f"[{group} {rank}] done in {time.perf_counter() - t0:.1f} s", flush=True)


# --------------------------------------------------------------------------
# the parent: inputs, the JAX side, the comparisons
# --------------------------------------------------------------------------


def _jax_noise(seed, n_steps, batch, latent):
    """The JAX staged restore's draws for ``PRNGKey(seed)`` (its key schedule)."""
    import jax
    import jax.numpy as jnp

    key, k_vae, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (batch, latent, latent, 4)
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return {"vae": np.asarray(jax.random.normal(k_vae, shape, jnp.float32)),
            "init": np.asarray(jax.random.normal(k_init, shape, jnp.float32)),
            **{f"step{i}": s for i, s in enumerate(steps)}}


def _jax_pipeline(unet: dict = None, vae: dict = None, resampler: dict = None):
    """The JAX tiny pipeline: parameter trees of each module's ``init``
    structure (``jax.eval_shape``, no compile), every leaf drawn from a numpy
    seed (zero-init leaves included, so every path is exercised); ``unet``,
    ``vae`` and ``resampler`` override their tiny configs (the UNet's applies
    to the Aggregator too)."""
    import jax

    from instantir_tpu.models.aggregator import Aggregator
    from instantir_tpu.models.dinov2 import DINOv2Model, tiny_dinov2_config
    from instantir_tpu.models.resampler import Resampler, tiny_resampler_config
    from instantir_tpu.models.unet import UNet2DConditionModel, tiny_unet_config
    from instantir_tpu.models.vae import AutoencoderKL, tiny_vae_config
    from instantir_tpu.pipeline.instantir import InstantIRPipeline
    from instantir_tpu.schedulers.diffusion import sdxl_schedule

    ucfg = tiny_unet_config(**{**SLIM, **(unet or {})})
    rcfg = tiny_resampler_config(output_dim=ucfg.cross_attention_dim, lora_rank=2, **(resampler or {}))
    dcfg = tiny_dinov2_config()
    unet, agg, vae = UNet2DConditionModel(ucfg), Aggregator(ucfg), AutoencoderKL(tiny_vae_config(**(vae or {})))
    res, dino = Resampler(rcfg), DINOv2Model(dcfg)

    def init(module, seed, *args, **kwargs):
        rng = np.random.default_rng(seed)

        def leaf(path, s):
            if str(getattr(path[-1], "key", path[-1])) == "scale":
                return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            if len(s.shape) >= 2:
                return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
        return jax.tree_util.tree_map_with_path(leaf, shapes)

    z, t0 = np.zeros((1, 8, 8, 4), np.float32), np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": init(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": init(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": init(vae, 3, np.zeros((1, 16, 16, 3), np.float32)),
        "resampler": init(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": init(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    return InstantIRPipeline(unet, agg, vae, res, dino, sdxl_schedule(), params)


def _export_weights(bundle, path: str) -> None:
    import torch

    from instantir_tpu_torch import convert

    p = bundle.params
    state = {
        "unet": convert.to_torch(convert.export_unet(p["unet"])),
        "aggregator": convert.to_torch(convert.export_aggregator(p["aggregator"])),
        "vae": convert.to_torch(convert.export_vae(p["vae"])),
        "resampler": convert.to_torch(convert.export_resampler(p["resampler"])),
        "image_encoder": convert.to_torch(convert.export_dinov2(p["image_encoder"],
                                                                bundle.image_encoder.config.num_layers)),
    }
    torch.save(state, path)


def _inputs(bundle):
    rng = np.random.default_rng(2)
    ucfg = bundle.unet.config
    pooled_dim = ucfg.projection_class_embeddings_input_dim - ucfg.addition_time_embed_dim * 6
    out = {"sp_lq": rng.uniform(-1, 1, (1, SP_RES, SP_RES, 3)).astype(np.float32),
           "sp_pe": rng.normal(size=(1, 7, ucfg.cross_attention_dim)).astype(np.float32),
           "sp_pooled": rng.normal(size=(1, pooled_dim)).astype(np.float32),
           "sh_lq": rng.uniform(-1, 1, (SHARD_BATCH, SHARD_RES, SHARD_RES, 3)).astype(np.float32),
           "sh_pe": (0.1 * rng.normal(size=(SHARD_BATCH, 7, ucfg.cross_attention_dim))).astype(np.float32),
           "sh_pooled": (0.1 * rng.normal(size=(SHARD_BATCH, pooled_dim))).astype(np.float32)}
    out.update({f"sp_{k}": v for k, v in _jax_noise(3, SP_STEPS, 1, SP_LATENT).items()})
    out.update({f"sh_{k}": v for k, v in _jax_noise(7, SHARD_STEPS, SHARD_BATCH, SHARD_LATENT).items()})
    return out


def _spawn(args, world: int, out: str, **env):
    """``world`` processes of this file as a script: ``args``, then the rank and the world for a worker, then ``out``."""
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


def jax_main(out: str) -> None:
    """The JAX side, in a process of its own on the suite's virtual 8-device
    CPU mesh at XLA's lowest CPU optimisation level: the ring,
    the dense attention and their gradients, the SP restore on a 2-device
    mesh and the sharded restore on a 2-device mesh, into ``jax.npz``."""
    import jax

    assert len(jax.devices()) == 8, "the JAX process runs on the suite's virtual 8-device CPU mesh"
    import jax.numpy as jnp

    from instantir_tpu.ops.attention import attention_xla
    from instantir_tpu.parallel import make_mesh
    from instantir_tpu.parallel.ring_attention import ring_attention
    from instantir_tpu.pipeline.instantir import InstantIRPipeline, RestoreConfig

    want = {}
    q, k, v = (jnp.asarray(x) for x in _qkv())
    mesh4 = make_mesh(num_devices=RING_RANKS)
    for tag, scale in (("default", None), ("half", 0.5)):
        want[f"xla_{tag}"] = np.asarray(attention_xla(q, k, v, scale=scale))
        want[f"ring_{tag}"] = np.asarray(ring_attention(q, k, v, mesh4, scale=scale))
        grads = jax.grad(lambda q, k, v: attention_xla(q, k, v, scale=scale).sum(), argnums=(0, 1, 2))(q, k, v)
        for name, g in zip("qkv", grads):
            want[f"d{name}_{tag}"] = np.asarray(g)
    want["ring_dq"] = np.asarray(jax.grad(lambda q: ring_attention(q, k, v, mesh4).sum())(q))

    bundle = _jax_pipeline()
    inputs = np.load(os.path.join(out, "inputs.npz"))
    for name, cfg, pre, seed in (
            ("sp", RestoreConfig(sequence_parallel=True, sp_min_seq=64, **SP_BASE), "sp_", 3),
            ("sharded", RestoreConfig(**SHARD_CFG), "sh_", 7)):
        pipe = InstantIRPipeline(bundle.unet, bundle.aggregator, bundle.vae, bundle.resampler, bundle.image_encoder,
                                 bundle.schedule, bundle.params).shard(make_mesh(num_devices=RESTORE_RANKS))
        want[name] = np.asarray(pipe.restore(*(jnp.asarray(inputs[pre + k]) for k in ("lq", "pe", "pooled")), cfg=cfg,
                                             key=jax.random.PRNGKey(seed), output_type="latent")[0])
    np.savez(os.path.join(out, "jax.npz"), **want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two gloo groups and the JAX process, started once and together."""
    out = str(tmp_path_factory.mktemp("parallel"))
    t0 = time.perf_counter()
    ring_procs = _spawn(["--worker", "ring"], RING_RANKS, out)
    bundle = _jax_pipeline()
    _export_weights(bundle, os.path.join(out, "weights.pt"))
    np.savez(os.path.join(out, "inputs.npz"), **_inputs(bundle))
    restore_procs = _spawn(["--worker", "restore"], RESTORE_RANKS, out)
    jax_proc = _spawn(["--jax"], 1, out, XLA_FLAGS=JAX_FAST_FLAGS, JAX_PLATFORMS="cpu")
    _wait(ring_procs, "ring")
    _wait(restore_procs, "restore")
    _wait(jax_proc, "jax")
    want = dict(np.load(os.path.join(out, "jax.npz")))
    got = {**{f"ring.{k}": v for k, v in np.load(os.path.join(out, "ring.npz")).items()},
           **{f"restore.{k}": v for k, v in np.load(os.path.join(out, "restore.npz")).items()}}
    print(f"[parallel] groups and JAX side in {time.perf_counter() - t0:.1f} s")
    return want, got


@pytest.mark.parametrize("tag", ["default", "half"])
def test_ring_at_4_ranks_matches_jax(runs, tag):
    want, got = runs
    out = got[f"ring.out_{tag}"]
    np.testing.assert_allclose(out, want[f"xla_{tag}"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out, want[f"ring_{tag}"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("tag", ["default", "half"])
def test_ring_gradient_at_4_ranks_matches_jax(runs, tag):
    want, got = runs
    for name in "qkv":
        np.testing.assert_allclose(got[f"ring.d{name}_{tag}"], want[f"d{name}_{tag}"], atol=5e-5, rtol=1e-3,
                                   err_msg=f"d{name}")
    if tag == "default":
        np.testing.assert_allclose(got["ring.dq_default"], want["ring_dq"], atol=5e-5, rtol=1e-3)


def test_ring_refuses_an_indivisible_sequence(runs):
    assert "divisible" in str(runs[1]["ring.refused"])


def test_sequence_parallel_restore_matches_jax_and_dense(runs):
    want, got = runs
    sp, dense, calls = got["restore.sp"], got["restore.sp_dense"], got["restore.sp_calls"]
    assert calls.size, "no attention took the ring path"
    assert calls.max() >= 256, f"the long sequences did not ring: {sorted(set(calls.tolist()))}"
    assert set(calls.tolist()) == {64, 128, 256, 512}, sorted(set(calls.tolist()))
    scale = float(np.abs(want["sp"]).max())
    assert float(np.abs(sp - want["sp"]).max()) <= 1e-4 * scale
    np.testing.assert_allclose(sp, dense, atol=2e-4, rtol=2e-4)


def test_sequence_parallel_composes_with_vae_tiling(runs):
    _, got = runs
    plain, tiled = got["restore.sp_image"], got["restore.sp_tiled"]
    assert tiled.shape == plain.shape == (1, SP_RES, SP_RES, 3)
    assert np.isfinite(tiled).all()
    err = np.abs(tiled - plain).mean() / (np.abs(plain).mean() + 1e-8)
    assert err < 0.4, err


def test_sharded_restore_at_2_ranks_matches_jax(runs):
    want, got = runs
    lat = got["restore.sharded"]
    assert lat.shape == want["sharded"].shape == (SHARD_BATCH, SHARD_LATENT, SHARD_LATENT, 4)
    scale = float(np.abs(want["sharded"]).max())
    assert float(np.abs(lat - want["sharded"]).max()) <= 1e-4 * scale


def test_sharded_restore_refuses_an_indivisible_batch(runs):
    assert "not divisible by mesh data axis" in str(runs[1]["restore.refused"])


if __name__ == "__main__" and len(sys.argv) == 6 and sys.argv[1] == "--worker":
    worker_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
elif __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--jax":
    jax_main(sys.argv[2])
