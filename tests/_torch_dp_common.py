"""Shared parts of the data-parallel trainer tests (``test_torch_port_dp.py``
and ``test_torch_port_dp_stage2_previewer.py``): the tiny configs, the inputs
(numpy, made from seeds and the JAX steps' keys), the port's trainers built on
weights exported from the JAX trees, and the processes a test starts.

A test file run as a script is one gloo rank (``--worker RANK WORLD DIR``) or
the JAX side (``--jax ... DIR``). This module imports neither JAX nor the JAX
package at import time: a worker imports torch, numpy and the port only, and
asserts so at its end (``assert_no_jax``); the JAX helpers import JAX inside.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

RES, LATENT, BATCH, RANKS = 32, 16, 2, 2
KINDS = ("stage1", "stage2", "previewer")
KEYS = (17, 18)  # the JAX steps' keys; the port gets their draws
LR = 1e-3
BASE = dict(train_batch_size=BATCH, resolution=RES, learning_rate=LR, lr_scheduler="cosine", lr_warmup_steps=0,
            max_train_steps=10, output_dir="", resume_from_checkpoint=None)
STEP_CFG = {
    "stage1": dict(BASE, image_drop_rate=0.5, importance_sampling=True),
    "stage2": dict(BASE, image_drop_rate=0.3, text_drop_rate=0.3, cond_drop_rate=0.3, cfg_scale=2.0,
                   optimize_adapter=True, ema_decay=0.5, ema_update_steps=1, importance_sampling=True),
    "previewer": dict(BASE, num_ddim_timesteps=2, image_drop_rate=0.5),
}
PREVIEWER_LOSSES = [dict(name="HuberLoss", weight=1.0, init_params={"huber_c": 0.001}),
                    dict(name="DINOLoss", weight=1e-3)]
MODELS = ("unet", "aggregator", "vae", "resampler", "image_encoder")
TRAINED = {"stage1": ("unet", "resampler"), "stage2": ("unet", "aggregator", "resampler"),
           "previewer": ("unet", "resampler")}
# the slim tiny UNet of tests/test_torch_port_restore_options.py (one resnet and one transformer layer a block):
# the JAX step compiles bound these files
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
WORKER_TIMEOUT = 600
# the JAX side: the suite's virtual 8-device CPU mesh (as conftest.py sets it) at XLA's lowest CPU level
JAX_FAST_FLAGS = ("--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
                  "--xla_llvm_disable_expensive_passes=true")


# --------------------------------------------------------------------------
# the port (no JAX)
# --------------------------------------------------------------------------


def port_pipeline(out: str):
    import torch

    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline

    pipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(), device="cpu")
    state = torch.load(os.path.join(out, "weights.pt"), weights_only=True)
    for name in MODELS:
        getattr(pipe, name).load_state_dict(state[name], strict=True)
    return pipe


def trainer(kind: str, out: str, mesh="auto", **cfg):
    from instantir_tpu_torch.losses import LossesConfig, SingleLossConfig
    from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

    pipe = port_pipeline(out)
    models = (pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder)
    cfg = {**STEP_CFG[kind], **cfg}
    if kind == "stage1":
        return Stage1Trainer(*models, Stage1Config(**cfg), device="cpu", mesh=mesh)
    if kind == "stage2":
        return Stage2Trainer(pipe.unet, pipe.aggregator, *models[1:], Stage2Config(**cfg), device="cpu", mesh=mesh)
    losses = LossesConfig(lcm_losses=[SingleLossConfig(**c) for c in PREVIEWER_LOSSES])
    return PreviewerTrainer(*models, PreviewerConfig(**cfg), losses, device="cpu", mesh=mesh)


def draws(kind: str, data, i: int):
    """The global draws of the JAX step ``i`` of ``kind``."""
    import torch

    from instantir_tpu_torch.train.previewer_lora import PreviewerDraws
    from instantir_tpu_torch.train.stage1_adapter import Stage1Draws
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Draws

    cls = {"stage1": Stage1Draws, "stage2": Stage2Draws, "previewer": PreviewerDraws}[kind]
    prefix = f"draws.{kind}.{i}."
    return cls(**{k[len(prefix):]: torch.from_numpy(data[k]) for k in data.files if k.startswith(prefix)})


def batch(tr, data):
    """This rank's rows of the global degraded batch and its conditioning (the whole batch without a mesh)."""
    import torch

    from instantir_tpu_torch.parallel import shard_batch

    cond = {k[len("cond."):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("cond.")}
    pair = {"lq": torch.from_numpy(data["lq"]), "gt": torch.from_numpy(data["gt"])}
    if tr.mesh is not None:
        pair, cond = shard_batch(pair, tr.mesh), shard_batch(cond, tr.mesh)
    return tr.prepare_batch(pair, cond)


def step_results(tr, data, kind: str, tag: str) -> dict:
    """``tag``'s loss, gradient norm and gradients by name of one step of ``kind`` on the JAX step's draws."""
    from instantir_tpu_torch.train import common

    loss, _, grads = tr.loss_and_grads(batch(tr, data), draws(kind, data, 0))
    res = {f"{kind}.{tag}.loss": np.asarray(float(loss)),
           f"{kind}.{tag}.grad_norm": np.asarray(float(common.global_norm(grads)))}
    for name, g in zip(tr.trainable_names, grads):
        res[f"{kind}.{tag}.grad.{name}"] = g.float().numpy()
    return res


def join_group(rank: int, world: int, out: str) -> None:
    """This process as rank ``rank`` of a gloo group of ``world`` (a ``file://`` rendezvous in ``out``)."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    import torch

    from instantir_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    assert initialize_distributed(init_method="file://" + os.path.join(out, "rendezvous"), device="cpu")


def assert_no_jax() -> None:
    banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "instantir_tpu")]
    assert not banned, f"a worker imported {banned[:5]}"


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------


def jax_models():
    from instantir_tpu.models.aggregator import Aggregator
    from instantir_tpu.models.dinov2 import DINOv2Model, tiny_dinov2_config
    from instantir_tpu.models.resampler import Resampler, tiny_resampler_config
    from instantir_tpu.models.unet import UNet2DConditionModel, tiny_unet_config
    from instantir_tpu.models.vae import AutoencoderKL, tiny_vae_config

    ucfg = tiny_unet_config(**SLIM)
    rcfg = tiny_resampler_config(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    return (UNet2DConditionModel(ucfg), Aggregator(ucfg), AutoencoderKL(tiny_vae_config()), Resampler(rcfg),
            DINOv2Model(tiny_dinov2_config()))


def jax_params():
    """Parameter trees of each module's ``init`` structure (``jax.eval_shape``),
    every leaf drawn from a numpy seed."""
    import jax

    unet, agg, vae, res, dino = jax_models()

    def init(module, seed, *args, **kwargs):
        rng = np.random.default_rng(seed)

        def leaf(path, s):
            if str(getattr(path[-1], "key", path[-1])) == "scale":
                return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            if len(s.shape) >= 2:
                return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

        return jax.tree_util.tree_map_with_path(
            leaf, jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)))

    z, t0 = np.zeros((1, LATENT, LATENT, 4), np.float32), np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    return {
        "unet": init(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": init(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": init(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": init(res, 4, np.zeros((1, 5, res.config.embedding_dim), np.float32)),
        "image_encoder": init(dino, 5, np.zeros((1, dino.config.image_size, dino.config.image_size, 3), np.float32)),
    }


def jax_draws(kind: str, key):
    """The JAX steps' draws for ``key`` (each trainer's key schedule), global batch."""
    import jax
    import jax.numpy as jnp

    shape = (BATCH, LATENT, LATENT, 4)
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    if kind == "stage1":
        k_t, k_noise, k_drop, k_vae = jax.random.split(key, 4)
        return {"timesteps": np.asarray(jax.random.randint(k_t, (BATCH,), 0, 1000)),
                "noise": a(jax.random.normal(k_noise, shape)),
                "drop_uniform": a(jax.random.uniform(k_drop, (BATCH, 1, 1))).reshape(BATCH),
                "vae_noise": a(jax.random.normal(k_vae, shape, dtype=jnp.float32))}
    if kind == "stage2":
        k_t, k_noise, k_drop, k_w, k_vae1, k_vae2 = jax.random.split(key, 6)
        return {"timesteps": np.asarray(jax.random.randint(k_t, (BATCH,), 0, 1000)),
                "noise": a(jax.random.normal(k_noise, shape)),
                "drop_uniform": a(jax.random.uniform(k_drop, (BATCH,))),
                "cfg_uniform": a(jax.random.uniform(k_w, (BATCH, 1, 1, 1))).reshape(BATCH),
                "vae_noise_gt": a(jax.random.normal(k_vae1, shape, dtype=jnp.float32)),
                "vae_noise_lq": a(jax.random.normal(k_vae2, shape, dtype=jnp.float32))}
    k_i, k_noise, k_w, k_drop, k_vae = jax.random.split(key, 5)
    return {"solver_index": np.asarray(jax.random.randint(k_i, (BATCH,), 0, STEP_CFG["previewer"]["num_ddim_timesteps"])),
            "noise": a(jax.random.normal(k_noise, shape)),
            "w_uniform": a(jax.random.uniform(k_w, (BATCH, 1, 1, 1))).reshape(BATCH),
            "drop_uniform": a(jax.random.uniform(k_drop, (BATCH, 1, 1))).reshape(BATCH),
            "vae_noise": a(jax.random.normal(k_vae, shape, dtype=jnp.float32))}


def inputs(kinds, keys) -> dict:
    """The global batch, its conditioning and the draws of ``kinds`` at ``keys`` (numpy)."""
    import jax

    rng = np.random.default_rng(71)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    out = {"gt": gt, "lq": np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32),
           "cond.prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
           "cond.pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
           "cond.time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1)),
           "cond.uncond_prompt_embeds": (0.1 * rng.standard_normal((BATCH, 7, 32))).astype(np.float32),
           "cond.uncond_pooled_embeds": (0.1 * rng.standard_normal((BATCH, 16))).astype(np.float32)}
    for kind in kinds:
        for i, seed in enumerate(keys):
            out.update({f"draws.{kind}.{i}.{k}": v for k, v in jax_draws(kind, jax.random.PRNGKey(seed)).items()})
    return out


def write_inputs(out: str, params, data: dict) -> None:
    """``params.npz`` (the JAX trees, flat), ``weights.pt`` (the port's, through ``convert.py``) and ``inputs.npz``."""
    import torch
    from flax.traverse_util import flatten_dict

    from instantir_tpu_torch import convert

    np.savez(os.path.join(out, "params.npz"), **{"/".join(k): v for k, v in flatten_dict(params).items()})
    dino_layers = jax_models()[4].config.num_layers
    torch.save({"unet": convert.to_torch(convert.export_unet(params["unet"])),
                "aggregator": convert.to_torch(convert.export_aggregator(params["aggregator"])),
                "vae": convert.to_torch(convert.export_vae(params["vae"])),
                "resampler": convert.to_torch(convert.export_resampler(params["resampler"])),
                "image_encoder": convert.to_torch(convert.export_dinov2(params["image_encoder"], dino_layers))},
               os.path.join(out, "weights.pt"))
    np.savez(os.path.join(out, "inputs.npz"), **data)


def load_params(out: str):
    from flax.traverse_util import unflatten_dict

    with np.load(os.path.join(out, "params.npz")) as flat:
        return unflatten_dict({tuple(k.split("/")): flat[k] for k in flat.files})


def port_names(params, kind: str, trainable) -> dict:
    """The JAX trainable leaves of ``kind`` under the port's names (``convert.export_named``)."""
    import jax
    from flax.traverse_util import flatten_dict, unflatten_dict

    from instantir_tpu_torch import convert

    full = jax.tree_util.tree_map(np.zeros_like, {k: params[k] for k in TRAINED[kind]})
    flat = flatten_dict(full)
    flat.update({k: np.asarray(v) for k, v in jax.device_get(trainable).items() if k[0] in full})
    return {k: np.asarray(v) for k, v in convert.export_named(unflatten_dict(flat)).items()}


def jax_step(kind: str, out: str, mesh) -> dict:
    """The JAX trainer of ``kind`` on ``mesh``, its own jitted step on the
    global batch with the key ``KEYS[0]``, its optimiser swapped for a
    gradient capture (the "optimiser state" that comes back is the gradient;
    the parameters stay): loss, gradient norm, gradients under the port's
    names and, for the previewer, the DINOLoss center after the step."""
    import jax
    import jax.numpy as jnp
    import optax

    from instantir_tpu.losses.loss_config import LossesConfig, SingleLossConfig
    from instantir_tpu.train import common as jcommon
    from instantir_tpu.train.previewer_lora import PreviewerConfig, PreviewerTrainer
    from instantir_tpu.train.stage1_adapter import Stage1Config, Stage1Trainer
    from instantir_tpu.train.stage2_aggregator import Stage2Config, Stage2Trainer

    params = load_params(out)
    unet, agg, vae, res, dino = jax_models()
    if kind == "stage1":
        tr = Stage1Trainer(unet, res, vae, dino, params, Stage1Config(**STEP_CFG[kind]), mesh=mesh)
    elif kind == "stage2":
        tr = Stage2Trainer(unet, agg, res, vae, dino, params, Stage2Config(**STEP_CFG[kind]), mesh=mesh)
    else:
        losses = LossesConfig(lcm_losses=[SingleLossConfig(**c) for c in PREVIEWER_LOSSES])
        tr = PreviewerTrainer(unet, res, vae, dino, params, PreviewerConfig(**STEP_CFG[kind]), losses, mesh=mesh)
    tr.tx = optax.GradientTransformation(
        init=lambda p: (), update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    tr.opt_state = ()
    data = np.load(os.path.join(out, "inputs.npz"))
    cond = {k[len("cond."):]: jnp.asarray(data[k]) for k in data.files if k.startswith("cond.")}
    b = jcommon.shard_or_keep({"lq": jnp.asarray(data["lq"]), "gt": jnp.asarray(data["gt"]), **cond}, tr.mesh)
    metrics = tr.train_step({**b, "uncond_tokens": tr._uncond_image_tokens()}, jax.random.PRNGKey(KEYS[0]))
    want = {f"{kind}.loss": np.asarray(float(metrics["loss"])),
            f"{kind}.grad_norm": np.asarray(float(metrics["grad_norm"]))}
    for name, g in port_names(params, kind, tr.opt_state).items():
        want[f"{kind}.grad.{name}"] = g
    if kind == "previewer":
        want["previewer.center"] = np.asarray(tr.dino_center)
    return want


def close(got: dict, want: dict, prefix_got: str, prefix_want: str) -> None:
    """Loss to 1e-5 relative, the gradient norm likewise, every gradient within 1e-5 + 1e-3 of its leaf's largest value."""
    for m in ("loss", "grad_norm"):
        a, b = float(got[f"{prefix_got}.{m}"]), float(want[f"{prefix_want}.{m}"])
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (m, a, b)
    names = [k[len(prefix_got) + len(".grad."):] for k in got if k.startswith(f"{prefix_got}.grad.")]
    assert names and all(f"{prefix_want}.grad.{n}" in want for n in names)
    for n in names:
        g, w = got[f"{prefix_got}.grad.{n}"], want[f"{prefix_want}.grad.{n}"]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + 1e-3 * float(np.abs(w).max()), err_msg=n)


# --------------------------------------------------------------------------
# the processes
# --------------------------------------------------------------------------


def spawn(script: str, args, out: str, n: int = 1):
    """``n`` processes of the test file ``script`` run as a script: ``args``,
    then the rank and the world for a worker, then ``out``. The JAX side runs
    with ``JAX_FAST_FLAGS``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    if args[0] == "--jax":
        env.update(XLA_FLAGS=JAX_FAST_FLAGS, JAX_PLATFORMS="cpu")
    ranks = (lambda r: [str(r), str(n)]) if args[0] == "--worker" else (lambda r: [])
    return [subprocess.Popen([sys.executable, os.path.abspath(script), *args, *ranks(r), out], cwd=root, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]


def wait(procs, what: str) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} {r} failed:\n{log[-4000:]}"
