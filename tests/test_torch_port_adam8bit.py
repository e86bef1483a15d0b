"""CPU parity of the port's 8-bit AdamW and int8 frozen UNet with the JAX package's.

``train/adam8bit.py`` is held to ``instantir_tpu/train/adam8bit.py`` (through
``make_adamw(use_8bit=True)`` on both sides) over three updates; then one
stage-1 and one stage-2 step with ``quantize_frozen_unet`` and
``use_8bit_adam`` against the JAX step on its own draws (the slimmer tiny
UNet of ``tests/test_torch_port_restore_options.py``, one resnet and one
transformer layer a block; the frozen UNet quantized in both packages at
``MIN_SIZE``), and the port's 8-bit state through a checkpoint.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import unflatten_dict

from instantir_tpu.losses import build_losses as j_build_losses
from instantir_tpu.losses.loss_config import SingleLossConfig as JSingle
from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.ops import quant as jquant
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu.train import common as jcommon
from instantir_tpu.train import stage1_adapter as jstage1
from instantir_tpu.train import stage2_aggregator as jstage2
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.ops import quant
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.train import common as tcommon
from instantir_tpu_torch.train.adam8bit import BLOCK, AdamW8bit
from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Draws, Stage1Trainer
from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Draws, Stage2Trainer

RES, LATENT, BATCH = 32, 16, 2
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
MIN_SIZE = 2048  # the tiny UNet's 64-wide linears and its 32-channel 3x3 convolutions but conv_in
BASE_CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=1e-3, lr_scheduler="cosine", lr_warmup_steps=0,
                max_train_steps=10, output_dir="", use_8bit_adam=True, quantize_frozen_unet=True)
S1_CFG = dict(BASE_CFG, image_drop_rate=0.5, importance_sampling=True)
S2_CFG = dict(BASE_CFG, image_drop_rate=0.3, text_drop_rate=0.3, cond_drop_rate=0.3, cfg_scale=1.0,
              optimize_adapter=False, use_ema_adapter=True)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# the optimiser against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw8bit_matches_jax_over_three_updates(dtype):
    """Leaves of 3,000 values (a part-filled second block), 2,048 (one whole
    block), 5 and an all-zero leaf whose gradient is zero too. The masters
    within 1e-6 relative of the JAX parameters; the int8 moment codes equal
    but for ±1 where a value lies at a rounding tie of the two packages'
    fp32 arithmetic, counted (at most 0.1% of the codes); the scales within
    1e-6 relative. bf16 leaves train
    through their fp32 masters (each leaf its master's rounding) fed
    bf16-valued gradients."""
    rng = np.random.default_rng(7)
    shapes = [(3000,), (64, 32), (5,), (3, 7)]
    p0 = [(0.05 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    p0[3][:] = 0.0
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes] for scale in (3.0, 0.1, 1.0)]
    for gs in grads:
        gs[3][:] = 0.0
    if dtype == torch.bfloat16:
        def bf16(x):
            return _t(x).bfloat16().float().numpy()

        p0 = [bf16(p) for p in p0]
        grads = [[bf16(g) for g in gs] for gs in grads]
    sched = ("cosine", 1e-2, 0, 10)
    tx = jcommon.make_adamw(jcommon.lr_schedule(*sched), weight_decay=0.1, use_8bit=True)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(_t(p).to(dtype)) for p in p0]
    opt = tcommon.make_adamw(tp, tcommon.lr_schedule(*sched), weight_decay=0.1, use_8bit=True)
    assert isinstance(opt, AdamW8bit)
    ties, codes = 0, 0
    for i, g in enumerate(grads):
        updates, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([_t(x).to(dtype) for x in g])
        assert abs(float(norm) - float(optax.global_norm([jnp.asarray(x) for x in g]))) <= 1e-5 * float(norm)
        adam = state[1][0]
        for j, (p, m, b) in enumerate(zip(tp, opt.masters, jp)):
            assert m.dtype == torch.float32
            scale = max(float(np.abs(np.asarray(b)).max()), 1e-30)
            assert np.abs(m.detach().numpy() - np.asarray(b)).max() <= 1e-6 * scale, f"update {i}, leaf {j}"
            if p is not m:
                assert torch.equal(p.detach(), m.to(p.dtype))
            leaf = opt._leaf_state(j)
            for key in ("mu", "nu"):
                got, want = leaf[f"{key}_q"].numpy().astype(np.int32), np.asarray(getattr(adam, f"{key}_q")[j], np.int32)
                assert got.shape == want.shape == (-(-p.numel() // BLOCK), BLOCK)
                assert np.abs(got - want).max() <= 1, (i, j, key)
                ties += int((got != want).sum())
                codes += got.size
                np.testing.assert_allclose(leaf[f"{key}_scale"].numpy(), np.asarray(getattr(adam, f"{key}_scale")[j]),
                                           rtol=1e-6)
        np.testing.assert_array_equal(opt._leaf_state(3)["mu_q"].numpy(), 0)
        np.testing.assert_array_equal(opt._leaf_state(3)["mu_scale"].numpy(), 1.0)
    assert ties <= 1e-3 * codes, f"{ties} of {codes} moment codes one step apart"
    assert opt.count == 3 and opt.mu_q.dtype == opt.nu_q.dtype == torch.int8


# ---------------------------------------------------------------------------
# one stage-1 and one stage-2 step with both int8 options against the JAX step
# ---------------------------------------------------------------------------


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
def setup():
    ucfg = j_unet_cfg(**SLIM)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg(image_size=224)
    unet, agg, vae, res, dino = JUNet(ucfg), JAggregator(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, 224, 224, 3), np.float32)),
    }
    rng = np.random.default_rng(43)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    lq = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1)),
            "uncond_prompt_embeds": (0.1 * rng.standard_normal((BATCH, 7, 32))).astype(np.float32),
            "uncond_pooled_embeds": (0.1 * rng.standard_normal((BATCH, 16))).astype(np.float32)}
    return dict(models=(unet, agg, res, vae, dino), params=params, dcfg=dcfg, lq=lq, gt=gt, cond=cond)


def _port_pipe(setup):
    pipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(image_size=224), device="cpu")
    p = setup["params"]
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(p["unet"])), strict=True)
    pipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(p["aggregator"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(p["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(p["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(p["image_encoder"], setup["dcfg"].num_layers)), strict=True)
    return pipe


# XLA's CPU backend at its lowest optimisation level: a third off the JAX step's compile, which bounds this file
# (the loss moves by 1e-7 relative)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at ``FAST``, then called on them."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _capture():
    """A gradient transformation that hands the raw gradients back as its state."""
    return optax.GradientTransformation(init=lambda p: (),
                                        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _named(setup, flat, models):
    full = jax.tree_util.tree_map(np.zeros_like, {k: setup["params"][k] for k in models})
    for model, tree in unflatten_dict({k: np.asarray(v) for k, v in flat.items()}).items():
        def merge(dst, src):
            for key, val in src.items():
                if isinstance(val, dict):
                    merge(dst[key], val)
                else:
                    dst[key] = val
        merge(full[model], tree)
    return convert.export_named(full)


def _check_step(setup, trainer, jgrads, jloss, models, loss, tgrads):
    """The existing train tests' tolerances: loss 1e-5 relative, gradients
    1e-5 + 1e-3 of a leaf's largest value, by name."""
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    want = _named(setup, jgrads, models)
    assert trainer.trainable_names
    for name, got in zip(trainer.trainable_names, tgrads):
        ref = want[name]
        assert tuple(got.shape) == ref.shape, name
        assert np.abs(got.numpy() - ref).max() <= 1e-5 + 1e-3 * np.abs(ref).max(), name


@pytest.fixture(scope="module")
def qparams(setup):
    """The JAX trainers' parameters with the frozen UNet quantized by
    ``quantize_frozen_unet`` at ``MIN_SIZE`` (jitted: one compile in place of
    an eager dispatch per kernel), shared by both steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "DEFAULT_MIN_SIZE", MIN_SIZE)
        return jax.jit(lambda p: jcommon.quantize_frozen_unet(p, keep_pred=jstage1.stage1_trainable_pred))(
            setup["params"])


def test_stage1_qlora_step_matches_jax(setup, qparams, monkeypatch):
    """A stage-1 step on a frozen UNet stored W8 (the ip projections fp) with
    the 8-bit AdamW: loss and every trainable gradient against the JAX step
    (its frozen tree quantized by the JAX ``quantize_frozen_unet``), then the
    update: every master moved, the moments int8."""
    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", MIN_SIZE)
    unet, _, res, vae, dino = setup["models"]
    jcfg = jstage1.Stage1Config(**S1_CFG)
    raw = jstage1.build_stage1_step(unet, res, vae, dino, j_sdxl_schedule(), j_build_losses([JSingle(name="L2Loss")]),
                                    jcfg)
    params = {k: v for k, v in qparams.items() if k != "aggregator"}
    assert "quant" in params["unet"]
    trainable, frozen = jcommon.partition_params(params, jstage1.stage1_trainable_pred)
    pipe = _port_pipe(setup)
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, Stage1Config(**S1_CFG),
                            device="cpu")
    assert quant.quant_mode(trainer.unet) == "w8" and isinstance(trainer.optimizer, AdamW8bit)
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items() if not k.startswith("uncond")})
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": batch["uncond_tokens"].numpy(),
              **{k: v for k, v in setup["cond"].items() if not k.startswith("uncond")}}
    key = jax.random.PRNGKey(17)
    _, grads, jmetrics = _compiled(lambda tr, fr, b, k: raw(tr, fr, (), _capture(), b, k), trainable, frozen, jbatch, key)
    k_t, k_noise, k_drop, k_vae = jax.random.split(key, 4)
    shape = (BATCH, LATENT, LATENT, 4)
    draws = Stage1Draws(timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000))),
                        noise=_t(jax.random.normal(k_noise, shape)),
                        drop_uniform=_t(jax.random.uniform(k_drop, (BATCH, 1, 1))).reshape(BATCH),
                        vae_noise=_t(jax.random.normal(k_vae, shape, dtype=jnp.float32)))
    loss, _, tgrads = trainer.loss_and_grads(batch, draws)
    _check_step(setup, trainer, grads, float(jmetrics["loss"]), ("unet", "resampler"), float(loss), tgrads)
    before = [m.detach().clone() for m in trainer.optimizer.masters]
    trainer.optimizer.step(tgrads)
    assert all(not torch.equal(b, m) for b, m in zip(before, trainer.optimizer.masters))
    assert trainer.optimizer.mu_q.abs().sum() > 0


def test_stage2_qlora_step_matches_jax(setup, qparams, monkeypatch):
    """A stage-2 step with the frozen UNet stored W8 (gradients flow through
    it to the Aggregator) and the 8-bit AdamW, against the JAX step on its
    draws (the previewer on the fp EMA adapter)."""
    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", MIN_SIZE)
    unet, agg, res, vae, dino = setup["models"]
    jcfg = jstage2.Stage2Config(**S2_CFG)
    raw = jstage2.build_stage2_step(unet, agg, res, vae, dino, j_sdxl_schedule(),
                                    j_build_losses([JSingle(name="L2Loss")]), jcfg)
    params = qparams
    trainable, frozen = jcommon.partition_params(params, jstage2.stage2_trainable_pred(jcfg))
    ema, _ = jcommon.partition_params(params, jstage2.ADAPTER_EMA_PRED)
    pipe = _port_pipe(setup)
    trainer = Stage2Trainer(pipe.unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder,
                            Stage2Config(**S2_CFG), device="cpu")
    assert quant.quant_mode(trainer.unet) == "w8" and quant.quant_mode(trainer.aggregator) is None
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": batch["uncond_tokens"].numpy(), **setup["cond"]}
    key = jax.random.PRNGKey(32)
    _, grads, jmetrics = _compiled(lambda tr, fr, e, b, k: raw(tr, fr, e, (), _capture(), b, k), trainable, frozen, ema,
                                   jbatch, key)
    k_t, k_noise, k_drop, k_w, k_vae1, k_vae2 = jax.random.split(key, 6)
    shape = (BATCH, LATENT, LATENT, 4)
    draws = Stage2Draws(timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000))),
                        noise=_t(jax.random.normal(k_noise, shape)),
                        drop_uniform=_t(jax.random.uniform(k_drop, (BATCH,))),
                        cfg_uniform=_t(jax.random.uniform(k_w, (BATCH, 1, 1, 1))).reshape(BATCH),
                        vae_noise_gt=_t(jax.random.normal(k_vae1, shape, dtype=jnp.float32)),
                        vae_noise_lq=_t(jax.random.normal(k_vae2, shape, dtype=jnp.float32)))
    loss, metrics, tgrads = trainer.loss_and_grads(batch, draws)
    jp = float(jmetrics["preview_error_latent"])
    assert abs(float(metrics["preview_error_latent"]) - jp) <= 1e-5 * abs(jp)
    _check_step(setup, trainer, grads, float(jmetrics["loss"]), ("unet", "aggregator", "resampler"), float(loss),
                tgrads)
    assert all(n.startswith("aggregator.") for n in trainer.trainable_names)


# ---------------------------------------------------------------------------
# the 8-bit state through a checkpoint
# ---------------------------------------------------------------------------


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_int8_state_saved_and_resumed_bitwise_and_the_wrong_optimiser_named(setup, tmp_path, monkeypatch):
    """The 8-bit state (masters, int8 moments and scales, count, block size)
    through ``CheckpointManager`` and a resume on fresh models: bitwise, and
    the next step the same. A checkpoint of the other optimiser fails with a
    message naming ``--use_8bit_adam``, both ways."""
    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", MIN_SIZE)
    cfg = Stage1Config(**dict(S1_CFG, output_dir=str(tmp_path)))
    cond = {k: _t(v) for k, v in setup["cond"].items() if not k.startswith("uncond")}

    def trainer_on_fresh_models(c):
        pipe = _port_pipe(setup)
        return Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, c, device="cpu")

    trainer = trainer_on_fresh_models(cfg)
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])}, cond)
    trainer.train_step(batch, generator=torch.Generator().manual_seed(2))
    trainer.save_checkpoint()
    saved = trainer.checkpoint_state()
    assert saved["opt_state"]["block"] == BLOCK
    assert all(s["mu_q"].dtype == torch.int8 for s in saved["opt_state"]["adamw8bit"].values())
    second = trainer_on_fresh_models(cfg)
    assert second.resume() == 1
    assert _tree_equal(saved, second.checkpoint_state())
    a = second.train_step(batch, generator=torch.Generator().manual_seed(3))["loss"]
    b = trainer.train_step(batch, generator=torch.Generator().manual_seed(3))["loss"]
    assert float(a) == float(b)
    assert torch.equal(second.optimizer.mu_q, trainer.optimizer.mu_q)
    assert all(torch.equal(x, y) for x, y in zip(second.optimizer.masters, trainer.optimizer.masters))

    fp32 = trainer_on_fresh_models(dataclasses.replace(cfg, use_8bit_adam=False))
    with pytest.raises(RuntimeError, match="--use_8bit_adam"):
        fp32.resume()
    fp32.train_step(batch)
    fp32.ckpt.save(5, fp32.checkpoint_state())
    with pytest.raises(RuntimeError, match="--use_8bit_adam"):
        trainer_on_fresh_models(cfg).resume()
