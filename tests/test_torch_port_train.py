"""CPU parity of the PyTorch port's stage-1 trainer with the JAX trainer.

Losses, LR schedules and AdamW are held against the JAX package and optax on
inputs made with numpy from a seed. One tiny stage-1 step (the
``tests/test_torch_port_pipeline.py`` configs, 32² images, batch 2) is
compiled once on the JAX side: the same weights go into the port through its
``convert.py``, the JAX step's own ``jax.random`` draws are fed to the port,
and loss, every trainable gradient by name, ``grad_norm`` and the parameters
after two AdamW updates are compared. The port-only tests cover gradient
checkpointing, gradient accumulation and the config fields that are not
ported. A second step at DINOv2's own ``image_size`` 28 holds the 224² input
and the bicubic position embeddings to the JAX step.
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

from instantir_tpu.losses import DiffusionLossInputs as JInputs
from instantir_tpu.losses import build_losses as j_build_losses
from instantir_tpu.losses.loss_config import SingleLossConfig as JSingle
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu.train import common as jcommon
from instantir_tpu.train import stage1_adapter as jstage1
from instantir_tpu_torch import convert
from instantir_tpu_torch.losses import DiffusionLossInputs, SingleLossConfig, build_losses
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.train import common as tcommon
from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Draws, Stage1Trainer, stage1_trainable_pred

RES, LATENT, BATCH, DINO = 32, 16, 2, 224
LR = 1e-3
STEP_CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=LR, lr_scheduler="cosine", lr_warmup_steps=0,
                max_train_steps=10, image_drop_rate=0.5, importance_sampling=True, output_dir="")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------------------
# losses, schedules, optimiser
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,params", [("L2Loss", {}), ("L1Loss", {}), ("HuberLoss", {"huber_c": 0.01}),
                                         ("WeightedNoiseLoss", {})])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, params, weighted):
    rng = np.random.default_rng(30)
    pred, target = (rng.standard_normal((3, 4, 6, 6)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.5, 1.5, 3).astype(np.float32) if weighted else None
    (jloss, jw), = j_build_losses([JSingle(name=name, weight=0.7, init_params=params)])
    (tloss, tw), = build_losses([SingleLossConfig(name=name, weight=0.7, init_params=params)])
    assert type(tloss).__name__ == name and tw == jw == 0.7
    want = float(jloss(JInputs(predicted=pred, target=target, weights=w)))
    got = float(tloss(DiffusionLossInputs(predicted=_t(pred), target=_t(target), weights=None if w is None else _t(w))))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    # bf16 predictions: the loss is still computed in fp32
    got16 = tloss(DiffusionLossInputs(predicted=_t(pred).bfloat16(), target=_t(target)))
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("name", ["LPIPSLoss", "CLIPLoss", "IDLoss", "DreamSIMLoss"])
def test_unported_losses_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        build_losses([SingleLossConfig(name=name)])


@pytest.mark.parametrize("name,warmup", [("constant", 0), ("constant", 2), ("cosine", 0), ("cosine", 2)])
def test_lr_schedule_matches_optax(name, warmup):
    want = jcommon.lr_schedule(name, 3e-4, warmup, 5)
    got = tcommon.lr_schedule(name, 3e-4, warmup, 5)
    for step in range(6):
        assert abs(got(step) - float(want(step))) <= 1e-6 * 3e-4, step
    if warmup:
        assert got(0) == 0.0  # the first update of a warmed-up schedule changes nothing


@pytest.mark.parametrize("warmup,max_norm,dtype", [
    pytest.param(0, 1.0, torch.float32, id="0-1.0"), pytest.param(2, 1.0, torch.float32, id="2-1.0"),
    pytest.param(0, None, torch.float32, id="0-None"), pytest.param(0, 1.0, torch.bfloat16, id="bf16-masters")])
def test_adamw_matches_optax_over_three_updates(warmup, max_norm, dtype):
    """fp32 leaves against optax step by step. bf16 leaves (a bf16 model's) at
    the trainers' learning rate 1e-4 and magnitudes near 0.05, where half a
    bf16 ulp (1.2e-4 above 1/32) swallows a single update: optax updates the
    fp32 parameters the JAX trainers keep, fed the same bf16-valued gradients;
    the port's fp32 masters must match them and each bf16 leaf must be its
    master's rounding."""
    rng = np.random.default_rng(31)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal((4,)).astype(np.float32)]
    grads = [[(s * rng.standard_normal(p.shape)).astype(np.float32) for p in p0] for s in (3.0, 0.1, 1.0)]
    lr = ("cosine", 1e-2, warmup, 10)
    if dtype == torch.bfloat16:
        def bf16(x):  # the bf16 values, in fp32
            return _t(x).bfloat16().float().numpy()

        p0 = [bf16(0.05 * p) for p in p0]
        grads = [[bf16(g) for g in gs] for gs in grads]
        lr = ("constant", 1e-4, 0, 10)
    tx = jcommon.make_adamw(jcommon.lr_schedule(*lr), weight_decay=0.1, max_grad_norm=max_norm)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p).to(dtype)) for p in p0]
    opt = tcommon.make_adamw(tp, tcommon.lr_schedule(*lr), weight_decay=0.1, max_grad_norm=max_norm)
    for i, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([_t(x).to(dtype) for x in g])
        assert abs(float(norm) - float(optax.global_norm([jnp.asarray(x) for x in g]))) <= 1e-5  # before clipping
        if dtype == torch.float32:
            for a, b in zip(tp, jp):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=f"update {i}")
            continue
        for a, m, b in zip(tp, opt.masters, jp):
            assert m.dtype == torch.float32 and a.dtype == torch.bfloat16
            np.testing.assert_allclose(m.numpy(), np.asarray(b), rtol=1e-6, atol=0, err_msg=f"update {i}")
            assert torch.equal(a.detach(), m.bfloat16()), f"update {i}"
            moments = opt.optimizer.state[m]
            assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32
    if dtype == torch.bfloat16:
        moved = [(m - _t(p)).abs().max().item() for m, p in zip(opt.masters, p0)]
        assert all(0 < x < 1e-3 for x in moved), moved
        # the fault the masters repair: AdamW on the bf16 leaves themselves (bf16 moments, clipping in bf16)
        # rounds the small early updates away and misses optax by at least half of what it moves
        naive = [torch.nn.Parameter(_t(p).bfloat16()) for p in p0]
        plain = torch.optim.AdamW(naive, lr=1e-4, weight_decay=0.1)
        for g in grads:
            gb = [_t(x).bfloat16() for x in g]
            factor = max_norm / torch.clamp(tcommon.global_norm(gb), min=max_norm)
            for p, x in zip(naive, gb):
                p.grad = x * factor.to(x.dtype)
            plain.step()
        miss = max((n.detach().float() - _t(b)).abs().max().item() for n, b in zip(naive, jp))
        assert miss >= 0.5 * max(moved), (miss, moved)
    if warmup:
        assert opt.count == 3
    from instantir_tpu_torch.train.adam8bit import AdamW8bit

    assert isinstance(tcommon.make_adamw([torch.nn.Parameter(_t(p)) for p in p0], 1e-3, use_8bit=True), AdamW8bit)


def test_trainable_predicate_on_port_names():
    cases = {
        ("resampler", "latents"): True,
        ("resampler", "layers", "0", "0", "to_q", "weight"): True,
        ("resampler", "layers", "0", "0", "to_q", "lora_A", "weight"): False,
        ("unet", "mid_block", "attentions", "0", "transformer_blocks", "0", "attn2", "processor", "to_k_ip", "weight"): True,
        ("unet", "mid_block", "attentions", "0", "transformer_blocks", "0", "attn2", "processor", "ln_v_ip", "linear", "bias"): True,
        ("unet", "mid_block", "attentions", "0", "transformer_blocks", "0", "attn2", "processor", "to_k_ip", "lora_B", "weight"): False,
        ("unet", "mid_block", "attentions", "0", "transformer_blocks", "0", "attn2", "to_k", "weight"): False,
        ("vae", "encoder", "conv_in", "weight"): False,
        ("image_encoder", "layernorm", "weight"): False,
    }
    for path, want in cases.items():
        assert stage1_trainable_pred(path) is want, path
        jpath = tuple(p.replace("lora_A", "lora_a").replace("lora_B", "lora_b") for p in path)
        assert jstage1.stage1_trainable_pred(jpath) is want, path


# --------------------------------------------------------------------------
# one tiny stage-1 step against the JAX trainer
# --------------------------------------------------------------------------


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


def _build_port(params, dcfg, **step_cfg):
    """A port trainer on the CPU carrying the JAX parameter trees."""
    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(image_size=DINO),
                          device="cpu")
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    cfg = Stage1Config(**{**STEP_CFG, **step_cfg})
    return Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cpu")


def _jax_draws(key):
    """The draws of the JAX step's ``loss_fn`` for ``key`` (its key schedule)."""
    k_t, k_noise, k_drop, k_vae = jax.random.split(key, 4)
    shape = (BATCH, LATENT, LATENT, 4)
    return Stage1Draws(
        timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000))),
        noise=_t(jax.random.normal(k_noise, shape)),
        drop_uniform=_t(jax.random.uniform(k_drop, (BATCH, 1, 1))).reshape(BATCH),
        vae_noise=_t(jax.random.normal(k_vae, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def setup():
    ucfg = j_unet_cfg(with_ip=True, lora_rank=4)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg(image_size=DINO)
    unet, vae, res, dino = JUNet(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, np.zeros((1,), np.int32), text, pooled, tids,
                             ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "vae": _init_random(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, DINO, DINO, 3), np.float32)),
    }
    rng = np.random.default_rng(40)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    lq = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1))}
    return dict(models=(unet, res, vae, dino), params=params, dcfg=dcfg, lq=lq, gt=gt, cond=cond)


@pytest.fixture(scope="module")
def two_steps(setup):
    """Two stage-1 updates on each side. The JAX step is compiled once, with a
    gradient transformation that hands the raw gradients back in place of the
    optimiser state; AdamW (``make_adamw``) is then applied outside that
    program, so the same compiled step serves both updates."""
    unet, res, vae, dino = setup["models"]
    jcfg = jstage1.Stage1Config(**STEP_CFG)
    losses = j_build_losses([JSingle(name="L2Loss")])
    raw_step = jstage1.build_stage1_step(unet, res, vae, dino, j_sdxl_schedule(), losses, jcfg)
    capture = optax.GradientTransformation(
        init=lambda p: (),
        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jax.jit(lambda tr, fr, batch, key: raw_step(tr, fr, (), capture, batch, key))

    trainer = _build_port(setup["params"], setup["dcfg"])
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    frozen_before = {n: p.detach().clone() for n, p in trainer.named_parameters().items() if not p.requires_grad}
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": batch["uncond_tokens"].numpy(), **setup["cond"]}

    trainable, frozen = jcommon.partition_params(setup["params"], jstage1.stage1_trainable_pred)
    tx = jcommon.make_adamw(jcommon.lr_schedule(jcfg.lr_scheduler, jcfg.learning_rate, jcfg.lr_warmup_steps,
                                                jcfg.max_train_steps),
                            weight_decay=jcfg.weight_decay, max_grad_norm=jcfg.max_grad_norm)
    opt_state = tx.init(trainable)
    apply = jax.jit(lambda g, s, p: tx.update(g, s, p))
    key = jax.random.PRNGKey(17)
    out = []
    for _ in range(2):
        key, k_step = jax.random.split(key)
        _, grads, jmetrics = step(trainable, frozen, jbatch, k_step)
        updates, opt_state = apply(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)

        draws = _jax_draws(k_step)
        loss, _, tgrads = trainer.loss_and_grads(batch, draws)
        tmetrics = trainer.train_step(batch, draws)
        out.append(dict(jgrads=grads, jmetrics={k: float(v) for k, v in jmetrics.items()},
                        tgrads=dict(zip(trainer.trainable_names, tgrads)), tloss=float(loss),
                        tmetrics={k: float(v) for k, v in tmetrics.items()}, jparams=trainable))
    return dict(steps=out, trainer=trainer, frozen_before=frozen_before, frozen_tree=frozen)


def _named(setup, flat_trainable, fill=None):
    """A flat ``{path tuple: leaf}`` dict of the JAX trainer's trainable leaves
    -> the port's names, through ``convert.export_named`` (frozen leaves zero)."""
    full = jax.tree_util.tree_map(np.zeros_like, {k: setup["params"][k] for k in ("unet", "resampler")})
    for model, tree in unflatten_dict({k: np.asarray(v) for k, v in flat_trainable.items()}).items():
        def merge(dst, src):
            for key, val in src.items():
                if isinstance(val, dict):
                    merge(dst[key], val)
                else:
                    dst[key] = val
        merge(full[model], tree)
    return convert.export_named(full)


def test_stage1_step_at_dino_native_28_matches_jax(setup):
    """DINOv2 at the tiny config's own ``image_size`` 28: both steps feed it
    224² pixels (its position embeddings resized bicubically) and 224² uncond
    tokens. One step, loss and every trainable gradient by name."""
    unet, res, vae, _ = setup["models"]
    dcfg = j_dino_cfg()
    dino = JDINO(dcfg)
    params = {**setup["params"],
              "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32))}
    jcfg = jstage1.Stage1Config(**STEP_CFG)
    raw_step = jstage1.build_stage1_step(unet, res, vae, dino, j_sdxl_schedule(),
                                         j_build_losses([JSingle(name="L2Loss")]), jcfg)
    capture = optax.GradientTransformation(
        init=lambda p: (),
        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    juncond = np.asarray(dino.apply(params["image_encoder"], np.zeros((1, 224, 224, 3), np.float32)))
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": juncond, **setup["cond"]}
    trainable, frozen = jcommon.partition_params(params, jstage1.stage1_trainable_pred)
    key = jax.random.PRNGKey(19)
    _, grads, jmetrics = jax.jit(lambda tr, fr, b, k: raw_step(tr, fr, (), capture, b, k))(trainable, frozen, jbatch, key)

    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cpu")
    for name, model in (("unet", pipe.unet), ("vae", pipe.vae), ("resampler", pipe.resampler)):
        model.load_state_dict(convert.to_torch(getattr(convert, f"export_{name}")(params[name])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, Stage1Config(**STEP_CFG),
                            device="cpu")
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    assert np.abs(batch["uncond_tokens"].numpy() - juncond).max() <= 1e-5 * np.abs(juncond).max()
    loss, _, tgrads = trainer.loss_and_grads(batch, _jax_draws(key))
    assert abs(float(loss) - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    want = _named(setup, grads)
    for name, got in zip(trainer.trainable_names, tgrads):
        bound = 1e-5 + 1e-3 * np.abs(want[name]).max()
        assert np.abs(got.numpy() - want[name]).max() <= bound, name


def test_trainable_leaves_match_jax_partition(setup, two_steps):
    trainer = two_steps["trainer"]
    trainable, _ = jcommon.partition_params(setup["params"], jstage1.stage1_trainable_pred)
    want = {n for n, v in _named(setup, {k: np.ones_like(v) for k, v in trainable.items()}).items() if v.any()}
    assert set(trainer.trainable_names) == want
    assert tcommon.count_params(trainer.trainable) == sum(int(np.prod(v.shape)) for v in trainable.values())
    assert not any("lora_" in n for n in trainer.trainable_names)


def test_stage1_loss_and_grad_norm_match_jax(two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = s["jmetrics"]
        # fp32 on both sides: 1e-5 relative is a few ulps of the reductions
        assert abs(s["tloss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), i
        assert abs(s["tmetrics"]["L2Loss"] - want["L2Loss"]) <= 1e-5 * abs(want["L2Loss"]), i
        assert abs(s["tmetrics"]["grad_norm"] - want["grad_norm"]) <= 1e-3 * want["grad_norm"], i


def test_stage1_gradients_match_jax_by_name(setup, two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = _named(setup, s["jgrads"])
        assert set(s["tgrads"]) <= set(want)
        worst = 0.0
        for name, got in s["tgrads"].items():
            ref = want[name]
            assert tuple(got.shape) == ref.shape, name
            bound = 1e-5 + 1e-3 * np.abs(ref).max()  # atol 1e-5 + rtol 1e-3 of the leaf's largest value
            err = np.abs(got.numpy() - ref).max()
            worst = max(worst, err / bound)
            assert err <= bound, (i, name, err, bound)
        frozen = [n for n in want if n not in s["tgrads"]]
        assert all(not want[n].any() for n in frozen)  # the JAX step gave the frozen leaves no gradient either
        assert np.isfinite(worst)


def test_stage1_parameters_after_two_updates_match_jax(setup, two_steps):
    """AdamW normalises each element's update to about lr whatever the size of
    its gradient, so where a gradient is numerical noise around an analytic zero
    (the shift half of ``ln_k_ip``: softmax ignores a constant added to every
    key) the two frameworks may step in different directions. Elements whose
    JAX gradient is above 1e-4 of its leaf's largest in both steps (86% of them)
    must agree within 2e-6 (measured 1e-6); the rest within a tenth of the two
    updates' reach 2·lr (measured 1.5e-4 of 2e-3)."""
    trainer = two_steps["trainer"]
    want = _named(setup, two_steps["steps"][-1]["jparams"])
    g1, g2 = (_named(setup, s["jgrads"]) for s in two_steps["steps"])
    named = trainer.named_parameters()
    start = convert.export_named({k: setup["params"][k] for k in ("unet", "resampler")})
    determined = []
    for name in trainer.trainable_names:
        got = named[name].detach().numpy()
        assert np.abs(got - start[name]).max() > 1e-4, f"{name} did not move"
        diff = np.abs(got - want[name])
        floor = 1e-4 * max(np.abs(g1[name]).max(), np.abs(g2[name]).max())
        mask = np.minimum(np.abs(g1[name]), np.abs(g2[name])) > floor
        determined.append(mask.mean())
        assert diff[mask].max(initial=0.0) <= 2e-6, name
        assert diff.max() <= 0.1 * 2 * LR, name
    assert np.mean(determined) > 0.8
    assert trainer.global_step == 2 and trainer.optimizer.count == 2


def test_stage1_frozen_leaves_bit_equal(two_steps):
    named = two_steps["trainer"].named_parameters()
    assert len(two_steps["frozen_before"]) > 100
    for name, before in two_steps["frozen_before"].items():
        assert torch.equal(named[name], before), name
        assert named[name].grad is None


def test_adapter_export_layout(setup, two_steps):
    trainer = two_steps["trainer"]
    payload = trainer.adapter_state()
    from instantir_tpu.convert.flax_to_torch import export_ip_adapter as j_export_ip

    unet = setup["models"][0]
    params = jcommon.merge_params(two_steps["steps"][-1]["jparams"], two_steps["frozen_tree"])
    want = {k: v for k, v in j_export_ip(params["unet"], unet.config).items() if "lora_" not in k}
    assert set(payload["ip_adapter"]) == set(want)
    for k, v in want.items():
        # the values are the parameters compared above; here the layout is the point
        np.testing.assert_allclose(payload["ip_adapter"][k].numpy(), np.asarray(v), rtol=0, atol=0.1 * 2 * LR, err_msg=k)
    assert set(payload["image_proj"]) == {k for k in trainer.resampler.state_dict() if "lora_" not in k}


# --------------------------------------------------------------------------
# port only
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_inputs(setup):
    def make(**cfg):
        trainer = _build_port(setup["params"], setup["dcfg"], **cfg)
        batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                      {k: _t(v) for k, v in setup["cond"].items()})
        return trainer, batch

    return make


def _draws(seed):
    g = torch.Generator().manual_seed(seed)
    shape = (BATCH, LATENT, LATENT, 4)
    return Stage1Draws(timesteps=torch.randint(0, 1000, (BATCH,), generator=g), noise=torch.randn(shape, generator=g),
                       drop_uniform=torch.rand(BATCH, generator=g), vae_noise=torch.randn(shape, generator=g))


def test_gradient_checkpointing_gives_the_same_gradients(port_inputs):
    trainer, batch = port_inputs()
    loss, _, grads = trainer.loss_and_grads(batch, _draws(1))
    trainer.unet.gradient_checkpointing = True
    loss_c, _, grads_c = trainer.loss_and_grads(batch, _draws(1))
    assert float(loss) == float(loss_c)
    for name, a, b in zip(trainer.trainable_names, grads, grads_c):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=name)
    assert tiny_unet_config(gradient_checkpointing=True).gradient_checkpointing


def test_gradient_accumulation_steps_on_the_mean_gradient(port_inputs):
    acc, batch = port_inputs(gradient_accumulation_steps=2)
    one, _ = port_inputs()
    start = {n: p.detach().clone() for n, p in acc.named_parameters().items()}
    g1 = acc.loss_and_grads(batch, _draws(2))[2]
    g2 = acc.loss_and_grads(batch, _draws(3))[2]
    acc.train_step(batch, _draws(2))
    for n, p in acc.named_parameters().items():
        assert torch.equal(p, start[n]), f"{n} moved after the first micro-step"
    acc.train_step(batch, _draws(3))
    one.optimizer.step([(a + b) / 2 for a, b in zip(g1, g2)])
    assert acc.optimizer.count == 1 and acc.global_step == 2
    for (n, a), b in zip(acc.named_parameters().items(), one.named_parameters().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=n)


def test_own_draws_are_seeded_and_generator_driven(port_inputs):
    trainer, batch = port_inputs()
    a = trainer.loss_and_grads(batch, generator=torch.Generator().manual_seed(5))[0]
    b = trainer.loss_and_grads(batch, generator=torch.Generator().manual_seed(5))[0]
    c = trainer.loss_and_grads(batch, generator=torch.Generator().manual_seed(6))[0]
    assert float(a) == float(b) and float(a) != float(c)


@pytest.mark.parametrize("field,value", [("use_8bit_adam", True), ("quantize_frozen_unet", True),
                                         ("validation_steps", 100)])
def test_unported_config_fields_raise(setup, monkeypatch, field, value):
    """The fields the port once refused now build a trainer that honours
    them: the 8-bit AdamW, the W8 frozen UNet (at a lowered threshold; the
    trained ip projections stay fp), validation."""
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.train.adam8bit import AdamW8bit

    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", 1)
    trainer = _build_port(setup["params"], setup["dcfg"], **{field: value})
    assert getattr(trainer.cfg, field) == value
    assert isinstance(trainer.optimizer, AdamW8bit) == (field == "use_8bit_adam")
    assert (quant.quant_mode(trainer.unet) == "w8") == (field == "quantize_frozen_unet")
    assert all(trainer.named_parameters()[n].requires_grad for n in trainer.trainable_names)


def test_raw_batches_and_missing_card_raise(port_inputs):
    trainer, _ = port_inputs()
    with pytest.raises(ValueError, match="kernel"):  # raw images need their blur kernels for the degradation
        trainer.prepare_batch({"images": torch.zeros(1, 8, 8, 3)}, {})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage1Trainer(trainer.unet, trainer.resampler, trainer.vae, trainer.image_encoder, Stage1Config(**STEP_CFG))


@pytest.mark.parametrize("kind", ["stage1", "stage2", "previewer"])
def test_bf16_trainer_exports_its_fp32_masters(kind):
    """A trainer over bf16 models (the card's dtype) at the tiny configs: its
    optimiser holds fp32 masters for the bf16 trainable leaves, each leaf is
    its master's bf16 rounding after two updates, and the export
    (``adapter_state``, ``aggregator_state``, ``lora_state``) is fp32 and
    equal to the masters, as the JAX trainers export their fp32 parameters.
    The updates are synthetic gradients at the trainers' learning rate."""
    from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(),
                          dtype=torch.bfloat16, device="cpu")
    cfg = dict(train_batch_size=BATCH, resolution=RES, learning_rate=1e-4, lr_warmup_steps=0, output_dir="")
    if kind == "stage1":
        trainer = Stage1Trainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, Stage1Config(**cfg),
                                device="cpu")
    elif kind == "stage2":
        trainer = Stage2Trainer(pipe.unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder,
                                Stage2Config(**cfg), device="cpu")
    else:
        trainer = PreviewerTrainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, PreviewerConfig(**cfg),
                                   device="cpu")
    opt = trainer.optimizer
    assert torch.bfloat16 in {p.dtype for p in trainer.trainable}  # LayerNorm32 keeps its fp32 leaves
    for m, p in zip(opt.masters, trainer.trainable):
        assert m.dtype == torch.float32 and (m is p) == (p.dtype == torch.float32)
    g = torch.Generator().manual_seed(17)
    for _ in range(2):
        opt.step([torch.randn(p.shape, generator=g).bfloat16() for p in trainer.trainable])
    for p, m in zip(trainer.trainable, opt.masters):
        assert torch.equal(p.detach(), m.to(p.dtype))
    assert any(not torch.equal(p.detach().float(), m) for p, m in zip(trainer.trainable, opt.masters))
    masters = trainer.master_parameters()
    if kind == "stage1":
        payload = trainer.adapter_state()
        want = {"image_proj": {k: v for k, v in trainer.master_state("resampler").items() if "lora_" not in k},
                "ip_adapter": convert.export_ip_adapter(trainer.master_state("unet"))}
        exported = [(f"{part}.{k}", v, want[part][k]) for part, tensors in payload.items() for k, v in tensors.items()]
        assert {k for k, _, _ in exported} == {f"{part}.{k}" for part, tensors in want.items() for k in tensors}
    elif kind == "stage2":
        exported = [(k, v, masters[f"aggregator.{k}"]) for k, v in trainer.aggregator_state().items()]
    else:
        exported = [(k, v, masters[k]) for k, v in trainer.lora_state().items()]
    assert exported
    for name, got, master in exported:
        assert got.dtype == torch.float32 and got.device.type == "cpu", name
        assert torch.equal(got, master.float()), name
    trained = {id(m) for m in opt.masters}
    assert any(id(master) in trained for _, _, master in exported)


def test_jax_and_port_configs_have_the_same_fields():
    want = {f.name: f.default for f in dataclasses.fields(jstage1.Stage1Config)}
    got = {f.name: f.default for f in dataclasses.fields(Stage1Config)}
    assert got == want
