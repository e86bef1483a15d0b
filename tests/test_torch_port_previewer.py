"""CPU parity of the PyTorch port's previewer (LCM-LoRA distillation) trainer with the JAX trainer.

One tiny previewer step (the ``tests/test_torch_port_stage2.py`` configs, 32²
images, batch 2, DINOv2 at its own ``image_size`` 28 fed 224² pixels) is
compiled once on the JAX side with the losses ``[HuberLoss 1, DINOLoss 1e-3,
LCMVisualization k=1]``, so that one program covers the Huber objective, the
image branch (the VAE decodes, DINOv2 on both images) and the strip. With
two solver points (``num_ddim_timesteps=2``) and ``image_drop_rate=0.5`` the
key's four draws hit solver index 0 (the alpha-bar[0] case) and 1, and both
drop branches. The same weights go into the port through its ``convert.py``
(every leaf random, ``lora_b`` included), the JAX step's own ``jax.random``
draws are fed to the port, and loss, each loss term, ``grad_norm``, every
trainable gradient by name, the parameters after two AdamW updates, the
DINOLoss center (the second step runs with the folded one) and the strip are
compared. Also here: the LoRA export, the scheduler numerics, DINOLoss and
``preprocess_dinov2`` in bf16 against their JAX twins, and the config fields
that are not ported.
"""

from __future__ import annotations

import dataclasses
import types

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
from instantir_tpu.models.dinov2 import preprocess_dinov2 as j_preprocess
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.schedulers import diffusion as jsched
from instantir_tpu.train import common as jcommon
from instantir_tpu.train import previewer_lora as jprev
from instantir_tpu_torch import convert
from instantir_tpu_torch.losses import DINOLoss, DiffusionLossInputs, LCMVisualization, build_losses
from instantir_tpu_torch.losses.loss_config import LossesConfig, SingleLossConfig
from instantir_tpu_torch.models.dinov2 import DINOV2_MEAN, DINOV2_STD, preprocess_dinov2, tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.schedulers import diffusion as tsched
from instantir_tpu_torch.train.previewer_lora import (
    PreviewerConfig,
    PreviewerDraws,
    PreviewerTrainer,
    lora_trainable_pred,
)

RES, LATENT, BATCH = 32, 16, 2
LR = 1e-3
STEP_CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=LR, lr_scheduler="cosine", lr_warmup_steps=0,
                max_train_steps=10, num_ddim_timesteps=2, image_drop_rate=0.5, output_dir="")
LOSSES = [dict(name="HuberLoss", weight=1.0, init_params={"huber_c": 0.001}),
          dict(name="DINOLoss", weight=1e-3),
          dict(name="LCMVisualization", weight=1.0, visualize_every_k=1)]
MODELS = ("unet", "resampler")
KEY_SEED = 18  # the four draws: solver index 1, 0, 1, 0; drop uniforms 0.48, 0.64, 0.66, 0.08
# XLA's CPU backend at its lowest optimisation level for the JAX step's one compile, which bounds this file
# (as tests/test_torch_port_adam8bit.py compiles its steps)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


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


def _port_models(params, dcfg):
    """The port's tiny models on the CPU carrying the JAX parameter trees."""
    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cpu")
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    return pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder


def _build_port(params, dcfg, **step_cfg):
    cfg = PreviewerConfig(**{**STEP_CFG, **step_cfg})
    losses = LossesConfig(lcm_losses=[SingleLossConfig(**c) for c in LOSSES])
    return PreviewerTrainer(*_port_models(params, dcfg), cfg, losses, device="cpu")


def _jax_draws(key):
    """The draws of the JAX step's ``loss_fn`` for ``key`` (its key schedule)."""
    k_i, k_noise, k_w, k_drop, k_vae = jax.random.split(key, 5)
    shape = (BATCH, LATENT, LATENT, 4)
    return PreviewerDraws(
        solver_index=torch.from_numpy(np.array(jax.random.randint(k_i, (BATCH,), 0, STEP_CFG["num_ddim_timesteps"]))),
        noise=_t(jax.random.normal(k_noise, shape)),
        w_uniform=_t(jax.random.uniform(k_w, (BATCH, 1, 1, 1))).reshape(BATCH),
        drop_uniform=_t(jax.random.uniform(k_drop, (BATCH, 1, 1))).reshape(BATCH),
        vae_noise=_t(jax.random.normal(k_vae, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def setup():
    ucfg = j_unet_cfg(with_ip=True, lora_rank=4)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    unet, vae, res, dino = JUNet(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "vae": _init_random(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    rng = np.random.default_rng(61)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    lq = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1)),
            "uncond_prompt_embeds": (0.1 * rng.standard_normal((BATCH, 7, 32))).astype(np.float32)}
    return dict(models=(unet, res, vae, dino), params=params, dcfg=dcfg, lq=lq, gt=gt, cond=cond)


@pytest.fixture(scope="module")
def two_steps(setup):
    """Two previewer updates on each side. The JAX step is compiled once (at
    ``FAST``), with a gradient transformation that hands the raw gradients
    back in place of the optimiser state; AdamW and the center's momentum
    fold (``PreviewerTrainer.train_step``'s) are then applied outside that
    program."""
    unet, res, vae, dino = setup["models"]
    jcfg = jprev.PreviewerConfig(**STEP_CFG)
    losses = j_build_losses([JSingle(**c) for c in LOSSES])
    raw_step = jprev.build_previewer_step(unet, res, vae, dino, jsched.sdxl_schedule(), losses, jcfg)
    capture = optax.GradientTransformation(
        init=lambda p: (),
        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step_fn = jax.jit(lambda tr, fr, batch, key, center: raw_step(tr, fr, (), capture, batch, key, center))

    trainer = _build_port(setup["params"], setup["dcfg"])
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    frozen_before = {n: p.detach().clone() for n, p in trainer.named_parameters().items() if not p.requires_grad}
    lora_before = trainer.lora_state()
    juncond = np.asarray(dino.apply(setup["params"]["image_encoder"], np.zeros((1, 224, 224, 3), np.float32)))
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": juncond, **setup["cond"]}

    trainable, frozen = jcommon.partition_params(setup["params"], jprev.lora_trainable_pred)
    tx = jcommon.make_adamw(jcommon.lr_schedule(jcfg.lr_scheduler, jcfg.learning_rate, jcfg.lr_warmup_steps,
                                                jcfg.max_train_steps),
                            weight_decay=jcfg.weight_decay, max_grad_norm=jcfg.max_grad_norm)
    opt_state = tx.init(trainable)
    apply = jax.jit(lambda g, s, p: tx.update(g, s, p))
    center = jnp.zeros((setup["dcfg"].hidden_size,), jnp.float32)
    key = jax.random.PRNGKey(KEY_SEED)
    out = []
    step = None
    for _ in range(2):
        key, k_step = jax.random.split(key)
        if step is None:
            step = step_fn.lower(trainable, frozen, jbatch, k_step, center).compile(compiler_options=FAST)
        _, grads, jmetrics, new_center = step(trainable, frozen, jbatch, k_step, center)
        updates, opt_state = apply(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        center = center * 0.9 + new_center * 0.1
        strip = np.asarray(jmetrics.pop("_vis_strip"))

        draws = _jax_draws(k_step)
        loss, _, tgrads = trainer.loss_and_grads(batch, draws)
        tmetrics = trainer.train_step(batch, draws)
        out.append(dict(jgrads=grads, jmetrics={k: float(v) for k, v in jmetrics.items()},
                        tgrads=dict(zip(trainer.trainable_names, tgrads)), tloss=float(loss),
                        tmetrics={k: float(v) for k, v in tmetrics.items()}, jparams=trainable,
                        jcenter=np.asarray(center), tcenter=trainer.dino_center.clone(), jstrip=strip,
                        tstrip=trainer.last_vis_strip, draws=draws))
    return dict(steps=out, trainer=trainer, frozen_before=frozen_before, lora_before=lora_before,
                jfrozen=frozen)


def _named(setup, flat):
    """A flat ``{path tuple: leaf}`` dict of JAX leaves of the UNet and the
    Resampler -> the port's names, through ``convert.export_named`` (the
    leaves not given are zero)."""
    full = jax.tree_util.tree_map(np.zeros_like, {k: setup["params"][k] for k in MODELS})
    for model, tree in unflatten_dict({k: np.asarray(v) for k, v in flat.items()}).items():
        def merge(dst, src):
            for key, val in src.items():
                if isinstance(val, dict):
                    merge(dst[key], val)
                else:
                    dst[key] = val
        merge(full[model], tree)
    return convert.export_named(full)


def test_draws_cover_solver_index_0_and_both_drop_branches(two_steps):
    idx = np.concatenate([s["draws"].solver_index.numpy() for s in two_steps["steps"]])
    drop = np.concatenate([s["draws"].drop_uniform.numpy() for s in two_steps["steps"]])
    assert set(idx.tolist()) == {0, 1}, idx
    assert (drop < STEP_CFG["image_drop_rate"]).any() and (drop >= STEP_CFG["image_drop_rate"]).any(), drop
    # each solver index with each drop branch
    pairs = {(int(i), bool(d < STEP_CFG["image_drop_rate"])) for i, d in zip(idx, drop)}
    assert len(pairs) == 4, pairs


def test_trainable_leaves_match_jax_partition(setup, two_steps):
    trainer = two_steps["trainer"]
    trainable, _ = jcommon.partition_params(setup["params"], jprev.lora_trainable_pred)
    want = {n for n, v in _named(setup, {k: np.ones_like(v) for k, v in trainable.items() if k[0] in MODELS}).items()
            if v.any()}
    assert set(trainer.trainable_names) == want
    assert not any(k[0] not in MODELS for k in trainable)  # no LoRA outside the UNet and the Resampler
    assert any(n.startswith("resampler.") for n in want) and any("to_k_ip.lora_A" in n for n in want)
    assert any("ln_k_ip" in n and "lora_B" in n for n in want)  # the ip projections' AdaLN LoRA
    assert lora_trainable_pred(("unet", "conv_in", "lora_A", "weight"))
    assert not lora_trainable_pred(("unet", "conv_in", "weight"))


def test_previewer_losses_and_grad_norm_match_jax(two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want, got = s["jmetrics"], s["tmetrics"]
        assert set(got) == set(want), (set(got), set(want))
        # fp32 on both sides: 1e-5 relative is a few ulps of the reductions. DINOLoss gets 1e-4: the teacher
        # temperature 0.04 multiplies token differences by 25 before the softmax, and its tokens pass a VAE
        # decode and a DINOv2 forward on each side
        for name, got_v, tol in (("loss", s["tloss"], 1e-5), ("HuberLoss", got["HuberLoss"], 1e-5),
                                 ("DINOLoss", got["DINOLoss"], 1e-4)):
            assert abs(got_v - want[name]) <= tol * abs(want[name]), (i, name, got_v, want[name])
        assert got["LCMVisualization"] == want["LCMVisualization"] == 0.0
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-3 * want["grad_norm"], i


def test_previewer_gradients_match_jax_by_name(setup, two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = _named(setup, {k: v for k, v in s["jgrads"].items() if k[0] in MODELS})
        assert set(s["tgrads"]) <= set(want)
        for name, got in s["tgrads"].items():
            ref = want[name]
            assert tuple(got.shape) == ref.shape, name
            bound = 1e-5 + 1e-3 * np.abs(ref).max()  # atol 1e-5 + rtol 1e-3 of the leaf's largest value
            err = np.abs(got.numpy() - ref).max()
            assert err <= bound, (i, name, err, bound)
        assert any(np.abs(want[n]).max() > 0 for n in s["tgrads"] if n.startswith("resampler."))


def test_previewer_parameters_after_two_updates_match_jax(setup, two_steps):
    """Every element within a tenth of the two updates' reach 2·lr, as stages
    1 and 2 hold them; every LoRA leaf moved."""
    trainer = two_steps["trainer"]
    want = _named(setup, {k: v for k, v in two_steps["steps"][-1]["jparams"].items() if k[0] in MODELS})
    start = convert.export_named({k: setup["params"][k] for k in MODELS})
    named = trainer.named_parameters()
    for name in trainer.trainable_names:
        got = named[name].detach().numpy()
        assert np.abs(got - start[name]).max() > 1e-4, f"{name} did not move"
        assert np.abs(got - want[name]).max() <= 0.1 * 2 * LR, name
    assert trainer.global_step == 2 and trainer.optimizer.count == 2


def test_previewer_frozen_leaves_bit_equal(two_steps):
    named = two_steps["trainer"].named_parameters()
    assert len(two_steps["frozen_before"]) > 100
    for name, before in two_steps["frozen_before"].items():
        assert torch.equal(named[name], before), name
        assert named[name].grad is None


def test_dino_center_folds_as_jax(two_steps):
    """The center after each step (fp32 ``[hidden_size]``, zeros at start):
    the second step's DINOLoss ran against the first fold. 1e-5 of the
    largest element: the teacher tokens pass a VAE decode and a DINOv2
    forward on each side."""
    for i, s in enumerate(two_steps["steps"]):
        got, want = s["tcenter"].numpy(), s["jcenter"]
        assert got.dtype == np.float32 and got.shape == want.shape == (16,)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), i
        assert np.abs(want).max() > 0


def test_vis_strip_matches_jax(two_steps):
    """``[lq | gt | decoded prediction]`` along the width, NHWC, each step's
    kept (``visualize_every_k=1``)."""
    for i, s in enumerate(two_steps["steps"]):
        got, want = s["tstrip"].numpy(), s["jstrip"]
        assert got.shape == want.shape == (BATCH, RES, 3 * RES, 3)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), i
        assert "_vis_strip" not in s["tmetrics"]


def test_export_lora_matches_jax_export(setup, two_steps, tmp_path):
    """``export_lora``: the UNet's LoRA leaves under ``unet.<name>``, fp32 on
    the CPU, equal to the JAX trainer's export of the same parameters (the
    Resampler's LoRA left out on both sides); after training, the trained
    values."""
    path = tmp_path / "jax_lora.bin"
    jstate = types.SimpleNamespace(trainable=jcommon.partition_params(setup["params"], jprev.lora_trainable_pred)[0],
                                   frozen=jcommon.partition_params(setup["params"], jprev.lora_trainable_pred)[1])
    jprev.PreviewerTrainer.export_lora(jstate, str(path))
    want = torch.load(path, weights_only=True)
    got = two_steps["lora_before"]
    assert set(got) == set(want) and len(got) > 10
    assert all(k.startswith("unet.") and ("lora_A" in k or "lora_B" in k) for k in got)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        assert torch.equal(v, want[k].float()), k
    trainer = two_steps["trainer"]
    out = tmp_path / "previewer_lora_weights.bin"
    trainer.export_lora(str(out))
    saved = torch.load(out, weights_only=True)
    named = trainer.named_parameters()
    assert set(saved) == set(want)
    for k, v in saved.items():
        assert torch.equal(v, named[k].detach()), k


def test_previewer_default_loss_is_huber(setup):
    trainer = PreviewerTrainer(*_port_models(setup["params"], setup["dcfg"]), PreviewerConfig(**STEP_CFG),
                               device="cpu")
    (loss, weight), = trainer.losses
    assert type(loss).__name__ == "HuberLoss" and loss.huber_c == 0.001 and weight == 1.0
    assert trainer._dino is None and trainer._vis is None
    draws = PreviewerDraws(solver_index=torch.tensor([0, 1]))
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    metrics = trainer.train_step(batch, draws)
    assert set(metrics) == {"HuberLoss", "loss", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert trainer.last_vis_strip is None and not trainer.dino_center.any()


def test_cuda_trainer_raises_without_a_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PreviewerTrainer(*_port_models(setup["params"], setup["dcfg"]), PreviewerConfig(**STEP_CFG))


def test_no_lora_raises(setup):
    pipe = build_pipeline(tiny_unet_config(with_ip=True), tiny_vae_config(), tiny_resampler_config(output_dim=32),
                          tiny_dinov2_config(), device="cpu")
    with pytest.raises(ValueError, match="no LoRA"):
        PreviewerTrainer(pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder, PreviewerConfig(**STEP_CFG),
                         device="cpu")


@pytest.mark.parametrize("field,value", [("use_8bit_adam", True), ("quantize_frozen_unet", True),
                                         ("validation_steps", 100)])
def test_unported_config_fields_raise(setup, monkeypatch, field, value):
    """The fields the JAX trainer has and the port once refused now build a
    trainer that honours them: the 8-bit AdamW, the W8 frozen UNet (at a
    lowered threshold, the tiny weights being under the default), validation."""
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.train.adam8bit import AdamW8bit

    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", 1)
    trainer = _build_port(setup["params"], setup["dcfg"], **{field: value})
    assert getattr(trainer.cfg, field) == value
    assert isinstance(trainer.optimizer, AdamW8bit) == (field == "use_8bit_adam")
    assert (quant.quant_mode(trainer.unet) == "w8") == (field == "quantize_frozen_unet")


def test_jax_and_port_configs_have_the_same_fields():
    want = {f.name: f.default for f in dataclasses.fields(jprev.PreviewerConfig)}
    got = {f.name: f.default for f in dataclasses.fields(PreviewerConfig)}
    assert got == want


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _feature_pair(seed):
    """A fixed feature map (images [B, 8, 8, 3] -> tokens [B, 4, 6]) in both
    frameworks, and two images."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((48, 24)).astype(np.float32) * 0.3
    pred, target = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))

    def jfeat(img):
        return (img.reshape(img.shape[0], 4, 48) @ w).reshape(img.shape[0], 16, 6)

    def tfeat(img):
        return (img.reshape(img.shape[0], 4, 48) @ _t(w)).reshape(img.shape[0], 16, 6)

    return jfeat, tfeat, pred, target


@pytest.mark.parametrize("center_kind", ["zero", "vector"])
def test_dino_loss_apply_with_center_matches_jax(center_kind):
    jfeat, tfeat, pred, target = _feature_pair(70)
    center = np.zeros(6, np.float32) if center_kind == "zero" else np.linspace(-0.3, 0.4, 6).astype(np.float32)
    zeros = np.zeros((2, 4), np.float32)
    (jl, _), = j_build_losses([JSingle(name="DINOLoss")])
    (tl, _), = build_losses([SingleLossConfig(name="DINOLoss")])
    assert tl.needs_images and (tl.student_temp, tl.teacher_temp, tl.center_momentum) == (0.1, 0.04, 0.9)
    jloss, jmean = jl.apply_with_center(JInputs(predicted=zeros, target=zeros, pred_image=pred, target_image=target),
                                        jfeat, center)
    tpred = _t(pred).requires_grad_()
    tloss, tmean = tl.apply_with_center(
        DiffusionLossInputs(predicted=_t(zeros), target=_t(zeros), pred_image=tpred, target_image=_t(target)),
        tfeat, _t(center))
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=0, atol=1e-6)
    # the gradient reaches the student image only
    jgrad = jax.grad(lambda p: jl.apply_with_center(
        JInputs(predicted=zeros, target=zeros, pred_image=p, target_image=target), jfeat, center)[0])(pred)
    (tgrad,) = torch.autograd.grad(tloss, tpred)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5 * np.abs(jgrad).max())


def test_dino_loss_call_and_center_fold_match_jax():
    jfeat, tfeat, pred, target = _feature_pair(71)
    zeros = np.zeros((2, 4), np.float32)
    (jl, _), = j_build_losses([JSingle(name="DINOLoss", init_params={"center_momentum": 0.5})], feature_fn=jfeat)
    (tl, _), = build_losses([SingleLossConfig(name="DINOLoss", init_params={"center_momentum": 0.5})],
                            feature_fn=tfeat)
    assert tl.feature_fn is tfeat
    for images in ((pred, target), (target, pred)):
        jv = jl(JInputs(predicted=zeros, target=zeros, pred_image=images[0], target_image=images[1]))
        tv = tl(DiffusionLossInputs(predicted=_t(zeros), target=_t(zeros), pred_image=_t(images[0]),
                                    target_image=_t(images[1])))
        assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
        jl.update_center()
        tl.update_center()
        np.testing.assert_allclose(tl.center.numpy(), np.asarray(jl.center), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="feature_fn"):
        build_losses([SingleLossConfig(name="DINOLoss")])[0][0](DiffusionLossInputs(predicted=_t(zeros),
                                                                                    target=_t(zeros)))


def test_lcm_visualization_contributes_zero():
    (loss, weight), = build_losses([SingleLossConfig(name="LCMVisualization", weight=2.0, visualize_every_k=5)])
    assert isinstance(loss, LCMVisualization) and loss.needs_images and loss.visualize_every_k == 5 and weight == 2.0
    val = loss(DiffusionLossInputs(predicted=torch.ones(2, 3), target=torch.zeros(2, 3)))
    assert val.dtype == torch.float32 and val.shape == () and float(val) == 0.0
    assert isinstance(build_losses([SingleLossConfig(name="DINOLoss")])[0][0], DINOLoss)


# --------------------------------------------------------------------------
# scheduler numerics
# --------------------------------------------------------------------------


SCHEDULES = [dict(), dict(beta_schedule="linear", beta_start=1e-4, beta_end=2e-2),
             dict(beta_schedule="squaredcos_cap_v2"), dict(rescale_betas_zero_snr=True),
             dict(beta_schedule="squaredcos_cap_v2", rescale_betas_zero_snr=True, set_alpha_to_one=False),
             dict(trained_betas=np.linspace(1e-4, 3e-2, 1000))]


@pytest.mark.parametrize("kwargs", SCHEDULES, ids=["sdxl", "linear", "cosine", "zero_snr", "cosine_zero_snr",
                                                   "trained"])
def test_make_schedule_matches_jax(kwargs):
    want = jsched.make_schedule(**kwargs)
    got = tsched.make_schedule(**kwargs)
    np.testing.assert_array_equal(got.betas.numpy(), np.asarray(want.betas))
    np.testing.assert_array_equal(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod))
    assert got.final_alpha_cumprod == float(want.final_alpha_cumprod)
    if kwargs.get("rescale_betas_zero_snr"):
        assert got.alphas_cumprod[-1] == 0.0


def test_unknown_beta_schedule_raises():
    with pytest.raises(NotImplementedError, match="beta_schedule"):
        tsched.make_schedule(beta_schedule="sigmoid")


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_velocity_eps_and_ddim_step_match_jax(prediction_type):
    rng = np.random.default_rng(72)
    x0, noise, sample, out = (rng.standard_normal((4, 3, 5, 2)).astype(np.float32) for _ in range(4))
    t = np.array([0, 17, 500, 999])
    prev_t = np.array([-1, 0, 480, 979])  # -1: final_alpha_cumprod
    js = jsched.make_schedule(prediction_type=prediction_type, set_alpha_to_one=False)
    ts = tsched.make_schedule(prediction_type=prediction_type, set_alpha_to_one=False)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    close(tsched.get_velocity(ts, _t(x0), _t(noise), torch.from_numpy(t)), jsched.get_velocity(js, x0, noise, t))
    close(tsched.pred_eps_from_x0(ts, _t(sample), _t(x0), torch.from_numpy(t)),
          jsched.pred_eps_from_x0(js, sample, x0, t))
    got = tsched.ddim_step(ts, _t(out), torch.from_numpy(t), torch.from_numpy(prev_t), _t(sample))
    want = jsched.ddim_step(js, out, t, prev_t, sample)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("n,original,strength", [(1, 50, 1.0), (4, 50, 1.0), (8, 50, 0.5), (50, 50, 1.0),
                                                 (3, 20, 0.8)])
def test_lcm_inference_timesteps_match_jax(n, original, strength):
    got = tsched.lcm_inference_timesteps(n, 1000, original, strength)
    want = jsched.lcm_inference_timesteps(n, 1000, original, strength)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


def test_lcm_inference_timesteps_too_many_steps_raise():
    with pytest.raises(ValueError, match="exceeds"):
        tsched.lcm_inference_timesteps(26, 1000, 50, 0.5)


@pytest.mark.parametrize("steps", [1, 2, 50, 64])
def test_ddim_solver_timesteps_match_jax(steps):
    got = tsched.ddim_solver_timesteps(1000, steps)
    np.testing.assert_array_equal(got, jsched.ddim_solver_timesteps(1000, steps))
    assert got.dtype == np.int64 and (np.diff(got) > 0).all()


# --------------------------------------------------------------------------
# preprocess_dinov2 in bf16
# --------------------------------------------------------------------------


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


@pytest.mark.parametrize("hw", [(40, 36), (224, 224)])
def test_preprocess_dinov2_bf16_matches_jax(hw):
    """A bf16 input stays bf16 (the resize is summed in fp32, then rounded)
    and agrees with ``jax.image.resize``'s bf16 output within the roundings
    the two take apart. JAX rounds its weights to bf16 (half an ulp of the
    resized value x per axis) and its first contraction (half an ulp); with
    each side's final rounding, x may differ by 2.5 bf16 ulps. The bf16
    subtraction of the mean then adds up to an ulp of max(x, mean), the
    division by the std (which carries both through 1/std) an ulp of the
    result."""
    rng = np.random.default_rng(73)
    images = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jin = jnp.asarray(images, jnp.bfloat16)
    want = np.asarray(j_preprocess(jin, size=28).astype(jnp.float32))
    got = preprocess_dinov2(torch.from_numpy(np.array(jin.astype(jnp.float32))).bfloat16(), size=28)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 28, 28, 3)
    got = got.float().numpy()
    mean, std = np.array(DINOV2_MEAN), np.array(DINOV2_STD)
    resized = np.abs(want * std + mean)
    bound = 3.5 * _bf16_ulp(np.maximum(resized, mean)) / std + _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= bound).all(), (np.abs(got - want) / bound).max()
