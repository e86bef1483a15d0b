"""CPU parity of the PyTorch port's stage-2 (Aggregator) trainer with the JAX trainer.

One tiny stage-2 step (the ``tests/test_torch_port_pipeline.py`` configs, 32²
images, batch 2, DINOv2 at its own ``image_size`` 28 fed 224² pixels) is
compiled once on the JAX side with ``cfg_scale=2``, ``optimize_adapter``,
``importance_sampling`` and an EMA update every step, so that one program
covers every branch. The same weights go into the port through its
``convert.py`` (every leaf random, the zero convs and ``lora_b`` included),
the JAX step's own ``jax.random`` draws are fed to the port, and loss,
``preview_error_latent``, every trainable gradient by name, ``grad_norm``,
the parameters after two AdamW updates and the EMA adapter after them are
compared. The EMA decay is 0.5 so that the second step's previewer runs with
an adapter the first update moved. The port-only tests cover the Aggregator's
gradient checkpointing, the config fields ported since the first slice and
the EMA helpers.
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
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu.train import common as jcommon
from instantir_tpu.train import stage2_aggregator as jstage2
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.train import common as tcommon
from instantir_tpu_torch.train.stage2_aggregator import (
    ADAPTER_EMA_PRED,
    Stage2Config,
    Stage2Draws,
    Stage2Trainer,
    stage2_trainable_pred,
)

RES, LATENT, BATCH = 32, 16, 2
LR = 1e-3
STEP_CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=LR, lr_scheduler="cosine", lr_warmup_steps=0,
                max_train_steps=10, image_drop_rate=0.3, text_drop_rate=0.3, cond_drop_rate=0.3, cfg_scale=2.0,
                optimize_adapter=True, ema_decay=0.5, ema_update_steps=1, importance_sampling=True, output_dir="")
MODELS = ("unet", "aggregator", "resampler")


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


def _build_port(params, dcfg, **step_cfg):
    """A port trainer on the CPU carrying the JAX parameter trees."""
    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cpu")
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    pipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    cfg = Stage2Config(**{**STEP_CFG, **step_cfg})
    return Stage2Trainer(pipe.unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cpu")


def _jax_draws(key):
    """The draws of the JAX step's ``loss_fn`` for ``key`` (its key schedule)."""
    k_t, k_noise, k_drop, k_w, k_vae1, k_vae2 = jax.random.split(key, 6)
    shape = (BATCH, LATENT, LATENT, 4)
    return Stage2Draws(
        timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (BATCH,), 0, 1000))),
        noise=_t(jax.random.normal(k_noise, shape)),
        drop_uniform=_t(jax.random.uniform(k_drop, (BATCH,))),
        cfg_uniform=_t(jax.random.uniform(k_w, (BATCH, 1, 1, 1))).reshape(BATCH),
        vae_noise_gt=_t(jax.random.normal(k_vae1, shape, dtype=jnp.float32)),
        vae_noise_lq=_t(jax.random.normal(k_vae2, shape, dtype=jnp.float32)))


@pytest.fixture(scope="module")
def setup():
    ucfg = j_unet_cfg(with_ip=True, lora_rank=4)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    unet, agg, vae, res, dino = JUNet(ucfg), JAggregator(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    rng = np.random.default_rng(41)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    lq = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1)),
            "uncond_prompt_embeds": (0.1 * rng.standard_normal((BATCH, 7, 32))).astype(np.float32),
            "uncond_pooled_embeds": (0.1 * rng.standard_normal((BATCH, 16))).astype(np.float32)}
    return dict(models=(unet, agg, res, vae, dino), params=params, dcfg=dcfg, lq=lq, gt=gt, cond=cond)


@pytest.fixture(scope="module")
def two_steps(setup):
    """Two stage-2 updates on each side. The JAX step is compiled once, with a
    gradient transformation that hands the raw gradients back in place of the
    optimiser state; AdamW and the EMA update (``Stage2Trainer.train_step``'s)
    are then applied outside that program."""
    unet, agg, res, vae, dino = setup["models"]
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    losses = j_build_losses([JSingle(name="L2Loss")])
    raw_step = jstage2.build_stage2_step(unet, agg, res, vae, dino, j_sdxl_schedule(), losses, jcfg)
    capture = optax.GradientTransformation(
        init=lambda p: (),
        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step = jax.jit(lambda tr, fr, ema, batch, key: raw_step(tr, fr, ema, (), capture, batch, key))

    trainer = _build_port(setup["params"], setup["dcfg"])
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    frozen_before = {n: p.detach().clone() for n, p in trainer.named_parameters().items() if not p.requires_grad}
    ema_before = {n: t.clone() for n, t in trainer.ema_adapter.items()}
    juncond = np.asarray(dino.apply(setup["params"]["image_encoder"], np.zeros((1, 224, 224, 3), np.float32)))
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": juncond, **setup["cond"]}

    trainable, frozen = jcommon.partition_params(setup["params"], jstage2.stage2_trainable_pred(jcfg))
    ema, _ = jcommon.partition_params(setup["params"], jstage2.ADAPTER_EMA_PRED)
    tx = jcommon.make_adamw(jcommon.lr_schedule(jcfg.lr_scheduler, jcfg.learning_rate, jcfg.lr_warmup_steps,
                                                jcfg.max_train_steps),
                            weight_decay=jcfg.weight_decay, max_grad_norm=jcfg.max_grad_norm)
    opt_state = tx.init(trainable)
    apply = jax.jit(lambda g, s, p: tx.update(g, s, p))
    key = jax.random.PRNGKey(32)  # its four drop uniforms fall into all four branches
    out = []
    for _ in range(2):
        key, k_step = jax.random.split(key)
        _, grads, jmetrics = step(trainable, frozen, ema, jbatch, k_step)
        updates, opt_state = apply(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        live = jcommon.partition_params(jcommon.merge_params(trainable, frozen), jstage2.ADAPTER_EMA_PRED)[0]
        ema = jcommon.ema_update(ema, live, jcfg.ema_decay)

        draws = _jax_draws(k_step)
        loss, _, tgrads = trainer.loss_and_grads(batch, draws)
        tmetrics = trainer.train_step(batch, draws)
        out.append(dict(jgrads=grads, jmetrics={k: float(v) for k, v in jmetrics.items()},
                        tgrads=dict(zip(trainer.trainable_names, tgrads)), tloss=float(loss),
                        tmetrics={k: float(v) for k, v in tmetrics.items()}, jparams=trainable, jema=ema,
                        drop_uniform=draws.drop_uniform.numpy()))
    return dict(steps=out, trainer=trainer, batch=batch, juncond=juncond, frozen_before=frozen_before,
                ema_before=ema_before, frozen_tree=frozen)


def _named(setup, flat):
    """A flat ``{path tuple: leaf}`` dict of JAX leaves of the UNet, Aggregator
    and Resampler -> the port's names, through ``convert.export_named`` (the
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


def test_draws_cover_every_drop_branch(two_steps):
    """The four drop uniforms fall into every branch
    (image / text / both / none at rates 0.3 / 0.3 / 0.3 / 0.1)."""
    r = np.concatenate([s["drop_uniform"] for s in two_steps["steps"]])
    branches = {int(min(x // 0.3, 3)) for x in r}
    assert branches == {0, 1, 2, 3}, r


def test_uncond_tokens_at_224_match_jax(two_steps):
    """DINOv2 at its native 28² grid fed a 224² zero image (bicubic position
    embeddings) gives the JAX encoder's tokens."""
    got = two_steps["batch"]["uncond_tokens"].numpy()
    want = two_steps["juncond"]
    assert got.shape == want.shape == (1, 257, 16)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_trainable_and_ema_leaves_match_jax_partition(setup, two_steps):
    trainer = two_steps["trainer"]
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    trainable, _ = jcommon.partition_params(setup["params"], jstage2.stage2_trainable_pred(jcfg))
    want = {n for n, v in _named(setup, {k: np.ones_like(v) for k, v in trainable.items()}).items() if v.any()}
    assert set(trainer.trainable_names) == want
    assert any(n.startswith("aggregator.") for n in want) and any(n.startswith("unet.") for n in want)
    ema, _ = jcommon.partition_params(setup["params"], jstage2.ADAPTER_EMA_PRED)
    want_ema = {n for n, v in _named(setup, {k: np.ones_like(v) for k, v in ema.items()}).items() if v.any()}
    assert set(trainer.ema_adapter) == want_ema
    assert all(t.dtype == torch.float32 for t in trainer.ema_adapter.values())
    off = stage2_trainable_pred(Stage2Config(**{**STEP_CFG, "optimize_adapter": False}))
    assert off(("aggregator", "conv_in", "weight")) and not off(("resampler", "latents"))
    assert ADAPTER_EMA_PRED(("resampler", "latents")) and not ADAPTER_EMA_PRED(("aggregator", "conv_in", "weight"))


def test_stage2_loss_preview_error_and_grad_norm_match_jax(two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = s["jmetrics"]
        # fp32 on both sides: 1e-5 relative is a few ulps of the reductions
        for name, got in (("loss", s["tloss"]), ("L2Loss", s["tmetrics"]["L2Loss"]),
                          ("preview_error_latent", s["tmetrics"]["preview_error_latent"])):
            assert abs(got - want[name]) <= 1e-5 * abs(want[name]), (i, name, got, want[name])
        assert abs(s["tmetrics"]["grad_norm"] - want["grad_norm"]) <= 1e-3 * want["grad_norm"], i


def test_stage2_gradients_match_jax_by_name(setup, two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = _named(setup, s["jgrads"])
        assert set(s["tgrads"]) <= set(want)
        for name, got in s["tgrads"].items():
            ref = want[name]
            assert tuple(got.shape) == ref.shape, name
            bound = 1e-5 + 1e-3 * np.abs(ref).max()  # atol 1e-5 + rtol 1e-3 of the leaf's largest value
            err = np.abs(got.numpy() - ref).max()
            assert err <= bound, (i, name, err, bound)
        frozen = [n for n in want if n not in s["tgrads"]]
        assert all(not want[n].any() for n in frozen)  # the JAX step gave the frozen leaves no gradient either


def test_stage2_parameters_and_ema_after_two_updates_match_jax(setup, two_steps):
    """Every element within a tenth of the two updates' reach 2·lr, as stage 1
    holds them (``test_torch_port_train.py``); elements whose JAX gradient is
    above 1e-2 of its leaf's largest in both steps (75% of them) within 2e-6
    (measured 1.0e-6). Stage 1 draws that line at 1e-4: here the second
    step's gradients pass through the previewer the first update's EMA fed
    and through the Aggregator's residuals, and elements below 1e-2 of the
    largest carry up to a few percent of relative noise (about 4e-6 of the
    leaf's largest, inside the gradient tolerance), which AdamW's
    normalisation turns into up to 1.9e-5 where the two gradients nearly
    cancel. The EMA copy (decay 0.5) mixes the start and the two updates, so
    it is held to the same reach, and it has moved off its start."""
    trainer = two_steps["trainer"]
    last = two_steps["steps"][-1]
    want = _named(setup, last["jparams"])
    g1, g2 = (_named(setup, s["jgrads"]) for s in two_steps["steps"])
    named = trainer.named_parameters()
    start = convert.export_named({k: setup["params"][k] for k in MODELS})
    determined = []
    for name in trainer.trainable_names:
        got = named[name].detach().numpy()
        assert np.abs(got - start[name]).max() > 1e-4, f"{name} did not move"
        diff = np.abs(got - want[name])
        floor = 1e-2 * max(np.abs(g1[name]).max(), np.abs(g2[name]).max())
        mask = np.minimum(np.abs(g1[name]), np.abs(g2[name])) > floor
        determined.append(mask.mean())
        assert diff[mask].max(initial=0.0) <= 2e-6, name
        assert diff.max() <= 0.1 * 2 * LR, name
    assert np.mean(determined) > 0.7
    assert trainer.global_step == 2 and trainer.optimizer.count == 2
    want_ema = _named(setup, last["jema"])
    for name, got in trainer.ema_adapter.items():
        assert np.abs(got.numpy() - want_ema[name]).max() <= 0.1 * 2 * LR, name
        assert not torch.equal(got, two_steps["ema_before"][name]), f"EMA of {name} did not move"


def test_stage2_frozen_leaves_bit_equal(two_steps):
    named = two_steps["trainer"].named_parameters()
    assert len(two_steps["frozen_before"]) > 100
    for name, before in two_steps["frozen_before"].items():
        assert torch.equal(named[name], before), name
        assert named[name].grad is None


def test_aggregator_export_layout(setup, two_steps):
    trainer = two_steps["trainer"]
    state = trainer.aggregator_state()
    want = convert.export_aggregator(setup["params"]["aggregator"])
    assert set(state) == set(want)
    named = trainer.named_parameters()
    for k, v in state.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        assert torch.equal(v, named[f"aggregator.{k}"].detach()), k


# --------------------------------------------------------------------------
# port only
# --------------------------------------------------------------------------


def _draws(seed):
    g = torch.Generator().manual_seed(seed)
    shape = (BATCH, LATENT, LATENT, 4)
    return Stage2Draws(timesteps=torch.randint(0, 1000, (BATCH,), generator=g), noise=torch.randn(shape, generator=g),
                       drop_uniform=torch.rand(BATCH, generator=g), cfg_uniform=torch.rand(BATCH, generator=g),
                       vae_noise_gt=torch.randn(shape, generator=g), vae_noise_lq=torch.randn(shape, generator=g))


def test_aggregator_checkpointing_gives_the_same_gradients(setup, two_steps):
    trainer, batch = two_steps["trainer"], two_steps["batch"]
    loss, _, grads = trainer.loss_and_grads(batch, _draws(1))
    trainer.aggregator.gradient_checkpointing = True
    trainer.unet.gradient_checkpointing = True
    try:
        loss_c, _, grads_c = trainer.loss_and_grads(batch, _draws(1))
    finally:
        trainer.aggregator.gradient_checkpointing = False
        trainer.unet.gradient_checkpointing = False
    assert float(loss) == float(loss_c)
    for name, a, b in zip(trainer.trainable_names, grads, grads_c):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7, msg=name)


def test_bf16_models_run_the_previewer_on_the_fp32_ema(setup):
    """bf16 models (the card's dtype) with the fp32 EMA copy: the previewer
    takes each EMA tensor in its own parameter's dtype (LayerNorm32 keeps fp32
    weights in a bf16 model), the step runs, and the EMA stays fp32 and moves."""
    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(),
                          dtype=torch.bfloat16, device="cpu")
    trainer = Stage2Trainer(pipe.unet, pipe.aggregator, pipe.resampler, pipe.vae, pipe.image_encoder,
                            Stage2Config(**STEP_CFG), device="cpu")
    named = trainer.named_parameters()
    assert {named[n].dtype for n in trainer.ema_adapter} == {torch.bfloat16, torch.float32}
    before = {n: t.clone() for n, t in trainer.ema_adapter.items()}
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v).to(torch.bfloat16) for k, v in setup["cond"].items()})
    metrics = trainer.train_step(batch, _draws(4))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(t.dtype == torch.float32 for t in trainer.ema_adapter.values())
    assert any(not torch.equal(t, before[n]) for n, t in trainer.ema_adapter.items())


@pytest.mark.parametrize("field,value", [("use_8bit_adam", True), ("quantize_frozen_unet", True),
                                         ("aggregator_adapter", True), ("validation_steps", 100)])
def test_unported_config_fields_raise(setup, monkeypatch, field, value):
    """Every field is ported now. ``aggregator_adapter`` without the
    Aggregator's Resampler raises ``ValueError`` as the JAX trainer does
    (``tests/test_torch_port_aggregator_adapter.py`` trains with it); the
    other fields build a trainer that honours them (the W8 frozen UNet at a
    lowered threshold, its ip projections kept in fp)."""
    from instantir_tpu_torch.ops import quant
    from instantir_tpu_torch.train.adam8bit import AdamW8bit

    if field == "aggregator_adapter":
        cfg = dataclasses.replace(Stage2Config(**STEP_CFG), **{field: value})
        with pytest.raises(ValueError, match="agg_resampler"):
            Stage2Trainer(None, None, None, None, None, cfg, device="cpu")
        return
    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", 1)
    trainer = _build_port(setup["params"], setup["dcfg"], **{field: value})
    assert getattr(trainer.cfg, field) == value
    assert isinstance(trainer.optimizer, AdamW8bit) == (field == "use_8bit_adam")
    assert (quant.quant_mode(trainer.unet) == "w8") == (field == "quantize_frozen_unet")
    ip = [m for n, m in trainer.unet.named_modules() if n.endswith(("to_k_ip", "to_v_ip"))]
    assert ip and all(m.quant_mode is None for m in ip)


def test_jax_and_port_configs_have_the_same_fields():
    want = {f.name: f.default for f in dataclasses.fields(jstage2.Stage2Config)}
    got = {f.name: f.default for f in dataclasses.fields(Stage2Config)}
    assert got == want


def test_ema_helpers_match_jax():
    rng = np.random.default_rng(50)
    names = ("a", "b", "c")
    ema, new, donor = ({n: rng.standard_normal((3, 4)).astype(np.float32) for n in names} for _ in range(3))
    mask = {"a": True, "b": False, "c": True}

    def tt(d):
        return {n: _t(v) for n, v in d.items()}

    got = tt(ema)
    tcommon.ema_update(got, tt(new), 0.9)
    want = jcommon.ema_update(ema, new, 0.9)
    got_m = tt(ema)
    tcommon.masked_ema_update(got_m, tt(new), mask, 0.9)
    want_m = jcommon.masked_ema_update(ema, new, mask, 0.9)
    swapped = tcommon.swap_masked(tt(ema), tt(donor), mask)
    want_s = jcommon.swap_masked(ema, donor, mask)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(got_m[n].numpy(), np.asarray(want_m[n]), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(swapped[n].numpy(), np.asarray(want_s[n]))
