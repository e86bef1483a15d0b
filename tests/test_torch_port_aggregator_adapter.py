"""CPU parity of the port's stage-2 ``aggregator_adapter`` with the JAX trainer's.

One tiny stage-2 step with the adapter (the slim tiny UNet: one resnet and
one transformer layer a block; 32² images, batch 2; the Aggregator built with
``aggregator_adapter=True``; a tiny ``agg_resampler`` of four queries) is
compiled once on the JAX side. Every leaf of the JAX trees is drawn from a
numpy seed (the AdaLN linears of the ip branch, the zero convs and ``lora_b``
included) and carried into the port by ``convert.py``; the JAX step's own
``jax.random`` draws are fed to the port. Held to JAX: loss,
``preview_error_latent``, every trainable gradient by name (the Aggregator's
attn1 ip leaves and the ``agg_resampler``'s among them), ``grad_norm`` and
the parameters after two AdamW updates. Beside them: the structure
``enable_aggregator_adapter`` builds against the JAX function's, the trainer's
guards in both packages, the training CLI with ``--aggregator_adapter`` and
its resume (bitwise), and the validation render, which raises in both
packages (the restore calls the Aggregator without image tokens).
"""

from __future__ import annotations

import os
from pathlib import Path

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
from instantir_tpu_torch.cli import train as ct
from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import Resampler, tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.train import stage2_aggregator
from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer, enable_aggregator_adapter
from test_torch_port_stage2 import _init_random, _jax_draws, _t

REPO = Path(__file__).resolve().parents[1]
RES, LATENT, BATCH = 32, 16, 2
TOKENS = 4
LR = 1e-3
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
STEP_CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=LR, lr_scheduler="constant", lr_warmup_steps=0,
                max_train_steps=10, image_drop_rate=0.4, text_drop_rate=0.3, cond_drop_rate=0.2,
                aggregator_adapter=True, adapter_tokens=TOKENS, output_dir="")
MODELS = ("unet", "aggregator", "resampler", "agg_resampler")
# XLA's lowest CPU optimisation level: the step's compile bounds this file, and the level changes no fp32 result
# beyond the tolerances below
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _agg_res_cfg(dcfg, ucfg, tiny):
    return tiny(num_queries=TOKENS, embedding_dim=dcfg.hidden_size, output_dim=ucfg.cross_attention_dim)


@pytest.fixture(scope="module")
def setup():
    ucfg = j_unet_cfg(**SLIM)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    unet, agg = JUNet(ucfg), JAggregator(ucfg, aggregator_adapter=True)
    vae, res, dino = JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    agg_res = JResampler(_agg_res_cfg(dcfg, ucfg, j_res_cfg))
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    ip = np.zeros((1, TOKENS, 32), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids,
                                   ip_hidden_states=ip),
        "vae": _init_random(vae, 3, np.zeros((1, RES, RES, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
        "agg_resampler": _init_random(agg_res, 6, np.zeros((1, 5, dcfg.hidden_size), np.float32)),
    }
    rng = np.random.default_rng(41)
    gt = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    lq = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    cond = {"prompt_embeds": rng.standard_normal((BATCH, 7, 32)).astype(np.float32),
            "pooled_embeds": rng.standard_normal((BATCH, 16)).astype(np.float32),
            "time_ids": np.tile(np.array([[RES, RES, 0, 0, RES, RES]], np.float32), (BATCH, 1)),
            "uncond_prompt_embeds": (0.1 * rng.standard_normal((BATCH, 7, 32))).astype(np.float32),
            "uncond_pooled_embeds": (0.1 * rng.standard_normal((BATCH, 16))).astype(np.float32)}
    return dict(models=(unet, agg, res, vae, dino, agg_res), params=params, dcfg=dcfg, lq=lq, gt=gt, cond=cond)


def _port_trainer(params, dcfg, **step_cfg):
    """A port trainer on the CPU carrying the JAX trees: the adapter
    Aggregator and the tiny ``agg_resampler`` loaded strictly."""
    ucfg = tiny_unet_config(**SLIM)
    pipe = build_pipeline(ucfg, tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(), device="cpu")
    pipe.unet.load_state_dict(convert.to_torch(convert.export_unet(params["unet"])), strict=True)
    pipe.vae.load_state_dict(convert.to_torch(convert.export_vae(params["vae"])), strict=True)
    pipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(params["resampler"])), strict=True)
    pipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(params["image_encoder"], dcfg.num_layers)), strict=True)
    agg = Aggregator(ucfg, aggregator_adapter=True).requires_grad_(False)
    agg.load_state_dict(convert.to_torch(convert.export_aggregator(params["aggregator"])), strict=True)
    agg_res = Resampler(_agg_res_cfg(tiny_dinov2_config(), ucfg, tiny_resampler_config)).requires_grad_(False)
    agg_res.load_state_dict(convert.to_torch(convert.export_resampler(params["agg_resampler"])), strict=True)
    cfg = Stage2Config(**{**STEP_CFG, **step_cfg})
    return Stage2Trainer(pipe.unet, agg, pipe.resampler, pipe.vae, pipe.image_encoder, cfg, device="cpu",
                         agg_resampler=agg_res)


@pytest.fixture(scope="module")
def two_steps(setup):
    """Two stage-2 updates with the adapter on each side. The JAX step is
    compiled once, with a gradient transformation that hands the raw
    gradients back; AdamW is applied outside that program."""
    unet, agg, res, vae, dino, agg_res = setup["models"]
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    losses = j_build_losses([JSingle(name="L2Loss")])
    raw_step = jstage2.build_stage2_step(unet, agg, res, vae, dino, j_sdxl_schedule(), losses, jcfg,
                                         agg_resampler=agg_res)
    capture = optax.GradientTransformation(
        init=lambda p: (),
        update=lambda g, state, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    step_fn = jax.jit(lambda tr, fr, batch, key: raw_step(tr, fr, None, (), capture, batch, key))

    trainer = _port_trainer(setup["params"], setup["dcfg"])
    seen, loss_and_grads = [], trainer.loss_and_grads

    def recorded(*args, **kwargs):  # the gradients train_step applies
        seen.append(loss_and_grads(*args, **kwargs))
        return seen[-1]

    trainer.loss_and_grads = recorded
    batch = trainer.prepare_batch({"lq": _t(setup["lq"]), "gt": _t(setup["gt"])},
                                  {k: _t(v) for k, v in setup["cond"].items()})
    frozen_before = {n: p.detach().clone() for n, p in trainer.named_parameters().items() if not p.requires_grad}
    juncond = np.asarray(dino.apply(setup["params"]["image_encoder"], np.zeros((1, 224, 224, 3), np.float32)))
    jbatch = {"lq": setup["lq"], "gt": setup["gt"], "uncond_tokens": juncond, **setup["cond"]}

    trainable, frozen = jcommon.partition_params(setup["params"], jstage2.stage2_trainable_pred(jcfg))
    tx = jcommon.make_adamw(jcommon.lr_schedule(jcfg.lr_scheduler, jcfg.learning_rate, jcfg.lr_warmup_steps,
                                                jcfg.max_train_steps),
                            weight_decay=jcfg.weight_decay, max_grad_norm=jcfg.max_grad_norm)
    opt_state = tx.init(trainable)
    apply = jax.jit(lambda g, s, p: tx.update(g, s, p))
    key = jax.random.PRNGKey(0)  # its four drop uniforms include an image drop and a text drop
    step = step_fn.lower(trainable, frozen, jbatch, key).compile(compiler_options=FAST)
    out = []
    for _ in range(2):
        key, k_step = jax.random.split(key)
        _, grads, jmetrics = step(trainable, frozen, jbatch, k_step)
        updates, opt_state = apply(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        draws = _jax_draws(k_step)
        tmetrics = trainer.train_step(batch, draws)
        loss, _, tgrads = seen.pop()
        out.append(dict(jgrads=grads, jmetrics={k: float(v) for k, v in jmetrics.items()},
                        tgrads=dict(zip(trainer.trainable_names, tgrads)), tloss=float(loss),
                        tmetrics={k: float(v) for k, v in tmetrics.items()}, jparams=trainable,
                        drop_uniform=draws.drop_uniform.numpy()))
    return dict(steps=out, trainer=trainer, frozen_before=frozen_before, trainable_tree=trainable)


def _named(setup, flat):
    """A flat ``{path tuple: leaf}`` dict of JAX leaves of the trained models
    -> the port's names (``convert.export_named``; the leaves not given are zero)."""
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


def test_trainable_leaves_match_jax_partition(setup, two_steps):
    """The Aggregator (its attn1 ip branch included) and the agg_resampler
    train, nothing else (``optimize_adapter`` off); the drops of the two
    steps hit an image-dropped sample, whose agg tokens are the uncond ones."""
    trainer = two_steps["trainer"]
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    trainable, _ = jcommon.partition_params(setup["params"], jstage2.stage2_trainable_pred(jcfg))
    want = {n for n, v in _named(setup, {k: np.ones_like(v) for k, v in trainable.items()}).items() if v.any()}
    assert set(trainer.trainable_names) == want
    assert {n.split(".")[0] for n in want} == {"aggregator", "agg_resampler"}
    assert any(".attn1.processor.to_k_ip." in n for n in want) and any(".attn1.processor.ln_v_ip." in n for n in want)
    r = np.concatenate([s["drop_uniform"] for s in two_steps["steps"]])
    image, text = STEP_CFG["image_drop_rate"], STEP_CFG["text_drop_rate"]
    assert (r < image).any() and ((r >= image) & (r < image + text)).any()


def test_adapter_step_loss_and_preview_error_match_jax(two_steps):
    for i, s in enumerate(two_steps["steps"]):
        want = s["jmetrics"]
        # fp32 on both sides: 1e-5 relative is a few ulps of the reductions
        for name, got in (("loss", s["tloss"]), ("L2Loss", s["tmetrics"]["L2Loss"]),
                          ("preview_error_latent", s["tmetrics"]["preview_error_latent"])):
            assert abs(got - want[name]) <= 1e-5 * abs(want[name]), (i, name, got, want[name])
        assert abs(s["tmetrics"]["grad_norm"] - want["grad_norm"]) <= 1e-3 * want["grad_norm"], i


def test_adapter_step_gradients_match_jax_by_name(setup, two_steps):
    """atol 1e-5 + rtol 1e-3 of each leaf's largest value, the stage-2
    test's bound; the agg_resampler's and the ip branch's gradients are
    nonzero."""
    for i, s in enumerate(two_steps["steps"]):
        want = _named(setup, s["jgrads"])
        assert set(s["tgrads"]) <= set(want)
        for name, got in s["tgrads"].items():
            ref = want[name]
            assert tuple(got.shape) == ref.shape, name
            bound = 1e-5 + 1e-3 * np.abs(ref).max()
            err = np.abs(got.numpy() - ref).max()
            assert err <= bound, (i, name, err, bound)
        for part in ("agg_resampler.layers.0.0.to_kv.", ".attn1.processor.to_v_ip.", ".attn1.processor.ln_k_ip."):
            assert any(part in n and np.abs(want[n]).max() > 0 for n in s["tgrads"]), part


def test_adapter_parameters_after_two_updates_match_jax(setup, two_steps):
    """The elements whose JAX gradient is above 1e-2 of its leaf's largest
    in both steps within 2e-6 (the stage-2 test's bound), and more than 70%
    of the elements among them; the elements whose gradients lie above the
    gradient test's bound (1e-5 + 1e-3 of the leaf's largest) in both steps,
    so that the two packages agree on their signs, within a tenth of the two
    updates' reach 2·lr; every other element within that reach, 2·2·lr
    (AdamW's first update is about ±lr whatever the gradient's size, and a
    gradient at the noise floor takes either sign: measured -5.8e-9 in JAX
    and +4.2e-9 here on a leaf whose largest is 2.1e-2). Every trained leaf
    moved and no frozen leaf changed."""
    trainer = two_steps["trainer"]
    want = _named(setup, two_steps["steps"][-1]["jparams"])
    g1, g2 = (_named(setup, s["jgrads"]) for s in two_steps["steps"])
    named = trainer.named_parameters()
    start = convert.export_named({k: setup["params"][k] for k in MODELS})
    determined = []
    for name in trainer.trainable_names:
        got = named[name].detach().numpy()
        assert np.abs(got - start[name]).max() > 1e-4, f"{name} did not move"
        diff = np.abs(got - want[name])
        top = max(np.abs(g1[name]).max(), np.abs(g2[name]).max())
        least = np.minimum(np.abs(g1[name]), np.abs(g2[name]))
        mask = least > 1e-2 * top
        determined.append(mask.mean())
        assert diff[mask].max(initial=0.0) <= 2e-6, name
        assert diff[least > 1e-5 + 1e-3 * top].max(initial=0.0) <= 0.1 * 2 * LR, name
        assert diff.max() <= 2 * 2 * LR, name
    assert np.mean(determined) > 0.7
    for name, before in two_steps["frozen_before"].items():
        assert torch.equal(named[name], before), name


def test_enable_aggregator_adapter_matches_jax_structure(setup):
    """The Aggregator grows the JAX function's leaves (names and shapes, by
    ``export_aggregator``), keeps every existing tensor, starts the AdaLN
    linears at zero; the agg_resampler has the JAX one's leaves (dim 1280,
    depth 4, 20 heads of 64, ``adapter_tokens`` queries), and
    ``image_proj_sd`` loads into it exactly."""
    unet, _, _, _, _, _ = setup["models"]
    ucfg, dcfg = j_unet_cfg(**SLIM), setup["dcfg"]
    plain = JAggregator(ucfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    plain_params = _init_random(plain, 2, z, np.zeros((1,), np.int32), z, added_text_embeds=np.zeros((1, 16),
                                np.float32), added_time_ids=np.zeros((1, 6), np.float32))
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    _, jparams, jres = jstage2.enable_aggregator_adapter(plain, {"aggregator": plain_params}, dcfg.hidden_size, jcfg,
                                                         seed=0)
    want_agg = convert.export_aggregator(jparams["aggregator"])
    want_res = convert.export_resampler(jparams["agg_resampler"])

    agg = Aggregator(tiny_unet_config(**SLIM))
    agg.load_state_dict(convert.to_torch(convert.export_aggregator(plain_params)), strict=True)
    new, res = enable_aggregator_adapter(agg, agg.state_dict(), dcfg.hidden_size, Stage2Config(**STEP_CFG), seed=0)
    assert new is not agg and new.aggregator_adapter and not agg.aggregator_adapter
    got_agg, got_res = new.state_dict(), res.state_dict()
    assert {k: tuple(v.shape) for k, v in got_agg.items()} == {k: v.shape for k, v in want_agg.items()}
    assert {k: tuple(v.shape) for k, v in got_res.items()} == {k: v.shape for k, v in want_res.items()}
    assert (res.config.dim, res.config.depth, res.config.heads, res.config.head_dim, res.config.num_queries) == (
        1280, 4, 20, 64, TOKENS) == (jres.config.dim, jres.config.depth, jres.config.heads, jres.config.head_dim,
                                     jres.config.num_queries)
    for k, v in agg.state_dict().items():
        assert torch.equal(got_agg[k], v), k
    for k, v in got_agg.items():
        if ".ln_k_ip." in k or ".ln_v_ip." in k:
            assert not v.any() and not want_agg[k].any(), k
        elif k.endswith("_ip.weight"):
            assert v.std() > 0 and want_agg[k].std() > 0, k
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(3)) for k, v in got_res.items()}
    _, loaded = enable_aggregator_adapter(agg, agg.state_dict(), dcfg.hidden_size, Stage2Config(**STEP_CFG),
                                          image_proj_sd=sd)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("case", ["no_agg_resampler", "plain_aggregator"])
def test_trainer_guards_raise_as_in_jax(setup, case):
    unet, agg, res, vae, dino, agg_res = setup["models"]
    jcfg = jstage2.Stage2Config(**STEP_CFG)
    trainer = _port_trainer(setup["params"], setup["dcfg"])
    if case == "no_agg_resampler":
        match = "agg_resampler"
        jfn = lambda: jstage2.Stage2Trainer(unet, agg, res, vae, dino, setup["params"], jcfg)  # noqa: E731
        tfn = lambda: Stage2Trainer(trainer.unet, trainer.aggregator, trainer.resampler, trainer.vae,  # noqa: E731
                                    trainer.image_encoder, Stage2Config(**STEP_CFG), device="cpu")
    else:
        match = "built without aggregator_adapter=True"
        jfn = lambda: jstage2.Stage2Trainer(unet, JAggregator(j_unet_cfg(**SLIM)), res, vae, dino,  # noqa: E731
                                            setup["params"], jcfg, agg_resampler=agg_res)
        tfn = lambda: Stage2Trainer(trainer.unet, Aggregator(tiny_unet_config(**SLIM)), trainer.resampler,  # noqa
                                    trainer.vae, trainer.image_encoder, Stage2Config(**STEP_CFG), device="cpu",
                                    agg_resampler=trainer.agg_resampler)
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


def test_validation_render_raises_with_the_adapter(two_steps):
    """The stage-2 validation render restores through the Aggregator, which
    the restore calls without image tokens: ``ValueError``, as the JAX
    trainer's ``validate_stage2`` raises at its Aggregator call."""
    trainer = two_steps["trainer"]
    val = {"lq": torch.zeros(1, RES, RES, 3), "gt": torch.zeros(1, RES, RES, 3)}
    cond = {"prompt_embeds": torch.zeros(1, 7, 32), "pooled_embeds": torch.zeros(1, 16),
            "time_ids": torch.tensor([[RES, RES, 0, 0, RES, RES]], dtype=torch.float32)}
    with pytest.raises(ValueError, match="requires ip_hidden_states"):
        trainer.validate(val, cond)


def test_cli_trains_with_the_adapter_and_resumes_bitwise(tmp_path, monkeypatch):
    """``cli.train.main stage2 --aggregator_adapter --synthetic_data`` for 2
    steps with a checkpoint, then to 4 steps from it: the first run's state
    equals ``checkpoint-2`` bitwise, a trainer of its own resumed from it
    holds the same state, the second run starts from ``checkpoint-2`` and
    leaves ``checkpoint-4``; ``aggregator.pt`` maps strictly onto an adapter
    Aggregator (the ip leaves included). The agg_resampler is built at the
    tiny Resampler's widths with the CLI's ``--adapter_tokens`` and the
    encoder's width (the reference widths, 80 M parameters, are held in
    ``test_enable_aggregator_adapter_matches_jax_structure``)."""
    monkeypatch.setattr(stage2_aggregator, "ResamplerConfig", tiny_resampler_config)
    ucfg = tiny_unet_config(**SLIM)
    pipe = build_pipeline(ucfg, tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                          tiny_dinov2_config(), seed=3, device="cpu")
    out = tmp_path / "s2"
    flags = ["stage2", "--aggregator_adapter", "--adapter_tokens", str(TOKENS), "--synthetic_data", "--resolution",
             "64", "--train_batch_size", "2", "--checkpointing_steps", "2", "--checkpoints_total_limit", "1",
             "--prefetch_batches", "1", "--lr_warmup_steps", "0", "--learning_rate", "1e-3", "--output_dir", str(out),
             "--losses_config", str(REPO / "config_files" / "losses.yaml")]
    first = ct.main(flags + ["--max_train_steps", "2"], device="cpu", pipe=pipe)["trainer"]
    assert first.global_step == 2
    assert (first.agg_resampler.config.num_queries, first.agg_resampler.config.embedding_dim) == (TOKENS, 16)
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-2"]
    state = first.checkpoint_state()
    assert any(n.startswith("agg_resampler.") for n in state["trainable"])

    def equal(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                equal(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path

    equal(state, first.ckpt.restore(2))
    agg, agg_res = enable_aggregator_adapter(pipe.aggregator, pipe.aggregator.state_dict(),
                                             pipe.image_encoder.config.hidden_size, first.cfg, seed=9)
    other = Stage2Trainer(pipe.unet, agg, pipe.resampler, pipe.vae, pipe.image_encoder, first.cfg, device="cpu",
                          agg_resampler=agg_res)
    assert other.resume() == 2
    equal(other.checkpoint_state(), state)
    del other, agg, agg_res

    second = ct.main(flags + ["--max_train_steps", "4"], device="cpu", pipe=pipe)["trainer"]
    assert second.global_step == 4
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-4"]
    exported = torch.load(out / "aggregator.pt", map_location="cpu", weights_only=True)
    back = Aggregator(ucfg, aggregator_adapter=True)
    back.load_state_dict(exported, strict=True)
    assert any(".attn1.processor.to_k_ip." in k for k in exported)
    masters = second.master_parameters()
    for k, v in exported.items():
        assert torch.equal(v, masters[f"aggregator.{k}"].detach().float()), k
