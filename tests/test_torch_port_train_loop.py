"""The port's training host loop on the CPU: checkpoints, resume, prefetching,
preemption, the event file, raw-image batches and the training CLI.

Tiny models (the ``tests/test_torch_port_pipeline.py`` configs, fp32). A
checkpoint holds each trainer's state (the fp32 masters, the AdamW state, the
step, stage 2's EMA adapter) and gives it back bitwise; a trainer resumed from
one takes the same next step as one that never stopped, fed the same draws.
``pipelined_batches`` gives the sequential loop's batches bitwise, raises a
worker's error, and ends with the data. A raw-image batch through
``prepare_batch`` equals the JAX ``prepare_batch``'s ``lq``/``gt`` (the eager
chain at 48², the same ``host_rng`` seed, JAX's own noise draws; 1e-5 with the
JPEG share of ``test_torch_port_data.py``). ``cli.train.main`` runs each stage
from synthetic raw images with the text towers of a tiny checkpoint tree
(written by ``chip_smoke.write_checkpoint_tree``), and its exports load back
strictly. The SDXL-width ``_build_models`` is wired on ``meta`` only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import signal
import struct
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.data import degradation as jdeg
from instantir_tpu.train import stage1_adapter as jstage1
from instantir_tpu_torch.cli import train as ct
from instantir_tpu_torch.models.clip_text import CLIPTextModel, tiny_clip_text_config
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.pipeline import load as tload
from instantir_tpu_torch.pipeline.factory import build_pipeline, synthesize_weights
from instantir_tpu_torch.train import common
from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer
from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer
from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

REPO = Path(__file__).resolve().parents[1]
RES, BATCH = 32, 2
OP_TOL = 1e-5
JPEG_FLIP_SHARE, JPEG_FLIP_MAX = 0.01, 0.2  # on [-1, 1]; the reasons in test_torch_port_data.py
CFG = dict(train_batch_size=BATCH, resolution=RES, learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=10)


def _pipe(seed: int = 0):
    return build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), seed=seed,
                          device="cpu")


def _trainer(kind: str, pipe, **cfg):
    cfg = {**CFG, **cfg}
    models = (pipe.unet, pipe.resampler, pipe.vae, pipe.image_encoder)
    if kind == "stage1":
        return Stage1Trainer(*models, Stage1Config(**cfg), device="cpu")
    if kind == "stage2":
        return Stage2Trainer(pipe.unet, pipe.aggregator, *models[1:],
                             Stage2Config(optimize_adapter=True, ema_decay=0.5, **cfg), device="cpu")
    return PreviewerTrainer(*models, PreviewerConfig(num_ddim_timesteps=2, **cfg), device="cpu")


def _cond(pipe, b: int = BATCH):
    ucfg = pipe.unet.config
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    g = torch.Generator().manual_seed(1)
    return {"prompt_embeds": torch.randn(b, 7, ucfg.cross_attention_dim, generator=g),
            "uncond_prompt_embeds": torch.zeros(b, 7, ucfg.cross_attention_dim),
            "pooled_embeds": torch.randn(b, pooled, generator=g), "uncond_pooled_embeds": torch.zeros(b, pooled),
            "time_ids": torch.tensor([[RES, RES, 0, 0, RES, RES]] * b, dtype=torch.float32)}


def _pair(seed: int = 2):
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand(BATCH, RES, RES, 3, generator=g) * 2 - 1
    return {"lq": (gt + 0.2 * torch.randn(gt.shape, generator=g)).clamp(-1, 1), "gt": gt}


def _equal_trees(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), path
    else:
        assert a == b, path


# --------------------------------------------------------------------------
# checkpoints and resume
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stage1", "stage2", "previewer"])
def test_checkpoint_round_trip_is_bitwise(kind, tmp_path):
    """Two steps, a checkpoint, and a second trainer over fresh models
    resumed from it: masters, AdamW state, count, step (and the EMA copy)
    equal bitwise; the leaves hold their masters."""
    pipe = _pipe()
    trainer = _trainer(kind, pipe, output_dir=str(tmp_path))
    batch = trainer.prepare_batch(_pair(), _cond(pipe))
    for i in range(2):
        trainer.train_step(batch, generator=torch.Generator().manual_seed(i))
    trainer.save_checkpoint()
    state = trainer.checkpoint_state()
    assert set(state) == ({"trainable", "opt_state", "step", "ema_adapter"} if kind == "stage2"
                          else {"trainable", "opt_state", "step"})
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2"]
    other = _trainer(kind, _pipe(seed=9), output_dir=str(tmp_path))
    assert other.resume() == 2 and other.global_step == 2
    _equal_trees(other.checkpoint_state(), state)
    named = other.named_parameters()
    for n, m in zip(other.trainable_names, other.optimizer.masters):
        assert torch.equal(named[n].detach(), m)


def test_gradient_accumulation_buffers_are_checkpointed(tmp_path):
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, output_dir=str(tmp_path), gradient_accumulation_steps=2)
    trainer.train_step(trainer.prepare_batch(_pair(), _cond(pipe)), generator=torch.Generator().manual_seed(0))
    trainer.save_checkpoint()
    other = _trainer("stage1", _pipe(), output_dir=str(tmp_path), gradient_accumulation_steps=2)
    other.resume()
    assert other._micro_steps == 1 and other.optimizer.count == 0
    _equal_trees(other.checkpoint_state(), trainer.checkpoint_state())


def test_resumed_trainer_takes_the_step_of_one_that_never_stopped(tmp_path):
    batch_pipe = _pipe()
    a = _trainer("stage1", _pipe(), output_dir=str(tmp_path / "a"))
    batch = a.prepare_batch(_pair(), _cond(batch_pipe))
    a.train_step(batch, generator=torch.Generator().manual_seed(10))
    a.save_checkpoint()
    a.train_step(batch, generator=torch.Generator().manual_seed(11))
    b = _trainer("stage1", _pipe(), output_dir=str(tmp_path / "a"))
    assert b.resume() == 1
    b.train_step(batch, generator=torch.Generator().manual_seed(11))
    _equal_trees(b.checkpoint_state(), a.checkpoint_state())


def test_checkpoint_manager_gc_async_and_errors(tmp_path, monkeypatch):
    state = {"trainable": {"w": torch.arange(6.0)}, "opt_state": {"count": 3}, "step": 0}
    mgr = common.CheckpointManager(str(tmp_path), total_limit=2)
    assert mgr.latest_step() is None and mgr.resume_latest() == (None, None)
    for step in (1, 2, 3, 4):
        mgr.save(step, {**state, "step": step})
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-3", "checkpoint-4"]
    assert mgr.latest_step() == 4 and mgr.restore(3)["step"] == 3
    assert [s["step"] for s in mgr.saves] == [1, 2, 3, 4] and mgr.last_save["bytes"] == 24

    amgr = common.CheckpointManager(str(tmp_path / "async"), total_limit=2, async_save=True)
    gate = threading.Event()
    real_save = torch.save

    def slow_save(obj, path):
        gate.wait(10)
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", slow_save)
    t = torch.ones(3)
    amgr.save(5, {"x": t})
    t.add_(1)  # the tensors were copied to the host before save returned
    assert amgr.latest_step() == 5 and not os.path.exists(tmp_path / "async" / "checkpoint-5")
    gate.set()
    amgr.wait()
    assert torch.equal(amgr.restore(5)["x"], torch.ones(3))
    assert os.listdir(tmp_path / "async") == ["checkpoint-5"]

    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    amgr.save(6, {"x": t})
    with pytest.raises(OSError, match="disk full"):
        amgr.wait()
    assert amgr.latest_step() == 5
    off = common.CheckpointManager("", total_limit=1)
    off.save(1, state)
    assert off.latest_step() is None


def test_final_save_is_idempotent(tmp_path):
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, output_dir=str(tmp_path), async_checkpointing=True)
    trainer.train_step(trainer.prepare_batch(_pair(), _cond(pipe)), generator=torch.Generator().manual_seed(0))
    trainer.save_checkpoint()
    trainer.save_checkpoint()  # in flight: the same step is not written twice
    trainer.ckpt.wait()
    trainer.save_checkpoint()
    assert [s["step"] for s in trainer.ckpt.saves] == [1]


@pytest.mark.parametrize("kind", ["stage1", "stage2", "previewer"])
@pytest.mark.parametrize("field", ["handle_preemption", "async_checkpointing"])
def test_preemption_and_async_checkpointing_are_ported(kind, field):
    trainer = _trainer(kind, _pipe(), output_dir="", **{field: True})
    assert getattr(trainer.cfg, field) is True


# --------------------------------------------------------------------------
# batches: prefetching, raw images
# --------------------------------------------------------------------------


def _raw_batches(n: int, size: int = 64, seed: int = 3):
    from instantir_tpu_torch.data.dataset import SyntheticImageDataset

    it = SyntheticImageDataset(seed=seed).batches(BATCH, size)
    return [next(it) for _ in range(n)]


def test_pipelined_batches_equal_the_sequential_loop():
    """Raw 64² images through ``prepare_batch`` (the traced chain), three
    steps ahead of the consumer and in turn: the same lq/gt bitwise."""
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, resolution=64, output_dir="")
    cond = _cond(pipe)
    host = _raw_batches(3)
    want = [trainer.prepare_batch(b, cond, step=i) for i, b in enumerate(host)]
    got = list(common.pipelined_batches(trainer, iter(host), lambda b: cond, max_steps=3, depth=3))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g["lq"], w["lq"]) and torch.equal(g["gt"], w["gt"])
    assert not torch.equal(want[0]["lq"], want[1]["lq"])


def test_pipelined_batches_raise_worker_errors_end_with_the_data_and_stop_early():
    class Prep:
        global_step = 0

        def stage_batch(self, host, step):
            return {"step": step}

        def finish_batch(self, staged, cond):
            return staged

    def failing():
        yield {}
        raise ValueError("bad image")

    stream = common.pipelined_batches(Prep(), failing(), {}, max_steps=5, depth=2)
    assert next(stream) == {"step": 0}
    with pytest.raises(ValueError, match="bad image"):
        next(stream)
    assert [b["step"] for b in common.pipelined_batches(Prep(), iter([{}, {}]), {}, 5, 2)] == [0, 1]
    before = set(threading.enumerate())
    stream = common.pipelined_batches(Prep(), iter([{}] * 100), {}, 100, 1)
    next(stream)
    stream.close()
    assert not [t for t in set(threading.enumerate()) - before if t.name == "batch-prefetch" and t.is_alive()]


@pytest.mark.parametrize("kind", ["stage1", "stage2", "previewer"])
def test_prefetch_run_takes_the_steps_of_the_sequential_run(kind, monkeypatch):
    """With cuDNN's TF32 switch on, as a card has it by default, ``run`` with
    ``prefetch_batches`` 2 ends on the masters of ``run`` in turn: the
    worker thread only stages batches, the degradation (and its
    ``full_fp32`` block) runs on the thread that takes the steps, and no
    step sees the switch turned off."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    chains, steps = [], []
    real_run_degradation = common.run_degradation

    def spy_degradation(*args, **kwargs):
        chains.append(threading.current_thread() is threading.main_thread())
        return real_run_degradation(*args, **kwargs)

    monkeypatch.setattr(common, "run_degradation", spy_degradation)
    masters = []
    for depth in (0, 2):
        pipe = _pipe()
        trainer = _trainer(kind, pipe, resolution=64, output_dir="", prefetch_batches=depth, max_train_steps=2)
        real_step = trainer.train_step

        def step(batch, real_step=real_step):
            steps.append(torch.backends.cudnn.allow_tf32)
            return real_step(batch)

        trainer.train_step = step
        cond = _cond(pipe)
        trainer.run(iter(_raw_batches(2)), lambda b: cond)
        assert trainer.global_step == 2
        masters.append([m.clone() for m in trainer.optimizer.masters])
    assert chains == [True] * 4 and steps == [True] * 4 and torch.backends.cudnn.allow_tf32
    assert all(torch.equal(a, b) for a, b in zip(*masters))
    assert not all(torch.equal(a, p) for a, p in zip(masters[0], _trainer(kind, _pipe(), output_dir="").optimizer.masters))


@pytest.mark.parametrize("form", ["traced", "eager", "degraded"])
def test_stage_batch_leaves_the_device_work_to_finish_batch(form, monkeypatch):
    """``stage_batch`` (the worker's half) uploads and draws the traced
    chain's choices for its step on the host, and degrades nothing;
    ``finish_batch`` (the consumer's half) runs the chain; together they
    give ``prepare_batch``'s batch bitwise. Step 3's eager draws at 48²
    take the order that ends on the JPEG at the snapped size, which needs
    no 8-pixel multiple of the 12² final size."""
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, resolution=32 if form == "eager" else 64, output_dir="")
    cond = _cond(pipe)
    host = _raw_batches(1, size=48 if form == "eager" else 64)[0] if form != "degraded" else _pair()
    calls = []
    real_run_degradation = common.run_degradation

    def spy(*args, **kwargs):
        calls.append(kwargs["draws"])
        return real_run_degradation(*args, **kwargs)

    monkeypatch.setattr(common, "run_degradation", spy)
    staged = trainer.stage_batch(host, step=3)
    assert calls == []
    if form == "traced":
        want = trainer.degradation.draw_choices(BATCH, (16, 16), common.degradation_generators(42, 3, "cpu")[0])
        for field in dataclasses.fields(want):
            assert np.array_equal(getattr(staged["draws"], field.name), getattr(want, field.name)), field.name
    elif form == "eager":
        assert staged["draws"] is None
    got = trainer.finish_batch(staged, cond)
    assert len(calls) == (0 if form == "degraded" else 1)
    want = trainer.prepare_batch(host, cond, step=3)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_raw_image_prepare_batch_matches_the_jax_prepare_batch(monkeypatch):
    """48² raw images (not a multiple of 16·sf: the eager chain in both),
    step 3: the same ``host_rng`` seed (seed·7919 + step) in both packages,
    JAX's own noise draws fed to the port."""
    from test_torch_port_data import _Recorder

    rec = _Recorder(monkeypatch)
    host = _raw_batches(1, size=48, seed=4)[0]
    jself = argparse.Namespace(degradation=jdeg.RealESRGANDegradation(resolution=RES), mesh=None, global_step=0,
                               cfg=jstage1.Stage1Config(seed=42, resolution=RES),
                               _uncond_image_tokens=lambda: jnp.zeros((1, 1, 1)))
    want = jstage1.Stage1Trainer.prepare_batch(jself, host, {}, jax.random.PRNGKey(7), step=3)
    assert len(rec.draws) == 2
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, seed=42, output_dir="")
    got = trainer.prepare_batch(host, {}, step=3, noise=tuple(rec.draws))
    assert got["lq"].shape == got["gt"].shape == (BATCH, RES, RES, 3)
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(want["gt"]), rtol=0, atol=OP_TOL)
    diff = np.abs(got["lq"].numpy() - np.asarray(want["lq"]))
    assert (diff > 2 * OP_TOL).mean() <= JPEG_FLIP_SHARE and diff.max() <= JPEG_FLIP_MAX


def test_raw_batches_need_their_kernels():
    trainer = _trainer("stage1", _pipe(), output_dir="")
    with pytest.raises(ValueError, match="kernel"):
        trainer.prepare_batch({"images": np.zeros((1, 64, 64, 3), np.float32)}, {})


# --------------------------------------------------------------------------
# run: preemption, logging
# --------------------------------------------------------------------------


def test_sigterm_during_run_leaves_a_checkpoint_at_that_step(tmp_path):
    pipe = _pipe()
    trainer = _trainer("stage1", pipe, resolution=64, output_dir=str(tmp_path), handle_preemption=True,
                       prefetch_batches=0, checkpointing_steps=100, logging_steps=1)
    cond = _cond(pipe)

    def data():
        for i, b in enumerate(_raw_batches(5)):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # arrives while batch 2 is prepared
            yield b

    previous = signal.getsignal(signal.SIGTERM)
    try:
        records = trainer.run(data(), cond)
    finally:
        signal.signal(signal.SIGTERM, previous)
        common._PREEMPT["requested"] = False
    assert trainer.global_step == 2 and sorted(os.listdir(tmp_path)) == ["checkpoint-2", "logs"]
    assert [r["step"] for r in records] == [1, 2] and all(r["steps_per_sec"] > 0 for r in records)
    result = []
    thread = threading.Thread(target=lambda: result.append(common.install_preemption_handler()))
    thread.start()
    thread.join()
    assert result == [False]


def _records(path):
    """The TFRecord records of an event file, each one's framing checked."""
    from tensorboardX.crc32c import crc32c as tbx_crc32c

    def masked(data):
        crc = tbx_crc32c(data)
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    out = []
    data = Path(path).read_bytes()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == masked(header)
        body = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == masked(body)
        out.append(body)
        i += 16 + n
    return out


def test_event_file_parses_with_tensorboardx(tmp_path):
    from tensorboardX.proto import event_pb2

    tracker = common.Tracker(str(tmp_path))
    tracker.scalars(3, {"loss": 0.25, "steps_per_sec": 1.5})
    images = np.random.default_rng(0).uniform(size=(2, 8, 12, 3))
    tracker.images(4, "TrainVisualization", images)
    tracker.close()
    (name,) = os.listdir(tmp_path)
    assert name.startswith("events.out.tfevents.")
    events = [event_pb2.Event.FromString(r) for r in _records(tmp_path / name)]
    assert events[0].file_version == "brain.Event:2"
    assert events[1].step == 3 and {v.tag: v.simple_value for v in events[1].summary.value} == {
        "loss": 0.25, "steps_per_sec": 1.5}
    (value,) = events[2].summary.value
    assert events[2].step == 4 and value.tag == "TrainVisualization"
    assert (value.image.height, value.image.width, value.image.colorspace) == (8, 24, 3)
    from io import BytesIO

    from PIL import Image

    png = np.asarray(Image.open(BytesIO(value.image.encoded_image_string)))
    np.testing.assert_array_equal(png, common.image_grid(images))
    assert common.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert common.Tracker(None).writer is None
    with pytest.raises(ValueError, match="backend"):
        common.Tracker(str(tmp_path), backend="nope")


# --------------------------------------------------------------------------
# the training CLI
# --------------------------------------------------------------------------


def test_parser_takes_every_jax_flag():
    from instantir_tpu.cli.train import build_parser as j_build_parser

    def flags(p):
        return {a.dest: (a.default, a.const, a.choices, a.required, a.nargs) for a in p._actions if a.dest != "help"}

    assert flags(ct.build_parser()) == flags(j_build_parser())


@pytest.mark.parametrize("flags", [["--use_8bit_adam"], ["--quantize_frozen_unet"], ["--aggregator_adapter"],
                                   ["--validation_steps", "100"]])
def test_unported_flags_raise(flags):
    """Every flag is ported now (the CLI refuses none): each parses to the
    value the trainer's config takes (``--aggregator_adapter`` trains in
    ``tests/test_torch_port_aggregator_adapter.py``)."""
    args = ct.build_parser().parse_args(["stage2", *flags])
    assert not hasattr(ct, "check_ported")
    dest = flags[0][2:]
    assert getattr(args, dest) == (100 if len(flags) > 1 else True)


def test_sdxl_width_models_are_wired_on_meta(monkeypatch):
    """``_build_models`` without ``--sdxl_path``: SDXL width, bf16, LoRA rank
    64, the seed; built here on ``meta`` in place of the card."""
    from instantir_tpu_torch.models.aggregator import Aggregator
    from instantir_tpu_torch.models.unet import UNet2DConditionModel

    seen = {}

    def on_meta(unet_cfg, vae_cfg, res_cfg, dino_cfg, seed, dtype, device):
        seen.update(seed=seed, dtype=dtype, device=device, res=res_cfg, dino=dino_cfg, vae=vae_cfg)
        meta = torch.device("meta")
        return UNet2DConditionModel(unet_cfg, dtype=dtype, device=meta), Aggregator(unet_cfg, dtype=dtype, device=meta)

    monkeypatch.setattr(ct, "build_pipeline", on_meta)
    unet, agg = ct._build_models(ct.build_parser().parse_args(["stage1", "--seed", "5"]), device="cuda")
    assert seen["seed"] == 5 and seen["dtype"] == torch.bfloat16 and seen["device"] == "cuda"
    assert unet.config.block_out_channels == (320, 640, 1280) and unet.config.cross_attention_dim == 2048
    assert unet.config.lora_rank == 64 and seen["res"].lora_rank == 64 and seen["dino"].hidden_size == 1024
    n_unet = sum(p.numel() for n, p in unet.named_parameters() if "lora_" not in n and "_ip" not in n)
    bf16 = sum(p.numel() for p in agg.parameters() if p.dtype == torch.bfloat16)
    assert 2.55e9 < n_unet < 2.6e9 and bf16 > 0.99 * sum(p.numel() for p in agg.parameters())  # norms stay fp32


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """A tiny pipeline (trained in place by the CLI runs) and its checkpoint tree with two tiny text towers."""
    import chip_smoke

    pipe = _pipe(seed=4)
    g = torch.Generator().manual_seed(6)
    encoders = [synthesize_weights(CLIPTextModel(tiny_clip_text_config(vocab_size=49408, eos_token_id=49407, **kw),
                                                 device=torch.device("cpu")), g)
                for kw in ({"projection_dim": None}, {})]
    root = tmp_path_factory.mktemp("tree")
    paths = chip_smoke.write_checkpoint_tree(torch, pipe, encoders, str(root))
    return pipe, paths, root


@pytest.mark.parametrize("stage", ["stage1", "previewer", "stage2"])
def test_cli_trains_each_stage_from_raw_images(tiny_tree, stage):
    pipe, paths, root = tiny_tree
    out = root / f"out_{stage}"
    argv = [stage, "--sdxl_path", paths["sdxl"], "--vision_encoder_path", paths["dinov2"], "--synthetic_data",
            "--resolution", "64", "--train_batch_size", "2", "--max_train_steps", "2", "--checkpointing_steps", "1",
            "--checkpoints_total_limit", "1", "--prefetch_batches", "1", "--lr_warmup_steps", "0", "--learning_rate",
            "1e-3", "--output_dir", str(out), "--losses_config", str(REPO / "config_files" / "losses.yaml")]
    result = ct.main(argv, device="cpu", pipe=pipe)
    trainer = result["trainer"]
    assert trainer.global_step == 2 and [d for d in os.listdir(out) if d.startswith("checkpoint-")] == ["checkpoint-2"]
    assert [os.path.basename(p) for p in result["exports"]] == [
        {"stage1": "adapter_ckpt.pt", "previewer": "previewer_lora_weights.bin", "stage2": "aggregator.pt"}[stage],
        "instantir_config.json"]
    assert not any(n.startswith("unet.") and ".lora_" not in n and "_ip" not in n for n in trainer.trainable_names)


def test_cli_exports_load_back_strictly(tiny_tree, tmp_path):
    """The three exports of ``test_cli_trains_each_stage_from_raw_images`` make
    an InstantIR folder that ``load_instantir_pipeline`` reads strictly: the
    loaded leaves equal the trained models' (the Resampler's LoRA, which the
    previewer export leaves out, drawn anew)."""
    pipe, paths, root = tiny_tree
    if not all((root / f"out_{s}").is_dir() for s in ("stage1", "previewer", "stage2")):
        for stage in ("stage1", "previewer", "stage2"):
            test_cli_trains_each_stage_from_raw_images(tiny_tree, stage)
    inst = tmp_path / "instantir"
    inst.mkdir()
    shutil.copy(root / "out_stage1" / "adapter_ckpt.pt", inst / "adapter.pt")
    shutil.copy(root / "out_previewer" / "previewer_lora_weights.bin", inst)
    shutil.copy(root / "out_stage2" / "aggregator.pt", inst)
    shutil.copy(root / "out_stage2" / "instantir_config.json", inst)
    back = tload.load_instantir_pipeline(paths["sdxl"], str(inst), vision_encoder_path=paths["dinov2"],
                                         dtype=torch.float32, device="cpu", strict=True)
    for name in ("unet", "aggregator", "resampler"):
        want = getattr(pipe, name).state_dict()
        for k, v in getattr(back, name).state_dict().items():
            if name == "resampler" and "lora_" in k:
                continue
            assert torch.equal(v, want[k]), f"{name}.{k}"
