"""CPU parity of the port's data-parallel trainers: the mean gradient over a
gloo group of two ranks, ZeRO-1, and the training CLI under a group.

The port side is one gloo group of two processes: this file run as a script
(``python tests/test_torch_port_dp.py --worker RANK WORLD DIR``) is one rank.
It imports torch, numpy and the port only, reads the inputs (numpy arrays,
and the weights exported from the JAX trees through ``convert.py``) from
``DIR``, writes rank 0's results there as ``.npz`` and asserts at its end that
no module of JAX or of the JAX package was imported. The JAX side runs beside
it in one more process (``--jax DIR``) on the suite's virtual 8-device mesh
(the device count of ``conftest.py``), at XLA's lowest CPU optimisation level.
The configs, inputs and helpers are ``_torch_dp_common.py``'s, shared with
``test_torch_port_dp_stage2_previewer.py`` (the DP steps of stage 2 and the
previewer against their JAX trainers). Checked here:

* a stage-1 step with ``mesh="auto"`` on the group, each rank fed its row of
  the global batch of two and the global draws of the JAX step's key,
  against the JAX trainer's step on a 2-device mesh: loss to 1e-5 relative,
  the gradient norm, every gradient within 1e-5 + 1e-3 of its leaf's largest
  value;
* ZeRO-1 against the replicated optimiser state, two stage-1 steps from one
  state and draws: masters and moments bitwise; ``zero1_spec``'s axis equal
  to the JAX package's for every trainable leaf of the three trainers; the
  8-bit moments under ZeRO-1: codes, scales and masters bitwise the
  unsharded 8-bit optimiser's;
* ``cli.train.main stage1`` under the group (each rank its rows of a global
  batch of two): two steps with a checkpoint that rank 0 alone writes, then a
  resume whose state is bitwise the checkpoint's, run to three steps;
* ``initialize_distributed``: a no-op without a launcher, idempotent once
  the group exists; ``resolve_mesh("auto")`` takes the group of two.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

from _torch_dp_common import BATCH, KEYS, KINDS, RANKS, STEP_CFG, assert_no_jax, batch, close, draws, inputs, \
    jax_params, jax_step, join_group, port_pipeline, spawn, step_results, trainer, wait, write_inputs

CLI_ARGS = ["stage1", "--synthetic_data", "--resolution", "64", "--train_batch_size", str(BATCH),
            "--checkpointing_steps", "2", "--prefetch_batches", "0", "--lr_warmup_steps", "0", "--learning_rate",
            "1e-3"]


# --------------------------------------------------------------------------
# the port's ranks (no JAX)
# --------------------------------------------------------------------------


def _equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _zero1_pair(out: str, data, steps: int, **cfg):
    """(optimiser state, masters) after ``steps`` stage-1 steps with ZeRO-1 on and off, same state and draws."""
    res = []
    for zero1 in (True, False):
        tr = trainer("stage1", out, shard_optimizer_state=zero1, **cfg)
        b = batch(tr, data)
        for i in range(steps):
            tr.train_step(b, draws("stage1", data, i))
        res.append((tr.optimizer.state_by_name(tr.trainable_names), [m.clone() for m in tr.optimizer.masters], tr))
    return res


def worker_main(rank: int, world: int, out: str) -> None:
    t0 = time.perf_counter()
    join_group(rank, world, out)
    import torch
    import torch.distributed as dist

    from instantir_tpu_torch.cli import train as ct
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh, zero1_spec
    from instantir_tpu_torch.train import common

    res = {"idempotent": np.asarray(initialize_distributed(force=True) and dist.get_world_size() == world)}
    data = np.load(os.path.join(out, "inputs.npz"))

    tr = trainer("stage1", out)  # mesh="auto": the group's data axis
    assert tr.mesh is not None and tr.is_main == (rank == 0)
    res.update(step_results(tr, data, "stage1", "dp"))
    for kind in KINDS:
        shapes = data[f"zero1.{kind}.shapes"]
        res[f"{kind}.zero1_axes"] = np.asarray([-1 if (a := zero1_spec(tuple(s[s > 0]), tr.mesh)) is None else a
                                                for s in shapes])

    (st_z, m_z, tr_z), (st_r, m_r, _) = _zero1_pair(out, data, 2)
    res["zero1.bitwise"] = np.asarray(_equal(st_z, st_r) and all(torch.equal(a, b) for a, b in zip(m_z, m_r)))
    res["zero1.sharded_leaves"] = np.asarray(sum(a is not None for a in tr_z.optimizer.axes))
    (st_z, m_z, tr_z), (st_r, m_r, _) = _zero1_pair(out, data, 2, use_8bit_adam=True)
    res["zero1_8bit.bitwise"] = np.asarray(_equal(st_z, st_r) and all(torch.equal(a, b) for a, b in zip(m_z, m_r)))
    res["zero1_8bit.blocks"] = np.asarray([tr_z.optimizer.mu_q.shape[0], tr_z.optimizer.flat.shape[0]])

    # the training CLI under the group: rank 0 alone writes; the resumed state is the checkpoint's
    saves = []
    orig_save = common.CheckpointManager.save
    common.CheckpointManager.save = lambda self, step, state: (saves.append(step), orig_save(self, step, state))[1]
    cli_out = os.path.join(out, "cli")
    try:
        first = ct.main([*CLI_ARGS, "--max_train_steps", "2", "--output_dir", cli_out], device="cpu",
                        pipe=port_pipeline(out))
        written = common._to_host(first["trainer"].checkpoint_state())
        resumed = {}
        orig_resume = common.Trainer.resume

        def capture(self):
            step = orig_resume(self)
            resumed.update(step=step, state=common._to_host(self.checkpoint_state()))  # a copy: the run trains on
            return step

        common.Trainer.resume = capture
        try:
            second = ct.main([*CLI_ARGS, "--max_train_steps", "3", "--output_dir", cli_out], device="cpu",
                             pipe=port_pipeline(out))
        finally:
            common.Trainer.resume = orig_resume
    finally:
        common.CheckpointManager.save = orig_save
    res["cli.saves"] = np.asarray(saves)
    res["cli.exports"] = np.asarray(len(first["exports"]) + len(second["exports"]))
    res["cli.resumed_step"] = np.asarray(resumed["step"])
    res["cli.resume_bitwise"] = np.asarray(_equal(written, resumed["state"]))
    res["cli.steps"] = np.asarray(second["trainer"].global_step)
    res["cli.mesh"] = np.asarray(second["trainer"].mesh is not None)
    gathered = [None] * world
    dist.all_gather_object(gathered, {k: v.tolist() for k, v in res.items() if k.startswith("cli.")})
    if rank == 0:
        res["cli.by_rank"] = np.asarray(repr(gathered))
        res["cli.checkpoints"] = np.asarray(sorted(d for d in os.listdir(cli_out) if d.startswith("checkpoint-")))
        np.savez(os.path.join(out, "port.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:  # a launched group of one: "auto" takes no mesh (the JAX rule), an explicit one-rank mesh is kept
        os.environ.update(WORLD_SIZE="1", RANK="0")
        initialize_distributed(init_method="file://" + os.path.join(out, "rendezvous1"), device="cpu")
        one = make_mesh(device="cpu")
        auto = common.resolve_mesh("auto", BATCH, device="cpu")
        kept = common.resolve_mesh(one, BATCH, device="cpu")
        np.savez(os.path.join(out, "one_rank.npz"), auto_none=np.asarray(auto is None), kept=np.asarray(kept is one),
                 zero1_axis=np.asarray(zero1_spec((4, 3), one)))
        dist.destroy_process_group()
    assert_no_jax()
    print(f"[dp {rank}] done in {time.perf_counter() - t0:.1f} s", flush=True)


# --------------------------------------------------------------------------
# the JAX side and the parent
# --------------------------------------------------------------------------


def _zero1_shapes(params) -> dict:
    """Each trainer's trainable leaf shapes, zero-padded to one width (numpy)."""
    import jax

    from instantir_tpu.train import common as jcommon
    from instantir_tpu.train.previewer_lora import lora_trainable_pred
    from instantir_tpu.train.stage1_adapter import stage1_trainable_pred
    from instantir_tpu.train.stage2_aggregator import Stage2Config, stage2_trainable_pred

    preds = {"stage1": stage1_trainable_pred, "stage2": stage2_trainable_pred(Stage2Config(**STEP_CFG["stage2"])),
             "previewer": lora_trainable_pred}
    out = {}
    for kind in KINDS:
        trainable, _ = jcommon.partition_params(params, preds[kind])
        shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(trainable)]
        width = max(len(s) for s in shapes)
        out[f"zero1.{kind}.shapes"] = np.asarray([list(s) + [0] * (width - len(s)) for s in shapes], np.int64)
    return out


def jax_main(out: str) -> None:
    """The JAX stage-1 trainer's step on a 2-device mesh (loss, gradient norm,
    gradients); the ZeRO-1 axes of the three trainers' trainable leaves."""
    import jax

    assert len(jax.devices()) == 8, "the JAX process runs on the suite's virtual 8-device CPU mesh"
    import jax.numpy as jnp

    from instantir_tpu.parallel import make_mesh
    from instantir_tpu.parallel.mesh import zero1_spec

    mesh = make_mesh(num_devices=RANKS)
    want = jax_step("stage1", out, mesh)
    data = np.load(os.path.join(out, "inputs.npz"))
    for kind in KINDS:
        axes = []
        for s in data[f"zero1.{kind}.shapes"]:
            spec = zero1_spec(jnp.zeros(tuple(s[s > 0])), mesh).spec
            axes.append(next((i for i, p in enumerate(spec) if p == "data"), -1))
        want[f"{kind}.zero1_axes"] = np.asarray(axes)
    np.savez(os.path.join(out, "jax.npz"), **want)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo group and the JAX process, started once and together."""
    out = str(tmp_path_factory.mktemp("dp"))
    t0 = time.perf_counter()
    params = jax_params()
    write_inputs(out, params, {**inputs(["stage1"], KEYS), **_zero1_shapes(params)})
    port = spawn(__file__, ["--worker"], out, RANKS)
    jax_proc = spawn(__file__, ["--jax"], out)
    wait(port, "rank")
    wait(jax_proc, "jax")
    print(f"[dp] group and JAX side in {time.perf_counter() - t0:.1f} s")
    return (dict(np.load(os.path.join(out, "jax.npz"))),
            {**np.load(os.path.join(out, "port.npz")),
             **{f"one_rank.{k}": v for k, v in np.load(os.path.join(out, "one_rank.npz")).items()}})


def test_initialize_distributed_is_a_noop_without_a_launcher(monkeypatch):
    from instantir_tpu_torch.parallel import initialize_distributed, make_mesh

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed(device="cpu") is False
    for model_parallel in (1, 2):  # the tensor-parallel mesh too: no group, no mesh
        with pytest.raises(RuntimeError, match="torchrun"):
            make_mesh(model_parallel=model_parallel, device="cpu")


def test_initialize_distributed_is_idempotent_once_initialized(runs):
    assert bool(runs[1]["idempotent"])


def test_auto_takes_no_mesh_on_a_group_of_one(runs):
    """At one rank ``mesh="auto"`` trains as a single process (no collective),
    as the JAX rule; a one-rank mesh given explicitly is kept, and ZeRO-1
    keeps its axis there (one shard)."""
    got = runs[1]
    assert bool(got["one_rank.auto_none"]) and bool(got["one_rank.kept"]) and int(got["one_rank.zero1_axis"]) == 0


def test_dp_stage1_step_matches_the_jax_trainer_on_a_2_device_mesh(runs):
    want, got = runs
    close(got, want, "stage1.dp", "stage1")


def test_zero1_matches_replicated_bitwise(runs):
    got = runs[1]
    assert bool(got["zero1.bitwise"]) and int(got["zero1.sharded_leaves"]) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_zero1_spec_axis_matches_jax_for_every_leaf(runs, kind):
    want, got = runs
    np.testing.assert_array_equal(got[f"{kind}.zero1_axes"], want[f"{kind}.zero1_axes"])
    assert (want[f"{kind}.zero1_axes"] >= 0).any()


def test_zero1_with_8bit_adam_is_bitwise_the_unsharded_optimizer(runs):
    got = runs[1]
    mine, padded = got["zero1_8bit.blocks"]
    assert bool(got["zero1_8bit.bitwise"]) and 0 < mine <= padded // RANKS


def test_two_process_cli_run_checkpoints_on_rank_0_and_resumes_bitwise(runs):
    got = runs[1]
    by_rank = eval(str(got["cli.by_rank"]))  # written by this file's own worker
    assert by_rank[0]["cli.saves"] == [2, 3] and by_rank[1]["cli.saves"] == []
    assert by_rank[0]["cli.exports"] == 4 and by_rank[1]["cli.exports"] == 0
    assert all(r["cli.resumed_step"] == 2 and r["cli.resume_bitwise"] and r["cli.steps"] == 3 and r["cli.mesh"]
               for r in by_rank)
    assert list(got["cli.checkpoints"]) == ["checkpoint-2", "checkpoint-3"]


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "--worker":
    worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
elif __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--jax":
    jax_main(sys.argv[2])
