"""CPU parity of the port's data-parallel stage-2 and previewer steps with the
JAX trainers on a 2-device mesh.

The port side is one gloo group of two processes: this file run as a script
(``python tests/test_torch_port_dp_stage2_previewer.py --worker RANK WORLD
DIR``) is one rank, importing torch, numpy and the port only (it asserts so at
its end). The JAX side is two more processes (``--jax stage2 DIR``, ``--jax
previewer DIR``), each on the suite's virtual 8-device mesh at XLA's lowest
CPU optimisation level, started beside the group. The configs, inputs and
helpers are ``_torch_dp_common.py``'s (the slim tiny UNet, a global batch of
two, every leaf random). Checked:

* a step of stage 2 (``cfg_scale`` 2, ``optimize_adapter``, importance
  sampling, EMA decay 0.5, drop rates 0.3) and of the previewer (Huber and
  DINOLoss at 1e-3, two solver points) with ``mesh="auto"`` on the group,
  each rank fed its row of the global batch and the global draws of the JAX
  step's key, against the JAX trainer's own jitted step on a 2-device mesh fed
  the same batch and key: loss to 1e-5 relative, the gradient norm, every
  gradient within 1e-5 + 1e-3 of its leaf's largest value;
* the same DP step against the port's one-process step on the whole batch;
* the DINOLoss center after the previewer's step (the global batch's mean)
  against the JAX trainer's after its step.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

from _torch_dp_common import KEYS, RANKS, assert_no_jax, batch, close, draws, inputs, jax_params, jax_step, join_group, \
    spawn, step_results, trainer, wait, write_inputs

KINDS = ("stage2", "previewer")


def worker_main(rank: int, world: int, out: str) -> None:
    t0 = time.perf_counter()
    join_group(rank, world, out)
    import torch.distributed as dist

    data = np.load(os.path.join(out, "inputs.npz"))
    res = {}
    for kind in KINDS:
        runs = [("dp", trainer(kind, out))]  # mesh="auto": the group's data axis
        assert runs[0][1].mesh is not None
        if rank == 0:  # the one-process step on the whole batch
            runs.append(("single", trainer(kind, out, mesh=None)))
        for tag, tr in runs:
            res.update(step_results(tr, data, kind, tag))
            if kind == "previewer":
                tr.train_step(batch(tr, data), draws(kind, data, 0))
                res[f"previewer.{tag}.center"] = tr.dino_center.numpy()
    if rank == 0:
        np.savez(os.path.join(out, "port.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
    assert_no_jax()
    print(f"[dp {rank}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def jax_main(kind: str, out: str) -> None:
    """The JAX trainer of ``kind`` on a 2-device mesh: its step's loss,
    gradient norm, gradients (and the previewer's DINOLoss center), into
    ``jax.<kind>.npz``."""
    import jax

    assert len(jax.devices()) == 8, "the JAX process runs on the suite's virtual 8-device CPU mesh"
    from instantir_tpu.parallel import make_mesh

    np.savez(os.path.join(out, f"jax.{kind}.npz"), **jax_step(kind, out, make_mesh(num_devices=RANKS)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo group and the two JAX processes, started once and together."""
    out = str(tmp_path_factory.mktemp("dp_steps"))
    t0 = time.perf_counter()
    write_inputs(out, jax_params(), inputs(KINDS, KEYS[:1]))
    port = spawn(__file__, ["--worker"], out, RANKS)
    jax_procs = [p for kind in KINDS for p in spawn(__file__, ["--jax", kind], out)]
    wait(port, "rank")
    wait(jax_procs, "jax")
    print(f"[dp_steps] group and JAX side in {time.perf_counter() - t0:.1f} s")
    want = {k: v for kind in KINDS for k, v in np.load(os.path.join(out, f"jax.{kind}.npz")).items()}
    return want, dict(np.load(os.path.join(out, "port.npz")))


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_the_jax_trainer_on_a_2_device_mesh(runs, kind):
    want, got = runs
    close(got, want, f"{kind}.dp", kind)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_the_one_process_step(runs, kind):
    got = runs[1]
    close(got, got, f"{kind}.dp", f"{kind}.single")


def test_dino_center_is_the_global_batch_mean(runs):
    want, got = runs
    np.testing.assert_allclose(got["previewer.dp.center"], want["previewer.center"], rtol=0,
                               atol=1e-5 * float(np.abs(want["previewer.center"]).max()))
    np.testing.assert_allclose(got["previewer.dp.center"], got["previewer.single.center"], rtol=0, atol=1e-6)
    assert np.abs(want["previewer.center"]).max() > 0


if __name__ == "__main__" and len(sys.argv) == 5 and sys.argv[1] == "--worker":
    worker_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
elif __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "--jax":
    jax_main(sys.argv[2], sys.argv[3])
