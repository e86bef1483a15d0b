"""CPU parity of the port's stage-2 validation render with the JAX package's.

``train/validation.py::validate_stage2`` against its JAX twin on the models,
inputs and draws of ``tests/test_torch_port_validation.py`` (whose fixture
this file takes; the render's JAX restore compile, the largest of the
validation renders, gets a file of its own so that ``--dist loadfile``
spreads the two over workers): the whole restore, config #4 in
``STAGE2_STEPS`` steps (modes A, B and C), staged, on the live weights; the
uint8 strips at most one level apart, their caption rows bitwise.
"""

from __future__ import annotations

import numpy as np

from instantir_tpu.train import validation as jval
from instantir_tpu_torch.train import validation as tval
from test_torch_port_validation import STAGE2_STEPS, _stage2_noise, _strips_close, _t, _Tracker
from test_torch_port_validation import trainers  # noqa: F401  (fixture)


def test_validate_stage2_strips_match_jax(trainers):  # noqa: F811
    jtr, ttr, x = trainers
    jtracker, ttracker = _Tracker(), _Tracker()
    jval.validate_stage2(jtr, x["lq"], x["gt"], x["cond"], jtracker, 5, num_steps=STAGE2_STEPS)
    strips = tval.validate_stage2(ttr, x["lq"], x["gt"], {k: _t(v) for k, v in x["cond"].items()}, ttracker, 5,
                                  num_steps=STAGE2_STEPS, noise=_stage2_noise())
    step, jimages = jtracker.logged["validation/instantir"]
    assert step == 5 and ttracker.logged["validation/instantir"][0] == 5
    _strips_close(strips, np.rint(jimages * 255.0).astype(np.uint8))
    assert "instantir_pipe" in ttr._val_cache  # the pipeline object is kept for the next render
