"""CPU parity of the PyTorch port's ops, layers and schedulers with their JAX twins.

Inputs are made with numpy from a seed and fed to both packages; outputs are
compared in fp32 unless a test says otherwise. The kernels themselves are CUDA
only: on the CPU the port's wrappers and autograd Functions run the kernels'
plain versions (``flash_attention_lse_reference``, ``flash_backward_reference``,
``group_norm_silu_nchw``), which are held here against the JAX Pallas kernels
in interpret mode; ``tests/test_torch_port_kernels.py`` holds each kernel
against its plain version on a card.
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.ops import attention as jattn
from instantir_tpu.ops import group_norm as jgn
from instantir_tpu.ops.group_norm import group_norm_silu_reference as jax_gn
from instantir_tpu.schedulers import diffusion as jsched
from instantir_tpu_torch import convert
from instantir_tpu_torch import kernels as tkernels
from instantir_tpu_torch.models import layers as tlayers
from instantir_tpu_torch.ops import attention as tattn
from instantir_tpu_torch.ops import group_norm as tgn
from instantir_tpu_torch.ops.group_norm import group_norm_silu_reference as torch_gn
from instantir_tpu_torch.schedulers import diffusion as tsched

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jlayers():
    """The JAX layers (they need flax, which a machine that only runs the
    ``cuda`` tests may lack)."""
    return pytest.importorskip("instantir_tpu.models.layers")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _random_tree(shapes, seed):
    """Every leaf of an abstract param tree filled from ``seed`` (kernels
    fan-in scaled, norm scales near 1, biases and zero-init leaves nonzero)."""
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
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _random_tree(shapes, seed)


# --------------------------------------------------------------------------
# import rule
# --------------------------------------------------------------------------


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and neither chip_smoke.py nor profile_torch.py,
    imports jax, flax or the JAX package (``instantir_tpu_torch`` shares the
    ``instantir_tpu`` prefix, so roots are compared whole)."""
    files = sorted((REPO / "instantir_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "profile_torch.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax", "instantir_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
    covered = {str(f.relative_to(REPO)) for f in files}
    for new in ("train/common.py", "train/stage1_adapter.py", "losses/losses.py", "losses/loss_config.py",
                "ops/group_norm.py", "data/degradation.py", "data/dataset.py", "cli/train.py", "parallel/tp.py",
                "utils/flops.py", "utils/profiling.py", "data/native_loader.py"):
        assert f"instantir_tpu_torch/{new}" in covered


def test_port_imports_triton_only_inside_functions():
    """No module of the port imports ``triton``, inside a function or not:
    every kernel is CUDA C++ (``csrc/``), and the port needs no Triton."""
    files = sorted((REPO / "instantir_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    users = [f"{path.relative_to(REPO)}: {mod}" for path in files for mod in _imported_modules(path)
             if mod.split(".")[0] == "triton"]
    assert not users, users


# --------------------------------------------------------------------------
# schedulers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear"])
def test_schedule_tables(schedule):
    j = jsched.make_schedule(beta_schedule=schedule)
    t = tsched.make_schedule(beta_schedule=schedule)
    np.testing.assert_array_equal(np.asarray(j.alphas_cumprod), t.alphas_cumprod.numpy())
    np.testing.assert_array_equal(np.asarray(j.betas), t.betas.numpy())
    assert float(j.final_alpha_cumprod) == t.final_alpha_cumprod


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
@pytest.mark.parametrize("n", [4, 30])
def test_inference_timesteps(spacing, n):
    j = jsched.ddpm_inference_timesteps(n, timestep_spacing=spacing)
    t = tsched.ddpm_inference_timesteps(n, timestep_spacing=spacing)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(jsched.ddpm_prev_timesteps(j, 1000, n), tsched.ddpm_prev_timesteps(t, 1000, n))


STEP_CASES = [([901, 651], [651, 401]), ([1, 251], [-249, 1]), ([0, 0], [-1, -1])]


@pytest.mark.parametrize("ts,prev", STEP_CASES)
def test_ddpm_step(ts, prev):
    rng = np.random.default_rng(1)
    x, eps, noise = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(3))
    js, ts_ = jsched.sdxl_schedule(), tsched.sdxl_schedule()
    jp, jx0 = jsched.ddpm_step(js, eps, np.array(ts), np.array(prev), x, noise)
    tp, tx0 = tsched.ddpm_step(ts_, _t(eps), torch.tensor(ts), torch.tensor(prev), _t(x), _t(noise))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ts", [[999, 500], [1, 21]])
def test_add_noise_and_lcm_step(ts):
    rng = np.random.default_rng(2)
    x, eps = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    js, ts_ = jsched.sdxl_schedule(), tsched.sdxl_schedule()
    np.testing.assert_allclose(
        tsched.add_noise(ts_, _t(x), _t(eps), torch.tensor(ts)).numpy(),
        np.asarray(jsched.add_noise(js, x, eps, np.array(ts))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tsched.lcm_single_step(ts_, _t(eps), torch.tensor(ts), _t(x)).numpy(),
        np.asarray(jsched.lcm_single_step(js, eps, np.array(ts), x)), rtol=1e-5, atol=1e-5)
    jc = jsched.lcm_boundary_scalings(np.array(ts))
    tc = tsched.lcm_boundary_scalings(torch.tensor(ts))
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_importance_sampling_weights():
    for n in (1000, 50):
        np.testing.assert_array_equal(tsched.importance_sampling_weights(n), jsched.importance_sampling_weights(n))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lora_scale", [0.0, 0.7])
def test_lora_dense(jlayers, lora_scale):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    jm = jlayers.LoRADense(20, lora_rank=4, lora_alpha=2.0)
    params = _init_random(jm, 0, x)
    ref = np.asarray(jm.apply(params, x, lora_scale=lora_scale))
    tm = tlayers.LoRALinear(12, 20, lora_rank=4, lora_alpha=2.0)
    sd = {}
    convert._inv_lora_dense(sd, "m", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    with torch.no_grad():
        got = tm(_t(x), lora_scale).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lora_scale", [0.0, 0.7])
@pytest.mark.parametrize("stride", [1, 2])
def test_lora_conv(jlayers, lora_scale, stride):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    jm = jlayers.LoRAConv(10, (3, 3), strides=(stride, stride), padding=1, lora_rank=3)
    params = _init_random(jm, 1, x)
    ref = np.asarray(jm.apply(params, x, lora_scale=lora_scale))
    tm = tlayers.LoRAConv2d(6, 10, 3, stride=stride, padding=1, lora_rank=3)
    sd = {}
    convert._inv_lora_conv(sd, "m", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2), lora_scale).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_group_norm32(jlayers, fuse_silu, offset):
    """GroupNorm32 module and the NHWC function vs JAX; ``offset`` shifts the
    mean so the E[x^2] - mu^2 form is exercised away from zero."""
    rng = np.random.default_rng(5)
    x = (offset + rng.standard_normal((2, 6, 5, 16))).astype(np.float32)
    jm = jlayers.GroupNorm32(num_groups=4, epsilon=1e-6, fuse_silu=fuse_silu)
    params = _init_random(jm, 2, x)
    ref = np.asarray(jm.apply(params, x))
    tm = tlayers.GroupNorm32(4, 16, eps=1e-6, fuse_silu=fuse_silu)
    sd = {}
    convert._inv_gn32(sd, "m", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    scale, bias = params["params"]["norm"]["scale"], params["params"]["norm"]["bias"]
    fn = torch_gn(_t(x), _t(scale), _t(bias), 4, 1e-6, fuse_silu).numpy()
    np.testing.assert_allclose(fn, np.asarray(jax_gn(x, scale, bias, 4, 1e-6, fuse_silu)), rtol=1e-5, atol=1e-5)


def _gn_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (0.5 + 1.5 * rng.standard_normal((2, 8, 16, 16))).astype(np.float32)  # NHWC, H*W = 128
    scale = (1.0 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return x, scale, bias, g, jdt, tdt


@functools.lru_cache(maxsize=None)
def _pallas_group_norm(dtype: str, apply_silu: bool) -> np.ndarray:
    """The Pallas GroupNorm in interpret mode on ``_gn_inputs(21, dtype)``
    (NHWC), traced once per dtype and SiLU setting."""
    x, scale, bias, _, jdt, _ = _gn_inputs(21, dtype)
    return np.asarray(jgn.group_norm_silu_pallas(jnp.asarray(x, jdt), scale, bias, 4, 1e-5, apply_silu,
                                                 interpret=True), np.float32)


# fp32 1e-5: the kernel's y = x·w + b against the plain (x − μ)·rstd·γ + β, two
# fp32 roundings apart; bf16 2e-2: one bf16 ulp of outputs of magnitude ~2-4.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("apply_silu", [False, True])
def test_group_norm_function_matches_pallas_interpret_and_reference_vjp(dtype, tol, apply_silu):
    """The K5 autograd Function (plain version on the CPU): forward against the
    Pallas kernel in interpret mode, gradients against ``jax.vjp`` of the JAX
    reference; NHWC on the JAX side, NCHW in the port."""
    x, scale, bias, g, jdt, tdt = _gn_inputs(21, dtype)
    want = _pallas_group_norm(dtype, apply_silu)
    _, vjp = jax.vjp(lambda *a: jgn.group_norm_silu_reference(*a, 4, 1e-5, apply_silu),
                     jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(g, jdt))

    tx = _t(x).permute(0, 3, 1, 2).contiguous().to(tdt).requires_grad_()
    ts, tb = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    before = tgn.group_norm_launches
    y = tgn.group_norm_silu_diff(tx, ts, tb, 4, 1e-5, apply_silu)
    assert tgn.group_norm_launches == before  # the CPU path launches nothing
    assert y.dtype == tdt
    got = y.detach().float().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= tol
    dx, ds, db = torch.autograd.grad(y, (tx, ts, tb), _t(g).permute(0, 3, 1, 2).to(tdt))
    assert dx.dtype == tdt and ds.dtype == torch.float32
    for got_g, want_g in ((dx.float().permute(0, 2, 3, 1), jdx), (ds, jds), (db, jdb)):
        want_g = np.asarray(want_g, np.float32)
        assert np.abs(got_g.numpy() - want_g).max() <= tol * max(1.0, np.abs(want_g).max())


@pytest.mark.parametrize("fused", [False, True])
def test_group_norm32_reads_the_setting(fused, monkeypatch):
    """``GroupNorm32`` goes through the Function when ``USE_FUSED`` is on and
    through the plain version when off; on the CPU both give the same values
    and gradients."""
    monkeypatch.setattr(tgn, "USE_FUSED", fused)
    calls = []
    real = tgn._GroupNormSiluDiff.apply
    monkeypatch.setattr(tgn, "group_norm_silu_diff", lambda *a: calls.append(1) or real(*a))
    x, scale, bias, g, _, _ = _gn_inputs(22, "float32")
    m = tlayers.GroupNorm32(4, 16, fuse_silu=True)
    m.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    tx = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = m(tx)
    assert len(calls) == (1 if fused else 0)
    ref = tgn.group_norm_silu_nchw(tx, m.weight, m.bias, 4, 1e-5, True)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    got = torch.autograd.grad(y, (tx, m.weight, m.bias), _t(g).permute(0, 3, 1, 2))
    want = torch.autograd.grad(ref, (tx, m.weight, m.bias), _t(g).permute(0, 3, 1, 2))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _blocked_group_norm(x, scale, bias, groups, eps, apply_silu, cs, res_vec):
    """Plain mirror of ``csrc/group_norm.cu``'s arithmetic, for the tests: each
    (batch, group) slab cut among ``cs`` CTAs by ``slab_slices``; a CTA's fp32
    partial sums of x and x² taken over what it reads from device memory (the
    part of its run past ``res_vec`` vectors, the head, the tail) and then over
    its shared-memory copy; the partials added in rank order; mean, clamped
    variance and rstd folded into per-channel w and b; y = x·w + b (+SiLU),
    the part past ``res_vec`` read again."""
    b, c = x.shape[:2]
    cpg = c // groups
    n = x.numel() // (b * groups)
    hw = n // cpg
    vec = 16 // x.element_size()
    flat = x.reshape(b * groups, n).float()
    out = torch.empty_like(flat)
    channel = torch.arange(n) // hw
    for bg in range(b * groups):
        row = flat[bg]
        total_s = total_q = torch.zeros((), dtype=torch.float32)
        for sl in tgn.slab_slices(bg * n, n, x.element_size(), cs):
            b0, b1 = sl["body"]
            kept = min(b1, b0 + res_vec * vec)
            part_s = part_q = torch.zeros((), dtype=torch.float32)
            for lo, hi in ((kept, b1), sl["head"], sl["tail"], (b0, kept)):
                part_s = part_s + row[lo:hi].sum()
                part_q = part_q + (row[lo:hi] * row[lo:hi]).sum()
            total_s, total_q = total_s + part_s, total_q + part_q
        mean = total_s / n
        rstd = torch.rsqrt((total_q / n - mean * mean).clamp(min=0.0) + eps)
        g = bg % groups
        w = rstd * scale[g * cpg:(g + 1) * cpg].float()
        shift = bias[g * cpg:(g + 1) * cpg].float() - mean * w
        y = row * w[channel] + shift[channel]
        out[bg] = torch.nn.functional.silu(y) if apply_silu else y
    return out.reshape(x.shape).to(x.dtype)


# (cs, res_vec): one CTA holding its whole slab; four holding theirs; sixteen,
# and four that keep 3 vectors each and read the rest of their runs again
@pytest.mark.parametrize("cs,res_vec", [(1, 1 << 20), (4, 1 << 20), (16, 1 << 20), (4, 3)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("apply_silu", [False, True])
def test_group_norm_blocked_mirror_matches_pallas_interpret(dtype, tol, apply_silu, cs, res_vec):
    """The kernel's arithmetic (per-CTA partials in rank order, the re-read of
    what does not fit) against the Pallas kernel in interpret mode."""
    x, scale, bias, _, _, tdt = _gn_inputs(21, dtype)
    tx = _t(x).permute(0, 3, 1, 2).contiguous().to(tdt)
    got = _blocked_group_norm(tx, _t(scale), _t(bias), 4, 1e-5, apply_silu, cs, res_vec)
    assert got.dtype == tdt
    assert np.abs(got.float().permute(0, 2, 3, 1).numpy() - _pallas_group_norm(dtype, apply_silu)).max() <= tol


@pytest.mark.parametrize("cs,res_vec", [(1, 1 << 20), (4, 7), (16, 1 << 20)])
def test_group_norm_blocked_mirror_ragged_matches_plain_version(cs, res_vec):
    """A ragged shape (2 channels of 45² per group: every slab but the first
    starts off 16-byte alignment, so the heads and tails are not empty) in
    fp32 against the plain version."""
    rng = np.random.default_rng(23)
    x = _t(0.5 + 1.5 * rng.standard_normal((2, 8, 45, 45)))
    scale, bias = _t(1.0 + 0.1 * rng.standard_normal(8)), _t(0.1 * rng.standard_normal(8))
    for silu in (False, True):
        got = _blocked_group_norm(x, scale, bias, 4, 1e-5, silu, cs, res_vec)
        want = tgn.group_norm_silu_nchw(x, scale, bias, 4, 1e-5, silu)
        assert (got - want).abs().max().item() <= 1e-5


# (C, H, W) of GroupNorm32 at 1024² (CFG batch 2): the UNet's twelve and the
# Aggregator's five (H-concat); then a ragged one
GN_MAIN_SHAPES = [(320, 128, 128), (640, 128, 128), (960, 128, 128), (320, 64, 64), (640, 64, 64), (960, 64, 64),
                  (1280, 64, 64), (1920, 64, 64), (640, 32, 32), (1280, 32, 32), (1920, 32, 32), (2560, 32, 32),
                  (320, 256, 128), (320, 128, 64), (640, 128, 64), (640, 64, 32), (1280, 64, 32)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", GN_MAIN_SHAPES + [(320, 45, 45)])
def test_group_norm_plan_tiles_slabs_and_fits(shape, itemsize):
    """The host's launch plan at every main-path shape (bf16/fp16 and fp32):
    the CTAs' slices tile each slab exactly, head and tail included, at every
    alignment a slab can start at; 1 <= cs <= 16, above 8 only as a
    non-portable cluster; a CTA's shared memory within the card's limit; and
    in 2-byte types three CTAs (so at least two) share an SM, the grid covers
    the card and every run fits in shared memory."""
    c, h, w = shape
    b, groups = 2, 32
    n = c // groups * h * w
    plan = tgn.gn_plan(b, c, h * w, groups, itemsize)
    assert plan.cs in tgn.CLUSTER_SIZES and 1 <= plan.cs <= 16
    assert plan.non_portable == (plan.cs > tgn.PORTABLE_CLUSTER)
    assert plan.smem_bytes == plan.res_vec * 16 + 8 * (c // groups)
    assert plan.smem_bytes + tgn.STATIC_SMEM <= tgn.SMEM_PER_CTA
    vec = 16 // itemsize
    runs = []
    for bg in range(min(b * groups, 16)):  # (bg·n·itemsize) % 16 repeats within 16 slabs
        covered = []
        for r, sl in enumerate(tgn.slab_slices(bg * n, n, itemsize, plan.cs)):
            b0, b1 = sl["body"]
            assert ((bg * n + b0) * itemsize) % 16 == 0 and (b1 - b0) % vec == 0
            assert sl["head"][1] - sl["head"][0] < vec and sl["tail"][1] - sl["tail"][0] < vec
            covered += [sl["head"], sl["body"], sl["tail"]] if r == 0 or r == plan.cs - 1 else [sl["body"]]
            runs.append((b1 - b0) // vec)
        covered = sorted(rng for rng in covered if rng[1] > rng[0])
        assert covered[0][0] == 0 and covered[-1][1] == n
        assert all(prev[1] == nxt[0] for prev, nxt in zip(covered, covered[1:]))
    assert (max(runs) <= plan.res_vec) == (plan.path == "resident")
    if itemsize == 2 and shape in GN_MAIN_SHAPES:
        assert tgn.CTAS_PER_SM * (plan.smem_bytes + tgn.STATIC_SMEM + tgn.SMEM_RESERVED_PER_CTA) <= tgn.SMEM_PER_SM
        assert tgn.CTAS_PER_SM >= 2
        assert b * groups * plan.cs >= tgn.H100_SMS
        assert plan.path == "resident"


def test_group_norm_dispatch_skips_the_function_without_grad(monkeypatch):
    """Under ``torch.no_grad()`` (the restore) the dispatch calls the wrapper
    and not the autograd Function, even for inputs that require a gradient;
    with gradients on it goes through the Function. On the CPU nothing
    launches."""
    calls = []
    real = tgn._GroupNormSiluDiff.apply
    monkeypatch.setattr(tgn._GroupNormSiluDiff, "apply", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tgn, "USE_FUSED", True)
    x, scale, bias, _, _, _ = _gn_inputs(22, "float32")
    tx = _t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    ts, tb = _t(scale).requires_grad_(), _t(bias)
    before = tgn.group_norm_launches
    with torch.no_grad():
        y = tgn.group_norm_silu(tx, ts, tb, 4, 1e-5, True)
    assert not calls and y.grad_fn is None
    torch.testing.assert_close(y, tgn.group_norm_silu_nchw(tx, ts, tb, 4, 1e-5, True), rtol=0, atol=0)
    y = tgn.group_norm_silu(tx, ts, tb, 4, 1e-5, True)
    assert len(calls) == 1 and y.grad_fn is not None
    assert tgn.group_norm_launches == before



def test_only_the_vae_group_norms_skip_the_dispatch(monkeypatch):
    """No model's GroupNorms skip the dispatch any more: every
    ``GroupNorm32`` of the UNet, the Aggregator and the VAE goes through
    ``group_norm_silu`` (on the card: the fused kernel, whatever the shape
    and the dtype), none is built to bypass it, and with ``USE_FUSED`` on a VAE norm reaches the wrapper
    (on the CPU its plain version, bit for bit)."""
    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline

    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cpu")
    norms = {name: [m for m in getattr(pipe, name).modules() if isinstance(m, tlayers.GroupNorm32)]
             for name in ("unet", "aggregator", "vae")}
    assert all(norms.values())
    assert not any(hasattr(m, "use_kernel") for ms in norms.values() for m in ms)
    source = (REPO / "instantir_tpu_torch" / "models" / "vae.py").read_text()
    assert "use_kernel" not in source and "group_norm_silu_nchw" not in source

    monkeypatch.setattr(tgn, "USE_FUSED", True)
    calls, wrapped = [], []
    real, real_fused = tlayers.group_norm_silu, tgn.group_norm_silu_fused
    monkeypatch.setattr(tlayers, "group_norm_silu", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tgn, "group_norm_silu_fused", lambda *a: wrapped.append(1) or real_fused(*a))
    m = norms["vae"][0]
    x = torch.randn(1, m.weight.shape[0], 4, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = m(x)
    assert calls == [1] and wrapped == [1]
    torch.testing.assert_close(y, tgn.group_norm_silu_nchw(x, m.weight, m.bias, m.num_groups, m.eps, m.fuse_silu),
                               rtol=0, atol=0)
    m = norms["unet"][0]
    with torch.no_grad():
        m(torch.randn(1, m.weight.shape[0], 4, 4, generator=torch.Generator().manual_seed(1)))
    assert calls == [1, 1] and wrapped == [1, 1]


# (B, C, H, W, groups): a VAE-like row (4 channels a group, H·W a multiple of 512), the UNet's and the
# Aggregator's maps at a narrow width, a pad_concat map (an odd number of rows), 1024x768's deepest map (32 x 24
# = 768 pixels, not a multiple of 512), maps below 512 pixels and of odd sides, the uneven local groups of a
# model axis of 5 (7 and 6 groups of 10 channels) and groups of 8 and 16 channels
DISPATCH_SHAPES = [(1, 128, 64, 64, 32), (1, 32, 128, 128, 32), (2, 64, 32, 32, 32), (2, 64, 33, 16, 32),
                   (2, 64, 32, 24, 32), (2, 128, 16, 16, 32), (1, 32, 45, 45, 32), (2, 32, 13, 7, 32),
                   (1, 64, 16, 33, 32), (2, 70, 16, 16, 7), (2, 60, 16, 16, 6), (1, 256, 8, 8, 32),
                   (2, 8, 32, 32, 1), (1, 64, 24, 24, 8), (2, 48, 20, 20, 16)]
# |port - JAX| <= atol + rtol * |JAX|: the fp32 statistics' summation order (atol), and one ulp of the output
# where the two fp32 values round apart (rtol: 2^-7 in bf16, 2^-10 in fp16, none in fp32)
DISPATCH_TOL = {"float32": (1e-5, 0.0), "bfloat16": (1e-5, 2.0**-7), "float16": (1e-5, 2.0**-10)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", DISPATCH_SHAPES)
def test_group_norm_dispatch_takes_the_wrapper_and_matches_jax(shape, dtype, monkeypatch):
    """With ``USE_FUSED`` on, the dispatch sends every shape to the fused
    kernel's wrapper (on the card the kernel; here, a CPU tensor, its plain
    version) -- none to the plain version for its shape, where the JAX
    dispatch's TPU bounds would -- and its output matches the JAX
    ``group_norm_silu`` on the same input in every dtype."""
    b, c, h, w, groups = shape
    rng = np.random.default_rng(sum(shape))
    x = (0.5 + 1.5 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}[dtype]
    want = np.asarray(jgn.group_norm_silu(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
                                          groups, 1e-6, True).astype(jnp.float32))
    monkeypatch.setattr(tgn, "USE_FUSED", True)
    wrapped = []
    real = tgn.group_norm_silu_fused
    monkeypatch.setattr(tgn, "group_norm_silu_fused", lambda *a: wrapped.append(tuple(a[0].shape)) or real(*a))
    xt = _t(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tgn.group_norm_silu(xt, _t(scale), _t(bias), groups, 1e-6, True)
    assert wrapped == [(b, c, h, w)] and got.dtype == xt.dtype
    atol, rtol = DISPATCH_TOL[dtype]
    err = np.abs(got.float().permute(0, 2, 3, 1).numpy() - want)
    assert (err <= atol + rtol * np.abs(want)).all(), err.max()


@pytest.mark.parametrize("apply_silu", [False, True])
def test_group_norm_vae_slab_matches_pallas_interpret(apply_silu):
    """A VAE-like fp32 slab (4 channels a group over 128², the VAE's eps
    1e-6, offset and spread like its activations) through the JAX Pallas
    kernel in interpret mode against the port's plain version, which the
    card's kernel is held to (and both to fp64 in ``chip_smoke.py``)."""
    rng = np.random.default_rng(31)
    x = (2.0 + 3.0 * rng.standard_normal((1, 128, 128, 128))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = np.asarray(jgn.group_norm_silu_pallas(jnp.asarray(x), scale, bias, 32, 1e-6, apply_silu, interpret=True))
    got = tgn.group_norm_silu_nchw(_t(x).permute(0, 3, 1, 2), _t(scale), _t(bias), 32, 1e-6, apply_silu)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5


def test_vae_group_norm_shapes_are_the_dispatched_ones(monkeypatch):
    """``chip_smoke.vae_group_norm_shapes`` (the VAE's K5 launches derived
    from ``VAEConfig``) lists the calls the SDXL VAE makes to the dispatch in
    an encode at 1024² and a decode of its latents, counted on the ``meta``
    device (no memory), whole and at a model axis of 4 on rank 2 (its
    resnets' ``norm2`` at 8 of the 32 groups)."""
    import chip_smoke
    from instantir_tpu_torch.models.vae import AutoencoderKL, sdxl_vae_config
    from instantir_tpu_torch.parallel import tp as ttp

    cfg = sdxl_vae_config()
    for tp, rank in ((1, 0), (4, 2)):
        vae = AutoencoderKL(cfg, device=torch.device("meta"))
        if tp > 1:
            place = ttp._Placer(vae, None, rank, tp)
            ttp._place(vae, place)
        seen = {}

        def counted(x, scale, bias, groups, eps, silu):
            key = (x.shape[1], x.shape[2], x.shape[3], groups, silu)
            seen[key] = seen.get(key, 0) + 1
            return x

        monkeypatch.setattr(tlayers, "group_norm_silu", counted)
        monkeypatch.setattr(ttp.TPShard, "reduce", lambda self, y: y)
        for part, call, hw in (("encoder", lambda v, t: v.encoder(t), 1024), ("decoder", lambda v, t: v.decoder(t), 128)):
            seen.clear()
            chans = 3 if part == "encoder" else 4
            call(vae, torch.empty(1, chans, hw, hw, device="meta"))
            assert seen == chip_smoke.vae_group_norm_shapes(cfg, hw, hw, part, tp, rank), (part, tp)
    assert chip_smoke.vae_k5(cfg, 128, 128, "decoder") == 30 and chip_smoke.vae_k5(cfg, 1024, 1024, "encoder") == 22


def test_timestep_embedding_and_adaln(jlayers):
    rng = np.random.default_rng(6)
    ts = np.array([0, 1, 999, 500])
    # atol 1e-5: one fp32 ulp of exp() in the frequencies, times t ~ 1000,
    # moves the sinusoid's argument by ~1e-5 rad
    for dim in (8, 7):
        np.testing.assert_allclose(
            tlayers.get_timestep_embedding(torch.tensor(ts), dim).numpy(),
            np.asarray(jlayers.get_timestep_embedding(ts, dim)), rtol=0, atol=1e-5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 12)).astype(np.float32)
    jm = jlayers.AdaLayerNorm(16, lora_rank=2)
    params = _init_random(jm, 3, x, temb)
    tm = tlayers.AdaLayerNorm(16, 12, lora_rank=2)
    sd = {}
    convert._inv_lora_dense(sd, "linear", params["params"]["linear"])
    tm.load_state_dict(convert.to_torch(sd), strict=True)
    for ls in (0.0, 0.5):
        with torch.no_grad():
            got = tm(_t(x), _t(temb), ls).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(params, x, temb, lora_scale=ls)), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _qkv(rng, sq, skv, h=2, d=64, b=2):
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, skv, skv))


@pytest.mark.parametrize("sq,skv", [(77, 77), (128, 64), (256, 520)])
def test_attention_xla(sq, skv):
    q, k, v = _qkv(np.random.default_rng(7), sq, skv, d=32)
    got = tattn.attention_xla(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jattn.attention_xla(q, k, v)), rtol=1e-5, atol=1e-5)
    # the dispatcher sends every CPU call to the plain path, as the JAX one does off-TPU
    got2 = tattn.dot_product_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_array_equal(got2, got)


@functools.lru_cache(maxsize=None)
def _pallas_flash_forward(bf16: bool, sq: int, skv: int):
    """The Pallas forward in interpret mode on the seeded inputs, traced once
    per shape and dtype whatever the plain version's blocking."""
    q, k, v = _qkv(np.random.default_rng(8), sq, skv)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = jattn.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), interpret=True)
    return q, k, v, np.asarray(ref, np.float32)


# fp32 ≤ 1e-5: the same algorithm, only the blocking (64 or 128 keys here, the
# whole row in the Pallas kernel) and so the summation order differ. bf16 ≤
# 4e-3: the band docs/perf.md states for the Pallas kernel vs the XLA path --
# the blocking changes which running max each P is rounded against. skv = 592
# leaves a tail of 16 keys under 64-key blocks and of 80 under 128-key ones.
# "tf32x3": the fp32 forward kernel's numerics, 32-key tiles and every block
# product in 3xTF32 (``_tf32x3``); bf16 operands, q2 and P are exact in TF32,
# so for bf16 only the blocking differs.
@pytest.mark.parametrize("block_k", [64, 128, "tf32x3"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 4e-3)])
@pytest.mark.parametrize("sq,skv", [(256, 640), (200, 520), (200, 592)])
def test_flash_reference_matches_pallas_interpret(dtype, tol, sq, skv, block_k):
    q, k, v, ref = _pallas_flash_forward(dtype != np.float32, sq, skv)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    before = tattn.flash_attention_launches
    if block_k == 64:  # the wrapper's own choice on the CPU: the kernel's key tile
        got = tattn.flash_attention(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt))
    elif block_k == "tf32x3":
        got, _ = tattn.flash_attention_lse_reference(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), block_k=32,
                                                     matmul=_tf32x3)
    else:
        got = tattn.flash_attention_reference(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), block_k=block_k)
    assert tattn.flash_attention_launches == before  # the CPU path launches nothing
    assert got.dtype == tdt and got.shape == q.shape
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= tol, err


def _fold(x):
    """[B, S, H, D] -> the Pallas kernels' [B·H, S, D]."""
    b, s, h, d = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)


# fp32: atol 5e-5 + rtol 1e-3, the band tests/test_flash_attention_bwd.py holds
# the Pallas backward to; bf16: 2e-2 of the largest reference value (8 bits of
# mantissa; the block sizes, and so the summation order, differ).
@functools.lru_cache(maxsize=None)
def _pallas_flash_training(dtype: str):
    """The Pallas forward-with-lse and backward in interpret mode on the seeded
    inputs, traced once per dtype."""
    b, s, h, d = 1, 256, 2, 64
    q, k, v = _qkv(np.random.default_rng(9), s, s, h=h, b=b)
    g = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jo, jlse = jattn._flash_forward_lse(jq, jk, jv, d**-0.5, interpret=True)
    jgrads = jattn._flash_backward(jq, jk, jv, jo, jlse, jg, d**-0.5, interpret=True)
    return q, k, v, g, jo, jlse, jgrads


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_lse_and_backward_references_match_pallas_interpret(dtype, block_k, block_q):
    """The plain forward-with-lse and backward against the Pallas kernels in
    interpret mode, at the blockings the kernels use (64 or 128 q rows or keys
    per CTA)."""
    b, s, h, d = 1, 256, 2, 64
    q, k, v, g, jo, jlse, jgrads = _pallas_flash_training(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = d**-0.5

    tq, tk, tv, tg = (_t(x).to(tdt) for x in (q, k, v, g))
    if block_k == 64:  # the wrapper's own choice on the CPU: the kernel's key tile
        o, lse = tattn.flash_attention_lse(tq, tk, tv, scale)
    else:
        o, lse = tattn.flash_attention_lse_reference(tq, tk, tv, scale, block_k=block_k)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    want_lse = np.asarray(jlse, np.float32).reshape(b, h, s)
    grads = tattn.flash_backward_reference(tq, tk, tv, o, lse, tg, scale, block_q=block_q, block_k=block_k)

    def close(got, want):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-3)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    close(o, jo)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-4 if dtype == "float32" else 2e-2, rtol=0)
    for got, want in zip(grads, jgrads):
        assert got.dtype == tdt and got.shape == q.shape
        close(got, want)


def _xla_grads(q, k, v, g):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(tattn.attention_xla(*leaves), leaves, g)


def test_flash_backward_reference_ragged_matches_attention_xla_autograd():
    """S=200 is no multiple of the 64-wide blocks: the last block is shorter."""
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(11), 200, 200, b=1))
    g = _t(np.random.default_rng(12).standard_normal(q.shape))
    o, lse = tattn.flash_attention_lse_reference(q, k, v)
    got = tattn.flash_backward_reference(q, k, v, o, lse, g)
    for a, b in zip(got, _xla_grads(q, k, v, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=1e-3)


def _tf32x3(a, b):
    """A block product as the fp32 backward kernels take it: three TF32
    products of the split operands, small terms first."""
    (ah, al), (bh, bl) = tattn.split_tf32(a), tattn.split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _tf32x1(a, b):
    return tattn.tf32_round(a) @ tattn.tf32_round(b)


def test_tf32_round_and_split_on_the_bits():
    """Round to nearest, ties away from zero (``cvt.rna.tf32.f32``); hi + lo
    keeps x to about 2^-21 of its magnitude."""
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-11, 1.0 + 2**-12, 0.0, -0.0, 3.0e-39])
    want = [1.0, 1.0 + 2**-10, 1.0 + 2**-9, -1.0 - 2**-10, 1.0, 0.0, -0.0]
    got = tattn.tf32_round(x)
    assert got[:7].tolist() == want and (got.view(torch.int32) & 0x1FFF == 0).all()
    y = torch.from_numpy(np.random.default_rng(15).standard_normal(10_000).astype(np.float32))
    hi, lo = tattn.split_tf32(y)
    assert torch.equal(tattn.tf32_round(hi), hi) and torch.equal(tattn.tf32_round(lo), lo)
    assert ((hi.double() + lo.double() - y.double()).abs() <= y.double().abs() * 2.0**-21).all()


@pytest.mark.parametrize("sq", [256, 200])
def test_3xtf32_backward_meets_the_fp32_tolerance(sq):
    """The numerics of the fp32 backward kernels (``csrc/flash_f32.cu``),
    emulated on the CPU: the blocked dQ and dK/dV sweeps with every product
    taken as three TF32 products of split operands come within the card
    check's relative L2 of 1e-5 of an fp64 reference; with one TF32 product
    they miss it. (S = 200 is ragged: its last 64-wide block is shorter.)"""
    rng = np.random.default_rng(16)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, sq, 2, 64)).astype(np.float32)) for _ in range(4))
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tattn.attention_xla(*leaves), leaves, do.double())
    o, lse = tattn.flash_attention_lse_reference(q, k, v)

    def rel_l2(matmul):
        got = tattn.flash_backward_reference(q, k, v, o, lse, do, matmul=matmul)
        return [((a.double() - b).norm() / b.norm()).item() for a, b in zip(got, want)]

    three, one = rel_l2(_tf32x3), rel_l2(_tf32x1)
    assert max(three) <= 1e-5, three
    assert min(one) > 1e-5, one


@pytest.mark.parametrize("sq,skv", [(256, 256), (200, 328)])
def test_3xtf32_forward_meets_the_fp32_tolerance(sq, skv):
    """The numerics of the fp32 forward kernel (``csrc/flash_f32.cu``),
    emulated on the CPU: the blocked online softmax over 32-key tiles with
    both block products (q2·Kᵀ and P·V) taken as three TF32 products of split
    operands comes within the card check's relative L2 of 1e-5 of an fp64
    reference, and its log2-domain lse within 1e-5; with one TF32 product the
    output misses. (200 x 328 is ragged on both sides: the last key tile
    holds 8 keys.)"""
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((1, sq, 2, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, skv, 2, 64)).astype(np.float32)) for _ in range(2))
    want = tattn.attention_xla(q.double(), k.double(), v.double())
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 64**-0.5
    want_lse = torch.logsumexp(logits, dim=-1) * tattn.LOG2E

    def errors(matmul):
        o, lse = tattn.flash_attention_lse_reference(q, k, v, block_k=32, matmul=matmul)
        assert o.dtype == torch.float32 and lse.shape == (1, 2, sq)
        return ((o.double() - want).norm() / want.norm()).item(), (lse.double() - want_lse).abs().max().item()

    (o3, lse3), (o1, _) = errors(_tf32x3), errors(_tf32x1)
    assert o3 <= 1e-5 and lse3 <= 1e-5, (o3, lse3)
    assert o1 > 1e-5, o1


@pytest.mark.parametrize("sq,skv", [(256, 256), (200, 328)])
def test_flash_attention_diff_gradients_match_attention_xla(sq, skv):
    """The attention autograd Function (plain versions on the CPU; the kernels
    have no fp64 path, so no gradcheck): its saving and returning of tensors,
    through dq/dk/dv against autograd through ``attention_xla``, fp32."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(np.random.default_rng(13), sq, skv, b=1))
    g = _t(np.random.default_rng(14).standard_normal(q.shape))
    counts = (tattn.flash_attention_lse_launches, tattn.flash_backward_dq_launches, tattn.flash_backward_dkv_launches)
    out = tattn.flash_attention_diff(q, k, v)
    got = torch.autograd.grad(out.reshape(1, sq, -1), (q, k, v), g.reshape(1, sq, -1))  # dO arrives as a view
    assert counts == (tattn.flash_attention_lse_launches, tattn.flash_backward_dq_launches,
                      tattn.flash_backward_dkv_launches)  # the CPU path launches nothing
    np.testing.assert_allclose(out.detach().numpy(), tattn.attention_xla(q, k, v).detach().numpy(), atol=1e-5, rtol=0)
    for a, b in zip(got, _xla_grads(q, k, v, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=1e-3)
    # only the inputs that need a gradient get one
    out = tattn.flash_attention_diff(q.detach(), k, v.detach())
    (dk,) = torch.autograd.grad(out, (k,), g)
    np.testing.assert_allclose(dk.numpy(), got[1].numpy(), atol=1e-6, rtol=0)


def _c_parameters(source: str, symbol: str) -> int:
    """Parameters of the ``extern "C"`` function ``symbol`` in a CUDA source."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(symbol) + r"\s*\(([^)]*)\)\s*\{", source)
    assert m, f'no extern "C" int {symbol}(...) definition'
    return len([a for a in m.group(1).split(",") if a.strip()])


ENTRY_POINTS = {**tattn._ENTRY_POINTS, **tgn._ENTRY_POINTS}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_match_their_sources(name):
    """Every ctypes binding (the attention and GroupNorm modules') names an
    ``extern "C"`` function of its source with as many parameters as its
    ``argtypes``: a renamed or re-ordered entry point would otherwise show
    only on the card."""
    assert len(ENTRY_POINTS) == len(tattn._ENTRY_POINTS) + len(tgn._ENTRY_POINTS)
    source, symbol, argtypes = ENTRY_POINTS[name]
    assert source in tkernels.SOURCES
    text = (tkernels.CSRC / f"{source}.cu").read_text()
    assert _c_parameters(text, symbol) == len(argtypes)


@pytest.mark.parametrize("dtypes,accepted", [
    ((torch.bfloat16,) * 3, True), ((torch.float32,) * 3, True), ((torch.float16,) * 3, False),
    ((torch.float32, torch.bfloat16, torch.float32), False), ((torch.float64,) * 3, False)])
def test_flash_wrappers_take_bf16_or_fp32_of_one_dtype(dtypes, accepted):
    """The kernels' dtype rule, checked before the device: bf16 or fp32, one
    dtype for q, k and v (these CPU tensors then fail the device check)."""
    q, k, v = (torch.zeros(1, 128, 2, 64, dtype=dt) for dt in dtypes)
    match = "CUDA device" if accepted else "bfloat16 or float32"
    with pytest.raises(ValueError, match=match):
        tattn._check_flash_inputs("flash_attention", q, k, v)
    if not accepted:
        with pytest.raises(ValueError, match=str(dtypes[1]).split(".")[-1]):
            tattn._check_flash_inputs("flash_attention", q, k, v)


@pytest.mark.parametrize("name", ["fwd", "fwd_lse", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_routes_each_dtype_to_its_entry_point(name, dtype, monkeypatch):
    """``_launch`` binds the bf16 entry point for bf16 operands and its
    ``_f32`` twin of ``csrc/flash_f32.cu`` for fp32 ones, and says which ran
    (the wrappers bump that one's counter)."""
    bound, launched = [], []
    monkeypatch.setattr(tkernels, "bind", lambda source, symbol, argtypes: bound.append((source, symbol)) or symbol)
    monkeypatch.setattr(tkernels, "launch", lambda what, fn, device, args: launched.append((fn, args)))
    like = torch.zeros(1, 2, 1, 64, dtype=dtype)
    f32 = tattn._launch("test", name, like, like, 3, 0.5)
    assert f32 == (dtype == torch.float32)
    source, symbol = ("flash_f32", f"instantir_flash_{name}_f32_d64") if f32 else tattn._ENTRY_POINTS[name][:2]
    assert bound == [(source, symbol)] and launched == [(symbol, [like.data_ptr(), 3, 0.5])]


def test_fp32_flash_source_holds_simt_kernels():
    """``flash_f32.cu`` holds the three fp32 kernels (a forward with an lse
    flag, dQ, dK/dV) behind four entry points, every product on the tensor
    cores in 3xTF32, each as three calls into one accumulator, small terms
    first: the forward on ``wgmma`` tf32 (S = q2·Kᵀ as m64n32k8, P·V as
    m64n64k8, A from registers, B from shared memory; the wrappers in
    ``hopper.cuh``), with no FFMA dot product (``fmaf``) and no ``mma.sync``
    left in it; the two backward kernels on ``mma.sync`` m16n8k8 (no
    ``ldmatrix``: their operands come from shared memory by plain loads and
    are split in registers)."""
    text = (tkernels.CSRC / "flash_f32.cu").read_text()
    header = (tkernels.CSRC / "hopper.cuh").read_text()
    assert len(re.findall(r"__global__\s+void", text)) == 3
    assert len(re.findall(r'extern\s+"C"', text)) == 4
    body = text.split("#include", 1)[1]
    backward, forward = body.split("// The forward: 3xTF32 on wgmma", 1)  # the backward's helpers and kernels first
    assert "flash_fwd_f32_kernel" in forward and "flash_fwd_f32_kernel" not in backward
    assert "fmaf(" not in forward and "mma_tf32(" not in forward and "mma.sync" not in forward
    # tf32 takes no transpose flags: only the two scale immediates follow the predicate
    assert 'wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " ACC16_REGS ", {%16, %17, %18, %19}, %20, p, 1, 1;' in header
    assert 'wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACC32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1;' in header
    for shape in ("m64n32k8", "m64n64k8"):
        assert re.search(rf"wgmma_{shape}_tf32_rs\(d, a\.lo, b_hi, scale_d\);\s*wgmma_{shape}_tf32_rs\(d, a\.hi, b_lo, "
                         rf"1\);\s*wgmma_{shape}_tf32_rs\(d, a\.hi, b_hi, 1\);", forward), shape
    kernel = forward.split("flash_fwd_f32_kernel(", 1)[1]
    assert "wgmma3_rs(sacc, qf[ks]," in kernel and "wgmma3_rs(pv, pa[kk]," in kernel
    assert body.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") == 1  # one wrapper, three calls a product
    assert re.search(r"mma_tf32\(d, a\.lo, b\.hi\);\s*mma_tf32\(d, a\.hi, b\.lo\);\s*mma_tf32\(d, a\.hi, b\.hi\);", backward)
    assert "wgmma" not in backward and "ldmatrix" not in body


def test_kernel_sources_exist_and_hold_one_forward_kernel():
    """The forward source holds one kernel and the backward source two; both
    include the shared header of Hopper PTX wrappers, multiply only with
    ``wgmma`` and stream by ``cp.async`` (in the source or the header). The
    GroupNorm source holds one kernel, launched as clusters: it brings x in by
    a bulk copy and meets its peers at ``barrier.cluster``."""
    for name in tkernels.SOURCES:
        assert (tkernels.CSRC / f"{name}.cu").is_file(), name
    header = (tkernels.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in header and "cp.async" in header
    for name, kernels in (("flash_fwd", 1), ("flash_bwd", 2)):
        text = (tkernels.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text, name
        assert len(re.findall(r"__global__\s+void", text)) == kernels, name
        body = text.split("#include", 1)[1] + header
        assert "wgmma.mma_async" in body and "cp.async" in body, name
        assert "mma.sync" not in body and "ldmatrix" not in body, name
    text = (tkernels.CSRC / "group_norm.cu").read_text()
    assert len(re.findall(r"__global__\s+void", text)) == 1
    for needle in ("barrier.cluster.arrive", "barrier.cluster.wait", "cp.async.bulk.shared::cluster.global",
                   "ld.shared::cluster", "cudaLaunchAttributeClusterDimension",
                   "cudaFuncAttributeNonPortableClusterSizeAllowed", "cudaOccupancyMaxActiveClusters"):
        assert needle in text, needle
