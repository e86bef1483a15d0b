"""CPU parity of the port's int8 quantization (``ops/quant.py``, the
quantized ``LoRALinear`` / ``LoRAConv2d``, ``InstantIRPipeline.quantize``)
with the JAX package's.

Weights and scales are held to ``instantir_tpu/ops/quant.py`` bitwise, the
int8 ops within 1e-6 relative in fp32 (their int32 products exactly), the W8
layers and their input gradients within 1e-6. The tiny pipeline of
``tests/test_torch_port_restore_options.py`` (one resnet and one transformer
layer a UNet block, JAX trees from a numpy seed) is quantized in both
packages at ``MIN_SIZE`` and restored on the JAX run's own draws: one JAX
restore program per mode, of mode A (the Aggregator and the main UNet; the
previewer's UNet is the same quantized model).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.models import layers as jlayers
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
from instantir_tpu.pipeline.instantir import InstantIRPipeline as JPipeline
from instantir_tpu.pipeline.instantir import RestoreConfig as JRestoreConfig
from instantir_tpu.schedulers.diffusion import sdxl_schedule as j_sdxl_schedule
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
from instantir_tpu_torch.models.layers import LoRAConv2d, LoRALinear
from instantir_tpu_torch.models.resampler import tiny_resampler_config
from instantir_tpu_torch.models.unet import tiny_unet_config
from instantir_tpu_torch.models.vae import tiny_vae_config
from instantir_tpu_torch.ops import quant
from instantir_tpu_torch.pipeline.factory import build_pipeline
from instantir_tpu_torch.pipeline.instantir import RestoreConfig, RestoreNoise

IMAGE, LATENT, SEED = 32, 16, 11
SLIM = dict(with_ip=True, lora_rank=4, layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
# the tiny models' bases of at least this many values are quantized: the 64-wide linears and every
# 32-channel 3x3 convolution but conv_in; the 32-wide linears stay fp
MIN_SIZE = 2048
# mode A (preview_start past the end): the Aggregator and the main UNet. W8 on 2 steps with CFG 7; W8A8 on one
# step without CFG, where one activation code rounded the other way by the two packages' fp32 differences does
# not yet swamp the comparison (2 steps with CFG 7 move the port's own W8A8 latents by 6-10% for a 1e-6
# change of the VAE noise, W8's by 3e-6)
RESTORE = {"w8": dict(num_inference_steps=2, guidance_scale=7.0, preview_start=1.0),
           "w8a8": dict(num_inference_steps=1, guidance_scale=1.0, preview_start=1.0)}


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


def _jax_noise(seed, n_steps):
    """The draws of the JAX staged restore for ``PRNGKey(seed)`` as a ``RestoreNoise``."""
    key, k_vae, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    shape = (1, LATENT, LATENT, 4)
    steps = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        steps.append(jax.random.normal(sub, shape, jnp.float32))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return RestoreNoise(vae=t(jax.random.normal(k_vae, shape, jnp.float32)),
                        init=t(jax.random.normal(k_init, shape, jnp.float32)), steps=[t(s) for s in steps])


def _dense_layout(k):
    """JAX ``[in, out]`` -> the port's ``[out, in]``."""
    return np.ascontiguousarray(np.asarray(k).T)


def _conv_layout(k):
    """JAX HWIO -> the port's OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err
    return err


@pytest.fixture(scope="module")
def models():
    ucfg = j_unet_cfg(**SLIM)
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, lora_rank=2)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    unet, agg, vae, res, dino = JUNet(ucfg), JAggregator(ucfg), JVAE(vcfg), JResampler(rcfg), JDINO(dcfg)
    z = np.zeros((1, LATENT, LATENT, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(unet, 1, z, t0, text, pooled, tids, ip_hidden_states=np.zeros((1, 8, 32), np.float32)),
        "aggregator": _init_random(agg, 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(vae, 3, np.zeros((1, IMAGE, IMAGE, 3), np.float32)),
        "resampler": _init_random(res, 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(dino, 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    return dict(jax=(unet, agg, vae, res, dino), params=params, dcfg=dcfg)


@pytest.fixture(scope="module")
def base(models):
    """The port's fp32 pipeline carrying the JAX trees; tests quantize copies."""
    return _port_pipe(models)


def _port_pipe(m, dtype=torch.float32):
    tpipe = build_pipeline(tiny_unet_config(**SLIM), tiny_vae_config(), tiny_resampler_config(output_dim=32, lora_rank=2),
                           tiny_dinov2_config(), device="cpu", dtype=dtype)
    p = m["params"]
    tpipe.unet.load_state_dict(convert.to_torch(convert.export_unet(p["unet"])), strict=True)
    tpipe.aggregator.load_state_dict(convert.to_torch(convert.export_aggregator(p["aggregator"])), strict=True)
    tpipe.vae.load_state_dict(convert.to_torch(convert.export_vae(p["vae"])), strict=True)
    tpipe.resampler.load_state_dict(convert.to_torch(convert.export_resampler(p["resampler"])), strict=True)
    tpipe.image_encoder.load_state_dict(
        convert.to_torch(convert.export_dinov2(p["image_encoder"], m["dcfg"].num_layers)), strict=True)
    return tpipe


def _jquantize(tree, weight_only):
    """The JAX ``quantize_tree`` at ``MIN_SIZE``, jitted: one compile in place of an eager dispatch per kernel.
    XLA turns the division by 127 into a product with its reciprocal, so a scale can differ by an ulp from
    the eager one, which the JAX pipeline computes and the port matches bitwise; the restores carry this
    tree across into the port."""
    return jax.jit(lambda t: jquant.quantize_tree(t, min_size=MIN_SIZE, weight_only=weight_only))(tree)


def _jax_pipe(m, weight_only):
    """The JAX pipeline as ``InstantIRPipeline.quantize(MIN_SIZE, weight_only)`` leaves it."""
    unet, agg, vae, res, dino = m["jax"]
    params = {**m["params"], **{k: _jquantize(m["params"][k], weight_only) for k in ("unet", "aggregator")}}
    return JPipeline(unet, agg, vae, res, dino, j_sdxl_schedule(), params)


# ---------------------------------------------------------------------------
# weights and ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_codes_and_scales_bitwise_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    for shape, layout in (((48, 24), _dense_layout), ((3, 3, 16, 40), _conv_layout), ((1, 1, 8, 8), _conv_layout)):
        k = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        k[..., 3] = 0.0  # an all-zero output channel: scale 1e-8 / 127, codes 0
        k[..., 5] *= 1e-3
        jk = jnp.asarray(k, getattr(jnp, dtype))
        jq, js = jquant.quantize_weight(jk)
        tq, ts = quant.quantize_weight(torch.from_numpy(layout(k)).to(getattr(torch, dtype)))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), layout(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        deq = quant.dequantize_weight(tq, ts, torch.float32).numpy()
        np.testing.assert_array_equal(deq, layout(jquant.dequantize_weight(jq, js, jnp.float32)))


def test_w8a8_dense_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    x[1, 2] = 0.0  # a zero token: scale 1e-8 / 127
    kq, ks = jquant.quantize_weight(jnp.asarray(0.2 * rng.standard_normal((24, 40)), jnp.float32))
    want = np.asarray(jquant.w8a8_dense(jnp.asarray(x), kq, ks))
    got = quant.w8a8_dense(torch.from_numpy(x), torch.from_numpy(_dense_layout(kq)), torch.from_numpy(np.asarray(ks)))
    _close(got.numpy(), want, 1e-6)
    # the int32 product alone, exactly
    codes = rng.integers(-127, 128, (7, 24)).astype(np.int8)
    np.testing.assert_array_equal(
        quant.int_mm(torch.from_numpy(codes), torch.from_numpy(_dense_layout(kq))).numpy(),
        np.asarray(jax.lax.dot(jnp.asarray(codes), kq, preferred_element_type=jnp.int32)))


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0), (2, 0)])
def test_w8a8_conv_matches_jax(stride, padding):
    rng = np.random.default_rng(2 + stride + 3 * padding)
    x = rng.standard_normal((2, 9, 9, 12)).astype(np.float32)  # NHWC
    kq, ks = jquant.quantize_weight(jnp.asarray(0.1 * rng.standard_normal((3, 3, 12, 16)), jnp.float32))
    pad = [(padding, padding)] * 2
    want = np.asarray(jquant.w8a8_conv(jnp.asarray(x), kq, ks, (stride, stride), pad))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = quant.w8a8_conv(xt, torch.from_numpy(_conv_layout(kq)), torch.from_numpy(np.asarray(ks)), stride, padding)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)
    codes = rng.integers(-127, 128, (2, 9, 9, 12)).astype(np.int8)
    want_i = jax.lax.conv_general_dilated(jnp.asarray(codes), kq, (stride, stride), pad,
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                          preferred_element_type=jnp.int32)
    got_i = quant.conv_int32(torch.from_numpy(codes).permute(0, 3, 1, 2).float(), torch.from_numpy(_conv_layout(kq)),
                             stride, padding)
    np.testing.assert_array_equal(got_i.numpy().reshape(np.asarray(want_i).shape), np.asarray(want_i))


def _layer_pair(kind, mode, rng):
    """(JAX apply of x, the port layer, the JAX kernel's codes and scales) for one quantized base."""
    k = (0.2 * rng.standard_normal((24, 16) if kind == "dense" else (3, 3, 12, 16))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    kq, ks = jquant.quantize_weight(jnp.asarray(k))
    qkey = "kernel_qw" if mode == "w8" else "kernel_q"
    variables = {"params": {"bias": bias}, "quant": {qkey: kq, "kernel_scale": ks}}
    if kind == "dense":
        jmod = jlayers.QuantizableDense(16)
        layer = LoRALinear(24, 16)
        layout = _dense_layout
    else:
        jmod = jlayers.QuantizableConv(16, (3, 3), padding=[(1, 1), (1, 1)])
        layer = LoRAConv2d(12, 16, 3, padding=1)
        layout = _conv_layout
    layer.quantize_(weight_only=mode == "w8")
    with torch.no_grad():
        getattr(layer, "weight_qw" if mode == "w8" else "weight_q").copy_(torch.from_numpy(layout(kq)))
        layer.weight_scale.copy_(torch.from_numpy(np.asarray(ks)))
        layer.bias.copy_(torch.from_numpy(bias))
    return (lambda x: jmod.apply(variables, x)), layer


@pytest.mark.parametrize("kind", ["dense", "conv"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_layers_match_jax(kind, mode):
    """The port's quantized bases against ``QuantizableDense`` /
    ``QuantizableConv`` given the same codes: the output within 1e-6, and for
    W8 (differentiable in x) the input gradient of a weighted sum against
    ``jax.grad``."""
    rng = np.random.default_rng(3)
    japply, layer = _layer_pair(kind, mode, rng)
    x = rng.standard_normal((2, 5, 24) if kind == "dense" else (2, 7, 7, 12)).astype(np.float32)
    want = np.asarray(japply(jnp.asarray(x)))
    xt = torch.from_numpy(x) if kind == "dense" else torch.from_numpy(x).permute(0, 3, 1, 2)
    xt.requires_grad_(mode == "w8")
    y = layer(xt)
    got = y if kind == "dense" else y.permute(0, 2, 3, 1)
    _close(got.detach().numpy(), want, 1e-6)
    if mode == "w8":  # the backward keeps the int8 codes and the scales, not a dequantized weight
        assert {t.dtype for t in y.grad_fn.saved_tensors} == {torch.int8, torch.float32}
        assert min(t.numel() for t in y.grad_fn.saved_tensors) == 16
        w = rng.standard_normal(want.shape).astype(np.float32)
        jgrad = jax.grad(lambda v: jnp.sum(japply(v) * w))(jnp.asarray(x))
        (got * torch.from_numpy(w)).sum().backward()
        tgrad = xt.grad if kind == "dense" else xt.grad.permute(0, 2, 3, 1)
        _close(tgrad.numpy(), np.asarray(jgrad), 1e-6)


# ---------------------------------------------------------------------------
# quantize_tree and the JAX tree carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,weight_only,dtype", [("unet", False, torch.float32), ("aggregator", True, torch.bfloat16)])
def test_quantize_tree_threshold_and_exclude_match_jax(models, base, model, weight_only, dtype):
    """The port's walk quantizes the same bases as the JAX ``quantize_tree``
    (threshold ``MIN_SIZE``, the ``to_k_ip`` bases excluded), and the state
    dict equals the JAX tree carried across (``convert.export_quantized``)
    leaf by leaf: codes and scales bitwise, fp leaves exactly (the aggregator
    in bf16: both packages quantize the bf16 weights)."""
    export = getattr(convert, f"export_{model}")
    tree = models["params"][model]
    if dtype == torch.bfloat16:  # the kernels in bf16, as the port's bf16 model holds them
        tree = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(a, jnp.bfloat16) if str(getattr(path[-1], "key", "")) == "kernel" else a, tree)
    jtree = jquant.quantize_tree(tree, min_size=MIN_SIZE, weight_only=weight_only,
                                 exclude=lambda path: "to_k_ip" in path)
    host = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a), jtree)
    want = convert.export_quantized(export, host)
    port = getattr(copy.deepcopy(base) if dtype == torch.float32 else _port_pipe(models, dtype), model)
    quant.quantize_tree(port, min_size=MIN_SIZE, weight_only=weight_only, exclude=lambda path: "to_k_ip" in path)
    got = port.state_dict()
    assert set(got) == set(want)
    key = "weight_qw" if weight_only else "weight_q"
    quantized = [k for k in got if k.endswith("." + key)]
    assert quantized and not any(k.endswith(".weight_q" if weight_only else ".weight_qw") for k in got)
    assert not any("to_k_ip" in k for k in quantized)
    assert any("to_v_ip" in k for k in quantized) == (model == "unet")
    for k, v in got.items():
        w = want[k]
        if v.dtype == torch.int8:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:  # an fp leaf in the port's dtype (norms stay fp32 in a bf16 model)
            np.testing.assert_array_equal(v.float().numpy(), torch.from_numpy(np.asarray(w, np.float32)).to(v.dtype)
                                          .float().numpy(), err_msg=k)
    n_q, total = quant.quantized_bytes(port)
    assert n_q == sum(got[k].numel() for k in quantized) and total == sum(
        t.numel() * t.element_size() for t in got.values())


# ---------------------------------------------------------------------------
# the quantized restore on the JAX draws
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.standard_normal((1, 7, 32)).astype(np.float32),
            rng.standard_normal((1, 16)).astype(np.float32))


def _restores(models, base, inputs, weight_only, carry: bool):
    """(JAX latents, port latents, port pipeline) of the quantized restore on
    the JAX draws. ``carry``: the port takes the JAX-quantized trees
    (``convert.export_quantized`` / ``load_quantized``) instead of quantizing
    its own weights (which ``test_quantize_tree_threshold_and_exclude_match_jax``
    holds to the JAX codes bitwise)."""
    lq, pe, pp = inputs
    cfg = RESTORE["w8" if weight_only else "w8a8"]
    jpipe = _jax_pipe(models, weight_only)
    jlat, _ = jpipe.restore(lq, pe, pp, cfg=JRestoreConfig(**cfg), key=jax.random.PRNGKey(SEED), output_type="latent")
    tpipe = copy.deepcopy(base)
    if carry:
        for name in ("unet", "aggregator"):
            tree = jax.tree_util.tree_map(np.asarray, jpipe.params[name])
            convert.load_quantized(getattr(tpipe, name),
                                   convert.export_quantized(getattr(convert, f"export_{name}"), tree))
    else:
        tpipe.quantize(min_size=MIN_SIZE, weight_only=weight_only)
    tlat, _ = tpipe.restore(*(torch.from_numpy(a) for a in inputs), cfg=RestoreConfig(**cfg),
                            noise=_jax_noise(SEED, cfg["num_inference_steps"]), output_type="latent")
    return np.asarray(jlat), tlat.numpy(), tpipe


def test_w8_restore_matches_jax(models, base, inputs):
    """W8 is the ordinary op on dequantized weights: the unquantized restore
    test's tolerance, 1e-4 of the latents' scale. The port runs the JAX
    package's own quantized trees, carried across."""
    jlat, tlat, tpipe = _restores(models, base, inputs, True, carry=True)
    assert tpipe.quantized == "w8"
    _close(tlat, jlat, 1e-4)


def test_w8a8_restore_matches_jax(models, base, inputs, monkeypatch):
    """W8A8 on both sides: the int8 products are exact, but an activation
    that the two packages' fp32 ops put within their difference (1e-6
    relative) of a rounding edge can round to the other code, and later
    layers carry the step. Measured: 4.0e-3 of the latents' scale; the
    tolerance is the cap, 1e-2 (10x the measured error would be 4.0e-2).
    The message counts the port's codes that lay that near an edge."""
    near, total = [0], [0]
    act = quant._quant_act

    def counted(x, dims):
        codes, scale = act(x, dims)
        r = (x.float() / scale).abs()
        near[0] += int(((r - r.floor() - 0.5).abs() <= 1e-6 * r).sum())
        total[0] += r.numel()
        return codes, scale

    monkeypatch.setattr(quant, "_quant_act", counted)
    jlat, tlat, tpipe = _restores(models, base, inputs, False, carry=True)
    assert tpipe.quantized == "w8a8"
    err = np.abs(tlat - jlat).max() / max(1.0, np.abs(jlat).max())
    assert np.isfinite(tlat).all() and err <= 1e-2, (
        f"relative error {err:.3e}; {near[0]} of {total[0]} activation codes within 1e-6 of a rounding edge")


# ---------------------------------------------------------------------------
# the pipeline's guards, save/load, the CLIs
# ---------------------------------------------------------------------------


def test_quantize_guards_and_idempotence(base, inputs):
    tpipe = copy.deepcopy(base)
    frozen = copy.deepcopy(tpipe).freeze_previewer(1.0)
    with pytest.raises(ValueError, match=r"quantize\(\) after freeze_previewer"):
        frozen.quantize(min_size=MIN_SIZE)
    tpipe.quantize(min_size=MIN_SIZE, weight_only=True)
    before = {k: v.clone() for k, v in tpipe.unet.state_dict().items()}
    assert tpipe.quantize(min_size=1, weight_only=False) is tpipe and tpipe.quantized == "w8"
    assert all(torch.equal(before[k], v) for k, v in tpipe.unet.state_dict().items())
    with pytest.raises(ValueError, match="quantized pipeline"):
        tpipe.freeze_previewer(1.0)
    with pytest.raises(ValueError, match="fuse_previewer_lora"):
        tpipe.restore(*(torch.from_numpy(a) for a in inputs),
                      cfg=RestoreConfig(num_inference_steps=1, fuse_previewer_lora=True))
    assert not any(isinstance(m, (LoRALinear, LoRAConv2d)) and m.quant_mode is not None
                   for m in (tpipe.vae, tpipe.image_encoder, tpipe.resampler) for m in m.modules())


@pytest.mark.parametrize("weight_only", [True, False])
def test_save_and_load_params_carry_the_int8_buffers(base, inputs, tmp_path, weight_only):
    """``save_params`` of a quantized pipeline, ``load_params`` into an
    unquantized one: the bases are quantized in the file's mode and every
    tensor comes back bitwise; the restores are equal."""
    src = copy.deepcopy(base).quantize(min_size=MIN_SIZE, weight_only=weight_only)
    src.save_params(str(tmp_path))
    dst = copy.deepcopy(base)
    with torch.no_grad():
        for p in dst.unet.parameters():
            p.mul_(0.5)
    dst.load_params(str(tmp_path))
    assert dst.quantized == src.quantized
    for name in ("unet", "aggregator"):
        a, b = getattr(src, name).state_dict(), getattr(dst, name).state_dict()
        assert set(a) == set(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    cfg = RestoreConfig(num_inference_steps=1)
    args = [torch.from_numpy(a) for a in inputs]
    assert torch.equal(src.restore(*args, cfg=cfg, output_type="latent")[0],
                       dst.restore(*args, cfg=cfg, output_type="latent")[0])


def _fake_encode(encoders, prompts, device):
    n = len(prompts)
    return torch.zeros((n, 7, 32)), torch.zeros((n, 16))


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_cli_infer_quantized_on_the_cpu(base, tmp_path, monkeypatch, mode):
    """``cli.infer.main --quantized`` quantizes the pipeline it is given in
    the flag's mode and writes the image (text encoding stubbed: the tiny
    pipeline takes 32-wide embeddings)."""
    from PIL import Image

    from instantir_tpu_torch.cli import infer

    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", MIN_SIZE)
    monkeypatch.setattr(infer, "encode_prompts", _fake_encode)
    src, out = tmp_path / "lq", tmp_path / "out"
    src.mkdir()
    Image.fromarray((np.random.default_rng(5).uniform(size=(64, 64, 3)) * 255).astype(np.uint8)).save(src / "a.png")
    pipe = copy.deepcopy(base)
    argv = ["--sdxl_path", "s", "--instantir_path", "i", "--vision_encoder_path", "v", "--test_path", str(src),
            "--out_path", str(out), "--min_side", "64", "--max_side", "64", "--num_inference_steps", "1",
            "--quantized", mode]
    records = infer.main(argv, device="cpu", models=(pipe, None))
    assert pipe.quantized == mode and records[0]["files"] == ["a.png"]
    assert Image.open(out / "a.png").size == (64, 64)


def test_cli_serve_quantized_on_the_cpu(base, monkeypatch):
    """``cli.serve.main --quantized w8`` quantizes the loaded pipeline before
    the server is built (loading, the server and the HTTP layer stubbed)."""
    import signal

    from instantir_tpu_torch.cli import serve
    from instantir_tpu_torch.pipeline import load

    monkeypatch.setattr(quant, "DEFAULT_MIN_SIZE", MIN_SIZE)
    pipe = copy.deepcopy(base)
    seen = {}

    class Server:
        def __init__(self, p, encode, cfg):
            seen.update(mode=p.quantized, budget=serve.estimate_hbm_budget(p, (32,), {32: 1}, limit_gb=100.0))
            self.buckets, self._bucket_batch, self.requests_served = (32,), {32: 1}, 0

        def start(self, warmup=True):
            return self

        def drain(self):
            pass

    class Httpd:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(load, "load_instantir_pipeline", lambda *a, **k: pipe)
    monkeypatch.setattr(load, "load_text_encoders", lambda *a, **k: None)
    monkeypatch.setattr(serve, "RestoreServer", Server)
    monkeypatch.setattr(serve, "make_http_server", lambda *a, **k: Httpd())
    monkeypatch.setattr(signal, "signal", lambda *a, **k: None)
    bf16_budget = serve.estimate_hbm_budget(base, (32,), {32: 1}, limit_gb=100.0)
    serve.main(["--sdxl_path", "s", "--instantir_path", "i", "--vision_encoder_path", "v", "--quantized", "w8"],
               device="cpu")
    assert seen["mode"] == "w8"
    assert seen["budget"]["params_gb"] < bf16_budget["params_gb"]
