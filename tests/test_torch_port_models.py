"""CPU parity of the PyTorch port's models with their JAX twins at the tiny configs.

Each JAX parameter tree has the structure of the JAX module's ``init`` (taken
abstractly with ``jax.eval_shape``) and every leaf drawn from a numpy seed, so
the LoRA-B, zero-conv, AdaLN and bias leaves that ``init`` zeroes are nonzero
and their paths really run. The tree goes through the port's ``convert.py``
and ``load_state_dict(strict=True)``. Inputs are numpy draws fed to both; the
JAX side is NHWC, the port's modules NCHW. fp32 throughout: the tolerances
(stated per test) cover summation-order differences only.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from instantir_tpu.models import attention as jattn_mod
from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import preprocess_dinov2 as jpreprocess
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu_torch import convert
from instantir_tpu_torch.models.aggregator import Aggregator
from instantir_tpu_torch.models.attention import Attention
from instantir_tpu_torch.models.dinov2 import DINOv2Model, _keys_cubic, _resize_matrix, preprocess_dinov2, tiny_dinov2_config
from instantir_tpu_torch.models.resampler import Resampler, tiny_resampler_config
from instantir_tpu_torch.models.unet import UNet2DConditionModel, down_stack_channels, tiny_unet_config
from instantir_tpu_torch.models.vae import AutoencoderKL, tiny_vae_config


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


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


def _max_rel_err(got, ref):
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


B = 2
UCFG = dict(with_ip=True, lora_rank=4)


@pytest.fixture(scope="module")
def cond_inputs():
    rng = np.random.default_rng(0)
    return dict(
        t=np.array([10, 700]),
        text=rng.standard_normal((B, 7, 32)).astype(np.float32),
        pooled=rng.standard_normal((B, 16)).astype(np.float32),
        time_ids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (B, 1)),
        ip=rng.standard_normal((B, 8, 32)).astype(np.float32),
        x=rng.standard_normal((B, 16, 16, 4)).astype(np.float32),
        ref=rng.standard_normal((B, 16, 16, 4)).astype(np.float32),
    )


# --------------------------------------------------------------------------
# attention modes
# --------------------------------------------------------------------------

# (cross, with_ip, time_aware_ip): plain self-attention, decoupled IP, TA-IP
ATTN_MODES = {"plain": (False, False, False), "ip": (True, True, False), "ta_ip": (True, True, True)}


@pytest.mark.parametrize("mode", list(ATTN_MODES))
def test_attention_modes(mode):
    cross, with_ip, ta = ATTN_MODES[mode]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 12, 16)).astype(np.float32)
    ctx = rng.standard_normal((B, 7, 24)).astype(np.float32) if cross else None
    ip = rng.standard_normal((B, 5, 24)).astype(np.float32) if with_ip else None
    temb = rng.standard_normal((B, 20)).astype(np.float32) if ta else None
    jm = jattn_mod.Attention(16, heads=2, head_dim=8, cross_attention_dim=24 if cross else None, with_ip=with_ip,
                             time_aware_ip=ta, lora_rank=2)
    kw = dict(encoder_hidden_states=ctx, ip_hidden_states=ip, temb=temb)
    params = _init_random(jm, 2, x, **kw)
    tm = Attention(16, 2, 8, cross_attention_dim=24 if cross else None, with_ip=with_ip, time_aware_ip=ta,
                   temb_dim=20 if ta else None, lora_rank=2)
    sd = {}
    convert._inv_attention(sd, "m", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    tkw = {k: (None if v is None else _t(v)) for k, v in kw.items()}
    for ls in (0.0, 0.6):
        ref = np.asarray(jm.apply(params, x, lora_scale=ls, **kw))
        with torch.no_grad():
            got = tm(_t(x), lora_scale=ls, **tkw).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# UNet and Aggregator
# --------------------------------------------------------------------------


def test_unet_forward_with_residuals_and_lora(cond_inputs):
    """Tiny UNet with IP tokens, additive ControlNet residuals and the
    previewer LoRA at 0.75. Tolerance 1e-4 of the output's scale: ~40 fp32
    layers deep, the sums run in another order."""
    c = cond_inputs
    rng = np.random.default_rng(3)
    jcfg, tcfg = j_unet_cfg(**UCFG), tiny_unet_config(**UCFG)
    sizes = [16, 16, 16, 8, 8, 8, 4, 4, 4]
    residuals = [rng.standard_normal((B, s, s, ch)).astype(np.float32) * 0.5
                 for s, ch in zip(sizes, down_stack_channels(tcfg))]
    mid = rng.standard_normal((B, 4, 4, 64)).astype(np.float32) * 0.5
    jm = JUNet(jcfg)
    args = (c["x"], c["t"], c["text"], c["pooled"], c["time_ids"])
    params = _init_random(jm, 4, *args, ip_hidden_states=c["ip"])
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        p, *args, ip_hidden_states=c["ip"], down_block_additional_residuals=tuple(residuals),
        mid_block_additional_residual=mid, lora_scale=0.75))(params))

    tm = UNet2DConditionModel(tcfg)
    tm.load_state_dict(convert.to_torch(convert.export_unet(params)), strict=True)
    with torch.no_grad():
        got = tm(_nchw(c["x"]), torch.tensor(c["t"]), _t(c["text"]), _t(c["pooled"]), _t(c["time_ids"]),
                 ip_hidden_states=_t(c["ip"]), down_block_additional_residuals=[_nchw(r) for r in residuals],
                 mid_block_additional_residual=_nchw(mid), lora_scale=0.75)
    assert _max_rel_err(_nhwc(got), ref) <= 1e-4


def test_aggregator_forward(cond_inputs):
    """H-concat stems, attn2-less trunk, SFT heads, conditioning_scale 0.8."""
    c = cond_inputs
    jm = JAggregator(j_unet_cfg(**UCFG))
    kw = dict(added_text_embeds=c["pooled"], added_time_ids=c["time_ids"])
    params = _init_random(jm, 5, c["x"], c["t"], c["ref"], **kw)
    jdown, jmid = jax.jit(lambda p: jm.apply(p, c["x"], c["t"], c["ref"], conditioning_scale=0.8, **kw))(params)

    tm = Aggregator(tiny_unet_config(**UCFG))
    tm.load_state_dict(convert.to_torch(convert.export_aggregator(params)), strict=True)
    with torch.no_grad():
        down, mid = tm(_nchw(c["x"]), torch.tensor(c["t"]), _nchw(c["ref"]), _t(c["pooled"]), _t(c["time_ids"]),
                       conditioning_scale=0.8)
    assert len(down) == len(jdown) == 9
    for g, r in zip(down + (mid,), tuple(jdown) + (jmid,)):
        assert _nhwc(g).shape == np.asarray(r).shape
        assert _max_rel_err(_nhwc(g), np.asarray(r)) <= 1e-4


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------


def test_vae_encode_with_noise_and_decode():
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jm = JVAE(j_vae_cfg())
    params = _init_random(jm, 6, x)
    key = jax.random.PRNGKey(3)
    jz = np.asarray(jm.apply(params, x, rng=key, sample=True, method=jm.encode))
    noise = np.asarray(jax.random.normal(key, jz.shape, np.float32))  # the draw encode makes
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    jimg = np.asarray(jm.apply(params, z, method=jm.decode))

    tm = AutoencoderKL(tiny_vae_config())
    tm.load_state_dict(convert.to_torch(convert.export_vae(params)), strict=True)
    with torch.no_grad():
        tz = tm.encode(_nchw(x), noise=_nchw(noise))
        timg = tm.decode(_nchw(z))
    assert _max_rel_err(_nhwc(tz), jz) <= 1e-5
    assert _max_rel_err(_nhwc(timg), jimg) <= 1e-5


def test_dinov2_and_preprocess():
    rng = np.random.default_rng(7)
    cfg = j_dino_cfg()
    images = rng.uniform(0, 1, (B, 40, 36, 3)).astype(np.float32)
    jpix = np.asarray(jpreprocess(images, size=cfg.image_size))
    tpix = preprocess_dinov2(_t(images), size=cfg.image_size).numpy()
    np.testing.assert_allclose(tpix, jpix, rtol=1e-5, atol=1e-5)

    jm = JDINO(cfg)
    params = _init_random(jm, 7, jpix)
    ref = np.asarray(jm.apply(params, jpix))
    tm = DINOv2Model(tiny_dinov2_config())
    tm.load_state_dict(convert.to_torch(convert.export_dinov2(params, cfg.num_layers)), strict=True)
    with torch.no_grad():
        got = tm(_nchw(jpix)).numpy()
    assert got.shape == ref.shape == (B, 5, 16)
    assert _max_rel_err(got, ref) <= 1e-5


def test_dinov2_fed_224_at_native_28_matches_jax():
    """The trainers feed 224² pixels whatever the native grid: at the tiny
    config's own ``image_size`` 28 (a 2x2 grid grown to 16x16) the position
    embeddings are resized bicubically in both frameworks."""
    rng = np.random.default_rng(9)
    cfg = j_dino_cfg()
    pix = rng.standard_normal((B, 224, 224, 3)).astype(np.float32)
    jm = JDINO(cfg)
    params = _init_random(jm, 9, pix[:1, :cfg.image_size, :cfg.image_size])
    ref = np.asarray(jm.apply(params, pix))
    tm = DINOv2Model(tiny_dinov2_config())
    tm.load_state_dict(convert.to_torch(convert.export_dinov2(params, cfg.num_layers)), strict=True)
    with torch.no_grad():
        got = tm(_nchw(pix)).numpy()
    assert got.shape == ref.shape == (B, 257, 16)
    assert _max_rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("n_in,n_out", [(2, 16), (16, 37), (16, 5), (37, 16), (5, 7), (7, 3)])
def test_cubic_resize_matrix_matches_jax_image_resize(n_in, n_out):
    """The [out, in] weights of ``jax.image.resize(method="cubic")`` along one
    axis, upsampling and (antialiased) downsampling: the resize of the
    identity is the weight matrix."""
    want = np.asarray(jax.image.resize(np.eye(n_in, dtype=np.float32), (n_out, n_in), method="cubic"))
    np.testing.assert_allclose(_resize_matrix(n_in, n_out, _keys_cubic), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("lora_scale", [0.0, 0.5])
def test_resampler(lora_scale):
    rng = np.random.default_rng(8)
    tokens = rng.standard_normal((B, 5, 16)).astype(np.float32)
    jm = JResampler(j_res_cfg(output_dim=32, lora_rank=2))
    params = _init_random(jm, 8, tokens)
    ref = np.asarray(jm.apply(params, tokens, lora_scale=lora_scale))
    tm = Resampler(tiny_resampler_config(output_dim=32, lora_rank=2))
    tm.load_state_dict(convert.to_torch(convert.export_resampler(params)), strict=True)
    with torch.no_grad():
        got = tm(_t(tokens), lora_scale=lora_scale).numpy()
    assert got.shape == ref.shape == (B, 8, 32)
    assert _max_rel_err(got, ref) <= 1e-5
