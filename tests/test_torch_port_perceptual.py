"""CPU parity of the port's perceptual losses, their towers, the face
utilities and the face dataset with their JAX twins.

Random weights at the tiny configs (the published checkpoint names where a
module loads them: ``lpips.LPIPS(net='vgg')``, InsightFace IR-SE50,
facenet_pytorch MTCNN; the JAX trees through ``convert.py`` otherwise),
inputs drawn with numpy from a seed. Forwards are held to 1e-5 relative L2,
each loss's gradient with respect to ``pred_image`` to ``jax.grad`` within
1e-5 + 1e-3 of its largest value, the augmentations fed the JAX run's own
homographies and flags to 1e-5, and the numpy host code (the MTCNN box
helpers, ``similarity_transform``, the dataset) bitwise.
"""

from __future__ import annotations

import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantir_tpu.data import face_dataset as jface_dataset
from instantir_tpu.losses import augmentations as jaug
from instantir_tpu.losses import losses as jlosses
from instantir_tpu.losses.arcface import ArcFaceBackbone as JArcFace
from instantir_tpu.losses.arcface import convert_arcface
from instantir_tpu.losses.lpips import LPIPS as JLPIPS
from instantir_tpu.losses.lpips import convert_lpips
from instantir_tpu.models import clip_vision as jclip
from instantir_tpu.models.clip_text import CLIPTextModel as JCLIPText
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.utils import face as jface
from instantir_tpu.utils import mtcnn as jmtcnn
from instantir_tpu.convert import flax_to_torch as f2t
from instantir_tpu_torch import convert
from instantir_tpu_torch.data import face_dataset as tface_dataset
from instantir_tpu_torch.losses import augmentations as taug
from instantir_tpu_torch.losses import losses as tlosses
from instantir_tpu_torch.losses.arcface import ArcFaceBackbone, import_arcface, tiny_arcface_config
from instantir_tpu_torch.losses.loss_config import SingleLossConfig
from instantir_tpu_torch.losses.lpips import LPIPS, tiny_lpips_config
from instantir_tpu_torch.models import clip_vision as tclip
from instantir_tpu_torch.models.clip_text import tiny_clip_text_config
from instantir_tpu_torch.models.dinov2 import DINOv2Model, tiny_dinov2_config
from instantir_tpu_torch.utils import face as tface
from instantir_tpu_torch.utils import mtcnn as tmtcnn

REPO = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-5


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


def _init_random(module, seed, *args):
    return _random_tree(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)), seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _value_close(got: float, want: float):
    """A loss value: 1e-5 of its terms' scale, at least 1 (``1 − cos`` of
    nearly parallel embeddings is a difference of O(1) terms)."""
    assert abs(got - want) <= FWD_TOL * max(1.0, abs(want)), (got, want)


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 0
    err = np.abs(got - want).max()
    assert err <= 1e-5 + 1e-3 * np.abs(want).max(), (err, np.abs(want).max())


def _port_loss_and_grad(loss, x, **inputs):
    """(value, d value / d pred_image) of a port loss at NHWC numpy ``x``."""
    xt = _t(x).requires_grad_(True)
    val = loss(tlosses.DiffusionLossInputs(predicted=xt, target=xt, pred_image=xt, **inputs))
    val.backward()
    return float(val.detach()), xt.grad.numpy()


def _jax_loss_and_grad(loss, x, **inputs):
    def f(img):
        return loss(jlosses.DiffusionLossInputs(predicted=img, target=img, pred_image=img, **inputs))

    val, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(x))  # one compile: far fewer than eager op by op
    return float(val), np.asarray(g)


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_vision():
    """(config, JAX CLIPVisionModel tree, port CLIPVisionModel with its weights)."""
    cfg = jclip.tiny_clip_vision_config()
    tree = _init_random(jclip.CLIPVisionModel(cfg), 1, np.zeros((1, 32, 32, 3), np.float32))
    model = tclip.CLIPVisionModel(tclip.tiny_clip_vision_config())
    model.load_state_dict(convert.to_torch(convert.export_clip_vision(tree, cfg.num_layers)), strict=True)
    return cfg, tree, model.eval()


def test_clip_vision_model_matches_jax(clip_vision):
    cfg, tree, model = clip_vision
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    j_tokens, j_proj = jclip.CLIPVisionModel(cfg).apply(tree, x)
    with torch.no_grad():
        tokens, proj = model(_t(x).permute(0, 3, 1, 2))
    assert tokens.shape == (2, 17, 16) and proj.shape == (2, 8)
    assert _rel_l2(tokens.numpy(), j_tokens) <= FWD_TOL
    assert _rel_l2(proj.numpy(), j_proj) <= FWD_TOL


@pytest.mark.parametrize("hw", [32, 40])
def test_clip_image_encoder_matches_jax(hw):
    """The penultimate layer's tokens after the ImageNet -> CLIP
    re-normalization, on the config's grid and off it (the re-resize)."""
    cfg = jclip.tiny_clip_vision_config(num_layers=3)
    tree = _init_random(jclip.CLIPImageEncoder(cfg), 2, np.zeros((1, 32, 32, 3), np.float32))
    enc = tclip.CLIPImageEncoder(tclip.tiny_clip_vision_config(num_layers=3))
    enc.load_state_dict(convert.to_torch(convert.export_clip_image_encoder(tree, cfg.num_layers)), strict=True)
    assert len(enc.vision_model.encoder.layers) == 2 and not hasattr(enc.vision_model, "post_layernorm")
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32)
    want = jclip.CLIPImageEncoder(cfg).apply(tree, x)
    with torch.no_grad():
        got = enc(_t(x).permute(0, 3, 1, 2))
    assert _rel_l2(got.numpy(), want) <= FWD_TOL


def test_hf_clip_vision_state_dict_reads_into_the_image_encoder(clip_vision):
    """A whole ``CLIPVisionModelWithProjection`` state dict in HF names
    (``pre_layrnorm``, the last layer, ``post_layernorm`` and the projection
    included) through ``import_clip_vision`` against the JAX
    ``convert_clip_image_encoder`` of the same dict: the encoder takes the
    first ``num_layers - 1`` layers and passes the rest over."""
    cfg, tree, _ = clip_vision
    sd = convert.export_clip_vision(tree, cfg.num_layers)
    assert "vision_model.pre_layrnorm.weight" in sd and "visual_projection.weight" in sd
    enc = tclip.CLIPImageEncoder(tclip.tiny_clip_vision_config())
    names = [n for n, _ in enc.named_parameters()]
    enc.load_state_dict(convert.to_torch(convert.import_clip_vision(sd, names)), strict=True)
    assert not [n for n in names if "layers.1." in n or "post_layernorm" in n]
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    want = jclip.CLIPImageEncoder(cfg).apply(jclip.convert_clip_image_encoder(sd, cfg), x)
    with torch.no_grad():
        got = enc(_t(x).permute(0, 3, 1, 2))
    assert _rel_l2(got.numpy(), want) <= FWD_TOL
    with pytest.raises(KeyError, match="lacks"):
        convert.import_clip_vision({k: v for k, v in sd.items() if "pre_layrnorm" not in k}, names)


def test_preprocess_clip_matches_jax():
    x = np.random.default_rng(3).uniform(size=(2, 40, 36, 3)).astype(np.float32)
    want = jclip.preprocess_clip(jnp.asarray(x), size=32)
    got = tclip.preprocess_clip(_t(x), size=32)
    assert _rel_l2(got.numpy(), want) <= FWD_TOL


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------


def _lpips_sd(rng, cfg):
    """A state dict in the published ``lpips.LPIPS(net='vgg')`` names."""
    sd, in_ch = {}, 3
    for si, (conv_ids, ch) in enumerate(zip(cfg.slices, cfg.channels)):
        for ci in conv_ids:
            sd[f"net.slice{si + 1}.{ci}.weight"] = rng.normal(size=(ch, in_ch, 3, 3)).astype(np.float32) * 0.2
            sd[f"net.slice{si + 1}.{ci}.bias"] = rng.normal(size=(ch,)).astype(np.float32) * 0.1
            in_ch = ch
        sd[f"lin{si}.model.1.weight"] = np.abs(rng.normal(size=(1, ch, 1, 1)).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def lpips_sd():
    return _lpips_sd(np.random.default_rng(4), tiny_lpips_config())


def test_lpips_matches_jax(lpips_sd):
    cfg = tiny_lpips_config()
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    jtree = convert_lpips(lpips_sd, cfg)
    want = JLPIPS(cfg).apply(jtree, x, y)
    model = LPIPS(cfg)
    model.load_state_dict(convert.to_torch(lpips_sd), strict=True)
    with torch.no_grad():
        got = model(_t(x), _t(y))
    assert _rel_l2(got.numpy(), want) <= FWD_TOL
    exported = convert.export_lpips(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert set(exported) == set(lpips_sd)
    for k, v in lpips_sd.items():
        np.testing.assert_array_equal(exported[k], v)


def test_lpips_loss_gradient_matches_jax(lpips_sd):
    cfg = tiny_lpips_config()
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    jl = jlosses.LPIPSLoss(params=convert_lpips(lpips_sd, cfg), config=cfg)
    tl = tlosses.LPIPSLoss(params=convert.to_torch(lpips_sd), config=cfg, device="cpu")
    j_val, j_g = _jax_loss_and_grad(jl, x, target_image=jnp.asarray(y))
    t_val, t_g = _port_loss_and_grad(tl, x, target_image=_t(y))
    _value_close(t_val, j_val)
    _grad_close(t_g, j_g)
    same = tl(tlosses.DiffusionLossInputs(predicted=_t(x), target=_t(x), pred_image=_t(x), target_image=_t(x)))
    assert float(same) < 1e-10


# ---------------------------------------------------------------------------
# Augmentations and CLIPLoss
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draw_arrays(key, n_aug: int, size: int, p=0.7, degrees=15.0, translate=0.1, distortion=0.7):
    """The homographies and flags ``jaug.image_augmentations`` draws for
    ``key``: its own key splits and samplers, vmapped as it vmaps them."""
    def one(k):
        ka, kap, kp, kpp = jax.random.split(k, 4)
        return (jaug._affine_homography(ka, size, size, degrees, translate), jax.random.uniform(kap, ()) < p,
                jaug._perspective_homography(kp, size, size, distortion), jax.random.uniform(kpp, ()) < p)

    return jax.vmap(one)(jax.random.split(key, n_aug))


def _jax_draws(key, n_aug: int, size: int) -> "taug.AugmentationDraws":
    aff, use_aff, per, use_per = (np.asarray(a) for a in _jax_draw_arrays(key, n_aug, size))
    return taug.AugmentationDraws(affine=_t(aff), use_affine=torch.from_numpy(use_aff), perspective=_t(per),
                                  use_perspective=torch.from_numpy(use_per))


AUG_KEY = 3


def test_image_augmentations_match_jax_on_its_draws():
    """Resize + affine (border fill) + perspective (zero fill), fed the JAX
    run's draws; the draws mix applied and skipped warps."""
    imgs = np.random.default_rng(7).uniform(size=(2, 24, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(AUG_KEY)
    want = jax.jit(jaug.image_augmentations, static_argnums=(2, 3))(key, jnp.asarray(imgs), 16, 3)
    draws = _jax_draws(key, 4, 16)
    assert draws.use_affine.any() and draws.use_perspective.any()
    assert not (draws.use_affine.all() and draws.use_perspective.all())
    got = taug.image_augmentations(_t(imgs), 16, 3, draws=draws)
    assert got.shape == (6, 16, 16, 3)
    assert _rel_l2(got.numpy(), want) <= FWD_TOL
    # the port's own draws: the same layout, the first tile the plain resize
    own = taug.image_augmentations(_t(imgs), 16, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(own[:2].numpy(), np.asarray(want[:2]), rtol=1e-5, atol=1e-6)


def test_homographies_match_jax():
    """The port's affine and four-point homographies against JAX's, fed the
    uniforms JAX draws from the same keys."""
    ka, kp = jax.random.split(jax.random.PRNGKey(8))
    k1, k2, k3 = jax.random.split(ka, 3)
    ang = float(jax.random.uniform(k1, (), minval=-15.0, maxval=15.0))
    tx, ty = (float(jax.random.uniform(k, (), minval=-0.1, maxval=0.1)) * 16 for k in (k2, k3))
    got = taug.affine_homography(_t([ang]), _t([tx]), _t([ty]), 16, 16)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jaug._affine_homography(ka, 16, 16, 15.0, 0.1)), rtol=1e-5, atol=1e-5)
    offs = np.asarray(jax.random.uniform(kp, (4, 2)))
    got = taug.perspective_homography(_t(offs)[None], 16, 16, 0.7)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jaug._perspective_homography(kp, 16, 16, 0.7)), rtol=1e-4, atol=1e-5)
    img = np.random.default_rng(9).uniform(size=(1, 12, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(taug.projective_warp(_t(img), torch.eye(3)[None]).numpy(), img, atol=1e-6)


@pytest.fixture(scope="module")
def clip_loss_pair():
    vcfg = jclip.tiny_clip_vision_config()
    from instantir_tpu.models.clip_text import tiny_clip_text_config as j_text_cfg

    tcfg = j_text_cfg(projection_dim=vcfg.projection_dim, eos_token_id=999)
    vp = _init_random(jclip.CLIPVisionModel(vcfg), 11, np.zeros((1, 32, 32, 3), np.float32))
    tp = _init_random(JCLIPText(tcfg), 12, np.zeros((1, 8), np.int32))
    jl = jlosses.CLIPLoss(params=(vp, tp, 80.0), augmentations_number=3, vision_config=vcfg, text_config=tcfg)
    params = (convert.to_torch(convert.export_clip_vision(vp, vcfg.num_layers)),
              convert.to_torch(f2t.export_clip_text(jax.tree_util.tree_map(np.asarray, tp), tcfg)), 80.0)
    tl = tlosses.CLIPLoss(params=params, augmentations_number=3, vision_config=tclip.tiny_clip_vision_config(),
                          text_config=tiny_clip_text_config(projection_dim=8, eos_token_id=999), device="cpu")
    return jl, tl


def test_clip_loss_and_gradient_match_jax(clip_loss_pair):
    jl, tl = clip_loss_pair
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, size=(2, 24, 24, 3)).astype(np.float32)
    ids = rng.integers(2, 900, size=(2, 8)).astype(np.int32)
    ids[:, 5] = 999  # EOS: the pooled token
    key = jax.random.PRNGKey(AUG_KEY)
    j_val, j_g = _jax_loss_and_grad(jl, x, prompt_ids=jnp.asarray(ids), key=key)
    t_val, t_g = _port_loss_and_grad(tl, x, prompt_ids=torch.from_numpy(ids).long(),
                                     augmentations=_jax_draws(key, 4, 32))
    _value_close(t_val, j_val)
    _grad_close(t_g, j_g)


# ---------------------------------------------------------------------------
# ArcFace IR-SE50 and IDLoss
# ---------------------------------------------------------------------------


def _arcface_sd(rng, cfg):
    """A state dict in InsightFace's ``model_ir_se50.pth`` names with BatchNorm statistics."""
    sd = {}

    def bn(prefix, ch):
        sd[f"{prefix}.weight"] = np.abs(rng.normal(size=(ch,)).astype(np.float32)) + 0.5
        sd[f"{prefix}.bias"] = rng.normal(size=(ch,)).astype(np.float32) * 0.1
        sd[f"{prefix}.running_mean"] = rng.normal(size=(ch,)).astype(np.float32) * 0.1
        sd[f"{prefix}.running_var"] = np.abs(rng.normal(size=(ch,)).astype(np.float32)) + 0.5

    sd["input_layer.0.weight"] = rng.normal(size=(cfg.stem_channels, 3, 3, 3)).astype(np.float32) * 0.2
    bn("input_layer.1", cfg.stem_channels)
    sd["input_layer.2.weight"] = np.abs(rng.normal(size=(cfg.stem_channels,)).astype(np.float32)) * 0.25
    bi, in_ch = 0, cfg.stem_channels
    for depth, n_units in cfg.stages:
        for _ in range(n_units):
            q = f"body.{bi}"
            bn(f"{q}.res_layer.0", in_ch)
            sd[f"{q}.res_layer.1.weight"] = rng.normal(size=(depth, in_ch, 3, 3)).astype(np.float32) * 0.2
            sd[f"{q}.res_layer.2.weight"] = np.abs(rng.normal(size=(depth,)).astype(np.float32)) * 0.25
            sd[f"{q}.res_layer.3.weight"] = rng.normal(size=(depth, depth, 3, 3)).astype(np.float32) * 0.2
            bn(f"{q}.res_layer.4", depth)
            r = depth // cfg.se_reduction
            sd[f"{q}.res_layer.5.fc1.weight"] = rng.normal(size=(r, depth, 1, 1)).astype(np.float32) * 0.3
            sd[f"{q}.res_layer.5.fc2.weight"] = rng.normal(size=(depth, r, 1, 1)).astype(np.float32) * 0.3
            if in_ch != depth:
                sd[f"{q}.shortcut_layer.0.weight"] = rng.normal(size=(depth, in_ch, 1, 1)).astype(np.float32) * 0.3
                bn(f"{q}.shortcut_layer.1", depth)
            in_ch, bi = depth, bi + 1
    spatial = cfg.input_size // (2 ** len(cfg.stages))
    bn("output_layer.0", in_ch)
    sd["output_layer.3.weight"] = rng.normal(size=(cfg.embedding_dim, in_ch * spatial ** 2)).astype(np.float32) * 0.1
    sd["output_layer.3.bias"] = rng.normal(size=(cfg.embedding_dim,)).astype(np.float32) * 0.1
    bn("output_layer.4", cfg.embedding_dim)
    return sd


@pytest.fixture(scope="module")
def arcface_sd():
    return _arcface_sd(np.random.default_rng(14), tiny_arcface_config())


def test_arcface_matches_jax_and_the_exporter_undoes_the_head_permutation(arcface_sd):
    cfg = tiny_arcface_config()
    jtree = convert_arcface(arcface_sd, cfg)
    model = ArcFaceBackbone(cfg)
    state = import_arcface(convert.to_torch(arcface_sd), model)
    model.load_state_dict(state, strict=True)
    x = np.random.default_rng(15).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    want = JArcFace(cfg).apply(jtree, x)
    with torch.no_grad():
        got = model(_t(x))
    assert _rel_l2(got.numpy(), want) <= FWD_TOL
    exported = convert.export_arcface(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert set(exported) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(exported[k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def _fixed_landmarks(images):
    """Fixed plausible 5-point landmarks; sample 1 "not found"."""
    b, s = images.shape[0], images.shape[1]
    base = np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6], [0.35, 0.8], [0.65, 0.8]]) * s
    return np.tile(base[None], (b, 1, 1)).astype(np.float32), ([1] if b > 1 else [])


def test_id_loss_and_gradient_match_jax(arcface_sd):
    cfg = tiny_arcface_config()
    jl = jlosses.IDLoss(params=convert_arcface(arcface_sd, cfg), detect_fn=_fixed_landmarks, config=cfg)
    tl = tlosses.IDLoss(params=convert.to_torch(arcface_sd), detect_fn=_fixed_landmarks, config=cfg, device="cpu")
    rng = np.random.default_rng(16)
    x, y = (rng.uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32) for _ in range(2))
    j_val, j_g = _jax_loss_and_grad(jl, x, target_image=jnp.asarray(y))
    t_val, t_g = _port_loss_and_grad(tl, x, target_image=_t(y))
    _value_close(t_val, j_val)
    _grad_close(t_g, j_g)
    assert np.all(t_g[1] == 0)  # the "not found" sample takes no gradient
    same = tl(tlosses.DiffusionLossInputs(predicted=_t(x), target=_t(x), pred_image=_t(x), target_image=_t(x)))
    assert float(same) < 1e-5
    # no valid face: mean(pred_image·0), still attached to the graph
    none = tlosses.IDLoss(params=convert.to_torch(arcface_sd), detect_fn=lambda im: (_fixed_landmarks(im)[0],
                                                                                     list(range(im.shape[0]))),
                          config=cfg, device="cpu")
    t_val, t_g = _port_loss_and_grad(none, x, target_image=_t(y))
    assert t_val == 0.0 and np.all(t_g == 0)


# ---------------------------------------------------------------------------
# DreamSIM
# ---------------------------------------------------------------------------


def test_dreamsim_loss_and_gradient_match_jax():
    """One injected backbone (the DINOv2 CLS token), inputs downsampled 40 ->
    28 by the antialiased bicubic resize."""
    from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg

    dcfg = j_dino_cfg()
    dtree = _init_random(JDINO(dcfg), 17, np.zeros((1, 28, 28, 3), np.float32))
    tdino = DINOv2Model(tiny_dinov2_config()).eval()
    tdino.load_state_dict(convert.to_torch(convert.export_dinov2(dtree, dcfg.num_layers)), strict=True)
    jl = jlosses.DreamSIMLoss(embed_fns=[lambda im: JDINO(dcfg).apply(dtree, im)[:, 0]], resize_to=28)
    tl = tlosses.DreamSIMLoss(embed_fns=[lambda im: tdino(im.permute(0, 3, 1, 2))[:, 0]], resize_to=28)
    rng = np.random.default_rng(18)
    x, y = (rng.uniform(-1, 1, size=(2, 40, 40, 3)).astype(np.float32) for _ in range(2))
    j_val, j_g = _jax_loss_and_grad(jl, x, target_image=jnp.asarray(y))
    t_val, t_g = _port_loss_and_grad(tl, x, target_image=_t(y))
    _value_close(t_val, j_val)
    _grad_close(t_g, j_g)
    same = tl(tlosses.DiffusionLossInputs(predicted=_t(x), target=_t(x), pred_image=_t(x), target_image=_t(x)))
    assert float(same) < 1e-5


# ---------------------------------------------------------------------------
# Face utilities
# ---------------------------------------------------------------------------


def test_similarity_transform_is_bitwise_the_jax_one():
    rng = np.random.default_rng(19)
    src = rng.uniform(0, 64, size=(5, 2))
    dst = jface.REFERENCE_FACIAL_POINTS_RELATIVE * 112
    np.testing.assert_array_equal(tface.similarity_transform(src, dst), jface.similarity_transform(src, dst))
    np.testing.assert_array_equal(tface.REFERENCE_FACIAL_POINTS_RELATIVE, jface.REFERENCE_FACIAL_POINTS_RELATIVE)


def test_warp_and_face_extraction_match_jax():
    rng = np.random.default_rng(20)
    images = rng.uniform(-1, 1, size=(2, 40, 36, 3)).astype(np.float32)
    lms = (np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6], [0.35, 0.8], [0.65, 0.8]]) * 36
           + rng.normal(size=(2, 5, 2))).astype(np.float32)
    want = jface.extract_faces_and_landmarks(jnp.asarray(images), lms, 24)
    got = tface.extract_faces_and_landmarks(_t(images), lms, 24)
    assert got.shape == (2, 24, 24, 3)
    assert _rel_l2(got.numpy(), want) <= FWD_TOL
    # reaches outside the source (zero fill); off-round entries, so no sample lands within an ulp of the
    # source's edge, where the fill flips between a pixel and 0
    m = np.array([[1.2903, 0.2117, -4.031], [-0.1969, 1.3127, 3.0212]], np.float32)
    want = jface.warp_affine(jnp.asarray(images[0]), jnp.asarray(m), (30, 28))
    got = tface.warp_affine(_t(images[0]), _t(m), (30, 28))
    assert (np.asarray(want) == 0).all(axis=-1).any()
    assert _rel_l2(got.numpy(), want) <= FWD_TOL


# ---------------------------------------------------------------------------
# MTCNN
# ---------------------------------------------------------------------------


def _facenet_sd(net, rng):
    return {k: (rng.normal(size=tuple(v.shape)) * 0.3).astype(np.float32) for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def mtcnn_sd():
    rng = np.random.default_rng(21)
    return {name: _facenet_sd(cls(), rng) for name, cls in (("pnet", tmtcnn.PNet), ("rnet", tmtcnn.RNet),
                                                             ("onet", tmtcnn.ONet))}


@pytest.mark.parametrize("name,shape", [("pnet", (2, 37, 29, 3)), ("rnet", (3, 24, 24, 3)), ("onet", (3, 48, 48, 3))])
def test_mtcnn_networks_match_jax(mtcnn_sd, name, shape):
    """The facenet_pytorch names load as they are; odd sizes reach the ceil-mode pools."""
    sd = mtcnn_sd[name]
    jnet = {"pnet": jmtcnn.PNet, "rnet": jmtcnn.RNet, "onet": jmtcnn.ONet}[name]()
    jconv = {"pnet": jmtcnn.convert_pnet, "rnet": jmtcnn.convert_rnet, "onet": jmtcnn.convert_onet}[name]
    tnet = {"pnet": tmtcnn.PNet, "rnet": tmtcnn.RNet, "onet": tmtcnn.ONet}[name]()
    tnet.load_state_dict(convert.to_torch(sd), strict=True)
    x = np.random.default_rng(22).uniform(-1, 1, size=shape).astype(np.float32)
    want = jnet.apply(jconv(sd), x)
    with torch.no_grad():
        got = tnet(_t(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g
        assert _rel_l2(g.numpy(), w) <= FWD_TOL


def test_mtcnn_host_helpers_are_bitwise_the_jax_ones():
    rng = np.random.default_rng(23)
    boxes = rng.uniform(0, 80, size=(40, 2)).astype(np.float32)
    boxes = np.concatenate([boxes, boxes + rng.uniform(5, 40, size=(40, 2)).astype(np.float32)], axis=1)
    scores = rng.uniform(size=40).astype(np.float32)
    reg = rng.normal(size=(40, 4)).astype(np.float32) * 0.1
    img = rng.uniform(0, 255, size=(37, 53, 3)).astype(np.float32)
    for mode in ("union", "min"):
        np.testing.assert_array_equal(tmtcnn.nms(boxes, scores, 0.4, mode), jmtcnn.nms(boxes, scores, 0.4, mode))
    np.testing.assert_array_equal(tmtcnn._resize_area(img, 24, 20), jmtcnn._resize_area(img, 24, 20))
    np.testing.assert_array_equal(tmtcnn._bbreg(boxes, reg), jmtcnn._bbreg(boxes, reg))
    np.testing.assert_array_equal(tmtcnn._rerec(boxes), jmtcnn._rerec(boxes))
    crops = boxes - 20  # reaching past the image's edges: zero padding
    np.testing.assert_array_equal(tmtcnn._crop_resize(img, crops, 24), jmtcnn._crop_resize(img, crops, 24))


def test_mtcnn_cascade_and_detect_fn_match_jax(mtcnn_sd):
    """Thresholds at 0 so proposals flow through every stage; the weights
    scaled down so the regressed boxes stay near the image's size."""
    flat = {f"{name}.{k}": v * 0.1 for name, sd in mtcnn_sd.items() for k, v in sd.items()}
    cfg = dict(min_face_size=24, thresholds=(0.0, 0.0, 0.0))  # two pyramid scales
    jdet = jmtcnn.MTCNN(jmtcnn.convert_mtcnn(flat), jmtcnn.MTCNNConfig(**cfg))
    tdet = tmtcnn.MTCNN(convert.to_torch(flat), tmtcnn.MTCNNConfig(**cfg), device="cpu")
    img = np.random.default_rng(24).uniform(0, 255, size=(40, 36, 3)).astype(np.float32)
    want, got = jdet.detect(img), tdet.detect(img)
    assert len(got[0]) == len(want[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    batch = (img / 127.5 - 1.0)[None]  # the same image through the [-1, 1] contract
    (j_lms, j_bad), (t_lms, t_bad) = jmtcnn.build_detect_fn(jdet)(batch), tmtcnn.build_detect_fn(tdet)(_t(batch))
    assert t_bad == j_bad == [] and t_lms.shape == (1, 5, 2)
    np.testing.assert_allclose(t_lms, j_lms, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# The face-identity dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def face_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faces")
    root = tmp / "faces"
    root.mkdir()
    rng = np.random.default_rng(0)
    labels = {}
    for ident in ("alice", "bob"):
        for j in range(3):
            name = f"conceptname_smiling_{ident}_{j}.png"
            Image.fromarray(rng.uniform(0, 255, size=(40, 48, 3)).astype(np.uint8)).save(root / name)
            labels[name] = ident
    meta = tmp / "meta.json"
    meta.write_text(json.dumps(labels))
    return root, meta


DATASET_CASES = {
    "pairs": dict(size=32, seed=1, prompt_in_filename=True, random_target_prob=0.5),
    "augmented_self": dict(size=32, aug_images=True, center_crop=True, seed=2, metadata=False),
    "decoder_prompts": dict(size=16, seed=0, use_only_decoder_prompts=True, use_only_vanilla_for_encoder=False),
}


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_face_dataset_batches_are_bitwise_the_jax_ones(face_root, case):
    root, meta = face_root
    kw = dict(DATASET_CASES[case])
    if kw.pop("metadata", True):
        kw["metadata_path"] = str(meta)
    jds, tds = jface_dataset.FaceIdentityDataset(str(root), **kw), tface_dataset.FaceIdentityDataset(str(root), **kw)
    assert len(tds) == len(jds) == 6
    for i in (0, 3):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    jb, tb = next(jds.batches(3)), next(tds.batches(3))
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tface_dataset.path_to_prompt("x/conceptname_happy_12_7.jpg", "a dog") == "a dog happy"
    np.testing.assert_array_equal(tface_dataset.RESIZED_REFERENCE_POINTS, jface_dataset.RESIZED_REFERENCE_POINTS)


def test_face_dataset_head_crop_matches_jax(face_root):
    """The head crop warps on the CPU through the port's ``warp_affine``
    (1e-5 of the JAX warp; every other value bitwise)."""
    root, meta = face_root

    def detect_fn(images):
        return np.array([[[10, 12], [22, 12], [16, 18], [12, 24], [20, 24]]], np.float32), []

    kw = dict(metadata_path=str(meta), size=32, seed=3, crop_head_for_encoder_image=True, detect_fn=detect_fn)
    want = jface_dataset.FaceIdentityDataset(str(root), **kw)[0]
    got = tface_dataset.FaceIdentityDataset(str(root), **kw)[0]
    np.testing.assert_array_equal(got["instance_images"], want["instance_images"])
    assert _rel_l2(got["encoder_images"], want["encoder_images"]) <= FWD_TOL
    with pytest.raises(ValueError, match="detect_fn"):
        tface_dataset.FaceIdentityDataset(str(root), size=32, crop_head_for_encoder_image=True)


# ---------------------------------------------------------------------------
# The registry, the refusals and the import rule
# ---------------------------------------------------------------------------

PERCEPTUAL = ("LPIPSLoss", "CLIPLoss", "IDLoss", "DreamSIMLoss")


def test_registry_builds_every_perceptual_loss_with_injected_weights(lpips_sd, arcface_sd, clip_loss_pair):
    assert not hasattr(tlosses, "NOT_PORTED")
    assert set(tlosses.LOSS_REGISTRY) == set(jlosses.LOSS_REGISTRY)
    _, tl = clip_loss_pair
    configs = [
        SingleLossConfig(name="LPIPSLoss", weight=0.5, init_params={"params": convert.to_torch(lpips_sd),
                                                                    "config": tiny_lpips_config()}),
        SingleLossConfig(name="CLIPLoss", init_params={
            "params": (tl.vision.state_dict(), tl.text.state_dict(), 100.0), "augmentations_number": 2,
            "vision_config": tl.vision_config, "text_config": tl.text_config}),
        SingleLossConfig(name="IDLoss", init_params={"params": convert.to_torch(arcface_sd),
                                                     "detect_fn": _fixed_landmarks, "config": tiny_arcface_config()}),
        SingleLossConfig(name="DreamSIMLoss", init_params={"embed_fns": [lambda im: im.mean(dim=(1, 2))]}),
    ]
    built = tlosses.build_losses(configs, device="cpu")
    assert [type(loss).__name__ for loss, _ in built] == list(PERCEPTUAL)
    assert built[0][1] == 0.5 and all(loss.needs_images for loss, _ in built)
    assert next(built[0][0].module.parameters()).device.type == "cpu"
    with pytest.raises(KeyError, match="unknown loss"):
        tlosses.build_losses([SingleLossConfig(name="NoSuchLoss")])


@pytest.mark.parametrize("name", PERCEPTUAL)
def test_perceptual_losses_without_weights_raise_as_in_jax(name):
    with pytest.raises(NotImplementedError) as want:
        getattr(jlosses, name)()
    with pytest.raises(NotImplementedError) as got:
        tlosses.build_losses([SingleLossConfig(name=name)], device="cpu")
    assert str(got.value) == str(want.value) and name in str(got.value)


def test_id_loss_without_a_detector_raises(arcface_sd):
    with pytest.raises(NotImplementedError, match="face detector"):
        tlosses.IDLoss(params=convert.to_torch(arcface_sd), config=tiny_arcface_config(), device="cpu")


def test_new_port_modules_import_no_jax():
    files = ["models/clip_vision.py", "losses/lpips.py", "losses/augmentations.py", "losses/arcface.py",
             "losses/losses.py", "utils/face.py", "utils/mtcnn.py", "data/face_dataset.py"]
    for rel in files:
        tree = ast.parse((REPO / "instantir_tpu_torch" / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not [n for n in names if n.split(".")[0] in ("jax", "flax", "instantir_tpu")], (rel, names)
