"""CPU parity of the port's checkpoint loading, text encoders and inference CLI
with the JAX package's.

One tiny checkpoint tree in the released layout (the fixture of
``tests/test_cli_e2e.py``: a diffusers SDXL folder, ``adapter.pt``,
``previewer_lora_weights.bin``, ``aggregator.pt``, a DINOv2 folder) is written
per module from numpy draws (every leaf nonzero, the zero-init ones too) in a
mix of formats: fp32 and fp16 ``.safetensors``, ``.bin``, ``.pt``. A second
InstantIR folder holds a legacy flat ``adapter.pt``, a LoRA file without the
Resampler's tensors and no ``aggregator.pt``. Both loaders read each; the
port's parameters must equal the JAX parameters exported through
``convert.py``, leaf by leaf, exactly. No JAX restore is compiled here
(``test_torch_port_pipeline.py`` holds the restore).
"""

from __future__ import annotations

import ast
import collections
import copy
import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantir_tpu.convert import flax_to_torch as f2t
from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.clip_text import CLIPTextModel as JCLIP
from instantir_tpu.models.clip_text import encode_sdxl_prompt as j_encode_sdxl_prompt
from instantir_tpu.models.clip_text import tiny_clip_text_config as j_clip_cfg
from instantir_tpu.models.dinov2 import DINOv2Model as JDINO
from instantir_tpu.models.dinov2 import tiny_dinov2_config as j_dino_cfg
from instantir_tpu.models.layers import merge_lora_tree
from instantir_tpu.models.resampler import Resampler as JResampler
from instantir_tpu.models.resampler import tiny_resampler_config as j_res_cfg
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.vae import AutoencoderKL as JVAE
from instantir_tpu.models.vae import tiny_vae_config as j_vae_cfg
from instantir_tpu.pipeline import load as jload
from instantir_tpu_torch import convert
from instantir_tpu_torch.cli import infer as tinfer
from instantir_tpu_torch.models.clip_text import CLIPTextModel, encode_sdxl_prompt, tiny_clip_text_config
from instantir_tpu_torch.models.layers import merge_lora
from instantir_tpu_torch.pipeline import load as tload
from instantir_tpu_torch.utils import text as ttext
from instantir_tpu_torch.utils import watermark as twm
from instantir_tpu_torch.utils.tokenizer import CLIPTokenizer, basic_clean, bytes_to_unicode, split_words

REPO = Path(__file__).resolve().parents[1]
LORA_RANK, RES_LORA_RANK = 4, 2
EOS = 999  # the tiny towers' EOS id (inside their 1000-entry vocabulary)
CORPUS = (
    "Photorealistic, highly detailed, hyper detailed photo - realistic maximum detail, 32k, ultra HD, "
    "extreme meticulous detailing, skin pore detailing, hyper sharpness, perfect without deformations, "
    "blurry, out of focus, unclear, depth of field, over-smooth, sketch, oil painting, cartoon, CG Style, "
    "the quick brown fox jumps over the lazy dog; a café, a naïve résumé. "
) * 3


def _random_tree(shapes, seed):
    """Every leaf drawn from ``seed``: kernels fan-in scaled, norm scales near
    1, biases and the zero-init leaves (LoRA B, zero convs) nonzero."""
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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_bin(path, sd):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def _save_safetensors(path, sd, dtype):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v, dtype) for k, v in sd.items()}, str(path))


def write_tokenizer(folder, pad_token=None, n_merges=300):
    """A CLIP tokenizer folder: the 256 byte characters with and without
    ``</w>``, ``n_merges`` merges learned greedily from ``CORPUS``, the two
    special tokens; ``pad_token`` written to both settings files when given."""
    os.makedirs(folder, exist_ok=True)
    be = bytes_to_unicode()
    vocab = {}
    for c in list(be.values()) + [c + "</w>" for c in be.values()]:
        vocab[c] = len(vocab)
    words = collections.Counter()
    for w in split_words(basic_clean(CORPUS)):
        m = "".join(be[b] for b in w.encode())
        words[tuple(m[:-1]) + (m[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(folder, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(folder, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    settings = {"model_max_length": 77, "tokenizer_class": "CLIPTokenizer"}
    if pad_token is not None:
        settings["pad_token"] = pad_token
        with open(os.path.join(folder, "special_tokens_map.json"), "w") as f:
            json.dump({"pad_token": pad_token}, f)
    with open(os.path.join(folder, "tokenizer_config.json"), "w") as f:
        json.dump(settings, f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The checkpoint tree: {"root", "params" (the JAX trees), "configs"}."""
    root = tmp_path_factory.mktemp("ckpt")
    sdxl, inst, inst_b, dino_dir = root / "sdxl", root / "instantir", root / "instantir_b", root / "dinov2"
    for d in (sdxl / "unet", sdxl / "vae", sdxl / "text_encoder", sdxl / "text_encoder_2", inst, inst_b, dino_dir):
        d.mkdir(parents=True)
    ucfg = j_unet_cfg(with_ip=True, lora_rank=LORA_RANK)
    vcfg, dcfg = j_vae_cfg(), j_dino_cfg()
    rcfg = j_res_cfg(output_dim=ucfg.cross_attention_dim, embedding_dim=dcfg.hidden_size, lora_rank=RES_LORA_RANK)
    ccfgs = {"text_encoder": j_clip_cfg(projection_dim=None, eos_token_id=EOS),
             "text_encoder_2": j_clip_cfg(eos_token_id=EOS)}
    lat = ucfg.sample_size
    z = np.zeros((1, lat, lat, 4), np.float32)
    t0 = np.zeros((1,), np.int32)
    text, pooled, tids = np.zeros((1, 7, 32), np.float32), np.zeros((1, 16), np.float32), np.zeros((1, 6), np.float32)
    params = {
        "unet": _init_random(JUNet(ucfg), 1, z, t0, text, pooled, tids,
                             ip_hidden_states=np.zeros((1, rcfg.num_queries, 32), np.float32)),
        "aggregator": _init_random(JAggregator(ucfg), 2, z, t0, z, added_text_embeds=pooled, added_time_ids=tids),
        "vae": _init_random(JVAE(vcfg), 3, np.zeros((1, 32, 32, 3), np.float32)),
        "resampler": _init_random(JResampler(rcfg), 4, np.zeros((1, 5, rcfg.embedding_dim), np.float32)),
        "image_encoder": _init_random(JDINO(dcfg), 5, np.zeros((1, dcfg.image_size, dcfg.image_size, 3), np.float32)),
    }
    for i, (sub, c) in enumerate(ccfgs.items()):
        params[sub] = _init_random(JCLIP(c), 6 + i, np.zeros((1, 8), np.int32))
    params = _np_tree(params)

    # the diffusers SDXL folder: the UNet in fp32 and the VAE in fp16 safetensors
    unet_sd = f2t.export_unet(params["unet"])
    _save_safetensors(sdxl / "unet" / "diffusion_pytorch_model.safetensors",
                      {k: v for k, v in unet_sd.items() if "lora_" not in k and ".processor." not in k}, np.float32)
    with open(sdxl / "unet" / "config.json", "w") as f:
        json.dump({"sample_size": ucfg.sample_size, "in_channels": 4, "out_channels": 4,
                   "down_block_types": list(ucfg.down_block_types), "up_block_types": list(ucfg.up_block_types),
                   "block_out_channels": list(ucfg.block_out_channels), "layers_per_block": ucfg.layers_per_block,
                   "transformer_layers_per_block": list(ucfg.transformer_layers_per_block),
                   "attention_head_dim": list(ucfg.num_attention_heads), "num_attention_heads": None,
                   "cross_attention_dim": ucfg.cross_attention_dim,
                   "addition_time_embed_dim": ucfg.addition_time_embed_dim,
                   "projection_class_embeddings_input_dim": ucfg.projection_class_embeddings_input_dim,
                   "norm_num_groups": ucfg.norm_num_groups}, f)
    _save_safetensors(sdxl / "vae" / "diffusion_pytorch_model.safetensors", f2t.export_vae(params["vae"]), np.float16)
    with open(sdxl / "vae" / "config.json", "w") as f:
        json.dump({"block_out_channels": list(vcfg.block_out_channels), "layers_per_block": vcfg.layers_per_block,
                   "latent_channels": 4, "norm_num_groups": vcfg.norm_num_groups,
                   "scaling_factor": vcfg.scaling_factor}, f)
    # the text towers: one fp32 safetensors, one .bin
    for sub, c in ccfgs.items():
        sd = f2t.export_clip_text(params[sub], c)
        if sub == "text_encoder":
            _save_safetensors(sdxl / sub / "model.safetensors", sd, np.float32)
        else:
            _save_bin(sdxl / sub / "pytorch_model.bin", sd)
        with open(sdxl / sub / "config.json", "w") as f:
            json.dump({"architectures": ["CLIPTextModelWithProjection" if c.projection_dim else "CLIPTextModel"],
                       "vocab_size": c.vocab_size, "hidden_size": c.hidden_size, "num_hidden_layers": c.num_layers,
                       "num_attention_heads": c.num_heads, "intermediate_size": c.intermediate_size,
                       "max_position_embeddings": c.max_length, "hidden_act": c.hidden_act,
                       "projection_dim": c.projection_dim or 512, "eos_token_id": EOS}, f)
    write_tokenizer(sdxl / "tokenizer")
    write_tokenizer(sdxl / "tokenizer_2", pad_token="!")

    _save_bin(dino_dir / "pytorch_model.bin", f2t.export_dinov2(params["image_encoder"], dcfg))
    with open(dino_dir / "config.json", "w") as f:
        json.dump({"hidden_size": dcfg.hidden_size, "num_hidden_layers": dcfg.num_layers,
                   "num_attention_heads": dcfg.num_heads, "mlp_ratio": dcfg.mlp_ratio,
                   "patch_size": dcfg.patch_size, "image_size": dcfg.image_size,
                   "layerscale_value": dcfg.layerscale_init}, f)

    # the InstantIR files (reference formats, infer.py:124-143)
    res_sd = f2t.export_resampler(params["resampler"])
    ip_sd = f2t.export_ip_adapter(params["unet"], ucfg)
    image_proj = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in res_sd.items() if "lora_" not in k}
    ip = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ip_sd.items() if "lora_" not in k}
    torch.save({"image_proj": image_proj, "ip_adapter": ip}, inst / "adapter.pt")
    unet_lora = {f"unet.{k}": v for k, v in unet_sd.items() if "lora_" in k}
    _save_bin(inst / "previewer_lora_weights.bin", {
        **unet_lora, **{f"unet.encoder_hid_proj.image_projection_layers.0.{k}": v
                        for k, v in res_sd.items() if "lora_" in k}})
    _save_bin(inst / "aggregator.pt", f2t.export_aggregator(params["aggregator"]))
    res_fields = dataclasses.asdict(rcfg)
    for d in (inst, inst_b):
        with open(d / "instantir_config.json", "w") as f:
            json.dump({"lora_rank": LORA_RANK, "resampler": res_fields}, f)
    # the second folder: a legacy flat adapter.pt, the UNet's LoRA alone, no aggregator.pt
    torch.save({**{f"image_proj_model.{k}": v for k, v in image_proj.items()},
                **{f"adapter_modules.{k}": v for k, v in ip.items()}}, inst_b / "adapter.pt")
    _save_bin(inst_b / "previewer_lora_weights.bin", unet_lora)
    return {"root": root, "params": params, "ucfg": ucfg, "dcfg": dcfg, "ccfgs": ccfgs}


VARIANTS = {"fp32": ("instantir", jnp.float32, torch.float32), "bf16_legacy": ("instantir_b", jnp.bfloat16,
                                                                               torch.bfloat16)}


@pytest.fixture(scope="module")
def loaded(tree):
    """Both loaders' pipelines of each variant, loaded once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            folder, jdtype, tdtype = VARIANTS[variant]
            kw = dict(vision_encoder_path=str(tree["root"] / "dinov2"))
            args = (str(tree["root"] / "sdxl"), str(tree["root"] / folder))
            cache[variant] = (jload.load_instantir_pipeline(*args, dtype=jdtype, **kw),
                              tload.load_instantir_pipeline(*args, dtype=tdtype, device="cpu", **kw))
        return cache[variant]

    return get


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


def _jax_state(jpipe, dcfg):
    p = _np_tree(jpipe.params)
    return {"unet": convert.export_unet(p["unet"]), "aggregator": convert.export_aggregator(p["aggregator"]),
            "vae": convert.export_vae(p["vae"]), "resampler": convert.export_resampler(p["resampler"]),
            "image_encoder": convert.export_dinov2(p["image_encoder"], dcfg.num_layers)}


def _fresh_names(variant, tpipe):
    """Parameters that no file of the variant provides: drawn by each loader."""
    if variant == "fp32":
        return {}
    return {"aggregator": {n for n, _ in tpipe.aggregator.named_parameters() if n.startswith("controlnet_")},
            "resampler": {n for n, _ in tpipe.resampler.named_parameters() if "lora_" in n}}


def _check_fresh(model, name, got, want):
    """A leaf both loaders drew: the same rule, not the same draw."""
    rule = tload.fresh_leaf(model, name, tuple(got.shape), np.random.default_rng(0)).numpy()
    if not rule.any() or np.all(rule == 1.0):
        np.testing.assert_array_equal(got, rule, err_msg=name)
        np.testing.assert_array_equal(want, rule, err_msg=name)
    else:
        std = rule.std()
        for x in (got, want):
            assert x.shape == rule.shape and 0.5 * std < x.std() < 1.5 * std, name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_loader_gives_the_jax_loaders_parameters(tree, loaded, variant):
    """Leaf by leaf through ``convert.py``, exactly: fp32 with the full tree
    (``aggregator.pt``, the nested ``adapter.pt``, the UNet's and the
    Resampler's LoRA); bf16 with the legacy flat adapter, the UNet's LoRA
    alone and the Aggregator built from the UNet (fresh leaves by rule)."""
    jpipe, tpipe = loaded(variant)
    want_all = _jax_state(jpipe, tree["dcfg"])
    fresh = _fresh_names(variant, tpipe)
    dtype = VARIANTS[variant][2]
    for model_name, want in want_all.items():
        model = getattr(tpipe, model_name)
        got = model.state_dict()
        assert set(got) == set(want), (model_name, sorted(set(got) ^ set(want))[:5])
        for name, t in got.items():
            owner = model.get_submodule(name.rpartition(".")[0])
            assert t.dtype == (torch.float32 if model_name == "vae" or isinstance(owner, tload._NORMS) else dtype), \
                (model_name, name, t.dtype)
            if name in fresh.get(model_name, ()):
                _check_fresh(model, name, _f32(t), _f32(want[name]))
            else:
                np.testing.assert_array_equal(_f32(t), _f32(want[name]), err_msg=f"{model_name}.{name}")
    assert {p.device.type for p in tpipe.unet.parameters()} == {"cpu"}


def test_aggregator_from_the_unet_copies_the_shared_leaves(loaded):
    _, tpipe = loaded("bf16_legacy")
    unet = tpipe.unet.state_dict()
    agg = tpipe.aggregator.state_dict()
    torch.testing.assert_close(agg["ref_conv_in.weight"], unet["conv_in.weight"], rtol=0, atol=0)
    shared = [n for n in agg if n.split(".")[0] in ("down_blocks", "mid_block", "time_embedding", "conv_in")]
    assert len(shared) > 20
    for n in shared:
        torch.testing.assert_close(agg[n], unet[n], rtol=0, atol=0)


@pytest.mark.parametrize("loader", ["jax", "port"])
def test_strict_load_raises_on_a_renamed_lora_key(tree, tmp_path, loader):
    inst = tmp_path / "instantir"
    shutil.copytree(tree["root"] / "instantir", inst)
    sd = torch.load(inst / "previewer_lora_weights.bin", weights_only=True)
    key = next(k for k in sd if ".attn1.to_q.lora_A" in k)
    sd[key.replace(".to_q.", ".to_qq.")] = sd.pop(key)
    torch.save(sd, inst / "previewer_lora_weights.bin")
    args = (str(tree["root"] / "sdxl"), str(inst))
    kw = dict(vision_encoder_path=str(tree["root"] / "dinov2"))
    if loader == "jax":
        with pytest.raises(ValueError, match="did not merge"):
            jload.load_instantir_pipeline(*args, **kw)
    else:
        with pytest.raises(ValueError, match="did not merge"):
            tload.load_instantir_pipeline(*args, device="cpu", **kw)
        pipe = tload.load_instantir_pipeline(*args, device="cpu", strict=False, **kw)  # warns and loads the rest
        assert pipe.unet.state_dict()[key[len("unet."):]].abs().sum() > 0  # B is nonzero: A was drawn


def test_port_loader_refusals(tree):
    args = (str(tree["root"] / "sdxl"), str(tree["root"] / "instantir"))
    with pytest.raises(ValueError, match="vision_encoder_path"):
        tload.load_instantir_pipeline(*args, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tload.load_instantir_pipeline(*args, vision_encoder_path=str(tree["root"] / "dinov2"))


CLIP_HF = dict(hidden_size=16, num_hidden_layers=3, num_attention_heads=2, intermediate_size=32, image_size=32,
               patch_size=8, projection_dim=8, hidden_act="quick_gelu", layer_norm_eps=1e-5)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """An HF ``CLIPVisionModelWithProjection`` folder (``config.json`` and
    ``pytorch_model.bin``, every tensor of the tower) at the tree's
    Resampler width (16), from a JAX tree drawn from a seed."""
    from instantir_tpu.models.clip_vision import CLIPVisionModel as JCLIPVision
    from instantir_tpu.models.clip_vision import tiny_clip_vision_config as j_clip_vision_cfg

    folder = tmp_path_factory.mktemp("clip_vision")
    cfg = j_clip_vision_cfg(num_layers=3)
    params = _np_tree(_init_random(JCLIPVision(cfg), 9, np.zeros((1, 32, 32, 3), np.float32)))
    _save_bin(folder / "pytorch_model.bin", convert.export_clip_vision(params, cfg.num_layers))
    with open(folder / "config.json", "w") as f:
        json.dump({"architectures": ["CLIPVisionModelWithProjection"], **CLIP_HF}, f)
    return folder


def test_port_loader_reads_a_clip_vision_folder(tree, clip_dir, rng):
    """``use_clip_encoder=True`` in both loaders: the port's
    ``CLIPImageEncoder`` holds the JAX encoder's parameters exactly (the
    tower's last layer, post-norm and projection passed over), the config
    comes from ``config.json``, and the image tokens and the uncond tokens
    equal JAX's within 1e-5 of their scale."""
    from instantir_tpu_torch.models.clip_vision import CLIPImageEncoder

    args = (str(tree["root"] / "sdxl"), str(tree["root"] / "instantir"))
    jpipe = jload.load_instantir_pipeline(*args, vision_encoder_path=str(clip_dir), dtype=jnp.float32,
                                          use_clip_encoder=True)
    tpipe = tload.load_instantir_pipeline(*args, vision_encoder_path=str(clip_dir), dtype=torch.float32,
                                          use_clip_encoder=True, device="cpu")
    enc = tpipe.image_encoder
    assert isinstance(enc, CLIPImageEncoder) and enc.config == tload.clip_vision_config_from_json(CLIP_HF)
    assert enc.config.num_layers == 3 and len(enc.vision_model.encoder.layers) == 2
    assert tpipe.resampler.config.embedding_dim == enc.config.hidden_size
    want = convert.export_clip_image_encoder(_np_tree(jpipe.params["image_encoder"]), 3)
    got = enc.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    lq = rng.uniform(size=(1, 48, 40, 3)).astype(np.float32)
    j_cond, j_uncond = jpipe.encode_image_embeds(jpipe.params, jnp.asarray(lq))
    with torch.no_grad():
        cond, uncond = tpipe.encode_image_embeds(torch.from_numpy(lq), tpipe._uncond_tokens(32, torch.float32))
    assert cond.shape == (1, 17, 16)
    for g, w in ((cond, j_cond), (uncond, j_uncond)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


def test_cli_restores_with_the_clip_encoder(tree, clip_dir, tmp_path):
    """``--use_clip_encoder``: the port's ``main`` on the CPU reads the CLIP
    folder as the image encoder and restores a 64x64 image."""
    lq = tmp_path / "lq"
    lq.mkdir()
    Image.fromarray((np.random.default_rng(4).uniform(size=(64, 64, 3)) * 255).astype(np.uint8)).save(lq / "d.png")
    root = tree["root"]
    records = tinfer.main(["--sdxl_path", str(root / "sdxl"), "--instantir_path", str(root / "instantir"),
                           "--vision_encoder_path", str(clip_dir), "--use_clip_encoder", "--test_path", str(lq),
                           "--out_path", str(tmp_path / "out"), "--num_inference_steps", "2", "--min_side", "64",
                           "--max_side", "64"], device="cpu")
    assert [(r["files"], r["size"]) for r in records] == [(["d.png"], (64, 64))]
    img = np.asarray(Image.open(tmp_path / "out" / "d.png"))
    assert img.shape == (64, 64, 3) and img.std() > 0


def test_merge_lora_bf16_within_one_ulp_of_the_jax_merge(tree, loaded):
    """Both loaders store bf16 weights and merge in bf16: the port's
    ``merge_lora`` against ``merge_lora_tree`` on the same loaded weights, in
    units of the bf16 spacing at each element's magnitude."""
    jpipe, tpipe = loaded("bf16_legacy")
    alpha = tree["ucfg"].lora_alpha
    jmerged = convert.export_unet(_np_tree(merge_lora_tree(jpipe.params["unet"], 1.0, lora_alpha=alpha)))
    with torch.no_grad():
        tmerged = merge_lora(tpipe.unet, 1.0)
    assert len(tmerged) > 50
    worst = 0.0
    for name, t in tmerged.items():
        assert t.dtype == torch.bfloat16
        got, want = _f32(t), _f32(jmerged[name])
        mag = np.maximum(np.abs(got), np.abs(want))
        ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
        worst = max(worst, float((np.abs(got - want) / ulp).max()))
    print(f"merge_lora bf16: largest difference {worst} ulp over {len(tmerged)} merged weights")
    assert worst <= 1.0


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load_file

    rng = np.random.default_rng(0)
    arrays = {"a.f32": rng.standard_normal((3, 5)).astype(np.float32), "b.f16": rng.standard_normal(7).astype(np.float16),
              "c.i64": rng.integers(-9, 9, (2, 2, 2)), "d.empty": np.zeros((0, 4), np.float32),
              "e.scalar": np.asarray(1.5, np.float32)}
    save_file(arrays, str(tmp_path / "x.safetensors"))
    got = convert.load_torch_state_dict(str(tmp_path / "x.safetensors"))
    want = load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # bf16 (numpy has none): the port's writer against the library's torch reader, and back
    tensors = {"w": torch.randn(4, 6).to(torch.bfloat16), "b": torch.randn(6), "i": torch.arange(5)}
    convert.write_safetensors(str(tmp_path / "y.safetensors"), tensors)
    for back in (torch_load_file(str(tmp_path / "y.safetensors")),
                 convert.load_torch_state_dict(str(tmp_path / "y.safetensors"))):
        for k, t in tensors.items():
            assert back[k].dtype == t.dtype
            torch.testing.assert_close(back[k], t, rtol=0, atol=0)


def test_bin_reader_unwraps_and_flattens(tmp_path):
    torch.save({"state_dict": {"a": {"b": torch.ones(2)}, "c": torch.zeros(1, dtype=torch.float16)}},
               tmp_path / "x.pt")
    got = convert.load_torch_state_dict(str(tmp_path / "x.pt"))
    assert sorted(got) == ["a.b", "c"] and got["c"].dtype == torch.float16


TEXTS = [
    "",
    "Photorealistic, highly detailed, hyper detailed photo!",
    "don't IT'S we'll 'S 'll's !'s",
    "digits 0123456789 x² 10³ ½ 2024-10-17 3.14",
    "punctuation !!! ?? ... ,,; :-) (a)[b]{c} @#$%^&*_+=~`|\\/<>",
    "accents café naïve résumé Ünïcödé ÀÉÎ straße İstanbul é",
    "emoji 😀 🎉👍 ❤️ 🇫🇷",
    "white\tspace\nnew line​zero width 　 ideographic 中文字",
    "<|endoftext|> a<|startoftext|>b !<|endoftext|> wow! ! !x",
    "word " * 100,
]


@pytest.mark.parametrize("pad", [None, "!"], ids=["pad_eos", "pad_bang"])
def test_tokenizer_matches_transformers(tmp_path, pad):
    from transformers import CLIPTokenizer as HFTokenizer

    write_tokenizer(tmp_path / "tok", pad_token=pad)
    hf = HFTokenizer.from_pretrained(str(tmp_path / "tok"))
    port = CLIPTokenizer.from_pretrained(str(tmp_path / "tok"))
    assert (port.pad_token, port.pad_token_id) == (hf.pad_token, hf.pad_token_id)
    texts = TEXTS + [tinfer.DEFAULT_PROMPT, tinfer.DEFAULT_NEG_PROMPT]
    want = hf(texts, padding="max_length", max_length=77, truncation=True)["input_ids"]
    got = port(texts, padding="max_length", max_length=77, truncation=True)["input_ids"]
    for text, g, w in zip(texts, got, want):
        assert g == w, text
    assert got[-3][-1] == port.eos_token_id  # the overlong text keeps its EOS
    assert ttext.tokenize_prompt(port, texts[:2]).tolist() == want[:2]


@pytest.fixture(scope="module")
def clip_pair():
    """JAX and port CLIP towers (fp32) with the same random weights."""
    out = []
    for i, cfg in enumerate((j_clip_cfg(projection_dim=None, eos_token_id=EOS), j_clip_cfg(eos_token_id=EOS))):
        jm = JCLIP(cfg)
        params = _np_tree(_init_random(jm, 10 + i, np.zeros((1, 8), np.int32)))
        tm = CLIPTextModel(tiny_clip_text_config(projection_dim=cfg.projection_dim, eos_token_id=EOS))
        tm.load_state_dict(convert.to_torch(f2t.export_clip_text(params, cfg)), strict=True)
        out.append((jm, params, tm.eval()))
    return out


def test_encode_sdxl_prompt_matches_jax(clip_pair):
    (j1, p1, t1), (j2, p2, t2) = clip_pair
    rng = np.random.default_rng(3)
    ids = rng.integers(0, EOS, (3, 77)).astype(np.int32)
    ids[:, 0] = 998
    for row, pos in enumerate((5, 40, 76)):
        ids[row, pos:] = EOS  # the first EOS is the pooled position
    ids2 = ids[::-1].copy()
    jpe, jpooled = j_encode_sdxl_prompt(j1, p1, j2, p2, jnp.asarray(ids), jnp.asarray(ids2))
    with torch.no_grad():
        tpe, tpooled = encode_sdxl_prompt(t1, t2, torch.from_numpy(ids).long(), torch.from_numpy(ids2).long())
        last, pen, pooled = t2(torch.from_numpy(ids2).long())
    jlast, jpen, jpool = j2.apply(p2, jnp.asarray(ids2))
    for got, want in ((tpe, jpe), (tpooled, jpooled), (last, jlast), (pen, jpen), (pooled, jpool)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), np.abs(got - want).max()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want), np.abs(got - want).max()


def test_text_utils(clip_pair):
    """``utils/text.py`` against ``instantir_tpu.utils.text``: ``encode_prompt``
    on the two towers (1e-5 relative); ``add_tokens``' padded vocabulary,
    first new id and kept rows exactly, its new rows by rule (N(0, 0.01²),
    the draws differ); ``patch_token_embeddings`` over every new row and one
    old row, the patched tables exactly, and the patched towers' encoding of
    ids that use the new tokens (1e-5 relative)."""
    from instantir_tpu.utils import text as jtext

    (j1, p1, t1), (j2, p2, t2) = clip_pair
    rng = np.random.default_rng(4)
    ids = rng.integers(0, EOS, (2, 77))
    ids[0, 50:], ids[1, 20:] = EOS, EOS
    ids2 = ids[::-1].copy()
    jpe, jpooled = jtext.encode_prompt([j1, j2], [p1, p2], [jnp.asarray(ids, jnp.int32), jnp.asarray(ids2, jnp.int32)])
    tpe, tpooled = ttext.encode_prompt([t1, t2], [torch.from_numpy(ids), torch.from_numpy(ids2)])
    _close(tpe.numpy(), jpe)
    _close(tpooled.numpy(), jpooled)
    with pytest.raises(ValueError, match="projection"):
        jtext.encode_prompt([j1], [p1], [jnp.asarray(ids, jnp.int32)])
    with pytest.raises(ValueError, match="projection"):
        ttext.encode_prompt([t1], [torch.from_numpy(ids)])

    enc = copy.deepcopy(t2)
    jparams, jcfg, jfirst = jtext.add_tokens(p2, j2.config, 3, key=jax.random.PRNGKey(0))
    first = ttext.add_tokens(enc, 3, generator=torch.Generator().manual_seed(0))
    table = enc.text_model.embeddings.token_embedding.weight.detach()
    jtable = np.asarray(jparams["params"]["token_embedding"]["embedding"])
    assert (first, enc.config.vocab_size, tuple(table.shape)) == (jfirst, jcfg.vocab_size, jtable.shape)
    assert jcfg.vocab_size % 128 == 0 and jcfg.vocab_size >= jfirst + 3
    np.testing.assert_array_equal(table[:first].numpy(), jtable[:first])
    for new in (table[first:].numpy(), jtable[first:]):
        assert abs(new.std() - 0.01) < 0.0015 and abs(new.mean()) < 0.002

    rows = list(range(first, jcfg.vocab_size)) + [5]
    emb = rng.standard_normal((len(rows), table.shape[1])).astype(np.float32)
    jparams = jtext.patch_token_embeddings(jparams, rows, jnp.asarray(emb))
    ttext.patch_token_embeddings(enc, rows, torch.from_numpy(emb))
    np.testing.assert_array_equal(enc.text_model.embeddings.token_embedding.weight.detach().numpy(),
                                  np.asarray(jparams["params"]["token_embedding"]["embedding"]))
    np.testing.assert_array_equal(table[rows].numpy(), emb)
    ids3 = ids2.copy()
    ids3[:, 1:4] = [first, first + 1, 5]
    with torch.no_grad():
        got = enc(torch.from_numpy(ids3))
    want = JCLIP(jcfg).apply(jparams, jnp.asarray(ids3, jnp.int32))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("size,kw", [
    ((70, 90), {}), ((90, 70), dict(min_side=64, max_side=192)), ((70, 150), dict(min_side=64, max_side=192)),
    ((1200, 800), {}), ((3000, 500), {}), ((640, 480), dict(width=1024)), ((640, 480), dict(height=900)),
    ((640, 480), dict(width=777, height=555)),
])
def test_resize_img_matches_jax(size, kw):
    from instantir_tpu.cli.infer import resize_img as j_resize_img

    img = Image.fromarray((np.random.default_rng(0).uniform(size=size[::-1] + (3,)) * 255).astype(np.uint8))
    (ja, jsize), (ta, tsize) = j_resize_img(img, **kw), tinfer.resize_img(img, **kw)
    assert tsize == jsize and ta.size == ja.size
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(ja))


@pytest.mark.parametrize("flags", [[], ["--denoising_start", "600"], ["--denoising_start", "20",
                                                                      "--num_inference_steps", "50"],
                                   ["--denoising_start", "2", "--num_inference_steps", "4"],
                                   ["--cfg", "3", "--preview_start", "0.1", "--creative_start", "0.7", "--fused",
                                    "--shared_cfg", "--multistep_restore"]])
def test_restore_config_matches_the_jax_cli(tmp_path, monkeypatch, flags):
    """The JAX CLI's ``main`` up to its ``RestoreConfig`` (stub models, an
    empty input folder) against the port's ``restore_config``."""
    import instantir_tpu.pipeline.instantir as jinst
    from instantir_tpu.cli import infer as jinfer

    seen = {}

    class Capture(jinst.RestoreConfig):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen["cfg"] = self

    monkeypatch.setattr(jinst, "RestoreConfig", Capture)
    monkeypatch.setattr(jload, "load_instantir_pipeline", lambda *a, **k: object())
    monkeypatch.setattr(jload, "load_text_encoders", lambda *a, **k: ((None,) * 3, (None,) * 3))
    (tmp_path / "lq").mkdir()
    argv = ["--sdxl_path", "s", "--instantir_path", "i", "--vision_encoder_path", "v", "--test_path",
            str(tmp_path / "lq"), "--out_path", str(tmp_path / "out")] + flags
    jinfer.main(argv)
    port = tinfer.restore_config(tinfer.build_parser().parse_args(argv))
    jcfg = seen["cfg"]
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(jcfg, field.name), field.name


def test_cli_parser_takes_every_jax_flag():
    from instantir_tpu.cli.infer import build_parser as j_build_parser

    def flags(p):
        return {a.dest: (a.default, a.const, a.choices, a.required) for a in p._actions}

    assert flags(tinfer.build_parser()) == flags(j_build_parser())


@pytest.mark.parametrize("flag", ["--quantized", "--sequence_parallel", "--use_clip_encoder"])
def test_cli_refuses_the_flags_not_ported(flag, tmp_path):
    """Every one of these flags is ported now: ``--quantized``,
    ``--use_clip_encoder`` and ``--sequence_parallel`` (without torchrun the
    process-group join is a no-op) get past the flag checks to the load,
    which fails on the missing folder."""
    argv = ["--sdxl_path", str(tmp_path / "s"), "--instantir_path", "i", "--vision_encoder_path", "v",
            "--test_path", "t", flag]
    parsed = tinfer.build_parser().parse_args(argv)
    assert {"--quantized": parsed.quantized == "w8a8", "--use_clip_encoder": parsed.use_clip_encoder,
            "--sequence_parallel": parsed.sequence_parallel}[flag]
    with pytest.raises(Exception) as info:
        tinfer.main(argv, device="cpu")
    assert not isinstance(info.value, NotImplementedError)


def test_watermark_matches_jax():
    from instantir_tpu.utils import watermark as jwm

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 256, 264, 3)).astype(np.float32)
    out = twm.embed_watermark(images)
    np.testing.assert_array_equal(out, jwm.embed_watermark(images))
    bits = rng.integers(0, 2, 48)
    for image in twm.embed_watermark(images, bits):
        np.testing.assert_array_equal(twm.extract_watermark(image), bits)
    np.testing.assert_array_equal(twm.extract_watermark(out[0]), np.asarray(twm.WATERMARK_BITS))


def test_trainer_exports_load_back_strictly(tree, loaded, tmp_path):
    """The port trainers' ``export_adapter``, ``export_aggregator`` and
    ``export_lora`` files, written at the tiny config, make an InstantIR
    folder that the port's loader reads strictly and the JAX loader reads
    too: both give back the parameters they were exported from (the
    Resampler's LoRA, which ``export_lora`` leaves out, is drawn anew)."""
    from instantir_tpu_torch.train.previewer_lora import PreviewerConfig, PreviewerTrainer
    from instantir_tpu_torch.train.stage1_adapter import Stage1Config, Stage1Trainer
    from instantir_tpu_torch.train.stage2_aggregator import Stage2Config, Stage2Trainer

    _, src = loaded("fp32")
    p = src
    inst = tmp_path / "instantir"
    inst.mkdir()
    Stage1Trainer(p.unet, p.resampler, p.vae, p.image_encoder, Stage1Config(), device="cpu").export_adapter(
        str(inst / "adapter.pt"))
    Stage2Trainer(p.unet, p.aggregator, p.resampler, p.vae, p.image_encoder, Stage2Config(),
                  device="cpu").export_aggregator(str(inst / "aggregator.pt"))
    PreviewerTrainer(p.unet, p.resampler, p.vae, p.image_encoder, PreviewerConfig(), device="cpu").export_lora(
        str(inst / "previewer_lora_weights.bin"))
    shutil.copy(tree["root"] / "instantir" / "instantir_config.json", inst)
    args = (str(tree["root"] / "sdxl"), str(inst))
    kw = dict(vision_encoder_path=str(tree["root"] / "dinov2"), dtype=torch.float32)
    back = tload.load_instantir_pipeline(*args, device="cpu", strict=True, **kw)
    jback = _jax_state(jload.load_instantir_pipeline(*args, vision_encoder_path=kw["vision_encoder_path"],
                                                     dtype=jnp.float32), tree["dcfg"])
    for model_name in ("unet", "aggregator", "resampler"):
        want = getattr(src, model_name).state_dict()
        model = getattr(back, model_name)
        for name, t in model.state_dict().items():
            if model_name == "resampler" and "lora_" in name:
                _check_fresh(model, name, _f32(t), _f32(jback[model_name][name]))
                continue
            torch.testing.assert_close(t, want[name], rtol=0, atol=0, msg=f"{model_name}.{name}")
            np.testing.assert_array_equal(_f32(t), _f32(jback[model_name][name]), err_msg=f"{model_name}.{name}")


def test_save_and_load_params_round_trip(loaded, tmp_path):
    _, pipe = loaded("fp32")
    before = {name: {k: v.clone() for k, v in getattr(pipe, name).state_dict().items()} for name in pipe._MODELS}
    file = pipe.save_params(str(tmp_path / "ckpt"))
    assert os.path.basename(file) == "params.pt"
    with torch.no_grad():
        for name in pipe._MODELS:
            for p in getattr(pipe, name).parameters():
                p.add_(1.0)
    pipe.load_params(str(tmp_path / "ckpt"))
    for name in pipe._MODELS:
        for k, v in getattr(pipe, name).state_dict().items():
            torch.testing.assert_close(v, before[name][k], rtol=0, atol=0)


def test_cli_restores_two_aspect_ratios_at_their_sizes(tree, tmp_path):
    """The port's ``main`` on the CPU: a 90x70 and a 70x150 image resize to
    64x64 and 64x128 (two groups of one batch), restore, and come back at
    their own sizes."""
    lq = tmp_path / "lq"
    lq.mkdir()
    rng = np.random.default_rng(1)
    sizes = {"a.png": (90, 70), "b.png": (70, 150)}
    for name, (w, h) in sizes.items():
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)).save(lq / name)
    root = tree["root"]
    out = tmp_path / "out"
    records = tinfer.main(["--sdxl_path", str(root / "sdxl"), "--instantir_path", str(root / "instantir"),
                           "--vision_encoder_path", str(root / "dinov2"), "--test_path", str(lq),
                           "--out_path", str(out), "--num_inference_steps", "2", "--min_side", "64",
                           "--max_side", "192", "--watermark"], device="cpu")
    assert sorted(os.listdir(out)) == sorted(sizes)
    assert [(r["files"], r["size"]) for r in records] == [(["a.png"], (64, 64)), (["b.png"], (64, 128))]
    for name, size in sizes.items():
        img = Image.open(out / name)
        assert img.size == size and img.mode == "RGB"
        assert np.asarray(img).std() > 0
    assert all(0 < r["restore_seconds"] <= r["seconds"] for r in records)


def test_cli_png_equals_the_restore_of_its_input(tree, tmp_path):
    """The port's ``main`` on the CPU, with its own load, on a 128x64 image
    (both resizes the identity): the PNG it writes equals the restore of the
    same pixels by a second load of the tree, with the same prompt
    embeddings, the same seeded generator and the same uint8 mapping."""
    lq = tmp_path / "lq"
    lq.mkdir()
    rgb = (np.random.default_rng(2).uniform(size=(64, 128, 3)) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(lq / "c.png")
    root = tree["root"]
    argv = ["--sdxl_path", str(root / "sdxl"), "--instantir_path", str(root / "instantir"),
            "--vision_encoder_path", str(root / "dinov2"), "--test_path", str(lq), "--out_path", str(tmp_path / "out"),
            "--num_inference_steps", "2", "--min_side", "64", "--max_side", "192", "--seed", "3"]
    tinfer.main(argv, device="cpu")
    got = np.asarray(tinfer.read_image(str(tmp_path / "out" / "c.png")))
    args = tinfer.build_parser().parse_args(argv)
    pipe, encoders = tinfer.load_models(args, device="cpu")
    pe, pooled = tinfer.encode_prompts(encoders, [tinfer.DEFAULT_PROMPT], "cpu")
    npe, npooled = tinfer.encode_prompts(encoders, [tinfer.DEFAULT_NEG_PROMPT], "cpu")
    image, _ = pipe.restore(torch.from_numpy(rgb.astype(np.float32)[None] / 127.5 - 1.0), pe, pooled,
                            negative_prompt_embeds=npe, negative_pooled_embeds=npooled,
                            cfg=tinfer.restore_config(args), generator=torch.Generator().manual_seed(3))
    want = (((np.clip(image[0], -1.0, 1.0) + 1.0) / 2.0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_restore_gives_its_inputs_row_major_strides():
    """``x[None]`` of a numpy array has batch stride 0, ``np.stack`` has
    H*W*3: on the card the stride picks the VAE convolutions' layout, so
    ``restore`` hands its models row-major copies."""
    from instantir_tpu_torch.pipeline.instantir import _dense

    x = torch.from_numpy(np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)[None])
    assert x.stride() == (0, 24, 3, 1)
    y = _dense(x, torch.device("cpu"))
    assert y.stride() == (192, 24, 3, 1) and torch.equal(x, y)


def _imported_modules(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_hf_packages_and_pillow_only_in_functions():
    """The port (and ``chip_smoke.py``) reads checkpoints, tokenizes and
    writes TensorBoard event files without ``transformers``, ``safetensors``,
    ``regex`` or tensorboardX: it needs torch, numpy, scipy and the standard
    library alone. PyYAML is imported only inside the functions that read
    the YAML configs. Pillow is imported only inside the functions of the
    command-line entry points (inference, serving, demo, training), of the
    datasets (image decode) and of the event writer (PNG summaries)."""
    files = sorted((REPO / "instantir_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("convert.py", "pipeline/load.py", "models/clip_text.py", "utils/tokenizer.py", "utils/text.py",
                "utils/watermark.py", "cli/infer.py", "cli/serve.py", "cli/app.py", "pipeline/slots.py",
                "data/kernels.py", "data/degradation.py", "data/dataset.py", "cli/train.py"):
        assert f"instantir_tpu_torch/{new}" in names
    bad = [f"{f.relative_to(REPO)}: {m}" for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "flax", "instantir_tpu", "transformers", "safetensors", "regex",
                                  "tensorboardX")]
    bad += [f"{f.relative_to(REPO)}: {m} at the top level" for f in files for m in _imported_modules(f, True)
            if m.split(".")[0] in ("PIL", "yaml")]
    pillow_users = ("cli/infer.py", "cli/serve.py", "cli/app.py", "cli/train.py", "data/dataset.py", "train/common.py",
                    "utils/vis.py", "data/face_dataset.py")
    bad += [f"{f.relative_to(REPO)}: {m}" for f in files for m in _imported_modules(f)
            if m.split(".")[0] == "PIL" and str(f.relative_to(REPO / "instantir_tpu_torch")) not in pillow_users]
    assert not bad, bad
