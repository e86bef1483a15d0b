"""JAX/Flax parameter tree (as numpy arrays) -> the port's state dicts.

The port's own copy of the exporters of ``instantir_tpu/convert/flax_to_torch.py``
that the restore path needs (``export_unet``, ``export_aggregator``,
``export_resampler``, ``export_vae``, ``export_dinov2``), and exporters of the
perceptual losses' towers for the tests (``export_clip_vision``,
``export_clip_image_encoder``, ``export_lpips``, ``export_arcface``). They emit the
diffusers / HF ``transformers`` / reference state-dict names with OIHW conv
and ``[out, in]`` linear weights, which are the port's parameter names, so
``module.load_state_dict(to_torch(export_x(tree)), strict=True)`` carries a
JAX model's weights across. The tree may hold numpy arrays or anything
``np.asarray`` accepts.

The exporters are linear re-layouts, so a *gradient* tree of a JAX train step
(the same tree shape as the parameters, zeros at frozen leaves) goes through
them unchanged: ``export_named`` runs several models' trees through their
exporters and returns ``{"<model>.<parameter name>": array}``, the names of
``train.common.named_parameters``, so gradients and updated parameters compare
name by name. ``export_ip_adapter`` and ``export_adapter`` lay the stage-1
result out as the reference's ``adapter.pt`` payload.

The model variants' leaves carry over too: ``export_unet`` writes a
``residual_fusion="zero_sft"`` UNet's ``up_blocks.{i}.zero_sfts.{j}.*`` and
``mid_zero_sft.*``; ``export_aggregator`` the attn1 ip branch of the
``aggregator_adapter`` (``attn1.processor.to_k_ip`` ...), the ``sep_split``
AdaLNs ``attn1.ln_k_ref`` / ``ln_v_ref``, and any attention's
``ln_k_ext`` / ``ln_v_ext`` (``ta_additive``); ``export_kv_copy``,
``export_conditioning_embedding``, ``export_image_proj`` and
``export_mlp_proj`` the standalone modules; the stage-2 ``agg_resampler``
goes through ``export_resampler``. Neither the JAX exporter nor any released
checkpoint names the ZeroSFT, split or ext leaves: their names here are the
port modules' attributes.

The other way, for ``pipeline/load.py``: ``load_torch_state_dict`` reads a
checkpoint file (its own ``.safetensors`` reader: the port needs no
``safetensors`` package), ``import_ip_adapter`` and
``import_previewer_lora`` rename ``adapter.pt``'s ip projections and the
previewer LoRA file's keys to the port's names, and ``import_clip_vision``
takes an HF CLIP vision tower's tensors by name.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch


def _inv_linear(out: Dict[str, np.ndarray], prefix: str, node: Dict[str, Any]):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
    if "bias" in node:
        out[f"{prefix}.bias"] = np.asarray(node["bias"])


def _inv_conv(out: Dict[str, np.ndarray], prefix: str, node: Dict[str, Any]):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
    if "bias" in node:
        out[f"{prefix}.bias"] = np.asarray(node["bias"])


def _inv_norm(out: Dict[str, np.ndarray], prefix: str, node: Dict[str, Any]):
    out[f"{prefix}.weight"] = np.asarray(node["scale"])
    out[f"{prefix}.bias"] = np.asarray(node["bias"])


def _inv_gn32(out, prefix, node):
    _inv_norm(out, prefix, node["norm"])


def _inv_lora_dense(out, prefix, node):
    _inv_linear(out, prefix, node["base"])
    if "lora_a" in node:
        out[f"{prefix}.lora_A.weight"] = np.ascontiguousarray(np.asarray(node["lora_a"]["kernel"]).T)
        out[f"{prefix}.lora_B.weight"] = np.ascontiguousarray(np.asarray(node["lora_b"]["kernel"]).T)


def _inv_lora_conv(out, prefix, node):
    _inv_conv(out, prefix, node["base"])
    if "lora_a" in node:
        out[f"{prefix}.lora_A.weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(node["lora_a"]["kernel"]), (3, 2, 0, 1))
        )
        out[f"{prefix}.lora_B.weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(node["lora_b"]["kernel"]), (3, 2, 0, 1))
        )


def _inv_time_embedding(out, prefix, node):
    _inv_linear(out, f"{prefix}.linear_1", node["linear_1"])
    _inv_linear(out, f"{prefix}.linear_2", node["linear_2"])
    if "cond_proj" in node:
        _inv_linear(out, f"{prefix}.cond_proj", node["cond_proj"])


def _inv_attention(out, prefix, node):
    _inv_lora_dense(out, f"{prefix}.to_q", node["to_q"])
    _inv_lora_dense(out, f"{prefix}.to_k", node["to_k"])
    _inv_lora_dense(out, f"{prefix}.to_v", node["to_v"])
    _inv_lora_dense(out, f"{prefix}.to_out.0", node["to_out"])
    if "to_k_ip" in node:
        p = f"{prefix}.processor"
        _inv_lora_dense(out, f"{p}.to_k_ip", node["to_k_ip"])
        _inv_lora_dense(out, f"{p}.to_v_ip", node["to_v_ip"])
        if "ln_k_ip" in node:
            _inv_lora_dense(out, f"{p}.ln_k_ip.linear", node["ln_k_ip"]["linear"])
            _inv_lora_dense(out, f"{p}.ln_v_ip.linear", node["ln_v_ip"]["linear"])
    for ln in ("ln_k_ref", "ln_v_ref", "ln_k_ext", "ln_v_ext"):  # SplitAttention "sep"; ta_additive
        if ln in node:
            _inv_lora_dense(out, f"{prefix}.{ln}.linear", node[ln]["linear"])


def _inv_zero_sft(out, prefix, node):
    for name in ("zero_conv", "mlp_shared", "zero_mul", "zero_add"):
        _inv_conv(out, f"{prefix}.{name}", node[name])
    if "param_free_norm" in node:
        _inv_gn32(out, f"{prefix}.param_free_norm", node["param_free_norm"])


def _inv_transformer_block(out, prefix, node):
    _inv_norm(out, f"{prefix}.norm1", node["norm1"])
    _inv_attention(out, f"{prefix}.attn1", node["attn1"])
    if "attn2" in node:
        _inv_norm(out, f"{prefix}.norm2", node["norm2"])
        _inv_attention(out, f"{prefix}.attn2", node["attn2"])
    _inv_norm(out, f"{prefix}.norm3", node["norm3"])
    _inv_lora_dense(out, f"{prefix}.ff.net.0.proj", node["ff"]["proj"])
    _inv_lora_dense(out, f"{prefix}.ff.net.2", node["ff"]["out"])


def _inv_transformer2d(out, prefix, node):
    _inv_gn32(out, f"{prefix}.norm", node["norm"])
    _inv_lora_dense(out, f"{prefix}.proj_in", node["proj_in"])
    _inv_lora_dense(out, f"{prefix}.proj_out", node["proj_out"])
    for name, sub in node.items():
        if name.startswith("blocks_"):
            _inv_transformer_block(out, f"{prefix}.transformer_blocks.{name.split('_')[-1]}", sub)


def _inv_resnet(out, prefix, node):
    _inv_gn32(out, f"{prefix}.norm1", node["norm1"])
    _inv_lora_conv(out, f"{prefix}.conv1", node["conv1"])
    _inv_gn32(out, f"{prefix}.norm2", node["norm2"])
    _inv_lora_conv(out, f"{prefix}.conv2", node["conv2"])
    if "time_emb_proj" in node:
        _inv_lora_dense(out, f"{prefix}.time_emb_proj", node["time_emb_proj"])
    if "conv_shortcut" in node:
        _inv_lora_conv(out, f"{prefix}.conv_shortcut", node["conv_shortcut"])


def _inv_block(out, prefix, node):
    for name, sub in sorted(node.items()):
        if name.startswith("resnets_"):
            _inv_resnet(out, f"{prefix}.resnets.{name.split('_')[-1]}", sub)
        elif name.startswith("attentions_"):
            _inv_transformer2d(out, f"{prefix}.attentions.{name.split('_')[-1]}", sub)
        elif name == "downsamplers_0":
            _inv_lora_conv(out, f"{prefix}.downsamplers.0.conv", sub["conv"])
        elif name == "upsamplers_0":
            _inv_lora_conv(out, f"{prefix}.upsamplers.0.conv", sub["conv"])
        elif name.startswith("zero_sfts_"):
            _inv_zero_sft(out, f"{prefix}.zero_sfts.{name.split('_')[-1]}", sub)


def _inv_sft(out, prefix, node):
    _inv_conv(out, f"{prefix}.0.mlp_shared.0", node["mlp_shared"])
    _inv_conv(out, f"{prefix}.0.mul", node["mul"])
    _inv_conv(out, f"{prefix}.0.add", node["add"])
    _inv_conv(out, f"{prefix}.1", node["zero_conv"])


def export_unet(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_conv(out, "conv_in", p["conv_in"]["base"])
    _inv_time_embedding(out, "time_embedding", p["time_embedding"])
    _inv_time_embedding(out, "add_embedding", p["add_embedding"])
    for name, node in p.items():
        if name.startswith("down_blocks_"):
            _inv_block(out, f"down_blocks.{name.split('_')[-1]}", node)
        elif name.startswith("up_blocks_"):
            _inv_block(out, f"up_blocks.{name.split('_')[-1]}", node)
    _inv_block(out, "mid_block", p["mid_block"])
    if "mid_zero_sft" in p:
        _inv_zero_sft(out, "mid_zero_sft", p["mid_zero_sft"])
    _inv_gn32(out, "conv_norm_out", p["conv_norm_out"])
    _inv_conv(out, "conv_out", p["conv_out"]["base"])
    return out


def export_aggregator(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_conv(out, "conv_in", p["conv_in"]["base"])
    _inv_conv(out, "ref_conv_in", p["ref_conv_in"]["base"])
    _inv_time_embedding(out, "time_embedding", p["time_embedding"])
    _inv_time_embedding(out, "add_embedding", p["add_embedding"])
    for name, node in p.items():
        if name.startswith("down_blocks_"):
            _inv_block(out, f"down_blocks.{name.split('_')[-1]}", node)
        elif name.startswith("controlnet_down_blocks_"):
            _inv_sft(out, f"controlnet_down_blocks.{name.split('_')[-1]}", node)
    _inv_block(out, "mid_block", p["mid_block"])
    _inv_sft(out, "controlnet_mid_block", p["controlnet_mid_block"])
    return out


def export_resampler(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {"latents": np.asarray(p["latents"])}
    _inv_linear(out, "proj_in", p["proj_in"])
    _inv_linear(out, "proj_out", p["proj_out"])
    _inv_norm(out, "norm_out", p["norm_out"])
    depth = len([k for k in p if k.endswith("_attn")])
    for i in range(depth):
        a = p[f"layers_{i}_attn"]
        _inv_norm(out, f"layers.{i}.0.norm1", a["norm1"])
        _inv_norm(out, f"layers.{i}.0.norm2", a["norm2"])
        _inv_lora_dense(out, f"layers.{i}.0.to_q", a["to_q"])
        _inv_lora_dense(out, f"layers.{i}.0.to_kv", a["to_kv"])
        _inv_lora_dense(out, f"layers.{i}.0.to_out", a["to_out"])
        _inv_norm(out, f"layers.{i}.1.0", p[f"layers_{i}_ff_norm"])
        _inv_linear(out, f"layers.{i}.1.1", p[f"layers_{i}_ff_in"])
        _inv_linear(out, f"layers.{i}.1.3", p[f"layers_{i}_ff_out"])
    return out


def export_kv_copy(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_lora_dense(out, "to_k", p["to_k"])
    _inv_lora_dense(out, "to_v", p["to_v"])
    return out


def export_conditioning_embedding(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_conv(out, "conv_in", p["conv_in"])
    for name, node in p.items():
        if name.startswith("blocks_"):
            _inv_conv(out, f"blocks.{name.split('_')[-1]}", node)
    _inv_conv(out, "conv_out", p["conv_out"])
    return out


def export_image_proj(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``ImageProjModel``'s tree (``proj``, ``norm``)."""
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_linear(out, "proj", p["proj"])
    _inv_norm(out, "norm", p["norm"])
    return out


def export_mlp_proj(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``MLPProjModel``'s tree (``fc1``, ``fc2``, ``norm``)."""
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}
    _inv_linear(out, "fc1", p["fc1"])
    _inv_linear(out, "fc2", p["fc2"])
    _inv_norm(out, "norm", p["norm"])
    return out


def export_vae(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def vae_resnet(prefix, node):
        _inv_gn32(out, f"{prefix}.norm1", node["norm1"])
        _inv_conv(out, f"{prefix}.conv1", node["conv1"])
        _inv_gn32(out, f"{prefix}.norm2", node["norm2"])
        _inv_conv(out, f"{prefix}.conv2", node["conv2"])
        if "conv_shortcut" in node:
            _inv_conv(out, f"{prefix}.conv_shortcut", node["conv_shortcut"])

    def vae_attention(prefix, node):
        _inv_gn32(out, f"{prefix}.group_norm", node["group_norm"])
        _inv_linear(out, f"{prefix}.to_q", node["to_q"])
        _inv_linear(out, f"{prefix}.to_k", node["to_k"])
        _inv_linear(out, f"{prefix}.to_v", node["to_v"])
        _inv_linear(out, f"{prefix}.to_out.0", node["to_out"])

    def side(side_name, kind):
        sp = p[side_name]
        _inv_conv(out, f"{side_name}.conv_in", sp["conv_in"])
        for name, node in sp.items():
            if "_resnets_" in name:
                parts = name.split("_")  # e.g. down_blocks_0_resnets_1
                vae_resnet(f"{side_name}.{kind}_blocks.{parts[2]}.resnets.{parts[4]}", node)
            elif name.endswith("_downsample"):
                _inv_conv(out, f"{side_name}.down_blocks.{name.split('_')[2]}.downsamplers.0.conv", node)
            elif name.endswith("_upsample"):
                _inv_conv(out, f"{side_name}.up_blocks.{name.split('_')[2]}.upsamplers.0.conv", node)
        vae_resnet(f"{side_name}.mid_block.resnets.0", sp["mid_block"]["resnets_0"])
        vae_attention(f"{side_name}.mid_block.attentions.0", sp["mid_block"]["attentions_0"])
        vae_resnet(f"{side_name}.mid_block.resnets.1", sp["mid_block"]["resnets_1"])
        _inv_gn32(out, f"{side_name}.conv_norm_out", sp["conv_norm_out"])
        _inv_conv(out, f"{side_name}.conv_out", sp["conv_out"])

    side("encoder", "down")
    side("decoder", "up")
    _inv_conv(out, "quant_conv", p["quant_conv"])
    _inv_conv(out, "post_quant_conv", p["post_quant_conv"])
    return out


def export_dinov2(tree: Dict[str, Any], num_layers: int) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    p = tree["params"]
    out["embeddings.cls_token"] = np.asarray(p["cls_token"])
    out["embeddings.position_embeddings"] = np.asarray(p["pos_embed"])
    _inv_conv(out, "embeddings.patch_embeddings.projection", p["patch_embed"])
    _inv_norm(out, "layernorm", p["norm"])
    for i in range(num_layers):
        n = p[f"blocks_{i}"]
        q = f"encoder.layer.{i}"
        _inv_norm(out, f"{q}.norm1", n["norm1"])
        _inv_linear(out, f"{q}.attention.attention.query", n["q"])
        _inv_linear(out, f"{q}.attention.attention.key", n["k"])
        _inv_linear(out, f"{q}.attention.attention.value", n["v"])
        _inv_linear(out, f"{q}.attention.output.dense", n["proj"])
        out[f"{q}.layer_scale1.lambda1"] = np.asarray(n["layerscale1"])
        _inv_norm(out, f"{q}.norm2", n["norm2"])
        _inv_linear(out, f"{q}.mlp.fc1", n["fc1"])
        _inv_linear(out, f"{q}.mlp.fc2", n["fc2"])
        out[f"{q}.layer_scale2.lambda1"] = np.asarray(n["layerscale2"])
    return out


def export_clip_vision(tree: Dict[str, Any], num_layers: int, head: bool = True) -> Dict[str, np.ndarray]:
    """A JAX ``CLIPVisionModel`` tree -> HF ``CLIPVisionModelWithProjection``
    names (the inverse of ``convert_clip_vision``); ``head=False`` leaves out
    ``post_layernorm`` and ``visual_projection``, which ``CLIPImageEncoder``
    does not hold (a JAX tree converted from a whole tower may)."""
    out: Dict[str, np.ndarray] = {}
    p, q = tree["params"], "vision_model."
    out[f"{q}embeddings.class_embedding"] = np.asarray(p["cls_token"])
    out[f"{q}embeddings.position_embedding.weight"] = np.asarray(p["pos_embed"])
    _inv_conv(out, f"{q}embeddings.patch_embedding", p["patch_embed"])
    _inv_norm(out, f"{q}pre_layrnorm", p["pre_norm"])
    if head:
        _inv_norm(out, f"{q}post_layernorm", p["post_norm"])
    for i in range(num_layers):
        n, layer = p[f"layers_{i}"], f"{q}encoder.layers.{i}"
        _inv_norm(out, f"{layer}.layer_norm1", n["norm1"])
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("proj", "out_proj")):
            _inv_linear(out, f"{layer}.self_attn.{dst}", n[src])
        _inv_norm(out, f"{layer}.layer_norm2", n["norm2"])
        _inv_linear(out, f"{layer}.mlp.fc1", n["fc1"])
        _inv_linear(out, f"{layer}.mlp.fc2", n["fc2"])
    if head and "visual_projection" in p:
        _inv_linear(out, "visual_projection", p["visual_projection"])
    return out


def export_clip_image_encoder(tree: Dict[str, Any], num_layers: int) -> Dict[str, np.ndarray]:
    """A JAX ``CLIPImageEncoder`` tree (``{"params": {"clip": ...}}``, the
    first ``num_layers - 1`` layers) -> the port ``CLIPImageEncoder``'s state dict."""
    return export_clip_vision({"params": tree["params"]["clip"]}, num_layers - 1, head=False)


def import_clip_vision(sd: Dict[str, Any], names) -> Dict[str, Any]:
    """An HF ``CLIPVisionModelWithProjection`` (or ``CLIPModel``) state dict ->
    the tensors of a port ``CLIPVisionModel`` or ``CLIPImageEncoder`` with
    parameter ``names``: the port's names are HF's (``vision_model.*``, HF's
    ``pre_layrnorm`` spelling, ``visual_projection.weight``), so each is
    taken by name and the rest (a text tower, the last layer and the
    post-norm an image encoder never reads) is passed over. A name ``sd``
    lacks raises ``KeyError``."""
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"the CLIP vision checkpoint lacks {len(missing)} of the model's tensors (first: {missing[:5]})")
    return {n: sd[n] for n in names}


def export_lpips(tree: Dict[str, Any], config) -> Dict[str, np.ndarray]:
    """A JAX ``LPIPS`` tree -> the published ``lpips.LPIPS(net='vgg')`` names."""
    out: Dict[str, np.ndarray] = {}
    p = tree["params"]
    for si, conv_ids in enumerate(config.slices):
        for ci in conv_ids:
            _inv_conv(out, f"net.slice{si + 1}.{ci}", p[f"conv_{ci}"])
        _inv_conv(out, f"lin{si}.model.1", p[f"lin_{si}"])
    return out


def export_arcface(tree: Dict[str, Any], config) -> Dict[str, np.ndarray]:
    """A JAX ``ArcFaceBackbone`` tree (BatchNorms folded) -> the port
    ``ArcFaceBackbone``'s state dict (InsightFace module names, ``Affine``
    ``scale`` / ``bias``). The JAX head flattens NHWC and its converter
    permutes ``output_layer.3``'s input columns to match; the port flattens
    NCHW, so the permutation is undone here."""
    out: Dict[str, np.ndarray] = {}
    p = tree["params"]

    def affine(prefix, node):
        out[f"{prefix}.scale"] = np.asarray(node["scale"])
        out[f"{prefix}.bias"] = np.asarray(node["bias"])

    _inv_conv(out, "input_layer.0", p["stem_conv"])
    affine("input_layer.1", p["stem_bn"])
    out["input_layer.2.weight"] = np.asarray(p["stem_prelu"])
    bi = 0
    for _, n_units in config.stages:
        for _ in range(n_units):
            blk, q = p[f"block_{bi}"], f"body.{bi}"
            affine(f"{q}.res_layer.0", blk["bn0"])
            _inv_conv(out, f"{q}.res_layer.1", blk["conv1"])
            out[f"{q}.res_layer.2.weight"] = np.asarray(blk["prelu"])
            _inv_conv(out, f"{q}.res_layer.3", blk["conv2"])
            affine(f"{q}.res_layer.4", blk["bn2"])
            _inv_conv(out, f"{q}.res_layer.5.fc1", blk["se_fc1"])
            _inv_conv(out, f"{q}.res_layer.5.fc2", blk["se_fc2"])
            if "shortcut_conv" in blk:
                _inv_conv(out, f"{q}.shortcut_layer.0", blk["shortcut_conv"])
                affine(f"{q}.shortcut_layer.1", blk["shortcut_bn"])
            bi += 1
    affine("output_layer.0", p["head_bn"])
    spatial, c = config.input_size // (2 ** len(config.stages)), config.stages[-1][0]
    w = np.asarray(p["head_fc"]["kernel"]).T  # [emb, H·W·C], the NHWC flatten
    out["output_layer.3.weight"] = np.ascontiguousarray(
        w.reshape(-1, spatial, spatial, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1))
    out["output_layer.3.bias"] = np.asarray(p["head_fc"]["bias"])
    affine("output_layer.4", p["head_bn1d"])
    return out


def to_torch(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state dict -> tensors (``load_state_dict`` casts to each parameter's dtype)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}


_EXPORTERS = {"unet": export_unet, "aggregator": export_aggregator, "resampler": export_resampler, "vae": export_vae,
              "agg_resampler": export_resampler}


def export_named(trees: Dict[str, Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """``{"unet": tree, "resampler": tree, ...}`` (parameters or gradients)
    -> one flat dict under ``<model>.<parameter name>``."""
    out: Dict[str, np.ndarray] = {}
    for model, tree in trees.items():
        for name, value in _EXPORTERS[model](tree).items():
            out[f"{model}.{name}"] = value
    return out


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def export_quantized(export, tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX model tree quantized by ``instantir_tpu/ops/quant.py::quantize_tree``
    (``{"params": pruned tree, "quant": {..., "base": {"kernel_q" or
    "kernel_qw", "kernel_scale"}}}``) -> the port's state dict through its
    exporter ``export`` (``export_unet``, ``export_aggregator``): each
    quantized base's codes as int8 ``<name>.weight_q`` (W8A8) or
    ``<name>.weight_qw`` (W8), HWIO -> OIHW and ``[in, out]`` -> ``[out, in]``,
    and its fp32 ``<name>.weight_scale [out]``, in place of ``<name>.weight``.
    The exporters are linear re-layouts, so the codes, the scales broadcast
    over each kernel and a mask of the modes go through them as kernels."""
    quant = tree.get("quant", {})

    def fill(params, qnode, fn):
        """``params`` with each quantized base's kernel set to ``fn(entry, codes)``."""
        out = dict(params)
        for key, q in qnode.items():
            if key == "base" and "kernel_scale" in q:
                codes = np.asarray(q.get("kernel_q", q.get("kernel_qw")))
                out["base"] = {**params.get("base", {}), "kernel": fn(q, codes)}
            else:
                out[key] = fill(params.get(key, {}), q, fn)
        return out

    params = tree["params"]
    zeros = _map_tree(lambda a: np.zeros(a.shape, np.float32), params)
    mode = export({"params": fill(zeros, quant, lambda q, c: np.full(c.shape, 1.0 if "kernel_q" in q else 2.0,
                                                                       np.float32))})
    codes = export({"params": fill(params, quant, lambda q, c: c.astype(np.float32))})
    scales = export({"params": fill(zeros, quant, lambda q, c: np.broadcast_to(
        np.asarray(q["kernel_scale"], np.float32), c.shape).copy())})
    out = {}
    for name, value in codes.items():
        m = mode[name]
        if not (name.endswith(".weight") and m.any()):
            out[name] = value
            continue
        prefix = name[:-len("weight")]
        key = "weight_q" if m.flat[0] == 1.0 else "weight_qw"
        out[prefix + key] = value.astype(np.int8)
        out[prefix + "weight_scale"] = np.ascontiguousarray(scales[name].reshape(value.shape[0], -1)[:, 0])
    return out


def load_quantized(model: torch.nn.Module, state: Dict[str, np.ndarray]) -> None:
    """Quantize the bases of ``model`` that ``state`` (``export_quantized``'s
    result) holds codes for, in their modes, then load ``state`` strictly,
    each tensor in its own dtype."""
    from instantir_tpu_torch.ops.quant import quantize_like

    quantize_like(model, state)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, strict=True)


_PROCESSOR = re.compile(r"^(down_blocks|up_blocks|mid_block)\.(.*\.attn2)\.processor\.(.+)$")


def export_ip_adapter(unet_state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's UNet state dict -> ``adapter.pt["ip_adapter"]``: the ip
    projections of every cross-attention under ``{2n+1}.to_k_ip.weight``-style
    names, n counting the cross-attentions in the reference's processor order
    (``cross_attention_processors``). LoRA leaves are left out."""
    out: Dict[str, Any] = {}
    for n, prefix in enumerate(cross_attention_processors(unet_state)):
        for key, value in unet_state.items():
            if key.startswith(prefix + ".") and "lora_" not in key:
                out[f"{2 * n + 1}.{key[len(prefix) + 1:]}"] = value
    return out


def export_adapter(unet_state: Dict[str, Any], resampler_state: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The reference-format ``adapter_ckpt.pt`` payload ``{image_proj,
    ip_adapter}`` from the port's state dicts; the reference loads
    ``image_proj`` strictly, so no LoRA leaf may leak in."""
    return {"image_proj": {k: v for k, v in resampler_state.items() if "lora_" not in k},
            "ip_adapter": export_ip_adapter(unet_state)}


# ---------------------------------------------------------------------------
# checkpoint files -> the port's parameter names
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> ``{name: CPU tensor}`` in the file's dtypes:
    an 8-byte little-endian header length, the JSON header (``dtype``,
    ``shape``, ``data_offsets`` into the byte buffer that follows), then the
    buffer, read once; the tensors are views of it."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this reader does not take")
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != itemsize * int(np.prod(info["shape"], dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes for shape {info['shape']}")
        flat = torch.frombuffer(data, dtype=dtype, count=(end - begin) // itemsize, offset=begin) \
            if end > begin else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``{name: tensor}`` -> a ``.safetensors`` file (the layout
    ``read_safetensors`` reads; the header padded with spaces to 8 bytes),
    one tensor at a time through host memory."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Twin of ``instantir_tpu/convert/torch_to_flax.py::load_torch_state_dict``:
    a ``.safetensors``, ``.bin`` or ``.pt`` file -> one flat ``{name: CPU
    tensor}``. A ``state_dict`` wrapper is unwrapped and nested payloads (the
    ``{image_proj, ip_adapter}`` of ``adapter.pt``) flatten with dotted
    prefixes. Tensors keep the file's dtype: the loader casts them once."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]

    def flatten(d: Dict[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for k, v in d.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}.", out)
            else:
                out[f"{prefix}{k}"] = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return out

    return flatten(sd, "", {})


def cross_attention_processors(unet_names) -> list:
    """The ``<...>.attn2.processor`` prefixes of a UNet's parameter names in
    the reference's processor order (down, then up, then mid blocks; within
    each by block, attention and transformer-block index): the n-th holds
    processor ``2n + 1`` of ``adapter.pt["ip_adapter"]``."""
    group_order = {"down_blocks": 0, "up_blocks": 1, "mid_block": 2}
    found = {}
    for key in unet_names:
        m = _PROCESSOR.match(key)
        if m is not None:
            order = (group_order[m.group(1)], tuple(int(x) for x in re.findall(r"\d+", m.group(2))))
            found[order] = f"{m.group(1)}.{m.group(2)}.processor"
    return [found[k] for k in sorted(found)]


def import_ip_adapter(ip_sd: Dict[str, Any], unet_names, strict: bool = True) -> Dict[str, Any]:
    """Inverse of ``export_ip_adapter`` (twin of ``torch_to_flax.py::merge_ip_adapter``):
    ``adapter.pt["ip_adapter"]`` -> the UNet's ``<...>.attn2.processor.*``
    names. Every cross-attention needs its ``to_k_ip`` / ``to_v_ip`` weights
    (``KeyError`` otherwise); the AdaLN linears come along when present. A
    tensor that maps to no cross-attention raises under ``strict``."""
    consumed = set()
    out: Dict[str, Any] = {}

    def take(src: str, dst: str):
        consumed.add(src)
        out[dst] = ip_sd[src]

    for n, prefix in enumerate(cross_attention_processors(unet_names)):
        idx = 2 * n + 1
        take(f"{idx}.to_k_ip.weight", f"{prefix}.to_k_ip.weight")
        take(f"{idx}.to_v_ip.weight", f"{prefix}.to_v_ip.weight")
        if f"{idx}.ln_k_ip.linear.weight" in ip_sd:
            for ln in ("ln_k_ip", "ln_v_ip"):
                for leaf in ("weight", "bias"):
                    take(f"{idx}.{ln}.linear.{leaf}", f"{prefix}.{ln}.linear.{leaf}")
    leftover = sorted(set(ip_sd) - consumed)
    if leftover and strict:
        raise ValueError(f"{len(leftover)} ip-adapter tensors map to no attention module "
                         f"(first: {leftover[:5]}) -- pass strict=False to allow a partial load")
    return out


_LORA_KEY = re.compile(r"^(unet\.)?(.+)\.lora_([AB])\.weight$")
_RESAMPLER_LORA_KEY = re.compile(
    r"^unet\.encoder_hid_proj\.image_projection_layers\.0\.(layers\.\d+\.0\.(?:to_q|to_kv|to_out)\.lora_[AB]\.weight)$")


def import_previewer_lora(lora_sd: Dict[str, Any], unet_names, resampler_names):
    """A diffusers-format ``previewer_lora_weights.bin`` -> ``(UNet tensors,
    Resampler tensors, unmatched names)`` under the port's names (twin of
    ``torch_to_flax.py::merge_previewer_lora`` and ``merge_resampler_lora``):
    ``unet.<path>.lora_A.weight`` is the UNet's ``<path>.lora_A.weight``; the
    Resampler's LoRA lives at ``unet.encoder_hid_proj.image_projection_layers.0``
    in the reference's module tree. Names that are no LoRA tensor are passed
    over; a LoRA tensor that lands nowhere is returned as unmatched."""
    unet_names, resampler_names = set(unet_names), set(resampler_names)
    unet_out: Dict[str, Any] = {}
    res_out: Dict[str, Any] = {}
    unmatched = []
    for key, value in lora_sd.items():
        m = _LORA_KEY.match(key)
        if m is None:
            continue
        name = f"{m.group(2)}.lora_{m.group(3)}.weight"
        r = _RESAMPLER_LORA_KEY.match(key)
        if name in unet_names:
            unet_out[name] = value
        elif r is not None and r.group(1) in resampler_names:
            res_out[r.group(1)] = value
        else:
            unmatched.append(key)
    return unet_out, res_out, unmatched


def export_previewer_lora(unet_state: Dict[str, Any], resampler_state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's state dicts -> the payload of ``previewer_lora_weights.bin``:
    the UNet's LoRA tensors under ``unet.<name>`` (``PreviewerTrainer.lora_state``'s
    naming) and the Resampler's under ``unet.encoder_hid_proj.image_projection_layers.0.<name>``."""
    out = {f"unet.{k}": v for k, v in unet_state.items() if "lora_" in k}
    out.update({f"unet.encoder_hid_proj.image_projection_layers.0.{k}": v
                for k, v in resampler_state.items() if "lora_" in k})
    return out
