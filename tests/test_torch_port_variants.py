"""CPU parity of the port's model variants with their JAX twins.

``SplitAttention`` (joint and sep, with and without the pad row), the three
``external_kv`` modes, ``KVCopy`` / ``init_kv_copy`` / ``drop_kvs`` (fed the
indices JAX's ``jax.random.choice`` drew), ``ZeroSFT`` and the
``residual_fusion="zero_sft"`` UNet (forward and input gradients), the
Aggregator over ``pad_concat`` x ``attn1_mode`` with ``global_pool_conditions``
and the ``aggregator_adapter`` branch, ``ConditioningEmbedding``, the three
projection heads, every JAX guard, and the exporters' round trip.

Each JAX parameter tree has the structure of the JAX module's ``init`` with
every leaf drawn from a numpy seed (the zero convs, ``zero_mul`` /
``zero_add`` and the AdaLN linears included, so their paths are live), and
goes into the port through ``convert.py`` with ``load_state_dict(strict=True)``.
The JAX side runs the plain attention path (``use_flash=False``) and its
GroupNorm reference, as the JAX tests run on the CPU. The UNet and the
Aggregator take the slim tiny config (one resnet and one transformer layer a
block). fp32 throughout: the tolerances, stated per test, cover
summation-order differences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantir_tpu.models import attention as jattn
from instantir_tpu.models import ip_adapter as jip
from instantir_tpu.models import kv_cache as jkv
from instantir_tpu.models.aggregator import Aggregator as JAggregator
from instantir_tpu.models.aggregator import ConditioningEmbedding as JCondEmbed
from instantir_tpu.models.unet import UNet2DConditionModel as JUNet
from instantir_tpu.models.unet import tiny_unet_config as j_unet_cfg
from instantir_tpu.models.zero_sft import ZeroSFT as JZeroSFT
from instantir_tpu_torch import convert
from instantir_tpu_torch.models import ip_adapter
from instantir_tpu_torch.models.aggregator import Aggregator, ConditioningEmbedding
from instantir_tpu_torch.models.attention import Attention, SplitAttention
from instantir_tpu_torch.models.kv_cache import AttentionCache, KVCache, KVCopy, drop_kvs, init_kv_copy
from instantir_tpu_torch.models.unet import UNet2DConditionModel, down_stack_channels, tiny_unet_config
from instantir_tpu_torch.models.zero_sft import ZeroSFT

B = 2
LAT = 8  # Aggregator and UNet latents: the H-concat map is 16x8, 17x8 with the pad row
SLIM = dict(layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
AGG_TOL = 1e-4  # of the output's scale: a few dozen fp32 layers, the sums in another order


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


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


def _load_attention(module, params):
    sd = {}
    convert._inv_attention(sd, "m", params["params"])
    module.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    return module


# --------------------------------------------------------------------------
# attention: SplitAttention and external K/V
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["joint", "sep"])
@pytest.mark.parametrize("pad", [0, 1])
def test_split_attention_matches_jax(mode, pad):
    """The (cond | pad | ref) map of 4 + pad rows of 3 tokens; ``ref_scale``
    0.3. 1e-5: one attention layer."""
    rng = np.random.default_rng(10 + pad)
    h, w = 4 + pad, 3
    x = rng.standard_normal((B, h * w, 16)).astype(np.float32)
    temb = rng.standard_normal((B, 20)).astype(np.float32)
    jm = jattn.SplitAttention(16, 2, 8, mode=mode, use_flash=False)
    params = _init_random(jm, 11, x, (h, w), temb=temb)
    ref = np.asarray(jm.apply(params, x, (h, w), temb=temb, ref_scale=0.3))
    tm = _load_attention(SplitAttention(16, 2, 8, mode=mode, temb_dim=20), params)
    with torch.no_grad():
        got = tm(_t(x), (h, w), temb=_t(temb), ref_scale=0.3).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if pad:
        assert not got[:, 2 * w:3 * w].any()  # a fresh zero pad row


def test_joint_split_without_pad_equals_plain_attention():
    """The JAX docstring's equivalence, on the port: joint over the whole map
    is plain self-attention with the same weights (exact up to 1e-6)."""
    rng = np.random.default_rng(12)
    x = _t(rng.standard_normal((B, 12, 16)))
    split = SplitAttention(16, 2, 8, mode="joint")
    plain = Attention(16, 2, 8)
    plain.load_state_dict(split.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(split(x, (4, 3)), plain(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["concat", "additive", "ta_additive"])
def test_external_kv_matches_jax(mode):
    """Seven external tokens against twelve queries, LoRA at 0.5, additive
    scale 0.7. 1e-5."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, 12, 16)).astype(np.float32)
    temb = rng.standard_normal((B, 20)).astype(np.float32)
    ek, ev = (rng.standard_normal((B, 7, 16)).astype(np.float32) for _ in range(2))
    jm = jattn.Attention(16, 2, 8, external_kv_mode=mode, additive_scale=0.7, use_flash=False, lora_rank=2)
    params = _init_random(jm, 14, x, temb=temb, external_kv=jkv.KVCache(ek, ev))
    ref = np.asarray(jm.apply(params, x, temb=temb, external_kv=jkv.KVCache(ek, ev), lora_scale=0.5))
    tm = _load_attention(Attention(16, 2, 8, external_kv_mode=mode, additive_scale=0.7, temb_dim=20, lora_rank=2),
                         params)
    with torch.no_grad():
        got = tm(_t(x), temb=_t(temb), external_kv=KVCache(_t(ek), _t(ev)), lora_scale=0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the K/V cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lora_scale", [0.0, 0.5])
def test_kv_copy_matches_jax(lora_scale):
    rng = np.random.default_rng(15)
    hs = rng.standard_normal((B, 9, 16)).astype(np.float32)
    jm = jkv.KVCopy(inner_dim=16, lora_rank=2)
    params = _init_random(jm, 16, hs)
    ref = jm.apply(params, hs, lora_scale=lora_scale)
    tm = KVCopy(16, lora_rank=2)
    tm.load_state_dict(convert.to_torch(convert.export_kv_copy(params)), strict=True)
    with torch.no_grad():
        got = tm(_t(hs), lora_scale=lora_scale)
    assert isinstance(got, KVCache)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(ref.k), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), rtol=1e-5, atol=1e-6)


def test_init_kv_copy_matches_jax():
    """The source attention's base to_k / to_v go into the copy; its LoRA
    stays. The port copies in place and returns the module."""
    rng = np.random.default_rng(17)
    hs = rng.standard_normal((B, 9, 16)).astype(np.float32)
    jsrc = jattn.Attention(16, 2, 8, use_flash=False)
    src_params = _init_random(jsrc, 18, hs)
    jcopy = jkv.KVCopy(inner_dim=16, lora_rank=2)
    copy_params = _init_random(jcopy, 19, hs)
    jnew = jkv.init_kv_copy(copy_params, src_params)
    want = convert.export_kv_copy(jnew)

    src = _load_attention(Attention(16, 2, 8), src_params)
    tm = KVCopy(16, lora_rank=2)
    tm.load_state_dict(convert.to_torch(convert.export_kv_copy(copy_params)), strict=True)
    assert init_kv_copy(tm, src) is tm
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the cache of the source's own hidden states is the source's K/V
    with torch.no_grad():
        np.testing.assert_allclose(tm(_t(hs)).k.numpy(), src.to_k(_t(hs)).numpy(), rtol=0, atol=0)


def test_drop_kvs_on_jax_indices():
    """``drop_kvs(0.5)`` on two layers: the static counts of the JAX function
    and, fed the positions its ``jax.random.choice`` drew (sorted), the same
    tensors; the cross-attention cache passes whole. A draw from a generator
    keeps the same count, sorted and without repeats."""
    rng = np.random.default_rng(20)

    def cache(s):
        return [rng.standard_normal((B, s, 16)).astype(np.float32) for _ in range(4)]

    raw = {"down.0": cache(10), "mid": cache(7)}
    jc = {n: jkv.AttentionCache(jkv.KVCache(a, b), jkv.KVCache(c, d)) for n, (a, b, c, d) in raw.items()}
    tc = {n: AttentionCache(KVCache(_t(a), _t(b)), KVCache(_t(c), _t(d))) for n, (a, b, c, d) in raw.items()}
    key = jax.random.PRNGKey(3)
    want = jkv.drop_kvs(jc, 0.5, key)
    indices, k = {}, key
    for name, c in jc.items():  # the JAX function's key schedule
        k, sub = jax.random.split(k)
        s = c.self_attention.k.shape[1]
        keep = max(1, int(round(s * 0.5)))
        indices[name] = torch.from_numpy(np.sort(np.asarray(jax.random.choice(sub, s, shape=(keep,), replace=False))))
    got = drop_kvs(tc, 0.5, indices=indices)
    for name in raw:
        assert got[name].self_attention.k.shape[1] == want[name].self_attention.k.shape[1]
        for g, w in ((got[name].self_attention.k, want[name].self_attention.k),
                     (got[name].self_attention.v, want[name].self_attention.v),
                     (got[name].cross_attention.k, want[name].cross_attention.k)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    drawn = drop_kvs(tc, 0.5, generator=torch.Generator().manual_seed(0))
    for name in raw:
        kept = drawn[name].self_attention.k
        assert kept.shape == want[name].self_attention.k.shape
        rows = [int(np.nonzero((tc[name].self_attention.k[0] == kept[0, j]).all(-1).numpy())[0][0])
                for j in range(kept.shape[1])]
        assert rows == sorted(set(rows))
    assert drop_kvs(tc, 0.99, generator=torch.Generator())["mid"].self_attention.k.shape[1] == 1  # max(1, ...)


# --------------------------------------------------------------------------
# ZeroSFT and the zero_sft UNet
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_h_ori", [False, True])
@pytest.mark.parametrize("control_scale", [1.0, 0.5])
def test_zero_sft_matches_jax(with_h_ori, control_scale):
    """Residual 12 channels, skip 16, up-path hidden 8 (when given), 8 groups;
    at ``control_scale`` 0.5 the ``h_raw`` blend. 1e-5."""
    rng = np.random.default_rng(21)
    control = rng.standard_normal((B, 6, 6, 12)).astype(np.float32)
    h = rng.standard_normal((B, 6, 6, 16)).astype(np.float32)
    h_ori = rng.standard_normal((B, 6, 6, 8)).astype(np.float32) if with_h_ori else None
    jm = JZeroSFT(nhidden=32, norm_num_groups=8)
    params = _init_random(jm, 22, control, h, h_ori=h_ori)
    ref = np.asarray(jm.apply(params, control, h, h_ori=h_ori, control_scale=control_scale))
    tm = ZeroSFT(12, 16, 8 if with_h_ori else 0, nhidden=32, norm_num_groups=8)
    sd = {}
    convert._inv_zero_sft(sd, "m", params["params"])
    tm.load_state_dict({k[2:]: v for k, v in convert.to_torch(sd).items()}, strict=True)
    with torch.no_grad():
        got = tm(_nchw(control), _nchw(h), None if h_ori is None else _nchw(h_ori), control_scale=control_scale)
    assert _max_rel_err(_nhwc(got), ref) <= 1e-5


def _unet_inputs(rng, cfg):
    levels = [LAT >> i for i in range(len(cfg.block_out_channels))]
    sizes = []
    for i, s in enumerate(levels):  # conv_in, each level's resnets, its downsample (to the next level)
        if i == 0:
            sizes.append(s)
        sizes += [s] * cfg.layers_per_block
        if i < len(levels) - 1:
            sizes.append(levels[i + 1])
    residuals = [rng.standard_normal((B, s, s, ch)).astype(np.float32) * 0.5
                 for s, ch in zip(sizes, down_stack_channels(cfg))]
    return dict(
        x=rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32), t=np.array([10, 700]),
        text=rng.standard_normal((B, 7, 32)).astype(np.float32),
        pooled=rng.standard_normal((B, 16)).astype(np.float32),
        time_ids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (B, 1)),
        ip=rng.standard_normal((B, 8, 32)).astype(np.float32),
        residuals=residuals, mid=rng.standard_normal((B, levels[-1], levels[-1], 64)).astype(np.float32) * 0.5,
        weight=rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def zero_sft_unet():
    """The zero_sft UNet on both sides and the JAX forward with the gradient
    of ``sum(out · weight)`` with respect to the sample and the residuals
    (one compile)."""
    jcfg = j_unet_cfg(with_ip=True, residual_fusion="zero_sft", **SLIM)
    tcfg = tiny_unet_config(with_ip=True, residual_fusion="zero_sft", **SLIM)
    c = _unet_inputs(np.random.default_rng(23), tcfg)
    jm = JUNet(jcfg, use_flash=False)
    fixed = (c["t"], c["text"], c["pooled"], c["time_ids"])
    params = _init_random(jm, 24, c["x"], *fixed, ip_hidden_states=c["ip"],
                          down_block_additional_residuals=tuple(c["residuals"]),
                          mid_block_additional_residual=c["mid"])

    def loss(x, residuals, mid):
        out = jm.apply(params, x, *fixed, ip_hidden_states=c["ip"], down_block_additional_residuals=residuals,
                       mid_block_additional_residual=mid)
        return jnp.sum(out * c["weight"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        c["x"], tuple(c["residuals"]), c["mid"])
    tm = UNet2DConditionModel(tcfg)
    tm.load_state_dict(convert.to_torch(convert.export_unet(params)), strict=True)
    return dict(c=c, params=params, out=np.asarray(out), grads=jax.tree_util.tree_map(np.asarray, grads), tm=tm,
                jm=jm)


def test_zero_sft_unet_forward_and_input_gradients_match_jax(zero_sft_unet):
    """Forward within 1e-4 of the output's scale; the gradients of the
    sample, each residual and the mid residual within 1e-4 of each one's
    largest value (one backward through the same layers)."""
    z = zero_sft_unet
    c, tm = z["c"], z["tm"]
    x = _nchw(c["x"]).requires_grad_()
    residuals = [_nchw(r).requires_grad_() for r in c["residuals"]]
    mid = _nchw(c["mid"]).requires_grad_()
    out = tm(x, torch.tensor(c["t"]), _t(c["text"]), _t(c["pooled"]), _t(c["time_ids"]), ip_hidden_states=_t(c["ip"]),
             down_block_additional_residuals=residuals, mid_block_additional_residual=mid)
    assert _max_rel_err(_nhwc(out), z["out"]) <= 1e-4
    (out * _nchw(c["weight"])).sum().backward()
    jx, jres, jmid = z["grads"]
    for got, want in [(x.grad, jx), (mid.grad, jmid)] + list(zip((r.grad for r in residuals), jres)):
        assert _nhwc(got).shape == want.shape
        assert np.abs(_nhwc(got) - want).max() <= 1e-4 * np.abs(want).max()
    assert all(np.abs(g).max() > 0 for g in jres)  # every residual reaches the output


def test_zero_sft_unet_leaves_and_checkpointing(zero_sft_unet):
    """One ZeroSFT per up-block resnet plus ``mid_zero_sft``; gradient
    checkpointing gives the same input gradient."""
    tm, c = zero_sft_unet["tm"], zero_sft_unet["c"]
    names = {n.rsplit(".zero_sfts.", 1)[0] for n, _ in tm.named_parameters() if ".zero_sfts." in n}
    assert names == {f"up_blocks.{i}" for i in range(3)}
    assert sum(1 for n, _ in tm.named_modules() if isinstance(_, ZeroSFT)) == 3 * (SLIM["layers_per_block"] + 1) + 1

    def grad(checkpointing):
        tm.gradient_checkpointing = checkpointing
        x = _nchw(c["x"]).requires_grad_()
        out = tm(x, torch.tensor(c["t"]), _t(c["text"]), _t(c["pooled"]), _t(c["time_ids"]),
                 ip_hidden_states=_t(c["ip"]), down_block_additional_residuals=[_nchw(r) for r in c["residuals"]],
                 mid_block_additional_residual=_nchw(c["mid"]))
        (out * _nchw(c["weight"])).sum().backward()
        tm.gradient_checkpointing = False
        return x.grad

    torch.testing.assert_close(grad(True), grad(False), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the Aggregator's variants
# --------------------------------------------------------------------------

AGG_SETTINGS = {
    "plain": dict(), "split": dict(attn1_mode="split"), "sep_split": dict(attn1_mode="sep_split"),
    "pad_plain": dict(pad_concat=True), "pad_split": dict(pad_concat=True, attn1_mode="split"),
    "pad_sep_split": dict(pad_concat=True, attn1_mode="sep_split"),
    "global_pool": dict(pad_concat=True, global_pool_conditions=True),
    "adapter": dict(aggregator_adapter=True),
}
IP_TOKENS = 4


@pytest.fixture(scope="module")
def aggregators():
    """Every setting's JAX params and outputs (one compile for all of them);
    ``ref_scale`` 0.3, ``ip_scale`` 0.8 for the adapter."""
    jcfg = j_unet_cfg(**SLIM)
    rng = np.random.default_rng(25)
    pooled_dim = jcfg.projection_class_embeddings_input_dim - 6 * jcfg.addition_time_embed_dim
    inputs = dict(
        sample=rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32), timesteps=np.array([10, 700]),
        controlnet_cond=rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
        added_text_embeds=rng.standard_normal((B, pooled_dim)).astype(np.float32),
        added_time_ids=np.tile(np.array([[32, 32, 0, 0, 32, 32]], np.float32), (B, 1)))
    ip = rng.standard_normal((B, IP_TOKENS, jcfg.cross_attention_dim)).astype(np.float32)
    mods, params = {}, {}
    for name, kw in AGG_SETTINGS.items():
        mods[name] = JAggregator(jcfg, use_flash=False, **kw)
        extra = dict(ip_hidden_states=ip) if kw.get("aggregator_adapter") else {}
        params[name] = _init_random(mods[name], 26, **inputs, **extra)

    def run_all(ps):
        out = {}
        for name, kw in AGG_SETTINGS.items():
            extra = dict(ip_hidden_states=ip, ip_scale=0.8) if kw.get("aggregator_adapter") else {}
            out[name] = mods[name].apply(ps[name], **inputs, ref_scale=0.3, conditioning_scale=0.9, **extra)
        return out

    outs = jax.tree_util.tree_map(np.asarray, jax.jit(run_all)(params))
    return dict(cfg=tiny_unet_config(**SLIM), inputs=inputs, ip=ip, params=params, outs=outs)


def _port_aggregator(agg, name):
    tm = Aggregator(agg["cfg"], **AGG_SETTINGS[name])
    tm.load_state_dict(convert.to_torch(convert.export_aggregator(agg["params"][name])), strict=True)
    return tm


def _port_inputs(agg):
    i = agg["inputs"]
    return (_nchw(i["sample"]), torch.tensor(i["timesteps"]), _nchw(i["controlnet_cond"]), _t(i["added_text_embeds"]),
            _t(i["added_time_ids"]))


@pytest.mark.parametrize("name", list(AGG_SETTINGS))
def test_aggregator_variant_matches_jax(aggregators, name):
    tm = _port_aggregator(aggregators, name)
    extra = dict(ip_hidden_states=_t(aggregators["ip"]), ip_scale=0.8) if name == "adapter" else {}
    with torch.no_grad():
        down, mid = tm(*_port_inputs(aggregators), ref_scale=0.3, conditioning_scale=0.9, **extra)
    jdown, jmid = aggregators["outs"][name]
    assert len(down) == len(jdown) == len(down_stack_channels(aggregators["cfg"]))
    for g, r in zip(down + (mid,), tuple(jdown) + (jmid,)):
        assert _nhwc(g).shape == r.shape
        assert _max_rel_err(_nhwc(g), r) <= AGG_TOL, name
    if name == "global_pool":
        assert all(r.shape[1:3] == (1, 1) for r in jdown)


def test_aggregator_parameter_layouts(aggregators):
    """plain, split and pad share one layout; sep_split adds ``ln_k_ref`` /
    ``ln_v_ref`` on every attn1; the adapter the attn1 ip branch."""
    names = {n: set(convert.export_aggregator(p)) for n, p in aggregators["params"].items()}
    plain = names["plain"]
    assert names["split"] == names["pad_plain"] == names["pad_split"] == plain
    sep_extra = names["sep_split"] - plain
    assert sep_extra and all(".attn1.ln_k_ref." in n or ".attn1.ln_v_ref." in n for n in sep_extra)
    ip_extra = names["adapter"] - plain
    assert ip_extra and all(".attn1.processor." in n for n in ip_extra)
    # one ip branch on every attn1 that sep_split gives its AdaLNs
    assert ({n.split(".processor.")[0] for n in ip_extra}
            == {n.split(".ln_k_ref.")[0] for n in sep_extra if ".ln_k_ref." in n})


def test_aggregator_adapter_at_ip_scale_zero_equals_plain(aggregators):
    """The adapter's weights with ``ip_scale=0`` give the plain Aggregator's
    residuals on the same weights (1e-6)."""
    tm = _port_aggregator(aggregators, "adapter")
    plain = Aggregator(aggregators["cfg"])
    plain.load_state_dict({k: v for k, v in tm.state_dict().items() if ".processor." not in k}, strict=True)
    args = _port_inputs(aggregators)
    with torch.no_grad():
        down, mid = tm(*args, ip_hidden_states=_t(aggregators["ip"]), ip_scale=0.0)
        pdown, pmid = plain(*args)
    for a, b in zip(down + (mid,), pdown + (pmid,)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_split_aggregator_without_pad_equals_plain(aggregators):
    tm = _port_aggregator(aggregators, "split")
    plain = Aggregator(aggregators["cfg"])
    plain.load_state_dict(tm.state_dict(), strict=True)
    args = _port_inputs(aggregators)
    with torch.no_grad():
        (down, mid), (pdown, pmid) = tm(*args), plain(*args)
    for a, b in zip(down + (mid,), pdown + (pmid,)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["pad_plain", "pad_sep_split", "adapter"])
def test_aggregator_checkpointing_keeps_gradients(aggregators, name):
    """Gradient checkpointing recomputes each block in every mode: the same
    parameter gradients (1e-6)."""
    tm = _port_aggregator(aggregators, name)
    extra = dict(ip_hidden_states=_t(aggregators["ip"])) if name == "adapter" else {}
    args = _port_inputs(aggregators)

    def grads(checkpointing):
        tm.gradient_checkpointing = checkpointing
        tm.zero_grad()
        down, mid = tm(*args, ref_scale=0.3, **extra)
        (sum(r.square().mean() for r in down) + mid.square().mean()).backward()
        return {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}

    off, on = grads(False), grads(True)
    assert set(off) == set(on) and len(off) == len(list(tm.parameters()))
    for n in off:
        torch.testing.assert_close(on[n], off[n], rtol=0, atol=1e-6, msg=n)


def test_conditioning_embedding_matches_jax():
    rng = np.random.default_rng(27)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    jm = JCondEmbed(embedding_channels=8, block_out_channels=(4, 6, 8))
    params = _init_random(jm, 28, x)
    ref = np.asarray(jm.apply(params, x))
    tm = ConditioningEmbedding(8, block_out_channels=(4, 6, 8))
    tm.load_state_dict(convert.to_torch(convert.export_conditioning_embedding(params)), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    assert _nhwc(got).shape == ref.shape == (B, 4, 4, 8)
    assert _max_rel_err(_nhwc(got), ref) <= 1e-5


# --------------------------------------------------------------------------
# the projection heads
# --------------------------------------------------------------------------


def _heads(seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, 16)).astype(np.float32)
    jimage = jip.ImageProjModel(cross_attention_dim=32, clip_embeddings_dim=16, clip_extra_context_tokens=4)
    jmlp = jip.MLPProjModel(cross_attention_dim=32, clip_embeddings_dim=16)
    pimage, pmlp = _init_random(jimage, seed + 1, emb), _init_random(jmlp, seed + 2, emb)
    timage = ip_adapter.ImageProjModel(32, 16, 4)
    timage.load_state_dict(convert.to_torch(convert.export_image_proj(pimage)), strict=True)
    tmlp = ip_adapter.MLPProjModel(32, 16)
    tmlp.load_state_dict(convert.to_torch(convert.export_mlp_proj(pmlp)), strict=True)
    return emb, (jimage, pimage, timage), (jmlp, pmlp, tmlp)


@pytest.mark.parametrize("head", ["image_proj", "mlp_proj", "mlp_proj_tokens", "multi"])
def test_projection_heads_match_jax(head):
    """LayerNorms in fp32 (eps 1e-6), the MLP's GELU exact; the MLP head on
    pooled ``[B, D]`` and on token ``[B, N, D]`` embeddings. 1e-5."""
    emb, (jimage, pimage, timage), (jmlp, pmlp, tmlp) = _heads(29)
    if head == "image_proj":
        ref, got = jimage.apply(pimage, emb), timage(_t(emb))
    elif head == "mlp_proj":
        ref, got = jmlp.apply(pmlp, emb), tmlp(_t(emb))
    elif head == "mlp_proj_tokens":
        tokens = np.stack([emb, -emb], axis=1)
        ref, got = jmlp.apply(pmlp, tokens), tmlp(_t(tokens))
    else:
        jmulti = jip.MultiImageProjection([(jimage, pimage), (jmlp, pmlp)])
        tmulti = ip_adapter.MultiImageProjection([timage, tmlp])
        assert len(tmulti) == len(jmulti) == 2
        ref, got = jmulti([emb, emb]), tmulti([_t(emb), _t(emb)])
        assert got.shape == (B, 5, 32)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the JAX guards
# --------------------------------------------------------------------------


def _guard_cases():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((1, 12, 16)).astype(np.float32)
    ek = rng.standard_normal((1, 3, 16)).astype(np.float32)
    return {
        "split_spatial": (lambda: jattn.SplitAttention(16, 2, 8, use_flash=False).init(
            jax.random.PRNGKey(0), x, (5, 3)),
            lambda: SplitAttention(16, 2, 8)(_t(x), (5, 3)), "does not match spatial"),
        "split_sep_temb": (lambda: jattn.SplitAttention(16, 2, 8, mode="sep", use_flash=False).init(
            jax.random.PRNGKey(0), x, (4, 3)),
            lambda: SplitAttention(16, 2, 8, mode="sep", temb_dim=4)(_t(x), (4, 3)), "requires temb"),
        "split_mode": (lambda: jattn.SplitAttention(16, 2, 8, mode="cross", use_flash=False).init(
            jax.random.PRNGKey(0), x, (4, 3)),
            lambda: SplitAttention(16, 2, 8, mode="cross"), "unknown SplitAttention mode"),
        "external_kv_mode": (lambda: jattn.Attention(16, 2, 8, external_kv_mode="gate", use_flash=False).init(
            jax.random.PRNGKey(0), x, external_kv=jkv.KVCache(ek, ek)),
            lambda: Attention(16, 2, 8, external_kv_mode="gate")(_t(x), external_kv=KVCache(_t(ek), _t(ek))),
            "unknown external_kv_mode"),
        "ta_additive_temb": (lambda: jattn.Attention(16, 2, 8, external_kv_mode="ta_additive", use_flash=False).init(
            jax.random.PRNGKey(0), x, external_kv=jkv.KVCache(ek, ek)),
            lambda: Attention(16, 2, 8, external_kv_mode="ta_additive", temb_dim=4)(
                _t(x), external_kv=KVCache(_t(ek), _t(ek))), "requires temb"),
        "multi_projection": (lambda: jip.MultiImageProjection([])([x]),
                             lambda: ip_adapter.MultiImageProjection([])([_t(x)]), "projectors"),
    }


@pytest.mark.parametrize("case", ["split_spatial", "split_sep_temb", "split_mode", "external_kv_mode",
                                  "ta_additive_temb", "multi_projection"])
def test_attention_and_projection_guards_raise_as_in_jax(case):
    jfn, tfn, match = _guard_cases()[case]
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        tfn()


@pytest.mark.parametrize("case", ["adapter_without_ip", "adapter_with_split", "zero_sft_without_residuals",
                                  "zero_sft_with_cached_deep"])
def test_model_guards_raise_as_in_jax(aggregators, zero_sft_unet, case):
    """The Aggregator's two guards and the zero_sft UNet's two, each raising
    in both packages (the port's adapter-with-split guard at construction:
    its modules are built there; the JAX side traced abstractly)."""
    if case.startswith("adapter"):
        jcfg = j_unet_cfg(**SLIM)
        i = aggregators["inputs"]
        if case == "adapter_without_ip":
            jfn = lambda: jax.eval_shape(lambda: JAggregator(  # noqa: E731
                jcfg, use_flash=False, aggregator_adapter=True).init(jax.random.PRNGKey(0), **i))
            tfn = lambda: _port_aggregator(aggregators, "adapter")(*_port_inputs(aggregators))  # noqa: E731
            match = "requires ip_hidden_states"
        else:
            jfn = lambda: jax.eval_shape(lambda: JAggregator(  # noqa: E731
                jcfg, use_flash=False, aggregator_adapter=True, attn1_mode="split").init(
                jax.random.PRNGKey(0), **i, ip_hidden_states=aggregators["ip"]))
            tfn = lambda: Aggregator(aggregators["cfg"], aggregator_adapter=True, attn1_mode="split")  # noqa: E731
            match = "requires attn1_mode='plain'"
    else:
        z = zero_sft_unet
        c, jm, tm = z["c"], z["jm"], z["tm"]
        fixed = (c["t"], c["text"], c["pooled"], c["time_ids"])
        tfixed = (torch.tensor(c["t"]), _t(c["text"]), _t(c["pooled"]), _t(c["time_ids"]))
        if case == "zero_sft_without_residuals":
            jfn = lambda: jax.eval_shape(lambda: jm.apply(  # noqa: E731
                z["params"], c["x"], *fixed, ip_hidden_states=c["ip"]))
            tfn = lambda: tm(_nchw(c["x"]), *tfixed, ip_hidden_states=_t(c["ip"]))  # noqa: E731
            match = "requires down_block_additional_residuals"
        else:
            deep = np.zeros((B, LAT // 2, LAT // 2, 64), np.float32)
            jfn = lambda: jm.apply(z["params"], c["x"], *fixed, ip_hidden_states=c["ip"],  # noqa: E731
                                   cached_deep=deep, down_block_additional_residuals=tuple(c["residuals"][:3]))
            tfn = lambda: tm(_nchw(c["x"]), *tfixed, ip_hidden_states=_t(c["ip"]),  # noqa: E731
                             cached_deep=_nchw(deep), down_block_additional_residuals=[_nchw(r) for r in
                                                                                       c["residuals"][:3]])
            match = "cached_deep requires residual_fusion='add'"
    with pytest.raises(ValueError, match=match):
        jfn()
    with pytest.raises(ValueError, match=match):
        with torch.no_grad():
            tfn()


# --------------------------------------------------------------------------
# the exporters' round trip
# --------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["zero_sft_unet", "sep_split_aggregator", "adapter_aggregator"])
def test_exporters_round_trip(aggregators, zero_sft_unet, model):
    """A JAX tree exported, loaded strictly and read back: the port's state
    dict holds exactly the exported names and values, and each new leaf kind
    is among them."""
    if model == "zero_sft_unet":
        want, tm = convert.export_unet(zero_sft_unet["params"]), zero_sft_unet["tm"]
        kinds = (".zero_sfts.0.zero_conv.", ".zero_sfts.1.zero_mul.", ".zero_sfts.0.param_free_norm.", "mid_zero_sft.")
    else:
        name = "pad_sep_split" if model.startswith("sep") else "adapter"
        want, tm = convert.export_aggregator(aggregators["params"][name]), _port_aggregator(aggregators, name)
        kinds = (".attn1.ln_k_ref.linear.", ".attn1.ln_v_ref.linear.") if name != "adapter" else (
            ".attn1.processor.to_k_ip.", ".attn1.processor.ln_v_ip.linear.")
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    for kind in kinds:
        assert any(kind in k for k in want), kind
