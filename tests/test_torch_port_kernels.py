"""The port's hand-written kernels against their plain versions on the card.

Every test but the first is marked ``cuda`` and skips where no NVIDIA GPU is
present: the kernels (``instantir_tpu_torch/csrc``) have no CPU mode. The file
imports only ``torch`` and the port, so it runs on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_port_kernels.py -m cuda``
(the repository's conftest imports JAX).
"""

from __future__ import annotations

import pytest
import torch

from instantir_tpu_torch.ops import attention as tattn
from instantir_tpu_torch.ops import group_norm as tgn


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the kernels have no CPU mode")


# beside the square shapes: Sq != Skv with neither a multiple of the tiles, a kv
# tail of 72 keys, and an odd S (lse and D rows start off 16-byte alignment);
# then the model variants': the Aggregator's ragged pad_concat maps at 512²
# (65x32 and 33x16 tokens) and external_kv's cross shape (a cache of 4096
# tokens appended to 4096)
CARD_SHAPES = [(1024, 1024), (2304, 2304), (1000, 1000), (200, 520), (1024, 1096), (1001, 1001), (2080, 2080),
               (528, 528), (4096, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,skv", CARD_SHAPES)
def test_flash_training_kernels_match_references_on_card(s, skv):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(2, s, 4, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, skv, 4, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    before = (tattn.flash_attention_lse_launches, tattn.flash_backward_dq_launches, tattn.flash_backward_dkv_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.dot_product_attention(*leaves)  # an input needs a gradient: the differentiable kernels
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = (tattn.flash_attention_lse_launches, tattn.flash_backward_dq_launches, tattn.flash_backward_dkv_launches)
    assert after == tuple(n + 1 for n in before)
    ref_o, ref_lse = tattn.flash_attention_lse_reference(q, k, v)
    _, lse = tattn.flash_attention_lse(q, k, v)
    assert (out.float() - ref_o.float()).abs().max().item() <= 4e-3
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    refs = tattn.flash_backward_reference(q, k, v, ref_o, ref_lse, do, block_q=512, block_k=512)
    for got, want in zip(grads, refs):
        assert ((got.float() - want.float()).abs().max() / want.float().abs().max()).item() <= 2e-2
    with pytest.raises(ValueError, match="float16"):
        tattn.flash_attention_lse(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        tattn.flash_backward_dq(q, k, v, do, ref_lse.double(), ref_lse)


# [B, C, H, W] with 32 groups: between them every cluster size (1 at the ragged
# 45², 2, 4, 8 at 320x128² bf16, 16 at 960x128² bf16) and, at 960x128² fp32,
# the path that reads again what does not fit in the cluster's shared memory
CARD_GN_SHAPES = [(2, 320, 64, 64), (2, 1280, 16, 16), (1, 64, 45, 45), (2, 640, 128, 128), (2, 960, 128, 128),
                  (2, 320, 128, 128)]


def test_card_group_norm_shapes_cover_every_cluster_size_and_path():
    """The card's GroupNorm cases reach every cluster size and both paths of
    the launch plan (a check of the plan, run on the CPU too)."""
    plans = [tgn.gn_plan(b, c, h * w, 32, itemsize) for b, c, h, w in CARD_GN_SHAPES for itemsize in (2, 4)]
    assert {p.cs for p in plans} == set(tgn.CLUSTER_SIZES)
    assert {p.path for p in plans} == {"resident", "reread"}


# against the plain version's fp32 values (before their rounding to x's dtype):
# half an ulp of outputs below 8 plus the fp32 difference (chip_smoke.GN_TOL)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4), (torch.float16, 2.5e-3)])
@pytest.mark.parametrize("shape", CARD_GN_SHAPES)
def test_group_norm_kernel_matches_plain_version_on_card(shape, dtype, tol):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(shape, generator=g, device="cuda") * 1.5 + 0.5).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device="cuda")
    bias = 0.1 * torch.randn(shape[1], generator=g, device="cuda")
    for silu in (False, True):
        before = tgn.group_norm_launches
        y = tgn.group_norm_silu_fused(x, scale, bias, 32, 1e-5, silu)
        torch.cuda.synchronize()
        assert tgn.group_norm_launches == before + 1 and y.dtype == dtype
        ref = tgn.group_norm_silu_nchw(x.float(), scale, bias, 32, 1e-5, silu)
        assert (y.float() - ref).abs().max().item() <= tol
    with pytest.raises(ValueError):
        tgn.group_norm_silu_fused(x.transpose(2, 3), scale, bias, 32)
    with pytest.raises(ValueError):
        tgn.group_norm_silu_fused(x, scale.to(dtype) if dtype != torch.float32 else scale.double(), bias, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("s,skv", CARD_SHAPES)
def test_flash_kernel_matches_reference_on_card(s, skv):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, s, 4, 64, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(2, skv, 4, 64, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    before = tattn.flash_attention_launches
    out = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_launches == before + 1
    err = (out.float() - tattn.flash_attention_reference(q, k, v).float()).abs().max().item()
    assert err <= 4e-3, err
    with pytest.raises(ValueError, match="float16"):
        tattn.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one dtype"):
        tattn.flash_attention(q, k.float(), v)


F32_COUNTERS = ("flash_attention_f32_launches", "flash_attention_lse_f32_launches", "flash_backward_dq_f32_launches",
                "flash_backward_dkv_f32_launches")
BF16_COUNTERS = ("flash_attention_launches", "flash_attention_lse_launches", "flash_backward_dq_launches",
                 "flash_backward_dkv_launches")


def _f32_errors(got: torch.Tensor, want: torch.Tensor):
    """(relative L2 error, max abs error over the reference's max abs)."""
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item(), ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("s,skv", CARD_SHAPES)
def test_fp32_flash_kernels_match_references_on_card(s, skv):
    """The fp32 entry points (csrc/flash_f32.cu) against the plain fp32
    versions on the same card: outputs and gradients within relative L2 1e-5
    and max abs 1e-4 of the reference's max abs, lse within 1e-5 (a few fp32
    ulps of values near 10: only the summation order differs)."""
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version's products in full fp32
    g = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn(2, s, 4, 64, generator=g, device="cuda") for _ in range(2))
    k, v = (torch.randn(2, skv, 4, 64, generator=g, device="cuda") for _ in range(2))
    before = [getattr(tattn, n) for n in F32_COUNTERS + BF16_COUNTERS]
    out = tattn.flash_attention(q, k, v)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out_diff = tattn.dot_product_attention(*leaves)  # an input needs a gradient: K2, then K3 and K4
    grads = torch.autograd.grad(out_diff, leaves, do)
    torch.cuda.synchronize()
    after = [getattr(tattn, n) for n in F32_COUNTERS + BF16_COUNTERS]
    assert after == [n + 1 for n in before[:4]] + before[4:]
    ref_o, ref_lse = tattn.flash_attention_lse_reference(q, k, v)
    _, lse = tattn.flash_attention_lse(q, k, v)
    refs = tattn.flash_backward_reference(q, k, v, ref_o, ref_lse, do, block_q=512, block_k=512)
    for what, got, want in (("o", out, ref_o), ("o (lse entry point)", out_diff, ref_o), ("dq", grads[0], refs[0]),
                            ("dk", grads[1], refs[1]), ("dv", grads[2], refs[2])):
        assert got.dtype == torch.float32, what
        rel_l2, rel_max = _f32_errors(got, want)
        assert rel_l2 <= 1e-5 and rel_max <= 1e-4, (what, rel_l2, rel_max)
    assert (lse - ref_lse).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fused_restore_replays_the_staged_restore_on_card():
    """``RestoreConfig.fused`` at the tiny configs with one head a level
    (head_dim 64, as the flash kernels take; fp32, 128² images, so the fp32
    flash entry points and the fused GroupNorm run): three calls with new
    inputs and draws each, the graph's image and previews equal to the staged
    restore's; the second and third calls replay (no launch counted)."""
    _need_card()
    import dataclasses

    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import RestoreConfig

    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4, num_attention_heads=(1, 1, 1)), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cuda")
    cfg = RestoreConfig(num_inference_steps=3, preview_start=0.3, lora_alpha=0.7, fuse_previewer_lora=True,
                        save_preview_row=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    for call in range(3):
        lq = torch.rand(1, 128, 128, 3, generator=g, device="cuda") * 2.0 - 1.0
        pe, pooled = torch.randn(1, 7, 32, generator=g, device="cuda"), torch.randn(1, 16, generator=g, device="cuda")

        def restore(c):
            return pipe.restore(lq, pe, pooled, cfg=c, generator=torch.Generator(device="cuda").manual_seed(call),
                                output_type="pt")

        staged, staged_previews = restore(cfg)
        before = (tattn.flash_attention_f32_launches, tgn.group_norm_launches)
        graph, graph_previews = restore(dataclasses.replace(cfg, fused=True))
        torch.cuda.synchronize()
        after = (tattn.flash_attention_f32_launches, tgn.group_norm_launches)
        assert (after == before) == (call > 0) and before[0] > 0
        torch.testing.assert_close(graph, staged, rtol=0, atol=1e-6)
        assert len(graph_previews) == len(staged_previews) == 2
        for a, b in zip(graph_previews, staged_previews):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_recorded_restores_are_bounded_on_card():
    """At most ``MAX_GRAPHS`` recorded restores are kept: three image sizes
    in turn record three graphs, the third drops the first (least recently
    replayed) and its pool, and a size still held replays (no launch)."""
    _need_card()
    import dataclasses

    from instantir_tpu_torch.models.dinov2 import tiny_dinov2_config
    from instantir_tpu_torch.models.resampler import tiny_resampler_config
    from instantir_tpu_torch.models.unet import tiny_unet_config
    from instantir_tpu_torch.models.vae import tiny_vae_config
    from instantir_tpu_torch.pipeline.factory import build_pipeline
    from instantir_tpu_torch.pipeline.instantir import MAX_GRAPHS, RestoreConfig

    pipe = build_pipeline(tiny_unet_config(with_ip=True, lora_rank=4, num_attention_heads=(1, 1, 1)), tiny_vae_config(),
                          tiny_resampler_config(output_dim=32, lora_rank=2), tiny_dinov2_config(), device="cuda")
    cfg = RestoreConfig(num_inference_steps=2, fused=True)
    g = torch.Generator(device="cuda").manual_seed(4)

    def restore(h, w):
        lq = torch.rand(1, h, w, 3, generator=g, device="cuda") * 2.0 - 1.0
        pe, pooled = torch.randn(1, 7, 32, generator=g, device="cuda"), torch.randn(1, 16, generator=g, device="cuda")
        before = tgn.group_norm_launches
        pipe.restore(lq, pe, pooled, cfg=cfg, output_type="pt")
        torch.cuda.synchronize()
        return tgn.group_norm_launches > before  # True: recorded

    assert MAX_GRAPHS == 2
    sizes = [(128, 128), (128, 192), (192, 128)]
    assert all(restore(*hw) for hw in sizes)
    assert len(pipe._graphs) == MAX_GRAPHS
    held = [tuple(k[2][0][0][1:3]) for k in pipe._graphs]
    assert held == [(128, 192), (192, 128)]
    assert not restore(128, 192) and not restore(192, 128)  # replays
    assert restore(128, 128)  # dropped: recorded again, dropping (128, 192)
    assert [tuple(k[2][0][0][1:3]) for k in pipe._graphs] == [(192, 128), (128, 128)]
