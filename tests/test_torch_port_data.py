"""CPU parity of the port's training data with the JAX package's.

The blur-kernel triples and both datasets must give bitwise the JAX
module's arrays and captions for the same seed. Every device op of the
RealESRGAN degradation (fp32, NHWC) is held to its JAX twin within
``OP_TOL``: the 2D filter, the USM blur (a 101-tap reflect pad on a 16²
image too), the three resize modes up and down (``jax.image.resize``) and on
a partial window (``_resize_valid``), the reflect fill and padding past a
full period, Gaussian noise from JAX's normals and Poisson noise from JAX's
counts, and the JPEG round trip within ``JPEG_FLIP_SHARE``. The traced chain
runs at 64², batch 2 (one JAX compile, module fixture) with two keys whose
noise stages are both Gaussian and which between them take the
``resize_first`` and ``jpeg_first`` orders and every resize mode, fed the
draws ``jax.random.split(key, 24)`` gives in ``traced_call``; the eager
chain at 48², batch 2, with the same numpy ``host_rng`` and JAX's own noise
draws. The data and loss configs under ``config_files/`` load as the JAX
package loads them.
"""

from __future__ import annotations

import contextlib
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantir_tpu.data import dataset as jdataset
from instantir_tpu.data import degradation as jdeg
from instantir_tpu.data import kernels as jkernels
from instantir_tpu.train import common as jcommon
from instantir_tpu_torch.data import dataset as tdataset
from instantir_tpu_torch.data import degradation as tdeg
from instantir_tpu_torch.data import kernels as tkernels
from instantir_tpu_torch.train import common as tcommon

REPO = Path(__file__).resolve().parents[1]
OP_TOL = 1e-5  # max abs difference of an fp32 device op's output (values in [0, 1])
# the JPEG round trip and the chains: a DCT coefficient at a rounding edge may round the other way under another
# summation order and move its whole 8x8 block (the resize back spreads a flipped lq block over ~36² gt pixels). On
# the CPU none flips: 0 pixels past OP_TOL, max 1.2e-6 measured here. The margin, 1% of the pixels, is less than one
# flipped block (2.1% of the JPEG test's pixels, more in the chains' outputs); no pixel may move further than
# JPEG_FLIP_MAX (on [0, 1], twice it on [-1, 1]), a third of a quantisation step at quality 30 (0.32)
JPEG_FLIP_SHARE = 0.01
JPEG_FLIP_MAX = 0.1
CHAIN_KEYS = (0, 30)  # both stages Gaussian; 0 takes jpeg_first (modes area, bilinear, bilinear), 30 resize_first
# (bilinear, bilinear, bicubic)
EAGER_SEEDS = (4,)  # host_rng seed at 48²: Poisson in stage 1, Gaussian in stage 2


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol=OP_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _jpeg_close(got, want, scale=1.0):
    """Within ``OP_TOL`` but for ``JPEG_FLIP_SHARE`` of the pixels, none past ``JPEG_FLIP_MAX`` (× ``scale``)."""
    diff = np.abs(np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got) - np.asarray(want))
    assert (diff > OP_TOL * scale).mean() <= JPEG_FLIP_SHARE, (diff > OP_TOL * scale).mean()
    assert diff.max() <= JPEG_FLIP_MAX * scale, diff.max()


def _images(rng, b, size, low=9):
    """Smooth random images in [0, 1] (edges and texture): a coarse grid, bicubic."""
    coarse = rng.uniform(size=(b, low, low, 3)).astype(np.float32)
    return np.clip(np.asarray(jax.image.resize(coarse, (b, size, size, 3), "cubic")), 0, 1).astype(np.float32)


def _kernels(b, seed=7):
    triples = [jkernels.sample_kernel_triple(np.random.default_rng(seed + i)) for i in range(b)]
    return tuple(np.stack([t[i] for t in triples]) for i in range(3))


# --------------------------------------------------------------------------
# kernels, datasets, configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_sample_kernel_triple_bitwise(seed):
    opt = dict(jkernels.KERNEL_OPT, sinc_prob=0.5, sinc_prob2=0.5) if seed % 2 else None
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        for want, got in zip(jkernels.sample_kernel_triple(a, opt), tkernels.sample_kernel_triple(b, opt)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert a.uniform() == b.uniform()


def _write_folder(root: Path, n: int, sizes, meta_ids, sidecar_ids, seed):
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    meta = []
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)).save(root / f"img{i}.png")
        if i in meta_ids:
            text = [f"caption {i} a", f"caption {i} b"] if i % 2 else f"caption {i}"
            meta.append({"file_name": f"img{i}.png", "text": text})
        elif i in sidecar_ids:
            (root / f"img{i}.txt").write_text(f"  sidecar {i}\n")
    (root / "metadata.jsonl").write_text("\n".join(json.dumps(m) for m in meta) + "\n\n")


def test_weighted_image_dataset_bitwise(tmp_path):
    """Two folders of PNGs (mixed sizes, captions in ``metadata.jsonl`` with
    single and multiple captions, ``.txt`` sidecars, none) mixed 0.3 / 0.7
    through a data config: the port's batches equal the JAX package's."""
    _write_folder(tmp_path / "a", 5, [(40, 36), (36, 52)], {0, 1, 2}, {3}, 1)
    _write_folder(tmp_path / "b" / "nested", 4, [(48, 40), (33, 33)], {1}, {0, 2}, 2)
    cfg_path = tmp_path / "data.yaml"
    cfg_path.write_text("datasets:\n  - dataset_folder: 'a'\n    dataset_weight: 0.3\n"
                        "  - dataset_folder: b  # nested folders are walked\n    dataset_weight: 0.7\n")
    jcfg = jdataset.load_data_config(str(cfg_path), str(tmp_path))
    tcfg = tdataset.load_data_config(str(cfg_path), str(tmp_path))
    assert [(d.dataset_folder, d.dataset_weight) for d in tcfg.datasets] == \
        [(d.dataset_folder, d.dataset_weight) for d in jcfg.datasets]
    jds, tds = jdataset.WeightedImageDataset(jcfg, seed=3), tdataset.WeightedImageDataset(tcfg, seed=3)
    assert len(tds) == len(jds) == 9
    jb, tb = jds.batches(3, 32), tds.batches(3, 32)
    for _ in range(4):
        want, got = next(jb), next(tb)
        assert got["captions"] == want["captions"]
        for k in ("images", "kernel", "kernel2", "sinc_kernel"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert tdataset.list_images(str(tmp_path / "b")) == jdataset.list_images(str(tmp_path / "b"))


def test_synthetic_dataset_bitwise():
    jb = jdataset.SyntheticImageDataset(seed=5).batches(2, 64)
    tb = tdataset.SyntheticImageDataset(seed=5).batches(2, 64)
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert got["captions"] == want["captions"]
        for k in ("images", "kernel", "kernel2", "sinc_kernel"):
            assert np.array_equal(got[k], want[k]), k


def test_random_crop_resize_and_load_image_bitwise(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(45, 70, 3)).astype(np.float32)
    for size in (32, 45, 50):
        a, b = np.random.default_rng(size), np.random.default_rng(size)
        assert np.array_equal(tdataset.random_crop_resize(b, img, size), jdataset.random_crop_resize(a, img, size))
    Image.fromarray((img * 255).astype(np.uint8)).convert("L").save(tmp_path / "gray.png")
    got = tdataset.load_image(str(tmp_path / "gray.png"))
    assert got.shape == (45, 70, 3) and np.array_equal(got, jdataset.load_image(str(tmp_path / "gray.png")))


@pytest.mark.parametrize("data_dir", ["", "/data/train"])
@pytest.mark.parametrize("name", ["IR_dataset.yaml", "val_dataset.yaml"])
def test_data_config_matches_jax_on_the_config_files(name, data_dir):
    path = str(REPO / "config_files" / name)
    want, got = jdataset.load_data_config(path, data_dir), tdataset.load_data_config(path, data_dir)
    assert [vars(d) for d in got.datasets] == [vars(d) for d in want.datasets]
    assert (got.val_dataset and vars(got.val_dataset)) == (want.val_dataset and vars(want.val_dataset))
    assert (got.batch_size, got.gt_size) == (want.batch_size, want.gt_size)


def test_losses_config_through_the_port_reader():
    from instantir_tpu.losses.loss_config import load_losses_config as jload
    from instantir_tpu_torch.losses.loss_config import load_losses_config as tload

    path = str(REPO / "config_files" / "losses.yaml")
    want, got = jload(path), tload(path)
    for group in ("diffusion_losses", "lcm_losses"):
        assert [vars(c) for c in getattr(got, group)] == [vars(c) for c in getattr(want, group)]


# --------------------------------------------------------------------------
# device ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("size,k", [((2, 40, 36, 3), 21), ((1, 16, 16, 3), 21), ((2, 12, 12, 3), 5)])
def test_filter2d(size, k):
    rng = np.random.default_rng(k + size[1])
    img = rng.uniform(size=size).astype(np.float32)
    ker = rng.uniform(size=(size[0], k, k)).astype(np.float32)
    ker /= ker.sum(axis=(1, 2), keepdims=True)
    _close(tdeg.filter2d(_t(img), _t(ker)), jdeg.filter2d(jnp.asarray(img), jnp.asarray(ker)))


@pytest.mark.parametrize("size", [(2, 48, 40, 3), (1, 16, 16, 3)])
def test_usm_sharp(size):
    img = np.random.default_rng(size[1]).uniform(size=size).astype(np.float32)
    _close(tdeg.usm_sharp(_t(img)), jdeg.usm_sharp(jnp.asarray(img)))


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
@pytest.mark.parametrize("out", [(16, 32), (96, 17)])
def test_resize(mode, out):
    img = np.random.default_rng(3).uniform(size=(2, 48, 40, 3)).astype(np.float32)
    _close(tdeg.resize(_t(img), out, mode), jdeg.resize(jnp.asarray(img), out, mode))


@pytest.mark.parametrize("mode_idx", [0, 1, 2])
@pytest.mark.parametrize("window", [((48, 40), (80, 64), (70, 55)), ((30, 20), (48, 48), (12, 9))])
def test_resize_valid(mode_idx, window):
    """Up onto a larger canvas, and down from a partial window."""
    in_valid, canvas, out_valid = window
    img = np.random.default_rng(5).uniform(size=(2, 48, 40, 3)).astype(np.float32)
    want = jdeg._resize_valid(jnp.asarray(img), jnp.asarray(in_valid, jnp.int32), canvas,
                              jnp.asarray(out_valid, jnp.int32), jnp.asarray(mode_idx))
    _close(tdeg.resize_valid(_t(img), in_valid, canvas, out_valid, tdeg.MODES[mode_idx]), want)


def test_reflect_fill_and_pad_past_a_period():
    img = np.random.default_rng(6).uniform(size=(2, 20, 17, 3)).astype(np.float32)
    for vh, vw in ((5, 3), (20, 17), (1, 1)):
        _close(tdeg.reflect_fill(_t(img), vh, vw), jdeg._reflect_fill(jnp.asarray(img), vh, vw), 0)
    x = np.random.default_rng(7).uniform(size=(1, 2, 3, 4)).astype(np.float32)
    for pad in (1, 2, 5, 10):
        want = jnp.pad(jnp.asarray(x), [(0, 0), (0, 0), (pad, pad), (pad, pad)], mode="reflect")
        _close(tdeg.reflect_pad(_t(x), pad), want, 0)


def test_gaussian_noise_with_jax_normals():
    img = np.random.default_rng(8).uniform(size=(2, 24, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    sigma, gray = np.asarray([5.0, 20.0], np.float32), np.asarray([0.0, 1.0], np.float32)
    want = jdeg.add_gaussian_noise(key, jnp.asarray(img), jnp.asarray(sigma), jnp.asarray(gray))
    k1, k2 = jax.random.split(key)
    got = tdeg.add_gaussian_noise(_t(img), _t(sigma), _t(gray), np.asarray(jax.random.normal(k1, img.shape)),
                                  np.asarray(jax.random.normal(k2, (2, 24, 20, 1))))
    _close(got, want)


def test_poisson_noise_with_jax_counts():
    """``jax.random.poisson`` cannot be reproduced: its counts are fed in."""
    img = np.random.default_rng(9).uniform(size=(2, 24, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    scale, gray = np.asarray([0.5, 2.0], np.float32), np.asarray([1.0, 0.0], np.float32)
    want = jdeg.add_poisson_noise(key, jnp.asarray(img), jnp.asarray(scale), jnp.asarray(gray))
    k1, k2 = jax.random.split(key)
    x = jnp.asarray(img)
    counts = jax.random.poisson(k1, jnp.clip(x, 0, 1) * 256.0).astype(jnp.float32)
    gray_counts = jax.random.poisson(k2, jnp.clip(jnp.mean(x, -1, keepdims=True), 0, 1) * 256.0).astype(jnp.float32)
    _close(tdeg.add_poisson_noise(_t(img), _t(scale), _t(gray), np.asarray(counts), np.asarray(gray_counts)), want)
    drawn = tdeg.add_poisson_noise(_t(img), _t(scale), _t(gray), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == img.shape and float(drawn.min()) >= 0 and float(drawn.max()) <= 1


@pytest.mark.parametrize("quality", [[30.5, 90.2], [5.0, 50.0], [95.0, 64.0], [100.0, 1.0]])
def test_jpeg_compress(quality):
    img = np.random.default_rng(10).uniform(size=(2, 32, 48, 3)).astype(np.float32)
    q = np.asarray(quality, np.float32)
    _jpeg_close(tdeg.jpeg_compress(_t(img), _t(q)), jdeg.jpeg_compress(jnp.asarray(img), jnp.asarray(q)))


@pytest.mark.parametrize("raises", [False, True])
def test_full_fp32_restores_the_callers_settings(raises):
    before = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with contextlib.suppress(RuntimeError):
            with tdeg.full_fp32():
                with tdeg.full_fp32():
                    assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                assert torch.get_float32_matmul_precision() == "highest"
                if raises:
                    raise RuntimeError("inside the block")
        assert torch.backends.cudnn.allow_tf32 and torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


# --------------------------------------------------------------------------
# the chains
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(b: int, ori: int):
    """A jitted function of the key that makes the JAX ``traced_call``'s draws
    for a ``b × ori × ori`` batch at the default options (compiled once)."""
    opt = dict(jdeg.DEGRADE_OPT, gt_size=ori)
    sf, lq = opt["sf"], opt["gt_size"] // opt["sf"]
    canvas1, canvas2 = tdeg.RealESRGANDegradation(degrade_opt=opt).canvases(ori, ori)
    final = ori // sf

    @jax.jit
    def draw(key):
        ks = jax.random.split(key, 24)
        uni = jax.random.uniform

        def gaussian(k, canvas):
            k1, k2 = jax.random.split(k)
            return jax.random.normal(k1, (b, *canvas, 3)), jax.random.normal(k2, (b, *canvas, 1))

        return dict(
            u=uni(ks[0], (16,)), up1=uni(ks[1], ()), down1=uni(ks[2], ()), mode1=jax.random.randint(ks[3], (), 0, 3),
            sigma1=uni(ks[4], (b,), minval=opt["noise_range"][0], maxval=opt["noise_range"][1]),
            pscale1=uni(ks[5], (b,), minval=opt["poisson_scale_range"][0], maxval=opt["poisson_scale_range"][1]),
            gray1=(uni(ks[6], (b,)) < opt["gray_noise_prob"]).astype(jnp.float32),
            q1=uni(ks[9], (b,), minval=opt["jpeg_range"][0], maxval=opt["jpeg_range"][1]),
            up2=uni(ks[10], ()), down2=uni(ks[11], ()), mode2=jax.random.randint(ks[12], (), 0, 3),
            sigma2=uni(ks[13], (b,), minval=opt["noise_range2"][0], maxval=opt["noise_range2"][1]),
            pscale2=uni(ks[14], (b,), minval=opt["poisson_scale_range2"][0], maxval=opt["poisson_scale_range2"][1]),
            gray2=(uni(ks[15], (b,)) < opt["gray_noise_prob2"]).astype(jnp.float32),
            q2=uni(ks[18], (b,), minval=opt["jpeg_range2"][0], maxval=opt["jpeg_range2"][1]),
            mode3=jax.random.randint(ks[19], (), 0, 3), top=jax.random.randint(ks[20], (), 0, final - lq + 1),
            left=jax.random.randint(ks[21], (), 0, final - lq + 1), noise1=gaussian(ks[7], canvas1),
            noise2=gaussian(ks[16], canvas2))

    return draw


def jax_traced_draws(key, b: int, ori: int) -> tdeg.ChainDraws:
    """The draws the JAX ``traced_call`` makes from ``key`` (``degradation.py:376-457``), Gaussian noise included."""
    d = jax.tree_util.tree_map(np.asarray, _jax_draw_fn(b, ori)(key))
    scalars = {k: (int(d[k]) if k in ("mode1", "mode2", "mode3", "top", "left") else float(d[k]))
               for k in ("up1", "down1", "up2", "down2", "mode1", "mode2", "mode3", "top", "left")}
    return tdeg.ChainDraws(u=[float(x) for x in d["u"]], sigma1=d["sigma1"], pscale1=d["pscale1"], gray1=d["gray1"],
                           q1=d["q1"], sigma2=d["sigma2"], pscale2=d["pscale2"], gray2=d["gray2"], q2=d["q2"],
                           noise1=tdeg.NoiseDraws(*d["noise1"]), noise2=tdeg.NoiseDraws(*d["noise2"]), **scalars)


@pytest.fixture(scope="module")
def traced_inputs():
    """64² images, batch 2, their kernels, and the JAX traced chain's output for each of ``CHAIN_KEYS`` (one compile)."""
    imgs = _images(np.random.default_rng(0), 2, 64)
    kernels = _kernels(2)
    fn = jdeg.RealESRGANDegradation(resolution=64).jitted()
    outs = {k: tuple(np.asarray(x) for x in fn(jax.random.PRNGKey(k), jnp.asarray(imgs),
                                                  tuple(jnp.asarray(x) for x in kernels))) for k in CHAIN_KEYS}
    draws = {k: jax_traced_draws(jax.random.PRNGKey(k), 2, 64) for k in CHAIN_KEYS}
    return imgs, kernels, draws, outs


@pytest.mark.parametrize("key", CHAIN_KEYS)
def test_traced_chain_with_the_jax_draws(traced_inputs, key):
    imgs, kernels, all_draws, outs = traced_inputs
    draws = all_draws[key]
    assert draws.u[1] < 0.5 and draws.u[4] < 0.5  # both noise stages Gaussian
    lq, gt = tdeg.RealESRGANDegradation(resolution=64).traced_call(_t(imgs), tuple(_t(k) for k in kernels),
                                                                   draws=draws)
    assert lq.shape == gt.shape == (2, 64, 64, 3)
    _close(gt, outs[key][1])
    _jpeg_close(lq, outs[key][0], scale=2.0)


def test_chain_keys_cover_both_orders_and_every_mode(traced_inputs):
    draws = list(traced_inputs[2].values())
    assert {d.u[5] < 0.5 for d in draws} == {True, False}
    assert {m for d in draws for m in (d.mode1, d.mode2, d.mode3)} == {0, 1, 2}


def test_traced_chain_refuses_unaligned_sizes():
    deg = tdeg.RealESRGANDegradation(resolution=64)
    with pytest.raises(ValueError, match="multiples"):
        deg.traced_call(torch.zeros(1, 48, 48, 3), tuple(torch.zeros(1, 21, 21) for _ in range(3)))


class _Recorder:
    """Wraps the JAX noise functions to record, per call, the draws they make from their keys."""

    def __init__(self, monkeypatch):
        self.draws = []
        gauss, poisson = jdeg.add_gaussian_noise, jdeg.add_poisson_noise

        def g(key, img, sigma, gray):
            k1, k2 = jax.random.split(key)
            self.draws.append(tdeg.NoiseDraws(normal=np.asarray(jax.random.normal(k1, img.shape)),
                                              gray_normal=np.asarray(jax.random.normal(k2, img.shape[:3] + (1,)))))
            return gauss(key, img, sigma, gray)

        def p(key, img, scale, gray, vals=256.0):
            k1, k2 = jax.random.split(key)
            gray_img = jnp.clip(jnp.mean(img, -1, keepdims=True), 0, 1)
            self.draws.append(tdeg.NoiseDraws(
                counts=np.asarray(jax.random.poisson(k1, jnp.clip(img, 0, 1) * vals).astype(jnp.float32)),
                gray_counts=np.asarray(jax.random.poisson(k2, gray_img * vals).astype(jnp.float32))))
            return poisson(key, img, scale, gray, vals)

        monkeypatch.setattr(jdeg, "add_gaussian_noise", g)
        monkeypatch.setattr(jdeg, "add_poisson_noise", p)


@pytest.mark.parametrize("seed", EAGER_SEEDS)
def test_eager_chain_with_the_same_host_rng(monkeypatch, seed):
    """The eager chain at 48² (not a multiple of 16·sf): the choices from the
    same numpy ``host_rng``, the pixel noise JAX's own draws."""
    rec = _Recorder(monkeypatch)
    imgs, kernels = _images(np.random.default_rng(1), 2, 48), _kernels(2, 17)
    want = jdeg.RealESRGANDegradation(resolution=32)(
        jax.random.PRNGKey(5), jnp.asarray(imgs), kernels=tuple(jnp.asarray(k) for k in kernels),
        host_rng=np.random.default_rng(seed))
    assert len(rec.draws) == 2
    got = tdeg.RealESRGANDegradation(resolution=32)(_t(imgs), tuple(_t(k) for k in kernels),
                                                    host_rng=np.random.default_rng(seed), noise1=rec.draws[0],
                                                    noise2=rec.draws[1])
    assert got[0].shape == (2, 32, 32, 3)
    _close(got[1], want[1])
    _jpeg_close(got[0], want[0], scale=2.0)


def test_run_degradation_dispatch(monkeypatch):
    """Traced for sides that are multiples of 16·sf (the same output as
    ``traced_call``), eager otherwise (the same as ``__call__`` with the same
    ``host_rng``), as the JAX ``run_degradation`` dispatches."""
    deg = tdeg.RealESRGANDegradation(resolution=64)
    imgs, kernels = _t(_images(np.random.default_rng(2), 1, 64)), tuple(_t(k) for k in _kernels(1))
    got = tcommon.run_degradation(deg, imgs, kernels, jit_mode=True, host_rng=None,
                                  generator=torch.Generator().manual_seed(1),
                                  device_generator=torch.Generator().manual_seed(2))
    want = deg.traced_call(imgs, kernels, generator=torch.Generator().manual_seed(1),
                           device_generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    calls = []
    monkeypatch.setattr(tdeg.RealESRGANDegradation, "traced_call", lambda *a, **k: calls.append("traced"))
    monkeypatch.setattr(tdeg.RealESRGANDegradation, "__call__", lambda *a, **k: calls.append("eager"))
    for size, jit_mode in ((64, True), (48, True), (64, False)):
        tcommon.run_degradation(deg, torch.zeros(1, size, size, 3), kernels, jit_mode=jit_mode, host_rng=None)
    assert calls == ["traced", "eager", "eager"]
    jcalls = []
    jd = jdeg.RealESRGANDegradation(resolution=64)
    monkeypatch.setattr(jdeg.RealESRGANDegradation, "jitted", lambda self: (lambda *a: jcalls.append("traced")))
    monkeypatch.setattr(jdeg.RealESRGANDegradation, "__call__", lambda *a, **k: jcalls.append("eager"))
    for size, jit_mode in ((64, True), (48, True), (64, False)):
        jcommon.run_degradation(jd, None, jnp.zeros((1, size, size, 3)), None, jit_mode=jit_mode, host_rng=None)
    assert jcalls == calls
