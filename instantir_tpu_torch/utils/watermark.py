"""Invisible output watermarking (the reference's optional behavior).

The port's own copy of ``instantir_tpu/utils/watermark.py`` (numpy only).

The reference applies diffusers' ``StableDiffusionXLWatermarker`` to every
decoded image when the optional ``invisible_watermark`` package is
installed (``pipelines/sdxl_instantir.py:63-64, 341-343``), embedding the
standard 48-bit SD watermark message. That package (cv2 + onnx deps) is not
in this image, so the capability is rebuilt from scratch: a blind
DCT-domain quantization-index-modulation (QIM) watermark on the blue
channel — 8×8 block DCT (the same DCT the degradation JPEG uses), one
mid-band coefficient per block carries one message bit by rounding to the
even or odd multiple of a quantization step, message tiled over all blocks
and recovered by majority vote. Deviation (documented): the embedding codec
differs from invisible_watermark's dwtDct (no cv2 here); the *behavior* —
an imperceptible (>40 dB), machine-recoverable provenance mark, off unless
requested, same 48-bit message — matches.

Host-side post-processing on decoded uint8-bound images, exactly where the
reference applies it.
"""

from __future__ import annotations

import numpy as np

# The standard Stable Diffusion watermark message (public diffusers
# constant, shared by every SDXL pipeline).
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = [int(b) for b in bin(WATERMARK_MESSAGE)[2:].zfill(48)]

_STEP = 12.0        # QIM quantization step (0-255 scale): invisible, robust to uint8 rounding
_COEF = (3, 2)      # mid-band DCT coefficient carrying the bit


def _dct_matrix() -> np.ndarray:
    m = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            m[k, n] = np.cos((2 * n + 1) * k * np.pi / 16) * (np.sqrt(0.125) if k == 0 else 0.5)
    return m


_DCT = _dct_matrix()


def _blocks(ch: np.ndarray):
    h, w = ch.shape
    hb, wb = h // 8, w // 8
    return ch[: hb * 8, : wb * 8].reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3), hb, wb


def embed_watermark(images: np.ndarray, bits=None) -> np.ndarray:
    """images: [B,H,W,3] float in [0,1] (or [H,W,3]) → watermarked copy.

    Needs H, W ≥ 8; images smaller than 256² carry fewer than ~2 full
    message tiles and extraction becomes unreliable (the reference's
    watermarker silently degrades the same way on tiny images)."""
    bits = np.asarray(WATERMARK_BITS if bits is None else bits, np.int64)
    single = images.ndim == 3
    imgs = images[None] if single else images
    out = np.array(imgs, np.float32, copy=True)
    for b in range(out.shape[0]):
        blue = out[b, :, :, 2] * 255.0
        blk, hb, wb = _blocks(blue)
        coefs = np.einsum("ij,hwjk,lk->hwil", _DCT, blk.astype(np.float32), _DCT)
        c = coefs[:, :, _COEF[0], _COEF[1]]
        idx = (np.arange(hb * wb) % len(bits)).reshape(hb, wb)
        want = bits[idx]  # 0 → even multiple of _STEP, 1 → odd
        q = np.round(c / _STEP - 0.5 * want) * 1.0
        coefs[:, :, _COEF[0], _COEF[1]] = (q + 0.5 * want) * _STEP
        rec = np.einsum("ji,hwjk,kl->hwil", _DCT, coefs, _DCT)
        blue2 = blue.copy()
        blue2[: hb * 8, : wb * 8] = rec.transpose(0, 2, 1, 3).reshape(hb * 8, wb * 8)
        out[b, :, :, 2] = np.clip(blue2, 0.0, 255.0) / 255.0
    return out[0] if single else out


def extract_watermark(image: np.ndarray, n_bits: int = 48) -> np.ndarray:
    """Recover the embedded bits from one [H,W,3] image in [0,1] by
    majority vote over the message tiling."""
    blue = np.asarray(image, np.float32)[:, :, 2] * 255.0
    blk, hb, wb = _blocks(blue)
    coefs = np.einsum("ij,hwjk,lk->hwil", _DCT, blk.astype(np.float32), _DCT)
    c = coefs[:, :, _COEF[0], _COEF[1]].reshape(-1)
    frac = c / _STEP - np.floor(c / _STEP)
    votes_one = (np.abs(frac - 0.5) < 0.25).astype(np.int64)
    idx = np.arange(c.size) % n_bits
    ones = np.bincount(idx, weights=votes_one, minlength=n_bits)
    total = np.bincount(idx, minlength=n_bits)
    return (ones * 2 > total).astype(np.int64)
