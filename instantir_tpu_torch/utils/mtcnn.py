"""MTCNN face detection (the P-Net / R-Net / O-Net cascade) for IDLoss.

Twin of ``instantir_tpu/utils/mtcnn.py`` (the reference detects with
``facenet_pytorch.MTCNN`` and keeps only the 5-point landmarks). The three
networks run on the device, with the ``facenet_pytorch`` parameter names
(``conv1.weight``, ``prelu1.weight``, ``dense5_1.weight`` ...), so its
``pnet.pt`` / ``rnet.pt`` / ``onet.pt`` state dicts (or one dict under
``pnet.`` / ``rnet.`` / ``onet.``) load by name. The cascade (image pyramid,
dense P-Net proposals, NMS, R-Net refinement, O-Net landmarks) stays on the
host in numpy, as in JAX: its box counts depend on the data. ``nms``,
``_resize_area``, ``_bbreg``, ``_rerec`` and ``_crop_resize`` are the port's
own copies of the JAX module's numpy helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _max_pool_ceil(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """torch ``MaxPool2d(kernel, stride, ceil_mode=True)`` on NCHW, written as
    the JAX module does: pad the trailing edges with -inf to the ceil-mode
    extent, then pool."""
    h, w = x.shape[2:]
    out_h = -(-(h - kernel) // stride) + 1
    out_w = -(-(w - kernel) // stride) + 1
    pad_h, pad_w = (out_h - 1) * stride + kernel - h, (out_w - 1) * stride + kernel - w
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=-float("inf"))
    return F.max_pool2d(x, kernel, stride)


def _matlab_flatten(x: torch.Tensor) -> torch.Tensor:
    """The checkpoints' Caffe/Matlab-order dense input: NCHW -> (W, H, C)
    flattened, C fastest."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class _Net(nn.Module):
    def _conv_prelu(self, i: int, cin: int, cout: int, k: int, dtype, device) -> None:
        setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, dtype=dtype, device=device))
        setattr(self, f"prelu{i}", nn.PReLU(cout, dtype=dtype, device=device))

    def _layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return getattr(self, f"prelu{i}")(getattr(self, f"conv{i}")(x))


class PNet(_Net):
    """Proposal net: fully convolutional, 12×12 receptive field, stride 2.
    [B, 3, H, W] -> (bbox regression [B, 4, h, w], face probability [B, 2, h, w])."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self._conv_prelu(1, 3, 10, 3, dtype, device)
        self._conv_prelu(2, 10, 16, 3, dtype, device)
        self._conv_prelu(3, 16, 32, 3, dtype, device)
        self.conv4_1 = nn.Conv2d(32, 2, 1, dtype=dtype, device=device)
        self.conv4_2 = nn.Conv2d(32, 4, 1, dtype=dtype, device=device)

    def forward(self, x):
        x = _max_pool_ceil(self._layer(x, 1), 2, 2)
        x = self._layer(self._layer(x, 2), 3)
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=1)


class RNet(_Net):
    """Refine net on 24² crops -> (bbox regression [B, 4], face probability [B, 2])."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self._conv_prelu(1, 3, 28, 3, dtype, device)
        self._conv_prelu(2, 28, 48, 3, dtype, device)
        self._conv_prelu(3, 48, 64, 2, dtype, device)
        self.dense4 = nn.Linear(576, 128, dtype=dtype, device=device)
        self.prelu4 = nn.PReLU(128, dtype=dtype, device=device)
        self.dense5_1 = nn.Linear(128, 2, dtype=dtype, device=device)
        self.dense5_2 = nn.Linear(128, 4, dtype=dtype, device=device)

    def forward(self, x):
        x = _max_pool_ceil(self._layer(x, 1), 3, 2)
        x = _max_pool_ceil(self._layer(x, 2), 3, 2)
        x = self.prelu4(self.dense4(_matlab_flatten(self._layer(x, 3))))
        return self.dense5_2(x), torch.softmax(self.dense5_1(x), dim=1)


class ONet(_Net):
    """Output net on 48² crops -> (bbox regression [B, 4], landmarks [B, 10], probability [B, 2])."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self._conv_prelu(1, 3, 32, 3, dtype, device)
        self._conv_prelu(2, 32, 64, 3, dtype, device)
        self._conv_prelu(3, 64, 64, 3, dtype, device)
        self._conv_prelu(4, 64, 128, 2, dtype, device)
        self.dense5 = nn.Linear(1152, 256, dtype=dtype, device=device)
        self.prelu5 = nn.PReLU(256, dtype=dtype, device=device)
        self.dense6_1 = nn.Linear(256, 2, dtype=dtype, device=device)
        self.dense6_2 = nn.Linear(256, 4, dtype=dtype, device=device)
        self.dense6_3 = nn.Linear(256, 10, dtype=dtype, device=device)

    def forward(self, x):
        x = _max_pool_ceil(self._layer(x, 1), 3, 2)
        x = _max_pool_ceil(self._layer(x, 2), 3, 2)
        x = _max_pool_ceil(self._layer(x, 3), 2, 2)
        x = self.prelu5(self.dense5(_matlab_flatten(self._layer(x, 4))))
        return self.dense6_2(x), self.dense6_3(x), torch.softmax(self.dense6_1(x), dim=1)


# ---------------------------------------------------------------------------
# Cascade (host-side numpy; data-dependent box counts)
# ---------------------------------------------------------------------------


def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float, mode: str = "union") -> np.ndarray:
    """Greedy non-max suppression; ``mode='min'`` divides the intersection by
    the smaller box's area (the cascade's last stage)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        if mode == "min":
            iou = inter / np.minimum(area[i], area[order[1:]])
        else:
            iou = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][iou <= threshold]
    return np.asarray(keep, np.int64)


def _resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Adaptive average pooling (torch ``interpolate(mode='area')`` when
    downscaling, the pyramid's resampler). img: [H, W, C] float."""
    h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img

    def pool_axis(x, n_in, n_out, axis):
        starts = (np.arange(n_out) * n_in) // n_out
        ends = -(-(np.arange(1, n_out + 1) * n_in) // n_out)
        cs = np.cumsum(np.moveaxis(x, axis, 0), axis=0, dtype=np.float64)
        cs = np.concatenate([np.zeros_like(cs[:1]), cs], axis=0)
        out = (cs[ends] - cs[starts]) / (ends - starts).reshape((-1,) + (1,) * (x.ndim - 1))
        return np.moveaxis(out, 0, axis)

    return pool_axis(pool_axis(img, h, out_h, 0), w, out_w, 1).astype(np.float32)


def _bbreg(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + reg[:, 0] * w
    out[:, 1] = boxes[:, 1] + reg[:, 1] * h
    out[:, 2] = boxes[:, 2] + reg[:, 2] * w
    out[:, 3] = boxes[:, 3] + reg[:, 3] * h
    return out


def _rerec(boxes: np.ndarray) -> np.ndarray:
    """Square each box around its centre (the cascade crops squares)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int) -> np.ndarray:
    """Zero-padded square crops area-resized to size². img [H, W, 3] 0..255."""
    h, w, _ = img.shape
    out = np.zeros((len(boxes), size, size, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:, :4].astype(np.int64)):
        cw, ch = x2 - x1 + 1, y2 - y1 + 1
        if cw <= 0 or ch <= 0:  # degenerate regressed box: zero crop
            continue
        patch = np.zeros((ch, cw, 3), np.float32)
        sx1, sy1 = max(x1, 0), max(y1, 0)
        sx2, sy2 = min(x2 + 1, w), min(y2 + 1, h)
        if sx2 > sx1 and sy2 > sy1:
            patch[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
        out[i] = _resize_area(patch, size, size)
    return out


@dataclasses.dataclass(frozen=True)
class MTCNNConfig:
    min_face_size: int = 20
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7)
    factor: float = 0.709  # pyramid scale step


class MTCNN:
    """The assembled detector: the three networks on ``device`` and the host
    cascade. ``state``: one flat dict under ``pnet.`` / ``rnet.`` / ``onet.``
    (the facenet_pytorch names), or None to keep the modules' own weights."""

    def __init__(self, state: Dict[str, torch.Tensor] = None, config: MTCNNConfig = MTCNNConfig(), device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MTCNN: device 'cuda' requested but no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        self.config = config
        self.device = device
        self.pnet, self.rnet, self.onet = (net(device=device).requires_grad_(False).eval()
                                           for net in (PNet, RNet, ONet))
        if state is not None:
            for name in ("pnet", "rnet", "onet"):
                sub = {k[len(name) + 1:]: v for k, v in state.items() if k.startswith(name + ".")}
                getattr(self, name).load_state_dict(sub, strict=True)

    def _run(self, net: nn.Module, x: np.ndarray) -> Tuple[np.ndarray, ...]:
        """[N, H, W, 3] pixels 0..255 through ``net`` (normalized to [-1, 1]
        on the host, NCHW on the device) -> numpy outputs, NHWC where spatial."""
        x = torch.from_numpy(((x - 127.5) * 0.0078125).astype(np.float32)).to(self.device)
        with torch.no_grad():
            outs = net(x.permute(0, 3, 1, 2))
        return tuple((o.permute(0, 2, 3, 1) if o.dim() == 4 else o).float().cpu().numpy() for o in outs)

    def _stage1(self, img: np.ndarray) -> np.ndarray:
        h, w, _ = img.shape
        cfg = self.config
        m = 12.0 / cfg.min_face_size
        scale, minl = m, min(h, w) * m
        all_boxes: List[np.ndarray] = []
        while minl >= 12:
            hs, ws = int(h * scale + 1), int(w * scale + 1)
            reg, prob = self._run(self.pnet, _resize_area(img, hs, ws)[None])
            reg, score = reg[0], prob[0, :, :, 1]
            ys, xs = np.nonzero(score >= cfg.thresholds[0])
            if len(ys):
                stride, cell = 2, 12
                q1 = np.stack([(stride * xs + 1), (stride * ys + 1)], axis=1) / scale
                q2 = np.stack([(stride * xs + cell), (stride * ys + cell)], axis=1) / scale
                boxes = np.concatenate([q1, q2, score[ys, xs, None], reg[ys, xs]], axis=1).astype(np.float32)
                boxes = boxes[nms(boxes[:, :4], boxes[:, 4], 0.5)]
                all_boxes.append(boxes)
            scale *= cfg.factor
            minl *= cfg.factor
        if not all_boxes:
            return np.zeros((0, 9), np.float32)
        boxes = np.concatenate(all_boxes, axis=0)
        boxes = boxes[nms(boxes[:, :4], boxes[:, 4], 0.7)]
        boxes[:, :4] = _rerec(_bbreg(boxes[:, :4], boxes[:, 5:9]))
        return boxes

    def detect(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """img: [H, W, 3] uint8/float 0..255 -> (boxes [N, 4], probs [N],
        landmarks [N, 5, 2] xy), largest area first (the reference's
        ``select_largest`` order)."""
        img = np.asarray(img, np.float32)
        cfg = self.config
        boxes = self._stage1(img)
        empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32), np.zeros((0, 5, 2), np.float32))
        if not len(boxes):
            return empty

        reg, prob = self._run(self.rnet, _crop_resize(img, boxes, 24))
        score = prob[:, 1]
        keep = score >= cfg.thresholds[1]
        boxes, reg, score = boxes[keep], reg[keep], score[keep]
        if not len(boxes):
            return empty
        keep = nms(boxes[:, :4], score, 0.7)
        boxes, reg, score = boxes[keep], reg[keep], score[keep]
        boxes[:, :4] = _rerec(_bbreg(boxes[:, :4], reg))

        reg, pts, prob = self._run(self.onet, _crop_resize(img, boxes, 48))
        score = prob[:, 1]
        w = boxes[:, 2] - boxes[:, 0] + 1
        h = boxes[:, 3] - boxes[:, 1] + 1
        lm_x = w[:, None] * pts[:, 0:5] + boxes[:, 0:1] - 1
        lm_y = h[:, None] * pts[:, 5:10] + boxes[:, 1:2] - 1
        landmarks = np.stack([lm_x, lm_y], axis=-1)
        keep = score >= cfg.thresholds[2]
        boxes, score, landmarks = boxes[keep], score[keep], landmarks[keep]
        if not len(boxes):
            return empty
        boxes[:, :4] = _bbreg(boxes[:, :4], reg[keep])
        keep = nms(boxes[:, :4], score, 0.7, mode="min")
        boxes, score, landmarks = boxes[keep, :4], score[keep], landmarks[keep]
        order = np.argsort(-(boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
        return boxes[order], score[order], landmarks[order]


def load_mtcnn(weights_path: str, config: MTCNNConfig = MTCNNConfig(), device="cuda") -> MTCNN:
    from instantir_tpu_torch.convert import load_torch_state_dict

    return MTCNN(load_torch_state_dict(weights_path), config, device=device)


def build_detect_fn(mtcnn: MTCNN):
    """IDLoss's ``detect_fn``: [B, H, W, 3] images in [-1, 1] (a tensor or an
    array) -> (landmarks [B, 5, 2] float32, invalid indices). A host loop
    over the images; the strongest face of each (the reference's
    ``detect_face`` takes ``landmarks[0]``)."""

    def detect_fn(images) -> Tuple[np.ndarray, List[int]]:
        if isinstance(images, torch.Tensor):
            images = images.detach().float().cpu().numpy()
        arr = (np.asarray(images, np.float32) * 0.5 + 0.5) * 255.0
        lms, invalid = [], []
        for i, img in enumerate(arr):
            _, _, landmarks = mtcnn.detect(img)
            if len(landmarks) == 0:
                invalid.append(i)
                lms.append(np.zeros((5, 2), np.float32))
            else:
                lms.append(landmarks[0].astype(np.float32))
        return np.stack(lms), invalid

    return detect_fn
