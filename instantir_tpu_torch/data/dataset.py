"""Training data: image-folder datasets, weighted mixing, and the blur-kernel
triples each sample ships with.

Twin of ``instantir_tpu/data/dataset.py`` (the reference's data plumbing,
``utils/train_utils.py:55-200``, ``data/data_config.py`` and
``config_files/IR_dataset.yaml``), kept as the port's own copy: each dataset
is a folder of images; the transform resizes the shorter side and crops
``gt_size``²; every sample ships a (kernel, kernel2, sinc_kernel) triple
drawn on the host; datasets mix by weighted draws. The numpy draws are the
JAX module's, in its order, so the same seed gives bitwise the same batches
and captions. PyYAML (for the data config) and Pillow are imported inside
the functions that use them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional

import numpy as np

from instantir_tpu_torch.data.kernels import KERNEL_OPT, sample_kernel_triple

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


@dataclasses.dataclass
class SingleDataConfig:
    dataset_folder: str
    dataset_weight: float = 1.0
    # reference SingleDataConfig: imagefolder + weight (data/data_config.py:5-9)


@dataclasses.dataclass
class DataConfig:
    datasets: List[SingleDataConfig]
    val_dataset: Optional[SingleDataConfig] = None
    batch_size: int = 4
    gt_size: int = 512


def load_data_config(path: str, data_dir: str = "") -> DataConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    datasets = [
        SingleDataConfig(os.path.join(data_dir, d["dataset_folder"]), d.get("dataset_weight", 1.0))
        for d in raw["datasets"]
    ]
    val = raw.get("val_dataset")
    val_cfg = SingleDataConfig(os.path.join(data_dir, val["dataset_folder"])) if val else None
    return DataConfig(datasets=datasets, val_dataset=val_cfg)


def list_images(folder: str) -> List[str]:
    out = []
    for root, _, files in os.walk(folder):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(root, f))
    return out


def load_captions(folder: str) -> dict:
    """Per-image captions, HF imagefolder convention: ``metadata.jsonl`` rows
    ``{"file_name": ..., "text": ...}`` (the reference trains on imagefolder
    datasets whose text column feeds ``encode_prompt``,
    ``utils/train_utils.py:55-102,190-237``). ``text`` may be a string or a
    list of strings (multi-caption)."""
    import json

    captions = {}
    meta = os.path.join(folder, "metadata.jsonl")
    if os.path.exists(meta):
        with open(meta) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                captions[os.path.normpath(os.path.join(folder, rec["file_name"]))] = rec.get("text", "")
    return captions


def caption_for(path: str, captions: dict, rng: np.random.Generator) -> str:
    """Caption lookup: metadata entry (random choice for multi-caption, the
    reference's ``random.choice(caption_column)`` at
    ``utils/train_utils.py:205-214``) → sidecar ``.txt`` → empty string."""
    cap = captions.get(os.path.normpath(path))
    if cap is None:
        sidecar = os.path.splitext(path)[0] + ".txt"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                cap = f.read().strip()
        else:
            cap = ""
    if isinstance(cap, (list, tuple)):
        cap = str(cap[int(rng.integers(len(cap)))]) if cap else ""
    return str(cap)


def load_image(path: str) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def random_crop_resize(rng: np.random.Generator, img: np.ndarray, size: int) -> np.ndarray:
    """Resize shorter side to ``size`` then random-crop size² (reference
    ``prepare_train_dataset`` transform)."""
    h, w, _ = img.shape
    scale = size / min(h, w)
    if scale != 1.0:
        from PIL import Image

        nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
        img = np.asarray(
            Image.fromarray((img * 255).astype(np.uint8)).resize((nw, nh), Image.BICUBIC), dtype=np.float32
        ) / 255.0
        h, w = nh, nw
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top : top + size, left : left + size]


class WeightedImageDataset:
    """Weighted mixture of imagefolder datasets with kernel triples.

    Per-process sharding: pass (process_index, process_count); each process
    consumes an independent, deterministic sample stream.
    """

    def __init__(
        self,
        config: DataConfig,
        kernel_opt: dict = None,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.config = config
        self.kernel_opt = kernel_opt or KERNEL_OPT
        self.files: List[List[str]] = [list_images(d.dataset_folder) for d in config.datasets]
        self.captions: dict = {}
        for d, fs in zip(config.datasets, self.files):
            if not fs:
                raise FileNotFoundError(f"no images under {d.dataset_folder}")
            self.captions.update(load_captions(d.dataset_folder))
        weights = np.asarray([d.dataset_weight for d in config.datasets], np.float64)
        self.weights = weights / weights.sum()
        self.rng = np.random.default_rng(seed * 1000003 + process_index)
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return sum(len(f) for f in self.files)

    def sample(self, gt_size: int):
        ds = int(self.rng.choice(len(self.files), p=self.weights))
        path = self.files[ds][int(self.rng.integers(len(self.files[ds])))]
        img = random_crop_resize(self.rng, load_image(path), gt_size)
        kernels = sample_kernel_triple(self.rng, self.kernel_opt)
        return img, kernels, caption_for(path, self.captions, self.rng)

    def batches(self, batch_size: int, gt_size: int) -> Iterator[dict]:
        """Infinite stream of collated batches (reference ``collate_fn``,
        ``utils/train_utils.py:176-200``); ``captions`` is a host-side list
        of per-sample strings."""
        while True:
            imgs, k1s, k2s, sks, caps = [], [], [], [], []
            for _ in range(batch_size):
                img, (k1, k2, sk), cap = self.sample(gt_size)
                imgs.append(img)
                k1s.append(k1)
                k2s.append(k2)
                sks.append(sk)
                caps.append(cap)
            yield {
                "images": np.stack(imgs),
                "kernel": np.stack(k1s),
                "kernel2": np.stack(k2s),
                "sinc_kernel": np.stack(sks),
                "captions": caps,
            }


class SyntheticImageDataset(WeightedImageDataset):
    """Procedural images for tests/benchmarks (no files needed)."""

    def __init__(self, seed: int = 0, kernel_opt: dict = None, process_index: int = 0, process_count: int = 1):
        self.kernel_opt = kernel_opt or KERNEL_OPT
        self.rng = np.random.default_rng(seed * 1000003 + process_index)
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self) -> int:
        return 1 << 30

    def sample(self, gt_size: int):
        # smooth random field: random low-res noise upsampled (has edges + texture)
        low = self.rng.uniform(size=(gt_size // 8 + 1, gt_size // 8 + 1, 3)).astype(np.float32)
        from PIL import Image

        img = np.asarray(
            Image.fromarray((low * 255).astype(np.uint8)).resize((gt_size, gt_size), Image.BICUBIC),
            dtype=np.float32,
        ) / 255.0
        kernels = sample_kernel_triple(self.rng, self.kernel_opt)
        return np.clip(img, 0, 1), kernels, f"synthetic image {int(self.rng.integers(1000))}"
