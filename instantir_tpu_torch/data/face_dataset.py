"""Face-identity pair dataset (the consistency-encoder lineage).

Twin of ``instantir_tpu/data/face_dataset.py`` (the reference's dormant
``data/dataset.py:23-182`` ``ImageDataset``): each sample pairs an
*instance* (decoder-target) image with an *encoder* image of the same
identity (drawn from a ``name -> label`` metadata json when given, else the
same image, re-augmented when asked), with filename-derived prompts and the
``conceptname`` / ``{placeholder}`` substitutions, an optional head crop of
the encoder image (the ArcFace template widened by 1.3) and
``random_target_prob`` target shuffling. Host-side numpy on the port's own
``data/dataset.py`` helpers; the numpy draws are the JAX module's, in its
order, so the same seed and files give the same batches. The head crop runs
``utils/face.py``'s warp on the CPU with landmarks from any ``detect_fn``
(``utils/mtcnn.py`` provides the cascade).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from instantir_tpu_torch.data.dataset import IMAGE_EXTS, load_image, random_crop_resize
from instantir_tpu_torch.utils.face import REFERENCE_FACIAL_POINTS_RELATIVE

RESIZE_FACTOR = 1.3  # widen the ArcFace template for head (not tight-face) crops
RESIZED_REFERENCE_POINTS = (
    REFERENCE_FACIAL_POINTS_RELATIVE / RESIZE_FACTOR + (RESIZE_FACTOR - 1) / (2 * RESIZE_FACTOR)
)


def path_to_prompt(path: str, concept_placeholder: str = "a face") -> str:
    """Filename -> prompt: trailing seed numerals dropped, underscores to
    spaces, ``conceptname`` to the concept placeholder (reference
    ``_path_to_prompt``, ``data/dataset.py:120-129``)."""
    parts = Path(path).stem.split("_")
    while parts and parts[-1].isnumeric():
        parts = parts[:-1]
    return " ".join(parts).replace("conceptname", concept_placeholder)


class FaceIdentityDataset:
    def __init__(
        self,
        instance_data_root: str,
        instance_prompt: str = "a photo of {placeholder}",
        metadata_path: Optional[str] = None,
        prompt_in_filename: bool = False,
        use_only_vanilla_for_encoder: bool = False,
        concept_placeholder: str = "a face",
        size: int = 1024,
        center_crop: bool = False,
        aug_images: bool = False,
        use_only_decoder_prompts: bool = False,
        crop_head_for_encoder_image: bool = False,
        random_target_prob: float = 0.0,
        detect_fn=None,
        seed: int = 0,
    ):
        self.root = Path(instance_data_root)
        if not self.root.exists():
            raise ValueError(f"Instance images root {self.root} doesn't exist.")
        self.instance_prompt = instance_prompt
        self.prompt_in_filename = prompt_in_filename
        self.concept_placeholder = concept_placeholder
        self.size = size
        self.center_crop = center_crop
        self.aug_images = aug_images
        self.use_only_decoder_prompts = use_only_decoder_prompts
        self.crop_head_for_encoder_image = crop_head_for_encoder_image
        self.random_target_prob = random_target_prob
        self.detect_fn = detect_fn
        self.rng = np.random.default_rng(seed)
        if crop_head_for_encoder_image and detect_fn is None:
            raise ValueError("crop_head_for_encoder_image requires detect_fn (see utils/mtcnn.py)")

        self.name_to_label: Optional[Dict[str, str]] = None
        if metadata_path is not None:
            with open(metadata_path) as f:
                self.name_to_label = json.load(f)
            self.label_to_names: Dict[str, List[str]] = {}
            for name, label in self.name_to_label.items():
                if use_only_vanilla_for_encoder and "vanilla" not in name:
                    continue
                self.label_to_names.setdefault(label, []).append(name)
            paths = [self.root / name for name in self.name_to_label]
            self.all_paths = [p for p in paths if p.exists()]
        else:
            self.all_paths = sorted((p for p in self.root.glob("**/*") if p.suffix.lower() in IMAGE_EXTS),
                                    key=lambda p: p.stem)

    def __len__(self) -> int:
        return len(self.all_paths)

    def _load(self, path) -> np.ndarray:
        img = load_image(str(path))
        if self.center_crop:
            h, w, _ = img.shape
            scale = self.size / min(h, w)
            if scale != 1.0:
                from PIL import Image

                nh, nw = max(self.size, round(h * scale)), max(self.size, round(w * scale))
                img = np.asarray(Image.fromarray((img * 255).astype(np.uint8)).resize((nw, nh), Image.BILINEAR),
                                 np.float32) / 255.0
                h, w = nh, nw
            top, left = (h - self.size) // 2, (w - self.size) // 2
            img = img[top:top + self.size, left:left + self.size]
        else:
            img = random_crop_resize(self.rng, img, self.size)
        return img * 2.0 - 1.0  # to [-1, 1]

    def _prompt(self, path) -> str:
        if self.prompt_in_filename:
            return path_to_prompt(str(path), self.concept_placeholder)
        return self.instance_prompt

    def _augment(self, img: np.ndarray) -> np.ndarray:
        """RandomResizedCrop (scale 0.8-1.0, ratio 1) and a horizontal flip
        (reference ``aug_transforms``, ``data/dataset.py:113-118``)."""
        from PIL import Image

        h, w, _ = img.shape
        area = self.rng.uniform(0.8, 1.0) * h * w
        side = min(int(round(np.sqrt(area))), h, w)
        top = int(self.rng.integers(0, h - side + 1))
        left = int(self.rng.integers(0, w - side + 1))
        crop = img[top:top + side, left:left + side]
        out = np.asarray(Image.fromarray(((crop + 1) * 127.5).astype(np.uint8)).resize((w, h), Image.BILINEAR),
                         np.float32) / 127.5 - 1.0
        if self.rng.uniform() < 0.5:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def _head_crop(self, img: np.ndarray) -> np.ndarray:
        import torch

        from instantir_tpu_torch.utils.face import similarity_transform, warp_affine

        landmarks, invalid = self.detect_fn(img[None])
        if invalid:  # no face found: the whole image (the reference's fallback)
            return img
        m = similarity_transform(np.asarray(landmarks[0], np.float64), RESIZED_REFERENCE_POINTS * self.size)
        with torch.no_grad():
            out = warp_affine(torch.from_numpy(np.ascontiguousarray(img, np.float32)),
                              torch.from_numpy(m.astype(np.float32)), (self.size, self.size))
        return out.numpy()

    def __getitem__(self, index: int) -> dict:
        path = self.all_paths[index]
        example = {"instance_images": self._load(path), "instance_prompt": self._prompt(path)}

        if self.name_to_label is None:
            enc = self._augment(example["instance_images"]) if self.aug_images else example["instance_images"]
            example["encoder_images"] = enc
            example["encoder_prompt"] = example["instance_prompt"]
        else:
            name = str(path.relative_to(self.root))
            label = self.name_to_label[name]
            candidates = [n for n in self.label_to_names.get(label, [name]) if n != name]
            enc_name = str(self.rng.choice(candidates)) if candidates else name
            example["encoder_images"] = self._load(self.root / enc_name)
            example["encoder_prompt"] = self._prompt(self.root / enc_name)

        if self.crop_head_for_encoder_image:
            example["encoder_images"] = self._head_crop(example["encoder_images"])

        example["encoder_prompt"] = example["encoder_prompt"].format(placeholder="<ph>")
        example["instance_prompt"] = example["instance_prompt"].format(placeholder="<s*>")

        if self.rng.uniform() < self.random_target_prob:
            rnd = self.all_paths[int(self.rng.integers(0, len(self.all_paths)))]
            example["instance_images"] = self._load(rnd)
            if self.prompt_in_filename:
                example["instance_prompt"] = path_to_prompt(str(rnd), self.concept_placeholder)

        if self.use_only_decoder_prompts:
            example["encoder_prompt"] = example["instance_prompt"]
        return example

    def batches(self, batch_size: int) -> Iterator[dict]:
        while True:
            idx = self.rng.integers(0, len(self), size=batch_size)
            items = [self[int(i)] for i in idx]
            yield {
                "instance_images": np.stack([it["instance_images"] for it in items]),
                "encoder_images": np.stack([it["encoder_images"] for it in items]),
                "instance_prompt": [it["instance_prompt"] for it in items],
                "encoder_prompt": [it["encoder_prompt"] for it in items],
            }
