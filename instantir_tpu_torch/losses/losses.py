"""Diffusion-space losses, config-instantiated and registry-dispatched.

Twin of ``instantir_tpu/losses/losses.py``. Ported: L2 with optional
per-sample importance weights (the stage-1/2 diffusion objective), L1,
pseudo-Huber (the previewer's LCM distillation), WeightedNoise, DINOLoss
(teacher-centred softmax cross-entropy over DINOv2 tokens, the features from
a ``feature_fn`` the trainer supplies) and ``LCMVisualization``; and the
perceptual losses with their towers: LPIPS (VGG16 and linear heads,
``lpips.py``), CLIPLoss (the CLIP vision and text towers and the
augmentations, ``models/clip_vision.py``, ``augmentations.py``), IDLoss
(ArcFace IR-SE50, ``arcface.py``, with MTCNN landmarks, ``utils/mtcnn.py``)
and DreamSIMLoss (injected backbones). Every loss is computed in fp32
whatever the model dtype. A perceptual loss built without its weights
(a ``weights_path``, or injected state dicts or callables) raises
``NotImplementedError`` at construction, naming itself, as in JAX: no
pretrained file is shipped. The towers are built on ``device`` (default
``cuda``; a trainer passes its own through ``build_losses``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from instantir_tpu_torch.losses.loss_config import SingleLossConfig


@dataclasses.dataclass
class DiffusionLossInputs:
    """Everything a diffusion-space loss may consume."""

    predicted: torch.Tensor  # model output (eps-hat or consistency prediction)
    target: torch.Tensor  # eps or distillation target
    timesteps: Optional[torch.Tensor] = None  # [B]
    weights: Optional[torch.Tensor] = None  # [B] importance weights
    pred_image: Optional[torch.Tensor] = None  # decoded prediction (image-space losses)
    target_image: Optional[torch.Tensor] = None
    prompt_ids: Optional[torch.Tensor] = None  # [B, 77] CLIP token ids (CLIPLoss)
    augmentations: Any = None  # CLIPLoss's ``augmentations.AugmentationDraws``; drawn from ``generator`` if None
    generator: Optional[torch.Generator] = None  # for stochastic losses (CLIPLoss's augmentations)


class Loss:
    """Base: ``__call__(inputs) -> scalar``."""

    # image-space losses set True: a trainer then decodes pred/target through
    # the VAE and fills pred_image/target_image
    needs_images: bool = False

    def __init__(self, visualize_every_k: int = -1, **kwargs):
        self.visualize_every_k = visualize_every_k

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        raise NotImplementedError


def _weighted_mean(per_sample: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return per_sample.mean()
    return (per_sample * weights.to(per_sample.dtype)).mean()


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


class L2Loss(Loss):
    """MSE with optional per-sample importance weights."""

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        per = _per_sample_mean((inputs.predicted.float() - inputs.target.float()) ** 2)
        return _weighted_mean(per, inputs.weights)


class L1Loss(Loss):
    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        per = _per_sample_mean((inputs.predicted.float() - inputs.target.float()).abs())
        return _weighted_mean(per, inputs.weights)


class HuberLoss(Loss):
    """Pseudo-Huber: sqrt(d^2 + c^2) - c (c = 0.001 in the reference recipe)."""

    def __init__(self, huber_c: float = 0.001, **kwargs):
        super().__init__(**kwargs)
        self.huber_c = huber_c

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        d2 = (inputs.predicted.float() - inputs.target.float()) ** 2
        per = _per_sample_mean(torch.sqrt(d2 + self.huber_c**2) - self.huber_c)
        return _weighted_mean(per, inputs.weights)


class WeightedNoiseLoss(L2Loss):
    """L2 with externally supplied per-sample weights."""


FeatureFn = Callable[[torch.Tensor], torch.Tensor]


class DINOLoss(Loss):
    """Teacher-centred softmax cross-entropy over DINOv2 tokens: student
    tokens of ``pred_image`` at temperature ``student_temp``, teacher tokens
    of ``target_image`` (no gradient) less a running center at
    ``teacher_temp``. ``feature_fn`` maps [-1, 1] NHWC images to tokens
    ``[B, N, D]``; the trainer passes its DINOv2."""

    needs_images = True

    def __init__(self, feature_fn: Optional[FeatureFn] = None, student_temp: float = 0.1,
                 teacher_temp: float = 0.04, center_momentum: float = 0.9, **kwargs):
        super().__init__(**kwargs)
        self.feature_fn = feature_fn
        self.student_temp = student_temp
        self.teacher_temp = teacher_temp
        self.center_momentum = center_momentum
        self.center: Optional[torch.Tensor] = None  # running center, folded by update_center

    def apply_with_center(self, inputs: DiffusionLossInputs, feature_fn: FeatureFn,
                          center: Union[torch.Tensor, float]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, the teacher tokens' mean over batch and tokens): the caller
        folds the mean into its center with ``center_momentum``."""
        student = feature_fn(inputs.pred_image).float()
        with torch.no_grad():
            teacher = feature_fn(inputs.target_image).float()
        t = torch.softmax((teacher - center) / self.teacher_temp, dim=-1)
        log_s = torch.log_softmax(student / self.student_temp, dim=-1)
        loss = -(t * log_s).sum(dim=-1).mean()
        return loss, teacher.mean(dim=(0, 1))

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if self.feature_fn is None:
            raise ValueError("DINOLoss requires feature_fn (the DINOv2 forward)")
        loss, self.latest_teacher_mean = self.apply_with_center(
            inputs, self.feature_fn, 0.0 if self.center is None else self.center)
        return loss

    def update_center(self) -> None:
        """Fold the last call's teacher mean into the center (momentum
        ``center_momentum``; the first fold takes the mean as it is)."""
        if not hasattr(self, "latest_teacher_mean"):
            return
        m, mean = self.center_momentum, self.latest_teacher_mean
        self.center = mean if self.center is None else self.center * m + mean * (1 - m)


class LCMVisualization(Loss):
    """Contributes 0 to the objective. Its presence asks the previewer
    trainer for an [lq | gt | one-step prediction] strip every
    ``visualize_every_k`` steps (and so for the decoded images)."""

    needs_images = True

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=inputs.predicted.device)


def _require_weights(name: str, hint: str):
    raise NotImplementedError(
        f"{name} needs pretrained weights: pass weights_path=<torch checkpoint> (or inject "
        f"params/embed fns) in the loss config's init_params. {hint}"
    )


def _device(what: str, device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to build it on the CPU)")
    return device


def _tower(model: torch.nn.Module, state: Dict[str, Any], device: torch.device) -> torch.nn.Module:
    """``model`` with ``state`` (tensors or arrays) loaded strictly, frozen, in eval mode on ``device``."""
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return model.to(device).requires_grad_(False).eval()


def _normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


class LPIPSLoss(Loss):
    """Perceptual distance through VGG16 features (``lpips.LPIPS(net='vgg')``)
    between ``pred_image`` and ``target_image`` ([-1, 1] NHWC pixels).
    ``params``: a state dict under the published names, or ``weights_path``."""

    needs_images = True

    def __init__(self, weights_path: Optional[str] = None, params=None, config=None, device="cuda", **kwargs):
        super().__init__(**kwargs)
        from instantir_tpu_torch.losses.lpips import LPIPS, LPIPSConfig

        self.config = config or LPIPSConfig()
        if params is None and weights_path:
            from instantir_tpu_torch.convert import load_torch_state_dict

            params = load_torch_state_dict(weights_path)
        if params is None:
            _require_weights("LPIPSLoss", "Export one with lpips.LPIPS(net='vgg').state_dict().")
        module = LPIPS(self.config)
        self.module = _tower(module, {n: params[n] for n in module.state_dict()}, _device("LPIPSLoss", device))

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if inputs.pred_image is None or inputs.target_image is None:
            raise ValueError("LPIPSLoss needs pred_image/target_image (decoded pixels)")
        return self.module(inputs.pred_image.float(), inputs.target_image.float()).mean()


class CLIPLoss(Loss):
    """Image-text alignment of the prediction with its prompt (reference
    ``losses/losses.py:335-374``): the batch is tiled through random affine /
    perspective augmentations, CLIP-embedded and scored ``1 − diag(logits)/100``.
    ``params``: (vision state dict, text state dict, logit scale) under the
    HF names, or ``weights_path``: one HF ``CLIPModel`` state dict
    (``vision_model.*``, ``text_model.*``, ``visual_projection.weight``,
    ``text_projection.weight``, ``logit_scale``; the scale exponentiated,
    100 when absent). The augmentations come from ``inputs.augmentations``,
    else from ``inputs.generator``."""

    needs_images = True

    def __init__(self, weights_path: Optional[str] = None, params=None, augmentations_number: int = 4,
                 vision_config=None, text_config=None, device="cuda", **kwargs):
        super().__init__(**kwargs)
        from instantir_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
        from instantir_tpu_torch.models.clip_vision import CLIPVisionModel, clip_vit_b16_config

        self.vision_config = vision_config or clip_vit_b16_config()
        self.text_config = text_config or CLIPTextConfig(
            hidden_size=512, num_layers=12, num_heads=8, intermediate_size=2048, projection_dim=512
        )  # ViT-B/16's text tower
        self.augmentations_number = augmentations_number
        if params is None and weights_path:
            from instantir_tpu_torch.convert import load_torch_state_dict

            sd = load_torch_state_dict(weights_path)
            scale = float(math.exp(float(sd["logit_scale"]))) if "logit_scale" in sd else 100.0
            params = (sd, sd, scale)
        if params is None:
            _require_weights("CLIPLoss", "Use an HF CLIPModel (ViT-B/16) state dict.")
        vision_sd, text_sd, self.logit_scale = params
        device = _device("CLIPLoss", device)
        vision, text = CLIPVisionModel(self.vision_config), CLIPTextModel(self.text_config)
        self.vision = _tower(vision, {n: vision_sd[n] for n in vision.state_dict()}, device)
        self.text = _tower(text, {n: text_sd[n] for n in text.state_dict()}, device)

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if inputs.pred_image is None or inputs.prompt_ids is None:
            raise ValueError("CLIPLoss needs pred_image and prompt_ids")
        from instantir_tpu_torch.losses.augmentations import image_augmentations
        from instantir_tpu_torch.models.clip_vision import preprocess_clip

        size = self.vision_config.image_size
        images01 = (inputs.pred_image.float() + 1.0) / 2.0
        batch = image_augmentations(images01, size, self.augmentations_number, draws=inputs.augmentations,
                                    generator=inputs.generator)
        _, img = self.vision(preprocess_clip(batch, size).permute(0, 3, 1, 2))
        _, _, txt = self.text(inputs.prompt_ids.long())
        txt = _normalize(txt.float()).repeat(self.augmentations_number, 1)
        logits = self.logit_scale * (_normalize(img.float()) * txt).sum(dim=-1)  # diag of logits_per_image
        return (1.0 - logits / 100.0).mean()


class IDLoss(Loss):
    """Face-identity cosine distance through ArcFace IR-SE50 (reference
    ``:188-293``). Landmarks come from an injected ``detect_fn`` ([B, H, W,
    3] -> (landmarks [B, 5, 2], invalid indices)) or the MTCNN cascade of
    ``mtcnn_weights_path``, on the host; faces are aligned by the
    differentiable warp (``utils/face.py``), embedded and scored ``1 − cos``
    (the target's features without gradient). ``params``: an IR-SE50 state
    dict under the InsightFace names (BatchNorms folded on load), or
    ``pretrained_arcface_path``."""

    needs_images = True

    def __init__(self, pretrained_arcface_path: Optional[str] = None, params=None, detect_fn=None,
                 mtcnn_weights_path: Optional[str] = None, skip_not_found: bool = True, config=None, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        from instantir_tpu_torch.losses.arcface import ArcFaceBackbone, import_arcface, ir_se_50_config

        self.config = config or ir_se_50_config()
        self.skip_not_found = skip_not_found
        if params is None and pretrained_arcface_path:
            from instantir_tpu_torch.convert import load_torch_state_dict

            params = load_torch_state_dict(pretrained_arcface_path)
        if params is None:
            _require_weights("IDLoss", "InsightFace model_ir_se50.pth.")
        device = _device("IDLoss", device)
        if detect_fn is None and mtcnn_weights_path:
            from instantir_tpu_torch.utils.mtcnn import build_detect_fn, load_mtcnn

            detect_fn = build_detect_fn(load_mtcnn(mtcnn_weights_path, device=device))
        if detect_fn is None:
            raise NotImplementedError(
                "IDLoss needs a face detector: pass mtcnn_weights_path (facenet_pytorch "
                "pnet/rnet/onet checkpoint -- utils/mtcnn.py implements the cascade) or "
                "inject detect_fn via init_params.")
        self.detect_fn = detect_fn
        backbone = ArcFaceBackbone(self.config)
        self.backbone = _tower(backbone, import_arcface(params, backbone), device)

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if inputs.pred_image is None or inputs.target_image is None:
            raise ValueError("IDLoss needs pred_image/target_image (decoded pixels)")
        from instantir_tpu_torch.utils.face import extract_faces_and_landmarks

        pred, target = inputs.pred_image.float(), inputs.target_image.float()
        lm_pred, bad_pred = self.detect_fn(pred)
        lm_tgt, bad_tgt = self.detect_fn(target)
        invalid = set(bad_pred) | set(bad_tgt)
        valid = [i for i in range(pred.shape[0]) if i not in invalid]
        if not valid and self.skip_not_found:
            return (pred * 0.0).mean()  # keeps the graph alive (reference :257-259)
        size = self.config.input_size
        f_pred = self.backbone(extract_faces_and_landmarks(pred[valid], np.asarray(lm_pred)[valid], size))
        with torch.no_grad():
            f_tgt = self.backbone(extract_faces_and_landmarks(target[valid], np.asarray(lm_tgt)[valid], size))
        return (1.0 - (f_pred * f_tgt).sum(dim=-1)).mean()


class DreamSIMLoss(Loss):
    """DreamSim-style perceptual distance (reference ``:53-80``): 224² images
    (antialiased bicubic, ``jax.image.resize``'s weights) embedded by an
    ensemble of backbones, each embedding normalized, the results
    concatenated; distance = 1 − cos, the target side without gradient.
    ``embed_fns``: torch callables from [B, 224, 224, 3] in [0, 1] to [B, D]
    (the published DreamSim ensemble is injected)."""

    needs_images = True

    def __init__(self, embed_fns: Optional[Sequence[Callable[[torch.Tensor], torch.Tensor]]] = None,
                 resize_to: int = 224, **kwargs):
        super().__init__(**kwargs)
        self.resize_to = resize_to
        if not embed_fns:
            _require_weights("DreamSIMLoss", "Inject embed_fns built from DreamSim checkpoint backbones.")
        self.embed_fns = list(embed_fns)

    def _embed(self, images01: torch.Tensor) -> torch.Tensor:
        from instantir_tpu_torch.models.dinov2 import _keys_cubic, resize_bhwc

        if tuple(images01.shape[1:3]) != (self.resize_to, self.resize_to):
            images01 = resize_bhwc(images01, self.resize_to, self.resize_to, _keys_cubic)
        return torch.cat([_normalize(fn(images01).float()) for fn in self.embed_fns], dim=-1)

    def __call__(self, inputs: DiffusionLossInputs) -> torch.Tensor:
        if inputs.pred_image is None or inputs.target_image is None:
            raise ValueError("DreamSIMLoss needs pred_image/target_image (decoded pixels)")
        e_pred = self._embed((inputs.pred_image.float() + 1.0) / 2.0)
        with torch.no_grad():
            e_tgt = self._embed((inputs.target_image.float() + 1.0) / 2.0)
        cos = (e_pred * e_tgt).sum(dim=-1) / (torch.linalg.vector_norm(e_pred, dim=-1)
                                              * torch.linalg.vector_norm(e_tgt, dim=-1))
        return (1.0 - cos).mean()


LOSS_REGISTRY: Dict[str, Any] = {
    "LCMVisualization": LCMVisualization,
    "L2Loss": L2Loss,
    "L1Loss": L1Loss,
    "HuberLoss": HuberLoss,
    "WeightedNoiseLoss": WeightedNoiseLoss,
    "DINOLoss": DINOLoss,
    "LPIPSLoss": LPIPSLoss,
    "DreamSIMLoss": DreamSIMLoss,
    "CLIPLoss": CLIPLoss,
    "IDLoss": IDLoss,
}
def build_losses(configs: List[SingleLossConfig], **shared_kwargs) -> List[Tuple[Loss, float]]:
    """Instantiate (loss, weight) pairs from config. A ``feature_fn`` among
    ``shared_kwargs`` goes to each DINOLoss whose config gives none, a
    ``device`` to each loss (those with towers of their own build them
    there; ``Loss`` drops it for the others); an unknown name raises
    ``KeyError``."""
    out = []
    for c in configs:
        if c.name not in LOSS_REGISTRY:
            raise KeyError(f"unknown loss {c.name!r}")
        kwargs = dict(c.init_params)
        if c.name == "DINOLoss" and "feature_fn" in shared_kwargs:
            kwargs.setdefault("feature_fn", shared_kwargs["feature_fn"])
        if "device" in shared_kwargs:
            kwargs.setdefault("device", shared_kwargs["device"])
        out.append((LOSS_REGISTRY[c.name](visualize_every_k=c.visualize_every_k, **kwargs), c.weight))
    return out
