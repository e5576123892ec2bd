"""On-device image preprocessing: resize → center-crop → normalize.

Counterpart of ``semanticlens_tpu.ops.preprocess``. The JAX package resizes
with ``jax.image.resize(method="bicubic", antialias=True)``: the Keys cubic
kernel with a=-0.5, widened by the scale factor when downsampling. torch's
``F.interpolate(mode="bicubic")`` without antialias uses a=-0.75 and never
widens, so this module always passes ``antialias=True``, whose kernel is the
same a=-0.5 Keys cubic (the PIL convention) with the same widening and the
same renormalisation of edge weights. The two agree to float32 rounding in
both directions (tests/test_torch_ops.py states the tolerance).

Layouts follow the JAX package at the boundary — (B, H, W, C) in and out —
and the work runs in NCHW; the output is a channels_last NCHW tensor viewed
as NHWC, so a model that permutes it back gets cuDNN's preferred layout
without a copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# OpenAI CLIP normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# SigLIP normalization.
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_images(
    images: torch.Tensor,
    *,
    size: int = 224,
    crop: int = 224,
    mean=CLIP_MEAN,
    std=CLIP_STD,
    interpolation: str = "bicubic",
) -> torch.Tensor:
    """(B, H, W, C) uint8 (0–255) or float (0–1) → normalized (B, crop, crop, C) float32.

    torchvision's ``Resize(size) → CenterCrop(crop) → ToTensor → Normalize``:
    the shorter side goes to ``size`` keeping aspect, then the central
    ``crop×crop`` window is taken. Runs on the tensor's own device.
    """
    x = images.permute(0, 3, 1, 2).to(torch.float32)  # NCHW view, channels_last memory
    if images.dtype == torch.uint8:
        x = x / 255.0
    b, c, h, w = x.shape
    if h <= w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    if (new_h, new_w) != (h, w):
        if interpolation == "nearest":
            # JAX's nearest: source floor((i + 0.5) · in / out) in float32, the division by the
            # constant compiled as a product with its float32 reciprocal
            for dim, (n_in, n_out) in ((2, (h, new_h)), (3, (w, new_w))):
                inv = torch.tensor(1.0 / n_out, dtype=torch.float32)
                src = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in * inv
                x = x.index_select(dim, src.floor().long().to(x.device))
        elif interpolation in ("bicubic", "bilinear"):
            x = F.interpolate(x, size=(new_h, new_w), mode=interpolation, antialias=True,
                              align_corners=False)
        else:
            raise ValueError(f"interpolation must be 'bicubic', 'bilinear' or 'nearest', got {interpolation!r}")
        x = x.clamp(0.0, 1.0)
    top = (new_h - crop) // 2
    left = (new_w - crop) // 2
    x = x[:, :, top : top + crop, left : left + crop]
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, c, 1, 1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, c, 1, 1)
    x = (x - mean_t) / std_t
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
