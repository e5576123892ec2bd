"""Plain reference of the image preprocessing: antialiased bicubic resize, centre crop, normalization.

The resize is PIL's ``Image.resize(..., BICUBIC)`` written out as two
matrices, one per axis: Keys' cubic kernel with a = −0.5, widened by the
scale factor when downsampling (the antialias), each output pixel's weights
normalised to sum 1 (PIL's ``ImagingResample``). The shorter side goes to
``size`` keeping the aspect ratio (torchvision's ``Resize(size)``), values
are clamped to [0, 1] after a resize, then the central ``crop`` window is
taken and ``(x − mean) / std`` applied per channel.
"""

from __future__ import annotations

import torch


def _cubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) float64 weights of PIL's antialiased bicubic resize along one axis."""
    scale = n_in / n_out
    filter_scale = max(scale, 1.0)
    support = 2.0 * filter_scale
    weights = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        taps = [_cubic((j - center + 0.5) / filter_scale) for j in range(lo, hi)]
        total = sum(taps)
        for j, w in zip(range(lo, hi), taps):
            weights[i, j] = w / total
    return weights


def resized_shape(h: int, w: int, size: int) -> tuple[int, int]:
    """The shorter side to ``size``, the other by the same ratio, rounded."""
    if h <= w:
        return size, max(1, round(w * size / h))
    return max(1, round(h * size / w)), size


def preprocess(images: torch.Tensor, *, size: int, crop: int, mean, std) -> torch.Tensor:
    """(B, H, W, 3) uint8 → normalized (B, 3, crop, crop) float32 NCHW."""
    x = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    h, w = x.shape[2:]
    new_h, new_w = resized_shape(h, w, size)
    if (new_h, new_w) != (h, w):
        rows = resize_matrix(h, new_h).to(x.device, torch.float32)
        cols = resize_matrix(w, new_w).to(x.device, torch.float32)
        x = torch.einsum("oh,bchw,pw->bcop", rows, x, cols).clamp(0.0, 1.0)
    top, left = (new_h - crop) // 2, (new_w - crop) // 2
    x = x[:, :, top : top + crop, left : left + crop]
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std
