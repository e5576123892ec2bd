"""Heatmap-driven rendering of concept examples (crops, masks, borders), without PIL.

Counterpart of ``semanticlens_tpu.utils.render``: Gaussian-blurred
relevance heatmaps select a square crop box and/or an opacity mask for each
concept example. The JAX package renders with numpy and PIL; the card has
no PIL, so this module reproduces what the JAX functions compute in torch,
on the heatmaps' device, with the blur batched over the images of a call:

- the blur is the separable Gaussian of ``np.convolve`` after numpy's
  ``reflect`` padding (repeated reflection, so a 51-tap kernel works on an
  image under 26 pixels a side, where torch's ``reflect`` pad refuses);
- crop boxes use the JAX package's integer arithmetic;
- :func:`imgify` returns a uint8 (H, W, 3) tensor where the JAX package
  returns a PIL image (same min–max scaling and truncation);
- :func:`mystroke` reproduces PIL's ``FIND_EDGES`` filter, its ellipse
  raster at ``size=1`` and ``Image.paste``'s alpha blend.

Layouts: images (H, W, C) in any range, heatmaps (H, W); the functions
return lists of uint8 (h, w, 3) tensors, on the images' device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(kernel_size: int) -> np.ndarray:
    """torchvision-compatible kernel: sigma = 0.3·((k−1)·0.5 − 1) + 0.8."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of numpy's ``np.pad(mode="reflect")`` for ``pad`` on both sides.

    numpy reflects as often as the pad needs (period 2(n−1), edge not
    repeated); a length-1 axis repeats its one value.
    """
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def gaussian_blur_2d(heatmap, kernel_size: int = 51) -> torch.Tensor:
    """Separable Gaussian blur with numpy ``reflect`` padding: (H, W) or (B, H, W) float32."""
    h = torch.as_tensor(heatmap).to(torch.float32)
    single = h.ndim == 2
    h = h[None, None] if single else h[:, None]
    k = torch.from_numpy(_gaussian_kernel1d(kernel_size)).to(h.device)
    pad = kernel_size // 2
    h = h.index_select(2, _reflect_index(h.shape[2], pad, h.device))
    h = F.conv2d(h, k.view(1, 1, -1, 1))
    h = h.index_select(3, _reflect_index(h.shape[3], pad, h.device))
    h = F.conv2d(h, k.view(1, 1, 1, -1))
    return h[0, 0] if single else h[:, 0]


def _box_from_any(rows: np.ndarray, cols: np.ndarray) -> tuple[int, int, int, int]:
    if not rows.any() or not cols.any():
        return 0, rows.shape[0], 0, cols.shape[0]
    row_idx = np.where(rows)[0]
    col_idx = np.where(cols)[0]
    return int(row_idx[0]), int(row_idx[-1]) + 1, int(col_idx[0]), int(col_idx[-1]) + 1


def get_crop_range(heatmap, crop_th: float):
    """Bounding box (row1, row2, col1, col2) of |heatmap| > crop_th.

    ``heatmap`` is expected normalized to max 1 (as the callers do); rows and
    columns whose peak stays below the threshold are cropped away.
    """
    mask = torch.abs(torch.as_tensor(heatmap)) > crop_th
    return _box_from_any(mask.any(dim=1).cpu().numpy(), mask.any(dim=0).cpu().numpy())


def _widen_span(lo: int, hi: int, target_len: int) -> tuple[int, int]:
    """Symmetrically widen the half-open span [lo, hi) toward ``target_len``.

    Each side grows by half the deficit, floor-divided, so an odd deficit
    leaves the span one pixel short (the JAX package's and the reference's
    arithmetic). A span pushed past index 0 slides forward; the far edge is
    left unclamped, and slicing clamps it.
    """
    grow = (target_len - (hi - lo)) // 2
    lo, hi = lo - grow, hi + grow
    if lo < 0:
        hi -= lo
        lo = 0
    return lo, hi


def _square_box(row1: int, row2: int, col1: int, col2: int):
    side = max(row2 - row1, col2 - col1)
    row1, row2 = _widen_span(row1, row2, side)
    col1, col2 = _widen_span(col1, col2, side)
    return row1, row2, col1, col2


def _get_square_crop_box(heatmap, crop_th: float):
    """Square crop box covering the relevant region: the thresholded
    bounding box, its shorter axis widened until (near-)square."""
    return _square_box(*get_crop_range(heatmap, crop_th))


def _square_crop_boxes(filtered: torch.Tensor, crop_th: float) -> list[tuple[int, int, int, int]]:
    """:func:`_get_square_crop_box` of each (H, W) map of a (B, H, W) batch, with one copy to the host."""
    mask = filtered > crop_th
    rows, cols = mask.any(dim=2).cpu().numpy(), mask.any(dim=1).cpu().numpy()
    return [_square_box(*_box_from_any(r, c)) for r, c in zip(rows, cols)]


def imgify(img) -> torch.Tensor:
    """(H, W, C) or (H, W) float/uint8 → uint8 (H, W, 3), floats min–max scaled to 0–255.

    As the JAX package's PIL conversion: floats scale by (x − min) /
    (max − min + 1e-12) · 255 in float32 and truncate; gray repeats to three
    channels, an alpha channel is dropped.
    """
    x = torch.as_tensor(img)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
        lo, hi = float(x.min()), float(x.max())
        x = ((x - lo) / (hi - lo + 1e-12) * 255.0).to(torch.uint8)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] == 1:
        return x.expand(-1, -1, 3)
    return x[:, :, :3]


def _filtered_heat(heatmaps: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """|blur(h)| / (max |blur(h)| + 1e-8) per (H, W) map of a (B, H, W) batch."""
    f = torch.abs(gaussian_blur_2d(heatmaps, kernel_size))
    return f / (torch.amax(f, dim=(1, 2), keepdim=True) + 1e-8)


def _validate(alpha, vis_th, crop_th):
    if alpha > 1 or alpha < 0:
        raise ValueError("'alpha' must be between [0, 1]")
    if vis_th >= 1 or vis_th < 0:
        raise ValueError("'vis_th' must be between [0, 1)")
    if crop_th >= 1 or crop_th < 0:
        raise ValueError("'crop_th' must be between [0, 1)")


def _image(data_batch, i) -> torch.Tensor:
    x = data_batch[i]
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _heat_batch(heatmaps, n: int) -> torch.Tensor:
    if isinstance(heatmaps, torch.Tensor):
        return heatmaps[:n].to(torch.float32)
    return torch.as_tensor(np.stack([np.asarray(heatmaps[i], np.float32) for i in range(n)]))


def crop_and_mask_images(
    data_batch, heatmaps, rf=False, alpha=0.4, vis_th=0.02, crop_th=0.01, kernel_size=51
):
    """Square-crop each image to its heatmap's relevant region.

    The default ``plot_fn`` for relevance-based concept examples. Returns a
    list of uint8 (h, w, 3) tensors (sizes vary), each a view of its image
    when the image is uint8 RGB.
    """
    _validate(alpha, vis_th, crop_th)
    n = len(data_batch)
    if n == 0:
        return []
    boxes = _square_crop_boxes(_filtered_heat(_heat_batch(heatmaps, n), kernel_size), crop_th)
    return [imgify(_image(data_batch, i)[r1:r2, c1:c2]) for i, (r1, r2, c1, c2) in enumerate(boxes)]


def _paste(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """PIL ``dst.paste(src, (0, 0), src)`` of two uint8 RGBA images: every band blends by src's alpha."""
    a = src[..., 3:].to(torch.int32)
    v = dst.to(torch.int32) * (255 - a) + src.to(torch.int32) * a + 128
    return ((v + (v >> 8)) >> 8).to(torch.uint8)  # PIL's DIV255


# PIL's ``ImageDraw.ellipse((x − 1, y − 1, x + 1, y + 1))`` raster: a plus.
_STROKE_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def mystroke(img, size: int = 1, color: str = "black") -> torch.Tensor:
    """Outline the alpha edge of a uint8 (H, W, 4) RGBA image with filled ellipses.

    PIL's ``FIND_EDGES`` (a 3×3 Laplacian, clipped to 0–255; border pixels
    and images under 3 pixels a side are copied) marks the edge where the
    filtered alpha is above 0; each edge pixel stamps an ellipse of radius
    ``size`` in (0, 0, 0, 180) (white: (255, 255, 255, 180)), and the image
    is pasted over the strokes by its own alpha. PIL's ellipse raster is
    reproduced at ``size=1``, the size the render functions use.
    """
    if size != 1:
        raise ValueError(f"mystroke reproduces PIL's ellipse raster at size=1 only, got size={size}")
    x = torch.as_tensor(img)
    a = x[..., 3].to(torch.int32)
    h, w = a.shape
    edge = a.clone()
    if h >= 3 and w >= 3:
        neighbours = sum(a[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0))
        edge[1:-1, 1:-1] = torch.clamp(8 * a[1:-1, 1:-1] - neighbours, 0, 255)
    on_edge = F.pad((edge > 0).to(torch.uint8), (1, 1, 1, 1))
    covered = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    for dy, dx in _STROKE_OFFSETS:
        covered |= on_edge[1 - dy : 1 - dy + h, 1 - dx : 1 - dx + w].bool()
    fill = torch.tensor((0, 0, 0, 180) if color == "black" else (255, 255, 255, 180),
                        dtype=torch.uint8, device=x.device)
    stroke = torch.where(covered[..., None], fill, torch.zeros_like(fill))
    return _paste(stroke, x)


def _masked_border(img, vis_mask):
    """``imgify(img)`` with the stroke of ``vis_mask``'s edge pasted on: uint8 (h, w, 3)."""
    rgb = imgify(img)
    alpha = (vis_mask.to(rgb.device, torch.uint8) * 255)[..., None]
    rgba = torch.cat([rgb, torch.full_like(alpha, 255)], dim=-1)
    stroked = mystroke(torch.cat([rgb, alpha], dim=-1), 1, color="black")
    return _paste(rgba, stroked)[..., :3]


def vis_lighten_img_border(
    data_batch, heatmaps, rf=False, alpha=0.4, vis_th=0.02, crop_th=0.01, kernel_size=51
):
    """Lighten low-relevance regions toward white and outline the relevant
    region; optionally crop (``rf``). Raises ``AssertionError`` when no
    pixel of the batch passed ``vis_th`` (the reference's contract)."""
    _validate(alpha, vis_th, crop_th)
    n = len(data_batch)
    imgs = []
    any_masked = False
    filtered = _filtered_heat(_heat_batch(heatmaps, n), kernel_size) if n else None
    boxes = _square_crop_boxes(filtered, crop_th) if rf and n else [None] * n
    for i in range(n):
        img = _image(data_batch, i).to(torch.float32)
        vis_mask = (filtered[i] > vis_th).to(img.device)
        if rf:
            row1, row2, col1, col2 = boxes[i]
            img_t = img[row1:row2, col1:col2]
            vis_mask_t = vis_mask[row1:row2, col1:col2]
            if img_t.sum() != 0 and vis_mask_t.sum() != 0:
                img, vis_mask = img_t, vis_mask_t
                any_masked = True
        if vis_mask.any():
            any_masked = True
        white = img.max() if img.numel() else torch.tensor(1.0)
        m = vis_mask[:, :, None].to(torch.float32)
        inv_m = (~vis_mask)[:, :, None].to(torch.float32)
        out = img * m + (img * (1 - alpha) + white * alpha) * inv_m
        imgs.append(_masked_border(out, vis_mask))
    if not any_masked:
        raise AssertionError(
            "every heatmap in the batch fell entirely below vis_th — no pixel "
            "survived masking. Lower vis_th or check that the heatmaps are "
            "non-degenerate."
        )
    return imgs


def vis_opaque_img_border(
    data_batch, heatmaps, rf=True, alpha=0.4, vis_th=0.02, crop_th=0.01, kernel_size=51
):
    """Attenuate low-relevance regions by ``alpha`` and outline the relevant
    region; crop to the receptive field if ``rf``."""
    _validate(alpha, vis_th, crop_th)
    n = len(data_batch)
    if n == 0:
        return []
    filtered = _filtered_heat(_heat_batch(heatmaps, n), kernel_size)
    boxes = _square_crop_boxes(filtered, crop_th) if rf else [None] * n
    imgs = []
    for i in range(n):
        img = _image(data_batch, i).to(torch.float32)
        vis_mask = (filtered[i] > vis_th).to(img.device)
        if rf:
            row1, row2, col1, col2 = boxes[i]
            img_t = img[row1:row2, col1:col2]
            vis_mask_t = vis_mask[row1:row2, col1:col2]
            if img_t.sum() != 0 and vis_mask_t.sum() != 0:
                img, vis_mask = img_t, vis_mask_t
        m = vis_mask[:, :, None].to(torch.float32)
        inv_m = (~vis_mask)[:, :, None].to(torch.float32)
        out = img * m + img * inv_m * alpha
        imgs.append(_masked_border(out, vis_mask))
    return imgs
