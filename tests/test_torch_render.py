"""Port parity: ``utils/render.py`` (no PIL) against the JAX package's numpy + PIL rendering.

The same numpy images and heatmaps go through both. Images must be equal
as uint8 arrays (the port returns tensors, the JAX package PIL images);
the blur agrees to float32 rounding (rtol 1e-5 of the map's peak) and the
crop boxes derived from it exactly.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from semanticlens_tpu.utils import render as jr
from semanticlens_tpu_torch.utils import render as tr

torch.set_num_threads(2)


def _batch(seed, h, w, uint8, n=3):
    rng = np.random.default_rng(seed)
    if uint8:
        imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    else:
        imgs = (rng.random((n, h, w, 3)) * 3 - 1).astype(np.float32)
    heat = rng.normal(size=(n, h, w)).astype(np.float32)
    heat[:, : h // 3] *= 0.01  # a quiet band, so the boxes are not the whole image
    heat[0, h // 2, w // 2] = 25.0  # one peak
    return imgs, heat


# (seed, height, width, uint8, kernel_size): the 51-tap default on images under 26 px a side
# reflects the padding more than once, which numpy does and torch's reflect pad refuses.
CASES = [(0, 32, 32, True, 51), (1, 17, 40, False, 51), (2, 9, 12, True, 51), (3, 64, 45, False, 11),
         (4, 5, 7, False, 5), (5, 1, 30, True, 51)]


@pytest.mark.parametrize("seed,h,w,uint8,kernel_size", CASES)
def test_blur_and_crop_boxes_match_jax(seed, h, w, uint8, kernel_size):
    _, heat = _batch(seed, h, w, uint8)
    batched = tr.gaussian_blur_2d(torch.from_numpy(heat), kernel_size)
    for i in range(len(heat)):
        ref = jr.gaussian_blur_2d(heat[i], kernel_size)
        ours = tr.gaussian_blur_2d(heat[i], kernel_size).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
        np.testing.assert_allclose(batched[i].numpy(), ours, rtol=0, atol=1e-5 * np.abs(ref).max())
        filt_ref = jr._filtered_heat(heat[i], kernel_size)
        filt = tr._filtered_heat(torch.from_numpy(heat[i : i + 1]), kernel_size)[0]
        for th in (0.01, 0.2, 0.6):
            assert tr._get_square_crop_box(filt, th) == jr._get_square_crop_box(filt_ref, th)
            assert tr.get_crop_range(filt, th) == jr.get_crop_range(filt_ref, th)


@pytest.mark.parametrize("seed,h,w,uint8,kernel_size", CASES)
@pytest.mark.parametrize("name", ["crop_and_mask_images", "vis_lighten_img_border", "vis_opaque_img_border"])
def test_render_functions_equal_jax(name, seed, h, w, uint8, kernel_size):
    imgs, heat = _batch(seed, h, w, uint8)
    for rf in (False, True):
        kwargs = dict(rf=rf, kernel_size=kernel_size, crop_th=0.2, vis_th=0.3, alpha=0.4)
        ref = getattr(jr, name)(imgs, heat, **kwargs)
        ours = getattr(tr, name)(torch.from_numpy(imgs), torch.from_numpy(heat), **kwargs)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert a.dtype == torch.uint8 and a.shape[-1] == 3
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} rf={rf}")
    lists = getattr(tr, name)(list(imgs), list(heat), rf=True, kernel_size=kernel_size)
    for a, b in zip(lists, getattr(jr, name)(imgs, heat, rf=True, kernel_size=kernel_size)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("color", ["black", "white"])
def test_mystroke_equals_pil(color):
    """FIND_EDGES, the size-1 ellipse raster and paste's alpha blend, on random RGBA images
    including ones under 3 pixels a side (PIL copies those unfiltered)."""
    rng = np.random.default_rng(11)
    for h, w in ((16, 16), (1, 1), (2, 5), (3, 3), (7, 19), (24, 9)):
        arr = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        arr[..., 3] = (rng.random((h, w)) > 0.5) * rng.integers(0, 256, (h, w))
        ref = np.asarray(jr.mystroke(Image.fromarray(arr, "RGBA"), 1, color=color))
        np.testing.assert_array_equal(tr.mystroke(torch.from_numpy(arr), 1, color=color).numpy(), ref)
    square = np.zeros((16, 16, 4), np.uint8)
    square[4:12, 4:12] = (255, 0, 0, 255)
    assert tr.mystroke(torch.from_numpy(square), 1).numpy()[3, 4, 3] > 0  # the stroke leaves the square
    with pytest.raises(ValueError):
        tr.mystroke(torch.from_numpy(square), 2)


def test_imgify_equals_pil_conversion():
    rng = np.random.default_rng(3)
    for arr in (np.linspace(-1, 1, 27).reshape(3, 3, 3).astype(np.float32),
                rng.random((5, 6)).astype(np.float32) * 7 - 2,
                rng.integers(0, 256, (4, 5, 3), dtype=np.uint8),
                rng.integers(0, 256, (4, 5), dtype=np.uint8)):
        ours = tr.imgify(torch.from_numpy(arr))
        assert ours.dtype == torch.uint8 and ours.shape == (*arr.shape[:2], 3)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jr.imgify(arr)))


@pytest.mark.parametrize("fn", [tr.crop_and_mask_images, tr.vis_lighten_img_border, tr.vis_opaque_img_border])
@pytest.mark.parametrize("kwargs", [{"alpha": 1.5}, {"vis_th": 1.0}, {"crop_th": -0.1}])
def test_parameter_validation(fn, kwargs):
    imgs, heat = _batch(0, 8, 8, True)
    with pytest.raises(ValueError):
        fn(imgs, heat, **kwargs)


def test_lighten_raises_when_nothing_masked_and_square_box_arithmetic():
    imgs, _ = _batch(0, 32, 32, False, n=2)
    with pytest.raises(AssertionError):
        tr.vis_lighten_img_border(imgs, np.zeros((2, 32, 32), np.float32), vis_th=0.5)
    heat = torch.zeros(40, 40)
    heat[0:3, 5:20] = 1.0
    assert tr._get_square_crop_box(heat, 0.5) == (0, 15, 5, 20)  # deficit 12: slides at 0
    heat = torch.zeros(40, 40)
    heat[10:15, 8:18] = 1.0
    assert tr._get_square_crop_box(heat, 0.5) == (8, 17, 8, 18)  # odd deficit: one short
    assert tr._get_square_crop_box(torch.zeros(16, 24), 0.5) == (0, 24, 0, 24)
