"""Port parity of the concept-example grids and the denormalization helpers.

Both packages collect with the same torch module as the subject (each its
own ``TorchSubjectModel``), so their top-k ids agree and the grids built
from them must be identical (``_make_grid``, ``_component_example_grid``).
``visualize_components`` in the port composes the figure as one uint8 array
and writes a PNG with its stdlib writer; the JAX package draws it with
matplotlib. The file names must agree, and the port's PNG must read back
(PIL, here) to the composed array. Titles are not drawn in the port.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

import jax.numpy as jnp

from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.collect.activation_based import _make_grid as j_make_grid
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.models import TorchSubjectModel as JAdapter
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu.utils import helper as jhelper
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer as TCV
from semanticlens_tpu_torch.collect.activation_based import _make_grid as t_make_grid
from semanticlens_tpu_torch.collect.activation_based import _to_uint8, write_png
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.models import TorchSubjectModel
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.utils import helper as thelper

torch.set_num_threads(2)

N_IMAGES, NUM_SAMPLES = 12, 4


def _module():
    torch.manual_seed(0)
    return nn.Sequential(nn.Conv2d(3, 6, 3, padding=1), nn.ReLU(), nn.Conv2d(6, 5, 3, stride=2)).eval()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz")
    images = np.random.default_rng(0).integers(0, 256, size=(N_IMAGES, 10, 14, 3), dtype=np.uint8)
    module = _module()
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            model, data, cls, agg = JAdapter(module, name="tiny"), JDataset(images, name="toy"), JCV, j_mean
        else:
            model, data, cls, agg = TorchSubjectModel(module, name="tiny", device="cpu"), TDataset(images, name="toy"), TCV, t_mean
        cv = cls(model=model, dataset_model=data, dataset_fm=data, layer_names=["1", "2"], num_samples=NUM_SAMPLES,
                 aggregate_fn=agg, cache_dir=str(root / pkg))
        cv.run(batch_size=5)
        out[pkg] = cv
    return out


@pytest.mark.parametrize("n, nrow, shapes", [(7, 3, None), (1, 3, None), (4, 2, None), (5, 3, "ragged"),
                                             (6, 4, "gray")])
def test_make_grid_equals_jax(n, nrow, shapes):
    rng = np.random.default_rng(n)
    if shapes == "ragged":
        imgs = [rng.integers(0, 256, (5 + i, 7 - i % 2, 3), dtype=np.uint8) for i in range(n)]
    elif shapes == "gray":
        imgs = [rng.random((4, 6)).astype(np.float32) for _ in range(n)]
    else:
        imgs = [rng.integers(0, 256, (6, 8, 3), dtype=np.uint8) for _ in range(n)]
    got, want = t_make_grid(imgs, nrow=nrow), j_make_grid(imgs, nrow=nrow)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("denorm", [None, "ours"], ids=["identity", "denormalized"])
def test_component_example_grid_equals_jax(both, denorm):
    jcv, tcv = both["jax"], both["torch"]
    for layer in ("1", "2"):
        np.testing.assert_array_equal(tcv.get_max_reference(layer), np.asarray(jcv.get_max_reference(layer)))
    post_j = jcv._resolve_denormalization(None if denorm is None else jhelper.get_denormalization_transform())
    post_t = tcv._resolve_denormalization(None if denorm is None else thelper.get_denormalization_transform())
    for layer, component in (("1", 0), ("1", 5), ("2", 3)):
        want = jcv._component_example_grid(component, layer, 3, 2, post_j)
        got = tcv._component_example_grid(component, layer, 3, 2, post_t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_visualize_components_png_path_and_contents(both):
    jcv, tcv = both["jax"], both["torch"]
    ids = [4, 0, 2, 1, 3]
    for fname in (None, "run"):
        want_path = jcv.visualize_components(ids, "2", n_samples=NUM_SAMPLES, nrows=2, fname=fname)
        got_path = tcv.visualize_components(ids, "2", n_samples=NUM_SAMPLES, nrows=2, fname=fname)
        assert got_path.relative_to(tcv._cache_root) == want_path.relative_to(jcv._cache_root)
        assert got_path.name == (f"{fname}_" if fname else "") + "2_4-0-2-1-3.png"
    # The figure: ceil(sqrt(5)) = 3 columns of panels, each panel the component's grid.
    panels = [tcv._component_example_grid(c, "2", NUM_SAMPLES, 2, lambda x: x) for c in ids]
    n_cols = math.isqrt(len(ids) - 1) + 1
    composed = t_make_grid(panels, nrow=n_cols)
    assert composed.shape == (2 * panels[0].shape[0], 3 * panels[0].shape[1], 3)
    np.testing.assert_array_equal(np.asarray(Image.open(got_path)), composed)


def test_visualize_components_float_panels_and_no_cache(both):
    """Denormalized (float) panels clip to [0, 1] and scale to uint8; without a cache root nothing is written."""
    tcv = both["torch"]
    denorm = thelper.get_denormalization_transform(mean=(0.1, 0.2, 0.3), std=(1 / 255, 1 / 255, 1 / 255))
    path = tcv.visualize_components([1, 2], "1", n_samples=2, nrows=2, denormalization_fn=denorm)
    panels = [tcv._component_example_grid(c, "1", 2, 2, denorm) for c in (1, 2)]
    composed = t_make_grid([_to_uint8(p) for p in panels], nrow=2)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), composed)
    uncached = TCV(model=tcv.model, dataset_model=tcv.dataset, dataset_fm=tcv.dataset, layer_names=["1"],
                   num_samples=NUM_SAMPLES, aggregate_fn=t_mean)
    uncached.actmax_cache = tcv.actmax_cache
    assert uncached.visualize_components([0], "1", fname="x") is None
    with pytest.raises(ValueError, match="not found"):
        tcv.visualize_components([0], "nope")


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (3, 4, 3), (2, 9, 4)])
def test_write_png_reads_back(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "x.png", img)
    back = np.asarray(Image.open(tmp_path / "x.png"))
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "y.png", img.astype(np.float32))


def test_denormalization_transform_matches_jax():
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 3)).astype(np.float32)
    want = jhelper.get_denormalization_transform(mean, std)(x)
    got = thelper.get_denormalization_transform(mean, std)
    np.testing.assert_array_equal(got(x), want)
    t = got(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), want, atol=1e-7)
    np.testing.assert_array_equal(thelper.get_denormalization_transform()(x[0]),
                                  jhelper.get_denormalization_transform()(x[0]))


@pytest.mark.parametrize("preset", [
    SimpleNamespace(resize_size=[40], crop_size=[32], mean=(0.5, 0.4, 0.3), std=(0.2, 0.3, 0.25),
                    interpolation="InterpolationMode.BILINEAR"),
    SimpleNamespace(resize_size=36, crop_size=30, interpolation="InterpolationMode.BICUBIC"),
    SimpleNamespace(resize_size=33, interpolation="InterpolationMode.NEAREST"),
    SimpleNamespace(interpolation="lanczos"),
], ids=["bilinear", "bicubic", "nearest", "fallback"])
def test_to_transforms_compose_matches_jax(preset):
    images = np.random.default_rng(1).integers(0, 256, size=(2, 48, 60, 3), dtype=np.uint8)
    want = np.asarray(jhelper.to_transforms_compose(preset)(jnp.asarray(images)))
    got = thelper.to_transforms_compose(preset)(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)
