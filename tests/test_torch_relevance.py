"""Port parity: LRP attribution and the relevance visualizer against the JAX package.

One set of numpy weights goes to both packages (the port through
``convert.py``), and the same numpy images go through both on the CPU.

Heatmap tolerances, measured on ResNet-18 at 32×32 (6 weight seeds with
random BN statistics, layer2/3/4, 2 components, 4 images, abs-max
normalised): the largest difference from the JAX package was 5.2e-5 for
ε-plus-flat, 5.3e-3 for ε and 6.7e-3 for the plain gradient. The ε and
gradient gaps come from units whose pre-activation or ε denominator is
near 0, where the two libraries' float32 sums differ in the last bits and
a ReLU mask or a stabiliser tips the other way. The tests bound them by
2e-4 and 2e-2; the crop boxes derived from the heatmaps are held exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import Lens as JLens
from semanticlens_tpu.collect import RelevanceComponentVisualizer as JRCV
from semanticlens_tpu.data import ArrayDataset as JDS
from semanticlens_tpu.foundation_models.clip import _to_image_batch as j_to_image_batch
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu.ops.preprocess import preprocess_images as j_preprocess_images
from semanticlens_tpu.relevance import attribution as jattr
from semanticlens_tpu.utils import render as jrender
from semanticlens_tpu_torch import Lens as TLens
from semanticlens_tpu_torch.collect import RelevanceComponentVisualizer as TRCV
from semanticlens_tpu_torch.data import ArrayDataset as TDS
from semanticlens_tpu_torch.foundation_models import OpenClip
from semanticlens_tpu_torch.models import TorchSubjectModel
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.layers import conv2d
from semanticlens_tpu_torch.models.resnet import ResNet as TResNet
from semanticlens_tpu_torch.relevance import component_heatmaps, make_attribution_fn, make_batched_attribution_fn
from semanticlens_tpu_torch.utils import render as trender

torch.set_num_threads(2)

HEAT_ATOL = {"epsilon_plus_flat": 2e-4, "epsilon": 2e-2, "gradient": 2e-2}


def _resnet18_weights(seed):
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    npp = tmodel.init_jax_layout(seed)
    rng = np.random.default_rng(seed + 100)
    for name, arr in npp.items():
        if arr.ndim == 1 and name != "fc.bias":
            if name.endswith(("weight", "running_var")):
                npp[name] = rng.uniform(0.5, 1.5, arr.shape).astype(np.float32)
            else:
                npp[name] = rng.normal(scale=0.1, size=arr.shape).astype(np.float32)
    return npp


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model), both carrying the same weights and the name ``r18``."""
    npp = _resnet18_weights(0)
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    tmodel.params, tmodel.name = tmodel.load_jax_params(npp), "r18"
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.float32)
    jmodel.params, jmodel.name = {k: jnp.asarray(v) for k, v in npp.items()}, "r18"
    return jmodel, tmodel


IMAGES = np.random.default_rng(0).random((24, 32, 32, 3)).astype(np.float32)


def _boxes(render, filtered_fn, heat):
    return [render._get_square_crop_box(filtered_fn(h), 0.01) for h in heat]


@pytest.mark.parametrize("composite", ["epsilon_plus_flat", "epsilon", "gradient"])
def test_heatmaps_match_jax(pair, composite):
    """ResNet-18 at 32×32, layer2 and layer3, sum and max targets: within HEAT_ATOL; crop boxes equal."""
    jmodel, tmodel = pair
    x = IMAGES[:4]
    for layer, comp, agg in (("layer2", 5, "sum"), ("layer3", 17, "sum"), ("layer3", 2, "max")):
        ref = np.asarray(jattr.make_attribution_fn(jmodel, layer, composite=composite, aggregation=agg)(
            jmodel.params, jnp.asarray(x), jnp.int32(comp)))
        ours = make_attribution_fn(tmodel, layer, composite=composite, aggregation=agg)(tmodel.params, x, comp)
        assert ours.shape == (4, 32, 32) and ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, atol=HEAT_ATOL[composite], err_msg=f"{layer} {comp} {agg}")
        assert _boxes(trender, lambda h: trender._filtered_heat(h[None], 51)[0], ours) == \
            _boxes(jrender, lambda h: jrender._filtered_heat(h, 51), ref)
    one = component_heatmaps(tmodel, tmodel.params, x, "layer2", 5, composite=composite)
    np.testing.assert_array_equal(one.numpy(), make_attribution_fn(tmodel, "layer2", composite=composite)(
        tmodel.params, x, 5).numpy())


def test_heatmaps_of_a_bf16_model_match_jax():
    """bf16 ResNet-18 (the config-4 dtype), three composites: finite, and within 5e-2 of the
    JAX package's bf16 heatmaps (bf16 rounds each layer to 2^-8 relative)."""
    tmodel = TResNet(depth=18, num_classes=10, dtype=torch.bfloat16, device="cpu")
    npp = tmodel.init_jax_layout(0)
    tparams = tmodel.load_jax_params(npp)
    jmodel = JResNet(depth=18, num_classes=10, dtype=jnp.bfloat16)
    jparams = {k: jnp.asarray(v) for k, v in npp.items()}
    x = IMAGES[:2]
    for comp in ("gradient", "epsilon_plus_flat", "epsilon"):
        ref = np.asarray(jattr.make_attribution_fn(jmodel, "layer2", composite=comp)(
            jparams, jnp.asarray(x), jnp.int32(0)))
        ours = make_attribution_fn(tmodel, "layer2", composite=comp)(tparams, x, 0).numpy()
        assert ours.shape == (2, 32, 32) and np.isfinite(ours).all() and np.abs(ours).sum() > 0
        np.testing.assert_allclose(ours, ref, atol=5e-2, err_msg=comp)


def test_batched_heatmaps_equal_single_and_jax(pair):
    """K components over their own images in one backward == K single calls (rtol 1e-4, atol 1e-5),
    and == the JAX package's vmapped function within HEAT_ATOL."""
    jmodel, tmodel = pair
    imgs = np.stack([IMAGES[:3], IMAGES[3:6]])
    comps = np.asarray([1, 7], np.int32)
    got = make_batched_attribution_fn(tmodel, "layer2")(tmodel.params, imgs, comps)
    assert got.shape == (2, 3, 32, 32)
    single = make_attribution_fn(tmodel, "layer2")
    for k in range(2):
        np.testing.assert_allclose(got[k].numpy(), single(tmodel.params, imgs[k], comps[k]).numpy(),
                                   rtol=1e-4, atol=1e-5)
    ref = np.asarray(jattr.make_batched_attribution_fn(jmodel, "layer2")(
        jmodel.params, jnp.asarray(imgs), jnp.asarray(comps)))
    np.testing.assert_allclose(got.numpy(), ref, atol=HEAT_ATOL["epsilon_plus_flat"])


def test_uint8_images_cast_at_the_boundary(pair):
    _, tmodel = pair
    raw = (IMAGES[:2] * 255).astype(np.uint8)
    heat = make_attribution_fn(tmodel, "layer2")(tmodel.params, raw, 3)
    ref = make_attribution_fn(tmodel, "layer2")(tmodel.params, raw.astype(np.float32), 3)
    np.testing.assert_array_equal(heat.numpy(), ref.numpy())


def test_attribution_localizes_signal():
    """A conv channel keyed to a spatial quadrant attributes there (mirror of the JAX test)."""

    class OneConv(SubjectModel):
        module_names = ("c",)
        device = torch.device("cpu")

        def apply(self, params, x, tap_names=()):
            tap = TapCollector(tap_names)
            out = torch.relu(conv2d(x.permute(0, 3, 1, 2), params["w"])).permute(0, 2, 3, 1)  # NHWC tap
            return tap("c", out), tap.taps

    w = torch.zeros(2, 3, 1, 1)
    w[0, 0], w[1, 1] = 1.0, 1.0  # channel 0 = red detector, channel 1 = green detector
    img = np.zeros((1, 16, 16, 3), np.float32)
    img[0, 2:6, 2:6, 0] = 1.0
    img[0, 10:14, 10:14, 1] = 1.0
    fn = make_attribution_fn(OneConv(), "c")
    heat0, heat1 = fn({"w": w}, img, 0)[0].numpy(), fn({"w": w}, img, 1)[0].numpy()
    assert heat0[2:6, 2:6].sum() > 5 * abs(heat0[10:14, 10:14]).sum()
    assert heat1[10:14, 10:14].sum() > 5 * abs(heat1[2:6, 2:6]).sum()


# --------------------------------------------------------------------------- #
# The visualizer, against the JAX package's on the same data
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cvs(pair, tmp_path_factory):
    jmodel, tmodel = pair
    jcv = JRCV(jmodel, JDS(IMAGES, name="rand24"), ["layer2"], num_samples=4,
               storage_dir=str(tmp_path_factory.mktemp("jax")))
    tcv = TRCV(tmodel, TDS(IMAGES, name="rand24"), ["layer2"], num_samples=4,
               storage_dir=str(tmp_path_factory.mktemp("port")))
    jcv.run(batch_size=8)
    tcv.run(batch_size=8)
    return jcv, tcv


def test_run_ids_metadata_and_cache_layout_match_jax(cvs):
    jcv, tcv = cvs
    assert tcv.get_act_max_sample_ids("layer2").shape == (128, 4)
    np.testing.assert_array_equal(tcv.get_act_max_sample_ids("layer2"), jcv.get_act_max_sample_ids("layer2"))
    assert tcv.metadata == jcv.metadata
    assert tcv.storage_dir.relative_to(tcv._storage_dir) == jcv.storage_dir.relative_to(jcv._storage_dir)
    assert sorted(f.name for f in tcv.storage_dir.iterdir()) == sorted(f.name for f in jcv.storage_dir.iterdir())
    out = tcv.run(batch_size=8)  # second run: already preprocessed
    assert isinstance(out, list) and out


@pytest.mark.parametrize("batch_size", [3, 12])
def test_max_reference_crops_equal_jax_crops(cvs, batch_size):
    """Crops as uint8 arrays equal to the JAX package's PIL crops, one component per backward
    (batch_size 3) and four (batch_size 12)."""
    jcv, tcv = cvs
    cids = [0, 5, 9, 33, 127]
    ref = jcv.get_max_reference(cids, "layer2", n_ref=3, batch_size=batch_size)
    ours = tcv.get_max_reference(cids, "layer2", n_ref=3, batch_size=batch_size)
    assert set(ours) == set(ref) == set(cids)
    for cid in cids:
        assert len(ours[cid]) == len(ref[cid]) == 3
        for a, b in zip(ours[cid], ref[cid]):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(cid))


class _TinyFM:
    """Channel means of each crop as its embedding (the port's tensors)."""

    name = "t"
    device = torch.device("cpu")

    def preprocess(self, crops):
        return torch.stack([c.float().mean(dim=(0, 1)) for c in crops])

    def encode_image(self, x):
        return x


class _JTinyFM:
    """The same for the JAX package's PIL crops."""

    name = "t"

    def preprocess(self, pils):
        return jnp.asarray(np.stack([np.asarray(p, np.float32).mean(axis=(0, 1)) for p in pils]))

    def encode_image(self, x):
        return x


def test_concept_db_and_its_cache_match_jax(cvs):
    """The DB (components × n_ref × D) within 1e-4 of the JAX package's, through Lens with the
    same cache file name."""
    jcv, tcv = cvs
    ref = JLens(_JTinyFM()).compute_concept_db(jcv, batch_size=8, n_ref=3)
    ours = TLens(_TinyFM()).compute_concept_db(tcv, batch_size=8, n_ref=3)
    assert ours["layer2"].shape == (128, 3, 3)
    np.testing.assert_allclose(ours["layer2"], np.asarray(ref["layer2"]), atol=1e-4)
    jfiles = sorted(f.name for f in (jcv.storage_dir / "concept_database" / "t").iterdir())
    assert sorted(f.name for f in (tcv.storage_dir / "concept_database" / "t").iterdir()) == jfiles


def test_data_start_offsets_sample_ids(pair, tmp_path):
    """run(data_start > 0) stores full-dataset ids, equal to the JAX package's."""
    jmodel, tmodel = pair
    images = np.random.default_rng(3).random((20, 32, 32, 3)).astype(np.float32)
    images[10:] *= 3.0
    ids = []
    for cls, model, ds in ((TRCV, tmodel, TDS(images, name="offs20")), (JRCV, jmodel, JDS(images, name="offs20"))):
        cv = cls(model=model, dataset=ds, layer_names=["layer4"], num_samples=3, storage_dir=str(tmp_path / cls.__module__))
        cv.run(batch_size=4, data_start=10, data_end=20)
        ids.append(cv.get_act_max_sample_ids("layer4"))
    valid = ids[0][ids[0] >= 0]
    assert valid.min() >= 10 and valid.max() < 20
    np.testing.assert_array_equal(ids[0], ids[1])


def test_stale_cache_recomputes_and_checkpoint_dir_is_keyed_by_slice(pair, tmp_path):
    _, tmodel = pair
    ds = TDS(IMAGES[:8], name="d8")
    cv1 = TRCV(tmodel, ds, ["layer4"], num_samples=4, storage_dir=str(tmp_path))
    cv1.run(batch_size=4, data_start=0, data_end=8, checkpoint=4)
    assert not (cv1.storage_dir / "_checkpoint-0-8").exists()  # cleared after the stored cache
    cv2 = TRCV(tmodel, ds, ["layer4"], num_samples=2, storage_dir=str(tmp_path))
    assert not cv2._ran
    cv2.run(batch_size=4)
    assert cv2.get_act_max_sample_ids("layer4").shape == (512, 2)


def test_caches_load_across_packages_both_ways(pair, tmp_path):
    """A cache the JAX package wrote is the port's (no sweep), and the reverse."""
    jmodel, tmodel = pair
    for writer, wmodel, wds, reader, rmodel, rds in (
        (JRCV, jmodel, JDS(IMAGES, name="x24"), TRCV, tmodel, TDS(IMAGES, name="x24")),
        (TRCV, tmodel, TDS(IMAGES, name="y24"), JRCV, jmodel, JDS(IMAGES, name="y24")),
    ):
        written = writer(wmodel, wds, ["layer3"], num_samples=3, storage_dir=str(tmp_path))
        written.run(batch_size=8)
        loaded = reader(rmodel, rds, ["layer3"], num_samples=3, storage_dir=str(tmp_path))
        assert loaded._ran
        np.testing.assert_array_equal(loaded.get_act_max_sample_ids("layer3"), written.get_act_max_sample_ids("layer3"))


def test_dead_components_get_zero_rows(tmp_path):
    """Components with no collected sample have no crops and zero rows in the DB."""

    class TwoChan(SubjectModel):
        module_names = ("c",)
        device = torch.device("cpu")

        def apply(self, params, x, tap_names=()):
            tap = TapCollector(tap_names)
            out = conv2d(x.permute(0, 3, 1, 2), params["w"]).permute(0, 2, 3, 1)
            return tap("c", out), tap.taps

    model = TwoChan()
    w = torch.zeros(2, 3, 1, 1)
    w[0], w[1] = 1.0, -1.0  # channel 1 is always negative: dead
    model.params, model.name = {"w": w}, "twochan"
    ds = TDS(np.random.default_rng(5).random((8, 16, 16, 3)).astype(np.float32), name="p8")
    cv = TRCV(model, ds, ["c"], num_samples=3, storage_dir=str(tmp_path))
    cv.run(batch_size=4)
    assert cv.get_max_reference([1], "c", n_ref=3)[1] == []
    db = cv._compute_concept_db(_TinyFM(), batch_size=4, n_ref=3)
    assert db["c"].shape == (2, 3, 3)
    np.testing.assert_array_equal(db["c"][1], 0.0)
    assert np.abs(db["c"][0]).sum() > 0


def test_uint8_dataset_with_preprocess_matches_jax(pair, tmp_path):
    jmodel, tmodel = pair
    raw = np.random.default_rng(8).integers(0, 255, (8, 32, 32, 3), dtype=np.uint8)
    cvs = []
    for cls, model, ds, pre in (
        (TRCV, tmodel, TDS(raw, name="u8"), lambda x: x.to(torch.float32) / 255.0),
        (JRCV, jmodel, JDS(raw, name="u8"), lambda x: x.astype(jnp.float32) / 255.0),
    ):
        cv = cls(model=model, dataset=ds, layer_names=["layer4"], num_samples=2,
                 storage_dir=str(tmp_path / cls.__module__), preprocess_fn=pre)
        cv.run(batch_size=4)
        cvs.append(cv)
    ids = cvs[0].get_act_max_sample_ids("layer4")
    np.testing.assert_array_equal(ids, cvs[1].get_act_max_sample_ids("layer4"))
    alive = [int(c) for c in np.where((ids >= 0).any(axis=1))[0][:2]]
    refs = [cv.get_max_reference(alive, "layer4", n_ref=2) for cv in cvs]
    for cid in alive:
        assert refs[0][cid]
        for a, b in zip(refs[0][cid], refs[1][cid]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_subject_model_is_refused(tmp_path):
    model = TorchSubjectModel(torch.nn.Sequential(torch.nn.Conv2d(3, 2, 1)), device="cpu")
    model.params = {}
    with pytest.raises(TypeError, match="LRP"):
        TRCV(model, TDS(IMAGES[:4], name="d4"), ["0"], num_samples=2, storage_dir=str(tmp_path))


def test_openclip_preprocess_on_image_lists_matches_jax():
    """Same-size lists stack (atol 1e-5); mixed-size lists resize per image as PIL does
    (within one level: atol 0.016 after normalisation); host floats in 0–255 rescale; a
    normalized float batch is refused."""
    fm = OpenClip("ViT-B-32", dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    same = [rng.integers(0, 256, (50, 60, 3), dtype=np.uint8) for _ in range(3)]
    mixed = [rng.integers(0, 256, (int(rng.integers(20, 300)), int(rng.integers(20, 300)), 3), dtype=np.uint8)
             for _ in range(3)]
    floats = [rng.random((int(rng.integers(20, 100)), int(rng.integers(20, 100)), 3)).astype(np.float32)
              for _ in range(2)]
    for images, atol in ((same, 1e-5), (mixed, 0.016), (floats, 0.016), ([floats[0] * 255], 1e-5),
                         ([torch.from_numpy(m) for m in mixed], 0.016)):
        host = [np.asarray(i) for i in images]
        ref = np.asarray(j_preprocess_images(jnp.asarray(j_to_image_batch(host, 224)), size=224, crop=224))
        ours = fm.preprocess(images).numpy()
        assert ours.shape == ref.shape == (len(images), 224, 224, 3)
        np.testing.assert_allclose(ours, ref, atol=atol)
    with pytest.raises(ValueError, match="normalized"):
        fm.preprocess(rng.normal(size=(2, 8, 8, 3)).astype(np.float32) * 3)
    batch = torch.from_numpy(same[0])[None]
    np.testing.assert_array_equal(fm.preprocess(batch).numpy(), fm.preprocess(batch.numpy()).numpy())
