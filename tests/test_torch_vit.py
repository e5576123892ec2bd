"""Port parity: the subject ViT (``models/vit.py``) against the JAX package's.

A cut-down ViT (32×32 images, 8×8 patches, width 32, 2 blocks, 2 heads) in
both namings. One set of numpy weights in the JAX layout goes to the JAX
model as it is and to the port through ``convert.vit_params_from_jax``; the
same numpy images go through both on the CPU in float32. Forward and taps
within atol 1e-5; LRP heatmaps on transformer taps within 1e-4 of the
largest relevance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.collect import RelevanceComponentVisualizer as JRCV
from semanticlens_tpu.data import ArrayDataset as JDS
from semanticlens_tpu.models.vit import VisionTransformer as JViT
from semanticlens_tpu.relevance import attribution as jattr
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.collect import RelevanceComponentVisualizer as TRCV
from semanticlens_tpu_torch.data import ArrayDataset as TDS
from semanticlens_tpu_torch.models import VisionTransformer as TViT
from semanticlens_tpu_torch.relevance import make_attribution_fn

torch.set_num_threads(2)

TINY = dict(image_size=32, patch_size=8, width=32, depth=2, heads=2, num_classes=4)
IMAGES = np.random.default_rng(1).random((12, 32, 32, 3)).astype(np.float32)


def _pair(naming, num_classes=4):
    kw = dict(TINY, num_classes=num_classes)
    tmodel = TViT(**kw, dtype=torch.float32, naming=naming, device="cpu")
    jmodel = JViT(**kw, dtype=jnp.float32, naming=naming)
    npp = tmodel.init_jax_layout(0)
    rng = np.random.default_rng(3)
    for name in npp:  # non-trivial norms and biases
        if npp[name].ndim == 1:
            npp[name] = npp[name] + rng.normal(scale=0.1, size=npp[name].shape).astype(np.float32)
    tmodel.params, tmodel.name = tmodel.load_jax_params(npp), f"vit-{naming}"
    jmodel.params, jmodel.name = {k: jnp.asarray(v) for k, v in npp.items()}, f"vit-{naming}"
    return jmodel, tmodel, npp


@pytest.mark.parametrize("naming,num_classes", [("timm", 4), ("torchvision", 4), ("timm", 0)])
def test_forward_and_every_tap_match_jax(naming, num_classes):
    jmodel, tmodel, _ = _pair(naming, num_classes)
    assert tmodel.module_names == jmodel.module_names
    assert repr(tmodel) == repr(jmodel)
    names = tuple(n for n in tmodel.module_names if n != "patch_embed")
    jout, jtaps = jmodel.apply(jmodel.params, jnp.asarray(IMAGES[:3]), names)
    tout, ttaps = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES[:3]), names)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    assert set(ttaps) == set(jtaps)
    for name in jtaps:
        assert ttaps[name].shape == jtaps[name].shape, name
        np.testing.assert_allclose(ttaps[name].numpy(), np.asarray(jtaps[name]), atol=1e-5, err_msg=name)
    heads = "blocks.1.attn.heads" if naming == "timm" else "encoder.layers.encoder_layer_1.self_attention.heads"
    assert ttaps[heads].shape == (3, 17, 2)  # (B, T, n_heads)
    # Requesting the per-head tap leaves the forward bit for bit as it was.
    plain, _ = tmodel.apply(tmodel.params, torch.from_numpy(IMAGES[:3]))
    assert torch.equal(plain, tout)


def test_from_name_and_torch_state_dicts_load_as_in_jax():
    """from_name builds the torchvision zoo; a torch state dict in either naming (torch layouts)
    loads to the same forward as the JAX package's load_torch_state_dict of it."""
    tv = TViT.from_name("vit_b_32", device="cpu")
    jv = JViT.from_name("vit_b_32")
    assert (tv.patch_size, tv.width, tv.depth, tv.heads, tv.naming) == (jv.patch_size, jv.width, jv.depth,
                                                                         jv.heads, jv.naming)
    with pytest.raises(ValueError):
        TViT.from_name("vit_q_99", device="cpu")
    for naming in ("timm", "torchvision"):
        jmodel, tmodel, npp = _pair(naming)
        state_dict = convert.vit_params_from_jax(npp)  # torch layouts, torch names
        jparams = jmodel.load_torch_state_dict(state_dict)
        tparams = tmodel.load_torch_state_dict(state_dict)
        ref, _ = jmodel.apply(jparams, jnp.asarray(IMAGES[:2]))
        ours, _ = tmodel.apply(tparams, torch.from_numpy(IMAGES[:2]))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        bad = dict(state_dict)
        key = tmodel._n("head.weight")
        bad[key] = bad[key].T
        with pytest.raises(ValueError):
            tmodel.load_torch_state_dict(bad)


@pytest.mark.parametrize("composite", ["epsilon_plus_flat", "epsilon", "gradient"])
def test_lrp_heatmaps_on_transformer_taps_match_jax(composite):
    """Patch-conv flat rule, LN, CP-LRP attention, GELU and the residual splits at model level."""
    jmodel, tmodel, _ = _pair("timm")
    x = IMAGES[:3]
    for layer, comp, agg in (("blocks.1.mlp.fc2", 3, "sum"), ("blocks.0.attn", 7, "max"), ("blocks.1", 1, "sum")):
        ref = np.asarray(jattr.make_attribution_fn(jmodel, layer, composite=composite, aggregation=agg,
                                                   abs_norm=False)(jmodel.params, jnp.asarray(x), jnp.int32(comp)))
        ours = make_attribution_fn(tmodel, layer, composite=composite, aggregation=agg, abs_norm=False)(
            tmodel.params, x, comp).numpy()
        assert ours.shape == (3, 32, 32) and np.isfinite(ours).all()
        np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max(), err_msg=layer)


def test_relevance_visualizer_on_vit_taps_matches_jax(tmp_path):
    """The relevance CV on a (B, T, D) tap: ids and crops equal to the JAX package's."""
    jmodel, tmodel, _ = _pair("torchvision")
    layer = "encoder.layers.encoder_layer_1.mlp.3"
    jcv = JRCV(jmodel, JDS(IMAGES, name="v12"), [layer], num_samples=3, storage_dir=str(tmp_path / "j"))
    tcv = TRCV(tmodel, TDS(IMAGES, name="v12"), [layer], num_samples=3, storage_dir=str(tmp_path / "t"))
    jcv.run(batch_size=4)
    tcv.run(batch_size=4)
    ids = tcv.get_act_max_sample_ids(layer)
    assert ids.shape == (32, 3)
    np.testing.assert_array_equal(ids, jcv.get_act_max_sample_ids(layer))
    ref = jcv.get_max_reference([0, 3], layer, n_ref=2, batch_size=4)
    ours = tcv.get_max_reference([0, 3], layer, n_ref=2, batch_size=4)
    for cid in (0, 3):
        assert len(ours[cid]) == len(ref[cid]) == 2
        for a, b in zip(ours[cid], ref[cid]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_vit_heatmaps_are_finite():
    tmodel = TViT(**TINY, dtype=torch.bfloat16, device="cpu")
    params = tmodel.init(seed=0)
    heat = make_attribution_fn(tmodel, "blocks.1.mlp.fc2")(params, IMAGES[:2], 5)
    assert heat.shape == (2, 32, 32) and torch.isfinite(heat).all() and heat.abs().sum() > 0
