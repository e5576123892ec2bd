"""Tensor parallelism at tp = 2 over two gloo ranks against the JAX package's GSPMD runs.

One spawned run on a (1, 2) ``("data", "model")`` mesh (``core.data_model_mesh``):

- the six placement functions of ``parallel.tensor_parallel`` on the port's
  own tensors — (out, in) weights, so the JAX package's column-parallel
  ``P(None, "model")`` is ``Shard(0)`` here and its row-parallel
  ``P("model", None)`` ``Shard(1)`` — naming exactly the JAX functions'
  parameters; a dimension the axis does not divide is replicated;
- GPT-2, Llama (GQA, 4 heads / 2 kv heads) and Gemma 2 tiny subjects
  collected through ``CollectEngine(mesh=…)`` with DTensor parameters,
  against the port's unsharded run (ids equal, top-k values equal) and the
  JAX package's GSPMD collect on a (2, 4) mesh of virtual CPU devices (the
  cases of JAX ``tests/test_parallel.py``: ids equal, values within its
  rtol 2e-2); Llama's logits and a tap within 1e-5 of the scale (float32,
  the row-parallel sums reorder);
- a CLIP tower's ``encode_image`` and ``encode_text`` with a sharded
  ``OpenClip`` against the unsharded tower and the JAX package's (1e-5);
  ``multi_head_attention``'s slices of a column-sharded fused ``in_proj``.

The attention core never receives a DTensor: the spawned ranks wrap
``F.scaled_dot_product_attention`` and count DTensor arguments (0).
"""

import json

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch.parallel import launch

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

CLIP_KW = dict(embed_dim=16)


def _jax_lm(family):
    import jax.numpy as jnp

    from semanticlens_tpu import models as jm

    kw = dict(vocab_size=61, n_positions=16, width=32, depth=2, heads=4, dtype=jnp.float32, pad_id=0)
    if family == "llama":
        return jm.Llama(kv_heads=2, intermediate=64, **kw)
    if family == "gemma2":
        return jm.Gemma2(kv_heads=2, head_dim=8, intermediate=64, sliding_window=5, **kw)
    return jm.GPT2(**kw)


def _clip_cfgs():
    from semanticlens_tpu.foundation_models import clip as jclip
    from semanticlens_tpu_torch.foundation_models import clip as tclip

    j = jclip.CLIPConfig(embed_dim=16, vision=jclip.VisionCfg(kind="vit", image_size=16, patch_size=8, width=64,
                                                              layers=2, heads=4),
                         text=jclip.TextCfg(context_length=12, vocab_size=64, width=64, heads=4, layers=2))
    t = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=64, layers=2, heads=4),
                         text=tclip.TextCfg(context_length=12, vocab_size=64, width=64, heads=4, layers=2))
    return j, t


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    from semanticlens_tpu_torch.foundation_models import clip as tclip

    out = tmp_path_factory.mktemp("mesh_tp")
    weights = {}
    for family in ranks.LM_LAYERS:
        npp = ranks._lm(family).init_jax_layout(0)
        rng = np.random.default_rng(1)
        for name in npp:  # non-trivial norms and biases
            if npp[name].ndim == 1:
                npp[name] = npp[name] + rng.normal(scale=0.1, size=npp[name].shape).astype(np.float32)
            weights[f"{family}/{name}"] = npp[name]
    _, tcfg = _clip_cfgs()
    weights |= {f"clip/{k}": v for k, v in tclip.init_clip_params_jax_layout(2, tcfg).items()}
    np.savez(out / "weights.npz", **weights)
    launch.spawn(ranks.tp_ranks, 2, out / "work", args=(str(out), str(out / "weights.npz")), timeout_s=150)
    return ([dict(np.load(out / f"tp{r}.npz")) for r in range(2)],
            [json.loads((out / f"tp{r}.json").read_text()) for r in range(2)], weights)


def _jax_specs(family, jmodel=None):
    from semanticlens_tpu import parallel as jp

    if family == "clip":
        return jp.clip_param_specs_2d(_clip_cfgs()[0])
    if family == "siglip":
        from semanticlens_tpu.foundation_models.siglip import SigLIPConfig

        return jp.siglip_param_specs_2d(SigLIPConfig(embed_dim=32, image_size=16, patch_size=8, vision_width=32,
                                                     vision_layers=1, vision_heads=2, text_width=32, text_layers=1,
                                                     text_heads=2, vocab_size=100, context_length=8))
    if family == "phi3":
        from semanticlens_tpu.models import Phi3

        import jax.numpy as jnp

        return jp.phi3_param_specs_2d(Phi3(vocab_size=61, n_positions=16, width=32, depth=2, heads=4, kv_heads=2,
                                           intermediate=48, dtype=jnp.float32))
    fn = jp.gpt2_param_specs_2d if family == "gpt2" else jp.llama_param_specs_2d
    return fn(_jax_lm(family))


@pytest.mark.parametrize("family", ["clip", "siglip", "llama", "gemma2", "gpt2", "phi3"])
def test_placement_functions_translate_the_jax_specs(tp2, family):
    _, (meta, _), _ = tp2
    jspecs = _jax_specs(family)
    assert meta["spec_names"][family] == sorted(jspecs)
    placed = meta["placements"][family]
    for name, spec in jspecs.items():
        if name not in placed:  # a name the model does not have (Qwen2's q/k/v biases on Llama)
            assert family in ("llama", "gemma2") and name.endswith(".bias"), name
            continue
        want = "Shard(dim=1)" if tuple(spec) == ("model", None) else "Shard(dim=0)"
        assert placed[name][0] == want, (name, placed[name])
    replicated = [n for n, p in placed.items() if n not in jspecs]
    assert replicated and all(placed[n][0] == "Replicate()" for n in replicated)


def test_column_and_row_shards_hold_half_of_the_port_layout(tp2):
    _, (meta, _), _ = tp2
    gpt2 = meta["placements"]["gpt2"]
    assert gpt2["transformer.h.0.attn.c_attn.weight"][1] == [48, 32]  # (3D, D) in torch's layout
    assert gpt2["transformer.h.0.mlp.c_proj.weight"][1] == [32, 64]  # (D, 4D): the input dim halves
    assert meta["placements"]["llama"]["model.layers.0.self_attn.k_proj.weight"][1] == [8, 32]
    assert meta["odd"] == {"a.weight": ["Replicate()", [5, 4]], "b.weight": ["Shard(dim=1)", [4, 3]],
                           "c": ["Replicate()", [3]]}


@pytest.mark.parametrize("family", list(ranks.LM_LAYERS))
def test_tp_subject_collect_matches_unsharded_and_jax_gspmd(tp2, family):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from semanticlens_tpu.collect.engine import CollectEngine
    from semanticlens_tpu.data.dataset import ArrayDataset
    from semanticlens_tpu.ops.aggregators import aggregate_transformer_mean
    from semanticlens_tpu.parallel import gpt2_param_specs_2d, llama_param_specs_2d, shard_params

    (got, _), (meta, _), weights = tp2
    assert meta["sdpa_calls"] > 0 and meta["sdpa_dtensor_args"] == 0
    assert meta["seconds"][family] < 60  # the Llama forward with heads split by rank finishes
    jmodel = _jax_lm(family)
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in weights.items() if k.startswith(f"{family}/")}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), axis_names=("data", "model"))
    spec_fn = gpt2_param_specs_2d if family == "gpt2" else llama_param_specs_2d
    eng = CollectEngine(model=jmodel, layer_names=ranks.LM_LAYERS[family], aggregation_fn=aggregate_transformer_mean,
                        n_collect=3, mesh=mesh, input_preprocess=lambda x: x)
    jstates, _ = eng.run(shard_params(params, mesh, spec_fn(jmodel)), ArrayDataset(ranks.TOKENS.astype(np.int32)), 4)
    for name in ranks.LM_LAYERS[family]:
        tp_ids, tp_vals = got[f"{family}/tp/{name}/ids"], got[f"{family}/tp/{name}/values"]
        np.testing.assert_array_equal(tp_ids, got[f"{family}/plain/{name}/ids"], err_msg=name)
        np.testing.assert_allclose(tp_vals, got[f"{family}/plain/{name}/values"], rtol=2**-7, err_msg=name)
        np.testing.assert_array_equal(tp_ids, np.asarray(jstates[name].ids), err_msg=name)
        np.testing.assert_allclose(tp_vals, np.asarray(jstates[name].values, np.float32), rtol=2e-2, atol=1e-4,
                                   err_msg=name)


def test_llama_tp_forward_equals_the_plain_forward(tp2):
    (got, _), _, _ = tp2
    for key in ("logits", "tap"):
        scale = np.abs(got[f"llama/{key}"]).max()
        assert np.abs(got[f"llama/{key}_tp"] - got[f"llama/{key}"]).max() <= 1e-5 * scale, key


def test_clip_tower_at_tp2_matches_unsharded_and_jax(tp2):
    import jax.numpy as jnp

    from semanticlens_tpu.foundation_models.clip import clip_encode_text, vit_encode_image

    (got, _), _, weights = tp2
    jcfg, _ = _clip_cfgs()
    params = {k[5:]: jnp.asarray(v) for k, v in weights.items() if k.startswith("clip/")}
    images = np.random.default_rng(7).normal(size=(3, 16, 16, 3)).astype(np.float32)
    tokens = np.random.default_rng(8).integers(0, 64, size=(2, 12))
    want = {"image": np.asarray(vit_encode_image(params, jcfg, jnp.asarray(images))),
            "text": np.asarray(clip_encode_text(params, jcfg, jnp.asarray(tokens)))}
    for key in ("image", "text"):
        scale = np.abs(want[key]).max()
        assert np.abs(got[f"clip/{key}_tp"] - got[f"clip/{key}"]).max() <= 1e-5 * scale, key
        assert np.abs(got[f"clip/{key}_tp"] - want[key]).max() <= 1e-5 * scale, key
    scale = np.abs(got["mha/plain"]).max()
    assert np.abs(got["mha/tp"] - got["mha/plain"]).max() <= 1e-5 * scale


def test_int8_tower_at_tp2_equals_the_unsharded_int8_tower(tp2):
    """``OpenClip(quantize="int8", mesh=…)``: quantized after the tensor sharding, every int8 weight a plain tensor,
    whole on each rank (the JAX package's replicated int8 leaves); the image embeddings equal the unsharded
    int8 tower's on both ranks."""
    (a0, a1), (meta, _), _ = tp2
    assert meta["int8_leaves_plain"] and set(meta["int8_leaves_plain"]) == {"Tensor"}
    for arrays in (a0, a1):
        np.testing.assert_allclose(arrays["clip/int8_image_tp"], arrays["clip/int8_image_plain"], rtol=0,
                                   atol=1e-5 * np.abs(arrays["clip/int8_image_plain"]).max())
