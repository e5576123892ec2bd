"""Port parity: the LM subjects (``models/gpt.py``, ``llama.py``, ``gemma.py``, ``phi.py``) against the JAX package's.

Each family at a small size (vocab 160, width 64, depth 2, 4 heads, kv
heads 2 or 1, 16 tokens): one set of numpy weights in the JAX layout
(norms and biases perturbed) goes to the JAX model as it is and to the
port through ``convert.lm_params_from_jax``; the same numpy tokens (one
row left-padded) go through both on the CPU in float32. Logits and every
tap in ``module_names`` within 1e-5 of each one's scale. Also: left-padded
rows against unpadded ones at their real positions, interventions on the
virtual heads tap, the HF state-dict loaders against the JAX loaders (on
state dicts of tiny ``transformers`` models), the zoo presets, and the
device draw of ``init``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu.models import GPT2 as JGPT2
from semanticlens_tpu.models import Gemma as JGemma
from semanticlens_tpu.models import Gemma2 as JGemma2
from semanticlens_tpu.models import Llama as JLlama
from semanticlens_tpu.models import Phi3 as JPhi3
from semanticlens_tpu.models import Qwen2 as JQwen2
from semanticlens_tpu.models.base import interventions as jinterventions
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models import GPT2, Gemma, Gemma2, Llama, Phi3, Qwen2, interventions

torch.set_num_threads(2)

V, T, PAD = 160, 16, 159
LLAMA3_ROPE = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0, original_max_position_embeddings=8)
# family → (JAX class, port class, constructor kwargs, an MLP tap, the last block's heads tap)
FAMILIES = {
    "gpt2": (JGPT2, GPT2, dict(width=64, depth=2, heads=4), "transformer.h.1.mlp.act", "transformer.h.1.attn.heads"),
    "llama": (JLlama, Llama, dict(width=64, depth=2, heads=4, kv_heads=2, rope_theta=5e5, rope_scaling=LLAMA3_ROPE,
                                  tie_word_embeddings=True),
              "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
    "llama-untied": (JLlama, Llama, dict(width=64, depth=2, heads=4, kv_heads=4, sliding_window=5),
                     "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
    "qwen2": (JQwen2, Qwen2, dict(width=64, depth=2, heads=4, kv_heads=1, tie_word_embeddings=True),
              "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
    "gemma": (JGemma, Gemma, dict(width=64, depth=2, heads=4, kv_heads=1, head_dim=32),
              "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
    "gemma2": (JGemma2, Gemma2, dict(width=64, depth=2, heads=4, kv_heads=2, head_dim=32, sliding_window=T // 2),
               "model.layers.1.mlp.act_fn", "model.layers.1.self_attn.heads"),
    "phi3": (JPhi3, Phi3, dict(width=64, depth=2, heads=4, kv_heads=2, intermediate=96),
             "model.layers.1.mlp.activation_fn", "model.layers.1.self_attn.heads"),
}


def tokens(n=3, seed=0):
    """(n, T) int32 ids below the pad id; row 1 left-padded with 5 pads, row 2 right-padded with 3."""
    toks = np.random.default_rng(seed).integers(0, PAD, size=(n, T)).astype(np.int32)
    toks[1, :5] = PAD
    if n > 2:
        toks[2, -3:] = PAD
    return toks


def lm_pair(family, pad_id=PAD, seed=0):
    """``(jax model, jax params, port model, port params, numpy params)`` on one set of weights."""
    jcls, tcls, kw, _, _ = FAMILIES[family]
    kw = dict(kw, vocab_size=V, n_positions=T)
    tmodel = tcls(**kw, dtype=torch.float32, pad_id=pad_id, device="cpu")
    jmodel = jcls(**kw, dtype=jnp.float32, pad_id=pad_id)
    npp = tmodel.init_jax_layout(seed)
    rng = np.random.default_rng(seed + 3)
    for name in npp:  # non-trivial norms and biases
        if npp[name].ndim == 1:
            npp[name] = npp[name] + rng.normal(scale=0.1, size=npp[name].shape).astype(np.float32)
    return jmodel, {k: jnp.asarray(v) for k, v in npp.items()}, tmodel, tmodel.load_jax_params(npp), npp


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("pad_id", [None, PAD], ids=["no-pad", "pad"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_and_every_tap_match_jax(family, pad_id):
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family, pad_id)
    assert tmodel.module_names == jmodel.module_names
    assert repr(tmodel) == repr(jmodel)
    toks = tokens()
    names = tmodel.module_names
    jout, jtaps = jmodel.apply(jparams, jnp.asarray(toks), names)
    tout, ttaps = tmodel.apply(tparams, torch.from_numpy(toks), names)
    assert rel_err(tout.numpy(), jout) <= 1e-5
    assert set(ttaps) == set(jtaps) == set(names)
    for name in names:
        assert tuple(ttaps[name].shape) == jtaps[name].shape, name
        assert rel_err(ttaps[name].numpy(), jtaps[name]) <= 1e-5, name


@pytest.mark.parametrize("family", ["gpt2", "llama", "gemma2", "phi3"])
def test_left_padded_rows_give_the_unpadded_activations(family):
    _, _, tmodel, tparams, _ = lm_pair(family)
    _, mlp, heads = FAMILIES[family][2:]
    row = tokens()[0]
    n_pad = 6
    padded = np.concatenate([np.full(n_pad, PAD, np.int32), row[: T - n_pad]])[None]
    unpadded = row[None, : T - n_pad]
    pout, ptaps = tmodel.apply(tparams, torch.from_numpy(padded), (mlp, heads))
    uout, utaps = tmodel.apply(tparams, torch.from_numpy(unpadded), (mlp, heads))
    assert rel_err(pout[:, n_pad:].numpy(), uout.numpy()) <= 1e-5
    for name in (mlp, heads):
        assert rel_err(ptaps[name][:, n_pad:].numpy(), utaps[name].numpy()) <= 1e-5, name


@pytest.mark.parametrize("family", ["gpt2", "llama", "gemma2"])
def test_head_interventions_are_causal_and_match_jax(family):
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family)
    heads = FAMILIES[family][4]
    toks = tokens()
    keep = np.array([1.0, 0.0, 1.0, 1.0], np.float32)  # zero-ablate head 1

    with jinterventions({heads: lambda v: v * jnp.asarray(keep, v.dtype)}):
        jout, jtaps = jmodel.apply(jparams, jnp.asarray(toks), (heads,))
    with interventions({heads: lambda v: v * torch.from_numpy(keep).to(v.dtype)}):
        tout, ttaps = tmodel.apply(tparams, torch.from_numpy(toks), (heads,))
    clean, _ = tmodel.apply(tparams, torch.from_numpy(toks))
    assert rel_err(tout.numpy(), jout) <= 1e-5
    assert float(ttaps[heads][..., 1].abs().max()) == 0.0
    assert float((tout - clean).abs().max()) > 1e-4  # removing a head moves the logits
    with interventions({heads: lambda v: v}):  # the identity rewrite goes through the rescale path
        same, _ = tmodel.apply(tparams, torch.from_numpy(toks))
    assert rel_err(same.numpy(), clean.numpy()) <= 1e-5


def test_zoo_presets_and_hf_names_equal_jax():
    for jcls, tcls in ((JGPT2, GPT2), (JLlama, Llama), (JQwen2, Qwen2), (JGemma, Gemma), (JGemma2, Gemma2),
                       (JPhi3, Phi3)):
        assert tcls._HF_VARIANTS == jcls._HF_VARIANTS, tcls.__name__
    gpt = GPT2.from_name("gpt2", device="cpu")
    assert gpt.module_names == JGPT2.from_name("gpt2").module_names
    llama = Llama.from_name("llama-3.2-1b", device="cpu")
    jllama = JLlama.from_name("llama-3.2-1b")
    assert llama.module_names == jllama.module_names and repr(llama) == repr(jllama)
    assert llama._param_specs() == jllama._param_specs()
    assert Gemma2.from_name("gemma-2-2b", device="cpu")._param_specs() == JGemma2.from_name("gemma-2-2b")._param_specs()
    assert Phi3.from_name("phi-3-mini-4k", device="cpu")._param_specs() == JPhi3.from_name("phi-3-mini-4k")._param_specs()
    with pytest.raises(ValueError, match="name must be one of"):
        Llama.from_name("llama-9", device="cpu")


def test_llama3_rope_scaling_matches_jax():
    from semanticlens_tpu.models.llama import _llama3_scaled_inv_freq as jscaled
    from semanticlens_tpu_torch.models.llama import _llama3_scaled_inv_freq as tscaled

    inv = 1.0 / (5e5 ** (np.arange(0, 64, 2, dtype=np.float32) / 64))
    got = tscaled(torch.from_numpy(inv), Llama._LLAMA3_ROPE).numpy()
    np.testing.assert_allclose(got, np.asarray(jscaled(jnp.asarray(inv), JLlama._LLAMA3_ROPE)), rtol=1e-6)


@pytest.mark.parametrize("family", ["gpt2", "llama", "gemma2"])
def test_init_draws_and_placement(family):
    _, tcls, kw, _, _ = FAMILIES[family]
    model = tcls(**kw, vocab_size=V, n_positions=T, dtype=torch.bfloat16, device="cpu")
    numpy_draw, device_draw = model.init(0), model.init(0, device_draw=True)
    assert set(numpy_draw) == set(device_draw)
    for name, value in numpy_draw.items():
        assert value.shape == device_draw[name].shape and value.dtype == device_draw[name].dtype, name
        assert value.dtype == (torch.bfloat16 if value.ndim == 2 else torch.float32), name
    assert all(torch.equal(value, numpy_draw[name]) for name, value in model.init(0).items())  # seeded
    out, _ = model.apply(device_draw, torch.from_numpy(tokens()))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="shape"):
        model.load_jax_params({k: np.zeros((1, 1), np.float32) for k in model.init_jax_layout(0)})
    with pytest.raises(ValueError, match="exceeds n_positions"):
        model.apply(numpy_draw, torch.zeros((1, T + 1), dtype=torch.int32))


def _hf_gpt2():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(vocab_size=V, n_positions=T, n_embd=64, n_layer=2, n_head=4)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval(), dict(width=64, depth=2, heads=4)


def _hf_llama():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(vocab_size=V, max_position_embeddings=T, hidden_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
                                   rms_norm_eps=1e-5, rope_theta=5e5, tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval(), dict(width=64, depth=2, heads=4, kv_heads=2, intermediate=96,
                                                           rms_eps=1e-5, rope_theta=5e5)


@pytest.mark.parametrize("make,jcls,tcls,kw", [(_hf_gpt2, JGPT2, GPT2, {}), (_hf_llama, JLlama, Llama, {})],
                         ids=["gpt2", "llama"])
def test_hf_state_dict_loaders_match_the_jax_loaders(make, jcls, tcls, kw):
    hf, arch = make()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    for name, value in sd.items():  # non-trivial norms and biases
        if value.ndim == 1:
            sd[name] = value + 0.1 * torch.randn(value.shape, generator=torch.Generator().manual_seed(1))
    jmodel = jcls(vocab_size=V, n_positions=T, **arch, dtype=jnp.float32)
    tmodel = tcls(vocab_size=V, n_positions=T, **arch, dtype=torch.float32, device="cpu")
    jparams = jmodel.load_torch_state_dict(sd)
    tparams = tmodel.load_torch_state_dict(sd)
    want = convert.lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    assert set(tparams) == set(want)
    for name in want:
        assert torch.equal(tparams[name], want[name]), name
    toks = tokens()
    jout, _ = jmodel.apply(jparams, jnp.asarray(toks))
    tout, _ = tmodel.apply(tparams, torch.from_numpy(toks))
    assert rel_err(tout.numpy(), jout) <= 1e-5
    hf.load_state_dict(sd)
    with torch.no_grad():
        assert rel_err(tout.numpy(), hf(torch.from_numpy(toks).long()).logits.numpy()) <= 1e-5
    if tcls is GPT2:  # bare GPT2Model keys load too
        bare = {k.removeprefix("transformer."): v for k, v in sd.items() if k != "lm_head.weight"}
        assert all(torch.equal(a, b) for a, b in zip(tmodel.load_torch_state_dict(bare).values(), tparams.values()))
    with pytest.raises(KeyError):
        tmodel.load_torch_state_dict({})
