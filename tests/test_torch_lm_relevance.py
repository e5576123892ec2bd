"""Port parity: token relevance (``relevance/text.py``) and causal checks on token inputs against the JAX package's.

The tiny LM pairs of ``test_torch_lm_models.py`` (pad-aware, one row
left-padded) in float32 on the CPU. Token relevance of an MLP component,
normalised, within 2e-4 of the abs-max under ε-plus-flat (PR 8's heatmap
bound; GPT-2 reads up to 1.5e-4), ε and the plain gradient on the Llama
family (PR 8's 2e-2 tightened: they read up to 1.3e-5). GPT-2's plain-gradient
sums are LayerNorm-centred to ≈ 0 (its first op subtracts the mean of
each embedding), so its normalised map is noise in both packages: it is
compared unnormalised, within 1e-6. Heads taps, whose target is a norm
taken by autograd and whose ε rules see outputs near 0, within 2e-2
(float32 against float64 moves them by up to 1e-3 in either package;
ROADMAP queue 3). Conservation of the ε composite on a bias-free path.
``necessity_ratio`` on (B, T) tokens and (B, T, C) taps within 1e-5
relative (5e-5 for mean ablation, where float32 itself is 2e-5 from
float64), ``ablation_effects`` within 1e-5 of the logits' scale (a Δ is
the difference of two forwards, as PR 11's causal gate found);
``highlight_evidence`` equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import causal as jcausal
from semanticlens_tpu.relevance import highlight_evidence as j_highlight
from semanticlens_tpu.relevance.text import token_relevance as j_relevance
from semanticlens_tpu_torch import causal as tcausal
from semanticlens_tpu_torch.relevance import highlight_evidence, make_token_relevance_fn, token_relevance
from test_torch_lm_models import FAMILIES, lm_pair, rel_err, tokens

torch.set_num_threads(2)

BOUND = {"epsilon_plus_flat": 2e-4, "epsilon": 2e-4, "gradient": 2e-4}
CASES = [(f, c, a) for f in ("gpt2", "llama", "gemma2", "phi3") for c in BOUND for a in ("sum", "max")]


@pytest.mark.parametrize("family,composite,aggregation", CASES, ids=["-".join(c) for c in CASES])
def test_token_relevance_of_an_mlp_component_matches_jax(family, composite, aggregation):
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family)
    layer = FAMILIES[family][3]
    toks = tokens()
    norm = not (family == "gpt2" and composite == "gradient")
    kw = dict(composite=composite, aggregation=aggregation, abs_norm=norm)
    for comp in (1, 7):
        want = np.asarray(j_relevance(jmodel, jparams, jnp.asarray(toks), layer, comp, **kw))
        got = token_relevance(tmodel, tparams, torch.from_numpy(toks), layer, comp, **kw)
        assert got.shape == (3, 16) and got.dtype == torch.float32
        if norm:
            assert float(np.abs(got.numpy() - want).max()) <= BOUND[composite], comp
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("family", ["gpt2", "llama", "gemma2"])
def test_token_relevance_of_a_head_matches_jax_within_the_float32_bound(family):
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family)
    heads = FAMILIES[family][4]
    toks = tokens()
    for comp in range(4):
        want = np.asarray(j_relevance(jmodel, jparams, jnp.asarray(toks), heads, comp))
        got = token_relevance(tmodel, tparams, torch.from_numpy(toks), heads, comp).numpy()
        assert float(np.abs(got - want).max()) <= 2e-2


def test_epsilon_relevance_conserves_the_target_on_a_bias_free_path():
    """Llama has no biases or position embeddings: Σ_tokens R = the component's summed activation."""
    _, _, tmodel, tparams, _ = lm_pair("llama")
    layer = "model.layers.0.mlp.act_fn"
    toks = tokens()
    fn = make_token_relevance_fn(tmodel, layer, composite="epsilon", abs_norm=False)
    _, taps = tmodel.apply(tparams, torch.from_numpy(toks), (layer,))
    for comp in (0, 5):
        total = fn(tparams, toks, comp).sum(dim=1)
        target = taps[layer][..., comp].sum(dim=1)
        torch.testing.assert_close(total, target, rtol=2e-3, atol=2e-3)


def test_embedding_tap_resolution_and_refusals():
    from semanticlens_tpu_torch.models import ResNet

    _, _, tmodel, _, _ = lm_pair("gpt2")
    with pytest.raises(ValueError, match="not in model.module_names"):
        make_token_relevance_fn(tmodel, "transformer.h.1.mlp.act", embedding_tap="model.embed_tokens")
    with pytest.raises(ValueError, match="no known embedding tap"):
        make_token_relevance_fn(ResNet(depth=18, device="cpu"), "layer3")


def test_highlight_evidence_equals_jax():
    strings = [list("a red car"), list("rain")]
    rel = np.random.default_rng(0).normal(size=(2, 12)).astype(np.float32)
    for kw in ({}, {"threshold": 0.2, "marker": "_"}):
        assert highlight_evidence(strings, torch.from_numpy(rel), **kw) == j_highlight(strings, rel, **kw)


@pytest.mark.parametrize("family", ["gpt2", "llama", "gemma2", "phi3"])
@pytest.mark.parametrize("mode", ["zero", "mean"])
def test_necessity_and_ablation_on_tokens_match_jax(family, mode):
    jmodel, jparams, tmodel, tparams, _ = lm_pair(family)
    layer = FAMILIES[family][3]
    toks = tokens(6, seed=4)
    ev, ctl = toks[:3], toks[3:]
    comps = [0, 3, 9]
    want = np.asarray(jcausal.necessity_ratio(jmodel, jparams, layer, comps, jnp.asarray(ev), jnp.asarray(ctl),
                                              mode=mode))
    got = tcausal.necessity_ratio(tmodel, tparams, layer, comps, torch.from_numpy(ev), ctl, mode=mode)
    # mean ablation fills with a batch mean: float32 reads 2.0e-5 (port) / 1.4e-5 (JAX) from a float64
    # port run on GPT-2, so that mode is held at 5e-5 (ROADMAP queue 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5 if mode == "zero" else 5e-5)
    jd = np.asarray(jcausal.ablation_effects(jmodel, jparams, layer, jnp.asarray(ev), comps, mode=mode))
    td = tcausal.ablation_effects(tmodel, tparams, layer, ev, comps, mode=mode)
    assert td.shape == jd.shape == (3, 3, 16, 160)
    # a Δ is the difference of two forwards: its float32 error follows the logits, not |Δ| (ROADMAP queue 3)
    logits, _ = tmodel.apply(tparams, torch.from_numpy(ev))
    assert float(np.abs(td.numpy() - jd).max()) <= 1e-5 * float(logits.abs().max())
