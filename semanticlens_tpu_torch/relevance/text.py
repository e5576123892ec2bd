"""Token-level LRP attributions for language-model components.

Counterpart of ``semanticlens_tpu.relevance.text``: how much each token of
an input drives an LM component (an MLP neuron, an attention head, an SAE
latent tap), so text evidence can be highlighted as image evidence is
cropped.

A token id has no gradient, so relevance is taken at the embedding layer
(Ali et al. 2022): a zero delta that requires grad is added at the
embedding tap through the ``interventions`` mechanism, the forward runs
under the composite (its rules are fixed as each op runs), and
``torch.autograd.grad`` pulls the component's relevance back to the delta.
The composite's backwards carry relevance directly, so the seed is the
component's own activation (for ``max``, at its peak token only) and a
token's relevance is the delta's gradient summed over features. Under the
ε composite the per-token sums conserve the target activation on paths
without biases and position embeddings.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from semanticlens_tpu_torch.models.base import interventions
from semanticlens_tpu_torch.models.layers import lrp_composite

# embedding-layer taps of the built-in LM families, tried in order
_KNOWN_EMBEDDING_TAPS = ("transformer.wte", "model.embed_tokens")


def make_token_relevance_fn(
    model,
    layer_name: str,
    *,
    embedding_tap: str | None = None,
    composite: str = "epsilon_plus_flat",
    aggregation: str = "sum",
    abs_norm: bool = True,
):
    """Build ``(params, tokens (B, T), component) → (B, T)`` float32 relevance.

    The target is the component's token-aggregated activation (``sum`` or
    ``max``); the result is the signed per-token relevance, optionally
    abs-max normalised per sequence, on the model's device.
    ``embedding_tap`` defaults to the model's own embedding module (GPT-2's
    ``transformer.wte``, Llama's ``model.embed_tokens``).
    """
    if embedding_tap is None:
        embedding_tap = next((t for t in _KNOWN_EMBEDDING_TAPS if model.has_module(t)), None)
        if embedding_tap is None:
            raise ValueError("no known embedding tap in model.module_names — pass "
                             "embedding_tap= for non-GPT/Llama naming conventions")
    elif not model.has_module(embedding_tap):
        raise ValueError(f"embedding tap '{embedding_tap}' not in model.module_names — "
                         "pass embedding_tap= for non-GPT naming conventions")

    def relevance(params, tokens, component):
        tokens = torch.as_tensor(tokens).to(model.device)
        component = int(component)
        with torch.no_grad():
            _, taps = model.apply(params, tokens, (embedding_tap,))
        delta = torch.zeros(taps[embedding_tap].shape, dtype=torch.float32, device=tokens.device,
                            requires_grad=True)

        def rewrite(v):
            return v + delta.to(v.dtype)

        rules = lrp_composite(composite) if composite != "gradient" else contextlib.nullcontext()
        with torch.inference_mode(False), torch.enable_grad():
            with rules, interventions({embedding_tap: rewrite}):
                _, inner = model.apply(params, tokens, (layer_name,))
            act = inner[layer_name].float()
            if act.ndim != 3:
                raise ValueError(f"{layer_name} must tap (B, T, C), got {tuple(act.shape)}")
            # seed = the component's own activation (relevance convention); "max"
            # seeds only the peak token position (crp's max_target)
            seed = torch.zeros_like(act)
            comp_act = act[..., component].detach()
            if aggregation == "max":
                peak = torch.argmax(comp_act, dim=1)
                rows = torch.arange(act.shape[0], device=act.device)
                seed[rows, peak, component] = comp_act[rows, peak]
            else:
                seed[..., component] = comp_act
            (r_emb,) = torch.autograd.grad(act, delta, seed)
        rel = torch.sum(r_emb.float(), dim=-1)  # (B, T)
        if abs_norm:
            rel = rel / (torch.amax(torch.abs(rel), dim=1, keepdim=True) + 1e-12)
        return rel

    return relevance


def token_relevance(model, params, tokens, layer_name, component, **kwargs):
    """One-shot wrapper around :func:`make_token_relevance_fn`."""
    return make_token_relevance_fn(model, layer_name, **kwargs)(params, tokens, component)


def highlight_evidence(token_strings, relevances, *, threshold: float = 0.5, marker: str = "**"):
    """Relevance-highlighted evidence strings (the text 'crop').

    ``token_strings``: per-sample lists of the tokens' surface strings (the
    caller detokenizes); tokens whose |relevance| ≥ ``threshold`` · max are
    wrapped in ``marker`` pairs. Returns one string per sample.
    """
    if isinstance(relevances, torch.Tensor):
        relevances = relevances.detach().cpu().numpy()
    out = []
    for strings, rel in zip(token_strings, np.asarray(relevances)):
        rel = np.abs(rel[: len(strings)])
        cut = threshold * (rel.max() + 1e-12)
        out.append(" ".join(f"{marker}{s}{marker}" if r >= cut else s for s, r in zip(strings, rel)))
    return out
