"""Dissect the foundation model itself: neuron → joint-embedding directions.

Counterpart of ``semanticlens_tpu.foundation_models.dissect``. A CLIP
tower's MLP neurons and attention heads write directly into the residual
stream, which maps (near-)linearly to the output embedding, so every hidden
unit has a direction in the joint image–text space that the Analyze
functions can search and label like a subject's components (the
direct-effect decomposition of Gandelsman et al., arXiv:2406.04341).

Linearization: the final LayerNorm's mean subtraction is applied exactly;
its input-dependent 1/std is dropped, so directions are defined up to a
positive per-input scale, to which cosine search and labelling are
invariant. Only the pooled token's stream reaches the output (CLS for the
ViT tower, EOT for the text tower).

The functions take the port's ``OpenClip.params`` (torch layout: linear
weights (out, in), where the JAX package reads ``c_proj.weight`` and
``out_proj.weight`` as (in, out)) and return float32 tensors on the
parameters' device, computed in float32 (the JAX package's ``highest``
precision; TF32 stays off)::

    dirs = mlp_neuron_directions(fm.params, fm.cfg, block=10)     # (4w, D)
    words, scores = label_components(fm, vocab, dirs, top_m=3)    # name them
"""

from __future__ import annotations

import torch


def _final_map(params, tower: str):
    """(ln scale, projection) of the tower's residual-stream → embedding map."""
    if tower == "visual":
        return params["visual.ln_post.weight"], params["visual.proj"]
    if tower == "text":
        return params["ln_final.weight"], params["text_projection"]
    raise ValueError(f"tower must be 'visual' or 'text', got {tower!r}")


def residual_directions_to_embedding(params, directions, *, tower: str = "visual") -> torch.Tensor:
    """Map (N, width) residual-stream write directions → (N, embed_dim) float32.

    Applies the final LayerNorm's exact mean subtraction and scale, then the
    output projection (see the module docstring for the linearization).
    """
    ln_w, proj = _final_map(params, tower)
    d = torch.as_tensor(directions, device=ln_w.device).float()
    if d.ndim != 2 or d.shape[1] != ln_w.shape[0]:
        raise ValueError(f"directions must be (N, {ln_w.shape[0]}) for this tower, got {tuple(d.shape)}")
    d = d - d.mean(dim=1, keepdim=True)  # LN mean subtraction (exact)
    return (d * ln_w.float()[None, :]) @ proj.float()


def _check_block(cfg, block: int, tower: str, fn: str):
    layers = cfg.vision.layers if tower == "visual" else cfg.text.layers
    if not isinstance(layers, int):
        raise ValueError(f"{fn} supports transformer towers only")
    if not 0 <= block < layers:
        raise ValueError(f"block {block} out of range for a {layers}-layer {tower} tower")


def mlp_neuron_directions(params, cfg, block: int, *, tower: str = "visual") -> torch.Tensor:
    """(mlp_hidden, embed_dim) direct-effect directions of one block's MLP.

    Hidden unit j of ``block``'s MLP writes column j of ``c_proj.weight``
    (torch layout; row j in the JAX package's) into the residual stream,
    scaled by its activation; this maps that write through the tower's
    final LN scale and projection. ``cfg`` is the FM's ``CLIPConfig``
    (bounds checking only).
    """
    _check_block(cfg, block, tower, "mlp_neuron_directions")
    prefix = "visual.transformer" if tower == "visual" else "transformer"
    w_out = params[f"{prefix}.resblocks.{block}.mlp.c_proj.weight"].t()  # (4w, w), (in, out)
    return residual_directions_to_embedding(params, w_out, tower=tower)


def attention_head_directions(params, cfg, block: int, *, tower: str = "visual") -> torch.Tensor:
    """(n_heads, head_dim, embed_dim) per-head value-path output directions.

    Head h of ``block`` writes ``out_proj`` applied to its value subspace:
    the head's slice of ``out_proj.weight``'s input dimension, mapped
    through the final LN scale and projection.
    """
    _check_block(cfg, block, tower, "attention_head_directions")
    heads = cfg.vision.heads if tower == "visual" else cfg.text.heads
    prefix = "visual.transformer" if tower == "visual" else "transformer"
    w_out = params[f"{prefix}.resblocks.{block}.attn.out_proj.weight"].t()  # (w, w), (in, out)
    width = w_out.shape[0]
    flat = residual_directions_to_embedding(params, w_out, tower=tower)  # (w, D)
    return flat.reshape(heads, width // heads, -1)


def resnet_attnpool_neuron_directions(params) -> torch.Tensor:
    """(C, embed_dim) direct-effect directions of the RN tower's final channels through the attention pool.

    CLIP's AttentionPool2d embeds ``c_proj(Σ_s p_s · v_proj(x_s))``: channel
    c writes input column c of ``v_proj.weight`` into every token's value,
    so its direct effect is that column through ``c_proj`` (scaled by the
    nonnegative attention mass, irrelevant to cosine analyses). No final LN
    exists on this tower. The head-sum of
    :func:`resnet_attnpool_neuron_head_directions`.
    """
    v = params["visual.attnpool.v_proj.weight"].float().t()  # (C, C), (in, out)
    c = params["visual.attnpool.c_proj.weight"].float().t()  # (C, D), (in, out)
    return v @ c


def resnet_attnpool_neuron_head_directions(params, *, head_dim: int = 64) -> torch.Tensor:
    """(C, n_heads, embed_dim) per-(channel, head) joint-space directions (arXiv:2509.19943).

    Channel c's value write is split across the attention heads: head h
    carries ``v_proj``'s output slice h·hd:(h+1)·hd through ``c_proj``'s
    matching input slice. Summing over heads gives
    :func:`resnet_attnpool_neuron_directions`. ``head_dim`` follows CLIP's
    AttentionPool2d (num_heads = C // 64).
    """
    v = params["visual.attnpool.v_proj.weight"].float().t()  # (C, C), (in, out)
    cw = params["visual.attnpool.c_proj.weight"].float().t()  # (C, D), (in, out)
    c_width = v.shape[1]
    if c_width % head_dim:
        raise ValueError(f"pooled width {c_width} not divisible by head_dim {head_dim}")
    heads = c_width // head_dim
    vh = v.reshape(v.shape[0], heads, head_dim)
    ch = cw.reshape(heads, head_dim, cw.shape[1])
    return torch.einsum("chd,hde->che", vh, ch)
