"""Plain CLIP text tower (Radford et al., arXiv:2103.00020), open_clip's names, in float32.

Token embedding plus learned positions, residual blocks (LN → causal
multi-head attention with a packed in-projection → LN → MLP with OpenAI's
quick GELU), a final LayerNorm, the features at each row's end token (the
largest id, as open_clip's ``argmax``) and the projection to the
embedding. LayerNorm eps 1e-5. The weights are ``reference/clip.py``'s
``param_specs`` (both towers); this module reads the text tower's.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ops
from portbench.reference.clip import LN_EPS


def _causal_attention(q, k, v, heads: int):
    """``ops.attention`` with each position seeing itself and the positions before it."""
    b, t, d = q.shape
    hd = d // heads
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool, device=q.device), diagonal=1)
    probs = torch.softmax(logits.masked_fill(causal, -math.inf), dim=-1)
    return (probs @ v).transpose(1, 2).reshape(b, t, d)


def _block(p, prefix, x, heads, quant):
    h = ops.layer_norm(x, p[f"{prefix}.ln_1.weight"], p[f"{prefix}.ln_1.bias"], LN_EPS)
    q, k, v = ops.linear(h, p[f"{prefix}.attn.in_proj_weight"], p[f"{prefix}.attn.in_proj_bias"],
                         quant).chunk(3, dim=-1)
    a = _causal_attention(q, k, v, heads)
    x = x + ops.linear(a, p[f"{prefix}.attn.out_proj.weight"], p[f"{prefix}.attn.out_proj.bias"], quant)
    h = ops.layer_norm(x, p[f"{prefix}.ln_2.weight"], p[f"{prefix}.ln_2.bias"], LN_EPS)
    h = ops.quick_gelu(ops.linear(h, p[f"{prefix}.mlp.c_fc.weight"], p[f"{prefix}.mlp.c_fc.bias"], quant))
    return x + ops.linear(h, p[f"{prefix}.mlp.c_proj.weight"], p[f"{prefix}.mlp.c_proj.bias"], quant)


def encode_text(p: dict, tokens: torch.Tensor, cfg: dict, quant=None) -> torch.Tensor:
    """(B, context) int token rows → (B, embed_dim) float32."""
    t = cfg["text"]
    tokens = tokens.long()
    x = p["token_embedding.weight"][tokens] + p["positional_embedding"][: tokens.shape[1]]
    for i in range(t["layers"]):
        x = _block(p, f"transformer.resblocks.{i}", x, t["heads"], quant)
    x = ops.layer_norm(x, p["ln_final.weight"], p["ln_final.bias"], LN_EPS)
    pooled = x[torch.arange(tokens.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return pooled @ p["text_projection"]
