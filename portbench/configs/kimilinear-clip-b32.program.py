"""The program's objects for ``kimilinear-clip-b32``: this card's share of Kimi Linear and the CLIP ViT-B/32 towers,
from the seed.

The subject is built from the configuration's HF keys, holding the routed
experts ``held_experts`` of ``num_experts_published`` (its router keeps all
of them), and its weights are drawn on the card one layer at a time
(``reference/kimi_linear.py``'s streams, in the served type) and placed
through the port's HF state-dict loader, which stacks each layer's held
experts: the share never exists in float32 (102 GB). The port's Kimi
Linear has no int8 path, so this configuration's control is the reference
in the program's place (``"control": "reference-int8"``) and
``control=True`` is refused.

The arithmetic of the cell's work lives here too: :func:`flops_per_image`
(a corpus sequence counts as one sample) and the KDA recurrence's least
work, :func:`kda_flops_per_token_head` and :func:`kda_bytes_per_token_head`.
"""

from __future__ import annotations

import types

import torch

from portbench.harness import flops
from portbench.reference import clip, kimi_linear, weights


def subject(cfg: dict, device, dtype):
    """The port's model of the configuration's HF keys, unplaced."""
    from semanticlens_tpu_torch.models import KimiLinear

    lin = cfg["linear_attn_config"]
    return KimiLinear(
        vocab_size=cfg["vocab_size"], n_positions=cfg["model_max_length"], width=cfg["hidden_size"],
        depth=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"], intermediate=cfg["intermediate_size"],
        moe_intermediate=cfg["moe_intermediate_size"], n_routed_experts=cfg["num_experts_published"],
        held_experts=kimi_linear.held(cfg), n_shared_experts=cfg["num_shared_experts"],
        experts_per_token=cfg["num_experts_per_token"], first_k_dense=cfg["first_k_dense_replace"],
        moe_layer_freq=cfg["moe_layer_freq"], kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=cfg["q_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], mla_use_nope=cfg["mla_use_nope"], norm_topk_prob=cfg["moe_renormalize"],
        routed_scaling_factor=cfg["routed_scaling_factor"], rope_theta=cfg["rope_theta"],
        rms_eps=cfg["rms_norm_eps"], tie_word_embeddings=cfg["tie_word_embeddings"], kda_heads=lin["num_heads"],
        kda_head_dim=lin["head_dim"], full_attn_layers=lin["full_attn_layers"],
        conv_size=lin["short_conv_kernel_size"], dtype=dtype, device=device)


def build(cfg: dict, seed: int, device, *, control: bool = False):
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.foundation_models.clip import CLIPConfig, TextCfg, VisionCfg

    if control:
        raise ValueError("kimilinear-clip-b32 has no int8 path of its own; its control is the reference in int8")
    dtype = getattr(torch, cfg["dtype"])
    model = subject(cfg, device, dtype)
    params = model.load_torch_state_dict(kimi_linear.draw_outer(cfg, seed, device, dtype), partial=True)
    for i in range(cfg["num_hidden_layers"]):
        params.update(model.load_torch_state_dict(kimi_linear.draw_layer(cfg, i, seed, device, dtype), partial=True))
    missing = {name for name, _, _ in model._param_specs()} - set(params)
    if missing:
        raise KeyError(f"the draw left out {sorted(missing)[:4]}")
    model.name = f"{cfg['name']}-subject"
    f = cfg["fm"]
    clip_cfg = CLIPConfig(embed_dim=f["embed_dim"], vision=VisionCfg(**f["vision"]), text=TextCfg(**f["text"]),
                          quick_gelu=f["quick_gelu"])
    fm = OpenClip(f["name"], params=weights.draw(clip.param_specs(f), seed, weights.STREAMS["fm"], device, dtype),
                  cfg=clip_cfg, quick_gelu=f["quick_gelu"], dtype=dtype, device=device)
    return types.SimpleNamespace(model=model, params=params, fm=fm)


def kda_flops_per_token_head(cfg: dict) -> int:
    """The recurrence's least work a token and head: 7·d² operations (the decay, Sᵀk, the rank-one update and Sᵀq
    over the d × d state)."""
    return 7 * cfg["linear_attn_config"]["head_dim"] ** 2


def kda_bytes_per_token_head(cfg: dict) -> int:
    """The recurrence's least traffic a token and head: q, k, v, g and o as bf16 elements and β, 2·(5·d + 1)."""
    return 2 * (5 * cfg["linear_attn_config"]["head_dim"] + 1)


def active_macs_per_token(cfg: dict, seq_len: int) -> float:
    """Multiply-accumulates of one token through this card's share, head included: the held experts at the
    expected k · held / published pairs a token, the KDA recurrence at 3.5·d² a head, MLA's causal logits and
    weighted values at ``seq_len`` / 2 keys."""
    w, lin = cfg["hidden_size"], cfg["linear_attn_config"]
    kh, kd, kw = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    kda = 3 * w * kh * kd + kw * 3 * kh * kd + 2 * (w * kd + kd * kh * kd) + w * kh + kh * kd * w + kh * 3.5 * kd**2
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    mla = w * h * (dn + dr) + w * (r + dr) + r * h * (dn + dv) + h * dv * w + h * seq_len / 2 * (dn + dr + dv)
    e_pub, inter = cfg["num_experts_published"], cfg["moe_intermediate_size"]
    pairs = cfg["num_experts_per_token"] * len(kimi_linear.held(cfg)) / e_pub
    moe = w * e_pub + (pairs + cfg["num_shared_experts"]) * 3 * w * inter
    total = 0.0
    for i in range(cfg["num_hidden_layers"]):
        total += mla if kimi_linear.is_mla(cfg, i) else kda
        total += moe if kimi_linear.is_moe(cfg, i) else 3 * w * cfg["intermediate_size"]
    return total + w * cfg["vocab_size"]


def clip_text_macs(cfg: dict) -> int:
    """One string through the CLIP text tower at its full context, and the projection."""
    t, w = cfg["fm"]["text"], cfg["fm"]["text"]["width"]
    n = t["context_length"]
    return t["layers"] * (12 * w * w * n + 2 * n * n * w) + w * cfg["fm"]["embed_dim"]


def flops_per_image(cfg: dict, seq_len: int = 2048) -> float:
    """FLOPs of one corpus sequence (the sweep's sample): the subject's forward over its tokens and the text tower
    over its string (≈ 10.2 TFLOP at 2,048 tokens)."""
    return flops.MAC * (active_macs_per_token(cfg, seq_len) * seq_len + clip_text_macs(cfg))
