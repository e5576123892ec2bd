"""The program's objects for ``dsv2lite-clip-b32``: DeepSeek-V2-Lite and the CLIP ViT-B/32 towers, from the seed.

The subject is built from the configuration's HF keys and its weights are
drawn on the card one layer at a time (``reference/deepseek_v2.py``'s
streams, in the served type) and placed through the port's HF state-dict
loader, which stacks each layer's experts: the whole model never exists in
float32 (63 GB). The port's DeepSeek-V2 has no int8 path, so this
configuration's control is the reference in the program's place
(``"control": "reference-int8"``) and ``control=True`` is refused.

The arithmetic of the cell's work lives here too: :func:`flops_per_image`
(a corpus sequence counts as one sample) and the routed experts' FLOPs and
bytes (:func:`expert_flops_per_pair`, :func:`expert_bytes`).
"""

from __future__ import annotations

import types

import torch

from portbench.harness import flops
from portbench.reference import clip, deepseek_v2, weights


def subject(cfg: dict, device, dtype):
    """The port's model of the configuration's HF keys, unplaced."""
    from semanticlens_tpu_torch.models import DeepseekV2

    return DeepseekV2(
        vocab_size=cfg["vocab_size"], n_positions=cfg["max_position_embeddings"], width=cfg["hidden_size"],
        depth=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"], intermediate=cfg["intermediate_size"],
        moe_intermediate=cfg["moe_intermediate_size"], n_routed_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"], experts_per_token=cfg["num_experts_per_tok"],
        first_k_dense=cfg["first_k_dense_replace"], moe_layer_freq=cfg["moe_layer_freq"],
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=cfg["q_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"], norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=cfg["routed_scaling_factor"], rope_theta=cfg["rope_theta"],
        rope_scaling=cfg["rope_scaling"], rms_eps=cfg["rms_norm_eps"], tie_word_embeddings=cfg["tie_word_embeddings"],
        dtype=dtype, device=device)


def build(cfg: dict, seed: int, device, *, control: bool = False):
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.foundation_models.clip import CLIPConfig, TextCfg, VisionCfg

    if control:
        raise ValueError("dsv2lite-clip-b32 has no int8 path of its own; its control is the reference in int8")
    dtype = getattr(torch, cfg["dtype"])
    model = subject(cfg, device, dtype)
    params = model.load_torch_state_dict(deepseek_v2.draw_outer(cfg, seed, device, dtype), partial=True)
    for i in range(cfg["num_hidden_layers"]):
        params.update(model.load_torch_state_dict(deepseek_v2.draw_layer(cfg, i, seed, device, dtype), partial=True))
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


def active_macs_per_token(cfg: dict) -> int:
    """Multiply-accumulates of one token's matmuls through the whole model, head included (≈ 2.45 G)."""
    w, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    attn = w * h * (dn + dr) + w * (r + dr) + r * h * (dn + dv) + h * dv * w
    inter, e_inter = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        total += attn
        if deepseek_v2.is_moe(cfg, i):
            experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
            total += w * cfg["n_routed_experts"] + experts * 3 * w * e_inter
        else:
            total += 3 * w * inter
    return total + w * cfg["vocab_size"]


def attention_macs_per_token(cfg: dict, seq_len: int) -> float:
    """The causal logits and weighted values of one token, over all layers: heads · T/2 · (qk + v head sizes)."""
    head = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return cfg["num_hidden_layers"] * cfg["num_attention_heads"] * seq_len / 2 * head


def clip_text_macs(cfg: dict) -> int:
    """One string through the CLIP text tower at its full context, and the projection."""
    t, w = cfg["fm"]["text"], cfg["fm"]["text"]["width"]
    n = t["context_length"]
    return t["layers"] * (12 * w * w * n + 2 * n * n * w) + w * cfg["fm"]["embed_dim"]


def flops_per_image(cfg: dict, seq_len: int = 512) -> float:
    """FLOPs of one corpus sequence (the sweep's sample): the subject's whole forward over its tokens and the
    text tower over its string (≈ 2.54 TFLOP at 512 tokens)."""
    per_token = active_macs_per_token(cfg) + attention_macs_per_token(cfg, seq_len)
    return flops.MAC * (per_token * seq_len + clip_text_macs(cfg))


def expert_flops_per_pair(cfg: dict) -> int:
    """One routed (token, expert) pair's SwiGLU: 2 · 3 · H · I FLOPs."""
    return flops.MAC * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def expert_bytes(cfg: dict, pairs: int, layer_calls: int) -> int:
    """Least bytes of the routed experts' work (bf16): every expert's three matrices read once a layer call,
    each pair's input row read once and its output row written once (the activations between the GEMMs are
    the work's own, not its inputs or outputs)."""
    w, inter = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 2 * cfg["n_routed_experts"] * 3 * w * inter * layer_calls + 2 * pairs * 2 * w
