"""Kimi Linear (``models/kimi_linear.py``, ``ops/kda.py``, ``ops/moe.py``'s sigmoid router and held experts)
against the plain float32 reference ``tests/plain/kimi_linear.py``.

A tiny model on the CPU in float32 with the published layer pattern cut
short: 8 layers, MLA at 1-based 4 and 8, KDA elsewhere (2 heads of 16,
convolutions of width 4), a dense first layer, 16 experts top-4 beside 1
shared, of which the model holds 8, width 64, vocabulary 160, seeded random
HF-named weights (the correction bias large enough to move the choice):
logits and every tap both compute, the plain KDA op against the
reference's token loop, the expert share (two halves and the shared expert
make the uncut layer), the sigmoid router's rule, DeepSeek-V2's router
unchanged, the held experts through dispatch, the grouped GEMMs, the
combine and the tap, the HF state dict's round trip, ``from_name`` against
the benchmark's configuration, the refusals, the untapped forward and the
text Collect+Embed path. On the card (``cuda``): the recurrence kernel
against its plain version, the combine's skip of absent experts, and the
model (with 128-wide KDA heads) against the CPU.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from plain import kimi_linear as plain
from semanticlens_tpu_torch import Lens
from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer, TokenTextDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import KimiLinear, TapCollector, interventions
from semanticlens_tpu_torch.models.layers import lrp_composite
from semanticlens_tpu_torch.ops import kda, moe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
V, T = 160, 12
HELD = range(0, 8)
# HF config.json keys of the tiny model (the reference reads these)
CFG = {"vocab_size": V, "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 8, "intermediate_size": 96,
       "moe_intermediate_size": 16, "num_experts": 16, "num_shared_experts": 1, "num_experts_per_token": 4,
       "first_k_dense_replace": 1, "moe_layer_freq": 1, "kv_lora_rank": 32, "q_lora_rank": None,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-5,
       "moe_renormalize": True, "routed_scaling_factor": 2.446, "mla_use_nope": True,
       "linear_attn_config": {"full_attn_layers": [4, 8], "head_dim": 16, "num_heads": 2,
                              "kda_layers": [1, 2, 3, 5, 6, 7], "short_conv_kernel_size": 4}}
# Kimi-Linear-48B-A3B-Instruct's config.json
# (https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct/blob/main/config.json)
PUBLISHED = {"first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu", "hidden_size": 2304,
             "intermediate_size": 9216, "kv_lora_rank": 512,
             "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
                                    "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23,
                                                   25, 26],
                                    "num_heads": 32, "short_conv_kernel_size": 4},
             "mla_use_nope": True, "model_max_length": 1048576, "model_type": "kimi_linear",
             "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
             "moe_router_activation_func": "sigmoid", "num_attention_heads": 32, "num_expert_group": 1,
             "num_experts": 256, "num_experts_per_token": 8, "num_hidden_layers": 27, "num_key_value_heads": 32,
             "num_nextn_predict_layers": 0, "num_shared_experts": 1, "q_lora_rank": None, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000,
             "routed_scaling_factor": 2.446, "tie_word_embeddings": False, "topk_group": 1, "use_grouped_topk": True,
             "v_head_dim": 128, "vocab_size": 163840}


def port_model(cfg=CFG, held=HELD, **kw):
    lin = cfg["linear_attn_config"]
    return KimiLinear(
        vocab_size=cfg["vocab_size"], n_positions=64, width=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], intermediate=cfg["intermediate_size"],
        moe_intermediate=cfg["moe_intermediate_size"], n_routed_experts=cfg["num_experts"],
        n_shared_experts=cfg["num_shared_experts"], experts_per_token=cfg["num_experts_per_token"],
        first_k_dense=cfg["first_k_dense_replace"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], rms_eps=cfg["rms_norm_eps"], routed_scaling_factor=cfg["routed_scaling_factor"],
        kda_heads=lin["num_heads"], kda_head_dim=lin["head_dim"], full_attn_layers=lin["full_attn_layers"],
        conv_size=lin["short_conv_kernel_size"], held_experts=held, dtype=torch.float32, device="cpu", **kw)


def hf_weights(cfg=CFG, seed=0) -> dict[str, torch.Tensor]:
    """An HF-named float32 state dict of every expert: matrices N(0, 1/fan_in), embeddings N(0, 1), norm scales
    1 + 0.1·N(0, 1); KDA's A_log 1 + 0.5·N, dt_bias −3 + N, the gate's bias N; the router's correction bias
    0.05·N (about the gaps between the sigmoid scores, so that it moves the choice)."""
    gen = torch.Generator().manual_seed(seed)
    w, h = cfg["hidden_size"], cfg["num_attention_heads"]
    lin = cfg["linear_attn_config"]
    kh, kd = lin["num_heads"], lin["head_dim"]
    e, inter = cfg["num_experts"], cfg["moe_intermediate_size"]
    dn, dr, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    shapes = {"model.embed_tokens.weight": (V, w), "model.norm.weight": (w,), "lm_head.weight": (V, w)}
    special = {}
    for i in range(cfg["num_hidden_layers"]):
        p, a = f"model.layers.{i}", f"model.layers.{i}.self_attn"
        shapes.update({f"{p}.input_layernorm.weight": (w,), f"{p}.post_attention_layernorm.weight": (w,)})
        if plain.is_mla(cfg, i):
            shapes.update({f"{a}.q_proj.weight": (h * (dn + dr), w), f"{a}.kv_a_proj_with_mqa.weight": (r + dr, w),
                           f"{a}.kv_a_layernorm.weight": (r,), f"{a}.kv_b_proj.weight": (h * (dn + dv), r),
                           f"{a}.o_proj.weight": (w, h * dv)})
        else:
            for n in "qkv":
                shapes[f"{a}.{n}_proj.weight"] = (kh * kd, w)
                shapes[f"{a}.{n}_conv1d.weight"] = (kh * kd, 1, lin["short_conv_kernel_size"])
            shapes.update({f"{a}.f_a_proj.weight": (kd, w), f"{a}.f_b_proj.weight": (kh * kd, kd),
                           f"{a}.b_proj.weight": (kh, w), f"{a}.g_a_proj.weight": (kd, w),
                           f"{a}.g_b_proj.weight": (kh * kd, kd), f"{a}.o_norm.weight": (kd,),
                           f"{a}.o_proj.weight": (w, kh * kd)})
            special.update({f"{a}.A_log": ((kh,), 1.0, 0.5), f"{a}.dt_bias": ((kh * kd,), -3.0, 1.0),
                            f"{a}.g_b_proj.bias": ((kh * kd,), 0.0, 1.0)})
        mlps = [(f"{p}.mlp", cfg["intermediate_size"])] if not plain.is_moe(cfg, i) else (
            [(f"{p}.mlp.experts.{j}", inter) for j in range(e)]
            + [(f"{p}.mlp.shared_experts", inter * cfg["num_shared_experts"])])
        if plain.is_moe(cfg, i):
            shapes[f"{p}.mlp.gate.weight"] = (e, w)
            special[f"{p}.mlp.gate.e_score_correction_bias"] = ((e,), 0.0, 0.05)
        for m, width in mlps:
            shapes.update({f"{m}.gate_proj.weight": (width, w), f"{m}.up_proj.weight": (width, w),
                           f"{m}.down_proj.weight": (w, width)})
    out = {}
    for name, shape in shapes.items():
        z = torch.randn(shape, generator=gen)
        if len(shape) == 1:
            out[name] = 1.0 + 0.1 * z
        elif len(shape) == 3:  # a convolution: fan-in is its width
            out[name] = z * shape[-1] ** -0.5
        else:
            out[name] = z if "embed" in name else z * shape[1] ** -0.5
    for name, (shape, mean, std) in special.items():
        out[name] = mean + std * torch.randn(shape, generator=gen)
    return out


def tokens(n=3, t=T, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, V, size=(n, t)).astype(np.int32))


@pytest.fixture(scope="module")
def pair():
    """(port model, port params, HF state dict, tokens, reference (logits, taps, chosen))."""
    model = port_model()
    sd = hf_weights()
    params = model.load_torch_state_dict(sd)
    toks = tokens()
    with torch.no_grad():
        want = plain.forward(sd, toks, CFG, HELD)
    return model, params, sd, toks, want


def scale_err(got, want) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def test_layer_pattern_follows_the_config():
    model = port_model()
    assert [i for i in range(8) if model.is_mla(i)] == [3, 7]
    assert [i for i in range(8) if model.is_moe(i)] == list(range(1, 8))
    assert "model.layers.2.self_attn.o_norm" in model.module_names
    assert "model.layers.3.self_attn.kv_b_proj" in model.module_names
    assert "model.layers.2.self_attn.kv_b_proj" not in model.module_names


def test_logits_and_every_tap_match_the_reference(pair):
    model, params, _, toks, (logits, ref_taps, _) = pair
    with torch.no_grad():
        got_logits, taps = model.apply(params, toks, model.module_names)
    # float32 on both sides, other summation orders (the recurrence, the convolutions): 1e-5 of each tensor's scale
    assert scale_err(got_logits, logits) < 1e-5
    shared = sorted(set(taps) & set(ref_taps))
    must = {f"model.layers.2.self_attn.{n}" for n in ("q_proj", "k_conv1d", "v_conv1d", "o_norm", "o_proj")} | {
        "model.layers.0.mlp.act_fn", "model.layers.3.self_attn", "model.layers.5.mlp.gate",
        "model.layers.5.mlp.experts.act_fn", "model.layers.5.mlp.experts", "model.layers.6.mlp.shared_experts.act_fn",
        "model.layers.7", "model.layers.6.self_attn"}
    assert must <= set(shared)
    for name in shared:
        assert taps[name].shape == ref_taps[name].shape, name
        assert scale_err(taps[name], ref_taps[name]) < 1e-5, name


def test_the_held_experts_tap_and_the_choice(pair):
    model, params, _, toks, (_, ref_taps, chosen) = pair
    names = [f"model.layers.{i}.mlp.experts.act_fn" for i in (1, 6)]
    with torch.no_grad():
        _, taps = model.apply(params, toks, names)
    for i, name in zip((1, 6), names):
        tap = taps[name].view(*toks.shape, len(HELD), CFG["moe_intermediate_size"])
        routed = tap.ne(0).any(dim=-1)
        want = torch.zeros(*toks.shape, CFG["num_experts"], dtype=torch.bool).scatter_(-1, chosen[i].long(), True)
        assert torch.equal(routed, want[..., HELD.start : HELD.stop])  # the held experts the router chose
        assert 0 < int(routed.sum()) < toks.numel() * CFG["num_experts_per_token"]  # some pairs went elsewhere


def test_untapped_forward_equals_the_tapped_one(pair):
    model, params, _, toks, _ = pair
    with torch.no_grad():
        plain_logits, taps = model.apply(params, toks)
        tapped, _ = model.apply(params, toks, ["model.layers.2.self_attn.o_norm", "model.layers.5.mlp.experts.act_fn"])
    assert taps == {} and torch.equal(plain_logits, tapped)


@pytest.mark.parametrize("b, t, h, d", [(2, 37, 3, 16), (1, 19, 1, 8), (3, 5, 2, 4)])
def test_plain_kda_op_matches_the_token_loop(b, t, h, d):
    gen = torch.Generator().manual_seed(b * 100 + t)
    q = plain.l2norm(torch.randn(b, t, h, d, generator=gen)) * d**-0.5
    k = plain.l2norm(torch.randn(b, t, h, d, generator=gen))
    v = torch.randn(b, t, h, d, generator=gen)
    g = -torch.rand(b, t, h, d, generator=gen) * 0.5  # decays in (0.6, 1]
    beta = torch.rand(b, t, h, generator=gen)
    want = plain.recurrence(q, k, v, g, beta)
    got = kda.recurrence(q, k, v, g, beta)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # float32, einsum orders
    # causal and per sequence: a later token or another sequence changes nothing before it
    v2 = v.clone()
    v2[0, t // 2 :] += 1.0
    again = kda.recurrence(q, k, v2, g, beta)
    assert torch.equal(again[0, : t // 2], got[0, : t // 2]) and torch.equal(again[1:], got[1:])


def test_no_decay_and_a_reset_state_differ_from_the_recurrence():
    gen = torch.Generator().manual_seed(9)
    b, t, h, d = 1, 70, 1, 8
    q, k = plain.l2norm(torch.randn(b, t, h, d, generator=gen)), plain.l2norm(torch.randn(b, t, h, d, generator=gen))
    v, beta = torch.randn(b, t, h, d, generator=gen), torch.full((b, t, h), 0.5)
    g = torch.full((b, t, h, d), -0.05)
    full = kda.recurrence(q, k, v, g, beta)
    assert not torch.allclose(kda.recurrence(q, k, v, torch.zeros_like(g), beta), full, atol=1e-3)
    split = torch.cat([kda.recurrence(q[:, :64], k[:, :64], v[:, :64], g[:, :64], beta[:, :64]),
                       kda.recurrence(q[:, 64:], k[:, 64:], v[:, 64:], g[:, 64:], beta[:, 64:])], dim=1)
    assert torch.equal(split[:, :64], full[:, :64]) and not torch.allclose(split[:, 64:], full[:, 64:], atol=1e-3)


def test_the_expert_share_adds_up_to_the_uncut_layer(pair):
    _, _, sd, toks, _ = pair
    full = port_model(held=range(16))
    halves = [port_model(held=range(0, 8)), port_model(held=range(8, 16))]
    x = torch.randn(*toks.shape, CFG["hidden_size"], generator=torch.Generator().manual_seed(4))
    p = "model.layers.5"
    names = [f"{p}.mlp.shared_experts.down_proj"]  # the shared expert's output
    with torch.no_grad():
        parts = []
        for model in halves:
            tap = TapCollector(names)
            parts.append((model._moe(tap, model.load_torch_state_dict(sd), p, x, 5), tap.taps[names[0]]))
        shared = parts[0][1]
        assert torch.equal(shared, parts[1][1])  # every device computes the shared expert alike
        tap = TapCollector([])
        whole = full._moe(tap, full.load_torch_state_dict(sd), p, x, 5)
        ref_routed, _ = plain.routed(sd, f"{p}.mlp", x.reshape(-1, CFG["hidden_size"]), CFG, range(16))
        ref = ref_routed.view_as(x) + plain.mlp(sd, f"{p}.mlp.shared_experts", x, {})
    summed = parts[0][0] + parts[1][0] - shared  # the shared expert counted once
    assert scale_err(summed, ref) < 1e-5 and scale_err(whole, ref) < 1e-5
    assert scale_err(parts[0][0], ref) > 1e-2  # one half alone is a partial result


def test_sigmoid_router_renormalises_then_scales_and_the_bias_only_chooses():
    gen = torch.Generator().manual_seed(6)
    x, gate = torch.randn(50, 16, generator=gen), torch.randn(12, 16, generator=gen) / 4
    bias = torch.zeros(12)
    bias[7] = 10.0  # expert 7 is chosen for every token, whatever its score
    scores, weights, experts = moe.route(x, gate, 3, norm_topk_prob=True, scaling_factor=2.446, scoring="sigmoid",
                                         correction_bias=bias)
    want_scores = torch.sigmoid(x @ gate.t())
    assert torch.equal(scores, want_scores)
    assert bool((experts == 7).any(dim=-1).all())
    want_experts = torch.topk(want_scores + bias, 3, dim=-1)[1]
    assert torch.equal(experts, want_experts)
    picked = want_scores.gather(1, want_experts)  # the weights read the unbiased scores
    torch.testing.assert_close(weights, picked / picked.sum(-1, keepdim=True) * 2.446, rtol=1e-6, atol=0)
    torch.testing.assert_close(weights.sum(-1), torch.full((50,), 2.446), rtol=1e-6, atol=0)
    _, unbiased_w, unbiased = moe.route(x, gate, 3, norm_topk_prob=True, scaling_factor=2.446, scoring="sigmoid")
    assert not torch.equal(unbiased, experts)
    with pytest.raises(ValueError, match="scoring"):
        moe.route(x, gate, 3, scoring="relu")
    # against the reference's rule on a router of the tiny model
    sd = {"m.gate.weight": gate, "m.gate.e_score_correction_bias": bias}
    ref_scores, ref_w, ref_e = plain.route(sd, "m", x, {**CFG, "num_experts_per_token": 3})
    assert torch.equal(ref_e, experts) and torch.equal(ref_scores, scores)
    torch.testing.assert_close(ref_w, weights, rtol=1e-6, atol=0)


@pytest.mark.parametrize("norm", [False, True])
def test_deepseek_softmax_router_is_unchanged(norm):
    gen = torch.Generator().manual_seed(7)
    x, gate = torch.randn(40, 16, generator=gen), torch.randn(8, 16, generator=gen)
    scores, weights, experts = moe.route(x, gate, 3, norm_topk_prob=norm, scaling_factor=1.5)
    want_scores = torch.nn.functional.linear(x.float(), gate.float()).softmax(dim=-1)  # the rule before Kimi
    want_w, want_e = torch.topk(want_scores, 3, dim=-1)
    want_w = want_w / (want_w.sum(dim=-1, keepdim=True) + 1e-20) if norm else want_w * 1.5
    assert torch.equal(scores, want_scores) and torch.equal(experts, want_e) and torch.equal(weights, want_w)


@pytest.mark.parametrize("held", [range(0, 5), range(3, 8), range(8)])
def test_dispatch_sorts_absent_experts_past_the_held_groups(held):
    gen = torch.Generator().manual_seed(len(held) + held.start)
    n, k, e, h = 30, 3, 8, 16
    experts = torch.topk(torch.randn(n, e, generator=gen), k, dim=-1)[1]
    d = moe.dispatch(experts, e, held)
    flat = experts.reshape(-1)
    inside = (flat >= held.start) & (flat < held.stop)
    assert torch.equal(d.counts, torch.bincount(flat, minlength=e))  # the routing over every expert
    assert d.offsets.shape == (len(held),) and int(d.offsets[-1]) == int(inside.sum())
    assert d.held_pairs.shape == (1,) and int(d.held_pairs) == int(inside.sum())  # n·k where every expert is held
    end = int(d.offsets[-1])
    assert bool((d.expert[:end] < len(held)).all()) and bool((d.expert[end:] >= len(held)).all())
    assert torch.equal(d.expert[d.pos.long()].view(n, k), ((flat - held.start) % e).view(n, k))
    # grouped GEMMs, the combine and the tap over the held experts only, against a dense loop
    x = torch.randn(n, h, generator=gen)
    gate_up, down = torch.randn(len(held), 16, h, generator=gen), torch.randn(len(held), h, 8, generator=gen)
    weights = torch.rand(n, k, generator=gen)
    act, y = moe.expert_ffn(x.index_select(0, d.token), gate_up, down, d, grouped=False)
    dense, dense_tap = torch.zeros(n, h), torch.zeros(n, len(held), 8)
    for t in range(n):
        for s in range(k):
            ex = int(experts[t, s])
            if ex in held:
                j = ex - held.start
                a = torch.nn.functional.silu(gate_up[j, :8] @ x[t])
                dense[t] += weights[t, s] * (down[j] @ (a * (gate_up[j, 8:] @ x[t])))
                dense_tap[t, j] = a
    # float32 sums of up to three products in other orders: 1e-5 of the output's scale
    assert scale_err(moe.combine(y, weights, d, n), dense) < 1e-5
    assert scale_err(moe.scatter_tap(act, d, n, len(held)), dense_tap.view(n, -1)) < 1e-5
    assert torch.equal(moe.scatter_tap(act, d, n, len(held)) == 0, dense_tap.view(n, -1) == 0)


def test_state_dict_round_trip_keeps_the_held_experts(pair):
    model, params, sd, _, _ = pair
    inter, w = CFG["moe_intermediate_size"], CFG["hidden_size"]
    assert params["model.layers.1.mlp.experts.gate_up_proj.weight"].shape == (len(HELD), 2 * inter, w)
    assert params["model.layers.1.mlp.gate.weight"].shape == (CFG["num_experts"], w)  # the router routes over all
    assert params["model.layers.2.self_attn.q_conv1d.weight"].shape == (32, 1, 4)
    back = model.hf_state_dict(params)
    held_names = {n for n in sd if ".mlp.experts." not in n or int(n.split(".")[5]) in HELD}
    assert set(back) == held_names  # the experts not held were dropped
    for name in held_names:
        assert torch.equal(back[name], sd[name]), name
    second = port_model(held=range(8, 16))  # the other device's share of the same checkpoint
    p2 = second.hf_state_dict(second.load_torch_state_dict(sd))
    name = "model.layers.4.mlp.experts.12.up_proj.weight"
    assert torch.equal(p2[name], sd[name])
    layer = {k: v for k, v in sd.items() if k.startswith("model.layers.2.")}
    part = model.load_torch_state_dict(layer, partial=True)
    assert set(part) == {k for k in params if k.startswith("model.layers.2.")}
    with pytest.raises(KeyError, match="missing"):
        model.load_torch_state_dict(layer)


def test_refuses_lrp_interventions_and_padding(pair):
    model, params, _, toks, _ = pair
    with pytest.raises(NotImplementedError, match="LRP through a Kimi Delta Attention"), lrp_composite():
        model.apply(params, toks.long())
    for name in ("model.layers.1.self_attn.o_norm", "model.layers.1.self_attn", "model.layers.2.mlp.gate"):
        with pytest.raises(NotImplementedError, match="interventions"), interventions({name: lambda v: v * 0}):
            model.apply(params, toks)
    with torch.no_grad(), interventions({"model.layers.0.mlp.act_fn": lambda v: v * 0}):
        ablated, _ = model.apply(params, toks)
    assert torch.isfinite(ablated).all()
    with pytest.raises(NotImplementedError, match="pad_id"):
        port_model(pad_id=0)
    with pytest.raises(ValueError, match="held_experts"):
        port_model(held=range(8, 20))


def test_from_name_holds_the_published_config():
    m = KimiLinear.from_name("kimi-linear-48b-a3b", device="cpu")
    got = {"hidden_size": m.width, "num_hidden_layers": m.depth, "num_attention_heads": m.heads,
           "num_key_value_heads": m.kv_heads, "intermediate_size": m.intermediate,
           "moe_intermediate_size": m.moe_intermediate, "num_experts": m.n_routed_experts,
           "num_shared_experts": m.n_shared_experts, "num_experts_per_token": m.experts_per_token,
           "first_k_dense_replace": m.first_k_dense, "moe_layer_freq": m.moe_layer_freq,
           "kv_lora_rank": m.kv_lora_rank, "qk_nope_head_dim": m.qk_nope_head_dim,
           "qk_rope_head_dim": m.qk_rope_head_dim, "v_head_dim": m.v_head_dim, "rope_theta": m.rope_theta,
           "rms_norm_eps": m.rms_eps, "vocab_size": m.vocab_size, "model_max_length": m.n_positions,
           "moe_renormalize": m.norm_topk_prob, "routed_scaling_factor": m.routed_scaling_factor,
           "tie_word_embeddings": m.tie_word_embeddings, "mla_use_nope": m.mla_use_nope,
           "head_dim": m.width // m.heads, "rope_scaling": m.rope_scaling, "q_lora_rank": None}
    assert got == {k: PUBLISHED[k] for k in got}
    lin = PUBLISHED["linear_attn_config"]
    assert (m.kda_heads, m.kda_head_dim, m.conv_size) == (lin["num_heads"], lin["head_dim"],
                                                          lin["short_conv_kernel_size"])
    assert [i + 1 for i in range(m.depth) if m.is_mla(i)] == lin["full_attn_layers"]
    assert [i + 1 for i in range(m.depth) if not m.is_mla(i)] == lin["kda_layers"]
    n = sum(math.prod(s) for _, s, _ in m._param_specs())
    assert n == pytest.approx(49.1e9, rel=1e-3)  # the published 48B-A3B: 49.1 B with the untied head
    share = KimiLinear.from_name("kimi-linear-48b-a3b", held_experts=range(128), device="cpu")
    assert sum(math.prod(s) for _, s, _ in share._param_specs()) == pytest.approx(25.57e9, rel=1e-3)
    # the benchmark's configuration file holds the published values at its top level; the experts are the cut
    bench = json.loads((ROOT / "portbench/configs/kimilinear-clip-b32.json").read_text())
    assert {k: bench[k] for k in PUBLISHED if k != "num_experts"} == {k: v for k, v in PUBLISHED.items()
                                                                       if k != "num_experts"}
    assert bench["reduced"] == ["num_experts"] and bench["num_experts_published"] == PUBLISHED["num_experts"]
    assert bench["num_experts"] == len(range(*bench["held_experts"])) == 128


def test_text_collect_and_embed_rank_as_the_reference(pair):
    model, params, sd, _, _ = pair
    n, k = 14, 3
    toks = tokens(n, seed=7).numpy()
    texts = [" ".join(f"w{int(t)}" for t in row[:6]) for row in toks]
    layer = "model.layers.5.self_attn.o_norm"
    model.params, model.name = params, "tiny-kimi"
    ds = TokenTextDataset(toks, texts, name="tiny-corpus")
    cfg = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=1,
                                                                heads=2),
                           text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=1))
    fm = tclip.OpenClip("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(1, cfg), cfg=cfg,
                        dtype=torch.float32, device="cpu")
    cv = TextActivationComponentVisualizer(model, ds, ds.texts_view(), [layer], k, cache_dir=None)
    db = Lens(fm).compute_concept_db(cv, batch_size=4)  # a padded last batch
    with torch.no_grad():
        _, ref_taps, _ = plain.forward(sd, torch.from_numpy(toks), CFG, HELD)
        acts = ref_taps[layer].mean(dim=1).t()  # (C, N) token means
    # the collect keeps bf16 values and an earlier sample wins a tie: rank the reference's the same way
    padded = torch.cat([torch.zeros(acts.shape[0], k), acts.to(torch.bfloat16).float()], dim=1)
    want = (torch.sort(padded, dim=1, descending=True, stable=True)[1][:, :k] - k).clamp(min=-1)
    np.testing.assert_array_equal(cv.get_max_reference(layer), want.numpy())
    assert db[layer].shape == (32, k, 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the KDA recurrence runs its hand-written kernel on the card")
    return torch.device("cuda", 0)


def kda_inputs(b, t, h, d, dtype, device, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit(z):
        return z * torch.rsqrt(z.square().sum(-1, keepdim=True))

    q = (unit(torch.randn(b, t, h, d, generator=gen, device=device)) * d**-0.5).to(dtype)
    k = unit(torch.randn(b, t, h, d, generator=gen, device=device)).to(dtype)
    v = torch.randn(b, t, h, d, generator=gen, device=device).to(dtype)
    g = -torch.nn.functional.softplus(torch.randn(b, t, h, d, generator=gen, device=device) - 4.6) * 3
    beta = torch.rand(b, t, h, generator=gen, device=device)
    return q, k, v, g, beta


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, d, dtype", [
    (4, 2048, 32, 128, torch.bfloat16),  # the text sweep's layer
    (1, 37, 1, 128, torch.bfloat16),  # B·h = 1, T not a multiple of the 16-token stage
    (3, 301, 5, 128, torch.float32),  # float32 operands: the kernel's arithmetic to float32 rounding
    (2, 16, 3, 128, torch.float32),  # one whole stage
])
def test_cuda_kda_kernel_matches_the_plain_version(cuda_device, b, t, h, d, dtype):
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    q, k, v, g, beta = kda_inputs(b, t, h, d, dtype, cuda_device)
    reset("kda.kernel")
    got = kda.recurrence(q, k, v, g, beta)
    torch.cuda.synchronize()
    assert counters().get("kda.kernel") == 1 and got.dtype == dtype and got.shape == v.shape
    want = kda.recurrence_plain(q, k, v, g, beta).float()  # every token: the state carried over the whole sequence
    # float32 sums in other orders, then one rounding to the operands' type
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert float((got.float() - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_cuda_kda_never_reaches_the_plain_version(cuda_device, monkeypatch):
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain recurrence")

    monkeypatch.setattr(kda, "recurrence_plain", refuse)
    q, k, v, g, beta = kda_inputs(2, 40, 2, 128, torch.bfloat16, cuda_device)
    reset("kda.kernel")
    for calls in range(1, 3):
        kda.recurrence(q, k, v, g, beta)
        assert counters().get("kda.kernel") == calls
    with pytest.raises(ValueError, match="head size"):
        kda.recurrence(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(),
                       g[..., :32].contiguous(), beta)
    with pytest.raises(ValueError, match="float32 g"):
        kda.recurrence(q, k, v, g.bfloat16(), beta)
    assert counters().get("kda.kernel") == 2


@pytest.mark.cuda
def test_cuda_combine_skips_the_absent_experts(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    n, k, e, h = 512, 8, 32, 256
    weights, experts = torch.topk(torch.rand(n, e, generator=gen, device=cuda_device), k, dim=-1)
    d = moe.dispatch(experts, e, range(0, 16))
    y = torch.randn(n * k, h, generator=gen, device=cuda_device).bfloat16()
    y[int(d.offsets[-1]):] = float("nan")  # rows never computed must not be read
    got = moe.combine(y, weights, d, n)
    want = moe.combine_plain(y.cpu(), weights.cpu(), moe.Dispatch(*(t.cpu() for t in d)), n)
    assert torch.isfinite(got).all()
    assert float((got.float().cpu() - want.float()).abs().max()) <= 2 ** -7 * float(want.float().abs().max())


@pytest.mark.cuda
def test_cuda_model_matches_the_cpu(cuda_device, pair):
    """A tiny Kimi Linear with the kernel's 128-wide KDA heads on the card in bf16 against the same model on the
    CPU in float32, on bf16-valued weights."""
    cfg = {**CFG, "linear_attn_config": {**CFG["linear_attn_config"], "head_dim": 128}}
    sd = {name: t.bfloat16().float() for name, t in hf_weights(cfg).items()}
    toks = tokens(2, 40)
    cpu = port_model(cfg)
    card = port_model(cfg)
    card.device, card.dtype = cuda_device, torch.bfloat16
    names = ["model.layers.0", "model.layers.2.self_attn.o_norm"]
    with torch.no_grad():
        _, on_card = card.apply(card.load_torch_state_dict(sd), toks, names)
        _, on_cpu = cpu.apply(cpu.load_torch_state_dict(sd), toks, names)
    for name in names:  # bf16 projections, convolutions and state inputs against float32: a few bf16 steps
        assert scale_err(on_card[name].float().cpu(), on_cpu[name]) < 3e-2, name
