"""DeepSeek-V2 (``models/deepseek.py``, ``ops/moe.py``) against the plain float32 reference
``tests/plain/deepseek_v2.py``.

A tiny model on the CPU in float32 (width 64, 4 heads, nope 16 / rope 8 /
v 16, kv rank 32, 8 experts top-2 beside 1 shared, a dense first layer,
depth 3, vocabulary 160, YaRN with an original length of 64 so that the
ramp crosses the four rope frequencies), seeded random HF-named weights:
logits, every tap both compute, the chosen experts and the expert tap's
layout and zeros, the YaRN frequencies against a table worked by hand, the
state dict's round trip through the stacked experts, the refusals of LRP
and interventions on MoE layers, ``from_name`` against the published
config, and the text Collect+Embed path end to end against the
reference's ranking.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from plain import deepseek_v2 as plain
from semanticlens_tpu_torch import Lens
from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer, TokenTextDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import DeepseekV2, TapCollector, interventions
from semanticlens_tpu_torch.models.deepseek import yarn_find_correction_range, yarn_inv_freq
from semanticlens_tpu_torch.models.layers import lrp_composite
from semanticlens_tpu_torch.ops import moe

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
V, T = 160, 12
YARN = {"type": "yarn", "factor": 4, "original_max_position_embeddings": 64, "beta_fast": 32, "beta_slow": 1,
        "mscale": 1.0, "mscale_all_dim": 0.707}
# HF config.json keys of the tiny model (the reference reads these)
CFG = {"vocab_size": V, "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 3, "intermediate_size": 96,
       "moe_intermediate_size": 16, "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
       "first_k_dense_replace": 1, "moe_layer_freq": 1, "kv_lora_rank": 32, "q_lora_rank": None,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "rope_theta": 10000.0, "rope_scaling": YARN,
       "rms_norm_eps": 1e-6, "norm_topk_prob": False, "routed_scaling_factor": 1.0}
# DeepSeek-V2-Lite's config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json)
LITE = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 2048,
        "intermediate_size": 10944, "kv_lora_rank": 512, "max_position_embeddings": 163840,
        "model_type": "deepseek_v2", "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
        "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
        "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096, "type": "yarn"},
        "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
        "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
        "vocab_size": 102400}


def port_model(cfg=CFG, **kw):
    return DeepseekV2(
        vocab_size=cfg["vocab_size"], n_positions=64, width=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], intermediate=cfg["intermediate_size"],
        moe_intermediate=cfg["moe_intermediate_size"], n_routed_experts=cfg["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"], experts_per_token=cfg["num_experts_per_tok"],
        first_k_dense=cfg["first_k_dense_replace"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], rope_theta=cfg["rope_theta"], rope_scaling=cfg["rope_scaling"],
        rms_eps=cfg["rms_norm_eps"], dtype=torch.float32, device="cpu", **kw)


def hf_weights(cfg=CFG, seed=0) -> dict[str, torch.Tensor]:
    """An HF-named float32 state dict: matrices N(0, 1/fan_in), embeddings N(0, 1), norms 1 + 0.1·N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    w, h = cfg["hidden_size"], cfg["num_attention_heads"]
    e, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    dn, dr, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    shapes = {"model.embed_tokens.weight": (V, w), "model.norm.weight": (w,), "lm_head.weight": (V, w)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        shapes.update({f"{p}.input_layernorm.weight": (w,), f"{p}.post_attention_layernorm.weight": (w,),
                       f"{p}.self_attn.q_proj.weight": (h * (dn + dr), w),
                       f"{p}.self_attn.kv_a_proj_with_mqa.weight": (r + dr, w),
                       f"{p}.self_attn.kv_a_layernorm.weight": (r,),
                       f"{p}.self_attn.kv_b_proj.weight": (h * (dn + dv), r),
                       f"{p}.self_attn.o_proj.weight": (w, h * dv)})
        mlps = [(f"{p}.mlp", cfg["intermediate_size"])] if not plain.is_moe(cfg, i) else (
            [(f"{p}.mlp.experts.{j}", inter) for j in range(e)]
            + [(f"{p}.mlp.shared_experts", inter * cfg["n_shared_experts"])])
        if plain.is_moe(cfg, i):
            shapes[f"{p}.mlp.gate.weight"] = (e, w)
        for m, width in mlps:
            shapes.update({f"{m}.gate_proj.weight": (width, w), f"{m}.up_proj.weight": (width, w),
                           f"{m}.down_proj.weight": (w, width)})
    out = {}
    for name, shape in shapes.items():
        z = torch.randn(shape, generator=gen)
        if len(shape) == 1:
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = z if "embed" in name else z * shape[1] ** -0.5
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
    heads = [f"model.layers.{i}.self_attn.heads" for i in range(CFG["num_hidden_layers"])]
    with torch.no_grad():
        want = plain.forward(sd, toks, CFG, heads)
    return model, params, sd, toks, want


def scale_err(got, want) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def test_logits_and_every_shared_tap_match_the_reference(pair):
    model, params, _, toks, (logits, ref_taps, _) = pair
    with torch.no_grad():
        got_logits, taps = model.apply(params, toks, model.module_names)
    # float32 on both sides, other summation orders and a float32 RoPE island: 1e-5 of each tensor's scale
    assert scale_err(got_logits, logits) < 1e-5
    shared = sorted(set(taps) & set(ref_taps))
    must = {"model.layers.0.mlp.act_fn", "model.layers.0.self_attn.heads", "model.layers.1.mlp.gate",
            "model.layers.2.mlp.experts.act_fn", "model.layers.2.mlp.shared_experts.act_fn",
            "model.layers.1.mlp.experts", "model.layers.2.mlp", "model.layers.2.self_attn", "model.layers.2"}
    assert must <= set(shared)
    for name in shared:
        assert taps[name].shape == ref_taps[name].shape, name
        assert scale_err(taps[name], ref_taps[name]) < 1e-5, name


def test_chosen_experts_and_the_expert_tap_layout(pair):
    model, params, _, toks, (_, ref_taps, chosen) = pair
    e, inter, k = CFG["n_routed_experts"], CFG["moe_intermediate_size"], CFG["num_experts_per_tok"]
    names = [f"model.layers.{i}.mlp.experts.act_fn" for i in (1, 2)]
    with torch.no_grad():
        _, taps = model.apply(params, toks, names)
    for i, name in zip((1, 2), names):
        tap = taps[name].view(*toks.shape, e, inter)
        routed = tap.ne(0).any(dim=-1)  # silu(gate_e x) is never exactly 0 for a routed pair
        assert torch.equal(routed.sum(-1), torch.full(toks.shape, k))
        want = torch.zeros_like(routed).scatter_(-1, chosen[i].long(), True)
        assert torch.equal(routed, want)  # the chosen experts, token by token
        assert torch.equal(tap[~routed], torch.zeros_like(tap[~routed]))  # exactly 0 where not routed
        ref = ref_taps[name].view_as(tap)
        assert scale_err(tap[routed], ref[routed]) < 1e-5


def test_untapped_forward_equals_the_tapped_one(pair):
    model, params, _, toks, _ = pair
    with torch.no_grad():
        plain_logits, taps = model.apply(params, toks)
        tapped, _ = model.apply(params, toks, ["model.layers.2.mlp.experts.act_fn"])
    assert taps == {} and torch.equal(plain_logits, tapped)


def test_yarn_inv_freq_against_a_hand_table():
    # rope dim 8, θ 1e4: unscaled 1, 0.1, 0.01, 0.001; the ramp over channels [0, 2) is 0, 0.5, 1, 1, so the
    # first keeps its frequency, the second takes half of each and the last two are divided by the factor 4
    got = yarn_inv_freq(8, 1e4, YARN)
    want = torch.tensor([1.0, 0.5 * 0.1 + 0.5 * 0.1 / 4, 0.01 / 4, 0.001 / 4])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got, plain.inv_freq(CFG), rtol=0, atol=0)
    # DeepSeek-V2-Lite: rope dim 64, original 4096, β 32 / 1 → the ramp spans channels 10 … 23
    assert yarn_find_correction_range(32, 1, 64, 1e4, 4096) == (10, 23)
    full = yarn_inv_freq(64, 1e4, LITE["rope_scaling"])
    base = 1e4 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    torch.testing.assert_close(full[:10].double(), base[:10], rtol=1e-6, atol=0)
    torch.testing.assert_close(full[23:].double(), base[23:] / 40, rtol=1e-6, atol=0)
    j = 16  # ramp (16 − 10) / 13 of the way to the scaled frequency
    r = (j - 10) / 13
    assert math.isclose(float(full[j]), float(base[j]) * (r / 40 + 1 - r), rel_tol=1e-6)


def test_state_dict_round_trip_through_the_stacked_experts(pair):
    model, params, sd, _, _ = pair
    e, inter, w = CFG["n_routed_experts"], CFG["moe_intermediate_size"], CFG["hidden_size"]
    assert params["model.layers.1.mlp.experts.gate_up_proj.weight"].shape == (e, 2 * inter, w)
    assert params["model.layers.1.mlp.experts.down_proj.weight"].shape == (e, w, inter)
    assert "model.layers.1.mlp.experts.3.up_proj.weight" not in params
    back = model.hf_state_dict(params)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    layer = {k: v for k, v in sd.items() if k.startswith("model.layers.2.")}
    part = model.load_torch_state_dict(layer, partial=True)
    assert set(part) == {k for k in params if k.startswith("model.layers.2.")}
    with pytest.raises(KeyError, match="missing"):
        model.load_torch_state_dict(layer)


def test_moe_refuses_lrp_and_interventions_but_not_the_dense_layer(pair):
    model, params, _, toks, _ = pair
    with pytest.raises(NotImplementedError, match="LRP"), lrp_composite():
        model.apply(params, toks.long(), ["model.layers.2.mlp.experts.act_fn"])
    with pytest.raises(NotImplementedError, match="interventions"), interventions(
            {"model.layers.1.mlp.experts.act_fn": lambda v: v * 0}):
        model.apply(params, toks)
    with torch.no_grad(), interventions({"model.layers.0.mlp.act_fn": lambda v: v * 0}):
        ablated, _ = model.apply(params, toks)
    assert torch.isfinite(ablated).all()


def test_grouped_and_plain_expert_paths_agree():
    gen = torch.Generator().manual_seed(3)
    x, gate = torch.randn(40, 16, generator=gen), torch.randn(8, 16, generator=gen)
    # widths whose rows are multiples of 16 bytes, as the grouped GEMM asks
    gate_up, down = torch.randn(8, 16, 16, generator=gen), torch.randn(8, 16, 8, generator=gen)
    _, weights, experts = moe.route(x, gate, 2)
    experts = torch.where(experts == 5, 6, experts)  # an expert that no pair goes to: an empty group
    d = moe.dispatch(experts, 8)
    assert int(d.counts[5]) == 0 and int(d.counts.sum()) == 80
    order = torch.argsort(experts.reshape(-1), stable=True)
    assert torch.equal(d.expert, experts.reshape(-1)[order]) and bool((d.expert[1:] >= d.expert[:-1]).all())
    xs = x.index_select(0, d.token)
    act_g, y_g = moe.expert_ffn(xs, gate_up, down, d, grouped=True)
    act_p, y_p = moe.expert_ffn(xs, gate_up, down, d, grouped=False)
    torch.testing.assert_close(y_g, y_p, rtol=1e-5, atol=1e-5)  # one float32 GEMM each, other blockings
    torch.testing.assert_close(act_g, act_p, rtol=1e-5, atol=1e-5)
    dense = torch.zeros(40, 16)
    for slot in range(2):  # the combine against a dense per-slot sum
        for t in range(40):
            e = int(experts[t, slot])
            h = torch.nn.functional.silu(gate_up[e, :8] @ x[t]) * (gate_up[e, 8:] @ x[t])
            dense[t] += weights[t, slot] * (down[e] @ h)
    torch.testing.assert_close(moe.combine(y_p, weights, d, 40), dense, rtol=1e-5, atol=1e-5)



def routed_pairs(n, k, e, h, *, dtype=torch.float32, device="cpu", one_expert=None, seed=5):
    """(y_sorted (N·k, H), weights (N, k) float32, dispatch) of N tokens routed top-k over e experts; with
    ``one_expert``, every pair goes to that expert."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scores = torch.randn(n, e, generator=gen, device=device).softmax(dim=-1)
    weights, experts = torch.topk(scores, k, dim=-1)
    if one_expert is not None:
        experts = torch.full_like(experts, one_expert)
    d = moe.dispatch(experts, e)
    return torch.randn(n * k, h, generator=gen, device=device).to(dtype), weights, d


@pytest.mark.parametrize("n, k, e", [(40, 2, 8), (37, 6, 64), (5, 1, 3), (16, 4, 4)])
def test_dispatch_positions_invert_the_order(n, k, e):
    gen = torch.Generator().manual_seed(n)
    experts = torch.topk(torch.randn(n, e, generator=gen), k, dim=-1)[1]
    d = moe.dispatch(experts, e)
    order = torch.argsort(experts.reshape(-1), stable=True)  # the sort dispatch makes
    assert d.pos.dtype == torch.int32 and d.pos.shape == (n * k,)
    assert torch.equal(d.pos[order], torch.arange(n * k, dtype=torch.int32))
    assert torch.equal(order[d.pos.long()], torch.arange(n * k))
    # token t's slot s sits at d.pos[t·k + s]: its expert and token read back from the sorted order
    assert torch.equal(d.expert[d.pos.long()].view(n, k), experts)
    assert torch.equal(d.token[d.pos.long()].view(n, k), torch.arange(n)[:, None].expand(n, k))


def test_slot_ordered_combine_equals_the_dense_per_slot_sum_with_an_empty_expert():
    y, weights, d = routed_pairs(40, 3, 8, 24)
    y2, w2, d2 = routed_pairs(40, 3, 8, 24, one_expert=2)  # seven experts with no pairs
    for yy, ww, dd in ((y, weights, d), (y2, w2, d2)):
        dense = torch.zeros(40, 24)
        for t in range(40):
            for slot in range(3):
                dense[t] += ww[t, slot] * yy[int(dd.pos[t * 3 + slot])]
        torch.testing.assert_close(moe.combine_plain(yy, ww, dd, 40), dense, rtol=0, atol=0)
        torch.testing.assert_close(moe.combine(yy, ww, dd, 40), dense, rtol=0, atol=0)
    assert int((d2.counts == 0).sum()) == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_ordered_combine_equals_the_index_add_form(dtype):
    y, weights, d = routed_pairs(64, 6, 16, 32, dtype=dtype)
    w = weights.reshape(-1)[torch.argsort(d.pos)]  # each sorted pair's weight: pos inverted
    old = torch.zeros(64, 32).index_add_(0, d.token, y.float() * w[:, None])  # the combine it replaced
    new = moe.combine_plain(y.float(), weights, d, 64)
    torch.testing.assert_close(new, old, rtol=1e-6, atol=1e-6)  # float32 sums of six terms in two orders


@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_combine_returns_the_requested_dtype(rows):
    y, weights, d = routed_pairs(12, 2, 4, 16, dtype=rows)
    got = moe.combine_plain(y, weights, d, 12)
    assert got.dtype == rows and got.shape == (12, 16)  # the outputs' dtype
    exact = moe.combine_plain(y.float(), weights, d, 12)
    assert torch.equal(got, exact.to(rows))  # one rounding, from the float32 sum
    assert torch.equal(moe.combine(y, weights, d, 12), got)

def test_from_name_holds_the_published_config():
    m = DeepseekV2.from_name("deepseek-v2-lite", device="cpu")
    got = {"hidden_size": m.width, "num_hidden_layers": m.depth, "num_attention_heads": m.heads,
           "num_key_value_heads": m.kv_heads, "intermediate_size": m.intermediate,
           "moe_intermediate_size": m.moe_intermediate, "n_routed_experts": m.n_routed_experts,
           "n_shared_experts": m.n_shared_experts, "num_experts_per_tok": m.experts_per_token,
           "first_k_dense_replace": m.first_k_dense, "moe_layer_freq": m.moe_layer_freq,
           "kv_lora_rank": m.kv_lora_rank, "qk_nope_head_dim": m.qk_nope_head_dim,
           "qk_rope_head_dim": m.qk_rope_head_dim, "v_head_dim": m.v_head_dim, "rope_theta": m.rope_theta,
           "rms_norm_eps": m.rms_eps, "vocab_size": m.vocab_size, "max_position_embeddings": m.n_positions,
           "norm_topk_prob": m.norm_topk_prob, "routed_scaling_factor": m.routed_scaling_factor,
           "tie_word_embeddings": m.tie_word_embeddings}
    assert got == {k: LITE[k] for k in got}
    assert {k: v for k, v in m.rope_scaling.items()} == LITE["rope_scaling"]
    n = sum(math.prod(s) for _, s, _ in m._param_specs())
    assert n == 15_706_484_224  # the published 15.7 B
    assert math.isclose(m.softmax_scale, 192**-0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2, rel_tol=1e-12)
    # the benchmark's configuration file holds the same published values at its top level
    bench = json.loads((ROOT / "portbench/configs/dsv2lite-clip-b32.json").read_text())
    assert {k: bench[k] for k in LITE} == LITE


def test_text_collect_and_embed_rank_as_the_reference(pair):
    model, params, sd, _, _ = pair
    n, k = 14, 3
    toks = tokens(n, seed=7).numpy()
    texts = [" ".join(f"w{int(t)}" for t in row[:6]) for row in toks]
    layer = "model.layers.2.mlp.experts.act_fn"
    model.params, model.name = params, "tiny-deepseek"
    ds = TokenTextDataset(toks, texts, name="tiny-corpus")
    cfg = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=1,
                                                                heads=2),
                           text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=1))
    fm = tclip.OpenClip("ViT-B-32", jax_params=tclip.init_clip_params_jax_layout(1, cfg), cfg=cfg,
                        dtype=torch.float32, device="cpu")
    cv = TextActivationComponentVisualizer(model, ds, ds.texts_view(), [layer], k, cache_dir=None)
    db = Lens(fm).compute_concept_db(cv, batch_size=4)  # a padded last batch
    with torch.no_grad():
        _, ref_taps, _ = plain.forward(sd, torch.from_numpy(toks), CFG)
        acts = ref_taps[layer].mean(dim=1).t()  # (C, N) token means
    # the collect keeps bf16 values and an earlier sample wins a tie: rank the reference's the same way
    padded = torch.cat([torch.zeros(acts.shape[0], k), acts.to(torch.bfloat16).float()], dim=1)
    want = (torch.sort(padded, dim=1, descending=True, stable=True)[1][:, :k] - k).clamp(min=-1)
    np.testing.assert_array_equal(cv.get_max_reference(layer), want.numpy())
    assert db[layer].shape == (CFG["n_routed_experts"] * CFG["moe_intermediate_size"], k, 16)
    with torch.no_grad():
        emb = fm.encode_text(fm.tokenize(texts)).float().numpy()
    ids = want.numpy()
    np.testing.assert_allclose(db[layer][ids >= 0], emb[ids[ids >= 0]], rtol=0, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped expert GEMMs run torch._grouped_mm on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_grouped_experts_match_the_plain_loop(cuda_device, pair):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(512, 256, device=cuda_device, generator=gen).bfloat16()
    gate = torch.randn(16, 256, device=cuda_device, generator=gen).bfloat16()
    gate_up = (torch.randn(16, 256, 256, device=cuda_device, generator=gen) / 16).bfloat16()
    down = (torch.randn(16, 256, 128, device=cuda_device, generator=gen) / 16).bfloat16()
    _, _, experts = moe.route(x, gate, 4)
    d = moe.dispatch(torch.where(experts == 3, 4, experts), 16)  # expert 3's group is empty
    xs = x.index_select(0, d.token)
    act_g, y_g = moe.expert_ffn(xs, gate_up, down, d)  # the card's default: one grouped GEMM a projection
    act_p, y_p = moe.expert_ffn(xs, gate_up, down, d, grouped=False)
    assert int(d.counts[3]) == 0
    # bf16 GEMMs with float32 accumulation in other blockings: a few bf16 steps of the output's scale
    assert scale_err(y_g, y_p) < 2e-2 and scale_err(act_g, act_p) < 2e-2
    # the model on the card in bf16 against the port on the CPU in float32, both on the same bf16-valued
    # weights and inputs, so that the router sees equal logits up to float32 rounding and routes alike
    model, _, sd, toks, _ = pair
    sd16 = {name: t.bfloat16().float() for name, t in sd.items()}
    card = port_model()
    card.device, card.dtype = cuda_device, torch.bfloat16
    names = ["model.layers.0", "model.layers.2.mlp.experts.act_fn"]
    with torch.no_grad():
        _, on_card = card.apply(card.load_torch_state_dict(sd16), toks, names)
        _, on_cpu = model.apply(model.load_torch_state_dict(sd16), toks, names)
        x = on_cpu["model.layers.0"].bfloat16()  # one MoE layer on equal inputs
        p_card, p_cpu = card.load_torch_state_dict(sd16), model.load_torch_state_dict(sd16)
        m_card = card._moe(TapCollector(names), p_card, "model.layers.1", x.to(cuda_device), 1)
        m_cpu = model._moe(TapCollector(names), p_cpu, "model.layers.1", x.float(), 1)
    # MLA with YaRN (cuDNN's attention with q/k 192 and v 128 at full size) and the dense layer: bf16 steps
    assert scale_err(on_card["model.layers.0"].float().cpu(), on_cpu["model.layers.0"]) < 2e-2
    assert scale_err(m_card.float().cpu(), m_cpu) < 2e-2  # the grouped bf16 experts against the float32 loop
    routed = on_card["model.layers.2.mlp.experts.act_fn"].view(*toks.shape, 8, 16).ne(0).any(dim=-1).cpu()
    want = on_cpu["model.layers.2.mlp.experts.act_fn"].view(*toks.shape, 8, 16).ne(0).any(dim=-1)
    assert (routed == want).all(dim=-1).float().mean() >= 0.9  # two layers on: bf16 may flip a near-tie



def within_one_step(got, want32, scale):
    """Whether ``got`` lies within one rounding step of its dtype from the float32 sum ``want32`` (plus a float32
    rounding of the summands' ``scale``, which a cancelling sum leaves)."""
    step = want32.abs() * torch.finfo(got.dtype).eps + scale * 2.0**-20
    return bool(((got.float() - want32).abs() <= step).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n, k, e, h, dtype, one_expert", [
    (8192, 6, 64, 2048, torch.bfloat16, None),  # DeepSeek-V2-Lite at 16 × 512 tokens
    (37, 2, 8, 5120, torch.bfloat16, None),  # ragged N, a wide row: 640 chunks over 256 lanes
    (512, 6, 64, 2048, torch.bfloat16, 9),  # one expert takes every pair
    (64, 11, 16, 72, torch.bfloat16, None),  # k above the unrolled instances, a row of 9 chunks
    (300, 6, 64, 64, torch.float32, None),  # a float32 model on the card (lm_audit's)
])
def test_cuda_combine_kernel_matches_the_plain_version(cuda_device, n, k, e, h, dtype, one_expert):
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    y, weights, d = routed_pairs(n, k, e, h, dtype=dtype, device=cuda_device, one_expert=one_expert)
    reset("moe.combine.kernel")
    got = moe.combine(y, weights, d, n)
    assert counters().get("moe.combine.kernel") == 1
    assert got.dtype == dtype and got.shape == (n, h)
    exact = moe.combine_plain(y.float(), weights, d, n)
    plain = moe.combine_plain(y, weights, d, n)
    scale = float(y.float().abs().max() * weights.sum(dim=1).max())
    assert within_one_step(got, exact, scale) and within_one_step(got, plain.float(), scale)


@pytest.mark.cuda
def test_cuda_combine_never_reaches_the_plain_version(cuda_device, monkeypatch):
    from semanticlens_tpu_torch.utils.profiling import counters, reset

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain combine")

    monkeypatch.setattr(moe, "combine_plain", refuse)
    y, weights, d = routed_pairs(100, 6, 64, 256, dtype=torch.bfloat16, device=cuda_device)
    reset("moe.combine.kernel")
    for calls in range(1, 4):
        moe.combine(y, weights, d, 100)
        assert counters().get("moe.combine.kernel") == calls  # one launch a call
    with pytest.raises(ValueError, match="multiples of 8"):
        moe.combine(y[:, :20].contiguous(), weights, d, 100)
    with pytest.raises(ValueError, match="float32 weights"):
        moe.combine(y, weights.double(), d, 100)
    assert counters().get("moe.combine.kernel") == 3
