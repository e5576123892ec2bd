"""End-to-end language-model audit: collect → embed → name → score → causal check → token attribution.

Counterpart of the JAX package's ``tools/lm_audit.py``, with its flags,
defaults and three JSON lines (keys in :data:`REPORT_KEYS`): dissect an LM
subject's MLP neurons (or attention heads, ``--layer …attn.heads``) over a
synthetic topic corpus, embed the evidence strings with OpenCLIP ViT-B/32's
text tower (float32), name the components against the topic vocabulary
(soft-WPMI), score clarity, ablate the clearest component on its evidence
against control rows (``causal.necessity_ratio``) and attribute it to
tokens (ε-plus-flat LRP). The corpus uses the JAX tool's stand-in
tokenizer (codepoints mod 160, left-padded with id 159); weights are
random from seed 0. Runs on the card unless given ``--cpu``.

Usage:
  python -m semanticlens_tpu_torch.lm_audit --family llama
  python -m semanticlens_tpu_torch.lm_audit --cpu --samples 64
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

TOPICS = ["a sleeping cat", "a red car", "fresh bread", "a wooden chair", "heavy rain"]
VOCAB, PAD_ID = 160, 159  # the stand-in tokenizer's range; 159 never starts or ends a topic sentence

# The keys of each stage's JSON line, in the JAX tool's order.
REPORT_KEYS = {
    "collect+embed": ("stage", "layer", "components", "evidence", "wall_s"),
    "analyze": ("stage", "clarity_mean", "clearest_component", "its_label", "its_evidence"),
    "validate": ("stage", "necessity_ratio", "top_relevant_token_index", "total_wall_s", "device"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layer", default="")
    ap.add_argument("--samples", type=int, default=96)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--evidence", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--family", default="gpt2", choices=["gpt2", "llama", "gemma2", "deepseek_v2"],
                    help="subject architecture (HF naming conventions)")
    return ap.parse_args(argv)


def corpus(n: int, seq_len: int):
    """The tool's synthetic topic corpus as a left-padded :class:`TokenTextDataset`."""
    from semanticlens_tpu_torch.collect import TokenTextDataset

    texts = [f"{TOPICS[i % len(TOPICS)]} appears in sentence {i}" for i in range(n)]
    return TokenTextDataset.from_texts(texts, lambda t: [ord(c) % VOCAB for c in t], seq_len, pad="left",
                                       pad_id=PAD_ID, name="lm-audit-corpus")


def build_subject(args, device):
    """``(model, default layer)``: the float32 subject of ``--family`` at the tool's sizes, pad-aware.

    ``deepseek_v2``: latent attention (nope 16, rope 8, value 16, kv rank 32,
    YaRN over an original 8 positions) and 8 experts (top-2) of width 32
    beside one shared, after one dense layer; the default layer is the last
    layer's experts' neurons.
    """
    from semanticlens_tpu_torch.models import GPT2, DeepseekV2, Gemma2, Llama

    common = dict(vocab_size=VOCAB, n_positions=args.seq_len, width=args.width, depth=args.depth,
                  heads=args.heads, dtype=torch.float32, pad_id=PAD_ID, device=device)
    if args.family == "deepseek_v2":
        yarn = {"type": "yarn", "factor": 4, "original_max_position_embeddings": 8, "beta_fast": 32, "beta_slow": 1,
                "mscale": 0.707, "mscale_all_dim": 0.707}
        return (DeepseekV2(**common, moe_intermediate=32, n_routed_experts=8, n_shared_experts=1, experts_per_token=2,
                           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, rope_scaling=yarn),
                f"model.layers.{args.depth - 1}.mlp.experts.act_fn")
    if args.family == "llama":
        return Llama(**common, kv_heads=max(1, args.heads // 2)), f"model.layers.{args.depth - 1}.mlp.act_fn"
    if args.family == "gemma2":
        return (Gemma2(**common, kv_heads=max(1, args.heads // 2), sliding_window=args.seq_len // 2),
                f"model.layers.{args.depth - 1}.mlp.act_fn")
    return GPT2(**common), f"transformer.h.{args.depth - 1}.mlp.act"


def build_fm(device):
    """OpenCLIP ViT-B/32 in float32 (the tool's dtype), random from seed 0."""
    from semanticlens_tpu_torch.foundation_models import OpenClip

    return OpenClip("ViT-B-32", dtype=torch.float32, device=device)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    from semanticlens_tpu_torch import Lens, causal
    from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer
    from semanticlens_tpu_torch.relevance import token_relevance
    from semanticlens_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    ds = corpus(args.samples, args.seq_len)
    tokens = ds.images

    lm, default_layer = build_subject(args, device)
    lm.params = lm.init(0)
    lm.name = f"lm-audit-{args.family}"
    layer = args.layer or default_layer

    cv = TextActivationComponentVisualizer(model=lm, dataset_model=ds, dataset_fm=ds.texts_view(),
                                           layer_names=[layer], num_samples=args.evidence, cache_dir=None)
    lens = Lens(build_fm(device))
    reports = []

    def emit(stage, *values):
        reports.append(dict(zip(REPORT_KEYS[stage], (stage, *values))))
        print(json.dumps(reports[-1]))

    db = lens.compute_concept_db(cv, batch_size=args.batch)
    emit("collect+embed", layer, int(db[layer].shape[0]), args.evidence, round(time.perf_counter() - t0, 2))

    agg = {k: np.asarray(v, np.float32).mean(1) for k, v in db.items()}
    words, _ = lens.label_components(TOPICS, agg, scoring="wpmi", evidence_ids={layer: cv.get_max_reference(layer)},
                                     image_embeds=cv.embedding_table)[layer]
    clarity = torch.as_tensor(lens.eval_clarity(db)[layer]).float().cpu().numpy()
    best = int(np.nanargmax(clarity))
    emit("analyze", round(float(np.nanmean(clarity)), 4), best, words[best][0],
         [t for t in cv.get_max_reference_texts(layer)[best] if t][:3])

    ev = cv.get_max_reference(layer)[best]
    ev = ev[ev >= 0]
    ratio, peak = None, None  # DeepSeek-V2 refuses ablation and LRP through its MoE layers: reported as null
    if args.family != "deepseek_v2":
        ctl = rng.choice(args.samples, size=ev.size, replace=False)
        ratio = round(float(causal.necessity_ratio(lm, lm.params, layer, [best], tokens[ev], tokens[ctl])[0]), 3)
        rel = token_relevance(lm, lm.params, tokens[ev[:1]], layer, best)
        peak = int(torch.argmax(torch.abs(rel[0])))
    emit("validate", ratio, peak, round(time.perf_counter() - t0, 2),
         torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    return reports


if __name__ == "__main__":
    main()
