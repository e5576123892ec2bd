"""Where one SAE training step and one SAE batch of the audit spend their device time, on one CUDA card.

    python3 profile_sae.py

The configuration of ``chip_smoke.py`` ``[sae]``: ResNet-50 bf16 (random
weights from seed 0), layer3 (d_in 1024), an SAE of 8192 latents with TopK
32 and AuxK 256, float32 SAE math with TF32 off.

1. One warm training step at 4096 × 1024 × 8192 (the rows of one 256-image
   batch at 16 positions each, extracted once beforehand): CUDA-event time,
   then a ``torch.profiler`` trace split into the encode GEMM, the top-32
   and its scatter, AuxK's top-256 and mask (computed on every step, also
   before any latent is dead), the decode, the rest of the forward (AuxK's
   decode, losses, metrics), the backward's GEMMs, the rest of the
   backward, and the optimizer (clip, Adam, apply).
   The streaming extraction of those rows (subject forward, position
   sampling) is timed and traced on its own.
2. One SAE batch of the audit's collect half (256 images: the subject
   forward, 50,176 rows through the 1024 × 8192 encode and a top-32, the
   max over positions and the streaming top-k update): CUDA-event time and
   the same kind of split.

Each kernel is classed by the labelled region around the op that launched
it (labels from wrapping, in this script only, the SAE module's functions)
and by the autograd engine for the backward. Prints JSON lines, the last
with the card's name; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

sys.dont_write_bytecode = True

import torch  # noqa: E402

TOPK_SCATTER = "top-k + scatter (training top-32)"
TOPK_MASK = "top-k + mask (training: AuxK's top-256; audit: the encode's top-32)"
LABELS = ("subject forward", "row extraction", "encode GEMM", TOPK_SCATTER, TOPK_MASK, "decode", "optimizer",
          "aggregate + top-k update")
BATCH, POSITIONS, LATENTS, K, AUX_K, BATCH_ROWS = 256, 16, 8192, 32, 256, 4096


def install_labels(sae, model):
    """Wrap the SAE module's pieces and the subject's forward in ``record_function`` regions."""
    from torch.profiler import record_function

    def labelled(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    sae._pre_activations = labelled("encode GEMM", sae._pre_activations)
    sae._topk_scatter = labelled(TOPK_SCATTER, sae._topk_scatter)
    sae._topk_mask = labelled(TOPK_MASK, sae._topk_mask)
    sae.decode = labelled("decode", sae.decode)
    sae.ClipAdam.update = labelled("optimizer", sae.ClipAdam.update)
    sae.apply_updates = labelled("optimizer", sae.apply_updates)
    model.apply = labelled("subject forward", model.apply)
    return labelled


def label_of(event) -> str | None:
    e = event
    while e is not None:
        if e.name in LABELS:
            return e.name
        if e.name.startswith("autograd::engine::evaluate_function"):
            return "backward"
        e = e.cpu_parent
    return None


def innermost_op(event) -> str:
    e = event
    while e is not None:
        if e.name.startswith("aten::"):
            return e.name
        e = e.cpu_parent
    return event.name


def split(prof, wall_ms: float) -> dict:
    """Device ms and launches by category from a trace."""
    by_cat: dict[str, dict] = {}
    for event in prof.events():
        for kernel in getattr(event, "kernels", []):
            label, op = label_of(event), innermost_op(event)
            if label == "backward":
                cat = "backward GEMMs" if op in ("aten::mm", "aten::bmm", "aten::addmm") else "backward other"
            elif label is None:
                cat = "other forward (AuxK decode, losses, metrics)"
            else:
                cat = label
            row = by_cat.setdefault(cat, {"ms": 0.0, "launches": 0})
            row["ms"] += kernel.duration / 1e3
            row["launches"] += 1
    device_ms = sum(r["ms"] for r in by_cat.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler linked no device kernel to an op; time with CUDA events instead")
    return {"wall_ms": wall_ms, "device_kernel_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "launches": sum(r["launches"] for r in by_cat.values()),
            "by_category": {c: r | {"share": r["ms"] / device_ms}
                            for c, r in sorted(by_cat.items(), key=lambda kv: -kv[1]["ms"])}}


def event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def traced(fn) -> tuple:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def main():
    if not torch.cuda.is_available():
        print("profile_sae: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import record_function

    from semanticlens_tpu_torch import sae
    from semanticlens_tpu_torch.collect.engine import CollectEngine
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_max_auto
    from semanticlens_tpu_torch.ops.topk import init_topk
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    params = model.init(seed=0)
    prep = make_preprocess_fn(size=224)
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 255, (BATCH, 224, 224, 3), generator=gen, device=dev, dtype=torch.uint8)
    cfg = sae.SAEConfig(d_in=1024, n_latents=LATENTS, k=K, aux_k=AUX_K, batch_rows=BATCH_ROWS,
                        positions_per_image=POSITIONS, seed=0)
    dictionary = sae.init_sae(torch.Generator().manual_seed(0), cfg, dev)
    labelled = install_labels(sae, model)

    # 1. The training step, and the streaming extraction of its rows.
    extract = sae._make_row_extractor(sae._PreprocessedModel(model, prep), "layer3", cfg)
    extract_fn = labelled("row extraction", extract)
    rows = extract_fn(params, raw, gen)
    optimizer = sae.make_optimizer(cfg)
    step = sae.make_train_step(cfg, optimizer)
    state = {"p": dictionary, "o": optimizer.init(dictionary), "s": sae.init_stats(cfg, dev)}

    def train_step():
        state["p"], state["o"], state["s"], _ = step(state["p"], state["o"], state["s"], rows)

    torch.cuda.reset_peak_memory_stats()
    timing = {"train_step_ms": event_ms(train_step), "extraction_ms_per_256_images": event_ms(
        lambda: extract_fn(params, raw, gen)), "rows": int(rows.shape[0]),
        "train_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    flops = 2.0 * BATCH_ROWS * 1024 * LATENTS
    timing["gemm_tflop_per_step"] = 9 * flops / 1e12  # encode, decode, AuxK decode; six backward products
    print(json.dumps({"train": timing}), flush=True)
    prof, wall = traced(train_step)
    print(json.dumps({"train_step_split": split(prof, wall)}), flush=True)
    prof, wall = traced(lambda: extract_fn(params, raw, gen))
    print(json.dumps({"extraction_split": split(prof, wall)}), flush=True)

    # 2. One SAE batch of the audit's collect half.
    wrapped = sae.SAESubjectModel(model, "layer3", sae.finalize_sae_params(state["p"], cfg), base_params=params)
    engine = CollectEngine(wrapped, ["layer3.sae"], labelled("aggregate + top-k update", aggregate_max_auto), 25,
                           input_preprocess=prep)
    states = {"layer3.sae": init_topk(LATENTS, 25, dev)}

    def audit_batch():
        with torch.inference_mode(), record_function("audit batch"):
            engine._step(states, wrapped.params, raw, 0, 2048)

    torch.cuda.reset_peak_memory_stats()
    audit = {"audit_batch_ms": event_ms(audit_batch), "rows": BATCH * 14 * 14,
             "audit_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
             "encode_tflop": 2.0 * BATCH * 196 * 1024 * LATENTS / 1e12}
    print(json.dumps({"audit": audit}), flush=True)
    prof, wall = traced(audit_batch)
    print(json.dumps({"audit_batch_split": split(prof, wall)}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
