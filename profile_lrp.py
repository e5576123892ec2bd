"""Where one 256-image LRP heatmap batch spends its device time, on one CUDA card.

    python3 profile_lrp.py

The config-4 attribution of ``chip_smoke.py`` ``[lrp]``: ResNet-50 bf16
(random weights from seed 0), layer3, ε-plus-flat, K = 32 components × 8
device-resident 224×224 images in one forward and one backward
(``relevance.make_batched_attribution_fn``), then the default render
(``utils.render.crop_and_mask_images``) of the 32 components' heatmaps.

Reports, after a warm-up batch:

1. the batch's time by CUDA events (attribution, render) and peak memory;
2. a ``torch.profiler`` trace of one batch: device time and kernel launches
   by category. Each kernel is classed by the op that launched it and the
   labelled region around that op: cuDNN convolution forward (the model's
   and the z⁺/flat rules' recomputation), backward-data convolutions (the
   rules' transposes), the rules' elementwise passes (stabilise, divide,
   multiply by the input), the residual splits, BN (its forward and its ε
   rule), blur and crop, and the rest (ReLU and max-pool backward, casts,
   the target and the channel sum).

The labels come from wrapping, in this script only, the rule Functions'
backwards and ``batch_norm``. Prints JSON lines; exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

sys.dont_write_bytecode = True

import torch  # noqa: E402

LABELS = ("lrp:bn", "lrp:residual", "lrp:rule", "render")
CONV_FORWARD_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution", "aten::conv2d")


def install_labels():
    """Wrap the rule backwards and BN in ``record_function`` regions (this process only)."""
    from torch.profiler import record_function

    from semanticlens_tpu_torch.models import layers, zoo

    rule_backward = layers._LrpRule.backward
    residual_backward = layers._ResidualSplit.backward
    batch_norm = layers.batch_norm

    def labelled_rule_backward(ctx, R):
        label = "lrp:bn" if getattr(ctx.rule_vjp, "is_bn", False) else "lrp:rule"
        with record_function(label):
            return rule_backward(ctx, R)

    def labelled_residual_backward(ctx, R):
        with record_function("lrp:residual"):
            return residual_backward(ctx, R)

    wrap = layers._lrp_wrap

    def bn_wrap(true_fwd, x, rule, eps, rule_fwd=None, rule_vjp=None):
        rule_vjp.is_bn = True
        return wrap(true_fwd, x, rule, eps, rule_fwd=rule_fwd, rule_vjp=rule_vjp)

    def labelled_batch_norm(*args, **kwargs):
        with record_function("lrp:bn"):
            layers._lrp_wrap = bn_wrap
            try:
                return batch_norm(*args, **kwargs)
            finally:
                layers._lrp_wrap = wrap

    layers._LrpRule.backward = staticmethod(labelled_rule_backward)
    layers._ResidualSplit.backward = staticmethod(labelled_residual_backward)
    zoo.batch_norm = labelled_batch_norm


def category(op_name: str, label: str | None) -> str:
    conv_forward = op_name in CONV_FORWARD_OPS
    if label == "render":
        return "blur and crop"
    if label == "lrp:residual":
        return "residual splits"
    if label == "lrp:bn":
        return "batch norm (forward and ε rule)"
    if op_name == "aten::convolution_backward":
        return "convolution backward-data"
    if conv_forward:
        return "convolution forward (model and z⁺/flat recomputation)"
    if label == "lrp:rule":
        return "rule elementwise passes"
    return "other (ReLU/max-pool backward, casts, target, channel sum)"


def label_of(event) -> str | None:
    e = event
    while e is not None:
        if e.name in LABELS:
            return e.name
        e = e.cpu_parent
    return None


def innermost_op(event) -> str:
    """The nearest ``aten::`` op at or above the launching event."""
    e = event
    while e is not None:
        if e.name.startswith("aten::"):
            return e.name
        e = e.cpu_parent
    return event.name


def main():
    if not torch.cuda.is_available():
        print("profile_lrp: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs
    from semanticlens_tpu_torch.collect.relevance_based import _Preprocessed
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.relevance import make_batched_attribution_fn
    from semanticlens_tpu_torch.utils.render import crop_and_mask_images

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    k, n_ref, size = 32, 8, 224
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    params = model.init(seed=0)
    install_labels()
    fn = make_batched_attribution_fn(_Preprocessed(model, cs.imagenet_preprocess), "layer3")
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.randint(0, 255, (k, n_ref, size, size, 3), generator=gen, device=dev, dtype=torch.uint8)
    comps = torch.arange(k, device=dev)

    def render(heat):
        with record_function("render"):
            return [crop_and_mask_images(raw[i], heat[i]) for i in range(k)]

    heat = fn(params, raw, comps)  # warm-up: cuDNN plans, allocator
    render(heat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    heat = fn(params, raw, comps)
    events[1].record()
    render(heat)
    events[2].record()
    torch.cuda.synchronize()
    timing = {"attribution_ms": events[0].elapsed_time(events[1]), "render_ms": events[1].elapsed_time(events[2]),
              "heatmaps": k * n_ref, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    timing["heatmaps_per_s_attribution"] = k * n_ref / timing["attribution_ms"] * 1e3
    print(json.dumps(timing), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(fn(params, raw, comps))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: dict[str, dict] = {}
    by_op: dict[tuple[str, str], dict] = {}
    for event in prof.events():
        for kernel in getattr(event, "kernels", []):
            op = innermost_op(event)
            cat = category(op, label_of(event))
            for row in (by_cat.setdefault(cat, {"ms": 0.0, "launches": 0}),
                        by_op.setdefault((cat, op), {"ms": 0.0, "launches": 0})):
                row["ms"] += kernel.duration / 1e3
                row["launches"] += 1
    device_ms = sum(r["ms"] for r in by_cat.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler linked no device kernel to an op; time with CUDA events instead")
    top = sorted((e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.key not in LABELS),
                 key=lambda e: e.self_device_time_total, reverse=True)[:12]
    print(json.dumps({
        "wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "launches": sum(r["launches"] for r in by_cat.values()),
        "by_category": {c: r | {"share": r["ms"] / device_ms}
                        for c, r in sorted(by_cat.items(), key=lambda kv: -kv[1]["ms"])},
        "top_ops": [{"category": c, "op": op} | r
                    for (c, op), r in sorted(by_op.items(), key=lambda kv: -kv[1]["ms"])[:16]],
        "top_kernels": [{"name": e.key[:90], "calls": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
