"""Where the time of the port's fused Collect+Embed pass goes, on one CUDA card.

    python3 profile_port.py

Builds the quickstart configuration of ``chip_smoke.py`` (ResNet-50 bf16
tapping layer3/layer4 and OpenCLIP ViT-B/32 bf16, random weights from seed
0, 2048 synthetic 256×256 uint8 images, batch 256) and reports, all on
device-resident data after a warm-up pass:

1. per-stage device time of one batch by CUDA events: subject preprocess,
   ResNet-50 forward with taps, aggregation + top-k merge, FM preprocess,
   ViT-B/32 image tower;
2. a ``torch.profiler`` trace of one whole warm fused pass: device time by
   kernel category and the top kernels, and the busy share of the pass's
   wall time (compute kernels; the side-stream uploads overlap them).

Prints JSON lines; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

sys.dont_write_bytecode = True

import torch  # noqa: E402

_CATEGORIES = (  # first match wins; matched against lower-cased kernel names
    ("attention", ("flash", "fmha", "attention", "softmax")),
    ("batch norm", ("batch_norm",)),
    ("layer norm", ("layer_norm",)),
    ("sort/top-k", ("sort", "radix", "gather", "scatter")),
    ("resize", ("upsample", "bicubic", "interp")),
    ("conv depthwise/grouped", ("c1_k1", "depthwise", "dwconv", "grouped")),  # cuDNN's depthwise: conv2d_c1_k1_*
    ("conv", ("conv", "implicit", "cudnn", "nhwc", "wgrad", "dgrad")),
    ("gemm", ("gemm", "cutlass", "nvjet", "sm90_xmma", "matmul", "cublas")),
    ("copy/cast", ("direct_copy", "copy_kernel")),
    ("memcpy", ("memcpy", "memset")),
    ("reduce", ("reduce", "mean", "sum")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other elementwise"


def main():
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.ops.topk import init_topk, topk_update
    from semanticlens_tpu_torch.utils import make_preprocess_fn
    from semanticlens_tpu_torch.collect.engine import CollectEngine

    dev = torch.device("cuda")
    n_images, batch = 2048, 256
    images = cs._make_images(n_images, seed=0)
    model = ResNet(depth=50, dtype=torch.bfloat16, device=dev)
    params = model.init(seed=0)
    fm = OpenClip("ViT-B-32", dtype=torch.bfloat16, device=dev, seed=0)
    preprocess = make_preprocess_fn(size=224)
    layers = ("layer3", "layer4")
    engine = CollectEngine(model, layers, aggregate_conv_mean, 25, input_preprocess=preprocess)
    dataset = ArrayDataset(images)

    def embed_fn(raw):
        return fm.encode_image(fm.preprocess(raw))

    # 1. Per-stage device time of one batch (device-resident input).
    raw = torch.from_numpy(images[:batch]).to(dev)
    with torch.inference_mode():
        x = preprocess(raw)
        _, taps = model.apply(params, x, layers)
        states = {k: init_topk(int(v.shape[-1]), 25, dev) for k, v in taps.items()}
        ids = torch.arange(batch, dtype=torch.int32, device=dev)
        xf = fm.preprocess(raw)

        def aggregate_merge():
            for k in layers:
                topk_update(states[k], aggregate_conv_mean(taps[k]).float(), ids)

        stages = {
            "subject_preprocess": lambda: preprocess(raw),
            "resnet50_forward": lambda: model.apply(params, x, layers),
            "aggregate_topk": aggregate_merge,
            "fm_preprocess": lambda: fm.preprocess(raw),
            "vit_b32_image_tower": lambda: fm.encode_image(xf),
        }
        stage_ms = {k: cs.time_ms(fn, iters=10, warmup=2) for k, fn in stages.items()}
    total = sum(stage_ms.values())
    print(json.dumps({"per_batch_ms": stage_ms, "batch": batch, "sum_ms": total,
                      "images_per_s_device_bound": batch / total * 1e3}), flush=True)

    # 2. One warm fused pass under the profiler.
    engine.run_fused(params, dataset, batch, embed_fn)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_fused(params, dataset, batch, embed_fn)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    by_cat: dict[str, float] = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    # Uploads run on a side stream and overlap compute: the busy share counts
    # the compute stream's kernels only.
    compute_ms = device_us / 1e3 - by_cat.get("memcpy", 0.0)
    print(json.dumps({
        "pass_wall_s": wall_s,
        "images_per_s": n_images / wall_s,
        "device_kernel_ms": device_us / 1e3,
        "device_busy_share": compute_ms / 1e3 / wall_s,
        "ms_by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "calls": e.count, "ms": e.self_device_time_total / 1e3}
                        for e in top],
    }), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
