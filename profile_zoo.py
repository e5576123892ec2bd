"""Where a vision-zoo subject's forward spends its time on the card, cold and warm.

Run from the root of a checkout on a machine with one CUDA card:

    python3 profile_zoo.py

For each family of ``FAMILIES`` (bf16, seed-0 weights, the default
``full_audit`` taps requested), on one batch of 256 images at 224²: the
first forward in the process (cold: cuDNN's engine choice and the kernels'
first load for each new convolution shape included), then the mean of 10
warm forwards (CUDA events), images/s warm. Then one warm forward of each
family of ``PROFILED`` (ConvNeXt-Tiny, EfficientNet-B0, Swin-T, MaxViT-T)
under ``torch.profiler``: device time by kernel
category (``profile_port``'s categories, which split depthwise / grouped
convolutions from dense ones) and the launch count. Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from profile_port import _category

FAMILIES = [  # (label, full_audit argv)
    ("convnext_tiny", ["--arch", "convnext"]),
    ("efficientnet_b0", ["--arch", "efficientnet"]),
    ("efficientnet_v2_s", ["--arch", "efficientnet", "--variant", "v2_s"]),
    ("mobilenet_v2", ["--arch", "mobilenet"]),
    ("densenet121", ["--arch", "densenet"]),
    ("vgg16", ["--arch", "vgg"]),
    ("resnet50d", ["--variant", "d"]),
    ("regnet_y_400mf", ["--arch", "regnet"]),
    ("swin_t", ["--arch", "swin"]),
    ("swin_v2_t", ["--arch", "swin_v2"]),
    ("maxvit_t", ["--arch", "maxvit"]),
    ("googlenet", ["--arch", "inception"]),
    ("inception_v3", ["--arch", "inception", "--variant", "v3"]),
    ("shufflenet_v2_x1_0", ["--arch", "shufflenet"]),
    ("alexnet", ["--arch", "alexnet"]),
    ("squeezenet1_0", ["--arch", "squeezenet"]),
]
PROFILED = ("convnext_tiny", "efficientnet_b0", "swin_t", "maxvit_t")
BATCH, SIZE, WARM = 256, 224, 10


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_zoo: no CUDA device is available", file=sys.stderr)
        return 2
    from semanticlens_tpu_torch import full_audit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x = torch.rand(BATCH, SIZE, SIZE, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    out = {"batch": BATCH, "size": SIZE, "families": {}, "profiles": {}}
    models = {}
    for label, argv in FAMILIES:
        model, layers, _ = full_audit._zoo_model(full_audit.parse_args(argv), dev)
        params = model.init(seed=0)
        models[label] = (model, params, layers)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.apply(params, x, layers)
            torch.cuda.synchronize()
            cold_ms = (time.perf_counter() - t) * 1e3
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(WARM):
                model.apply(params, x, layers)
            end.record()
            torch.cuda.synchronize()
            warm_ms = start.elapsed_time(end) / WARM
        out["families"][label] = {"cold_first_forward_ms": cold_ms, "warm_ms": warm_ms,
                                  "images_per_s_warm": BATCH / warm_ms * 1e3,
                                  "weights": sum(v.numel() for v in params.values())}
    for label in PROFILED:
        model, params, layers = models[label]
        with torch.inference_mode(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.apply(params, x, layers)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        by_cat = {}
        for e in kernels:
            by_cat[_category(e.key)] = by_cat.get(_category(e.key), 0.0) + e.self_device_time_total / 1e3
        total, launches = sum(by_cat.values()), sum(e.count for e in kernels)
        top = [(e.key[:80], e.count, e.self_device_time_total / 1e3)
               for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]]
        out["profiles"][label] = {"device_ms": total, "launches": launches, "by_category_ms": by_cat,
                                  "top_kernels_ms": top}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out["card"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
