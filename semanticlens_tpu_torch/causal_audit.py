"""Causal validation of collected concept evidence (ablate-and-measure).

Counterpart of the JAX package's ``tools/causal_audit.py``, with its flags,
defaults and JSON lines. For each audited component: collect its
top-activating evidence images (the Collect stage, ``aggregate_max_auto``
over float images in [0, 1]), zero-ablate the component, and compare the
output change on its OWN evidence with random control images —
:func:`semanticlens_tpu_torch.causal.necessity_ratio`. Ratios ≫ 1 certify
the component is causally load-bearing exactly where SemanticLens says it
fires; ratios ≈ 1 flag passenger correlations.

The subject's weights come from seed 0, in ``--dtype`` (float32 by
default); ``--arch`` takes every vision name of the JAX
``tools/bench_subject.py``: ResNet and its ResNeXt / Wide variants, ViT,
ConvNeXt, VGG, DenseNet, EfficientNet / V2, MobileNetV2 / V3, RegNet,
MNASNet, Swin / Swin-V2, GoogLeNet, Inception-v3, ShuffleNetV2, AlexNet,
SqueezeNet and MaxViT (224-multiple ``--image-size`` only). ``--layer`` keeps
the JAX tool's default, ``layer3``, which only the ResNets have: name a
layer of the family for the others (``--layer features.14``). One JSON line
per component, then a summary with the card's name as ``"device"``.

Usage:
  python -m semanticlens_tpu_torch.causal_audit --arch resnet --depth 18 --layer layer3 \\
      --components 8 --images 256 --image-size 96
  python -m semanticlens_tpu_torch.causal_audit --cpu ...   # the CPU (tests, small sizes)
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# The keys of the summary line, in the JAX tool's order (each component's line has "component" and
# "necessity_ratio").
REPORT_KEYS = ("layer", "mode", "components", "median_ratio", "min_ratio", "wall_s", "device")



def build_model(args, device):
    """The subject from ``--arch`` in the ``--dtype`` activation dtype, named as the JAX
    ``tools/bench_subject.py`` names it (``--depth 50`` stands for VGG-16 and DenseNet-121)."""
    from semanticlens_tpu_torch import models

    kw = {"dtype": getattr(torch, args.dtype), "device": device}
    constructors = {
        "resnet": lambda: models.ResNet(depth=args.depth, **kw),
        "vit": lambda: models.VisionTransformer(image_size=args.image_size, **kw),
        "convnext": lambda: models.ConvNeXt(variant=args.variant or "tiny", **kw),
        "vgg": lambda: models.VGG(depth=args.depth if args.depth != 50 else 16, **kw),
        "densenet": lambda: models.DenseNet(depth=args.depth if args.depth != 50 else 121, **kw),
        "efficientnet": lambda: models.EfficientNet(variant=args.variant or "b0", **kw),
        "efficientnet_v2": lambda: models.EfficientNetV2(variant=args.variant or "v2_s", **kw),
        "mobilenetv2": lambda: models.MobileNetV2(**kw),
        "mobilenetv3": lambda: models.MobileNetV3(variant=args.variant or "large", **kw),
        "resnext": lambda: models.ResNet(depth=args.depth, groups=32, width_per_group=8 if args.depth == 101 else 4,
                                         **kw),
        "wide_resnet": lambda: models.ResNet(depth=args.depth, width_per_group=128, **kw),
        "regnet": lambda: models.RegNet(variant=args.variant or "y_400mf", **kw),
        "mnasnet": lambda: models.MNASNet(variant=args.variant or "1_0", **kw),
        "swin": lambda: models.SwinTransformer(variant=args.variant or "tiny", **kw),
        "swin_v2": lambda: models.SwinTransformerV2(variant=args.variant or "tiny", **kw),
        "googlenet": lambda: models.GoogLeNet(**kw),
        "inception_v3": lambda: models.InceptionV3(**kw),
        "shufflenet": lambda: models.ShuffleNetV2(variant=args.variant or "x1_0", **kw),
        "alexnet": lambda: models.AlexNet(**kw),
        "squeezenet": lambda: models.SqueezeNet(version=args.variant or "1_0", **kw),
        "maxvit": lambda: models.MaxViT(variant=args.variant or "tiny", **kw),
    }
    if args.arch not in constructors:
        raise SystemExit(f"unknown arch {args.arch}")
    return constructors[args.arch]()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", default="resnet")
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--variant", default="")
    ap.add_argument("--layer", default="layer3")
    ap.add_argument("--components", type=int, default=8,
                    help="audit the N components with the strongest evidence")
    ap.add_argument("--evidence", type=int, default=8, help="evidence images per component")
    ap.add_argument("--images", type=int, default=256, help="synthetic dataset size")
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--mode", default="zero", choices=["zero", "mean"])
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="model activation dtype; float32 default — single-channel ablation deltas on a "
                         "bfloat16 model can fall below bf16 resolution and turn the ratios into rounding noise")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from semanticlens_tpu_torch import causal
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops.aggregators import aggregate_max_auto
    from semanticlens_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    model = build_model(args, device)
    model.params = model.init(seed=0)
    model.name = "causal-audit"

    rng = np.random.default_rng(0)
    images = rng.integers(
        0, 255, size=(args.images, args.image_size, args.image_size, 3), dtype=np.uint8
    ).astype(np.float32) / 255.0
    ds = ArrayDataset(images, name="causal-synthetic")

    cv = ActivationComponentVisualizer(
        model=model, dataset_model=ds, dataset_fm=ds,
        layer_names=[args.layer], num_samples=args.evidence,
        aggregate_fn=aggregate_max_auto, cache_dir=None,
    )
    t0 = time.perf_counter()
    cache = cv.run(batch_size=args.batch)
    act = cache[args.layer]
    strength = act.activations.to(torch.float32).numpy()[:, 0]  # strongest evidence
    comp_ids = np.argsort(-strength)[: args.components]

    ratios = []
    for comp in comp_ids:
        ev_ids = np.asarray(act.sample_ids[comp])
        ev_ids = ev_ids[ev_ids >= 0]
        if ev_ids.size == 0:
            ratios.append(None)
            continue
        control = rng.choice(args.images, size=ev_ids.size, replace=False)
        r = causal.necessity_ratio(
            model, model.params, args.layer, [int(comp)], images[ev_ids], images[control], mode=args.mode,
        )
        ratios.append(float(r[0]))
    wall = time.perf_counter() - t0

    live = [r for r in ratios if r is not None]
    for comp, r in zip(comp_ids.tolist(), ratios):
        print(json.dumps({"component": comp, "necessity_ratio": round(r, 3) if r is not None else None}))
    report = dict(zip(REPORT_KEYS, (
        args.layer, args.mode, len(comp_ids),
        round(float(np.median(live)), 3) if live else None,
        round(float(np.min(live)), 3) if live else None,
        round(wall, 2),
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
