"""Train a sparse autoencoder on a subject-model layer; report throughput.

Counterpart of the JAX package's ``tools/train_sae.py``, with its flags,
defaults and JSON keys: ``train_sae_on_layer`` streams the tap's rows on the
card (positions sampled per image) and steps the optimizer on them, then
one JSON line reports wall-clock, optimizer steps/s, activation rows/s and
images/s, the final loss, fvu and l0, the dead-latent count and the device
(the card's name). The subject's weights come from seed 0; ``--data`` reads
a JPEG ``ImageFolder`` (decoded on the card), else 2048 synthetic uint8
images from seed 0. ``--out`` writes the dictionary as the JAX tool's
``.npz`` (``convert.save_sae_npz``).

Usage:
  python -m semanticlens_tpu_torch.train_sae --arch resnet --depth 50 --layer layer3 \\
      --latents 8192 --k 32 --images 2048 --epochs 1
  python -m semanticlens_tpu_torch.train_sae --data /path/to/imagefolder --layer layer3 --out sae.npz
  python -m semanticlens_tpu_torch.train_sae --cpu ...   # the CPU (tests, small sizes)
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

ARCHES = ("resnet", "vit")
# The keys of the JSON line, in the JAX tool's order.
REPORT_KEYS = ("layer", "d_in", "latents", "k", "jumprelu", "steps", "rows_per_step", "wall_s", "steps_per_s",
               "rows_per_s", "imgs_per_s", "final_loss", "final_fvu", "l0", "dead_latents", "device")


def build_model(args, device):
    """The subject in bf16 from ``--arch`` (the families the port has)."""
    from semanticlens_tpu_torch.models import ResNet, VisionTransformer

    if args.arch == "resnet":
        return ResNet(depth=args.depth, dtype=torch.bfloat16, device=device)
    return VisionTransformer(image_size=args.image_size, dtype=torch.bfloat16, device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet", choices=ARCHES)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--variant", default="", help="accepted for the JAX tool's command lines; unused")
    ap.add_argument("--layer", default="layer3")
    ap.add_argument("--latents", type=int, default=8192)
    ap.add_argument("--k", type=int, default=32, help="TopK sparsity; 0 = ReLU+L1")
    ap.add_argument("--aux-k", type=int, default=256)
    ap.add_argument("--jumprelu", action="store_true",
                    help="JumpReLU flavour (requires --k 0): learned per-latent thresholds, "
                         "mse + l0_coef*L0 with STE gradients")
    ap.add_argument("--l0-coef", type=float, default=6e-4)
    ap.add_argument("--ste-eps", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=256, help="images per extraction batch")
    ap.add_argument("--batch-rows", type=int, default=4096, help="rows per optimizer step")
    ap.add_argument("--positions", type=int, default=16, help="positions sampled per image")
    ap.add_argument("--images", type=int, default=2048, help="synthetic dataset size")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--data", default="", help="ImageFolder root (synthetic data if unset)")
    ap.add_argument("--out", default="", help="write trained params as .npz")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from semanticlens_tpu_torch import convert
    from semanticlens_tpu_torch.data import ArrayDataset, ImageFolder
    from semanticlens_tpu_torch.sae import SAEConfig, train_sae_on_layer
    from semanticlens_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    model = build_model(args, device)
    params = model.init(seed=0)
    if args.data:
        ds = ImageFolder(args.data, image_size=args.image_size, device=device)
    else:
        rng = np.random.default_rng(0)
        ds = ArrayDataset(rng.integers(0, 255, size=(args.images, args.image_size, args.image_size, 3),
                                       dtype=np.uint8), name="synthetic")

    def prep(x):
        return x.to(torch.bfloat16) / 255.0

    with torch.no_grad():  # the layer's width from a one-image forward
        probe = torch.zeros((1, args.image_size, args.image_size, 3), dtype=torch.uint8, device=device)
        d_in = int(model.apply(params, prep(probe), (args.layer,))[1][args.layer].shape[-1])
    cfg = SAEConfig(
        d_in=d_in, n_latents=args.latents, k=args.k, aux_k=args.aux_k if args.k else 0, lr=args.lr,
        jumprelu=args.jumprelu, l0_coef=args.l0_coef, ste_eps=args.ste_eps,
        batch_rows=args.batch_rows, positions_per_image=args.positions, seed=0,
    )
    t0 = time.perf_counter()
    sae_params, stats, metrics = train_sae_on_layer(model, params, ds, args.layer, cfg, batch_size=args.batch,
                                                    epochs=args.epochs, input_preprocess=prep)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    steps = int(stats["step"])
    dead = int((stats["last_fired"] >= cfg.dead_steps).sum())
    if args.out:
        convert.save_sae_npz(args.out, sae_params)
    report = {
        "layer": args.layer, "d_in": d_in, "latents": args.latents, "k": args.k,
        "jumprelu": args.jumprelu,
        "steps": steps, "rows_per_step": cfg.batch_rows,
        "wall_s": round(wall, 2),
        "steps_per_s": round(steps / wall, 2),
        "rows_per_s": round(steps * cfg.batch_rows / wall, 1),
        "imgs_per_s": round(args.epochs * (len(ds) // args.batch) * args.batch / wall, 1),
        "final_loss": metrics["loss"], "final_fvu": metrics["fvu"],
        "l0": metrics["l0"], "dead_latents": dead,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
