"""Full model audit (BASELINE config 5): all-layer concept DB + scores + search.

Counterpart of the JAX package's ``tools/full_audit.py``, with its flags,
defaults, stages and JSON report keys, on one CUDA card:

1. Collect + Embed (the fused single pass) over every requested layer;
2. clarity / redundancy / polysemanticity per layer, and the
   null-calibrated polysemanticity index when the embedding table exists;
3. text search (top component per query) and the exact top-5 per query
   over every layer's bank (``topk_cosine_search``);
4. class composition of the top-k evidence when the dataset has labels,
   image probing (``--image-query-indices``) and component labels over
   ``--vocabulary`` (cosine or soft-WPMI, 16 components per layer);
5. the seconds and items/s of each stage (``report["stages"]``).

One JSON line reports it, with exactly the JAX tool's keys
(:data:`REPORT_KEYS`); the card's name goes to the log. Weights are random
from seed 0 unless ``--model-checkpoint`` (a torchvision/timm ``.pt`` state
dict) or ``--checkpoint`` (the foundation model's) is given — the systems
path is the same either way.

Every ``--arch`` of the JAX tool runs, each with its default layers and
model name: ``resnet`` (variants ``''``, ``d``, ``x``, ``wide``), ``vit``,
``convnext``, ``vgg``, ``densenet``, ``efficientnet`` (``b0``…``b7``,
``v2_s``/``v2_m``/``v2_l``), ``mobilenet`` (``v2``, ``large``, ``small``),
``mnasnet``, ``regnet``, ``swin`` / ``swin_v2`` (``tiny``, ``small``,
``base``), ``maxvit``, ``inception`` (``v1`` GoogLeNet, ``v3``),
``shufflenet`` (``x0_5``…``x2_0``), ``alexnet`` and ``squeezenet``
(``1_0``, ``1_1``).

Over several cards it runs one process per card:
``torchrun --nproc-per-node N python -m semanticlens_tpu_torch.full_audit …``
starts NCCL (gloo with ``--cpu``), builds ``core.data_mesh()`` and passes
it to the visualizer (each rank sweeps its rows of every batch) and the
foundation model; clarity and polysemanticity run on a
``core.shard_concept_db`` of the concept DB, the rest whole on every rank,
and rank 0 prints the report, whose ``"mesh"`` is ``{"data": N}``.
``--no-mesh`` keeps one card; several cards without ``torchrun`` raise.
``--cpu`` (the one flag the JAX tool lacks: it takes its backend from
``JAX_PLATFORMS``) runs on the CPU.

Usage:
  python -m semanticlens_tpu_torch.full_audit [--images /path.npy | --image-dir DIR]
      [--arch resnet|vit|convnext|vgg|densenet|efficientnet|mobilenet|inception|swin|regnet|shufflenet|alexnet|
              squeezenet|mnasnet|swin_v2|maxvit] [--variant V]
      [--depth 50] [--layers layer1 ... | blocks.N.mlp ...]
      [--n-samples 25] [--batch 256] [--queries dog "striped pattern"]
      [--vocabulary dog cat ...] [--label-scoring cosine|wpmi]
      [--fm ViT-B-32|siglip2|mobileclip-s1] [--checkpoint ckpt.safetensors]
      [--bpe merges.gz] [--cache-dir cache] [--no-mesh] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("semanticlens_tpu_torch.full_audit")

RESNET_LAYERS = ["layer1", "layer2", "layer3", "layer4"]
# The JAX tool's --arch choices, in its order.
ARCHES = ("resnet", "vit", "convnext", "vgg", "densenet", "efficientnet", "mobilenet", "inception", "swin", "regnet",
          "shufflenet", "alexnet", "squeezenet", "mnasnet", "swin_v2", "maxvit")
# The keys of the JSON report, in the JAX tool's order.
REPORT_KEYS = ("dataset", "n_images", "layers", "mesh", "db_shapes", "scores", "top_neuron_per_query",
               "top5_per_query", "component_labels", "image_probe_top_neuron", "class_selective_components",
               "stages")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", default=None, help=".npy uint8 (N,H,W,3)")
    ap.add_argument("--image-dir", default=None)
    ap.add_argument("--n-synthetic", type=int, default=1024)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--arch", default="resnet", choices=list(ARCHES))
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--variant", default="",
                    help="resnet: '' (torchvision), 'd' (timm resnet*d), 'x' (resnext 32x4d/32x8d), or 'wide' "
                         "(wide_resnet*_2); convnext: tiny/small/base/large; efficientnet: b0..b7 or v2_s/v2_m/v2_l; "
                         "mobilenet: v2/large/small; mnasnet: 0_5/0_75/1_0/1_3; regnet: y_400mf, x_3_2gf, ...; "
                         "swin/swin_v2: tiny/small/base; inception: v1/v3; shufflenet: x0_5/x1_0/x1_5/x2_0; "
                         "squeezenet: 1_0/1_1")
    ap.add_argument("--layers", nargs="*", default=list(RESNET_LAYERS))
    ap.add_argument("--n-samples", type=int, default=25)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--queries", nargs="*", default=["dog", "car wheel", "striped pattern"])
    ap.add_argument("--label-scoring", default="cosine", choices=["cosine", "wpmi"],
                    help="component naming score: mean-vector cosine or CLIP-Dissect soft-WPMI "
                         "over each component's top-activating images")
    ap.add_argument("--vocabulary", nargs="*", default=[],
                    help="words for CLIP-Dissect-style component naming (label_components)")
    ap.add_argument("--image-query-indices", nargs="*", type=int, default=[],
                    help="dataset indices used as image-probing queries (reference image_probing)")
    ap.add_argument("--fm", default="ViT-B-32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--model-checkpoint", default=None,
                    help="subject-model state dict (.pt) per --arch: torchvision (timm for ResNet-D, ViT-B and "
                         "ConvNeXt)")
    ap.add_argument("--bpe", default=None)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap


def parse_args(argv=None):
    """The JAX tool's arguments and checks."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.arch not in ("resnet", "vgg", "densenet") and args.depth != 50:
        ap.error("--depth configures --arch resnet/vgg/densenet only")
    if args.arch == "vit" and args.variant:
        ap.error(
            "--variant configures --arch resnet (timm *d), convnext (tiny/small/base), "
            "efficientnet (b0..b7), or mobilenet (v2/large/small)"
        )
    if args.arch == "resnet" and args.variant not in ("", "d", "x", "wide"):
        ap.error("--arch resnet supports --variant ''/d/x/wide")
    if args.arch == "vgg" and args.depth not in (11, 13, 16, 19, 50):
        ap.error(f"--arch vgg supports --depth 11/13/16/19, got {args.depth}")
    if args.arch == "densenet" and args.depth not in (121, 161, 169, 201, 50):
        ap.error(f"--arch densenet supports --depth 121/161/169/201, got {args.depth}")
    if args.arch == "mobilenet" and args.variant not in ("", "v2", "large", "small"):
        ap.error("--arch mobilenet supports --variant v2/large/small")
    if args.arch == "inception" and args.variant not in ("", "v1", "v3"):
        ap.error("--arch inception supports --variant v1/v3")
    return args


def _zoo_model(args, device):
    """``(model, default layers, model name)`` of ``--arch``/``--variant``/``--depth`` as the JAX tool builds them
    (``tools/full_audit.py``); depth 50, the resnet default, stands for each family's own default."""
    from semanticlens_tpu_torch import models

    kw = {"dtype": torch.bfloat16, "device": device}
    if args.arch == "convnext":
        model = models.ConvNeXt(variant=args.variant or "tiny", **kw)
        return model, [f"stages.{i}" for i in range(4)], f"convnext-{model.variant}-audit"
    if args.arch == "vgg":
        depth = args.depth if args.depth != 50 else 16
        stage_last = {11: [0, 3, 8, 13, 18], 13: [2, 7, 12, 17, 22], 16: [2, 7, 14, 21, 28],
                      19: [2, 7, 16, 25, 34]}[depth]  # the last conv of each stage
        return models.VGG(depth=depth, **kw), [f"features.{i}" for i in stage_last[1:]], f"vgg{depth}-audit"
    if args.arch == "efficientnet":
        variant = args.variant or "b0"
        if variant.startswith("v2"):
            model = models.EfficientNetV2(variant=variant, **kw)
            n_stages = len(model.stages)
            layers = [f"features.{i}" for i in (2, 3, n_stages - 1, n_stages)]
        else:
            model = models.EfficientNet(variant=variant, **kw)
            layers = [f"features.{i}" for i in (2, 4, 6, 8)]
        return model, layers, f"efficientnet-{model.variant}-audit"
    if args.arch == "mobilenet":
        variant = args.variant or "v2"
        if variant == "v2":
            model, stage_taps = models.MobileNetV2(**kw), (4, 7, 14, 18)  # the last block of each stride stage
        else:
            model = models.MobileNetV3(variant=variant, **kw)
            stage_taps = (4, 7, 13, 16) if variant == "large" else (2, 4, 9, 12)
        return model, [f"features.{i}" for i in stage_taps], f"mobilenet-{variant}-audit"
    if args.arch == "regnet":
        model = models.RegNet(variant=args.variant or "y_400mf", **kw)
        return model, [f"trunk_output.block{i}" for i in range(1, 5)], f"regnet_{model.variant}-audit"
    if args.arch == "mnasnet":
        model = models.MNASNet(variant=args.variant or "1_0", **kw)
        return model, ["layers.9", "layers.10", "layers.12", "layers.13"], f"mnasnet{model.variant}-audit"
    if args.arch in ("swin", "swin_v2"):
        cls = models.SwinTransformerV2 if args.arch == "swin_v2" else models.SwinTransformer
        model = cls(variant=args.variant or "tiny", **kw)
        return model, [f"features.{i}" for i in (1, 3, 5, 7)], f"{args.arch}-{model.variant}-audit"
    if args.arch == "inception":
        if (args.variant or "v1") == "v1":
            return (models.GoogLeNet(**kw), ["inception3b", "inception4c", "inception4e", "inception5b"],
                    "googlenet-audit")
        return models.InceptionV3(**kw), ["Mixed_5d", "Mixed_6b", "Mixed_6e", "Mixed_7c"], "inception_v3-audit"
    if args.arch == "shufflenet":
        model = models.ShuffleNetV2(variant=args.variant or "x1_0", **kw)
        return model, ["stage2", "stage3", "stage4", "conv5"], f"shufflenet_v2_{model.variant}-audit"
    if args.arch == "maxvit":
        model = models.MaxViT(variant=args.variant or "tiny", **kw)
        return model, [f"blocks.{i}" for i in range(4)], f"maxvit_{model.variant}-audit"
    if args.arch == "alexnet":
        return models.AlexNet(**kw), ["features.4", "features.7", "features.9", "features.12"], "alexnet-audit"
    if args.arch == "squeezenet":  # fire-module outputs present in both versions' plans
        model = models.SqueezeNet(version=args.variant or "1_0", **kw)
        return model, ["features.4", "features.7", "features.10", "features.12"], f"squeezenet{model.version}-audit"
    if args.arch == "densenet":
        depth = args.depth if args.depth != 50 else 121
        return (models.DenseNet(depth=depth, **kw), [f"features.denseblock{i}" for i in range(1, 5)],
                f"densenet{depth}-audit")
    if args.variant in ("", "d"):
        model = models.ResNet(depth=args.depth, variant=args.variant, **kw)
        return model, RESNET_LAYERS, f"resnet{args.depth}{args.variant}-audit"
    if args.variant == "x":  # torchvision resnext{50_32x4d,101_32x8d}
        width = 8 if args.depth == 101 else 4
        model = models.ResNet(depth=args.depth, groups=32, width_per_group=width, **kw)
        return model, RESNET_LAYERS, f"resnext{args.depth}_32x{width}d-audit"
    model = models.ResNet(depth=args.depth, width_per_group=128, **kw)  # torchvision wide_resnet{50,101}_2
    return model, RESNET_LAYERS, f"wide_resnet{args.depth}_2-audit"


def build_model(args, device):
    """``(model, aggregate_fn)``: the bf16 subject named as the JAX tool names it, weights from seed 0
    or ``--model-checkpoint``. Left at the ResNet default, ``--layers`` becomes the family's default
    (the ViT's ``blocks.{0,3,6,9}.mlp``). Every family's taps are (B, H, W, C), Swin's and MaxViT's too."""
    from semanticlens_tpu_torch.models import VisionTransformer
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean, aggregate_transformer_mean

    if args.arch == "vit":
        model = VisionTransformer(image_size=args.image_size, dtype=torch.bfloat16, device=device)
        layers = [f"blocks.{i}.mlp" for i in range(0, model.depth, 3)]
        aggregate_fn = aggregate_transformer_mean
        model.name = f"vitb{args.image_size // model.grid}-audit"
    else:
        model, layers, model.name = _zoo_model(args, device)
        aggregate_fn = aggregate_conv_mean
    if args.layers == RESNET_LAYERS:
        args.layers = list(layers)
    if args.model_checkpoint:
        model.params = model.load_torch_state_dict(torch.load(args.model_checkpoint, map_location="cpu"))
    else:
        model.params = model.init(seed=0)
    return model, aggregate_fn


def build_fm(args, device):
    """The foundation model in bf16 from ``--fm`` (``create``), random from seed 0 without ``--checkpoint``,
    on the run's mesh (``args.mesh``, set by :func:`main`)."""
    from semanticlens_tpu_torch.foundation_models import create

    return create(args.fm, checkpoint=args.checkpoint, bpe_path=args.bpe, dtype=torch.bfloat16, device=device,
                  mesh=getattr(args, "mesh", None))


def setup_mesh(args, device):
    """``(device, mesh)``: under ``torchrun`` (``WORLD_SIZE`` > 1) this rank's device and a data mesh over
    the ranks; else the device as given and no mesh. Several cards without ``torchrun`` raise."""
    if args.no_mesh:
        return device, None
    from semanticlens_tpu_torch.core import data_mesh, init_distributed

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = init_distributed("gloo" if args.cpu else "nccl")
        return device, data_mesh()
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise SystemExit(f"{n} cards: start one process per card, `torchrun --nproc-per-node {n} python -m "
                         "semanticlens_tpu_torch.full_audit ...`, or pass --no-mesh to audit on one")
    return device, None


def load_dataset(args, device):
    from semanticlens_tpu_torch.data import ArrayDataset, ImageFolder

    if args.image_dir:
        return ImageFolder(args.image_dir, image_size=args.image_size, device=device)
    if args.images:
        return ArrayDataset(np.load(args.images), name=str(args.images))
    rng = np.random.default_rng(0)
    return ArrayDataset(
        rng.integers(0, 255, size=(args.n_synthetic, args.image_size, args.image_size, 3), dtype=np.uint8),
        name="synthetic-audit",
    )


def main(argv=None) -> dict:
    args = parse_args(argv)
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.core import shard_concept_db
    from semanticlens_tpu_torch.core.mesh import is_writer
    from semanticlens_tpu_torch.data.dataset import get_image
    from semanticlens_tpu_torch.scores import (
        class_composition,
        null_calibrated_polysemanticity,
        topk_cosine_search,
    )
    from semanticlens_tpu_torch.utils import StageTimer, make_preprocess_fn, setup_colored_logging
    from semanticlens_tpu_torch.utils.device import resolve_device

    setup_colored_logging("INFO")
    device, mesh = setup_mesh(args, resolve_device("cpu" if args.cpu else None))
    args.mesh = mesh
    logger.info("full audit on %s", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    timer = StageTimer()

    # --- data and models ---------------------------------------------------------
    dataset = load_dataset(args, device)
    n = len(dataset)
    model, aggregate_fn = build_model(args, device)
    fm = build_fm(args, device)
    lens = Lens(fm)
    cv = ActivationComponentVisualizer(
        model=model,
        dataset_model=dataset,
        dataset_fm=dataset,
        layer_names=list(args.layers),
        num_samples=args.n_samples,
        aggregate_fn=aggregate_fn,
        model_preprocess=make_preprocess_fn(size=args.image_size, crop=args.image_size),
        cache_dir=args.cache_dir,
        mesh=mesh,
    )

    # --- pipeline ----------------------------------------------------------------
    with timer.stage("collect+embed", items=n):
        concept_db = lens.compute_concept_db(cv, batch_size=args.batch)

    agg_db = {k: np.asarray(v).mean(1) for k, v in concept_db.items()}

    scores_out = {}
    with timer.stage("scores"):
        # component-sharded under a mesh: each rank scores its components, the scores are gathered
        scored_db = concept_db if mesh is None else shard_concept_db(concept_db, mesh)
        clarity = lens.eval_clarity(scored_db)
        redundancy = lens.eval_redundancy(agg_db)
        poly = lens.eval_polysemanticity(scored_db)
        for layer in args.layers:
            # null-calibrated index (arXiv:2508.16950); the embedding table exists only when the
            # embed stage ran in this process (a concept-DB cache hit skips it)
            scored = {
                "clarity_mean": float(clarity[layer].mean()),
                "redundancy": float(redundancy[layer]),
                "polysemanticity_mean": float(poly[layer].mean()),
            }
            if cv.embedding_table is not None:
                npi, _, _, _ = null_calibrated_polysemanticity(concept_db[layer], cv.embedding_table,
                                                               device=lens.device)
                scored["npi_mean"] = float(np.nanmean(npi))
            scores_out[layer] = scored

    search_out = {}
    with timer.stage("text-search"):
        hits = lens.text_probing(list(args.queries), agg_db, templates=["a photo of a {}"])
        for layer, sim in hits.items():
            search_out[layer] = {q: int(sim[i].argmax()) for i, q in enumerate(args.queries)}

    # exact top-5 per query over every layer's bank (the memory-bounded streaming search)
    top5 = {}
    with timer.stage("topk-search"):
        with torch.inference_mode():
            queries = fm.encode_text(fm.tokenize(list(args.queries))).float()
        for layer, bank in agg_db.items():
            k = min(5, bank.shape[0])
            _vals, idx = topk_cosine_search(queries, bank, k=k)
            top5[layer] = {q: idx[i].tolist() for i, q in enumerate(args.queries)}

    # class composition (crp Statistics analogue) when the dataset has labels
    class_stats_out = {}
    dataset_labels = getattr(dataset, "labels", None)
    if dataset_labels is None and hasattr(dataset, "samples"):
        dataset_labels = np.asarray([lab for _p, lab in dataset.samples])
    if dataset_labels is not None and np.asarray(dataset_labels).max() > 0:
        with timer.stage("class-composition"):
            for layer in args.layers:
                ids = cv.get_max_reference(layer)  # (C, k) top sample ids
                counts, purity = class_composition(ids, np.asarray(dataset_labels))
                # A component backed by one sample has purity 1.0 trivially: require half the
                # top-k slots filled before calling it class-selective, then rank by (purity, evidence).
                evidence = counts.sum(axis=1)
                eligible = evidence >= max(2, args.n_samples // 2)
                ranked = np.lexsort((-evidence, -np.where(eligible, purity, -1.0)))[:8]
                class_stats_out[layer] = {
                    str(int(i)): {
                        "purity": round(float(purity[i]), 4),
                        "evidence": int(evidence[i]),
                        "top_class": int(counts[i].argmax()),
                    }
                    for i in ranked
                    if eligible[i]
                }

    image_probe_out = {}
    if args.image_query_indices:
        with timer.stage("image-probing"):
            query_images = np.stack([get_image(dataset, i) for i in args.image_query_indices])
            hits = lens.image_probing(query_images, agg_db)
            for layer, sim in hits.items():
                image_probe_out[layer] = int(np.asarray(sim).argmax())

    labels_out = {}
    if args.vocabulary:
        # CLIP-Dissect-style naming (arXiv:2204.10965), reported for the first 16 components per layer
        label_kwargs = {}
        if args.label_scoring == "wpmi":
            table = cv.embedding_table
            if table is None:
                raise SystemExit(
                    "--label-scoring wpmi needs the dataset embedding table; "
                    "rerun without a warm concept-db cache (the fused sweep "
                    "retains it) or use cosine scoring"
                )
            label_kwargs = {
                "scoring": "wpmi",
                "evidence_ids": {layer: cv.get_max_reference(layer) for layer in args.layers},
                "image_embeds": table,
            }
        with timer.stage("label-components"):
            named = lens.label_components(
                list(args.vocabulary), agg_db, top_m=1, templates=["a photo of a {}"], **label_kwargs,
            )
            for layer, (words, vals) in named.items():
                labels_out[layer] = {
                    str(i): {"word": words[i][0], "score": float(vals[i][0])}
                    for i in range(min(len(words), 16))
                }

    report = {
        "dataset": getattr(dataset, "name", "?"),
        "n_images": n,
        "layers": list(args.layers),
        "mesh": None if mesh is None else {"data": mesh.size()},
        "db_shapes": {k: list(np.asarray(v).shape) for k, v in concept_db.items()},
        "scores": scores_out,
        "top_neuron_per_query": search_out,
        "top5_per_query": top5,
        "component_labels": labels_out,
        "image_probe_top_neuron": image_probe_out,
        "class_selective_components": class_stats_out,
        "stages": timer.summary(),
    }
    if is_writer(mesh):
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
