"""Rank bodies for the port's multi-process CPU tests (``tests/test_torch_mesh*.py``).

Each function runs in its own process, started by
``semanticlens_tpu_torch.parallel.launch.spawn`` over a gloo group on the
CPU, and writes what it computed to ``out`` for the test to compare with
the JAX package. This module imports torch and the port only (the ranks
never import JAX); the tests import its models and constants.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector

W_CONV = np.random.default_rng(0).normal(size=(1, 1, 3, 6)).astype(np.float32)  # HWIO
IMAGES = np.random.default_rng(1).normal(size=(40, 8, 8, 3)).astype(np.float32)
PROJ = np.random.default_rng(5).normal(size=(3, 7)).astype(np.float32)
N_SWEEP, BATCH = 22, 4  # 22 rows: the last global batch is padded
CKPT_ROWS = 24  # a sweep over the first 24 rows at batch 8 leaves a checkpoint at next_start 24
TOKENS = np.random.default_rng(3).integers(1, 61, size=(12, 8)).astype(np.int64)
LM_LAYERS = {"llama": ["model.layers.1.mlp.act_fn", "model.layers.0.self_attn.heads"],
             "gemma2": ["model.layers.1.mlp.act_fn", "model.layers.0.self_attn.heads"],
             "gpt2": ["transformer.h.1.mlp.act", "transformer.h.0.attn.heads"]}


class OneConv(SubjectModel):
    """A 1×1 conv with 6 output channels, tapped as ``c`` (NHWC)."""

    module_names = ("c",)
    device = torch.device("cpu")
    name = "one-conv"

    def apply(self, params, x, tap_names=()):
        tap = TapCollector(tap_names)
        return tap("c", F.conv2d(x.permute(0, 3, 1, 2), params["w"]).permute(0, 2, 3, 1)), tap.taps


CONV_PARAMS = {"w": torch.from_numpy(W_CONV.transpose(3, 2, 0, 1).copy())}


def embed(batch):
    return batch.float().mean(dim=(1, 2)) @ torch.from_numpy(PROJ)


class FakeVLM:
    """A deterministic stand-in foundation model: mean pixel projected to 7 dims."""

    name = "fake-vlm"
    device = torch.device("cpu")

    def preprocess(self, img):
        return torch.as_tensor(img).float()

    def encode_image(self, img):
        return embed(img)


def conv_engine(mesh=None):
    from semanticlens_tpu_torch.collect.engine import CollectEngine
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean

    return CollectEngine(OneConv(), ("c",), aggregate_conv_mean, 5, mesh=mesh)


def _states(prefix: str, states) -> dict:
    out = {}
    for name, st in states.items():
        out[f"{prefix}/{name}/ids"] = st.ids.numpy()
        out[f"{prefix}/{name}/values"] = st.values.float().numpy()
    return out


def _save(out, tag: str, rank: int, arrays: dict, meta: dict | None = None):
    np.savez(Path(out) / f"{tag}{rank}.npz", **arrays)
    if meta is not None:
        (Path(out) / f"{tag}{rank}.json").write_text(json.dumps(meta))


# --------------------------------------------------------------------------- collect
def collect_ranks(rank, world, dev, out, jax_ckpt):
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.core import data_mesh
    from semanticlens_tpu_torch.data import ArrayDataset, ImageFolder
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
    from semanticlens_tpu_torch.parallel import collect_multihost, fused_multihost, gather_selected_rows

    from semanticlens_tpu_torch.core import replicate, shard_batch

    mesh = data_mesh()
    ds = ArrayDataset(IMAGES[:N_SWEEP], name="imgs")
    arrays, meta = {}, {}
    arrays["core/shard_batch"] = shard_batch(np.arange(8), mesh)
    arrays["core/replicated"] = replicate({"w": torch.full((3,), float(rank))}, mesh)["w"].numpy()
    try:
        data_mesh(3)
    except ValueError as e:
        meta["mesh_size"] = str(e)
    states, n = conv_engine(mesh).run(CONV_PARAMS, ds, BATCH)
    arrays |= _states("run", states)
    states, embeds, _ = conv_engine(mesh).run_fused(CONV_PARAMS, ds, BATCH, embed)
    arrays |= _states("fused", states) | {"fused/embeds": embeds}
    try:
        conv_engine(mesh).run(CONV_PARAMS, ds, 3)
        meta["odd_batch"] = "no error"
    except ValueError as e:
        meta["odd_batch"] = str(e)

    states, n = collect_multihost(conv_engine(), CONV_PARAMS, ds, BATCH)
    arrays |= _states("multihost", states)
    states, db, _ = fused_multihost(conv_engine(), CONV_PARAMS, ds, BATCH, embed)
    arrays |= _states("fusedmh", states) | {"fusedmh/db": db["c"]}
    one = ArrayDataset(IMAGES[:1], name="one")  # rank 1's shard is empty
    states, _ = collect_multihost(conv_engine(), CONV_PARAMS, one, BATCH)
    arrays |= _states("empty", states)
    states, db, _ = fused_multihost(conv_engine(), CONV_PARAMS, one, BATCH, embed)
    arrays |= _states("emptyfused", states) | {"emptyfused/db": db["c"]}
    local = np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * rank
    arrays["rows"] = gather_selected_rows(np.array([1, 4, 6, 7]), local, 4 * rank, 4 * rank + 4)

    # checkpoints: resume the JAX package's meshed checkpoint; leave one of our own (a sweep over a prefix
    # commits every batch and is never cleared by the engine: an interrupted sweep's directory)
    states, _ = conv_engine(mesh).run(CONV_PARAMS, ArrayDataset(IMAGES), 8, checkpoint_dir=jax_ckpt,
                                      checkpoint_every=1)
    arrays |= _states("resumed", states)
    conv_engine(mesh).run(CONV_PARAMS, ArrayDataset(IMAGES[:CKPT_ROWS]), 8, checkpoint_dir=Path(out) / "port_ckpt",
                          checkpoint_every=1)

    # a JPEG folder (written by the test): each rank decodes only its own rows of each batch
    folder = ImageFolder(Path(out) / "jpegs", image_size=8, device="cpu")
    decoded, decode = [], folder._decode
    folder._decode = lambda path: decoded.append(path.name) or decode(path)
    states, _ = conv_engine(mesh).run(CONV_PARAMS, folder, BATCH)
    arrays |= _states("folder", states)
    meta["folder_decoded"] = sorted(decoded)

    cv = ActivationComponentVisualizer(OneConv(), ds, ds, ["c"], 5, aggregate_fn=aggregate_conv_mean,
                                       cache_dir=Path(out) / "cache", mesh=mesh, params=CONV_PARAMS)
    db = Lens(FakeVLM()).compute_concept_db(cv, batch_size=BATCH, checkpoint=8)
    arrays["cv/db"] = db["c"]
    arrays["cv/table"] = cv.embedding_table
    _save(out, "collect", rank, arrays, meta)


# --------------------------------------------------------------------------- tensor parallel
def _lm(family: str):
    from semanticlens_tpu_torch.models import GPT2, Gemma2, Llama

    kw = dict(vocab_size=61, n_positions=16, width=32, depth=2, heads=4, dtype=torch.float32, pad_id=0, device="cpu")
    if family == "llama":
        return Llama(kv_heads=2, intermediate=64, **kw)
    if family == "gemma2":
        return Gemma2(kv_heads=2, head_dim=8, intermediate=64, sliding_window=5, **kw)
    return GPT2(**kw)


def _lm_collect(model, params, layers, mesh):
    from semanticlens_tpu_torch.collect.engine import CollectEngine
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops.aggregators import aggregate_transformer_mean

    eng = CollectEngine(model, layers, aggregate_transformer_mean, 3, mesh=mesh, input_preprocess=lambda x: x)
    states, n = eng.run(params, ArrayDataset(TOKENS, name="toks"), 4)
    assert n == len(TOKENS)
    return states


def tp_ranks(rank, world, dev, out, weights):
    """``weights``: an .npz of JAX-layout numpy weights, ``{family}/{name}``."""
    from torch.distributed.tensor import DTensor

    from semanticlens_tpu_torch.core import data_model_mesh
    from semanticlens_tpu_torch.core.mesh import tensor_parallel_region
    from semanticlens_tpu_torch.foundation_models import clip as tclip
    from semanticlens_tpu_torch.foundation_models import siglip as tsig
    from semanticlens_tpu_torch.models import Phi3, layers
    from semanticlens_tpu_torch.parallel import (
        clip_param_specs_2d,
        gpt2_param_specs_2d,
        llama_param_specs_2d,
        phi3_param_specs_2d,
        shard_params,
        siglip_param_specs_2d,
    )

    mesh = data_model_mesh(2)
    data = np.load(weights)
    arrays, meta = {}, {"sdpa_dtensor_args": 0, "sdpa_calls": 0}

    plain_sdpa = F.scaled_dot_product_attention

    def watched_sdpa(*args, **kwargs):
        meta["sdpa_calls"] += 1
        meta["sdpa_dtensor_args"] += sum(isinstance(a, DTensor) for a in (*args, *kwargs.values()))
        return plain_sdpa(*args, **kwargs)

    F.scaled_dot_product_attention = watched_sdpa

    def placements(params):
        return {n: [repr(p) for p in v.placements] + [list(v.to_local().shape)]
                for n, v in params.items() if isinstance(v, DTensor)}

    # every spec function on the port's own tensors
    clip_cfg = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=64, layers=2,
                                                                     heads=4),
                                text=tclip.TextCfg(context_length=12, vocab_size=64, width=64, heads=4, layers=2))
    clip_np = {k[5:]: data[k] for k in data.files if k.startswith("clip/")}
    plain_fm = tclip.OpenClip("ViT-B-32", jax_params=clip_np, dtype=torch.float32, device="cpu", cfg=clip_cfg)
    sharded_fm = tclip.OpenClip("ViT-B-32", jax_params=clip_np, dtype=torch.float32, device="cpu", cfg=clip_cfg,
                                mesh=mesh)
    meta["placements"] = {"clip": placements(sharded_fm.params)}
    sig_cfg = tsig.SigLIPConfig(embed_dim=32, image_size=16, patch_size=8, vision_width=32, vision_layers=1,
                                vision_heads=2, text_width=32, text_layers=1, text_heads=2, vocab_size=100,
                                context_length=8)
    sig = tsig.SigLipV2(device="cpu", dtype=torch.float32, cfg=sig_cfg, mesh=mesh)
    meta["placements"]["siglip"] = placements(sig.params)
    meta["spec_names"] = {"clip": sorted(clip_param_specs_2d(clip_cfg)), "siglip": sorted(siglip_param_specs_2d(sig_cfg))}
    phi = Phi3(vocab_size=61, n_positions=16, width=32, depth=2, heads=4, kv_heads=2, intermediate=48,
               dtype=torch.float32, device="cpu")
    meta["placements"]["phi3"] = placements(shard_params(phi.init(seed=0), mesh, phi3_param_specs_2d(phi)))
    meta["spec_names"]["phi3"] = sorted(phi3_param_specs_2d(phi))

    # the int8 tower: quantized after the tensor sharding, its int8 weights plain tensors on every rank
    from semanticlens_tpu_torch.ops.quant import QuantizedTensor

    int8_fms = {tag: tclip.OpenClip("ViT-B-32", jax_params=clip_np, dtype=torch.float32, device="cpu", cfg=clip_cfg,
                                    mesh=m, quantize="int8") for tag, m in (("tp", mesh), ("plain", None))}
    meta["int8_leaves_plain"] = [type(t).__name__ for v in int8_fms["tp"].params.values()
                                 if isinstance(v, QuantizedTensor) for t in v]

    # CLIP towers at tp = 2 against the unsharded port towers
    images = torch.from_numpy(np.random.default_rng(7).normal(size=(3, 16, 16, 3)).astype(np.float32))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 64, size=(2, 12)))
    with torch.inference_mode():
        arrays["clip/image_tp"] = sharded_fm.encode_image(images).numpy()
        arrays["clip/image"] = plain_fm.encode_image(images).numpy()
        arrays["clip/text_tp"] = sharded_fm.encode_text(tokens).numpy()
        arrays["clip/text"] = plain_fm.encode_text(tokens).numpy()
        for tag, fm in int8_fms.items():
            arrays[f"clip/int8_image_{tag}"] = fm.encode_image(images).numpy()

        # multi_head_attention slices a column-sharded fused in_proj (the cross-attention path)
        prefix = "visual.transformer.resblocks.0.attn"
        x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 5, 64)).astype(np.float32))
        kv = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 7, 64)).astype(np.float32))
        arrays["mha/plain"] = layers.multi_head_attention(x, plain_fm.params, prefix, 4, kv=kv).numpy()
        with tensor_parallel_region():
            got = layers.multi_head_attention(x, sharded_fm.params, prefix, 4, kv=kv)
        arrays["mha/tp"] = got.full_tensor().numpy()

    # the LM subjects through the engine at tp = 2 against the unsharded port run
    specs = {"gpt2": gpt2_param_specs_2d, "llama": llama_param_specs_2d, "gemma2": llama_param_specs_2d}
    meta["seconds"] = {}
    for family, spec_fn in specs.items():
        model = _lm(family)
        params = model.load_jax_params({k.split("/", 1)[1]: data[k] for k in data.files
                                        if k.startswith(f"{family}/")})
        sharded = shard_params(params, mesh, spec_fn(model))
        meta["placements"][family] = placements(sharded)
        meta["spec_names"][family] = sorted(spec_fn(model))
        arrays |= _states(f"{family}/plain", _lm_collect(model, params, LM_LAYERS[family], None))
        t = time.perf_counter()
        arrays |= _states(f"{family}/tp", _lm_collect(model, sharded, LM_LAYERS[family], mesh))
        meta["seconds"][family] = time.perf_counter() - t
        if family == "llama":  # the forward's logits and one tap, whole
            with tensor_parallel_region():
                logits, taps = model.apply(sharded, torch.from_numpy(TOKENS[:3]), ("model.layers.1.mlp.down_proj",))
            ref_logits, ref_taps = model.apply(params, torch.from_numpy(TOKENS[:3]), ("model.layers.1.mlp.down_proj",))
            arrays["llama/logits_tp"] = logits.full_tensor().numpy()
            arrays["llama/logits"] = ref_logits.detach().numpy()
            arrays["llama/tap_tp"] = taps["model.layers.1.mlp.down_proj"].full_tensor().numpy()
            arrays["llama/tap"] = ref_taps["model.layers.1.mlp.down_proj"].detach().numpy()
    F.scaled_dot_product_attention = plain_sdpa

    # a dimension the axis does not divide is replicated
    odd = {"a.weight": torch.ones(5, 4), "b.weight": torch.ones(4, 6), "c": torch.ones(3)}
    from torch.distributed.tensor import Shard

    meta["odd"] = placements(shard_params(odd, mesh, {"a.weight": Shard(0), "b.weight": Shard(1), "c": Shard(0)}))
    _save(out, "tp", rank, arrays, meta)


class CropMeanFM:
    """Channel means of each relevance crop as its embedding."""

    name = "crop-mean"
    device = torch.device("cpu")

    def preprocess(self, crops):
        return torch.stack([c.float().mean(dim=(0, 1)) for c in crops])

    def encode_image(self, x):
        return x


def relevance_db(out, mesh=None) -> np.ndarray:
    """``RelevanceComponentVisualizer`` on a seed-0 ResNet-18's layer2 (128 components, 3 crops each)."""
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import RelevanceComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.models import ResNet

    model = ResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    model.params, model.name = model.load_jax_params(model.init_jax_layout(0)), "r18"
    ds = ArrayDataset(np.random.default_rng(0).random((16, 32, 32, 3)).astype(np.float32), name="rel16")
    rcv = RelevanceComponentVisualizer(model, ds, ["layer2"], num_samples=3, storage_dir=Path(out) / "fv",
                                       mesh=mesh)
    rcv.run(batch_size=8)
    return Lens(CropMeanFM()).compute_concept_db(rcv, batch_size=8, n_ref=3)["layer2"]


# --------------------------------------------------------------------------- SAE, featviz, scores
class Identity(SubjectModel):
    """The image's channels are the tap: rows streamed as (B, 4, 4, d) images."""

    module_names = ("x",)
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        return x.mean(dim=(1, 2)), ({"x": x} if "x" in tap_names else {})


class PairTaps(SubjectModel):
    """Aligned taps for a transcoder: ``a = [x, 2·relu(x)]``, ``b = a[:3] · a[3:]``."""

    module_names = ("a", "b")
    device = torch.device("cpu")

    def apply(self, params, x, tap_names=()):
        tap = TapCollector(tap_names)
        a = tap("a", torch.cat([x, torch.relu(x) * 2.0], dim=-1))
        b = tap("b", a[..., :3] * a[..., 3:])
        return b.mean(dim=(1, 2)), tap.taps


# The streaming cases of ``tests/test_torch_sae_train.py`` (its planted-dictionary SAE and its transcoder), whose
# final fvu it holds to the JAX trainers' within bounds measured over five seeds.
STREAM_KW = {"stream": {"d_in": 16, "n_latents": 32, "k": 3, "lr": 2e-3, "batch_rows": 512, "positions_per_image": 8,
                        "seed": 1},
             "stream_tc": {"d_in": 6, "d_out": 3, "n_latents": 64, "k": 8, "lr": 3e-3, "batch_rows": 128,
                           "positions_per_image": 16, "seed": 0}}
STREAM_RUNS = {"stream": {"batch_size": 128, "epochs": 24}, "stream_tc": {"batch_size": 32, "epochs": 48}}


def stream_cases(data) -> dict:
    """tag → (model, taps, images, config keywords) of the streaming trainers, images from ``data``."""
    return {"stream": (Identity(), ("x",), data["planted"], STREAM_KW["stream"]),
            "stream_tc": (PairTaps(), ("a", "b"), data["tc_images"], STREAM_KW["stream_tc"])}


def train_ranks(rank, world, dev, out, inputs):
    from semanticlens_tpu_torch import Lens, featviz, sae
    from semanticlens_tpu_torch.core import data_mesh, shard_concept_db
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.scores import clarity_score, polysemanticity_score, redundancy_score

    mesh = data_mesh()
    data = np.load(inputs)
    arrays, meta = {}, {}
    for tag, targets in (("sae", None), ("tc", data["targets"])):
        cfg = sae.SAEConfig(**json.loads(str(data[f"{tag}_cfg"])))
        init = {k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(f"{tag}_init/")}
        params, stats, metrics = sae.train_sae_from_rows(data["rows"], cfg, targets=targets, steps=int(data["steps"]),
                                                         params=init, mesh=mesh, device="cpu")
        arrays |= {f"{tag}/{k}": v.numpy() for k, v in params.items() if k != "k"}
        arrays[f"{tag}/last_fired"] = stats["last_fired"].numpy()
        meta[f"{tag}_metrics"] = metrics

    # the streaming trainers on the minibatches of one process: the SAE on a planted dictionary, the transcoder
    for tag, (model, taps, images, kw) in stream_cases(data).items():
        trainer = sae.train_sae_on_layer if len(taps) == 1 else sae.train_transcoder_on_layer
        params, stats, metrics = trainer(model, {}, ArrayDataset(images), *taps, sae.SAEConfig(**kw), mesh=mesh,
                                         **STREAM_RUNS[tag])
        arrays |= {f"{tag}/{k}": v.numpy() for k, v in params.items() if k != "k"}
        arrays[f"{tag}/last_fired"] = stats["last_fired"].numpy()
        meta[f"{tag}_metrics"] = metrics
        meta[f"{tag}_steps"] = int(stats["step"])
    model = OneConv()

    # feature synthesis, K = 4 canvases over the ranks
    syn_cfg = featviz.SynthesisConfig(steps=4, lr=0.05, jitter=1)
    images, objective, trace = featviz.synthesize(model, CONV_PARAMS, "c", [0, 3, 5, 1],
                                                  lambda t: t.mean(dim=(1, 2)), image_size=6, config=syn_cfg,
                                                  seed=3, return_trace=True, mesh=mesh)
    arrays |= {"syn/images": images, "syn/objective": objective, "syn/trace": trace}

    # the Analyze scores on a component-sharded concept DB
    db = {"layer4": data["db"], "odd": data["db_odd"]}
    sharded = shard_concept_db(db, mesh)
    meta["sharded"] = {k: type(v).__name__ for k, v in sharded.items()}
    for name in db:
        arrays[f"clarity/{name}"] = clarity_score(sharded[name]).numpy()
        arrays[f"poly/{name}"] = polysemanticity_score(sharded[name]).numpy()
    agg = shard_concept_db({"layer4": data["db"].mean(1)}, mesh)["layer4"]
    arrays["redundancy"] = redundancy_score(agg).numpy()
    lens = Lens(FakeVLM())
    arrays["lens/clarity"] = lens.eval_clarity(sharded)["layer4"].numpy()
    arrays["lens/poly"] = lens.eval_polysemanticity(sharded)["layer4"].numpy()
    arrays["relevance/db"] = relevance_db(out, mesh)  # components split over the ranks
    _save(out, "train", rank, arrays, meta)


# --------------------------------------------------------------------------- full audit
def audit_ranks(rank, world, dev, out, weights, argv):
    """``full_audit.main`` on every rank with the tiny shared-weight models of ``test_torch_full_audit.py``."""
    from semanticlens_tpu_torch import full_audit
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.foundation_models import clip as tclip
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean

    data = np.load(weights)
    tiny = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2,
                                                                 heads=2),
                            text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2))

    def build_model(args, device):
        model = ResNet(depth=18, dtype=torch.float32, device=device)
        model.params = model.load_jax_params({k[7:]: data[k] for k in data.files if k.startswith("resnet/")})
        model.name = "resnet18-audit"
        return model, aggregate_conv_mean

    full_audit.build_model = build_model
    full_audit.build_fm = lambda args, device: tclip.OpenClip(
        "ViT-B-32", jax_params={k[5:]: data[k] for k in data.files if k.startswith("clip/")}, dtype=torch.float32,
        device=device, cfg=tiny, mesh=args.mesh)
    full_audit.load_dataset = lambda args, device: ArrayDataset(data["images"], data["labels"], name="toy")
    report = full_audit.main(list(argv))
    (Path(out) / f"audit{rank}.json").write_text(json.dumps(report))


# --------------------------------------------------------------------------- int8 towers
def int8_tower_ranks(rank, world, dev, out, vision, text):
    """A tiny int8 ``OpenClip`` with and without ``mesh=data_mesh()``: image and text embeddings."""
    from semanticlens_tpu_torch.core import data_mesh
    from semanticlens_tpu_torch.foundation_models import clip as tclip

    with np.load(Path(out) / "weights.npz") as data:
        weights = {k: data[k] for k in data.files}
    cfg = tclip.CLIPConfig(embed_dim=64, vision=tclip.VisionCfg(**vision), text=tclip.TextCfg(**text))
    images = torch.from_numpy(np.random.default_rng(4).normal(size=(5, vision["image_size"], vision["image_size"],
                                                                     3)).astype(np.float32))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(1, text["vocab_size"] - 1, size=(3, 12)))
    arrays = {}
    for tag, mesh in (("mesh", data_mesh()), ("plain", None)):
        fm = tclip.OpenClip("ViT-B-32", jax_params=weights, cfg=cfg, dtype=torch.float32, device=dev,
                            quantize="int8", mesh=mesh)
        arrays[f"{tag}/image"] = fm.encode_image(images).cpu().numpy()
        arrays[f"{tag}/text"] = fm.encode_text(tokens).cpu().numpy()
    if rank == 0:
        np.savez(Path(out) / "int8_mesh.npz", **arrays)
