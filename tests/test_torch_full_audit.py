"""``python -m semanticlens_tpu_torch.full_audit`` against the JAX package's ``tools/full_audit.py``.

The JAX tool's flags, defaults and report keys are read from its source
(AST); the port adds ``--cpu`` and nothing else. An in-process run at tiny
size (ResNet-18 at 32², the cut-down CLIP tower of ``test_torch_slice.py``,
the same numpy weights in both packages, float32 on the CPU) is held
against the same pipeline composed from the JAX package's calls, as the
tool makes them: the concept DB shapes, clarity and redundancy per layer
(1e-5 relative), the top neuron and top-5 ids per query, the class-selective
components of a labelled dataset, the image probe and the cosine and
soft-WPMI labels are equal. Polysemanticity and NPI are not compared: their
k-means and null draws come from other random streams (ROADMAP queue 3).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semanticlens_tpu import scores as jscores
from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.foundation_models.tokenizer import HashTokenizer as JHash
from semanticlens_tpu.lens import Lens as JLens
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu.utils import make_preprocess_fn as j_pre
from semanticlens_tpu_torch import full_audit
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import ResNet as TResNet
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY_J = jclip.CLIPConfig(
    embed_dim=16,
    vision=jclip.VisionCfg(kind="vit", image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=jclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
TINY_T = tclip.CLIPConfig(
    embed_dim=16,
    vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2, heads=2),
    text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2),
)
N, SAMPLES, LAYERS = 24, 4, ["layer3", "layer4"]
IMAGES = np.random.default_rng(0).integers(0, 256, size=(N, 32, 32, 3), dtype=np.uint8)
LABELS = np.repeat(np.arange(3), N // 3)
VOCAB = ["dog", "cat", "car", "tree", "wheel", "stripe"]
TINY_ARGS = ["--cpu", "--image-size", "32", "--layers", *LAYERS, "--n-samples", str(SAMPLES), "--batch", "8",
             "--vocabulary", *VOCAB, "--image-query-indices", "0", "5"]


def _jax_tool():
    return ast.parse((REPO / "tools" / "full_audit.py").read_text())


def _jax_flags():
    flags = {}
    for node in ast.walk(_jax_tool()):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flags[node.args[0].value] = next(
                (ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"), False)
    return flags


def _jax_report_keys():
    for node in ast.walk(_jax_tool()):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "report"
                and isinstance(node.value, ast.Dict)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no report = {...} in tools/full_audit.py")


def test_flags_defaults_and_report_keys_are_the_jax_tools():
    args = vars(full_audit.parse_args([]))
    want = _jax_flags()
    assert {f"--{k.replace('_', '-')}" for k in args} == set(want) | {"--cpu"}  # the port adds --cpu only
    for flag, default in want.items():
        assert args[flag[2:].replace("-", "_")] == default, flag
    assert args["layers"] == ["layer1", "layer2", "layer3", "layer4"] and args["cpu"] is False
    assert list(full_audit.REPORT_KEYS) == _jax_report_keys()


@pytest.mark.parametrize("argv,match", [
    (["--arch", "swin", "--depth", "18"], "--depth configures"),
    (["--arch", "inception", "--variant", "v2"], "supports --variant v1/v3"),
    (["--arch", "maxvit", "--depth", "18"], "--depth configures"),
    (["--arch", "shufflenet", "--depth", "18"], "--depth configures"),
    (["--variant", "q"], "supports --variant"),
    (["--arch", "vit", "--variant", "x"], "--variant configures"),
    (["--arch", "vit", "--depth", "18"], "--depth configures"),
], ids=["swin", "inception", "maxvit", "shufflenet", "unknown-variant", "vit-variant", "vit-depth"])
def test_unsupported_arguments_exit_naming_their_item(capsys, argv, match):
    with pytest.raises(SystemExit):
        full_audit.parse_args(argv)
    assert match in capsys.readouterr().err


def test_several_cards_without_no_mesh_exit_naming_item_13(monkeypatch):
    """Several cards outside ``torchrun`` exit naming it (the message named ROADMAP item 13 before the
    multi-GPU path was ported; the test keeps its name)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        full_audit.main([])


@pytest.fixture(scope="module")
def weights():
    return TResNet(depth=18, device="cpu").init_jax_layout(seed=0), tclip.init_clip_params_jax_layout(1, TINY_T)


def _run_port(monkeypatch, weights, argv, labels=None):
    np_resnet, np_clip = weights

    def build_model(args, device):
        model = TResNet(depth=18, dtype=torch.float32, device=device)
        model.params, model.name = model.load_jax_params(np_resnet), "resnet18-audit"
        return model, t_mean

    monkeypatch.setattr(full_audit, "build_model", build_model)
    monkeypatch.setattr(full_audit, "build_fm", lambda args, device: tclip.OpenClip(
        "ViT-B-32", jax_params=np_clip, dtype=torch.float32, device=device, cfg=TINY_T))
    monkeypatch.setattr(full_audit, "load_dataset", lambda args, device: TDataset(IMAGES, labels, name="toy"))
    return full_audit.main(argv)


def _run_jax(weights, scoring, labels=None):
    """The tool's pipeline (``tools/full_audit.py:308-455``) composed from JAX package calls."""
    np_resnet, np_clip = weights
    model = JResNet(depth=18, dtype=jnp.float32)
    model.params, model.name = {k: jnp.asarray(v) for k, v in np_resnet.items()}, "resnet18-audit"
    fm = jclip.OpenClip("ViT-B-32", params={k: jnp.asarray(v) for k, v in np_clip.items()}, dtype=jnp.float32)
    fm.cfg, fm.tokenizer = TINY_J, JHash(50, 12)
    dataset = JDataset(IMAGES, labels, name="toy")
    lens = JLens(fm)
    cv = JCV(model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=LAYERS, num_samples=SAMPLES,
             aggregate_fn=j_mean, model_preprocess=j_pre(size=32, crop=32), cache_dir=None)
    db = lens.compute_concept_db(cv, batch_size=8)
    agg = {k: np.asarray(v).mean(1) for k, v in db.items()}
    clarity, redundancy = lens.eval_clarity(db), lens.eval_redundancy(agg)
    queries = ["dog", "car wheel", "striped pattern"]
    hits = lens.text_probing(queries, agg, templates=["a photo of a {}"])
    q = np.asarray(fm.encode_text(fm.tokenize(queries)), np.float32)
    out = {
        "db_shapes": {k: list(np.asarray(v).shape) for k, v in db.items()},
        "clarity": {k: float(np.asarray(clarity[k]).mean()) for k in LAYERS},
        "redundancy": {k: float(np.asarray(redundancy[k])) for k in LAYERS},
        "top": {k: {w: int(np.asarray(s)[i].argmax()) for i, w in enumerate(queries)} for k, s in hits.items()},
        "top5": {k: {w: np.asarray(jscores.topk_cosine_search(q, b, k=5)[1])[i].tolist()
                     for i, w in enumerate(queries)} for k, b in agg.items()},
        "image": {k: int(np.asarray(s).argmax()) for k, s in lens.image_probing(IMAGES[[0, 5]], agg).items()},
        "ids": {k: np.asarray(cv.get_max_reference(k)) for k in LAYERS},
    }
    kw = {} if scoring == "cosine" else {"scoring": "wpmi", "image_embeds": cv.embedding_table,
                                         "evidence_ids": {k: cv.get_max_reference(k) for k in LAYERS}}
    named = lens.label_components(VOCAB, agg, top_m=1, templates=["a photo of a {}"], **kw)
    out["labels"] = {k: (words[:16], np.asarray(vals)[:16, 0]) for k, (words, vals) in named.items()}
    if labels is not None:
        out["classes"] = {k: jscores.class_composition(out["ids"][k], labels) for k in LAYERS}
    return out


@pytest.mark.parametrize("scoring,labels", [("cosine", None), ("wpmi", LABELS)], ids=["cosine", "wpmi-labelled"])
def test_in_process_run_matches_the_jax_pipeline(monkeypatch, weights, scoring, labels):
    report = _run_port(monkeypatch, weights, TINY_ARGS + ["--label-scoring", scoring], labels)
    want = _run_jax(weights, scoring, labels)
    assert list(report) == list(full_audit.REPORT_KEYS)
    assert report["mesh"] is None and report["n_images"] == N and report["layers"] == LAYERS
    assert report["db_shapes"] == want["db_shapes"] == {"layer3": [256, SAMPLES, 16], "layer4": [512, SAMPLES, 16]}
    for layer in LAYERS:
        got = report["scores"][layer]
        assert got["clarity_mean"] == pytest.approx(want["clarity"][layer], rel=1e-5)
        assert got["redundancy"] == pytest.approx(want["redundancy"][layer], rel=1e-5)
        assert np.isfinite(got["polysemanticity_mean"]) and np.isfinite(got["npi_mean"])
        words, vals = want["labels"][layer]
        assert [report["component_labels"][layer][str(i)]["word"] for i in range(16)] == [w[0] for w in words]
        np.testing.assert_allclose([report["component_labels"][layer][str(i)]["score"] for i in range(16)], vals,
                                   rtol=1e-4, atol=1e-6)
    assert report["top_neuron_per_query"] == want["top"]
    assert report["top5_per_query"] == want["top5"]
    assert report["image_probe_top_neuron"] == want["image"]
    stages = ["collect+embed", "scores", "text-search", "topk-search"] + (
        ["class-composition"] if labels is not None else []) + ["image-probing", "label-components"]
    assert list(report["stages"]) == stages
    assert report["stages"]["collect+embed"]["items"] == N and "items_per_sec" in report["stages"]["collect+embed"]
    if labels is None:
        assert report["class_selective_components"] == {}
        return
    for layer in LAYERS:  # the tool's ranking over the JAX package's class composition
        counts, purity = want["classes"][layer]
        evidence = counts.sum(axis=1)
        eligible = evidence >= max(2, SAMPLES // 2)
        ranked = np.lexsort((-evidence, -np.where(eligible, purity, -1.0)))[:8]
        expected = {str(int(i)): {"purity": round(float(purity[i]), 4), "evidence": int(evidence[i]),
                                  "top_class": int(counts[i].argmax())} for i in ranked if eligible[i]}
        assert report["class_selective_components"][layer] == expected and expected


def test_cli_process_over_an_image_folder_prints_the_jax_keys(tmp_path):
    """``python -m`` in its own process over a 2-class JPEG folder: class composition runs."""
    from PIL import Image

    rng = np.random.default_rng(1)
    for c in ("a", "b"):
        (tmp_path / "data" / c).mkdir(parents=True)
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(tmp_path / "data" / c / f"{i}.jpg")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "semanticlens_tpu_torch.full_audit", "--cpu", "--image-dir",
                           str(tmp_path / "data"), "--image-size", "32", "--depth", "18", "--layers", "layer4",
                           "--n-samples", "4", "--batch", "4", "--queries", "dog"],
                          capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(report) == _jax_report_keys()
    assert report["dataset"] == "data" and report["n_images"] == 12 and report["db_shapes"] == {"layer4": [512, 4, 512]}
    assert "class-composition" in report["stages"] and set(report["class_selective_components"]) == {"layer4"}
    assert "full audit on cpu" in proc.stderr
