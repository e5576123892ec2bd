"""``full_audit`` over two gloo ranks on the CPU against its ``--no-mesh`` run.

``parallel.launch.spawn`` starts two ranks with ``RANK``/``WORLD_SIZE`` set,
as ``torchrun`` does; each runs ``full_audit.main`` with the tiny
shared-weight models of ``test_torch_full_audit.py`` (ResNet-18 at 32², the
cut-down CLIP tower) over a labelled dataset. The run builds
``core.data_mesh()``, sweeps each rank's rows of every batch, scores a
``shard_concept_db`` and reports ``"mesh": {"data": 2}``. Its report equals
the one-process ``--no-mesh`` report in every key but ``"mesh"`` and the
stage timings (whose stage names are equal): ids and labels exactly, the
scores within 1e-5 (the tower embeds half batches on each rank, float32).
"""

import json

import numpy as np
import pytest
import torch

from semanticlens_tpu_torch import full_audit
from semanticlens_tpu_torch.data import ArrayDataset
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import ResNet
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean
from semanticlens_tpu_torch.parallel import launch

import torch_mesh_ranks as ranks

torch.set_num_threads(2)

N = 24
ARGV = ["--cpu", "--image-size", "32", "--layers", "layer3", "layer4", "--n-samples", "4", "--batch", "8",
        "--vocabulary", "dog", "cat", "car", "tree", "--image-query-indices", "0", "5"]
TINY = tclip.CLIPConfig(embed_dim=16, vision=tclip.VisionCfg(image_size=16, patch_size=8, width=32, layers=2, heads=2),
                        text=tclip.TextCfg(context_length=12, vocab_size=50, width=32, heads=2, layers=2))


def _weights():
    return {**{f"resnet/{k}": v for k, v in ResNet(depth=18, device="cpu").init_jax_layout(seed=0).items()},
            **{f"clip/{k}": v for k, v in tclip.init_clip_params_jax_layout(1, TINY).items()},
            "images": np.random.default_rng(0).integers(0, 256, size=(N, 32, 32, 3), dtype=np.uint8),
            "labels": np.repeat(np.arange(3), N // 3)}


def _no_mesh_report(monkeypatch, data):
    def build_model(args, device):
        model = ResNet(depth=18, dtype=torch.float32, device=device)
        model.params = model.load_jax_params({k[7:]: v for k, v in data.items() if k.startswith("resnet/")})
        model.name = "resnet18-audit"
        return model, aggregate_conv_mean

    monkeypatch.setattr(full_audit, "build_model", build_model)
    monkeypatch.setattr(full_audit, "build_fm", lambda args, device: tclip.OpenClip(
        "ViT-B-32", jax_params={k[5:]: v for k, v in data.items() if k.startswith("clip/")}, dtype=torch.float32,
        device=device, cfg=TINY))
    monkeypatch.setattr(full_audit, "load_dataset", lambda args, device: ArrayDataset(data["images"], data["labels"],
                                                                                      name="toy"))
    return full_audit.main(ARGV + ["--no-mesh"])


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), path
    else:
        assert got == want, path


def test_two_rank_audit_report_equals_the_no_mesh_report(tmp_path, monkeypatch, capsys):
    data = _weights()
    np.savez(tmp_path / "weights.npz", **data)
    launch.spawn(ranks.audit_ranks, 2, tmp_path / "work", args=(str(tmp_path), str(tmp_path / "weights.npz"), ARGV),
                 timeout_s=150)
    reports = [json.loads((tmp_path / f"audit{r}.json").read_text()) for r in range(2)]
    want = _no_mesh_report(monkeypatch, data)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed and printed[-1]["mesh"] is None
    for got in reports:
        assert list(got) == list(full_audit.REPORT_KEYS)
        assert got["mesh"] == {"data": 2} and want["mesh"] is None
        assert list(got["stages"]) == list(want["stages"])
        for key in full_audit.REPORT_KEYS:
            if key not in ("mesh", "stages"):
                _close(got[key], want[key], key)
        assert got["class_selective_components"]  # the labelled dataset's composition ran on the gathered ids
