"""The port's SAE training entry point against the JAX package's ``tools/train_sae.py``.

``python -m semanticlens_tpu_torch.train_sae`` runs here with ``--cpu`` at a
tiny size (ResNet-18 on 32×32 images). Its flags and defaults are the JAX
tool's, its JSON line has the JAX tool's keys (read from the tool's source),
and the ``.npz`` it writes loads in the JAX ``SAESubjectModel`` under the
same name as in the port's.
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

from semanticlens_tpu import sae as jsae
from semanticlens_tpu.models.resnet import ResNet as JResNet
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch import sae as tsae
from semanticlens_tpu_torch import train_sae
from semanticlens_tpu_torch.models import ResNet, VisionTransformer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--cpu", "--depth", "18", "--layer", "layer1", "--latents", "64", "--k", "4", "--aux-k", "8",
        "--images", "10", "--image-size", "32", "--batch", "4", "--batch-rows", "32", "--positions", "8"]


def _jax_tool():
    return ast.parse((REPO / "tools" / "train_sae.py").read_text())


def _jax_report_keys():
    for node in ast.walk(_jax_tool()):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps({...}) in tools/train_sae.py")


def _jax_flags():
    """{flag: default} of the JAX tool's ``add_argument`` calls."""
    flags = {}
    for node in ast.walk(_jax_tool()):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            default = next((ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"), False)
            flags[node.args[0].value] = default
    return flags


def test_flags_and_defaults_are_the_jax_tools():
    args = vars(train_sae.parse_args([]))
    want = _jax_flags()
    assert {f"--{k.replace('_', '-')}" for k in args} == set(want)
    for flag, default in want.items():
        assert args[flag[2:].replace("-", "_")] == default, flag
    with pytest.raises(SystemExit):
        train_sae.parse_args(["--arch", "convnext"])  # the port has resnet and vit


def test_cli_process_reports_the_jax_keys_and_writes_a_dictionary_the_jax_package_loads(tmp_path):
    out = tmp_path / "sae.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "semanticlens_tpu_torch.train_sae", *TINY, "--epochs", "2",
                           "--out", str(out)], capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(report) == list(train_sae.REPORT_KEYS) == _jax_report_keys()
    # 10 images at batch 4: 2 full batches per epoch (the tail is dropped), 4 · 8 rows // 32 = 1 step each
    assert report["steps"] == 4 and report["d_in"] == 64 and report["device"] == "cpu"
    assert report["l0"] == 4.0 and np.isfinite(report["final_loss"])

    arrays = dict(np.load(out))
    assert int(arrays["k"]) == 4 and arrays["W_dec"].shape == (64, 64)
    jmodel = JResNet(depth=18, dtype=jnp.bfloat16)
    jsub = jsae.SAESubjectModel(jmodel, "layer1", arrays, base_params={})
    tsub = tsae.SAESubjectModel(ResNet(depth=18, device="cpu"), "layer1", convert.load_sae_npz(out, device="cpu"),
                                base_params={})
    assert jsub.name == tsub.name == f"ResNet-sae_layer1_64k4_{jsae._params_digest(arrays)}"


def test_in_process_jumprelu_and_model_families(capsys):
    report = train_sae.main([*TINY, "--k", "0", "--jumprelu", "--l0-coef", "1e-3"])
    assert json.loads(capsys.readouterr().out.strip()) == report
    assert report["jumprelu"] is True and report["k"] == 0 and report["steps"] == 2
    args = train_sae.parse_args(["--arch", "vit", "--image-size", "64"])
    vit = train_sae.build_model(args, torch.device("cpu"))
    assert isinstance(vit, VisionTransformer) and vit.image_size == 64 and vit.dtype == torch.bfloat16
