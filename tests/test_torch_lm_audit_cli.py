"""``python -m semanticlens_tpu_torch.lm_audit`` against the JAX package's ``tools/lm_audit.py``.

The JAX tool's flags, defaults, topic vocabulary and the keys of its three
JSON lines are read from its source (AST); the port has the same flags
(``--cpu`` included) and keeps the keys as ``REPORT_KEYS``. The CLI runs on
the CPU in its own process, and ``main`` in process for the other two
families, each printing the three stages with those keys.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from semanticlens_tpu_torch import lm_audit

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    return ast.parse((REPO / "tools" / "lm_audit.py").read_text())


def test_flags_defaults_topics_and_keys_are_the_jax_tools():
    tree = _jax_tool()
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = (ast.literal_eval(kw["default"]) if "default" in kw else False,
                                         ast.literal_eval(kw["choices"]) if "choices" in kw else None)
    args = vars(lm_audit.parse_args([]))
    assert {f: d for f, (d, _) in flags.items()} == {"--" + k.replace("_", "-"): v for k, v in args.items()}
    assert flags["--family"][1] == ["gpt2", "llama", "gemma2"]
    with pytest.raises(SystemExit):
        lm_audit.parse_args(["--family", "phi3"])
    topics = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                  if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "TOPICS")
    assert topics == lm_audit.TOPICS
    stages = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and getattr(node.keys[0], "value", None) == "stage":
            stages[node.values[0].value] = tuple(k.value for k in node.keys)
    assert stages == lm_audit.REPORT_KEYS


def _check(reports, family_layer):
    assert [r["stage"] for r in reports] == list(lm_audit.REPORT_KEYS)
    for r in reports:
        assert tuple(r) == lm_audit.REPORT_KEYS[r["stage"]]
    assert reports[0]["layer"] == family_layer and reports[0]["components"] > 0
    assert reports[2]["device"] == "cpu" and 0 <= reports[2]["top_relevant_token_index"] < 16


def test_cli_process_prints_the_three_stages():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "semanticlens_tpu_torch.lm_audit", "--cpu", "--samples", "40"],
                          capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    _check(lines, "transformer.h.1.mlp.act")


@pytest.mark.parametrize("family,layer", [("llama", "model.layers.1.mlp.act_fn"),
                                          ("gemma2", "model.layers.1.self_attn.heads")])
def test_main_in_process_for_the_other_families(family, layer, capsys):
    reports = lm_audit.main(["--cpu", "--family", family, "--samples", "40", "--layer", layer])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == reports
    _check(reports, layer)


def test_main_in_process_for_deepseek_v2(capsys):
    """The MoE subject's experts' neurons through the tool; its validate stage reports null (no ablation or
    LRP through an MoE layer)."""
    reports = lm_audit.main(["--cpu", "--family", "deepseek_v2", "--samples", "40"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == reports
    assert [r["stage"] for r in reports] == list(lm_audit.REPORT_KEYS)
    assert all(tuple(r) == lm_audit.REPORT_KEYS[r["stage"]] for r in reports)
    assert reports[0]["layer"] == "model.layers.1.mlp.experts.act_fn" and reports[0]["components"] == 8 * 32
    assert reports[2]["necessity_ratio"] is None and reports[2]["top_relevant_token_index"] is None
    assert reports[2]["device"] == "cpu"
