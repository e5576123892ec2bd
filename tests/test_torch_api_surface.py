"""The port's public names against the JAX package's, subpackage by subpackage and module by module.

Every name in a JAX ``__all__`` is in the port's ``__all__``, or is listed
below: under the ROADMAP item that ports it (queue 1), as a JAX name with
no port and its reason, or as a rename with its reason. A new JAX export
with none of these fails the test; so does a queued name that the port now
has (move it out of the queue). The port may export more (``Subset``, the
interventions names, …).

Module by module: every public top-level function, class and constant
that a JAX module defines is an attribute of its counterpart in the port
(the module at the same path, ``ops/pallas_ops.py`` → ``ops/cosine.py``),
or is listed in ``MODULE_NO_PORT`` / ``MODULE_RENAMED`` with its reason.
"""

import ast
import importlib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

SUBPACKAGES = ["", ".causal", ".collect", ".core", ".data", ".featviz", ".foundation_models", ".models", ".ops",
               ".parallel", ".relevance", ".scores", ".utils"]

# JAX names the port does not have yet, by the ROADMAP queue-1 item that ports them.
QUEUED = {}
# JAX names with no port, and why.
NO_PORT = {
    ".models": {"FlaxSubjectModel": "wraps flax.linen, which the card does not have; TorchSubjectModel is the "
                                    "port's counterpart"},
}
# JAX names the port has under another name: the JAX initializers take a jax.random key, the
# port's draw numpy weights in the JAX layout from an integer seed.
RENAMED = {
    ".foundation_models": {"init_clip_params": "init_clip_params_jax_layout",
                           "init_siglip_params": "init_siglip_params_jax_layout",
                           "init_mobileclip_params": "init_mobileclip_params_jax_layout"},
}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_every_jax_export_is_ported_or_queued(sub):
    jax_mod = importlib.import_module("semanticlens_tpu" + sub)
    port = importlib.import_module("semanticlens_tpu_torch" + sub)
    jax_names, port_names = set(jax_mod.__all__), set(port.__all__)
    queued, renamed, no_port = QUEUED.get(sub, {}), RENAMED.get(sub, {}), NO_PORT.get(sub, {})
    missing = jax_names - port_names - set(queued) - set(renamed) - set(no_port)
    assert not missing, f"semanticlens_tpu{sub} exports {sorted(missing)}: port them or queue them in ROADMAP.md"
    assert not (set(queued) & port_names), f"now ported, drop from QUEUED: {sorted(set(queued) & port_names)}"
    assert not (set(no_port) & port_names), f"now ported, drop from NO_PORT: {sorted(set(no_port) & port_names)}"
    assert set(queued) <= jax_names and set(renamed) <= jax_names and set(no_port) <= jax_names
    assert set(renamed.values()) <= port_names
    for name in port_names:
        assert hasattr(port, name), f"semanticlens_tpu_torch{sub}.__all__ names {name}, which it lacks"


def test_queued_items_are_open_in_the_roadmap():
    from pathlib import Path

    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    for item in sorted({i for names in QUEUED.values() for i in names.values()}):
        assert f"**{item.capitalize()}:" in roadmap, f"{item} is not an open ROADMAP item"


# Module by module. JAX modules whose port lives at another path, and those with none.
COUNTERPART = {"ops/pallas_ops.py": "ops/cosine.py"}
NO_PORT_MODULES = {"models/flax_adapter.py": "wraps flax.linen (see NO_PORT)"}
# Public top-level names of a ported JAX module that its counterpart lacks, and why.
MODULE_NO_PORT = {
    "data/native_decoder.py": {
        "decode_batch": "the JAX package's libjpeg-turbo host decoder; the port decodes through nvJPEG and decode_cpu",
        "is_available": "reports that host decoder; the port's decoders are chosen by the device",
    },
    "data/grain_adapter.py": {
        "GrainShardDataset": "its stream runs grain worker processes, and the card machine has no grain",
    },
    "utils/helper.py": {
        "host_c_array": "a TPU F-order layout guard; the port's safetensors_io writes contiguous tensors",
    },
    "utils/flops.py": {
        "tpu_peak_flops_bf16": "TPU peaks; the port looks its card's peaks up with cuda_peaks",
    },
}
MODULE_RENAMED = {
    "foundation_models/clip.py": {"init_clip_params": "init_clip_params_jax_layout"},
    "foundation_models/siglip.py": {"init_siglip_params": "init_siglip_params_jax_layout"},
    "foundation_models/mobileclip.py": {"init_mobileclip_params": "init_mobileclip_params_jax_layout"},
}
IGNORED = {"logger"}
JAX_MODULES = sorted(str(p.relative_to(ROOT / "semanticlens_tpu")) for p in (ROOT / "semanticlens_tpu").rglob("*.py")
                     if p.name != "__init__.py")


def _counterpart(rel: str) -> Path:
    return ROOT / "semanticlens_tpu_torch" / COUNTERPART.get(rel, rel)


def _public_top_level(path: Path) -> set[str]:
    """Functions, classes and assigned names defined at a module's top level, without a leading underscore."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")} - IGNORED


def _module_name(path: Path) -> str:
    return ".".join(path.relative_to(ROOT).with_suffix("").parts)


def test_every_jax_module_has_a_counterpart_or_a_reason():
    without = {rel for rel in JAX_MODULES if not _counterpart(rel).exists()}
    assert without == set(NO_PORT_MODULES), f"JAX modules with no port module: {sorted(without)}"
    listed = set(MODULE_NO_PORT) | set(MODULE_RENAMED) | set(COUNTERPART)
    assert listed <= set(JAX_MODULES), f"entries for modules the JAX package lacks: {sorted(listed - set(JAX_MODULES))}"


@pytest.mark.parametrize("rel", [rel for rel in JAX_MODULES if rel not in NO_PORT_MODULES])
def test_every_public_name_of_a_jax_module_is_in_its_counterpart(rel):
    names = _public_top_level(ROOT / "semanticlens_tpu" / rel)
    port = importlib.import_module(_module_name(_counterpart(rel)))
    no_port, renamed = MODULE_NO_PORT.get(rel, {}), MODULE_RENAMED.get(rel, {})
    missing = {n for n in names - set(no_port) - set(renamed) if not hasattr(port, n)}
    assert not missing, f"semanticlens_tpu/{rel} defines {sorted(missing)}, which {port.__name__} lacks"
    assert set(no_port) | set(renamed) <= names, f"stale entries for {rel}: {sorted(set(no_port) | set(renamed) - names)}"
    assert not [n for n in no_port if hasattr(port, n)], f"now ported, drop from MODULE_NO_PORT: {rel}"
    assert all(hasattr(port, n) for n in renamed.values())
