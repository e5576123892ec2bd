"""The port's public names against the JAX package's, subpackage by subpackage.

Every name in a JAX ``__all__`` is in the port's ``__all__``, or is listed
below: under the ROADMAP item that ports it (queue 1), or as a rename with
its reason. A new JAX export with neither a port nor an entry here fails
the test; so does a queued name that the port now has (move it out of the
queue). The port may export more (``Subset``, the interventions names, …).
"""

import importlib

import pytest
import torch

torch.set_num_threads(2)

SUBPACKAGES = ["", ".causal", ".collect", ".core", ".data", ".featviz", ".foundation_models", ".models", ".ops",
               ".parallel", ".relevance", ".scores", ".utils"]

# JAX names the port does not have yet, by the ROADMAP queue-1 item that ports them.
QUEUED = {
    ".data": {"GrainDataset": "item 14"},  # needs grain, which the card lacks
    ".models": {"FlaxSubjectModel": "item 14"},  # wraps flax.linen, which the card does not have
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
    queued, renamed = QUEUED.get(sub, {}), RENAMED.get(sub, {})
    missing = jax_names - port_names - set(queued) - set(renamed)
    assert not missing, f"semanticlens_tpu{sub} exports {sorted(missing)}: port them or queue them in ROADMAP.md"
    assert not (set(queued) & port_names), f"now ported, drop from QUEUED: {sorted(set(queued) & port_names)}"
    assert set(queued) <= jax_names and set(renamed) <= jax_names
    assert set(renamed.values()) <= port_names
    for name in port_names:
        assert hasattr(port, name), f"semanticlens_tpu_torch{sub}.__all__ names {name}, which it lacks"


def test_queued_items_are_open_in_the_roadmap():
    from pathlib import Path

    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    for item in sorted({i for names in QUEUED.values() for i in names.values()}):
        assert f"**{item.capitalize()}:" in roadmap, f"{item} is not an open ROADMAP item"
