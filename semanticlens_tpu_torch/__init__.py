"""semanticlens_tpu_torch: the PyTorch/CUDA port of ``semanticlens_tpu``.

A second package beside the JAX one, with the same module layout and public
names, running on one NVIDIA H100. It imports ``torch`` and never ``jax`` or
anything of ``semanticlens_tpu``. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.

Workflow (the JAX package's three stages):

1. **Collect** — ``collect.ActivationComponentVisualizer`` streams uint8
   batches (``data.ArrayDataset``, or a JPEG ``data.ImageFolder`` decoded on
   the card) through a tapped subject model (``models.ResNet``, or any
   ``torch.nn.Module`` through ``models.TorchSubjectModel``) and keeps a
   per-component streaming top-k on the card.
2. **Embed** — ``foundation_models.OpenClip`` embeds the same uploaded
   batches in the same pass; ``Lens.compute_concept_db`` caches the concept
   DB in the safetensors format the JAX package reads.
3. **Analyze** — ``scores`` and ``Lens`` probing; every cosine matrix runs
   through the hand-written CUDA kernel ``ops.cosine`` (``csrc/cosine.cu``).

Beyond the three stages: ``causal`` (ablation, patching, steering through
``models.interventions``), ``featviz`` and ``collect.SynthesisComponentVisualizer``
(synthesized concept examples), ``sae`` (sparse autoencoders and
transcoders), ``core`` and ``parallel`` (one process per card on
``torch.distributed``: data-parallel Collect, multi-process shards,
tensor-parallel subjects and towers), and the entry points ``python -m semanticlens_tpu_torch.full_audit``
(BASELINE config 5), ``.causal_audit``, ``.train_sae`` and ``.serve``.
"""

from semanticlens_tpu_torch import (
    causal,
    collect,
    core,
    data,
    foundation_models,
    models,
    ops,
    parallel,
    relevance,
    sae,
    scores,
    utils,
)
from semanticlens_tpu_torch.lens import Lens
from semanticlens_tpu_torch.scores import clarity_score, polysemanticity_score, redundancy_score

__all__ = [
    "causal",
    "collect",
    "core",
    "data",
    "foundation_models",
    "models",
    "ops",
    "parallel",
    "relevance",
    "sae",
    "scores",
    "utils",
    "Lens",
    "clarity_score",
    "polysemanticity_score",
    "redundancy_score",
]

__version__ = "0.1.0"
