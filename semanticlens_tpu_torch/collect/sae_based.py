"""SAE component visualizer: audit sparse-autoencoder latents as components.

Counterpart of ``semanticlens_tpu.collect.sae_based``. The subject model is
wrapped with :class:`~semanticlens_tpu_torch.sae.SAESubjectModel`, whose
virtual tap ``"{layer}.sae"`` yields the SAE code field, and everything else
is :class:`~semanticlens_tpu_torch.collect.activation_based.ActivationComponentVisualizer`:
the fused Collect+Embed pass, checkpoints, caching in the reference format
under ``{cache_dir}/SAEComponentVisualizer/{dataset}/{base}-sae_{layer}_{n}k{k}_{digest}``
(the JAX package's directory, so either package loads the other's cache),
and the ``Lens`` Analyze stage.
"""

from __future__ import annotations

import logging
from typing import Mapping

from semanticlens_tpu_torch.collect.activation_based import ActivationComponentVisualizer
from semanticlens_tpu_torch.models.base import SubjectModel
from semanticlens_tpu_torch.ops import aggregators
from semanticlens_tpu_torch.sae import SAEConfig, SAESubjectModel, train_sae_on_layer

logger = logging.getLogger(__name__)


class SAEComponentVisualizer(ActivationComponentVisualizer):
    """Collect concept examples for each latent of an SAE trained on a layer.

    Parameters (beyond the base visualizer's)
    ----------
    model : the *base* subject model (not pre-wrapped).
    layer_name : single tap the SAE was trained on.
    sae_params : trained SAE parameters (numpy or tensors, the JAX layout);
        the trainers stamp the encode-time sparsity in as ``"k"``.
    k : override of the encode-time TopK sparsity (0 = ReLU encoder);
        defaults to the stored value; raises if neither is available or
        both are given and disagree.
    mesh : optional ``DeviceMesh``: data-parallel collect, and data-parallel
        training in :meth:`train` (see ``sae.train_sae_on_layer``).

    The per-image score of a latent defaults to the max of its code over
    positions (``aggregate_max_auto``): sparse codes make the mean
    uninformative.
    """

    def __init__(
        self,
        model: SubjectModel,
        dataset_model,
        dataset_fm,
        layer_name: str,
        sae_params: Mapping,
        num_samples: int,
        *,
        k: int | None = None,
        aggregate_fn=None,
        cache_dir: str | None = None,
        mesh=None,
        params=None,
        model_preprocess=None,
    ):
        base_params = params if params is not None else getattr(model, "params", None)
        if base_params is None:
            raise ValueError("Model weights required: pass `params=` or set `model.params`.")
        wrapped = SAESubjectModel(model, layer_name, sae_params, k=k, base_params=base_params)
        self.base_model = model
        self.sae_layer = layer_name
        super().__init__(
            wrapped,
            dataset_model,
            dataset_fm,
            layer_names=[wrapped.sae_tap],
            num_samples=num_samples,
            aggregate_fn=aggregate_fn or aggregators.aggregate_max_auto,
            cache_dir=cache_dir,
            mesh=mesh,
            params=wrapped.params,
            model_preprocess=model_preprocess,
        )

    @staticmethod
    def train(
        model: SubjectModel,
        dataset,
        layer_name: str,
        cfg: SAEConfig,
        *,
        params=None,
        batch_size: int = 64,
        epochs: int = 1,
        mesh=None,
        model_preprocess=None,
        log_every: int = 0,
    ):
        """Train an SAE on ``layer_name``'s activations over ``dataset`` on
        ``model.device`` (:func:`semanticlens_tpu_torch.sae.train_sae_on_layer`)
        and return its parameters, ready for the constructor."""
        params = params if params is not None else getattr(model, "params", None)
        if params is None:
            raise ValueError("Model weights required: pass `params=` or set `model.params`.")
        sae_params, _stats, metrics = train_sae_on_layer(
            model, params, dataset, layer_name, cfg, batch_size=batch_size, epochs=epochs, mesh=mesh,
            input_preprocess=model_preprocess, log_every=log_every,
        )
        logger.info("trained SAE on %s: loss %.4g fvu %.3f l0 %.1f",
                    layer_name, metrics["loss"], metrics["fvu"], metrics["l0"])
        return sae_params
