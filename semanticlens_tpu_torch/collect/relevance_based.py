"""Relevance-based component visualizer: attribution-selected concept examples.

Counterpart of ``semanticlens_tpu.collect.relevance_based``, with the same
constructor, cache layout (``{storage_dir}/{dataset}/{model}``, the ActMax
files of the activation visualizer) and results:

- the Collect sweep is the streaming engine in activation mode (crp's
  ``max_target="sum"`` is the spatial-sum aggregation), checkpointed under a
  directory keyed by the swept slice;
- ``get_max_reference`` computes LRP heatmaps
  (:mod:`semanticlens_tpu_torch.relevance.attribution`) for K components at
  a time, each over its own top images, in one forward and one backward on
  the card, and renders attribution-cropped examples
  (:func:`semanticlens_tpu_torch.utils.render.crop_and_mask_images` by
  default) as uint8 tensors where the JAX package returns PIL images;
- ``_compute_concept_db`` embeds the crops in flat fixed-size batches, so
  the concept DB reflects each component's receptive evidence.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from semanticlens_tpu_torch.collect.activation_caching import ActMaxCache
from semanticlens_tpu_torch.collect.base import AbstractComponentVisualizer
from semanticlens_tpu_torch.collect.engine import CollectEngine
from semanticlens_tpu_torch.core.mesh import all_reduce, barrier, check_mesh, is_writer, mesh_axis
from semanticlens_tpu_torch.data.dataset import Subset, get_image
from semanticlens_tpu_torch.models.base import validate_layers
from semanticlens_tpu_torch.models.torch_adapter import TorchSubjectModel
from semanticlens_tpu_torch.ops import aggregators
from semanticlens_tpu_torch.relevance.attribution import make_attribution_fn, make_batched_attribution_fn
from semanticlens_tpu_torch.utils.helper import get_fallback_name
from semanticlens_tpu_torch.utils.render import crop_and_mask_images

logger = logging.getLogger(__name__)

# Rank-dispatching reducers: conv (4D) and transformer (3D) taps under one name.
_AGG_BY_NAME = {
    "sum": aggregators.aggregate_sum_auto,
    "mean": aggregators.aggregate_mean_auto,
    "max": aggregators.aggregate_max_auto,
}


class RelevanceComponentVisualizer(AbstractComponentVisualizer):
    """Finds and renders concept examples with relevance attribution.

    Parameters
    ----------
    model : SubjectModel of the port (weights via ``params`` or
        ``model.params``); runs on ``model.device``.
    dataset : raw-image dataset (uint8/float HWC); also used for rendering.
    layer_names : str or list of taps to analyze.
    preprocess_fn : optional device-side input preprocessing for the model.
    composite : LRP composite ("epsilon_plus_flat", "epsilon", "gradient").
    aggregation_fn : activation target reducer name ("sum" | "mean" | "max").
    abs_norm : normalize heatmaps per image by their abs max.
    storage_dir : cache root (crp-style, "FeatureVisualization").
    device, cache : accepted for the reference's signature; the model's
        device is used.
    num_samples : top examples kept per component.
    plot_fn : heatmap renderer (default: square crop).
    mesh : optional ``DeviceMesh``: the activation sweep is data-parallel
        (``CollectEngine``), and ``_compute_concept_db`` splits the
        components over the ranks, each attributing and embedding its own,
        before the concept DB is summed across ranks. Cache files are
        written by global rank 0.
    """

    def __init__(
        self,
        model,
        dataset,
        layer_names,
        preprocess_fn=None,
        composite: str = "epsilon_plus_flat",
        aggregation_fn: str = "sum",
        abs_norm: bool = True,
        storage_dir: str | Path = "FeatureVisualization",
        device=None,
        num_samples: int = 100,
        cache=None,
        plot_fn=crop_and_mask_images,
        params=None,
        mesh=None,
    ):
        self.mesh = check_mesh(mesh)
        layer_names = [layer_names] if not isinstance(layer_names, list) else layer_names
        self.model = model
        self.params = params if params is not None else getattr(model, "params", None)
        if self.params is None:
            raise ValueError("Model weights required: pass `params=` or set `model.params`.")
        self.dataset = dataset
        self.layer_names = list(layer_names)
        validate_layers(self.model, self.layer_names)
        if isinstance(model, TorchSubjectModel):
            raise TypeError(
                "RelevanceComponentVisualizer needs the LRP rules of the port's functional "
                "layers; a TorchSubjectModel runs a module's own forward, which carries none. "
                "Use a native family (models.ResNet/VisionTransformer) for attribution-based "
                "collection."
            )

        self.preprocess_fn = preprocess_fn
        self.composite = composite
        self.aggregation_fn = aggregation_fn
        self.abs_norm = abs_norm
        self._storage_dir = Path(storage_dir)
        self.num_samples = num_samples
        self.plot_fn = plot_fn

        if not hasattr(self.model, "name"):
            self.model.name = get_fallback_name(self.model)
        if not hasattr(self.dataset, "name"):
            self.dataset.name = get_fallback_name(self.dataset)

        try:
            agg = _AGG_BY_NAME[aggregation_fn]
        except KeyError:
            raise ValueError(
                f"Unknown aggregation_fn '{aggregation_fn}'; expected one of {sorted(_AGG_BY_NAME)}"
            ) from None
        self.actmax_cache = ActMaxCache(self.layer_names, n_collect=num_samples, aggregation_fn=agg,
                                        device=self.model.device)
        self.engine = CollectEngine(
            model=self.model,
            layer_names=self.layer_names,
            aggregation_fn=agg,
            n_collect=num_samples,
            mesh=mesh,
            input_preprocess=preprocess_fn,
        )
        self._attribution_fns: dict[str, object] = {}
        self._ran = False
        if self.check_if_preprocessed():
            try:
                self.actmax_cache.load(self.storage_dir)
                self._ran = True
            except FileNotFoundError:
                # A cache written with another num_samples/aggregation: recompute on run().
                logger.info("Existing cache at %s does not match this configuration; "
                            "will recompute on run().", self.storage_dir)

    # ------------------------------------------------------------- properties
    @property
    def caching(self) -> bool:
        return True

    @property
    def storage_dir(self) -> Path:
        return self._storage_dir / self.dataset.name / self.model.name

    @property
    def metadata(self) -> dict:
        return {
            "preprocess_fn": str(self.preprocess_fn),
            "abs_norm": str(self.abs_norm),
            "aggregation_fn": self.aggregation_fn,
            "composite": self.composite,
            "num_samples": str(self.num_samples),
            "plot_fn": getattr(self.plot_fn, "__name__", str(self.plot_fn)),
            "layer_names": str(self.layer_names),
            "dataset": self.dataset.name,
            "model": self.model.name,
        }

    # ----------------------------------------------------------------- sweep
    def check_if_preprocessed(self) -> bool:
        """True iff every layer's cache file (this aggregation fn and num_samples) exists."""
        d = self.storage_dir
        if not d.is_dir():
            return False
        return all((d / self.actmax_cache._layer_fname(layer)).exists() for layer in self.layer_names)

    def run(self, composite=None, data_start=0, data_end=None, batch_size=32, checkpoint=500, **kwargs):
        """Activation-mode sweep: collect per-component top sample ids.

        Returns the per-layer ActMax cache, or the list of existing files if
        already preprocessed (the reference's contract). Ids index the full
        dataset also when the sweep covers ``[data_start, data_end)``.
        """
        if self.check_if_preprocessed():
            logger.info("Already preprocessed")
            self.actmax_cache.load(self.storage_dir)
            self._ran = True
            return [f.name for f in self.storage_dir.iterdir()
                    if any(layer in f.name for layer in self.layer_names)]

        data_end = len(self.dataset) if data_end is None else data_end
        # Keyed by slice: another slice's checkpoint holds other slice-local ids.
        ckpt_dir = self.storage_dir / f"_checkpoint-{data_start}-{data_end}" if checkpoint else None
        states, n_seen = self.engine.run(
            self.params,
            Subset(self.dataset, data_start, min(data_end, len(self.dataset))),
            batch_size,
            checkpoint_dir=ckpt_dir,
            checkpoint_every=max(1, checkpoint // batch_size) if checkpoint else 0,
        )
        for name, state in states.items():
            if data_start:
                state = state._replace(ids=torch.where(state.ids >= 0, state.ids + data_start, state.ids))
            act_max = self.actmax_cache[name]
            act_max.n_latents = int(state.values.shape[0])
            act_max.state = state
            self.actmax_cache.sample_idx_counter[name] = n_seen
        if is_writer(self.mesh):
            self.actmax_cache.store(self.storage_dir)
            if ckpt_dir is not None and ckpt_dir.exists():
                shutil.rmtree(ckpt_dir)  # the stored ActMax files supersede it
        if self.mesh is not None:
            barrier()
        self._ran = True
        return self.actmax_cache.cache

    def get_act_max_sample_ids(self, layer_name: str) -> np.ndarray:
        """(n_components, n_samples) top sample ids."""
        return self.actmax_cache[layer_name].sample_ids

    # ------------------------------------------------------------ attribution
    def _make_fn(self, make, layer_name: str):
        return make(
            _Preprocessed(self.model, self.preprocess_fn),
            layer_name,
            composite=self.composite,
            aggregation="sum" if self.aggregation_fn == "sum" else "max",
            abs_norm=self.abs_norm,
        )

    def _attribution_fn(self, layer_name: str):
        if layer_name not in self._attribution_fns:
            self._attribution_fns[layer_name] = self._make_fn(make_attribution_fn, layer_name)
        return self._attribution_fns[layer_name]

    def _batched_attribution_fn(self, layer_name: str):
        key = f"{layer_name}//batched"
        if key not in self._attribution_fns:
            self._attribution_fns[key] = self._make_fn(make_batched_attribution_fn, layer_name)
        return self._attribution_fns[key]

    def _images(self, ids: list[int]) -> torch.Tensor:
        """The dataset's images at ``ids``, stacked on the model's device."""
        base = getattr(self.dataset, "images", None)
        if base is not None:
            raw = np.asarray(base[np.asarray(ids)])
        else:
            raw = np.stack([get_image(self.dataset, i) for i in ids])
        return torch.from_numpy(raw).to(self.model.device)

    def get_max_reference(
        self, concept_ids, layer_name: str, n_ref: int | None = None, batch_size: int = 32
    ) -> dict:
        """Attribution-cropped reference images per concept: ``{concept_id: [uint8 (h, w, 3) tensor, ...]}``.

        K = max(1, min(32, batch_size // n_ref)) components are attributed per
        forward and backward, each over its own top images. Components with
        fewer than ``n_ref`` collected samples are padded (repeats of their
        first image) and trimmed, the last chunk is padded with its last
        component, as in the JAX package; components with no sample get an
        empty list and no device work.
        """
        if not self._ran:
            raise RuntimeError("Call run() first to collect maximally activating samples.")
        if isinstance(concept_ids, (int, np.integer)):
            concept_ids = [int(concept_ids)]
        n_ref = n_ref or min(self.num_samples, 8)

        ids_table = self.get_act_max_sample_ids(layer_name)
        per_cid_ids = {
            int(cid): [int(i) for i in ids_table[int(cid)][:n_ref] if i >= 0] for cid in concept_ids
        }
        out = {cid: [] for cid in per_cid_ids}
        work = [(cid, ids) for cid, ids in per_cid_ids.items() if ids]
        if not work:
            return out

        k_per_batch = max(1, min(32, batch_size // n_ref))
        if k_per_batch == 1:
            fn = self._attribution_fn(layer_name)
            for cid, ids in work:
                raw = self._images(ids)
                out[cid] = self.plot_fn(raw, fn(self.params, raw, cid))
            return out

        fn = self._batched_attribution_fn(layer_name)
        for chunk_start in range(0, len(work), k_per_batch):
            chunk = work[chunk_start : chunk_start + k_per_batch]
            padded = chunk + [chunk[-1]] * (k_per_batch - len(chunk))
            flat_ids = [i for _, ids in padded for i in ids + [ids[0]] * (n_ref - len(ids))]
            raws = self._images(flat_ids)
            raws = raws.reshape(k_per_batch, n_ref, *raws.shape[1:])
            heat = fn(self.params, raws, [cid for cid, _ in padded])
            for row, (cid, ids) in enumerate(chunk):
                out[cid] = self.plot_fn(raws[row][: len(ids)], heat[row][: len(ids)])
        return out

    # ------------------------------------------------------------ concept DB
    def _compute_concept_db(self, fm, batch_size: int = 32, n_ref: int | None = None, **kwargs):
        """Embed each component's attribution-cropped top examples.

        Under a mesh each rank takes a contiguous run of components. The
        crops of all (its) components are encoded in flat batches of
        ``batch_size`` (the last padded with its first crop); unfilled slots
        are zero rows. Returns ``{layer: (n_components, n_ref, D) float32 numpy}``.
        """
        if not self._ran:
            self.run(batch_size=batch_size)
        n_ref = n_ref or self.num_samples

        size, rank, group = mesh_axis(self.mesh, "data")
        encode = getattr(fm, "encode_image_local", fm.encode_image)
        concept_db = {}
        for layer_name in self.layer_names:
            n_components = self.get_act_max_sample_ids(layer_name).shape[0]
            per = -(-n_components // size)  # this rank's contiguous run of components
            mine = list(range(min(rank * per, n_components), min((rank + 1) * per, n_components)))
            refs = self.get_max_reference(mine, layer_name, n_ref, batch_size) if mine else {}

            flat: list = []
            spans: dict[int, tuple[int, int]] = {}
            for cid, crops in refs.items():
                spans[cid] = (len(flat), len(flat) + len(crops))
                flat.extend(crops)
            encoded_rows = None
            if flat:
                rows = []
                with torch.inference_mode():
                    for s in range(0, len(flat), batch_size):
                        chunk = flat[s : s + batch_size]
                        chunk = chunk + [chunk[0]] * (batch_size - len(chunk))
                        rows.append(encode(fm.preprocess(chunk)).float())
                encoded_rows = torch.cat(rows).cpu().numpy()[: len(flat)]
            embed_dim = encoded_rows.shape[-1] if encoded_rows is not None else 1
            if size > 1:  # a rank without crops learns the width from the others
                embed_dim = int(all_reduce(torch.tensor(embed_dim), group, dist.ReduceOp.MAX))
            db = np.zeros((n_components, n_ref, embed_dim), np.float32)
            for cid, (lo, hi) in spans.items():
                db[cid, : hi - lo] = encoded_rows[lo:hi]
            if size > 1:  # each component's rows come from exactly one rank
                db = all_reduce(torch.from_numpy(db), group).numpy()
            concept_db[layer_name] = db
        return concept_db

    def to(self, device):
        return self


class _Preprocessed:
    """Model view that applies the input preprocessing before ``apply``."""

    def __init__(self, model, preprocess_fn):
        self.model = model
        self.preprocess_fn = preprocess_fn
        self.device = model.device

    def apply(self, params, x, tap_names=()):
        if self.preprocess_fn is not None:
            x = self.preprocess_fn(x)
        return self.model.apply(params, x, tap_names)
