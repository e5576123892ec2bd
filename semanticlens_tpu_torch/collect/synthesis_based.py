"""Synthesis component visualizer: dataset-free concept examples.

Counterpart of ``semanticlens_tpu.collect.synthesis_based``: each
component's concept examples are *synthesized* by
:func:`semanticlens_tpu_torch.featviz.synthesize` — gradient ascent on the
input until the component fires maximally — then embedded by the
foundation model like any other evidence. The concept DB has the standard
``(n_components, n_samples, embed_dim)`` shape, so ``Lens`` probing, scores
and labels run unchanged on components whose concept never appears in a
dataset.

``n_samples`` here means *synthesis variants*: each component is optimized
``num_samples`` times, each canvas with its own init and augmentation
draws. The gallery file and its name are the JAX package's, so a gallery
either package writes loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
from pathlib import Path

import numpy as np
import torch

from semanticlens_tpu_torch.collect.activation_based import _make_grid, _to_uint8, write_png
from semanticlens_tpu_torch.collect.base import AbstractComponentVisualizer
from semanticlens_tpu_torch.core.mesh import barrier, check_mesh, is_writer
from semanticlens_tpu_torch.featviz import SynthesisConfig, synthesize
from semanticlens_tpu_torch.models.base import validate_layers
from semanticlens_tpu_torch.utils import safetensors_io
from semanticlens_tpu_torch.utils.helper import get_fallback_name

logger = logging.getLogger(__name__)


class SynthesisComponentVisualizer(AbstractComponentVisualizer):
    """Synthesize concept examples for components of the given layers.

    Parameters
    ----------
    model : ``SubjectModel`` with ``.params`` (or pass ``params=``).
    layer_names : taps to synthesize for.
    n_components : components per layer — dict ``{layer: n}`` or one int for
        all layers (synthesis has no dataset sweep to infer widths from).
    num_samples : synthesis variants per component (concept-DB rows).
    aggregate_fn : Collect-stage aggregator mapping the tapped activation to
        ``(batch, components)``.
    image_size / model_preprocess / config / seed / loop : forwarded to
        :func:`semanticlens_tpu_torch.featviz.synthesize`.
    max_batch : canvases per ``synthesize`` call (components × variants are
        chunked to this size; chunk ``start`` uses seed ``seed + start`` and
        a ragged tail is padded with repeats, as in the JAX package).
    cache_dir : when set, the synthesized gallery persists as
        ``synthesis-{config_digest}-{num_samples}-{layer}.safetensors`` and
        reloads instead of re-optimizing; the digest covers every parameter
        that changes the pixels or gallery shape (config, seed, image_size,
        n_components, max_batch, aggregator), and a loaded gallery is
        shape-validated with fallback to re-synthesis.
    mesh : optional ``DeviceMesh``: each ``synthesize`` call splits its
        canvases over the ``"data"`` axis (``max_batch``, and a single
        shorter chunk, must be multiples of its size); global rank 0 writes
        the gallery.
    """

    def __init__(
        self,
        model,
        layer_names,
        n_components,
        num_samples: int,
        aggregate_fn,
        *,
        image_size: int = 224,
        model_preprocess=None,
        config: SynthesisConfig | None = None,
        seed: int = 0,
        max_batch: int = 64,
        cache_dir: str | None = None,
        params=None,
        loop: str = "host",
        mesh=None,
    ):
        validate_layers(model, layer_names)
        self.mesh = check_mesh(mesh)
        self.model = model
        self.params = params if params is not None else model.params
        self.layer_names = list(layer_names)
        if isinstance(n_components, int):
            n_components = {name: n_components for name in self.layer_names}
        missing = [n for n in self.layer_names if n not in n_components]
        if missing:
            raise ValueError(f"n_components missing entries for layers: {missing}")
        self.n_components = {n: int(n_components[n]) for n in self.layer_names}
        self.num_samples = int(num_samples)
        self.aggregate_fn = aggregate_fn
        self.image_size = int(image_size)
        self.model_preprocess = model_preprocess
        self.config = config or SynthesisConfig()
        self.seed = int(seed)
        self.max_batch = int(max_batch)
        self.loop = loop
        self._cache_dir = Path(cache_dir) if cache_dir else None
        if not hasattr(self.model, "name"):
            self.model.name = get_fallback_name(self.model)
        # gallery[layer]: images (C, V, H, W, 3) float32 [0,1]; objective (C, V)
        self.gallery: dict[str, np.ndarray] = {}
        self.objectives: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ contract
    @property
    def caching(self) -> bool:
        return self._cache_dir is not None

    @property
    def storage_dir(self) -> Path:
        return self._cache_dir / self.__class__.__name__ / "synthetic" / self.model.name

    @property
    def metadata(self) -> dict[str, str]:
        return {
            "dataset": "synthetic",
            "model": self.model.name,
            "strategy": "feature-synthesis",
            # a changed synthesis hyper-parameter misses both the gallery and the concept-DB cache
            "config": self._config_digest(),
            "num_samples": str(self.num_samples),
        }

    def _config_digest(self) -> str:
        # Everything that changes the synthesized pixels or the gallery's shape, as the JAX
        # package folds it (the same repr, so the same digest): the config, seed, canvas size,
        # per-layer component counts, max_batch (chunk seeds are seed + start) and the aggregator.
        agg_id = getattr(
            self.aggregate_fn, "__qualname__", getattr(self.aggregate_fn, "__name__", None)
        ) or repr(self.aggregate_fn)
        key = repr((
            self.config._key(),
            self.seed,
            self.image_size,
            sorted(self.n_components.items()),
            self.max_batch,
            agg_id,
        ))
        return hashlib.sha256(key.encode()).hexdigest()[:12]

    def _gallery_path(self, layer_name: str) -> Path:
        return self.storage_dir / (
            f"synthesis-{self._config_digest()}-{self.num_samples}-{layer_name}.safetensors"
        )

    # ----------------------------------------------------------------- run
    def run(self, **kwargs):
        """Synthesize (or load the cached gallery for) every layer."""
        for layer_name in self.layer_names:
            if layer_name in self.gallery:
                continue
            if (
                self.caching
                and self._gallery_path(layer_name).exists()
                and self._load_gallery(layer_name)
            ):
                continue
            self._synthesize_layer(layer_name)
            if self.caching and is_writer(self.mesh):
                self._save_gallery(layer_name)
            if self.caching and self.mesh is not None:
                barrier()
        return self.gallery

    def _synthesize_layer(self, layer_name: str) -> None:
        n_comp = self.n_components[layer_name]
        # Work items: component c, variant v, chunked into max_batch canvases.
        items = [(c, v) for c in range(n_comp) for v in range(self.num_samples)]
        imgs = np.zeros(
            (n_comp, self.num_samples, self.image_size, self.image_size, 3), np.float32
        )
        objs = np.zeros((n_comp, self.num_samples), np.float32)
        for start in range(0, len(items), self.max_batch):
            chunk = items[start : start + self.max_batch]
            if len(chunk) < self.max_batch and start > 0:
                # pad the ragged tail to the chunk shape with repeats (the JAX package's draws)
                chunk = chunk + chunk[-1:] * (self.max_batch - len(chunk))
            images, objective = synthesize(
                self.model,
                self.params,
                layer_name,
                [c for c, _ in chunk],
                self.aggregate_fn,
                image_size=self.image_size,
                model_preprocess=self.model_preprocess,
                config=self.config,
                seed=self.seed + start,
                loop=self.loop,
                mesh=self.mesh,
            )
            for i, (c, v) in enumerate(items[start : start + self.max_batch]):
                imgs[c, v] = images[i]
                objs[c, v] = objective[i]
            logger.info(
                f"{layer_name}: synthesized {min(start + self.max_batch, len(items))}"
                f"/{len(items)} canvases"
            )
        self.gallery[layer_name] = imgs
        self.objectives[layer_name] = objs

    # ------------------------------------------------------------- caching
    def _save_gallery(self, layer_name: str) -> None:
        path = self._gallery_path(layer_name)
        path.parent.mkdir(parents=True, exist_ok=True)
        safetensors_io.save_file(
            {
                "images": torch.from_numpy(
                    np.ascontiguousarray(np.clip(self.gallery[layer_name] * 255.0, 0, 255), np.uint8)
                ),
                "objective": torch.from_numpy(np.ascontiguousarray(self.objectives[layer_name], np.float32)),
            },
            path,
            metadata={k: str(v) for k, v in self.metadata.items()} | {"config": json.dumps(self.config._key())},
        )
        logger.info(f"Saved synthesis gallery to {path}")

    def _load_gallery(self, layer_name: str) -> bool:
        data = {k: v.numpy() for k, v in safetensors_io.load_file(self._gallery_path(layer_name)).items()}
        expected = (self.n_components[layer_name], self.num_samples)
        if data["images"].shape[:2] != expected or data["objective"].shape != expected:
            # a stale or foreign file at the digest path re-synthesizes, never loads wrong-sized
            logger.warning(
                f"Cached gallery for {layer_name} has shape "
                f"{data['images'].shape[:2]}, expected {expected}; re-synthesizing"
            )
            return False
        self.gallery[layer_name] = data["images"].astype(np.float32) / 255.0
        self.objectives[layer_name] = data["objective"]
        logger.info(f"Loaded synthesis gallery for {layer_name}")
        return True

    # ------------------------------------------------------------- analyze
    def _compute_concept_db(self, fm, batch_size: int = 64, **kwargs) -> dict:
        """Embed every synthesized variant: (C, V, embed_dim) float32 numpy per layer."""
        self.run()
        concept_db = {}
        for layer_name in self.layer_names:
            imgs = self.gallery[layer_name]
            c, v = imgs.shape[:2]
            flat = (imgs.reshape(c * v, *imgs.shape[2:]) * 255.0).astype(np.uint8)
            rows = []
            with torch.inference_mode():
                for s in range(0, len(flat), batch_size):
                    chunk = torch.from_numpy(flat[s : s + batch_size]).to(fm.device)
                    rows.append(fm.encode_image(fm.preprocess(chunk)).to(torch.float32))
            concept_db[layer_name] = torch.cat(rows).cpu().numpy().reshape(c, v, -1)
        return concept_db

    def get_max_reference(self, layer_name: str) -> np.ndarray:
        """(n_components, num_samples) indices into the flattened gallery."""
        c, v = self.n_components[layer_name], self.num_samples
        return np.arange(c * v, dtype=np.int64).reshape(c, v)

    def get_images(self, layer_name: str, component_id: int) -> np.ndarray:
        """(num_samples, H, W, 3) synthesized variants of one component."""
        self.run()
        return self.gallery[layer_name][int(component_id)]

    def visualize_components(self, component_ids, layer_name: str, fname=None):
        """One panel per component of its synthesized variants, as a PNG.

        The JAX package's layout (ceil(sqrt) columns of panels, each panel a
        row of the component's ``num_samples`` variants) composed into one
        uint8 image without titles (matplotlib, which draws them in the JAX
        package, is not on the card). Saved under ``storage_dir/plots`` when
        caching is enabled and the path returned, else None.
        """
        self._check_layer(layer_name)
        self.run()
        component_ids = np.asarray(component_ids)
        grids = [
            _to_uint8(_make_grid(list(self.gallery[layer_name][int(c)]), nrow=self.num_samples))
            for c in component_ids
        ]
        n_cols = max(1, math.isqrt(max(0, len(grids) - 1)) + 1)
        figure = _make_grid(grids, nrow=n_cols)
        if not self.caching:
            return None
        stem = "-".join(str(int(c)) for c in component_ids)
        fdir = self.storage_dir / "plots"
        fdir.mkdir(parents=True, exist_ok=True)
        fpath = fdir / ((fname + "_" if fname else "") + f"{layer_name}_{stem}.png")
        write_png(fpath, figure)
        logger.info(f"Saved synthesis visualization to {fpath}")
        return fpath

    def _check_layer(self, layer_name: str):
        if layer_name not in self.layer_names:
            raise ValueError(
                f"Layer '{layer_name}' not found in visualizer layers: {self.layer_names}"
            )
