"""Activation-based component visualizer — the Collect entry point.

Counterpart of ``semanticlens_tpu.collect.activation_based``: the same public
API, cache directory layout and on-disk format, on one CUDA card or, with
``mesh=``, data-parallel over one process per card (the engine splits
every batch; cache files are written by global rank 0 while the other
ranks wait at a barrier). When
one raw-image dataset serves both the subject model and the foundation model,
``_compute_concept_db`` runs the fused single pass
(:meth:`~semanticlens_tpu_torch.collect.engine.CollectEngine.run_fused`).

With a cache root, every sweep checkpoints every ``checkpoint`` samples
(512 by default) under ``storage_dir/_checkpoint-collect``, ``-fused`` or
``-embed`` and resumes from there after a crash; the directory is cleared
once the sweep's results are stored.

``visualize_components`` composes each component's top examples into one
uint8 image, laid out as the JAX package's matplotlib figure is (ceil(sqrt)
columns, one panel per component), and writes it as a PNG with a stdlib
writer under the JAX package's file name. The card has neither matplotlib
nor PIL, so panels carry no titles.
"""

from __future__ import annotations

import logging
import math
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch

from semanticlens_tpu_torch.collect.activation_caching import ActMaxCache
from semanticlens_tpu_torch.collect.base import AbstractComponentVisualizer
from semanticlens_tpu_torch.collect.engine import CollectEngine
from semanticlens_tpu_torch.core.mesh import barrier, check_mesh, is_writer
from semanticlens_tpu_torch.data.dataset import _extract_image
from semanticlens_tpu_torch.models.base import SubjectModel, validate_layers
from semanticlens_tpu_torch.ops import aggregators
from semanticlens_tpu_torch.utils.helper import get_fallback_name
from semanticlens_tpu_torch.utils.profiling import count, span

logger = logging.getLogger(__name__)


class MissingNameWarning(UserWarning):
    """Raised when a model/dataset lacks the ``.name`` needed for stable caching."""


def gather_concept_db(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The concept DB of one layer: (C, k, D) rows of the (N, D) embedding ``table`` at the (C, k) ``ids``.

    Equal to ``table[ids]`` with the rows of the sentinel slots (``ids < 0``)
    zero, in one pass: the table gains one zero row, the sentinels point at
    it, and ``torch.index_select`` copies every (component, sample) row once,
    split over torch's intra-op threads, into an array numpy allocated and
    the caller owns. An id at or past N raises numpy's IndexError, as does
    any slot over an empty table (an empty dataset leaves only sentinels).
    """
    n, d = table.shape
    if ids.size and max(int(ids.max()), 0) >= n:
        raise IndexError(f"index {int(ids.max())} is out of bounds for axis 0 with size {n}")
    padded = torch.from_numpy(table)
    padded = torch.cat([padded, padded.new_zeros(1, d)])
    rows = torch.as_tensor(ids.reshape(-1), dtype=torch.int64)
    out = np.empty((*ids.shape, d), table.dtype)
    torch.index_select(padded, 0, rows.masked_fill(rows < 0, n), out=torch.from_numpy(out).view(ids.size, d))
    return out


class ActivationComponentVisualizer(AbstractComponentVisualizer):
    """Finds concept examples by activation maximization over a dataset.

    Parameters
    ----------
    model : SubjectModel; weights from ``params`` or ``model.params``, run on
        ``model.device``. A ``.name`` attribute is recommended for caching.
    dataset_model : dataset for the subject model.
    dataset_fm : dataset of raw images for the foundation model; must match
        ``dataset_model`` in length and order.
    layer_names : taps to analyze (torch-style names, e.g. ``"layer4"``).
    num_samples : top-k examples kept per component.
    aggregate_fn : activation reducer; defaults to spatial mean.
    cache_dir : root for cached artifacts; None disables caching.
    mesh : optional ``DeviceMesh`` (``core.data_mesh()``): every rank runs
        the visualizer on its rows of each batch (see ``CollectEngine``).
    params : optional explicit parameter dict.
    model_preprocess : optional device-side fn mapping a raw batch (uint8
        NHWC) to the subject model's input; defaults to a float32 cast.
    """

    def __init__(
        self,
        model: SubjectModel,
        dataset_model,
        dataset_fm,
        layer_names: list[str],
        num_samples: int,
        aggregate_fn=None,
        cache_dir: str | None = None,
        mesh=None,
        params=None,
        model_preprocess=None,
    ):
        self.mesh = check_mesh(mesh)
        self.model = model
        self.params = params if params is not None else getattr(model, "params", None)
        if self.params is None:
            raise ValueError("Model weights required: pass `params=` or set `model.params`.")
        self.device = model.device
        self.dataset = dataset_model
        self.dataset_fm = dataset_fm
        self._cache_root = None if cache_dir is None else Path(cache_dir)
        if self._cache_root is not None:
            self._cache_root.mkdir(parents=True, exist_ok=True)
        self._validate_args()

        self.layer_names = list(layer_names)
        validate_layers(self.model, self.layer_names)
        if aggregate_fn is None:
            logger.warning("No aggregation_fn provided using default: aggregate_conv_mean")
            aggregate_fn = aggregators.aggregate_conv_mean

        self.actmax_cache = ActMaxCache(
            self.layer_names, n_collect=num_samples, aggregation_fn=aggregate_fn, device=self.device
        )
        self.engine = CollectEngine(
            model=self.model,
            layer_names=self.layer_names,
            aggregation_fn=aggregate_fn,
            n_collect=num_samples,
            mesh=mesh,
            input_preprocess=model_preprocess,
        )
        if self.caching:
            try:
                self.actmax_cache.load(self.storage_dir)
            except FileNotFoundError:
                logger.info(f"Results will be stored in {self.storage_dir}")

    # ------------------------------------------------------------- validation
    def _validate_args(self):
        """Stable names are required for cache identity; fall back to
        sha256-of-repr with a warning."""
        for what, obj in (("Model", self.model), ("Dataset", self.dataset)):
            if not hasattr(obj, "name"):
                name = get_fallback_name(obj)
                if self.caching:
                    warnings.warn(
                        f"{what} does not have a name attribute, which is required for reliable "
                        f"caching.\nUsing a fallback name: {name}.",
                        MissingNameWarning,
                        stacklevel=3,
                    )
                obj.name = name
        if len(self.dataset) != len(self.dataset_fm):
            raise ValueError(
                "Model and foundation model datasets should have the same length.",
                (len(self.dataset), len(self.dataset_fm)),
            )

    # -------------------------------------------------------------- properties
    @property
    def caching(self) -> bool:
        return self._cache_root is not None

    @property
    def storage_dir(self) -> Path:
        """``{cache_root}/ActivationComponentVisualizer/{dataset}/{model}``."""
        if self._cache_root is None:
            raise ValueError("No cache dir provided")
        return self._cache_root / self.__class__.__name__ / self.dataset.name / self.model.name

    @property
    def metadata(self) -> dict[str, str]:
        return {**self.actmax_cache.metadata, "dataset": self.dataset.name, "model": self.model.name}

    @property
    def embedding_table(self) -> np.ndarray | None:
        """(N, D) full-dataset FM embedding table from the last concept-DB
        computation, or None before one ran."""
        return getattr(self, "_embedding_table", None)

    # --------------------------------------------------------------- pipeline
    def run(self, batch_size: int = 32, **kwargs):
        """Collect per-component top activating samples (cache-or-compute).

        ``checkpoint`` (samples between sweep checkpoints, default 512; 0 turns
        them off) applies when a cache root is set. Returns ``{layer: ActMax}``.
        """
        checkpoint = kwargs.get("checkpoint", 512)
        if self._cache_root is not None:
            try:
                self.actmax_cache.load(self.storage_dir)
                return self.actmax_cache.cache
            except FileNotFoundError:
                pass
        return self._run(batch_size=batch_size, checkpoint=checkpoint)

    def _checkpoint_dir(self, kind: str, checkpoint: int):
        """``storage_dir/_checkpoint-{kind}`` when checkpoints are on and a cache root is set."""
        if not checkpoint or self._cache_root is None:
            return None
        return self.storage_dir / f"_checkpoint-{kind}"

    @staticmethod
    def _every(ckpt_dir, checkpoint: int, batch_size: int) -> int:
        """Checkpoint interval in batches."""
        return max(1, checkpoint // batch_size) if ckpt_dir is not None else 0

    def _run(self, batch_size: int = 64, checkpoint: int = 512):
        ckpt_dir = self._checkpoint_dir("collect", checkpoint)
        states, n_seen = self.engine.run(self.params, self.dataset, batch_size, checkpoint_dir=ckpt_dir,
                                         checkpoint_every=self._every(ckpt_dir, checkpoint, batch_size))
        self._ingest(states, n_seen)
        self._clear_checkpoint(ckpt_dir)
        return self.actmax_cache.cache

    def _clear_checkpoint(self, ckpt_dir):
        """Remove a finished sweep's checkpoint (global rank 0 under a mesh, then a barrier)."""
        if ckpt_dir is not None and is_writer(self.mesh):
            self.engine.clear_checkpoint(ckpt_dir)
        if self.mesh is not None:
            barrier()

    def _ingest(self, states, n_seen: int):
        for name, state in states.items():
            act_max = self.actmax_cache[name]
            act_max.n_latents = int(state.values.shape[0])
            act_max.state = state
            self.actmax_cache.sample_idx_counter[name] = n_seen
        if self._cache_root is not None and is_writer(self.mesh):
            self.actmax_cache.store(self.storage_dir)
        if self.mesh is not None:
            barrier()

    def _compute_concept_db(self, fm, batch_size: int = 32, checkpoint: int = 512, **kwargs):
        """Collect, embed the full FM dataset, gather per-component embeddings.

        ``checkpoint``: samples between sweep checkpoints (with a cache root).
        Returns ``{layer: (n_components, n_samples, D) float32 numpy}``; −1
        sentinel slots become zero rows, as in the JAX package.
        """
        if self.dataset_fm is self.dataset and not self._has_collect_cache():
            embeds = self._run_fused(fm, batch_size, checkpoint=checkpoint)
        else:
            self.run(batch_size=batch_size, checkpoint=checkpoint, **kwargs)
            embeds = self._embed_vision_dataset(fm, batch_size, checkpoint=checkpoint, **kwargs)
        self._embedding_table = embeds
        concept_db = {}
        with span("concept_db.gather"):
            for layer_name in self.layer_names:
                db = gather_concept_db(embeds, self.get_max_reference(layer_name))
                count("concept_db.bytes", db.nbytes)
                concept_db[layer_name] = db
        return concept_db

    def _has_collect_cache(self) -> bool:
        if self._cache_root is None:
            return False
        return all(
            (self.storage_dir / self.actmax_cache._layer_fname(name)).exists()
            for name in self.layer_names
        )

    def _run_fused(self, fm, batch_size: int, checkpoint: int = 0) -> np.ndarray:
        """One pass over the raw dataset: collect top-k AND embed every image.

        With ``checkpoint`` and a cache root the sweep persists under
        ``storage_dir/_checkpoint-fused``, cleared only once the actmax cache
        is stored (clearing first would reopen the crash window). The batch
        is already this rank's rows, so the FM's unsplit encode embeds it.
        """
        ckpt_dir = self._checkpoint_dir("fused", checkpoint)
        states, embeds, n_seen = self.engine.run_fused(
            self.params, self.dataset, batch_size, _embed_fn(fm), checkpoint_dir=ckpt_dir,
            checkpoint_every=self._every(ckpt_dir, checkpoint, batch_size),
        )
        with span("concept_db.ingest"):
            self._ingest(states, n_seen)
        if embeds.shape[0] != n_seen:
            raise RuntimeError("Number of embeddings does not match number of ids!")
        self._clear_checkpoint(ckpt_dir)
        return embeds

    def _embed_vision_dataset(self, fm, batch_size: int, checkpoint: int = 512, **kwargs) -> np.ndarray:
        """Embed every sample of ``dataset_fm`` once → (N, D) float32 (``CollectEngine.run_embed``).

        With a cache root, finished rows persist every ``checkpoint`` samples
        under ``storage_dir/_checkpoint-embed`` and an interrupted embed
        resumes from there; the directory is cleared once the table is whole.
        """
        n = len(self.dataset_fm)
        ckpt_dir = self._checkpoint_dir("embed", checkpoint)
        embeds = self.engine.run_embed(self.dataset_fm, batch_size, _embed_fn(fm), device=fm.device,
                                       checkpoint_dir=ckpt_dir,
                                       checkpoint_every=self._every(ckpt_dir, checkpoint, batch_size))
        self._clear_checkpoint(ckpt_dir)
        if embeds.shape[0] != n:
            raise RuntimeError("Number of embeddings does not match number of ids!")
        return embeds

    def get_max_reference(self, layer_name: str) -> np.ndarray:
        """(n_components, n_samples) dataset indices of the top examples."""
        self._check_layer_name(layer_name)
        return self.actmax_cache.cache[layer_name].sample_ids

    # ------------------------------------------------------------------- viz
    def visualize_components(
        self,
        component_ids,
        layer_name: str,
        n_samples: int = 9,
        nrows: int = 3,
        fname=None,
        denormalization_fn=None,
    ):
        """Compose a grid of top activating samples per component; save it as a PNG.

        The JAX package's layout (ceil(sqrt) columns of panels, one panel
        per component, each panel ``_make_grid`` of the component's top
        ``n_samples`` with ``nrows`` images per row), composed into one
        uint8 (H, W, 3) array; float panels (after a denormalization) are
        clipped to [0, 1] and scaled to 0–255. No titles are drawn. With
        caching the image goes to ``storage_dir/plots/`` under the JAX
        package's name, which is returned; without, returns None.
        """
        self._check_layer_name(layer_name)
        post_process = self._resolve_denormalization(denormalization_fn)
        component_ids = np.asarray(component_ids)
        grids = [
            self._component_example_grid(int(c), layer_name, n_samples, nrows, post_process)
            for c in component_ids
        ]
        n_cols = max(1, math.isqrt(len(grids) - 1) + 1) if grids else 1
        figure = _make_grid([_to_uint8(g) for g in grids], nrow=n_cols)
        if not self.caching:
            if fname:
                logger.warning(
                    "Failed to save visualization. Caching is not enabled in the "
                    "ComponentVisualizer (`cv.caching: False`)"
                )
            return None
        stem = "-".join(str(int(c)) for c in component_ids)
        fdir = self.storage_dir / "plots"
        fdir.mkdir(parents=True, exist_ok=True)
        fpath = fdir / ((fname + "_" if fname else "") + f"{layer_name}_{stem}.png")
        write_png(fpath, figure)
        logger.info(f"Saved visualization to {fpath}")
        return fpath

    def _resolve_denormalization(self, denormalization_fn):
        """The de-normalizer for raw dataset items: the dataset's attribute wins, then
        the argument, then identity (reference precedence)."""
        ds_fn = getattr(self.dataset, "denormalization_fn", None)
        if ds_fn is not None:
            return ds_fn
        if denormalization_fn is not None:
            return denormalization_fn
        logger.debug("Dataset does not have denormalization_fn method.")
        return lambda x: x

    def _component_example_grid(self, component_id, layer_name, n_samples, nrows, post_process):
        """Tile one component's top-``n_samples`` dataset items into a grid.

        ``post_process`` receives the raw dataset item; numpy conversion after.
        """
        ids = self.get_max_reference(layer_name)[component_id][:n_samples]
        imgs = [np.asarray(post_process(_extract_image(self.dataset[int(i)]))) for i in ids]
        return _make_grid(imgs, nrow=nrows)

    def _check_layer_name(self, layer_name: str):
        if layer_name not in self.layer_names:
            raise ValueError(f"Layer '{layer_name}' not found in model layers: {self.layer_names}")


def _embed_fn(fm):
    """``raw device batch → (B, D)`` of the FM: its preprocess, then its encode of the rows it is
    given (``encode_image_local`` where the tower splits ``encode_image`` over a data mesh, since
    the engine hands it this rank's rows, else ``encode_image``)."""
    encode = getattr(fm, "encode_image_local", fm.encode_image)

    def embed_fn(raw_device_batch):
        with span("embed.preprocess", raw_device_batch.device):
            x = fm.preprocess(raw_device_batch)
        with span("embed.encode", raw_device_batch.device):
            return encode(x)

    return embed_fn


def _make_grid(imgs: list[np.ndarray], nrow: int = 3) -> np.ndarray:
    """Tile (H, W, C) images into a grid, row-major, ``nrow`` images per row."""
    imgs = [np.atleast_3d(np.asarray(i)) for i in imgs]
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    c = imgs[0].shape[2]
    n = len(imgs)
    ncols = min(nrow, n)
    nrows_ = (n + ncols - 1) // ncols
    grid = np.zeros((nrows_ * h, ncols * w, c), imgs[0].dtype)
    for i, img in enumerate(imgs):
        r, col = divmod(i, ncols)
        grid[r * h : r * h + img.shape[0], col * w : col * w + img.shape[1]] = img
    return grid


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 stays; floats (images in [0, 1], as matplotlib shows them) clip and scale to 0–255."""
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(np.asarray(img, np.float64), 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path, image: np.ndarray) -> None:
    """Write an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 array as an 8-bit PNG (zlib, no filter)."""
    image = np.ascontiguousarray(np.atleast_3d(image))
    if image.dtype != np.uint8 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png takes uint8 with 1, 3 or 4 channels, got {image.dtype} {image.shape}")
    h, w, c = image.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
