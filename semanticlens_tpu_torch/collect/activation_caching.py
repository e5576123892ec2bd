"""Collect-stage state and its safetensors persistence.

Counterpart of ``semanticlens_tpu.collect.activation_caching``: ``ActMax``
wraps one layer's device-resident :class:`~semanticlens_tpu_torch.ops.topk.TopKState`
and writes it with the same bytes, dtypes, metadata and file names as the
JAX package and the reference (bf16 ``activations``, int64 ``sample_ids``,
``{agg_fn}-{n_collect}-{layer}.safetensors``), so a cache written by either
package loads in the other. ``ActMaxCache`` manages the per-layer instances;
``ActCache`` captures raw activations for ad-hoc inspection.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from semanticlens_tpu_torch.ops import aggregators
from semanticlens_tpu_torch.ops.topk import TopKState, init_topk, topk_update
from semanticlens_tpu_torch.utils import safetensors_io
from semanticlens_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


DEFAULT_AGGREGATION_FUNCTION_MAP = {
    name: fn
    for name, fn in vars(aggregators).items()
    if callable(fn) and name.startswith(("aggregate_", "get_aggregate_"))
}


class ActMax:
    """Running top-k activations and sample ids for one layer.

    Parameters
    ----------
    n_collect : number of top samples kept per component.
    n_latents : number of components; inferred from the first batch if None.
    device : where the state lives (``None`` → the CUDA card).
    """

    def __init__(self, n_collect: int, n_latents: int | None = None, device=None):
        self.n_collect = n_collect
        self.n_latents = n_latents
        self.device = device
        self.state: TopKState | None = None
        if n_latents is not None:
            self.state = init_topk(n_latents, n_collect, device)

    @property
    def is_setup(self) -> bool:
        return self.state is not None

    @property
    def activations(self) -> torch.Tensor:
        """(n_latents, n_collect) bf16 CPU tensor of the collected values."""
        if self.state is None:
            raise ValueError("ActMax holds no state yet")
        return self.state.values.to("cpu", torch.bfloat16).contiguous()

    @property
    def sample_ids(self) -> np.ndarray:
        """(n_latents, n_collect) int64 sample ids (−1 = unfilled)."""
        if self.state is None:
            raise ValueError("ActMax holds no state yet")
        return np.ascontiguousarray(self.state.ids.to("cpu", torch.int64).numpy())

    def update(self, acts: torch.Tensor, sample_ids):
        """Merge a (B, n_latents) batch; infers n_latents on first call."""
        if acts.ndim != 2:
            raise ValueError(f"expected (B, n_latents) activations, got shape {tuple(acts.shape)}")
        if self.state is None:
            self.n_latents = int(acts.shape[1])
            self.state = init_topk(self.n_latents, self.n_collect, acts.device)
        ids = torch.as_tensor(sample_ids, dtype=torch.int32, device=acts.device)
        self.state = topk_update(self.state, acts, ids)

    @property
    def alive_latents(self) -> np.ndarray:
        """Indices of latents with any non-zero activation."""
        if self.state is None:
            return np.array([], dtype=np.int64)
        mask = self.activations.float().abs().sum(dim=1) > 0
        return torch.nonzero(mask).flatten().numpy().astype(np.int64)

    def store(self, file_path: str | Path, metadata: dict[str, str] | None = None):
        """Write bf16 values + int64 ids to a reference-format safetensors file."""
        if self.state is None:
            logger.warning("Attempted to store an un-initialized ActMax instance; skipping.")
            return
        tensors = {
            "activations": self.activations,
            "sample_ids": torch.from_numpy(self.sample_ids),
        }
        safetensors_io.save_file(tensors, file_path, metadata=metadata)

    @classmethod
    def load(cls, file_path: str | Path, device=None) -> "ActMax":
        """Load from a safetensors file written by either package or the reference."""
        metadata = safetensors_io.read_metadata(file_path)
        if metadata is None:
            raise ValueError(f"File {file_path} is missing required metadata for loading.")
        tensors = safetensors_io.load_file(file_path)
        instance = cls(n_collect=int(metadata["n_collect"]), device=device)
        instance.n_latents = int(metadata["n_latents"])
        device = resolve_device(device)
        instance.state = TopKState(
            values=tensors["activations"].to(device, torch.bfloat16),
            ids=tensors["sample_ids"].to(device, torch.int32),
        )
        return instance


class ActCache:
    """Raw per-layer activation capture for a batch of inputs.

    :meth:`capture` runs the tapped forward and stores each requested
    layer's raw output in ``.cache`` as host float32 numpy (the reference's
    ``.detach().cpu()``). Use :class:`ActMaxCache` for streaming top-k;
    this class is for ad-hoc inspection of full activations.
    """

    def __init__(self, layer_names: list[str]):
        self.layer_names = list(layer_names)
        self.cache: dict[str, np.ndarray] = {}

    def capture(self, model, params, x) -> dict[str, np.ndarray]:
        """Forward ``x`` through ``model`` and cache the requested taps."""
        with torch.inference_mode():
            _, taps = model.apply(params, x, tuple(self.layer_names))
            self.cache = {name: taps[name].to("cpu", torch.float32).numpy() for name in self.layer_names}
        return self.cache

    def clear(self):
        self.cache = {}


class ActMaxCache:
    """Per-layer ActMax registry with validating directory persistence.

    File names and metadata follow the reference byte for byte:
    ``{aggregation_fn_name}-{n_collect}-{layer_name}.safetensors``; loading
    validates the aggregation function and n_collect.
    """

    def __init__(self, layer_names: list[str], aggregation_fn: Callable, n_collect: int, device=None):
        self.layer_names = list(layer_names)
        self.aggregation_fn = aggregation_fn
        self.n_collect = n_collect
        self.device = device
        self.sample_idx_counter: dict[str, int] = {name: 0 for name in self.layer_names}

        agg_fn_name = getattr(aggregation_fn, "__name__", None)
        if agg_fn_name is None or agg_fn_name == "<lambda>":
            raise ValueError(
                "aggregation_fn needs a stable __name__ (it is serialized into cache "
                "filenames); pass a module-level function rather than a lambda"
            )
        self.agg_fn_name = agg_fn_name
        self.cache: dict[str, ActMax] = {
            name: ActMax(n_collect=n_collect, device=device) for name in self.layer_names
        }

    def __getitem__(self, layer_name: str) -> ActMax:
        return self.cache[layer_name]

    def __iter__(self):
        return iter(self.cache.values())

    def __repr__(self) -> str:
        return (
            f"ActMaxCache(layers={list(self.layer_names)}, "
            f"aggregation_fn='{self.agg_fn_name}', n_collect={self.n_collect})"
        )

    def update_layer(self, layer_name: str, raw_activation) -> None:
        """Aggregate one layer's raw activation and merge it into the top-k."""
        aggregated = self.aggregation_fn(raw_activation)
        if aggregated.ndim != 2:
            raise ValueError("aggregation_fn must reduce to (B, n_components)")
        batch_size = int(aggregated.shape[0])
        start = self.sample_idx_counter[layer_name]
        self.sample_idx_counter[layer_name] += batch_size
        self.cache[layer_name].update(aggregated, np.arange(start, start + batch_size, dtype=np.int32))

    @property
    def metadata(self) -> dict[str, str]:
        return dict(
            aggregation_fn_name=self.agg_fn_name,
            n_collect=str(self.n_collect),
            layer_names=str(list(self.cache.keys())),
        )

    def _layer_fname(self, layer_name: str) -> str:
        return "-".join([self.agg_fn_name, str(self.n_collect), layer_name]) + ".safetensors"

    def store(self, directory: Path | str):
        """Save one safetensors file per layer into ``directory``."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for layer_name, act_max in self.cache.items():
            if not act_max.is_setup:
                logger.warning("layer '%s' never received activations — nothing to write", layer_name)
                continue
            metadata = {
                "aggregation_fn_name": self.agg_fn_name,
                "n_collect": str(self.n_collect),
                "n_latents": str(act_max.n_latents),
                "layer_name": layer_name,
            }
            act_max.store(directory / self._layer_fname(layer_name), metadata=metadata)

    def load(self, directory: Path | str):
        """Load and validate per-layer files; raises FileNotFoundError on any miss.

        Missing files or mismatched aggregation-fn/n_collect metadata raise
        ``FileNotFoundError`` so callers fall back to recomputation.
        """
        directory = Path(directory)
        if not directory.is_dir():
            raise FileNotFoundError(f"no cache directory at {directory}")
        loaded: dict[str, ActMax] = {}
        for layer_name in self.layer_names:
            fpath = directory / self._layer_fname(layer_name)
            problem = self._check_layer_file(fpath)
            if problem is not None:
                raise FileNotFoundError(f"unusable cache file {fpath}: {problem}")
            loaded[layer_name] = ActMax.load(fpath, self.device)
        self.cache.update(loaded)

    def _check_layer_file(self, fpath: Path) -> str | None:
        """Return a human-readable reason the file is unusable, or None if OK."""
        if not fpath.exists():
            return "file does not exist"
        metadata = safetensors_io.read_metadata(fpath) or {}
        found_agg = metadata.get("aggregation_fn_name")
        if found_agg != self.agg_fn_name:
            return f"written with aggregation_fn '{found_agg}', this cache expects '{self.agg_fn_name}'"
        try:
            found_k = int(metadata.get("n_collect"))
        except (TypeError, ValueError):
            return f"corrupt n_collect metadata: {metadata.get('n_collect')!r}"
        if found_k != self.n_collect:
            return f"written with n_collect={found_k}, this cache expects {self.n_collect}"
        return None
