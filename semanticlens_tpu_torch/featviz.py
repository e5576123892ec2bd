"""Optimization-based feature visualization: synthesize concept examples.

Counterpart of ``semanticlens_tpu.featviz``. Beyond collecting evidence
from a dataset, this module *synthesizes* it: gradient ascent on the input
image until a chosen component fires maximally (Olah et al.,
distill.pub/2017/feature-visualization). The synthesized images drop into
the same Embed → Analyze pipeline
(:class:`~semanticlens_tpu_torch.collect.SynthesisComponentVisualizer`), so
probing, labels and scores run on dataset-free concept databases.

- All K canvases of a request ascend together: one (K, H, W, 3) batch, one
  forward tapping the layer, each canvas ascending its own component's
  aggregate (a gather over the (K, C) aggregate).
- The canvas is ``sigmoid(z)`` of an unconstrained ``z``; each step takes a
  random (H, W) window of the (H + 2·jitter) canvas and flips canvases at
  random, then Adam (``sae.Adam``, optax's ``adam`` without a clip) steps
  ``z`` along ``torch.autograd.grad`` of the loss with respect to ``z``
  alone: the subject's parameters take no gradient.
- Random draws: the canvas init and every step's window offset (one
  (oy, ox) per step, shared by the K canvases) and flips (one per canvas)
  come from a ``torch.Generator`` on the CPU seeded with ``seed``, drawn
  before the loop, so a seed gives the same draws on the card and on the
  CPU. The JAX package draws from ``jax.random``: the streams differ, so
  the two packages agree on a given init and draw stream, not per seed.
- ``loop="host"`` and ``loop="scan"`` run the same steps with the same
  draws and are bit-equal (the JAX package's promise for its two modes).
- ``mesh=`` splits the K canvases over the ranks of the ``"data"`` axis
  (K must be a multiple of its size). Every rank draws the whole stream,
  the K canvases' init and flips and each step's offset, and takes its own
  canvases by index; the loss is summed over the local canvases and
  divided by the global K, so each canvas takes the step the one-device
  run gives it, and the gathered gallery is the one-device gallery.
  The port runs eagerly and memoizes no program (:func:`clear_programs`).
"""

from __future__ import annotations

import numpy as np
import torch

from semanticlens_tpu_torch.core.mesh import all_gather, all_reduce, mesh_axis
from semanticlens_tpu_torch.sae import Adam

__all__ = ["synthesize", "SynthesisConfig", "clear_programs"]


def clear_programs() -> None:
    """Kept for parity with the JAX package, which memoizes compiled synthesis
    programs. The port runs its steps eagerly and memoizes nothing."""


class SynthesisConfig:
    """Hyper-parameters for :func:`synthesize` (plain attributes; ``_key()``
    is the tuple the JAX package keys its memo and the gallery digest on).

    The classic feature-visualization recipe: Adam ascent on a
    sigmoid-parametrized canvas with per-step random shifts, weight decay
    toward mid-gray, and total-variation smoothing.
    """

    def __init__(
        self,
        *,
        steps: int = 256,
        lr: float = 0.05,
        jitter: int = 4,
        flip: bool = True,
        l2: float = 1e-3,
        tv: float = 2.5e-4,
        init_scale: float = 0.01,
    ):
        self.steps = int(steps)
        self.lr = float(lr)
        self.jitter = int(jitter)
        self.flip = bool(flip)
        self.l2 = float(l2)
        self.tv = float(tv)
        self.init_scale = float(init_scale)

    def _key(self):
        return (self.steps, self.lr, self.jitter, self.flip, self.l2, self.tv, self.init_scale)


def _total_variation(img):
    """Anisotropic TV over a (K, H, W, C) batch → (K,) penalties."""
    dh = torch.abs(img[:, 1:, :, :] - img[:, :-1, :, :])
    dw = torch.abs(img[:, :, 1:, :] - img[:, :, :-1, :])
    return torch.mean(dh, dim=(1, 2, 3)) + torch.mean(dw, dim=(1, 2, 3))


def _agg_component(taps, component_ids, aggregate_fn):
    """Aggregate a tapped activation and gather each canvas's component.

    ``aggregate_fn`` maps the (K, …) tap to (K, C); returns (K,) — canvas
    k's ``component_ids[k]`` aggregate.
    """
    agg = aggregate_fn(taps)
    if agg.ndim != 2:
        raise ValueError(
            f"aggregate_fn must map the tapped activation to (batch, components); got rank {agg.ndim}"
        )
    return agg[torch.arange(agg.shape[0], device=agg.device), component_ids]


def _init_canvas(cfg: SynthesisConfig, k: int, canvas_hw: int, generator: torch.Generator) -> torch.Tensor:
    """z0: (K, canvas, canvas, 3) float32 on the CPU."""
    return cfg.init_scale * torch.randn((k, canvas_hw, canvas_hw, 3), generator=generator, dtype=torch.float32)


def _draws(cfg: SynthesisConfig, k: int, generator: torch.Generator):
    """Every step's window offsets (steps, 2) int64 and flips (steps, K) bool, on the CPU.

    One (oy, ox) per step for all K canvases, one flip per canvas; zeros
    without jitter, all False without flips.
    """
    offsets = (torch.randint(0, 2 * cfg.jitter + 1, (cfg.steps, 2), generator=generator) if cfg.jitter > 0
               else torch.zeros((cfg.steps, 2), dtype=torch.int64))
    flips = (torch.rand((cfg.steps, k), generator=generator) < 0.5 if cfg.flip
             else torch.zeros((cfg.steps, k), dtype=torch.bool))
    return offsets, flips


def _forward_objective(model, params, layer_name, aggregate_fn, model_preprocess, img01, ids):
    """(K, S, S, 3) in [0, 1] → (K,) component aggregates."""
    _, taps = model.apply(params, model_preprocess(img01 * 255.0), (layer_name,))
    return _agg_component(taps[layer_name], ids, aggregate_fn)


def _loss(model, params, layer_name, aggregate_fn, model_preprocess, cfg, image_size, z, ids, offset, flip,
          k_total=None):
    """``(mean(reg − obj), mean(obj))`` for one step's window ``offset`` (oy, ox) and ``flip`` (K,) mask.

    With ``k_total`` (these canvases are a rank's part of ``k_total``) the
    sums over the local canvases are divided by ``k_total`` instead: each
    rank's share of the global means.
    """
    img = torch.sigmoid(z)
    if cfg.jitter > 0:
        oy, ox = offset
        img = img[:, oy : oy + image_size, ox : ox + image_size, :]
    if cfg.flip:
        img = torch.where(flip[:, None, None, None], torch.flip(img, dims=(2,)), img)
    obj = _forward_objective(model, params, layer_name, aggregate_fn, model_preprocess, img, ids)
    reg = cfg.l2 * torch.mean((img - 0.5) ** 2, dim=(1, 2, 3)) + cfg.tv * _total_variation(img)
    # ascend the objective, descend the regularizers; scale-free mean
    if k_total is not None:
        return torch.sum(reg - obj) / k_total, torch.sum(obj) / k_total
    return torch.mean(reg - obj), torch.mean(obj)


def synthesize(
    model,
    params,
    layer_name: str,
    component_ids,
    aggregate_fn,
    *,
    image_size: int = 224,
    model_preprocess=None,
    config: SynthesisConfig | None = None,
    seed: int = 0,
    return_trace: bool = False,
    loop: str = "host",
    mesh=None,
):
    """Synthesize one maximally-activating image per component.

    Parameters
    ----------
    model, params : a ``SubjectModel`` (``apply(params, x, tap_names)``) and
        its parameters; the canvases live on ``model.device``.
    layer_name : tap to maximize at.
    component_ids : (K,) ints — component per canvas. Duplicates are fine
        (vary ``seed`` for diverse variants of one component).
    aggregate_fn : maps the tapped activation to (K, C) — the Collect
        stage's aggregators (``ops.aggregators``).
    image_size : canvas height/width fed to the model.
    model_preprocess : device-side fn applied to the 0–255 canvas before the
        model (e.g. ``make_preprocess_fn``'s normalizer). Identity when None.
    config : :class:`SynthesisConfig`.
    seed : seed of the CPU ``torch.Generator`` for the canvas init and the
        per-step augmentation draws.
    return_trace : also return the (steps,) mean-objective trajectory.
    loop : ``"host"`` (default) or ``"scan"``; the same steps either way,
        bit-equal (the JAX package's two loop modes).
    mesh : optional ``DeviceMesh``: the K canvases split over its
        ``"data"`` axis (K must be a multiple of the axis size); every rank
        returns the whole gallery.

    Returns
    -------
    images : (K, image_size, image_size, 3) float32 numpy in [0, 1].
    objective : (K,) float32 — final (un-augmented) component aggregates.
    trace : (steps,) float32, only when ``return_trace``.
    """
    size, rank, group = mesh_axis(mesh, "data")
    cfg = config or SynthesisConfig()
    ids_np = np.asarray(component_ids, np.int64)
    if ids_np.ndim != 1:
        raise ValueError("component_ids must be a 1-D sequence of component indices")
    if loop not in ("scan", "host"):
        raise ValueError(f"loop must be 'scan' or 'host', got {loop!r}")
    k = int(ids_np.shape[0])
    if k % size:
        raise ValueError(f"K={k} canvases must divide the mesh size {size}")
    model_preprocess = model_preprocess or _identity
    device = getattr(model, "device", torch.device("cpu"))
    pad = cfg.jitter
    mine = slice(rank * (k // size), (rank + 1) * (k // size))  # this rank's canvases
    ids = torch.as_tensor(ids_np[mine], device=device)

    generator = torch.Generator().manual_seed(int(seed))
    z = _init_canvas(cfg, k, image_size + 2 * pad, generator)[mine].to(device)
    offsets, flips = _draws(cfg, k, generator)
    offsets, flips = offsets.tolist(), flips[:, mine].to(device)
    k_total = k if size > 1 else None
    opt = Adam(cfg.lr)
    state = opt.init({"z": z})
    objs = []
    for step in range(cfg.steps):
        leaf = z.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, obj = _loss(model, params, layer_name, aggregate_fn, model_preprocess, cfg, image_size,
                              leaf, ids, offsets[step], flips[step], k_total)
            (grad,) = torch.autograd.grad(loss, [leaf])
        with torch.no_grad():
            updates, state = opt.update({"z": grad}, state)
            z = z + updates["z"]
        objs.append(obj.detach())
    with torch.no_grad():
        img = torch.sigmoid(z)[:, pad : pad + image_size, pad : pad + image_size, :]
        objective = _forward_objective(model, params, layer_name, aggregate_fn, model_preprocess, img, ids)
    trace = torch.stack(objs) if objs else torch.zeros(0, device=device)
    if size > 1:  # the whole gallery on every rank, canvases in order; the trace's mean over all canvases
        img, objective = all_gather(img, group).flatten(0, 1), all_gather(objective, group).flatten(0, 1)
        trace = all_reduce(trace, group)
    images = img.to("cpu", torch.float32).numpy()
    objective = objective.to("cpu", torch.float32).numpy()
    if return_trace:
        return images, objective, trace.to("cpu", torch.float32).numpy()
    return images, objective


def _identity(x):
    return x
