"""Causal interventions on subject-model components: ablate, patch, steer.

Counterpart of ``semanticlens_tpu.causal``. SemanticLens names what a
component *encodes* (top-activating evidence embedded by the foundation
model); this module tests what a component *causes*. Every subject model
routes its activations through the tap contract
(:class:`semanticlens_tpu_torch.models.base.TapCollector`), so the
:func:`~semanticlens_tpu_torch.models.base.interventions` context rewrites
any named activation of any native family (and the SAE virtual taps) with no
per-model code.

- :func:`ablation_effects` — zero- or mean-ablate components, return the
  per-component output delta (the component's "necessity");
- :func:`activation_patch` — interchange intervention: run target images
  with selected components' activations taken from source images;
- :func:`steer` — add a concept direction at a layer;
- :func:`sae_latent_ablation` — the effect of single SAE latents, through
  encode → mask → decode at the layer the SAE was trained on;
- :func:`necessity_ratio` — ablation effect on a component's own evidence
  images relative to control images: a causal check of the Collect stage's
  concept examples.

Where the JAX package ``vmap``s one traced forward over K keep-masks, the
port runs ONE forward over K·B rows: row ``k·B + b`` is image b under mask
k. The rows go through in chunks of :data:`ROWS_PER_FORWARD`, so a whole
1,024-channel ResNet-50 layer at 224² fits on one card. BatchNorm runs in
inference mode, so every row is independent and the result equals K
separate forwards.

Typical audit: collect evidence with ActivationComponentVisualizer, name
components with ``Lens.label_components``, then confirm the named concept
is causally load-bearing with ``necessity_ratio`` — components whose
naming is an artifact of correlated context score ≈ 1.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from semanticlens_tpu_torch import sae
from semanticlens_tpu_torch.models.base import SubjectModel, interventions, validate_layers

__all__ = [
    "ablation_effects",
    "activation_patch",
    "steer",
    "necessity_ratio",
    "sae_latent_ablation",
    "clear_programs",
]

# Rows (mask × image pairs) per intervened forward: 512 float32 ResNet-50 rows at 224² stay
# within a few GiB of activations.
ROWS_PER_FORWARD = 512


def clear_programs() -> None:
    """Kept for parity with the JAX package, which memoizes compiled ablation
    programs. The port runs its forwards eagerly and memoizes nothing, so
    there is nothing to drop."""


def _validated_ids(ids, width: int, what: str) -> np.ndarray:
    """Host-side id validation. An out-of-range id would give an all-ones
    keep-mask — a silently clean 'ablation' — so reject it loudly."""
    ids = np.asarray(ids, np.int64)
    if ids.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {tuple(ids.shape)}")
    if ids.size and (ids.min() < 0 or ids.max() >= width):
        bad = ids[(ids < 0) | (ids >= width)]
        raise ValueError(
            f"{what} out of range for width {width}: {bad.tolist()} "
            "(ids must index the tapped layer, 0 <= id < width)"
        )
    return ids.astype(np.int32)


def _keep_masks(ids, width: int, what: str, device) -> torch.Tensor:
    """(K, width) float32 keep-masks, each zero at one id."""
    ids = torch.as_tensor(_validated_ids(ids, width, what), dtype=torch.long, device=device)
    return 1.0 - torch.nn.functional.one_hot(ids, width).to(torch.float32)


def _images(model, images) -> torch.Tensor:
    """``images`` as a tensor on the model's device (a tensor keeps its own without one)."""
    images = images if isinstance(images, torch.Tensor) else torch.as_tensor(np.asarray(images))
    device = getattr(model, "device", None)
    return images if device is None else images.to(device)


def _masked_forwards(model, params, layer_name: str, images, masks,
                     rewrite: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Model output for every (mask, image) pair, shaped (K, B, ...).

    One forward over K·B rows, row ``k·B + b`` carrying ``masks[k]``;
    ``rewrite(activation, mask)`` gets the mask broadcast against the
    activation's last axis.
    """
    k, b = masks.shape[0], images.shape[0]
    outs = []
    for start in range(0, k * b, ROWS_PER_FORWARD):
        rows = torch.arange(start, min(start + ROWS_PER_FORWARD, k * b), device=images.device)
        row_masks = masks[(rows // b).to(masks.device)]

        def rewrite_rows(v, row_masks=row_masks):
            return rewrite(v, row_masks.reshape(row_masks.shape[0], *(1,) * (v.ndim - 2), -1))

        with interventions({layer_name: rewrite_rows}):
            out, _ = model.apply(params, images[rows % b], ())
        outs.append(out)
    out = torch.cat(outs)
    return out.reshape(k, b, *out.shape[1:])


def ablation_effects(
    model: SubjectModel,
    params,
    layer_name: str,
    images,
    component_ids: Sequence[int],
    *,
    mode: str = "zero",
    target_class: int | None = None,
):
    """Output change caused by knocking out each component of a layer.

    For every ``component_ids[k]``, runs the model with that channel of
    ``layer_name`` replaced by 0 (``mode="zero"``) or by its batch-mean
    activation (``mode="mean"``, the gentler ablation that stays on the
    layer's manifold) and returns ``clean_output − ablated_output``
    (float32): shape ``(K, B, n_out)``, or ``(K, B)`` when ``target_class``
    picks a single output column.
    """
    if mode not in ("zero", "mean"):
        raise ValueError(f"mode must be 'zero' or 'mean', got {mode!r}")
    validate_layers(model, [layer_name])
    with torch.no_grad():
        images = _images(model, images)
        clean_out, taps = model.apply(params, images, (layer_name,))
        act = taps[layer_name]
        width = act.shape[-1]
        masks = _keep_masks(component_ids, width, "component_ids", act.device)
        if mode == "mean":
            fill = torch.mean(act.to(torch.float32), dim=tuple(range(act.ndim - 1)))  # (C,) batch mean
        else:
            fill = torch.zeros((width,), dtype=torch.float32, device=act.device)
        ablated = _masked_forwards(model, params, layer_name, images, masks,
                                   lambda v, m: (v * m + (1.0 - m) * fill).to(v.dtype))
        delta = clean_out[None].to(torch.float32) - ablated.to(torch.float32)
    if target_class is not None:
        delta = delta[..., target_class]
    return delta


def activation_patch(
    model: SubjectModel,
    params,
    layer_name: str,
    target_images,
    source_images,
    component_ids: Sequence[int] | None = None,
):
    """Interchange intervention: run ``target_images`` with the selected
    components of ``layer_name`` carrying the activations they would have
    on ``source_images`` (rows are paired 1:1 — shapes must match).

    ``component_ids=None`` patches the whole layer (a full causal trace of
    everything downstream). Returns ``(patched_output, clean_output)``.
    """
    validate_layers(model, [layer_name])
    with torch.no_grad():
        _, src_taps = model.apply(params, _images(model, source_images), (layer_name,))
        src = src_taps[layer_name]
        target_images = _images(model, target_images)
        clean_out, tgt_taps = model.apply(params, target_images, (layer_name,))
        if tgt_taps[layer_name].shape != src.shape:
            raise ValueError(
                f"source/target activations must align 1:1 at {layer_name}: "
                f"{tuple(src.shape)} vs {tuple(tgt_taps[layer_name].shape)}"
            )
        if component_ids is None:
            patch_mask = torch.ones((src.shape[-1],), dtype=torch.float32, device=src.device)
        else:
            patch_mask = 1.0 - _keep_masks(component_ids, src.shape[-1], "component_ids", src.device).prod(dim=0)

        def rewrite(v):
            return (v * (1.0 - patch_mask) + src.to(torch.float32) * patch_mask).to(v.dtype)

        with interventions({layer_name: rewrite}):
            patched_out, _ = model.apply(params, target_images, ())
    return patched_out, clean_out


def steer(
    model: SubjectModel,
    params,
    layer_name: str,
    images,
    direction,
    *,
    alpha: float = 1.0,
):
    """Concept steering: add ``alpha · direction`` to ``layer_name``'s
    activation (direction broadcasts against the activation's last axis —
    pass a (C,) vector for channel-space steering) and return the output."""
    validate_layers(model, [layer_name])
    with torch.no_grad():
        images = _images(model, images)
        if not isinstance(direction, torch.Tensor):
            direction = torch.as_tensor(np.asarray(direction, np.float32))
        direction = direction.to(images.device)

        def rewrite(v):
            return (v.to(torch.float32) + alpha * direction).to(v.dtype)

        with interventions({layer_name: rewrite}):
            out, _ = model.apply(params, images, ())
    return out


def sae_latent_ablation(
    model: SubjectModel,
    params,
    layer_name: str,
    sae_params,
    images,
    latent_ids: Sequence[int],
    *,
    k: int | None = None,
    substitute_clean: bool = False,
):
    """Causal effect of individual SAE latents on the model output.

    An SAE latent is a virtual component — it never feeds the forward pass
    directly — so knocking it out rewrites the layer it was trained on:
    ``activation → encode → zero latent f → decode`` replaces
    ``layer_name``'s activation for everything downstream. Returns
    ``(K, B, n_out)`` deltas ``baseline_output − ablated_output`` where the
    baseline runs the full SAE reconstruction through the same path (a
    keep-all mask, so the effect isolates the LATENT, not the SAE's
    reconstruction error; ``substitute_clean=True`` baselines against the
    raw forward instead).

    ``k`` defaults to the encode-time sparsity stamped into ``sae_params``
    (:func:`semanticlens_tpu_torch.sae.finalize_sae_params`).
    """
    validate_layers(model, [layer_name])
    stored_k = sae_params.get("k") if hasattr(sae_params, "get") else None
    if k is None:
        if stored_k is None:
            raise ValueError(
                "encode-time sparsity unknown: pass k= or use sae_params "
                "carrying a 'k' entry (the trainers stamp it)"
            )
        k = int(stored_k)
    with torch.no_grad():
        images = _images(model, images)
        dictionary = sae._place(sae_params, images.device)
        n_latents = dictionary["W_dec"].shape[0]
        keep = _keep_masks(latent_ids, n_latents, "latent_ids", images.device)

        def rewrite(v, m):
            return sae.decode(dictionary, sae.encode(dictionary, v, k=k) * m).to(v.dtype)

        ablated = _masked_forwards(model, params, layer_name, images, keep, rewrite)
        if substitute_clean:
            baseline, _ = model.apply(params, images, ())
        else:
            all_kept = torch.ones((1, n_latents), dtype=torch.float32, device=images.device)
            baseline = _masked_forwards(model, params, layer_name, images, all_kept, rewrite)[0]
        return baseline[None].to(torch.float32) - ablated.to(torch.float32)


def necessity_ratio(
    model: SubjectModel,
    params,
    layer_name: str,
    component_ids: Sequence[int],
    evidence_images,
    control_images,
    *,
    mode: str = "zero",
    eps: float = 1e-9,
):
    """Causal validation of concept evidence: how much MORE the model's
    output depends on a component on that component's own top-activating
    images than on control images.

    Returns ``(K,)`` ratios ``‖Δ_evidence‖ / (‖Δ_control‖ + eps)`` of mean
    ablation-induced output-change norms. Ratios ≫ 1 mean the component is
    causally load-bearing exactly where the Collect stage says it fires.
    """
    d_ev = ablation_effects(model, params, layer_name, evidence_images, component_ids, mode=mode)
    d_ct = ablation_effects(model, params, layer_name, control_images, component_ids, mode=mode)

    def per_component(d):  # norm over the output axis, mean over every other non-K axis
        return torch.linalg.vector_norm(d, dim=-1).mean(dim=tuple(range(1, d.ndim - 1)))

    return per_component(d_ev) / (per_component(d_ct) + eps)
