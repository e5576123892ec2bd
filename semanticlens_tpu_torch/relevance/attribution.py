"""Per-component input attributions via LRP or plain gradients.

Counterpart of ``semanticlens_tpu.relevance.attribution``. A heatmap is the
gradient of a component's aggregated activation with respect to the input
pixels, taken by autograd through a forward in which the linear primitives
carry the LRP rules of :func:`semanticlens_tpu_torch.models.layers.lrp_composite`;
the channel sum of that input relevance, optionally abs-max normalised per
image, is the heatmap. Runs on the device of the images it is given (the
card for a model on the card).
"""

from __future__ import annotations

import contextlib

import torch

from semanticlens_tpu_torch.models.layers import lrp_composite


def _make_heatmap_core(model, layer_name, composite, aggregation, abs_norm):
    """``(params, images (B, H, W, C), components (B,)) → (B, H, W)``: one forward, one backward.

    Sample b's target is its own component ``components[b]``; samples are
    independent under inference-mode BN, so one batch of K·S images equals
    K·S separate attributions.
    """

    def heatmaps(params, images, components):
        x = images.to(torch.float32).detach().requires_grad_(True)
        rules = lrp_composite(composite) if composite != "gradient" else contextlib.nullcontext()
        with torch.inference_mode(False), torch.enable_grad():
            with rules:
                _, taps = model.apply(params, x, (layer_name,))
            act = taps[layer_name].float()
            if act.ndim == 4:
                agg = torch.sum(act, dim=(1, 2)) if aggregation == "sum" else torch.amax(act, dim=(1, 2))
            elif act.ndim == 3:
                agg = torch.sum(act, dim=1) if aggregation == "sum" else torch.amax(act, dim=1)
            else:
                agg = act
            target = torch.gather(agg, 1, components.to(agg.device, torch.long)[:, None]).sum()
            (grads,) = torch.autograd.grad(target, x)
        heat = torch.sum(grads.float(), dim=-1)  # channels → (B, H, W)
        if abs_norm:
            heat = heat / (torch.amax(torch.abs(heat), dim=(1, 2), keepdim=True) + 1e-12)
        return heat

    return heatmaps


def _on_model_device(model, images):
    device = getattr(model, "device", None)
    images = torch.as_tensor(images)
    return images if device is None else images.to(device)


def make_attribution_fn(
    model,
    layer_name: str,
    *,
    composite: str = "epsilon_plus_flat",
    aggregation: str = "sum",
    abs_norm: bool = True,
):
    """``(params, images (B, H, W, C), component) → (B, H, W)`` heatmaps.

    The target is the component's aggregated activation (spatial/token
    ``sum`` or ``max``, crp's ``max_target``) summed over the batch; the
    heatmap is the signed input relevance summed over channels, optionally
    abs-max normalised per image. uint8 images are cast to float32 at the
    boundary; relevance is with respect to the float pixels.
    """
    core = _make_heatmap_core(model, layer_name, composite, aggregation, abs_norm)

    def fn(params, images, component):
        images = _on_model_device(model, images)
        comps = torch.full((images.shape[0],), int(component), dtype=torch.long, device=images.device)
        return core(params, images, comps)

    return fn


def make_batched_attribution_fn(
    model,
    layer_name: str,
    *,
    composite: str = "epsilon_plus_flat",
    aggregation: str = "sum",
    abs_norm: bool = True,
):
    """``(params, images (K, S, H, W, C), components (K,)) → (K, S, H, W)``.

    Attributes K components, each over its own S images, in one forward and
    one backward over the K·S images (the JAX package's ``vmap`` of the
    single-component function).
    """
    core = _make_heatmap_core(model, layer_name, composite, aggregation, abs_norm)

    def fn(params, images, components):
        images = _on_model_device(model, images)
        k, s = images.shape[:2]
        comps = torch.as_tensor(components, device=images.device).to(torch.long).repeat_interleave(s)
        return core(params, images.reshape(k * s, *images.shape[2:]), comps).reshape(k, s, *images.shape[2:4])

    return fn


def component_heatmaps(model, params, images, layer_name, component, **kwargs):
    """One-shot convenience wrapper around :func:`make_attribution_fn`."""
    return make_attribution_fn(model, layer_name, **kwargs)(params, images, component)
