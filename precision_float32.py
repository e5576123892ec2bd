"""How far float32 itself moves the causal and synthesis results: float32 against float64 on the CPU.

Runs the port's ResNet-50 (seed 0) on the inputs of ``chip_smoke.py``'s
``[causal]`` and ``[featviz]`` float32 gates twice, in float32 and in
float64 (batch norm given float64 statistics), and prints one JSON line:

- ``causal``: zero and mean ablation of 8 layer3 channels on 4 images —
  the largest |Δ| difference over the largest |Δ| and over the largest
  clean logit. A Δ is the difference of two forwards, so its rounding
  error follows the logits, not |Δ|;
- ``featviz``: step 1 of feature synthesis on 2 canvases (loss, objective,
  and the gradient with respect to the canvas: relative L2 and max), and
  the images and objectives after 4 steps. Adam moves every canvas entry by
  about lr whatever the size of its gradient, and max-pool and ReLU ties
  route single pixels' gradients, so rounding moves the 4-step canvases
  far more than the step's forward.

This bounds what a float32 comparison between two devices can show; it is
a property of the arithmetic, not of a device. Run on any machine:

    python3 precision_float32.py
"""

from __future__ import annotations

import json

import numpy as np
import torch

import chip_smoke as cs
from semanticlens_tpu_torch import causal, featviz
from semanticlens_tpu_torch.models import ResNet
from semanticlens_tpu_torch.models import zoo as zoo_module
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean


def _model(dtype):
    model = ResNet(depth=50, dtype=dtype, device="cpu")
    model.params = {k: v.to(dtype) for k, v in model.load_jax_params(model.init_jax_layout(0)).items()}
    return model


def causal_precision(models) -> dict:
    size, layer = cs.CAUSAL["size"], cs.CAUSAL["layer"]
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(cs.CAUSAL["images"], size, size, 3), dtype=np.uint8)
    x = images[: cs.CAUSAL["gate_images"]].astype(np.float32) / 255.0
    ids = (np.arange(cs.CAUSAL["gate_components"]) * 127).tolist()
    out = {}
    for mode in ("zero", "mean"):
        d = {dt: causal.ablation_effects(m, m.params, layer, torch.from_numpy(x).to(dt), ids, mode=mode).double()
             for dt, m in models.items()}
        err = float((d[torch.float32] - d[torch.float64]).abs().max())
        with torch.no_grad():
            clean = models[torch.float64].apply(models[torch.float64].params, torch.from_numpy(x).double())[0]
        out[mode] = {"vs_largest_delta": err / float(d[torch.float64].abs().max()),
                     "vs_output_scale": err / float(clean.abs().max()),
                     "largest_delta": float(d[torch.float64].abs().max()), "output_scale": float(clean.abs().max())}
    return out


def featviz_precision(models) -> dict:
    cfg = featviz.SynthesisConfig(steps=cs.FEATVIZ["gate_steps"])
    k, size, layer = cs.FEATVIZ["gate_canvases"], cs.FEATVIZ["size"], cs.FEATVIZ["layer"]
    ids = torch.arange(k)
    step1, runs = {}, {}
    for dt, m in models.items():
        generator = torch.Generator().manual_seed(0)
        z0 = featviz._init_canvas(cfg, k, size + 2 * cfg.jitter, generator).to(dt)
        offsets, flips = featviz._draws(cfg, k, generator)
        leaf = z0.clone().requires_grad_(True)
        loss, obj = featviz._loss(m, m.params, layer, aggregate_conv_mean, cs.imagenet_preprocess_as_input, cfg,
                                  size, leaf, ids, offsets[0].tolist(), flips[0])
        (grad,) = torch.autograd.grad(loss, [leaf])
        step1[dt] = (float(loss.detach()), float(obj.detach()), grad.double())
        init = featviz._init_canvas
        featviz._init_canvas = lambda cfg_, k_, hw, gen, dt=dt: init(cfg_, k_, hw, gen).to(dt)
        try:
            runs[dt] = featviz.synthesize(m, m.params, layer, list(range(k)), aggregate_conv_mean, image_size=size,
                                          model_preprocess=cs.imagenet_preprocess_as_input, config=cfg,
                                          seed=0)
        finally:
            featviz._init_canvas = init
    (l32, o32, g32), (l64, o64, g64) = step1[torch.float32], step1[torch.float64]
    (i32, f32), (i64, f64) = runs[torch.float32], runs[torch.float64]
    return {
        "step1_loss_rel": abs(l32 - l64) / abs(l64), "step1_objective_rel": abs(o32 - o64) / abs(o64),
        "step1_grad_rel_l2": float((g32 - g64).norm() / g64.norm()),
        "step1_grad_max_rel": float((g32 - g64).abs().max() / g64.abs().max()),
        "step1_grad_share_below_1e-8": float((g64.abs() < 1e-8).double().mean()),
        "steps_images_max_abs": float(np.abs(i32 - i64).max()),
        "steps_images_share_over_1e-3": float((np.abs(i32 - i64) > 1e-3).mean()),
        "steps_objective_rel": float(np.abs(f32 - f64).max() / np.abs(f64).max()),
    }


def main():
    torch.set_num_threads(8)
    zoo_module.batch_norm = cs.batch_norm_any_dtype
    models = {dt: _model(dt) for dt in (torch.float32, torch.float64)}
    print(json.dumps({"causal": causal_precision(models), "featviz": featviz_precision(models)}))


if __name__ == "__main__":
    main()
