"""Where a float32 ε heatmap departs from float64: relevance at every tap of a zoo family, layer by layer.

Runs the ε heatmap of one component of ``chip_smoke.py``'s heatmap inputs
(seed-0 weights, 2 images at 224², the inputs of ``heatmap_rows``) in
float32 on the card (when there is one) and on the CPU, and in float64 on
the CPU, recording the relevance that reaches every tap on the way back
from the heatmap's layer. Prints one JSON line: per float32 run, the
heatmap's max gap from float64 and, for each tap whose relevance departs
from float64 by more than ``REPORT`` of its scale, the gap, how many
entries depart by more than 1e-2 of the scale, where the largest is, and
the activation there in both runs. The deepest tap that departs is where
the float32 run takes another path: a max-pool whose input departs while
its output does not has resolved a near-tie in a window the other way.
The map is GoogLeNet ``inception4c``'s, component 1, the ε map of
``[zoo2]`` that departs most. Run on the card (or, CPU only, anywhere):

    python3 precision_heatmaps.py
"""

from __future__ import annotations

import json

import torch

import chip_smoke as cs
from semanticlens_tpu_torch import models
from semanticlens_tpu_torch.models import base
from semanticlens_tpu_torch.relevance.attribution import make_attribution_fn

FAMILY, LAYER, COMPONENT = "GoogLeNet", "inception4c", 1
REPORT = 1e-3  # report the taps whose relevance departs by more than this share of its scale


def relevance_at_taps(model, params, x, layer, component) -> tuple[dict, dict, torch.Tensor]:
    """``({tap: relevance}, {tap: activation}, heatmap)`` of one ε heatmap, every tap before ``layer`` recorded."""
    names = list(model.module_names)
    grads, acts = {}, {}

    def record(name):
        def rewrite(v):
            if v.requires_grad:
                acts[name] = v.detach().cpu().double()
                v.register_hook(lambda g: grads.__setitem__(name, g.detach().cpu().double()))
            return v

        return rewrite

    fn = make_attribution_fn(model, layer, composite="epsilon")
    with base.interventions({name: record(name) for name in names[: names.index(layer) + 1]}):
        heat = fn(params, x.to(model.device), component)
    return grads, acts, heat.cpu().double()


def main() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.ZOO2
    x = torch.rand(cfg["gate_images"], cfg["size"], cfg["size"], 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    cpu = torch.device("cpu")
    runs = [("cpu", cpu, torch.float32), ("reference", cpu, torch.float64)]
    if torch.cuda.is_available():
        runs.insert(0, ("card", torch.device("cuda"), torch.float32))
    got = {}
    for label, device, dtype in runs:
        model = getattr(models, FAMILY)(dtype=dtype, device=device)
        params = model.load_jax_params(model.init_jax_layout(0))
        got[label] = relevance_at_taps(model, params, x, LAYER, COMPONENT)
    ref_grads, ref_acts, ref_heat = got.pop("reference")
    out = {"family": FAMILY, "layer": LAYER, "component": COMPONENT}
    for label, (grads, acts, heat) in got.items():
        taps = {}
        for name in (n for n in acts if n in grads):  # forward order
            gap, scale = (grads[name] - ref_grads[name]).abs(), float(ref_grads[name].abs().max())
            if float(gap.max()) > REPORT * scale:
                at = tuple(int(i) for i in torch.nonzero(gap == gap.max())[0])
                taps[name] = {"rel": float(gap.max()) / scale, "n_over_1e-2": int((gap > 1e-2 * scale).sum()),
                              "at": at, "act": float(acts[name][at]), "act_float64": float(ref_acts[name][at])}
        out[label] = {"heatmap_max": float((heat - ref_heat).abs().max()), "taps": taps}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
