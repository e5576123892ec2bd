"""The program's objects for ``vitb16-siglip2``: ViT-B/16 and the SigLIP 2 ViT-B/16 image tower, from the seed.

Weights are drawn on the card (``portbench.reference.weights``) in the
served type and handed to the port's constructors through their state-dict
arguments. The port's ViT subject has no int8 path, so this
configuration's control is the reference in the program's place
(``"control": "reference-int8"``) and ``control=True`` is refused.
"""

from __future__ import annotations

import types

import torch

from portbench.harness import flops
from portbench.reference import siglip, vit, weights


def build(cfg: dict, seed: int, device, *, control: bool = False):
    from semanticlens_tpu_torch.foundation_models import create
    from semanticlens_tpu_torch.foundation_models.siglip import SigLIPConfig
    from semanticlens_tpu_torch.models import VisionTransformer
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    if control:
        raise ValueError("vitb16-siglip2 has no int8 path of its own; its control is the reference in int8")
    dtype = getattr(torch, cfg["dtype"])
    s, f = cfg["subject"], cfg["fm"]
    model = VisionTransformer(image_size=s["image_size"], patch_size=s["patch_size"], width=s["width"],
                              depth=s["depth"], heads=s["heads"], num_classes=s["num_classes"], dtype=dtype,
                              naming=s["naming"], device=device)
    params = model.load_torch_state_dict(
        weights.draw(vit.param_specs(s), seed, weights.STREAMS["subject"], device, dtype))
    model.name = f"{cfg['name']}-subject"
    v, t = f["vision"], f["text"]
    sig_cfg = SigLIPConfig(embed_dim=f["embed_dim"], image_size=v["image_size"], patch_size=v["patch_size"],
                           vision_width=v["width"], vision_layers=v["layers"], vision_heads=v["heads"],
                           text_width=t["width"], text_layers=t["layers"], text_heads=t["heads"],
                           vocab_size=t["vocab_size"], context_length=t["context_length"])
    fm = create(f["name"], params=weights.draw(siglip.param_specs(f), seed, weights.STREAMS["fm"], device, dtype),
                cfg=sig_cfg, dtype=dtype, device=device)
    return types.SimpleNamespace(model=model, params=params, fm=fm,
                                 subject_preprocess=make_preprocess_fn(**cfg["subject_preprocess"]))


def flops_per_image(cfg: dict) -> int:
    """The subject's whole forward (its head included: ``apply`` runs it), the tapped ``attn.heads``
    component's per-head projection, and the SigLIP image tower with its MAP head."""
    s, v = cfg["subject"], cfg["fm"]["vision"]
    tokens = (s["image_size"] // s["patch_size"]) ** 2 + 1
    subject = flops.vit_macs_per_image(s["image_size"], s["patch_size"], s["width"], s["depth"],
                                       s["mlp_ratio"], out_dim=s["num_classes"])
    heads = sum(flops.heads_tap_macs(tokens, s["width"]) for c in cfg["components"] if c.endswith(".attn.heads"))
    tower = flops.siglip_macs_per_image(v["image_size"], v["patch_size"], v["width"], v["layers"])
    return flops.MAC * (subject + heads + tower)
