"""The program's objects for ``rn50-clip-b32``: ResNet-50 and the CLIP ViT-B/32 image tower, from the seed.

Weights are drawn on the card (``portbench.reference.weights``) in the
served type and handed to the port's constructors through their state-dict
arguments; ``control=True`` builds both with the port's own int8 path.
"""

from __future__ import annotations

import types

import torch

from portbench.harness import flops
from portbench.reference import clip, resnet, weights


def build(cfg: dict, seed: int, device, *, control: bool = False):
    from semanticlens_tpu_torch.foundation_models import OpenClip
    from semanticlens_tpu_torch.foundation_models.clip import CLIPConfig, TextCfg, VisionCfg
    from semanticlens_tpu_torch.models import ResNet
    from semanticlens_tpu_torch.utils import make_preprocess_fn

    dtype = getattr(torch, cfg["dtype"])
    quant = "int8" if control else None
    s, f = cfg["subject"], cfg["fm"]
    model = ResNet(depth=s["depth"], num_classes=s["num_classes"], dtype=dtype, quantize=quant, device=device)
    params = model.load_torch_state_dict(resnet.served(s, cfg["subject_preprocess"], seed, device, dtype))
    model.name = f"{cfg['name']}-subject"
    clip_cfg = CLIPConfig(embed_dim=f["embed_dim"], vision=VisionCfg(**f["vision"]), text=TextCfg(**f["text"]),
                          quick_gelu=f["quick_gelu"])
    fm = OpenClip(f["name"], params=weights.draw(clip.param_specs(f), seed, weights.STREAMS["fm"], device, dtype),
                  cfg=clip_cfg, quick_gelu=f["quick_gelu"], dtype=dtype, device=device, quantize=quant)
    return types.SimpleNamespace(model=model, params=params, fm=fm,
                                 subject_preprocess=make_preprocess_fn(**cfg["subject_preprocess"]))


def flops_per_image(cfg: dict) -> int:
    """The subject's whole forward (its classifier included: ``apply`` runs it) and the image tower."""
    s, v = cfg["subject"], cfg["fm"]["vision"]
    subject = flops.resnet_macs_per_image(s["depth"], s["image_size"], s["num_classes"])
    tower = flops.vit_macs_per_image(v["image_size"], v["patch_size"], v["width"], v["layers"],
                                     out_dim=cfg["fm"]["embed_dim"])
    return flops.MAC * (subject + tower)
