"""Plain float32 reference of ``rn50-clip-b32``: ResNet-50's stage taps, spatially averaged, and the CLIP
ViT-B/32 image embedding, each after its own preprocessing. It imports nothing of the program.

The weights are drawn again from the seed, in the served type, and the
ResNet's BN statistics calibrated again on the same scenes, exactly as the
program was given them, then widened to float32.
"""

from __future__ import annotations

import torch

from portbench.reference import clip, preprocess, resnet, topk, weights


class Reference:
    def __init__(self, cfg: dict, seed: int, device, quant=None):
        served = getattr(torch, cfg["dtype"])
        self.cfg, self.quant = cfg, quant
        self.subject_p = weights.as_float32(resnet.served(cfg["subject"], cfg["subject_preprocess"], seed, device,
                                                          served))
        fm = weights.draw(clip.param_specs(cfg["fm"]), seed, weights.STREAMS["fm"], device, served)
        self.fm_p = weights.as_float32({k: v for k, v in fm.items() if k.startswith("visual.")})

    def subject(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 → {layer: (B, C)} aggregated activations."""
        x = preprocess.preprocess(images, **self.cfg["subject_preprocess"])
        taps = resnet.forward(self.subject_p, x, tuple(self.cfg["components"]), self.cfg["subject"], self.quant)
        return {name: topk.aggregate(t, self.cfg["aggregate"]) for name, t in taps.items()}

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 → (B, D) image embeddings."""
        x = preprocess.preprocess(images, **self.cfg["fm_preprocess"])
        return clip.encode_image(self.fm_p, x, self.cfg["fm"], self.quant)
