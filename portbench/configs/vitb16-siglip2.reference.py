"""Plain float32 reference of ``vitb16-siglip2``: ViT-B/16's MLP and head taps, averaged over tokens, and
the SigLIP 2 image embedding, each after its own preprocessing. It imports nothing of the program.

The weights are drawn again from the seed, in the served type, exactly as
the program was given them, and widened to float32.
"""

from __future__ import annotations

import torch

from portbench.reference import preprocess, siglip, topk, vit, weights


class Reference:
    def __init__(self, cfg: dict, seed: int, device, quant=None):
        served = getattr(torch, cfg["dtype"])
        self.cfg, self.quant = cfg, quant
        self.subject_p = weights.as_float32(
            weights.draw(vit.param_specs(cfg["subject"]), seed, weights.STREAMS["subject"], device, served))
        fm = weights.draw(siglip.param_specs(cfg["fm"]), seed, weights.STREAMS["fm"], device, served)
        self.fm_p = weights.as_float32({k: v for k, v in fm.items() if k.startswith("visual.")})

    def subject(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, H, W, 3) uint8 → {component tap: (B, C)} token-averaged activations."""
        x = preprocess.preprocess(images, **self.cfg["subject_preprocess"])
        taps = vit.forward(self.subject_p, x, tuple(self.cfg["components"]), self.cfg["subject"], self.quant)
        return {name: topk.aggregate(t, self.cfg["aggregate"]) for name, t in taps.items()}

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 → (B, D) image embeddings."""
        x = preprocess.preprocess(images, **self.cfg["fm_preprocess"])
        return siglip.encode_image(self.fm_p, x, self.cfg["fm"], self.quant)
