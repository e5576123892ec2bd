"""Plain float32 reference of ``kimilinear-clip-b32``: this card's share of Kimi Linear, its tapped KDA layer and
router averaged over tokens, and the CLIP ViT-B/32 text embedding of a sequence's string. It imports nothing of the
program.

The subject's weights are drawn again from the seed, layer by layer, in
the served type, exactly as the program was given them, and widened to
float32 (``reference/kimi_linear.token_means``), the held experts only;
the sweep's check hands the corpus over in blocks of sequences and each
block is run one layer at a time. The text embedding reads a sequence's
token row and frames its string as the port's hash tokenizer does
(``harness/text_inputs.py``).
"""

from __future__ import annotations

import torch

from portbench.harness import text_inputs
from portbench.reference import clip, clip_text, kimi_linear, weights


class Reference:
    def __init__(self, cfg: dict, seed: int, device, quant=None):
        self.cfg, self.seed, self.device, self.quant = cfg, seed, device, quant
        self.served = getattr(torch, cfg["dtype"])
        fm = weights.draw(clip.param_specs(cfg["fm"]), seed, weights.STREAMS["fm"], device, self.served)
        self.fm_p = weights.as_float32({k: v for k, v in fm.items() if not k.startswith("visual.")})

    def subject(self, tokens: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, T) token ids → {component tap: (B, C)} token-averaged activations."""
        return kimi_linear.token_means(self.cfg, self.seed, self.device, tokens, self.cfg["components"], self.served,
                                       self.quant)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids → (B, D) text embeddings of the sequences' strings."""
        f = self.cfg["fm"]
        rows = text_inputs.fm_token_rows(self.seed, tokens.cpu().numpy(), self.cfg["fm_words"], self.cfg["vocab_size"],
                                         f["text"]["vocab_size"], f["text"]["context_length"])
        return clip_text.encode_text(self.fm_p, torch.from_numpy(rows).to(self.device), f, self.quant)
