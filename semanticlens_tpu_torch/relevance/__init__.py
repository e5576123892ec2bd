"""Attribution-based analysis: LRP heatmaps for relevance-selected concept examples, and token relevance."""

from semanticlens_tpu_torch.relevance.attribution import (
    component_heatmaps,
    make_attribution_fn,
    make_batched_attribution_fn,
)
from semanticlens_tpu_torch.relevance.text import highlight_evidence, make_token_relevance_fn, token_relevance

__all__ = ["component_heatmaps", "make_attribution_fn", "make_batched_attribution_fn", "make_token_relevance_fn",
           "token_relevance", "highlight_evidence"]
