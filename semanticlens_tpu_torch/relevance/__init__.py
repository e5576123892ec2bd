"""Attribution-based analysis: LRP heatmaps for relevance-selected concept examples."""

from semanticlens_tpu_torch.relevance.attribution import (
    component_heatmaps,
    make_attribution_fn,
    make_batched_attribution_fn,
)

__all__ = ["component_heatmaps", "make_attribution_fn", "make_batched_attribution_fn"]
