"""Device ops: preprocessing, aggregation, streaming top-k, k-means, the cosine kernel, MoE and KDA layers' parts."""

from semanticlens_tpu_torch.ops import aggregators, kda, moe
from semanticlens_tpu_torch.ops.kmeans import batched_kmeans, kmeans
from semanticlens_tpu_torch.ops.topk import (
    TopKState,
    alive_latents,
    init_topk,
    topk_merge,
    topk_update,
    topk_update_jit,
)

__all__ = ["aggregators", "kda", "moe", "TopKState", "init_topk", "topk_update", "topk_update_jit", "topk_merge",
           "alive_latents", "kmeans", "batched_kmeans"]
