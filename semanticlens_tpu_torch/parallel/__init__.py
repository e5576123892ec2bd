"""Multi-GPU parallelism: multi-process Collect, tensor-parallel placements, the rank launcher."""

from semanticlens_tpu_torch.parallel.multihost import (
    collect_multihost,
    fused_multihost,
    gather_selected_rows,
    merge_states_across_processes,
)
from semanticlens_tpu_torch.parallel.tensor_parallel import (
    clip_param_specs_2d,
    gpt2_param_specs_2d,
    llama_param_specs_2d,
    phi3_param_specs_2d,
    shard_clip_params,
    shard_params,
    siglip_param_specs_2d,
)

__all__ = [
    "shard_params",
    "shard_clip_params",
    "clip_param_specs_2d",
    "siglip_param_specs_2d",
    "llama_param_specs_2d",
    "gpt2_param_specs_2d",
    "phi3_param_specs_2d",
    "collect_multihost",
    "fused_multihost",
    "gather_selected_rows",
    "merge_states_across_processes",
]
