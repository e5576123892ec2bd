"""Tensor-parallel placements for the foundation-model towers and the LM subjects.

Counterpart of ``semanticlens_tpu.parallel.tensor_parallel``: Megatron-style
column → row parallel pairs over the mesh's ``"model"`` axis, written as
DTensor placements on the flat parameter dict. The model code is unchanged:
:func:`shard_params` turns the parameters into DTensors, the forward runs
under ``torch.distributed.tensor.experimental.implicit_replication()``, and
DTensor inserts the all-reduces of the row-parallel products (the JAX
package leaves that to GSPMD). The attention core itself runs on plain
tensors, whole heads per rank (``models.layers._dtensor_attention``).

The port's Linear weights are torch's (out, in), where the JAX package's
are (in, out). So the JAX package's column-parallel ``P(None, "model")`` is
``Shard(0)`` here, its row-parallel ``P("model", None)`` is ``Shard(1)``,
and a column-parallel bias is ``Shard(0)``. Unlisted parameters, and listed
ones whose split dimension the axis does not divide, are replicated.
"""

from __future__ import annotations

import torch

__all__ = ["clip_param_specs_2d", "gpt2_param_specs_2d", "llama_param_specs_2d", "phi3_param_specs_2d",
           "shard_clip_params", "shard_params", "siglip_param_specs_2d"]


def _column():
    from torch.distributed.tensor import Shard

    return Shard(0)


def _row():
    from torch.distributed.tensor import Shard

    return Shard(1)


def _transformer_specs_2d(prefix: str, layers: int) -> dict:
    """open_clip's ``resblocks``: fused ``in_proj`` and ``c_fc`` column-, ``out_proj`` and ``c_proj`` row-parallel."""
    specs = {}
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        specs[f"{p}.attn.in_proj_weight"] = _column()
        specs[f"{p}.attn.in_proj_bias"] = _column()
        specs[f"{p}.attn.out_proj.weight"] = _row()
        specs[f"{p}.mlp.c_fc.weight"] = _column()
        specs[f"{p}.mlp.c_fc.bias"] = _column()
        specs[f"{p}.mlp.c_proj.weight"] = _row()
    return specs


def clip_param_specs_2d(cfg) -> dict:
    """Placements for a CLIP param dict (ViT or ModifiedResNet vision tower, and the text tower).

    ``cfg`` is a :class:`~semanticlens_tpu_torch.foundation_models.clip.CLIPConfig`.
    """
    specs = {}
    if cfg.vision.kind == "vit":
        specs.update(_transformer_specs_2d("visual.transformer", cfg.vision.layers))
    specs.update(_transformer_specs_2d("transformer", cfg.text.layers))
    return specs


def siglip_param_specs_2d(cfg) -> dict:
    """Placements for a SigLIP param dict (timm block naming, both towers)."""
    specs = {}
    for tower, layers in (("visual.blocks", cfg.vision_layers), ("text.blocks", cfg.text_layers)):
        for i in range(layers):
            p = f"{tower}.{i}"
            specs[f"{p}.attn.qkv.weight"] = _column()
            specs[f"{p}.attn.qkv.bias"] = _column()
            specs[f"{p}.attn.proj.weight"] = _row()
            specs[f"{p}.mlp.fc1.weight"] = _column()
            specs[f"{p}.mlp.fc1.bias"] = _column()
            specs[f"{p}.mlp.fc2.weight"] = _row()
    return specs


def llama_param_specs_2d(model) -> dict:
    """Placements for a :class:`~semanticlens_tpu_torch.models.Llama` subject (Qwen2, Gemma, Gemma 2 too).

    q/k/v and gate/up are column-parallel (each rank computes whole heads
    and its slice of the SwiGLU hidden), o_proj and down_proj row-parallel.
    Norm scales and embeddings stay replicated. Prefer ``heads % tp == 0``
    and ``kv_heads % tp == 0``: otherwise the attention core replicates q,
    k and v first (and a kv dimension that the axis does not divide is
    replicated by :func:`shard_params`).
    """
    specs = {}
    for i in range(model.depth):
        p = f"model.layers.{i}"
        for col in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj"):
            specs[f"{p}.{col}.weight"] = _column()
            specs[f"{p}.{col}.bias"] = _column()  # Qwen2's attention_bias only
        specs[f"{p}.self_attn.o_proj.weight"] = _row()
        specs[f"{p}.mlp.down_proj.weight"] = _row()
    return specs


def phi3_param_specs_2d(model) -> dict:
    """Placements for a :class:`~semanticlens_tpu_torch.models.Phi3` subject.

    The fused ``qkv_proj`` and ``gate_up_proj`` are column-parallel; the
    forward's q/k/v and gate/up split then replicates them, as GSPMD
    reshards in the JAX package. ``o_proj`` / ``down_proj`` are row-parallel.
    """
    specs = {}
    for i in range(model.depth):
        p = f"model.layers.{i}"
        specs[f"{p}.self_attn.qkv_proj.weight"] = _column()
        specs[f"{p}.mlp.gate_up_proj.weight"] = _column()
        specs[f"{p}.self_attn.o_proj.weight"] = _row()
        specs[f"{p}.mlp.down_proj.weight"] = _row()
    return specs


def gpt2_param_specs_2d(model) -> dict:
    """Placements for a :class:`~semanticlens_tpu_torch.models.GPT2` subject.

    The port stores ``c_attn`` as (3D, D) and ``c_fc`` as (4D, D) (the
    loader transposes HF's ``Conv1D``), so both are ``Shard(0)``, with
    their biases; ``attn.c_proj`` and ``mlp.c_proj`` are ``Shard(1)``. The
    forward's q/k/v slices of ``c_attn`` replicate it (the boundaries at D
    and 2D cut no whole number of shards for tp ∈ {2, 4, 8}).
    """
    specs = {}
    for i in range(model.depth):
        p = f"transformer.h.{i}"
        specs[f"{p}.attn.c_attn.weight"] = _column()
        specs[f"{p}.attn.c_attn.bias"] = _column()
        specs[f"{p}.attn.c_proj.weight"] = _row()
        specs[f"{p}.mlp.c_fc.weight"] = _column()
        specs[f"{p}.mlp.c_fc.bias"] = _column()
        specs[f"{p}.mlp.c_proj.weight"] = _row()
    return specs


def shard_params(params: dict, mesh, specs: dict, *, model_axis: str = "model") -> dict:
    """The parameter dict as DTensors on the mesh's ``model_axis``, placed per ``specs``.

    Each rank keeps its chunk of a ``Shard(d)`` tensor (``torch.chunk``
    order, no communication: every rank holds the same full weights, e.g.
    from one seed or after ``core.replicate``). A spec whose dimension the
    axis does not divide, and every unlisted tensor, is ``Replicate()``.
    Non-tensor entries pass through. Works for any flat name → tensor dict:
    towers and subjects alike.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from semanticlens_tpu_torch.core.mesh import check_mesh

    names = check_mesh(mesh).mesh_dim_names or ()
    if model_axis not in names:
        raise ValueError(f"mesh axes {names} have no '{model_axis}' axis to shard parameters over")
    sub = mesh[model_axis] if mesh.ndim > 1 else mesh
    tp, rank = sub.size(), sub.get_local_rank()
    out = {}
    for name, value in params.items():
        if not isinstance(value, torch.Tensor):
            out[name] = value
            continue
        spec = specs.get(name)
        if isinstance(spec, Shard) and value.shape[spec.dim] % tp == 0:
            local = value.chunk(tp, dim=spec.dim)[rank].contiguous()
            out[name] = DTensor.from_local(local, sub, [spec], run_check=False)
        else:
            out[name] = DTensor.from_local(value, sub, [Replicate()], run_check=False)
    return out


#: The JAX package's name from before the helper went generic.
shard_clip_params = shard_params
