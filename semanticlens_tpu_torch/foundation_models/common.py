"""Shared helpers for foundation-model implementations."""

from __future__ import annotations

import math

import numpy as np
import torch


def init_from_specs(seed: int, specs) -> dict[str, np.ndarray]:
    """Random float32 numpy weights from (name, shape, kind) specs, JAX layout.

    The JAX package's scheme: ``ones`` / ``zeros`` / ``logit_scale``
    (ln(1/0.07)) / ``logit_scale_siglip`` (ln 10) / ``embed`` (σ=0.02) /
    anything else → normal with σ = fan_in**-0.5, drawn from ``np.random``
    with ``seed``.
    """
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape, kind in specs:
        if kind == "ones":
            params[name] = np.ones(shape, np.float32)
        elif kind == "zeros":
            params[name] = np.zeros(shape, np.float32)
        elif kind == "logit_scale":
            params[name] = np.asarray(math.log(1 / 0.07), np.float32)
        elif kind == "logit_scale_siglip":
            params[name] = np.asarray(math.log(10.0), np.float32)
        else:
            fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
            std = 0.02 if kind == "embed" else fan_in**-0.5
            params[name] = rng.standard_normal(shape, np.float32) * np.float32(std)
    return params


def float32_or(float32_param, int8_match):
    """``float32_param`` widened to the weights ``int8_match`` selects, or as it is when that is None.

    A tower places the weights it will quantize in float32, so that its
    int8 weights are quantized from float32, as in the JAX package, not
    from their copies in the compute dtype.
    """
    if int8_match is None:
        return float32_param
    return lambda name: float32_param(name) or int8_match(name)


def split_encode(mesh, encode_local, img):
    """``encode_image`` under a data mesh: this rank's rows of the global batch, all-gathered.

    Every rank calls it with the same (B, …) batch; rank ``r`` of ``W`` on
    the ``"data"`` axis encodes rows ``[r·⌈B/W⌉, (r+1)·⌈B/W⌉)`` (the batch
    zero-padded to a multiple of ``W``) and every rank returns the (B, D)
    embeddings in row order, as ``img`` sharded on ``"data"`` does in the
    JAX package. Without a mesh, ``encode_local(img)``.
    """
    from semanticlens_tpu_torch.core.mesh import all_gather, mesh_axis

    size, rank, group = mesh_axis(mesh, "data")
    if size == 1:
        return encode_local(img)
    b = img.shape[0]
    per = -(-b // size)
    if per * size != b:
        img = torch.cat([img, img.new_zeros((per * size - b, *img.shape[1:]))])
    return all_gather(encode_local(img[rank * per : (rank + 1) * per]), group).flatten(0, 1)[:b]


def tensor_parallel_call(mesh, fn, *args):
    """``fn(*args)`` as a plain tensor: under a ``"model"`` axis, run with DTensor parameters under
    ``implicit_replication`` and gather the output whole."""
    from semanticlens_tpu_torch.core.mesh import full_tensor, is_tensor_parallel, tensor_parallel_region

    if not is_tensor_parallel(mesh):
        return fn(*args)
    with tensor_parallel_region():
        return full_tensor(fn(*args))


def shard_tower(params: dict, mesh, specs_fn, cfg) -> dict:
    """The tower's parameters tensor-sharded by ``specs_fn(cfg)`` when the mesh has a ``"model"``
    axis (``parallel.shard_params``); otherwise unchanged."""
    from semanticlens_tpu_torch.core.mesh import check_mesh, is_tensor_parallel

    if not is_tensor_parallel(check_mesh(mesh)):
        return params
    from semanticlens_tpu_torch.parallel.tensor_parallel import shard_params

    return shard_params(params, mesh, specs_fn(cfg))
