"""Carry weights across from the JAX package's layout into the port's.

The JAX package keeps flat parameter dicts with torch names but XLA layouts
(conv HWIO, linear (in, out)); the port keeps torch's own layouts (conv OIHW,
linear (out, in)), i.e. plain torch state dicts. These functions are the
inverses of ``semanticlens_tpu.models.resnet.ResNet.load_torch_state_dict``,
``semanticlens_tpu.models.vit.VisionTransformer.load_torch_state_dict``,
``semanticlens_tpu.foundation_models.clip.load_openclip_state_dict``,
``semanticlens_tpu.foundation_models.siglip.load_siglip_state_dict``,
``semanticlens_tpu.foundation_models.mobileclip.load_mobileclip_state_dict``,
the vision zoo's ``load_torch_state_dict`` (``semanticlens_tpu.models.layers.load_torch_params``)
and the LM subjects' loaders (``semanticlens_tpu.models.gpt``, ``.llama``,
``.gemma``, ``.phi``).
SAE and transcoder dictionaries keep the JAX layout in both packages
(``sae_params_from_jax`` / ``sae_params_to_jax``, and the ``.npz`` that the
JAX ``tools/train_sae.py --out`` and the port's ``train_sae --out`` write).

Inputs are numpy arrays (or anything ``np.asarray`` takes, e.g. a JAX array
on the host); outputs are float32 CPU tensors. The CLIP-family and zoo
converters also take the JAX package's int8 ``QuantizedTensor`` leaves
(``q``, ``scale``): ``q`` (in, out) → (out, in), HWIO → OIHW, ``scale``
as it is, as the port's
:class:`~semanticlens_tpu_torch.ops.quant.QuantizedTensor`. The port's
own random init draws its weights in the JAX layout from a numpy seed and
comes through here, so one seed gives both packages the same weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from semanticlens_tpu_torch.utils.device import resolve_device


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def _is_quantized(value) -> bool:
    return hasattr(value, "q") and hasattr(value, "scale")


def quantized_from_jax(value):
    """A JAX ``QuantizedTensor`` (int8 ``q`` (in, out) or HWIO, float32 ``scale`` (out,)) → the port's.

    The out channel moves from the last axis to dim 0: ``q`` (out, in) or
    OIHW, contiguous; ``scale`` is unchanged.
    """
    from semanticlens_tpu_torch.ops.quant import QuantizedTensor

    q = np.asarray(value.q, dtype=np.int8)
    q = q.transpose(3, 2, 0, 1) if q.ndim == 4 else q.T
    return QuantizedTensor(torch.from_numpy(np.ascontiguousarray(q)), _tensor(value.scale))


def _is_matrix(name: str, shape, kind: str) -> bool:
    """A 2-D weight that the JAX layout keeps (in, out): the JAX loader's ``load_torch_params`` rule."""
    return len(shape) == 2 and (kind == "linear" or name.endswith("weight"))


def torch_layout_shape(name: str, shape, kind: str) -> tuple[int, ...]:
    """The torch layout of a vision-zoo tensor whose JAX-layout spec is ``(name, shape, kind)``.

    Convs HWIO → OIHW (depthwise (k, k, 1, C) → (C, 1, k, k), Swin's
    patch embedding (4, 4, 3, C) → (C, 3, 4, 4)); the squeeze-excite 1×1
    convs (kind ``"se_fc"``, (in, out) linears in the JAX layout) → (out,
    in, 1, 1); weight matrices (kind ``"linear"`` or a ``…weight`` name, so
    Swin-V2's ``cpb_mlp`` linears too) (in, out) → (out, in);
    torchvision ConvNeXt's ``layer_scale`` (C,) → (C, 1, 1). Everything else
    keeps its shape: the relative-position bias tables ((2w−1)², heads) and
    Swin-V2's ``logit_scale`` (heads, 1, 1) are stored alike in both.
    """
    shape = tuple(shape)
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if kind == "se_fc":
        return (shape[1], shape[0], 1, 1)
    if _is_matrix(name, shape, kind):
        return shape[::-1]
    if name.endswith("layer_scale"):
        return (*shape, 1, 1)
    return shape


def zoo_params_from_jax(params: Mapping, specs) -> dict[str, torch.Tensor]:
    """The vision zoo (ResNet, VGG, DenseNet, ConvNeXt, EfficientNet/V2, MobileNetV2/V3, MNASNet, RegNet, Swin/V2,
    MaxViT, GoogLeNet, Inception-v3, ShuffleNetV2, AlexNet, SqueezeNet): weights in the JAX layout → torch
    state-dict tensors, by each tensor's spec (:func:`torch_layout_shape`).

    The inverse of the JAX families' ``load_torch_state_dict`` (``load_torch_params``): convs HWIO → OIHW,
    linears (in, out) → (out, in), the squeeze-excite ``.fc1.`` / ``.fc2.`` linears (in, out) →
    (out, in, 1, 1) convs, torchvision's ``layer_scale`` (C,) → (C, 1, 1); bias tables and
    ``logit_scale`` as they are. ``specs`` are the family's ``_param_specs()``.
    """
    out = {}
    for name, shape, kind in specs:
        if _is_quantized(params[name]):
            if tuple(params[name].q.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {params[name].q.shape} != expected {tuple(shape)}")
            out[name] = quantized_from_jax(params[name])
            continue
        arr = np.asarray(params[name], dtype=np.float32)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(shape)}")
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif kind == "se_fc":
            arr = arr.T[:, :, None, None]
        elif _is_matrix(name, shape, kind):
            arr = arr.T
        out[name] = _tensor(arr.reshape(torch_layout_shape(name, shape, kind)))
    return out


def clip_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """CLIP: convs HWIO → OIHW; linear and attention in-proj weights (in, out) → (out, in).

    ``visual.proj``, ``text_projection`` and the embeddings keep their layout
    (open_clip stores them as the JAX package does).
    """
    out = {}
    for name, value in params.items():
        if _is_quantized(value):
            out[name] = quantized_from_jax(value)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith("weight") and arr.ndim == 2 and "embedding" not in name:
            arr = arr.T
        out[name] = _tensor(arr)
    return out


def vit_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """ViT (timm or torchvision names): the patch conv HWIO → OIHW, every matrix (in, out) → (out, in).

    The class token and position embedding (3-D) keep their layout.
    """
    out = {}
    for name, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        out[name] = _tensor(arr)
    return out


def siglip_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """SigLIP (timm names): the patch conv HWIO → OIHW, linear weights and the text head (in, out) → (out, in).

    The JAX loader's relayout rule is CLIP's; ``visual.pos_embed`` (N, width),
    the MAP head's ``latent`` and the embeddings keep their layout.
    """
    return clip_params_from_jax(params)


def mobileclip_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """MobileCLIP: convs HWIO → OIHW (depthwise (k, k, 1, C) → (C, 1, k, k)), linear weights transposed.

    The JAX loader's relayout rule is CLIP's; ``visual.head.proj``,
    ``text_projection`` and the embeddings keep their layout.
    """
    return clip_params_from_jax(params)


LM_EMBEDDINGS = ("transformer.wte.weight", "transformer.wpe.weight", "model.embed_tokens.weight")


def lm_params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """LM subjects (GPT-2, Llama, Qwen2, Gemma, Gemma 2, Phi-3): every linear weight (in, out) → (out, in).

    The token and position embeddings (V, D) / (P, D), norm scales and
    biases keep their layout. The JAX layout is HF GPT-2's ``Conv1D``
    layout, so an HF GPT-2 state dict converts here too; HF Llama-family
    state dicts are already the port's layout. Values may be numpy arrays
    or CPU tensors.
    """
    out = {}
    for name, value in params.items():
        t = _tensor(value)
        out[name] = t.t().contiguous() if t.ndim == 2 and name not in LM_EMBEDDINGS else t
    return out


def sae_params_from_jax(arrays: Mapping, device=None) -> dict:
    """An SAE or transcoder dictionary in the JAX layout → float32 tensors on
    ``device`` (None → the card) under the same names, ``k`` as an int.

    The layouts are the same (``W_enc (d_in, n_latents)``, ``W_dec
    (n_latents, d_out)``), so the float32 bytes, and the cache digest of
    ``W_dec``, are too.
    """
    from semanticlens_tpu_torch.sae import _place

    return _place(arrays, resolve_device(device))


def sae_params_to_jax(params: Mapping) -> dict[str, np.ndarray]:
    """The inverse: float32 numpy arrays, ``k`` as a 0-d int32 array (what the JAX trainers stamp)."""
    return {name: np.asarray(int(value), np.int32) if name == "k"
            else np.ascontiguousarray(torch.as_tensor(value).detach().to("cpu", torch.float32).numpy())
            for name, value in params.items()}


def load_sae_npz(path, device=None) -> dict:
    """Read a dictionary ``.npz`` written by either package's SAE trainer tool."""
    with np.load(path) as arrays:
        return sae_params_from_jax(dict(arrays), device)


def save_sae_npz(path, params: Mapping) -> None:
    """Write a dictionary as the ``.npz`` the JAX ``tools/train_sae.py --out`` writes."""
    np.savez(path, **sae_params_to_jax(params))
