"""SigLIP (v2-style) vision-language towers, functional, on torch tensors.

Counterpart of ``semanticlens_tpu.foundation_models.siglip`` (the reference's
``SigLipV2``, a pin of open_clip's ``hf-hub:timm/ViT-B-16-SigLIP2``):

- **Vision**: a ViT with no class token (196 patch tokens plus a learned
  ``pos_embed``), exact GELU, a final LayerNorm and a MAP attention-pooling
  head: one learned query cross-attends over the patches, then ``proj``,
  LayerNorm and an MLP with a residual on the pooled vector.
- **Text**: a non-causal transformer (no mask, unlike CLIP's), pooled at the
  last position ``x[:, -1]`` (with ``SigLipTokenizer``'s padding usually a
  pad token), then a dense head in float32.
- Normalization mean/std = (0.5, 0.5, 0.5).

Parameter names follow timm/open_clip SigLIP state dicts, in torch's layouts
(conv OIHW, linear (out, in)); ``visual.pos_embed`` is kept as (N, width).
The JAX package's parameters come across through
:func:`semanticlens_tpu_torch.convert.siglip_params_from_jax`.

Precision: matmuls and attention run in the tower's dtype (bf16 on the
card); layer norms are computed in float32 and the text head is a float32
product (the JAX package's ``Precision.HIGHEST``; TF32 stays off).

``mesh=`` splits ``encode_image`` over a data mesh and tensor-shards the
towers over a ``"model"`` axis, as ``OpenClip`` does. ``quantize="int8"``
runs the image tower's block matmuls in int8 (:func:`quantize_siglip_params`).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.foundation_models.clip import (
    _load_checkpoint,
    _to_image_batch,
    check_quantize,
    place_params,
    torch_shape,
)
from semanticlens_tpu_torch.foundation_models.common import (
    float32_or,
    init_from_specs,
    shard_tower,
    split_encode,
    tensor_parallel_call,
)
from semanticlens_tpu_torch.foundation_models.tokenizer import HashTokenizer
from semanticlens_tpu_torch.models.layers import conv2d, gelu, layer_norm, linear, scaled_dot_product_attention
from semanticlens_tpu_torch.ops.preprocess import SIGLIP_MEAN, SIGLIP_STD, preprocess_images
from semanticlens_tpu_torch.ops.quant import quantize_params
from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    embed_dim: int = 768
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    vocab_size: int = 256000
    context_length: int = 64


SIGLIP_PRESETS = {
    "ViT-B-16-SigLIP2": SigLIPConfig(),
    "ViT-B-16-SigLIP": SigLIPConfig(vocab_size=32000),
}


def _vit_block(params, prefix, x, heads):
    """timm Block: norm1 → attn (fused qkv) → norm2 → mlp (exact GELU), residual around both."""
    h = layer_norm(x, params[f"{prefix}.norm1.weight"], params[f"{prefix}.norm1.bias"])
    q, k, v = linear(h, params[f"{prefix}.attn.qkv.weight"], params[f"{prefix}.attn.qkv.bias"]).chunk(3, dim=-1)
    h = scaled_dot_product_attention(q, k, v, heads)
    x = x + linear(h, params[f"{prefix}.attn.proj.weight"], params[f"{prefix}.attn.proj.bias"])
    h = layer_norm(x, params[f"{prefix}.norm2.weight"], params[f"{prefix}.norm2.bias"])
    h = gelu(linear(h, params[f"{prefix}.mlp.fc1.weight"], params[f"{prefix}.mlp.fc1.bias"]))
    return x + linear(h, params[f"{prefix}.mlp.fc2.weight"], params[f"{prefix}.mlp.fc2.bias"])


def siglip_encode_image(params, cfg: SigLIPConfig, images, *, dtype=torch.float32):
    """(B, H, W, 3) preprocessed → (B, embed_dim) float32 via MAP attention pooling."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    x = conv2d(x, params["visual.patch_embed.proj.weight"], params["visual.patch_embed.proj.bias"],
               stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # (B, g·g, width), row-major over the grid
    b, _, w = x.shape
    x = x + params["visual.pos_embed"].to(dtype)
    for i in range(cfg.vision_layers):
        x = _vit_block(params, f"visual.blocks.{i}", x, cfg.vision_heads)
    x = layer_norm(x, params["visual.norm.weight"], params["visual.norm.bias"])

    # MAP head: one learned probe token cross-attends over the patches.
    p = "visual.attn_pool"
    probe = params[f"{p}.latent"].to(dtype).expand(b, 1, w)
    q = linear(probe, params[f"{p}.q.weight"], params[f"{p}.q.bias"])
    k, v = linear(x, params[f"{p}.kv.weight"], params[f"{p}.kv.bias"]).chunk(2, dim=-1)
    pooled = scaled_dot_product_attention(q, k, v, cfg.vision_heads)
    pooled = linear(pooled, params[f"{p}.proj.weight"], params[f"{p}.proj.bias"])[:, 0]
    h = layer_norm(pooled, params[f"{p}.norm.weight"], params[f"{p}.norm.bias"])
    h = gelu(linear(h, params[f"{p}.mlp.fc1.weight"], params[f"{p}.mlp.fc1.bias"]))
    h = linear(h, params[f"{p}.mlp.fc2.weight"], params[f"{p}.mlp.fc2.bias"])
    return (pooled + h).float()


def siglip_encode_text(params, cfg: SigLIPConfig, tokens, *, dtype=torch.float32):
    """(B, T) int tokens → (B, embed_dim) float32: non-causal transformer, last-position pooling."""
    tokens = tokens.long()
    x = params["text.token_embedding.weight"][tokens].to(dtype)
    x = x + params["text.positional_embedding"][: tokens.shape[1]].to(dtype)
    for i in range(cfg.text_layers):
        x = _vit_block(params, f"text.blocks.{i}", x, cfg.text_heads)
    x = layer_norm(x, params["text.norm.weight"], params["text.norm.bias"])
    pooled = x[:, -1]  # SigLIP pools the final token position
    return F.linear(pooled.float(), params["text.head.weight"].float(), params["text.head.bias"].float())


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #
def _block_specs(prefix, w):
    return [
        (f"{prefix}.norm1.weight", (w,), "ones"),
        (f"{prefix}.norm1.bias", (w,), "zeros"),
        (f"{prefix}.attn.qkv.weight", (w, 3 * w), "attn"),
        (f"{prefix}.attn.qkv.bias", (3 * w,), "zeros"),
        (f"{prefix}.attn.proj.weight", (w, w), "proj"),
        (f"{prefix}.attn.proj.bias", (w,), "zeros"),
        (f"{prefix}.norm2.weight", (w,), "ones"),
        (f"{prefix}.norm2.bias", (w,), "zeros"),
        (f"{prefix}.mlp.fc1.weight", (w, 4 * w), "fc"),
        (f"{prefix}.mlp.fc1.bias", (4 * w,), "zeros"),
        (f"{prefix}.mlp.fc2.weight", (4 * w, w), "proj"),
        (f"{prefix}.mlp.fc2.bias", (w,), "zeros"),
    ]


def siglip_param_specs(cfg: SigLIPConfig):
    """All (name, shape, init-kind) of a SigLIP under ``cfg``, shapes in the JAX package's layout."""
    if cfg.embed_dim != cfg.vision_width:
        # SigLIP's image embedding is the MAP-head output, which stays at
        # vision width; the text head projects text_width → embed_dim.
        raise ValueError(
            f"SigLIP requires embed_dim == vision_width, got {cfg.embed_dim} != {cfg.vision_width}"
        )
    w = cfg.vision_width
    grid = cfg.image_size // cfg.patch_size
    specs = [
        ("visual.patch_embed.proj.weight", (cfg.patch_size, cfg.patch_size, 3, w), "patch"),
        ("visual.patch_embed.proj.bias", (w,), "zeros"),
        ("visual.pos_embed", (grid * grid, w), "scaled"),
        ("visual.norm.weight", (w,), "ones"),
        ("visual.norm.bias", (w,), "zeros"),
        ("visual.attn_pool.latent", (1, w), "scaled"),
        ("visual.attn_pool.q.weight", (w, w), "proj"),
        ("visual.attn_pool.q.bias", (w,), "zeros"),
        ("visual.attn_pool.kv.weight", (w, 2 * w), "proj"),
        ("visual.attn_pool.kv.bias", (2 * w,), "zeros"),
        ("visual.attn_pool.proj.weight", (w, w), "proj"),
        ("visual.attn_pool.proj.bias", (w,), "zeros"),
        ("visual.attn_pool.norm.weight", (w,), "ones"),
        ("visual.attn_pool.norm.bias", (w,), "zeros"),
        ("visual.attn_pool.mlp.fc1.weight", (w, 4 * w), "fc"),
        ("visual.attn_pool.mlp.fc1.bias", (4 * w,), "zeros"),
        ("visual.attn_pool.mlp.fc2.weight", (4 * w, w), "proj"),
        ("visual.attn_pool.mlp.fc2.bias", (w,), "zeros"),
    ]
    for i in range(cfg.vision_layers):
        specs += _block_specs(f"visual.blocks.{i}", w)

    tw = cfg.text_width
    specs += [
        ("text.token_embedding.weight", (cfg.vocab_size, tw), "embed"),
        ("text.positional_embedding", (cfg.context_length, tw), "scaled"),
        ("text.norm.weight", (tw,), "ones"),
        ("text.norm.bias", (tw,), "zeros"),
        ("text.head.weight", (tw, cfg.embed_dim), "proj"),
        ("text.head.bias", (cfg.embed_dim,), "zeros"),
        ("logit_scale", (), "logit_scale_siglip"),
        ("logit_bias", (), "zeros"),
    ]
    for i in range(cfg.text_layers):
        specs += _block_specs(f"text.blocks.{i}", tw)
    return specs


def init_siglip_params_jax_layout(seed: int, cfg: SigLIPConfig) -> dict[str, np.ndarray]:
    """Random numpy weights in the JAX package's layout (its init scheme, numpy streams)."""
    return init_from_specs(seed, siglip_param_specs(cfg))


def load_siglip_state_dict(cfg: SigLIPConfig, state_dict: Mapping) -> dict[str, torch.Tensor]:
    """A timm/open_clip SigLIP torch state dict, checked: float32 CPU tensors in torch's layout.

    Counterpart of the JAX package's ``load_siglip_state_dict``, which
    relayouts into XLA's layouts; the port keeps torch's. Every name of
    ``siglip_param_specs(cfg)`` must be there (``KeyError`` otherwise) with
    its torch shape (``ValueError``); ``visual.pos_embed`` may come as
    (1, N, width) and is kept as (N, width). Other entries are ignored.
    """
    out = {}
    for name, shape, _ in siglip_param_specs(cfg):
        t = torch.as_tensor(state_dict[name]).detach().to("cpu", torch.float32)
        if name == "visual.pos_embed" and t.ndim == 3:
            t = t[0]
        expected = torch_shape(name, shape)
        if tuple(t.shape) != expected:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != expected {expected}")
        out[name] = t
    return out


#: timm-Block dense suffixes (SigLIP's names, not open_clip's): the fused
#: qkv, the attention out-proj and the MLP pair, almost all of the tower's FLOPs.
SIGLIP_DENSE_SUFFIXES = (
    ".attn.qkv.weight",
    ".attn.proj.weight",
    ".mlp.fc1.weight",
    ".mlp.fc2.weight",
)


def siglip_int8_match(*, include_text: bool = False):
    """The keys :func:`quantize_siglip_params` quantizes: the image (and with ``include_text`` the text)
    blocks' dense weights."""
    prefixes = ("visual.blocks.", "text.blocks.") if include_text else ("visual.blocks.",)
    return lambda key: key.startswith(prefixes) and key.endswith(SIGLIP_DENSE_SUFFIXES)


def quantize_siglip_params(params, *, include_text: bool = False):
    """The SigLIP ViT blocks' matmuls int8-quantized (:mod:`semanticlens_tpu_torch.ops.quant`).

    The MAP attention-pool head, the norms, biases and embeddings stay
    float. SigLIP splits its fused qkv on the output side, after the
    product, so no weight slicing is needed.
    """
    return quantize_params(params, siglip_int8_match(include_text=include_text))


def _float32_param(name: str) -> bool:
    """Tensors the towers use in float32: the layer norms, the text head and the logit terms."""
    return ".norm" in name or name.startswith(("text.head.", "logit_"))


# --------------------------------------------------------------------------- #
# User-facing foundation-model class
# --------------------------------------------------------------------------- #
class SigLipV2(AbstractVLM):
    """SigLIP v2 foundation model with the reference's ``SigLipV2`` API.

    Parameters
    ----------
    params : optional timm-named SigLIP state dict (torch layout).
    checkpoint : optional state dict or path to one (``.safetensors`` or
        ``.npz``); a SentencePiece model next to a checkpoint file is found.
    jax_params : optional parameter dict in the JAX package's layout.
    tokenizer : optional tokenizer object (called as ``tokenizer(texts, ctx)``).
    tokenizer_path : SentencePiece ``.model`` file. Without it and without
        ``tokenizer``, one is looked up (``assets.find_sentencepiece``: next
        to the checkpoint, ``$SEMANTICLENS_ASSETS``, the HF cache); else a
        HashTokenizer fallback is used (testing only).
    dtype : tower compute dtype.
    device : ``None`` → the CUDA card (raises without one), or ``"cpu"``.
    seed : numpy seed of the random weights used when none are given.
    cfg : optional tower configuration that replaces the preset's (a
        cut-down tower, e.g. for tests); the name stays the preset's.
    mesh : optional ``DeviceMesh``: ``encode_image`` splits the batch over a
        ``"data"`` axis and gathers it, a ``"model"`` axis tensor-shards
        the towers (``parallel.siglip_param_specs_2d``), as
        for ``OpenClip``.
    quantize : ``None`` or ``"int8"``: the image tower's blocks run int8
        (:func:`quantize_siglip_params`), quantized from the float32 weights
        after loading and mesh placement; ``name`` gains ``-int8``.
    """

    URL = "hf-hub:timm/ViT-B-16-SigLIP2"

    def __init__(
        self,
        *,
        params=None,
        checkpoint=None,
        jax_params=None,
        tokenizer=None,
        tokenizer_path=None,
        dtype=torch.bfloat16,
        device=None,
        seed: int = 0,
        mesh=None,
        quantize: str | None = None,
        cfg: SigLIPConfig | None = None,
    ):
        check_quantize(quantize)
        self.url = self.URL
        self.cfg = cfg or SIGLIP_PRESETS["ViT-B-16-SigLIP2"]
        self.dtype = dtype
        self.device = resolve_device(device)
        self.name = f"SigLipV2({self.URL})"

        if params is None and checkpoint is not None:
            params = _load_checkpoint(checkpoint)
        if params is None:
            if jax_params is None:
                logger.warning("No weights provided for %s — using random init.", self.URL)
                jax_params = init_siglip_params_jax_layout(seed, self.cfg)
            params = convert.siglip_params_from_jax(jax_params)
        self.quantize = quantize
        float32 = float32_or(_float32_param, siglip_int8_match() if quantize else None)
        with span("fm.load"):
            self.params = place_params(load_siglip_state_dict(self.cfg, params), float32, dtype, self.device)
        from semanticlens_tpu_torch.parallel.tensor_parallel import siglip_param_specs_2d

        self.mesh = mesh
        self.params = shard_tower(self.params, mesh, siglip_param_specs_2d, self.cfg)
        if quantize:
            self.params = quantize_siglip_params(self.params)
            self.name = f"{self.name}-int8"  # concept-DB caches key on the name

        # Resolution order: an explicit tokenizer object, an explicit .model
        # path, a locally discovered .model, then the testing fallback.
        if tokenizer is None:
            if tokenizer_path is None:
                from semanticlens_tpu_torch.foundation_models.assets import find_sentencepiece

                tokenizer_path = find_sentencepiece(
                    near=checkpoint if isinstance(checkpoint, (str, Path)) else None,
                    expected_vocab=self.cfg.vocab_size,
                )
            if tokenizer_path is not None:
                from semanticlens_tpu_torch.foundation_models.sentencepiece import SigLipTokenizer

                tokenizer = SigLipTokenizer(tokenizer_path, self.cfg.context_length)
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size, self.cfg.context_length)

    @property
    def context_length(self):
        return self.cfg.context_length

    @property
    def embed_dim(self):
        return self.cfg.embed_dim

    def __repr__(self):
        quant = f", quantize='{self.quantize}'" if self.quantize else ""
        return f"{self.__class__.__name__}(url='{self.url}'{quant})"

    def preprocess(self, img):
        """Images → normalized (B, S, S, 3) on the device (as ``OpenClip.preprocess``, SigLIP's mean/std)."""
        size = self.cfg.image_size
        x = _to_image_batch(img, size, self.device)
        return preprocess_images(x, size=size, crop=size, mean=SIGLIP_MEAN, std=SIGLIP_STD)

    def encode_image(self, img):
        return split_encode(self.mesh, self.encode_image_local, img)

    def encode_image_local(self, img):
        """Embeddings of exactly the rows given (no split over a data mesh)."""
        return tensor_parallel_call(self.mesh, lambda x: siglip_encode_image(self.params, self.cfg, x,
                                                                              dtype=self.dtype), img.to(self.device))

    def tokenize(self, txt, context_length=None):
        ids = self.tokenizer(txt, context_length or self.context_length)
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    def encode_text(self, text_input):
        tokens = torch.as_tensor(text_input, device=self.device)
        return tensor_parallel_call(self.mesh, lambda t: siglip_encode_text(self.params, self.cfg, t,
                                                                             dtype=self.dtype), tokens)
