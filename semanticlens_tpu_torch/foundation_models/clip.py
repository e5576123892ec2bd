"""CLIP image towers (ViT and ModifiedResNet) and causal text tower, functional, on torch tensors.

Counterpart of ``semanticlens_tpu.foundation_models.clip``. Parameter names
mirror open_clip state dicts (``visual.conv1.weight``,
``visual.layer1.0.bn1.running_mean``,
``transformer.resblocks.0.attn.in_proj_weight`` …) in torch's layouts, so an
open_clip state dict (or a ``.safetensors``/``.npz`` file of one, the
``checkpoint=`` argument) loads as it is, and the JAX package's parameters
come across through :func:`semanticlens_tpu_torch.convert.clip_params_from_jax`.
Preprocessing (resize/crop/normalize) runs on the device.

Precision: convs and matmuls run in the tower's dtype (bf16 on the card);
layer norms, BN statistics and the final projections are kept and applied
in float32. The ModifiedResNet's attention pool runs in the tower's dtype,
as in the JAX package (PERF.md records its error against float32 on the
card).

``OpenClip(quantize="int8")`` runs the ViT tower's transformer matmuls in
int8 (:func:`quantize_clip_params`, :mod:`semanticlens_tpu_torch.ops.quant`);
its ``name`` gains ``-int8``, so concept-DB caches keep apart.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.foundation_models.common import (
    float32_or,
    init_from_specs,
    shard_tower,
    split_encode,
    tensor_parallel_call,
)
from semanticlens_tpu_torch.foundation_models.tokenizer import ClipBpeTokenizer, HashTokenizer
from semanticlens_tpu_torch.models.layers import (
    avg_pool,
    batch_norm,
    conv2d,
    gelu,
    layer_norm,
    linear,
    multi_head_attention,
    quick_gelu,
    scaled_dot_product_attention,
)
from semanticlens_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, preprocess_images
from semanticlens_tpu_torch.ops.quant import quantize_params, transformer_dense_match
from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VisionCfg:
    kind: str = "vit"  # "vit" or "resnet"
    image_size: int = 224
    # ViT
    patch_size: int = 32
    width: int = 768
    layers: int | tuple[int, int, int, int] = 12
    heads: int = 12
    # ResNet stem width (CLIP ModifiedResNet "width")
    resnet_width: int = 64


@dataclasses.dataclass(frozen=True)
class TextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    vision: VisionCfg
    text: TextCfg
    quick_gelu: bool = True  # OpenAI-pretrained towers use x·σ(1.702x)
    mean: tuple = CLIP_MEAN
    std: tuple = CLIP_STD


CLIP_PRESETS: dict[str, CLIPConfig] = {
    "RN50": CLIPConfig(
        embed_dim=1024,
        vision=VisionCfg(kind="resnet", image_size=224, layers=(3, 4, 6, 3), resnet_width=64),
        text=TextCfg(width=512, heads=8, layers=12),
    ),
    "ViT-B-32": CLIPConfig(
        embed_dim=512,
        vision=VisionCfg(patch_size=32, width=768, layers=12, heads=12),
        text=TextCfg(width=512, heads=8, layers=12),
    ),
    "ViT-B-16": CLIPConfig(
        embed_dim=512,
        vision=VisionCfg(patch_size=16, width=768, layers=12, heads=12),
        text=TextCfg(width=512, heads=8, layers=12),
    ),
    "ViT-L-14": CLIPConfig(
        embed_dim=768,
        vision=VisionCfg(patch_size=14, width=1024, layers=24, heads=16),
        text=TextCfg(width=768, heads=12, layers=12),
    ),
    "ViT-L-14-336": CLIPConfig(
        embed_dim=768,
        vision=VisionCfg(image_size=336, patch_size=14, width=1024, layers=24, heads=16),
        text=TextCfg(width=768, heads=12, layers=12),
    ),
    "RN101": CLIPConfig(
        embed_dim=512,
        vision=VisionCfg(kind="resnet", image_size=224, layers=(3, 4, 23, 3), resnet_width=64),
        text=TextCfg(width=512, heads=8, layers=12),
    ),
}


# --------------------------------------------------------------------------- #
# Transformer (shared by the image and text towers)
# --------------------------------------------------------------------------- #
def _no_tap(name, value):
    return value


def transformer_block(params, prefix, x, n_heads, *, mask=None, quick: bool = True, tap=None):
    """open_clip ResidualAttentionBlock: pre-LN attn + pre-LN MLP.

    ``tap(name, value) → value``, when given, sees (and may replace) the
    attention branch (``{prefix}.attn``), the MLP branch (``{prefix}.mlp``)
    and the block output (``{prefix}``), as in the JAX package.
    """
    tap = tap or _no_tap
    h = layer_norm(x, params[f"{prefix}.ln_1.weight"], params[f"{prefix}.ln_1.bias"])
    x = x + tap(f"{prefix}.attn", multi_head_attention(h, params, f"{prefix}.attn", n_heads, mask=mask))
    h = layer_norm(x, params[f"{prefix}.ln_2.weight"], params[f"{prefix}.ln_2.bias"])
    h = linear(h, params[f"{prefix}.mlp.c_fc.weight"], params[f"{prefix}.mlp.c_fc.bias"])
    h = quick_gelu(h) if quick else gelu(h)
    h = linear(h, params[f"{prefix}.mlp.c_proj.weight"], params[f"{prefix}.mlp.c_proj.bias"])
    return tap(prefix, x + tap(f"{prefix}.mlp", h))


def transformer_stack(params, prefix, x, layers, n_heads, *, mask=None, quick=True, tap=None):
    for i in range(layers):
        x = transformer_block(params, f"{prefix}.resblocks.{i}", x, n_heads, mask=mask, quick=quick, tap=tap)
    return x


def vit_encode_image(params, cfg: CLIPConfig, images, *, dtype=torch.float32, tap=None):
    """(B, H, W, 3) preprocessed → (B, embed_dim) float32. open_clip VisionTransformer.

    ``tap`` as in :func:`transformer_block`, on every block of ``visual.transformer``.
    """
    v = cfg.vision
    x = images.permute(0, 3, 1, 2).to(dtype)
    x = conv2d(x, params["visual.conv1.weight"], stride=v.patch_size)  # (B, width, g, g)
    x = x.flatten(2).transpose(1, 2)  # (B, g·g, width), row-major over the grid
    b, _, w = x.shape
    cls = params["visual.class_embedding"].to(dtype).expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + params["visual.positional_embedding"].to(dtype)
    x = layer_norm(x, params["visual.ln_pre.weight"], params["visual.ln_pre.bias"])
    x = transformer_stack(params, "visual.transformer", x, v.layers, v.heads, quick=cfg.quick_gelu, tap=tap)
    pooled = layer_norm(x[:, 0], params["visual.ln_post.weight"], params["visual.ln_post.bias"])
    return pooled.float() @ params["visual.proj"].float()


# --------------------------------------------------------------------------- #
# ModifiedResNet image tower (CLIP RN50 family)
# --------------------------------------------------------------------------- #
def _bn(params, prefix, x):
    return batch_norm(x, params[f"{prefix}.weight"], params[f"{prefix}.bias"],
                      params[f"{prefix}.running_mean"], params[f"{prefix}.running_var"])


def _rn_bottleneck(params, prefix, x, stride):
    """CLIP's anti-aliased Bottleneck: stride-1 convs, average pooling for striding."""
    identity = x
    out = torch.relu(_bn(params, f"{prefix}.bn1", conv2d(x, params[f"{prefix}.conv1.weight"])))
    out = torch.relu(_bn(params, f"{prefix}.bn2", conv2d(out, params[f"{prefix}.conv2.weight"], padding=1)))
    if stride > 1:
        out = avg_pool(out, window=stride, stride=stride)
    out = _bn(params, f"{prefix}.bn3", conv2d(out, params[f"{prefix}.conv3.weight"]))
    if f"{prefix}.downsample.0.weight" in params:
        if stride > 1:
            identity = avg_pool(identity, window=stride, stride=stride)
        identity = _bn(params, f"{prefix}.downsample.1", conv2d(identity, params[f"{prefix}.downsample.0.weight"]))
    return torch.relu(out + identity)


def resnet_trunk(params, cfg: CLIPConfig, images, *, dtype=torch.float32):
    """(B, H, W, 3) preprocessed → (B, C, h, w) features before the attention pool (NCHW)."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    # 3-conv stem, average-pool downsampling.
    x = torch.relu(_bn(params, "visual.bn1", conv2d(x, params["visual.conv1.weight"], stride=2, padding=1)))
    x = torch.relu(_bn(params, "visual.bn2", conv2d(x, params["visual.conv2.weight"], padding=1)))
    x = torch.relu(_bn(params, "visual.bn3", conv2d(x, params["visual.conv3.weight"], padding=1)))
    x = avg_pool(x, window=2, stride=2)
    for stage, n_blocks in enumerate(cfg.vision.layers, start=1):
        for b in range(n_blocks):
            stride = (1, 2, 2, 2)[stage - 1] if b == 0 else 1
            x = _rn_bottleneck(params, f"visual.layer{stage}.{b}", x, stride)
    return x


def attention_pool(params, x):
    """CLIP's AttentionPool2d over (B, C, h, w) features → (B, embed_dim) float32, in ``x``'s dtype.

    The mean token queries itself and the h·w spatial tokens (row-major),
    with positions added; ``C // 64`` heads (32 for RN50).
    """
    b, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)  # (B, h·w, C)
    seq = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    seq = seq + params["visual.attnpool.positional_embedding"].to(seq.dtype)
    p = "visual.attnpool"
    q = linear(seq[:, :1], params[f"{p}.q_proj.weight"], params[f"{p}.q_proj.bias"])
    k = linear(seq, params[f"{p}.k_proj.weight"], params[f"{p}.k_proj.bias"])
    v = linear(seq, params[f"{p}.v_proj.weight"], params[f"{p}.v_proj.bias"])
    pooled = scaled_dot_product_attention(q, k, v, c // 64)[:, 0]
    return linear(pooled, params[f"{p}.c_proj.weight"], params[f"{p}.c_proj.bias"]).float()


def resnet_encode_image(params, cfg: CLIPConfig, images, *, dtype=torch.float32, tap=None):
    """(B, H, W, 3) preprocessed → (B, embed_dim) float32. CLIP ModifiedResNet with attention pool.

    ``tap`` is accepted for the ViT tower's signature and, as in the JAX
    package, names no point of this tower.
    """
    return attention_pool(params, resnet_trunk(params, cfg, images, dtype=dtype))


def clip_encode_text(params, cfg: CLIPConfig, tokens, *, dtype=torch.float32, tap=None):
    """(B, T) int tokens → (B, embed_dim) float32. EOT pooling via argmax(token id).

    ``tap`` as in :func:`transformer_block`, on every block of ``transformer``.
    """
    t = cfg.text
    tokens = tokens.long()
    length = tokens.shape[1]
    x = params["token_embedding.weight"].to(dtype)[tokens]
    x = x + params["positional_embedding"].to(dtype)[:length]
    mask = torch.triu(torch.full((length, length), -torch.inf, device=x.device), diagonal=1)
    x = transformer_stack(params, "transformer", x, t.layers, t.heads, mask=mask, quick=cfg.quick_gelu, tap=tap)
    x = layer_norm(x, params["ln_final.weight"], params["ln_final.bias"])
    pooled = x[torch.arange(tokens.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return pooled.float() @ params["text_projection"].float()


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #
def _transformer_param_specs(prefix, layers, width):
    specs = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        specs += [
            (f"{p}.ln_1.weight", (width,), "ones"),
            (f"{p}.ln_1.bias", (width,), "zeros"),
            (f"{p}.attn.in_proj_weight", (width, 3 * width), "attn"),
            (f"{p}.attn.in_proj_bias", (3 * width,), "zeros"),
            (f"{p}.attn.out_proj.weight", (width, width), "proj"),
            (f"{p}.attn.out_proj.bias", (width,), "zeros"),
            (f"{p}.ln_2.weight", (width,), "ones"),
            (f"{p}.ln_2.bias", (width,), "zeros"),
            (f"{p}.mlp.c_fc.weight", (width, 4 * width), "fc"),
            (f"{p}.mlp.c_fc.bias", (4 * width,), "zeros"),
            (f"{p}.mlp.c_proj.weight", (4 * width, width), "proj"),
            (f"{p}.mlp.c_proj.bias", (width,), "zeros"),
        ]
    return specs


def _bn_specs(prefix, ch):
    return [
        (f"{prefix}.weight", (ch,), "ones"),
        (f"{prefix}.bias", (ch,), "zeros"),
        (f"{prefix}.running_mean", (ch,), "zeros"),
        (f"{prefix}.running_var", (ch,), "ones"),
    ]


def _resnet_param_specs(cfg: CLIPConfig):
    v = cfg.vision
    w = v.resnet_width
    pooled_dim = w * 8 * 4  # final channel count (2048 for RN50)
    spacial = v.image_size // 32
    specs = [
        ("visual.conv1.weight", (3, 3, 3, w // 2), "patch"),
        *_bn_specs("visual.bn1", w // 2),
        ("visual.conv2.weight", (3, 3, w // 2, w // 2), "patch"),
        *_bn_specs("visual.bn2", w // 2),
        ("visual.conv3.weight", (3, 3, w // 2, w), "patch"),
        *_bn_specs("visual.bn3", w),
    ]
    in_ch = w
    for stage, n_blocks in enumerate(v.layers, start=1):
        planes = w * (2 ** (stage - 1))
        out_ch = planes * 4
        for b in range(n_blocks):
            p = f"visual.layer{stage}.{b}"
            specs += [
                (f"{p}.conv1.weight", (1, 1, in_ch, planes), "patch"),
                *_bn_specs(f"{p}.bn1", planes),
                (f"{p}.conv2.weight", (3, 3, planes, planes), "patch"),
                *_bn_specs(f"{p}.bn2", planes),
                (f"{p}.conv3.weight", (1, 1, planes, out_ch), "patch"),
                *_bn_specs(f"{p}.bn3", out_ch),
            ]
            if b == 0:
                specs += [
                    (f"{p}.downsample.0.weight", (1, 1, in_ch, out_ch), "patch"),
                    *_bn_specs(f"{p}.downsample.1", out_ch),
                ]
            in_ch = out_ch
    specs += [
        ("visual.attnpool.positional_embedding", (spacial * spacial + 1, pooled_dim), "scaled"),
        ("visual.attnpool.q_proj.weight", (pooled_dim, pooled_dim), "proj"),
        ("visual.attnpool.q_proj.bias", (pooled_dim,), "zeros"),
        ("visual.attnpool.k_proj.weight", (pooled_dim, pooled_dim), "proj"),
        ("visual.attnpool.k_proj.bias", (pooled_dim,), "zeros"),
        ("visual.attnpool.v_proj.weight", (pooled_dim, pooled_dim), "proj"),
        ("visual.attnpool.v_proj.bias", (pooled_dim,), "zeros"),
        ("visual.attnpool.c_proj.weight", (pooled_dim, cfg.embed_dim), "proj"),
        ("visual.attnpool.c_proj.bias", (cfg.embed_dim,), "zeros"),
    ]
    return specs


def clip_param_specs(cfg: CLIPConfig):
    """All (name, shape, init-kind) of a CLIP under ``cfg``, shapes in the JAX package's layout."""
    v, t = cfg.vision, cfg.text
    if v.kind == "vit":
        grid = v.image_size // v.patch_size
        specs = [
            ("visual.conv1.weight", (v.patch_size, v.patch_size, 3, v.width), "patch"),
            ("visual.class_embedding", (v.width,), "scaled"),
            ("visual.positional_embedding", (grid * grid + 1, v.width), "scaled"),
            ("visual.ln_pre.weight", (v.width,), "ones"),
            ("visual.ln_pre.bias", (v.width,), "zeros"),
            ("visual.ln_post.weight", (v.width,), "ones"),
            ("visual.ln_post.bias", (v.width,), "zeros"),
            ("visual.proj", (v.width, cfg.embed_dim), "scaled"),
        ]
        specs += _transformer_param_specs("visual.transformer", v.layers, v.width)
    else:
        specs = _resnet_param_specs(cfg)
    specs += [
        ("token_embedding.weight", (t.vocab_size, t.width), "embed"),
        ("positional_embedding", (t.context_length, t.width), "scaled"),
        ("ln_final.weight", (t.width,), "ones"),
        ("ln_final.bias", (t.width,), "zeros"),
        ("text_projection", (t.width, cfg.embed_dim), "scaled"),
        ("logit_scale", (), "logit_scale"),
    ]
    specs += _transformer_param_specs("transformer", t.layers, t.width)
    return specs


def init_clip_params_jax_layout(seed: int, cfg: CLIPConfig) -> dict[str, np.ndarray]:
    """Random numpy weights in the JAX package's layout (its init scheme, numpy streams)."""
    return init_from_specs(seed, clip_param_specs(cfg))


def _float32_param(name: str) -> bool:
    """Tensors the towers use in float32: norms (layer and batch) and the final projections."""
    return (".ln_" in name or name.startswith("ln_") or ".bn" in name or ".downsample.1." in name
            or name in ("visual.proj", "text_projection", "logit_scale"))


def torch_shape(name: str, shape: tuple) -> tuple:
    """A spec's JAX-layout shape in torch's layout: convs HWIO → OIHW, linear weights (in, out) → (out, in).

    Embedding tables and the open_clip projections (not named ``…weight``)
    keep their layout.
    """
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    if len(shape) == 2 and name.endswith("weight") and "embedding" not in name:
        return tuple(shape[::-1])
    return tuple(shape)


def load_openclip_state_dict(cfg: CLIPConfig, state_dict: Mapping) -> dict[str, torch.Tensor]:
    """An open_clip/OpenAI CLIP torch state dict, checked: float32 CPU tensors in torch's layout.

    Counterpart of the JAX package's ``load_openclip_state_dict``, which
    relayouts into XLA's layouts; the port keeps torch's (conv OIHW, linear
    (out, in)). Every name of ``clip_param_specs(cfg)`` must be there
    (``KeyError`` otherwise) with its torch shape (``ValueError``); other
    entries (``attn_mask``, ``input_resolution`` …) are ignored.
    """
    out = {}
    for name, shape, _ in clip_param_specs(cfg):
        t = torch.as_tensor(state_dict[name]).detach().to("cpu", torch.float32)
        expected = torch_shape(name, shape)
        if tuple(t.shape) != expected:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != expected {expected}")
        out[name] = t
    return out


def quantize_clip_params(params, cfg: CLIPConfig, *, include_text: bool = False):
    """The ViT tower's transformer matmuls int8-quantized (:mod:`semanticlens_tpu_torch.ops.quant`).

    Their weights become per-out-channel int8 ``QuantizedTensor`` s, which
    ``models.layers.linear`` runs on the int8 path with per-row activation
    scales. LayerNorms, biases, embeddings, the patch conv and the final
    projection stay float. A ModifiedResNet tower (its FLOPs are convs) is
    left float, with a warning. ``include_text`` quantizes the text
    tower's blocks too.
    """
    if cfg.vision.kind != "vit":
        logger.warning("int8 quantization targets ViT towers; %s vision tower left in float", cfg.vision.kind)
    return quantize_params(params, clip_int8_match(cfg, include_text=include_text))


def clip_int8_match(cfg: CLIPConfig, *, include_text: bool = False):
    """The keys :func:`quantize_clip_params` quantizes: the ViT tower's (not an RN tower's) and the text
    tower's (``include_text``) transformer matmul weights."""
    vit = cfg.vision.kind == "vit"
    image, text = transformer_dense_match("visual.transformer."), transformer_dense_match("transformer.")
    return lambda key: (vit and image(key)) or (include_text and text(key))


def check_quantize(quantize):
    """``quantize`` must be ``None`` or ``"int8"`` (the JAX towers' message otherwise)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"Unsupported quantize={quantize!r}; only 'int8'")


def place_params(state_dict: Mapping, float32_param, dtype, device) -> dict[str, torch.Tensor]:
    """Checked float32 CPU tensors placed for a tower: ``float32_param(name)`` ones stay float32, the rest are
    stored once in the compute dtype the towers cast them to on use; convs channels_last."""
    out = {}
    for name, t in state_dict.items():
        t = t.to(device, torch.float32 if float32_param(name) else dtype)
        out[name] = t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t
    return out


def _load_checkpoint(checkpoint) -> Mapping:
    """A state dict, or a path to one: ``.safetensors`` (the port's reader) or ``.npz``."""
    if not isinstance(checkpoint, (str, bytes, Path)) and not hasattr(checkpoint, "__fspath__"):
        return checkpoint
    from semanticlens_tpu_torch.utils import safetensors_io

    path = str(checkpoint)
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(np.array(data[k])) for k in data.files}
    raise ValueError(f"Unsupported checkpoint file type: {path}")


# --------------------------------------------------------------------------- #
# User-facing foundation-model class
# --------------------------------------------------------------------------- #
class OpenClip(AbstractVLM):
    """CLIP foundation model with the reference's ``OpenClip`` API.

    Parameters
    ----------
    url : preset name (``"ViT-B-32"``, …) or an open_clip-style id — a
        leading ``hf-hub:`` or trailing pretraining tag is stripped.
    cfg : optional tower configuration that replaces the preset's (a
        cut-down tower, e.g. for tests); ``url`` still names the model.
    params : optional open_clip state dict (torch layout).
    checkpoint : optional open_clip state dict or path to one
        (``.safetensors`` or ``.npz``), as in the JAX package.
    jax_params : optional parameter dict in the JAX package's layout.
    bpe_path : CLIP BPE merges file for real tokenization; without it one
        is looked up (``assets.find_clip_bpe``: next to the checkpoint file,
        ``$SEMANTICLENS_ASSETS``, the HF cache), else a HashTokenizer
        fallback is used (testing only).
    dtype : tower compute dtype.
    device : ``None`` → the CUDA card (raises without one), or ``"cpu"``.
    seed : numpy seed of the random weights used when none are given.
    mesh : optional ``DeviceMesh``. With a ``"data"`` axis, ``encode_image``
        called on every rank with the same batch encodes this rank's rows
        and all-gathers them (``encode_image_local`` encodes the rows it is
        given, for a batch that is already this rank's); with a ``"model"``
        axis the parameters are tensor-sharded
        (``parallel.clip_param_specs_2d``) and both towers run under
        ``implicit_replication``.
    quantize : ``None`` or ``"int8"``: the ViT image tower's transformer
        matmuls run int8 (:func:`quantize_clip_params`), quantized from the
        float32 weights after loading and mesh placement; the int8 weights
        are plain tensors, whole on every rank. ``name`` gains ``-int8``.
    """

    def __init__(
        self,
        url: str = "ViT-B-32",
        *,
        params=None,
        checkpoint=None,
        jax_params=None,
        bpe_path=None,
        dtype=torch.bfloat16,
        device=None,
        seed: int = 0,
        quick_gelu: bool | None = None,
        cfg: CLIPConfig | None = None,
        mesh=None,
        quantize: str | None = None,
    ):
        check_quantize(quantize)
        self.url = url
        preset = _resolve_preset(url)
        if preset is None:
            raise ValueError(f"Unknown CLIP model '{url}'. Presets: {sorted(CLIP_PRESETS)}")
        self.cfg = cfg or CLIP_PRESETS[preset]
        if quick_gelu is None:
            quick_gelu = not any(tag in url for tag in ("laion", "datacomp", "dfn", "metaclip"))
            if "quickgelu" in url:
                quick_gelu = True
        if quick_gelu != self.cfg.quick_gelu:
            self.cfg = dataclasses.replace(self.cfg, quick_gelu=quick_gelu)
        self.preset = preset
        self.dtype = dtype
        self.device = resolve_device(device)
        self.name = f"OpenClip({url})"

        if params is None and checkpoint is not None:
            params = _load_checkpoint(checkpoint)
        if params is None:
            if jax_params is None:
                logger.warning("No weights provided for %s — using random init.", url)
                jax_params = init_clip_params_jax_layout(seed, self.cfg)
            params = convert.clip_params_from_jax(jax_params)
        self.quantize = quantize
        float32 = float32_or(_float32_param, clip_int8_match(self.cfg) if quantize else None)
        with span("fm.load"):
            self.params = place_params(load_openclip_state_dict(self.cfg, params), float32, dtype, self.device)
        from semanticlens_tpu_torch.parallel.tensor_parallel import clip_param_specs_2d

        self.mesh = mesh
        self.params = shard_tower(self.params, mesh, clip_param_specs_2d, self.cfg)
        if quantize:
            self.params = quantize_clip_params(self.params, self.cfg)
            self.name = f"{self.name}-int8"  # concept-DB caches key on the name

        if bpe_path is None:
            from semanticlens_tpu_torch.foundation_models.assets import find_clip_bpe

            bpe_path = find_clip_bpe(near=checkpoint if isinstance(checkpoint, (str, Path)) else None)
        if bpe_path is not None:
            self.tokenizer = ClipBpeTokenizer(bpe_path, self.cfg.text.context_length)
        else:
            self.tokenizer = HashTokenizer(self.cfg.text.vocab_size, self.cfg.text.context_length)

    @property
    def context_length(self):
        return self.cfg.text.context_length

    @property
    def embed_dim(self):
        return self.cfg.embed_dim

    def __repr__(self):
        quant = f", quantize='{self.quantize}'" if self.quantize else ""
        return f"{self.__class__.__name__}(url='{self.url}', preset={self.preset}{quant})"

    def preprocess(self, img):
        """Images → normalized (B, S, S, 3) on the device.

        Takes a tensor batch (passed through as it is), a numpy batch or
        image (uint8 0–255 or float; floats in 0–255 are rescaled), or a list
        of images (tensors or arrays): a list of one size is stacked, a
        mixed-size list is resized per image first, on the device (PIL's
        bicubic shorter-side resize and centre crop, as the JAX package does
        on the host).
        """
        size = self.cfg.vision.image_size
        x = _to_image_batch(img, size, self.device)
        return preprocess_images(x, size=size, crop=size, mean=self.cfg.mean, std=self.cfg.std)

    def encode_image(self, img):
        return split_encode(self.mesh, self.encode_image_local, img)

    def encode_image_local(self, img):
        """Embeddings of exactly the rows given (no split over a data mesh)."""
        encode = vit_encode_image if self.cfg.vision.kind == "vit" else resnet_encode_image
        return tensor_parallel_call(self.mesh, lambda x: encode(self.params, self.cfg, x, dtype=self.dtype),
                                    img.to(self.device))

    def tokenize(self, txt, context_length=None):
        ids = self.tokenizer(txt, context_length or self.context_length)
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def encode_text(self, text_input):
        tokens = torch.as_tensor(text_input, device=self.device)
        return tensor_parallel_call(self.mesh, lambda t: clip_encode_text(self.params, self.cfg, t, dtype=self.dtype),
                                    tokens)


def _resolve_preset(url: str) -> str | None:
    if url in CLIP_PRESETS:
        return url
    stripped = url.split(":")[-1].split("/")[-1]  # hf-hub:org/name → name
    # Preset followed only by pretraining/activation tags; architecture
    # suffixes (ViT-B-16-plus-240 …) are different towers and do not match.
    harmless = ("quickgelu", "laion", "openai", "datacomp", "dfn", "metaclip", "commonpool", "2b", "400m", "80m")
    best = None
    for preset in CLIP_PRESETS:
        if stripped == preset:
            return preset
        if stripped.startswith(preset + "-"):
            tokens = stripped[len(preset) + 1 :].lower().split("-")
            if all(any(t.startswith(h) or h.startswith(t) for h in harmless) for t in tokens if t):
                if best is None or len(preset) > len(best):
                    best = preset
    return best


def _to_image_batch(img, target_size: int, device) -> torch.Tensor:
    """Tensor / array / list of either → (B, H, W, C) on ``device``; tensor batches pass through.

    The JAX package's ``_to_image_batch``: a mixed-size list is resized per
    image to ``target_size`` (floats are first cast to uint8 as the JAX
    package's ``_host_resize_crop`` does) and stacked; host float batches
    with values in 0–255 are rescaled to 0–1, and a float batch that looks
    mean/std-normalized is refused.
    """
    if isinstance(img, torch.Tensor):
        x = img.to(device)
        return x if x.ndim == 4 else x[None]
    if isinstance(img, (list, tuple)):
        from semanticlens_tpu_torch.data.image_folder import resize_crop

        items = [(i if isinstance(i, torch.Tensor) else torch.as_tensor(np.asarray(i))).to(device) for i in img]
        if len({tuple(i.shape) for i in items}) > 1:
            items = [resize_crop(_to_uint8(i), target_size) for i in items]
        x = torch.stack(items)
    else:
        x = torch.as_tensor(np.asarray(img)).to(device)
        if x.ndim == 3:
            x = x[None]
    if x.is_floating_point() and x.numel():
        hi = float(x.max())
        if hi > 2.0:
            lo = float(x.min())
            if hi < 16.0 and lo < -0.5:
                raise ValueError(
                    "float image batch looks already mean/std-normalized "
                    f"(min {lo:.3g}, max {hi:.3g}); pass raw images (uint8, 0-1 or "
                    "0-255 float) - normalization happens on device."
                )
            x = (x / 255.0).to(torch.float32)
    return x


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 stays; floats in 0–1 scale by 255, then clip to 0–255 and truncate."""
    if x.dtype == torch.uint8:
        return x
    return torch.clamp(x * 255.0 if float(x.max()) <= 2.0 else x, 0, 255).to(torch.uint8)
