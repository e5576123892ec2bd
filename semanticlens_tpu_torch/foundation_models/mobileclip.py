"""MobileCLIP foundation model (``ClipMobile``), functional, on torch tensors.

Counterpart of ``semanticlens_tpu.foundation_models.mobileclip`` (the
reference's ``ClipMobile``, a pin of open_clip's MobileCLIP-S1/S2). The image
tower is a FastViT/MCi-style hybrid in its inference (reparameterized) form:
conv stem → RepMixer stages (depthwise token mixing + ConvFFN) → attention
stage → GAP → projection. The text tower is the CLIP text transformer
(:func:`~semanticlens_tpu_torch.foundation_models.clip.clip_encode_text`)
with exact GELU.

Layouts: activations NCHW (channels_last memory), conv weights OIHW
(depthwise (C, 1, k, k)), linear weights (out, in). The attention stage
flattens tokens in the JAX package's row-major (h, w) order. Images are
256×256 and normalized by plain 0–1 scaling (mean 0, std 1); GAP and the
head projection run in float32, as in the JAX package.

:func:`load_mobileclip_state_dict` takes torch state dicts in the port's own
layout, in deployed form (``reparam_conv``) and in raw train form
(MobileOne ``rbr_*`` branch sets, RepMixer ``mixer``/``norm`` pairs,
conv+BN pairs), folding the branches with :mod:`.reparam`.

``mesh=`` splits ``encode_image`` over a data mesh, as in the JAX package
(the convolutional tower has no tensor-parallel placements there either).
``quantize="int8"`` runs the pointwise convs and the attention stage's
denses in int8 (:func:`quantize_mobileclip_params`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Mapping

import numpy as np
import torch

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.foundation_models.clip import (
    TextCfg,
    _load_checkpoint,
    _to_image_batch,
    _transformer_param_specs,
    check_quantize,
    clip_encode_text,
    place_params,
    torch_shape,
)
from semanticlens_tpu_torch.foundation_models.common import float32_or, init_from_specs, split_encode
from semanticlens_tpu_torch.foundation_models.tokenizer import ClipBpeTokenizer, HashTokenizer
from semanticlens_tpu_torch.models.layers import conv2d, gelu, layer_norm, linear, scaled_dot_product_attention
from semanticlens_tpu_torch.ops.preprocess import preprocess_images
from semanticlens_tpu_torch.ops.quant import quantize_params, transformer_dense_match
from semanticlens_tpu_torch.utils.device import resolve_device
from semanticlens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MobileCLIPConfig:
    embed_dim: int = 512
    image_size: int = 256
    depths: tuple = (2, 6, 10, 2)
    dims: tuple = (64, 128, 256, 512)
    mixers: tuple = ("rep", "rep", "rep", "attn")
    attn_heads: int = 8
    text: TextCfg = TextCfg(width=512, heads=8, layers=12)
    # Normalization: MobileCLIP uses plain 0-1 scaling (no mean/std shift).
    mean: tuple = (0.0, 0.0, 0.0)
    std: tuple = (1.0, 1.0, 1.0)


MOBILECLIP_PRESETS = {
    "MobileCLIP-S1": MobileCLIPConfig(depths=(2, 6, 10, 2), dims=(64, 128, 256, 512)),
    "MobileCLIP-S2": MobileCLIPConfig(depths=(4, 12, 24, 4), dims=(80, 160, 320, 640)),
}


# --------------------------------------------------------------------------- #
# Inference-form blocks (NCHW)
# --------------------------------------------------------------------------- #
def _dw_conv(x, w, b, *, stride=1, padding=1):
    """Depthwise conv with bias: w is (C, 1, k, k), groups=C."""
    return conv2d(x, w, b, stride=stride, padding=padding, groups=x.shape[1])


def _conv_ffn(params, prefix, x):
    """ConvFFN (fused): 7×7 depthwise + 1×1 expand + GELU + 1×1 project, residual."""
    h = _dw_conv(x, params[f"{prefix}.dw.weight"], params[f"{prefix}.dw.bias"], padding=3)
    h = gelu(conv2d(h, params[f"{prefix}.fc1.weight"], params[f"{prefix}.fc1.bias"]))
    return x + conv2d(h, params[f"{prefix}.fc2.weight"], params[f"{prefix}.fc2.bias"])


def _rep_mixer_block(params, prefix, x):
    """RepMixer (fused): residual depthwise 3×3 token mixing, then ConvFFN."""
    x = x + _dw_conv(x, params[f"{prefix}.mixer.weight"], params[f"{prefix}.mixer.bias"], padding=1)
    return _conv_ffn(params, f"{prefix}.ffn", x)


def _attention_block(params, prefix, x, heads):
    """MHSA over the (h, w) tokens in row-major order + ConvFFN (FastViT attention stage)."""
    b, c, h_, w_ = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(b, h_ * w_, c)
    normed = layer_norm(tokens, params[f"{prefix}.norm.weight"], params[f"{prefix}.norm.bias"])
    q, k, v = linear(normed, params[f"{prefix}.attn.qkv.weight"], params[f"{prefix}.attn.qkv.bias"]).chunk(3, dim=-1)
    attn = scaled_dot_product_attention(q, k, v, heads)
    attn = linear(attn, params[f"{prefix}.attn.proj.weight"], params[f"{prefix}.attn.proj.bias"])
    x = x + attn.reshape(b, h_, w_, c).permute(0, 3, 1, 2)
    return _conv_ffn(params, f"{prefix}.ffn", x)


def _downsample(params, prefix, x):
    """Fused patch embed between stages: 7×7 depthwise stride 2 + 1×1 pointwise."""
    h = _dw_conv(x, params[f"{prefix}.dw.weight"], params[f"{prefix}.dw.bias"], stride=2, padding=3)
    return conv2d(h, params[f"{prefix}.pw.weight"], params[f"{prefix}.pw.bias"])


def mobileclip_encode_image(params, cfg: MobileCLIPConfig, images, *, dtype=torch.float32):
    """(B, H, W, 3) preprocessed → (B, embed_dim) float32."""
    x = images.permute(0, 3, 1, 2).to(dtype)
    # Fused stem: /4 resolution.
    x = gelu(conv2d(x, params["visual.stem.0.weight"], params["visual.stem.0.bias"], stride=2, padding=1))
    x = gelu(conv2d(x, params["visual.stem.1.weight"], params["visual.stem.1.bias"], stride=2, padding=1))
    for stage, (depth, mixer) in enumerate(zip(cfg.depths, cfg.mixers)):
        if stage > 0:
            x = _downsample(params, f"visual.stage{stage}.downsample", x)
        for b in range(depth):
            prefix = f"visual.stage{stage}.blocks.{b}"
            if mixer == "rep":
                x = _rep_mixer_block(params, prefix, x)
            else:
                x = _attention_block(params, prefix, x, cfg.attn_heads)
    pooled = torch.mean(x.float(), dim=(2, 3))  # GAP
    return pooled @ params["visual.head.proj"].float()


# --------------------------------------------------------------------------- #
# Parameter specs / init
# --------------------------------------------------------------------------- #
def _ffn_specs(prefix, c):
    hidden = 4 * c
    return [
        (f"{prefix}.dw.weight", (7, 7, 1, c), "dw"),
        (f"{prefix}.dw.bias", (c,), "zeros"),
        (f"{prefix}.fc1.weight", (1, 1, c, hidden), "conv"),
        (f"{prefix}.fc1.bias", (hidden,), "zeros"),
        (f"{prefix}.fc2.weight", (1, 1, hidden, c), "conv"),
        (f"{prefix}.fc2.bias", (c,), "zeros"),
    ]


def mobileclip_param_specs(cfg: MobileCLIPConfig):
    """All (name, shape, init-kind) of a MobileCLIP under ``cfg``, shapes in the JAX package's layout."""
    specs = [
        ("visual.stem.0.weight", (3, 3, 3, cfg.dims[0] // 2), "conv"),
        ("visual.stem.0.bias", (cfg.dims[0] // 2,), "zeros"),
        ("visual.stem.1.weight", (3, 3, cfg.dims[0] // 2, cfg.dims[0]), "conv"),
        ("visual.stem.1.bias", (cfg.dims[0],), "zeros"),
    ]
    for stage, (depth, mixer) in enumerate(zip(cfg.depths, cfg.mixers)):
        c = cfg.dims[stage]
        if stage > 0:
            specs += [
                (f"visual.stage{stage}.downsample.dw.weight", (7, 7, 1, cfg.dims[stage - 1]), "dw"),
                (f"visual.stage{stage}.downsample.dw.bias", (cfg.dims[stage - 1],), "zeros"),
                (f"visual.stage{stage}.downsample.pw.weight", (1, 1, cfg.dims[stage - 1], c), "conv"),
                (f"visual.stage{stage}.downsample.pw.bias", (c,), "zeros"),
            ]
        for b in range(depth):
            prefix = f"visual.stage{stage}.blocks.{b}"
            if mixer == "rep":
                specs += [
                    (f"{prefix}.mixer.weight", (3, 3, 1, c), "dw"),
                    (f"{prefix}.mixer.bias", (c,), "zeros"),
                ]
            else:
                specs += [
                    (f"{prefix}.norm.weight", (c,), "ones"),
                    (f"{prefix}.norm.bias", (c,), "zeros"),
                    (f"{prefix}.attn.qkv.weight", (c, 3 * c), "attn"),
                    (f"{prefix}.attn.qkv.bias", (3 * c,), "zeros"),
                    (f"{prefix}.attn.proj.weight", (c, c), "proj"),
                    (f"{prefix}.attn.proj.bias", (c,), "zeros"),
                ]
            specs += _ffn_specs(f"{prefix}.ffn", c)
    specs += [("visual.head.proj", (cfg.dims[-1], cfg.embed_dim), "proj")]

    t = cfg.text
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


def init_mobileclip_params_jax_layout(seed: int, cfg: MobileCLIPConfig) -> dict[str, np.ndarray]:
    """Random numpy weights in the JAX package's layout (its init scheme, numpy streams)."""
    return init_from_specs(seed, mobileclip_param_specs(cfg))


# --------------------------------------------------------------------------- #
# Checkpoint conversion (own layout, deployed or raw train form)
# --------------------------------------------------------------------------- #
def load_mobileclip_state_dict(cfg: MobileCLIPConfig, state_dict: Mapping, *, eps: float = 1e-5
                               ) -> dict[str, torch.Tensor]:
    """A torch MobileCLIP state dict → the fused tower's float32 CPU tensors in torch's layout.

    Counterpart of the JAX package's ``load_mobileclip_state_dict`` (which
    then relayouts into XLA's layouts). Three source forms per conv site, in
    priority order:

    1. already in this layout (our own exports);
    2. deployed/reparameterized (``<site>.reparam_conv.weight``);
    3. raw train form: MobileOne-style branch sets (``rbr_conv.{i}`` /
       ``rbr_scale`` / ``rbr_skip`` conv+BN branches), RepMixer pairs
       (``mixer``/``norm``) and plain ``<site>.conv`` + ``<site>.bn`` pairs,
       folded in float64 with :mod:`.reparam`.

    Every name of ``mobileclip_param_specs(cfg)`` must be provided
    (``KeyError`` otherwise) with its torch shape (``ValueError``).
    """
    from semanticlens_tpu_torch.foundation_models.reparam import fuse_conv_bn, fuse_mobileone_block, fuse_repmixer

    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v) for k, v in state_dict.items()}

    def fuse_site(prefix: str, hwio_shape):
        k, in_ch, c = hwio_shape[0], hwio_shape[2], hwio_shape[3]
        groups = c if in_ch == 1 else 1
        if prefix.endswith(".mixer"):
            w, b = fuse_repmixer(sd, prefix, channels=c, k=k, eps=eps)
        elif f"{prefix}.conv.weight" in sd and f"{prefix}.bn.weight" in sd:
            w, b = fuse_conv_bn(
                sd[f"{prefix}.conv.weight"],
                sd[f"{prefix}.bn.weight"],
                sd[f"{prefix}.bn.bias"],
                sd[f"{prefix}.bn.running_mean"],
                sd[f"{prefix}.bn.running_var"],
                bias=sd.get(f"{prefix}.conv.bias"),
                eps=eps,
            )
        else:
            w, b = fuse_mobileone_block(sd, prefix, channels=c, groups=groups, k=k, eps=eps)
        sd[f"{prefix}.weight"] = w
        sd[f"{prefix}.bias"] = b

    out = {}
    for name, shape, _kind in mobileclip_param_specs(cfg):
        if name not in sd and name.endswith(".weight") and len(shape) == 4:
            fuse_site(name[: -len(".weight")], shape)
        if name not in sd:
            raise KeyError(f"checkpoint provides no source for '{name}'")
        arr = np.asarray(sd[name], np.float64)
        expected = torch_shape(name, shape)  # depthwise convs: (C, 1, k, k)
        if arr.shape != expected:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != expected {expected}")
        out[name] = torch.from_numpy(arr.astype(np.float32))
    return out


#: Image-tower weight suffixes worth int8: the 1×1 pointwise convs (ConvFFN
#: expand and project, the stage downsample's projection) and the attention
#: stage's dense pair carry the FLOPs. Depthwise convs (``.dw``, ``.mixer``:
#: one input channel per group, nothing for an int8 GEMM to batch), the stem
#: (raw-pixel statistics) and the head projection stay float.
_MOBILECLIP_QUANT_SUFFIXES = (
    ".fc1.weight",
    ".fc2.weight",
    ".attn.qkv.weight",
    ".attn.proj.weight",
    ".downsample.pw.weight",
)


def mobileclip_int8_match(*, include_text: bool = False):
    """The keys :func:`quantize_mobileclip_params` quantizes."""
    text = transformer_dense_match("transformer.")
    return lambda key: ((key.startswith("visual.") and key.endswith(_MOBILECLIP_QUANT_SUFFIXES))
                        or (include_text and text(key)))


def quantize_mobileclip_params(params, *, include_text: bool = False):
    """The FastViT tower's pointwise convs and attention denses int8-quantized, after reparameter folding.

    The W8A8 scheme of :func:`~semanticlens_tpu_torch.foundation_models.clip.quantize_clip_params`
    (:mod:`semanticlens_tpu_torch.ops.quant`): the pointwise convs run
    ``int8_conv`` (per-sample activation scales), the denses
    ``int8_matmul`` (per-row). ``include_text`` quantizes the CLIP-style
    text tower's blocks too.
    """
    return quantize_params(params, mobileclip_int8_match(include_text=include_text))


def _float32_param(name: str) -> bool:
    """Tensors the towers use in float32: the layer norms and the final projections."""
    return (".norm." in name or ".ln_" in name or name.startswith("ln_")
            or name in ("visual.head.proj", "text_projection", "logit_scale"))


class ClipMobile(AbstractVLM):
    """MobileCLIP foundation model with the reference's ``ClipMobile`` API.

    Parameters
    ----------
    version : "s1" or "s2".
    params : optional torch state dict in any form
        :func:`load_mobileclip_state_dict` takes.
    checkpoint : optional state dict or path to one (``.safetensors`` or
        ``.npz``).
    jax_params : optional parameter dict in the JAX package's layout.
    bpe_path : CLIP BPE merges file; without it one is looked up
        (``assets.find_clip_bpe``: ``$SEMANTICLENS_ASSETS``, the HF cache),
        else a HashTokenizer fallback is used.
    dtype / device / seed / cfg : as in
        :class:`~semanticlens_tpu_torch.foundation_models.clip.OpenClip`.
    mesh : optional ``DeviceMesh``: ``encode_image`` called on every rank
        with the same batch encodes this rank's rows of the ``"data"`` axis
        and all-gathers them (``encode_image_local`` encodes the rows given).
    quantize : ``None`` or ``"int8"``: the image tower's pointwise convs
        and attention denses run int8 (:func:`quantize_mobileclip_params`),
        quantized from the float32 weights after loading and reparameter
        folding; ``name`` gains ``-int8``.
    """

    URLs = dict(s1="MobileCLIP-S1", s2="MobileCLIP-S2")

    def __init__(
        self,
        version: str = "s1",
        *,
        params=None,
        checkpoint=None,
        jax_params=None,
        bpe_path=None,
        dtype=torch.bfloat16,
        device=None,
        seed: int = 0,
        mesh=None,
        quantize: str | None = None,
        cfg: MobileCLIPConfig | None = None,
    ):
        if version not in self.URLs:
            raise ValueError(f"Unknown MobileCLIP version '{version}'; expected {sorted(self.URLs)}")
        from semanticlens_tpu_torch.core.mesh import check_mesh

        self.mesh = check_mesh(mesh)
        check_quantize(quantize)
        self.url = self.URLs[version]
        self.cfg = cfg or MOBILECLIP_PRESETS[self.url]
        self.dtype = dtype
        self.device = resolve_device(device)
        self.name = f"ClipMobile({self.url})"

        if params is None and checkpoint is not None:
            params = _load_checkpoint(checkpoint)
        if params is None:
            if jax_params is None:
                logger.warning("No weights provided for %s — using random init.", self.url)
                jax_params = init_mobileclip_params_jax_layout(seed, self.cfg)
            params = convert.mobileclip_params_from_jax(jax_params)
        self.quantize = quantize
        float32 = float32_or(_float32_param, mobileclip_int8_match() if quantize else None)
        with span("fm.load"):
            self.params = place_params(load_mobileclip_state_dict(self.cfg, params), float32, dtype, self.device)
        if quantize:
            self.params = quantize_mobileclip_params(self.params)
            self.name = f"{self.name}-int8"  # concept-DB caches key on the name

        if bpe_path is None:
            from semanticlens_tpu_torch.foundation_models.assets import find_clip_bpe

            bpe_path = find_clip_bpe()  # as the JAX package: not next to the checkpoint
        if bpe_path is not None:
            self.tokenizer = ClipBpeTokenizer(bpe_path, self.cfg.text.context_length)
        else:
            self.tokenizer = HashTokenizer(self.cfg.text.vocab_size, self.cfg.text.context_length)
        # MobileCLIP S1/S2 use the base CLIP text encoder with exact GELU.
        self._text_cfg = _TextOnly(self.cfg)

    @property
    def context_length(self):
        return self.cfg.text.context_length

    @property
    def embed_dim(self):
        return self.cfg.embed_dim

    def __repr__(self):
        quant = f", quantize='{self.quantize}'" if self.quantize else ""
        return f"{self.__class__.__name__}(url='{self.url}'{quant})"

    def preprocess(self, img):
        """Images → (B, 256, 256, 3) scaled to 0–1 on the device (as ``OpenClip.preprocess``)."""
        size = self.cfg.image_size
        x = _to_image_batch(img, size, self.device)
        return preprocess_images(x, size=size, crop=size, mean=self.cfg.mean, std=self.cfg.std)

    def encode_image(self, img):
        return split_encode(self.mesh, self.encode_image_local, img)

    def encode_image_local(self, img):
        """Embeddings of exactly the rows given (no split over a data mesh)."""
        return mobileclip_encode_image(self.params, self.cfg, img.to(self.device), dtype=self.dtype)

    def tokenize(self, txt, context_length=None):
        ids = self.tokenizer(txt, context_length or self.context_length)
        return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)

    def encode_text(self, text_input):
        tokens = torch.as_tensor(text_input, device=self.device)
        return clip_encode_text(self.params, self._text_cfg, tokens, dtype=self.dtype)


class _TextOnly:
    """Adapter giving clip_encode_text the (text, quick_gelu) view it needs."""

    def __init__(self, cfg: MobileCLIPConfig):
        self.text = cfg.text
        self.quick_gelu = False
