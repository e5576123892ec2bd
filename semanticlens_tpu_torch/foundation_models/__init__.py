"""Vision-language foundation models (torch towers + tokenizers) and the ``create`` factory."""

import inspect

from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.foundation_models.clip import (
    CLIP_PRESETS,
    CLIPConfig,
    OpenClip,
    init_clip_params_jax_layout,
    load_openclip_state_dict,
)
from semanticlens_tpu_torch.foundation_models.dissect import (
    attention_head_directions,
    mlp_neuron_directions,
    resnet_attnpool_neuron_directions,
    resnet_attnpool_neuron_head_directions,
    residual_directions_to_embedding,
)
from semanticlens_tpu_torch.foundation_models.mobileclip import (
    ClipMobile,
    MobileCLIPConfig,
    init_mobileclip_params_jax_layout,
    load_mobileclip_state_dict,
)
from semanticlens_tpu_torch.foundation_models.siglip import (
    SigLipV2,
    init_siglip_params_jax_layout,
    load_siglip_state_dict,
)
from semanticlens_tpu_torch.foundation_models.tokenizer import ClipBpeTokenizer, HashTokenizer

__all__ = [
    "mlp_neuron_directions",
    "attention_head_directions",
    "resnet_attnpool_neuron_directions",
    "resnet_attnpool_neuron_head_directions",
    "residual_directions_to_embedding",
    "AbstractVLM",
    "OpenClip",
    "SigLipV2",
    "ClipMobile",
    "CLIPConfig",
    "CLIP_PRESETS",
    "MobileCLIPConfig",
    "init_clip_params_jax_layout",
    "init_siglip_params_jax_layout",
    "init_mobileclip_params_jax_layout",
    "load_openclip_state_dict",
    "load_siglip_state_dict",
    "load_mobileclip_state_dict",
    "ClipBpeTokenizer",
    "HashTokenizer",
    "create",
]


def _accepted(cls, kwargs: dict) -> dict:
    """The keyword arguments ``cls`` takes; the rest are dropped (the JAX classes' ``**kwargs`` sinks)."""
    names = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in kwargs.items() if k in names}


def create(name: str, **kwargs) -> AbstractVLM:
    """Name-based foundation-model factory (open_clip's ``create_model`` shape).

    Routes as the JAX package's ``create``: ``"siglip"``/``"siglip2"``/
    ``"ViT-B-16-SigLIP2"`` → :class:`SigLipV2`; ``"mobileclip"``,
    ``"mobileclip-s1"``/``"mobileclip-s2"`` → :class:`ClipMobile`; anything
    else (``"ViT-B-32"``, ``"RN50"``, …) → :class:`OpenClip`. Keyword
    arguments (``checkpoint=``, ``bpe_path=``, ``tokenizer_path=``,
    ``dtype=``, ``device=``, …) pass through; those a family does not take
    are dropped.
    """
    key = name.lower()
    if key in ("siglip", "siglip2", "vit-b-16-siglip2"):
        return SigLipV2(**_accepted(SigLipV2, kwargs))
    if key.startswith("mobileclip"):
        version = key.split("-")[-1] if "-" in key else "s1"
        return ClipMobile(version=version, **_accepted(ClipMobile, kwargs))
    return OpenClip(name, **_accepted(OpenClip, kwargs))
