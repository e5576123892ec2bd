"""Subject models with named activation taps, and the interventions stack that rewrites them."""

from semanticlens_tpu_torch.models.base import (
    SubjectModel,
    TapCollector,
    apply_interventions,
    has_intervention,
    interventions,
    interventions_fingerprint,
    validate_layers,
)
from semanticlens_tpu_torch.models.gemma import Gemma, Gemma2
from semanticlens_tpu_torch.models.gpt import GPT2
from semanticlens_tpu_torch.models.llama import Llama, Qwen2
from semanticlens_tpu_torch.models.phi import Phi3
from semanticlens_tpu_torch.models.resnet import ResNet
from semanticlens_tpu_torch.models.torch_adapter import TorchSubjectModel
from semanticlens_tpu_torch.models.vit import VisionTransformer

__all__ = ["GPT2", "Gemma", "Gemma2", "Llama", "Phi3", "Qwen2", "ResNet", "SubjectModel", "TapCollector", "TorchSubjectModel", "VisionTransformer", "apply_interventions",
           "has_intervention", "interventions", "interventions_fingerprint", "validate_layers"]
