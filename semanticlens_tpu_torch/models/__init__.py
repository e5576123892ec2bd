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
from semanticlens_tpu_torch.models.resnet import ResNet
from semanticlens_tpu_torch.models.torch_adapter import TorchSubjectModel
from semanticlens_tpu_torch.models.vit import VisionTransformer

__all__ = ["ResNet", "SubjectModel", "TapCollector", "TorchSubjectModel", "VisionTransformer", "apply_interventions",
           "has_intervention", "interventions", "interventions_fingerprint", "validate_layers"]
