"""Subject models with named activation taps."""

from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.resnet import ResNet
from semanticlens_tpu_torch.models.torch_adapter import TorchSubjectModel
from semanticlens_tpu_torch.models.vit import VisionTransformer

__all__ = ["ResNet", "SubjectModel", "TapCollector", "TorchSubjectModel", "VisionTransformer"]
