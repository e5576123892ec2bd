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
from semanticlens_tpu_torch.models.classic import AlexNet, SqueezeNet
from semanticlens_tpu_torch.models.convnext import ConvNeXt
from semanticlens_tpu_torch.models.deepseek import DeepseekV2
from semanticlens_tpu_torch.models.densenet import DenseNet
from semanticlens_tpu_torch.models.efficientnet import EfficientNet, EfficientNetV2
from semanticlens_tpu_torch.models.gemma import Gemma, Gemma2
from semanticlens_tpu_torch.models.gpt import GPT2
from semanticlens_tpu_torch.models.inception import GoogLeNet, InceptionV3
from semanticlens_tpu_torch.models.llama import Llama, Qwen2
from semanticlens_tpu_torch.models.maxvit import MaxViT
from semanticlens_tpu_torch.models.mnasnet import MNASNet
from semanticlens_tpu_torch.models.mobilenet import MobileNetV2, MobileNetV3
from semanticlens_tpu_torch.models.phi import Phi3
from semanticlens_tpu_torch.models.regnet import RegNet
from semanticlens_tpu_torch.models.resnet import ResNet
from semanticlens_tpu_torch.models.shufflenet import ShuffleNetV2
from semanticlens_tpu_torch.models.swin import SwinTransformer, SwinTransformerV2
from semanticlens_tpu_torch.models.torch_adapter import TorchSubjectModel
from semanticlens_tpu_torch.models.vgg import VGG
from semanticlens_tpu_torch.models.vit import VisionTransformer

__all__ = ["AlexNet", "ConvNeXt", "DeepseekV2", "DenseNet", "EfficientNet", "EfficientNetV2", "GPT2", "Gemma", "Gemma2",
           "GoogLeNet", "InceptionV3", "Llama", "MNASNet", "MaxViT", "MobileNetV2", "MobileNetV3", "Phi3", "Qwen2",
           "RegNet", "ResNet", "ShuffleNetV2", "SqueezeNet", "SubjectModel", "SwinTransformer", "SwinTransformerV2",
           "TapCollector", "TorchSubjectModel", "VGG", "VisionTransformer", "apply_interventions", "has_intervention",
           "interventions", "interventions_fingerprint", "validate_layers"]
