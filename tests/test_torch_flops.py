"""Port parity: ``utils/flops.py`` — the analytic counters equal the JAX module's; the CUDA peak table.

The counts are integers and must be equal exactly at every ResNet depth and
the CLIP ViT widths the port runs. The peaks are NVIDIA's H100 data-sheet
dense rates, looked up by ``torch.cuda.get_device_name()``.
"""

import json

import pytest

from semanticlens_tpu.utils import flops as jflops
from semanticlens_tpu_torch.utils import flops as tflops

VITS = {"B/32": dict(patch=32), "B/16": dict(patch=16),
        "L/14": dict(patch=14, width=1024, layers=24, out_dim=768), "L/14-336": dict(image_size=336, patch=14,
                                                                                      width=1024, layers=24,
                                                                                      out_dim=768)}


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
@pytest.mark.parametrize("image_size", [224, 256])
def test_resnet_counts_equal_jax(depth, image_size):
    assert tflops.resnet_macs_per_image(depth, image_size) == jflops.resnet_macs_per_image(depth, image_size)
    assert tflops.resnet_macs_per_image(depth, image_size, 10) == jflops.resnet_macs_per_image(depth, image_size, 10)
    assert tflops.resnet_flops_per_image(depth, image_size) == jflops.resnet_flops_per_image(depth, image_size)
    assert tflops.resnet_flops_per_image(depth, image_size) == 2 * tflops.resnet_macs_per_image(depth, image_size)


@pytest.mark.parametrize("arch", list(VITS))
def test_vit_counts_equal_jax(arch):
    kw = VITS[arch]
    assert tflops.vit_macs_per_image(**kw) == jflops.vit_macs_per_image(**kw)
    assert tflops.vit_flops_per_image(**kw) == jflops.vit_flops_per_image(**kw)
    assert tflops.vit_macs_per_image(**kw, cls_token=False) == jflops.vit_macs_per_image(**kw, cls_token=False)


def test_grouped_conv_macs_equal_jax():
    for args in ((64, 128, 3, 28, 28), (128, 128, 3, 14, 14, 32), (256, 256, 1, 7, 7)):
        assert tflops._conv_macs(*args) == jflops._conv_macs(*args)


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB", "nvidia h100 80gb hbm3"])
def test_h100_sxm_peaks(name):
    assert tflops.cuda_peaks(name) == {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12,
                                       "hbm_bytes_per_s": 3.35e12}


def test_h100_pcie_peaks_and_unknown_cards():
    assert tflops.cuda_peaks("NVIDIA H100 PCIe") == {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12,
                                                     "int8": 1513e12, "hbm_bytes_per_s": 2.0e12}
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL", "TPU v5 lite", "cpu", ""):
        assert tflops.cuda_peaks(name) is None
    peaks = tflops.cuda_peaks("NVIDIA H100 80GB HBM3")
    peaks["bf16"] = 0.0  # a copy: the table itself is unchanged
    assert tflops.cuda_peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12


def test_mfu_arithmetic():
    """``imgs/s · FLOPs/img / peak`` in percent, rounded to 0.1, at the dtype's peak; None when unknown."""
    flops = 2 * (tflops.resnet_macs_per_image(50) + tflops.vit_macs_per_image(patch=32))
    card = "NVIDIA H100 80GB HBM3"
    assert tflops.mfu_pct(6000.0, flops, card) == round(100.0 * 6000.0 * flops / 989e12, 1)
    assert tflops.mfu_pct(6000.0, flops, card, dtype="int8") == round(100.0 * 6000.0 * flops / 1979e12, 1)
    assert tflops.mfu_pct(6000.0, flops, card, dtype="tf32") == round(100.0 * 6000.0 * flops / 495e12, 1)
    assert tflops.mfu_pct(6000.0, flops, "NVIDIA H100 PCIe") == round(100.0 * 6000.0 * flops / 756e12, 1)
    assert tflops.mfu_pct(6000.0, flops, "unknown") is None and tflops.mfu_pct(0.0, flops, card) is None
    json.dumps({"mfu_pct": tflops.mfu_pct(1000.0, flops, card)})
