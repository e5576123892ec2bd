"""Analytic FLOP counts and CUDA peak rates, for MFU and roofline accounting.

Counterpart of ``semanticlens_tpu.utils.flops``. The counters are the JAX
module's: one multiply-accumulate is **2 FLOPs** (the convention of
hardware peaks), while most model-zoo tables ("ResNet-50 = 4.1 GFLOPs",
"ViT-B/32 = 4.4 GFLOPs") give multiply-adds (MACs); both are exposed
(``*_macs_per_image`` / ``*_flops_per_image``) so the two cannot be mixed
silently. Counts cover the matmuls and convs only (BN, activations,
pooling, softmax and the top-k update are bandwidth-bound and under 1% of
the FLOPs).

The peaks are NVIDIA's data-sheet dense rates (no sparsity), looked up by
``torch.cuda.get_device_name()``: :func:`cuda_peaks`. A card set below its
full power limit runs under them, so a share of peak is stated beside the
card's power limit.
"""

from __future__ import annotations

_MAC = 2  # FLOPs per multiply-accumulate


def _conv_macs(cin: int, cout: int, k: int, hout: int, wout: int, groups: int = 1) -> int:
    return k * k * (cin // groups) * cout * hout * wout


def resnet_macs_per_image(depth: int = 50, image_size: int = 224, num_classes: int = 1000) -> int:
    """Multiply-accumulates of one ResNet forward (torchvision layout), ~4.1 GMac for depth 50 at 224."""
    stage_blocks = {
        18: (2, 2, 2, 2),
        34: (3, 4, 6, 3),
        50: (3, 4, 6, 3),
        101: (3, 4, 23, 3),
        152: (3, 8, 36, 3),
    }[depth]
    bottleneck = depth >= 50
    expansion = 4 if bottleneck else 1

    s = image_size // 2  # stem conv stride 2
    macs = _conv_macs(3, 64, 7, s, s)
    s //= 2  # maxpool stride 2
    cin = 64
    for stage, n_blocks in enumerate(stage_blocks):
        width = 64 * (2**stage)
        cout = width * expansion
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            s_in, s_out = s, s // stride
            if bottleneck:
                # 1x1 (stride 1, input spatial) -> 3x3 (stride) -> 1x1
                macs += _conv_macs(cin, width, 1, s_in, s_in)
                macs += _conv_macs(width, width, 3, s_out, s_out)
                macs += _conv_macs(width, cout, 1, s_out, s_out)
            else:
                macs += _conv_macs(cin, width, 3, s_out, s_out)
                macs += _conv_macs(width, width, 3, s_out, s_out)
            if stride != 1 or cin != cout:
                macs += _conv_macs(cin, cout, 1, s_out, s_out)  # downsample
            cin, s = cout, s_out
    macs += cin * num_classes  # fc head
    return macs


def vit_macs_per_image(
    image_size: int = 224,
    patch: int = 32,
    width: int = 768,
    layers: int = 12,
    mlp_ratio: float = 4.0,
    out_dim: int = 512,
    cls_token: bool = True,
) -> int:
    """Multiply-accumulates of one ViT image-tower forward (CLIP layout); defaults are CLIP ViT-B/32.

    ~4.4 GMac for ViT-B/32, ~17.5 GMac for ViT-B/16.
    """
    grid = image_size // patch
    tokens = grid * grid + (1 if cls_token else 0)
    macs = _conv_macs(3, width, patch, grid, grid)  # patch embedding
    per_layer = (
        3 * width * width * tokens  # qkv projection
        + width * width * tokens  # output projection
        + 2 * tokens * tokens * width  # QK^T and AV
        + 2 * int(mlp_ratio * width) * width * tokens  # MLP in + out
    )
    macs += layers * per_layer
    macs += width * out_dim  # final projection (pooled token)
    return macs


def resnet_flops_per_image(depth: int = 50, image_size: int = 224) -> int:
    return _MAC * resnet_macs_per_image(depth, image_size)


def vit_flops_per_image(**kw) -> int:
    return _MAC * vit_macs_per_image(**kw)


#: NVIDIA H100 data sheet, dense rates: operations/s by dtype (``int8`` in
#: OP/s, ``fp32`` outside the tensor cores) and HBM bytes/s.
H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12, "hbm_bytes_per_s": 3.35e12}
H100_PCIE = {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "int8": 1513e12, "hbm_bytes_per_s": 2.0e12}

# By lower-cased device-name substring, first match wins: torch names the
# SXM part "NVIDIA H100 80GB HBM3" and the PCIe part "NVIDIA H100 PCIe".
_PEAKS = (
    ("h100 pcie", H100_PCIE),
    ("h100 sxm", H100_SXM),
    ("h100 80gb hbm3", H100_SXM),
)


def cuda_peaks(device_name: str) -> dict | None:
    """Dense peaks of the card named ``device_name`` (``torch.cuda.get_device_name()``), or None if unknown.

    Keys ``bf16``, ``tf32``, ``fp32``, ``int8`` (operations/s) and
    ``hbm_bytes_per_s``.
    """
    name = device_name.lower()
    for key, peaks in _PEAKS:
        if key in name:
            return dict(peaks)
    return None


def mfu_pct(imgs_per_s: float, flops_per_img: float, device_name: str, dtype: str = "bf16") -> float | None:
    """Model FLOPs utilization (%) of one card at its ``dtype`` peak, or None for an unknown card."""
    peaks = cuda_peaks(device_name)
    if not peaks or not imgs_per_s:
        return None
    return round(100.0 * imgs_per_s * flops_per_img / peaks[dtype], 1)
