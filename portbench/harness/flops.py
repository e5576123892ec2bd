"""Frozen arithmetic of the yardstick: FLOP counters, the search's operations and bytes, the card's peaks.

The ResNet and ViT counters are copies of ``semanticlens_tpu_torch/utils/
flops.py`` as of the benchmark's first version, kept here so that a change
to the program cannot change what its work is counted as. One
multiply-accumulate is 2 FLOPs; matmuls and convolutions only (norms,
activations, pooling and softmax are under 1% of the FLOPs).
:func:`siglip_macs_per_image` adds what the program's module lacks: the
SigLIP tower (patch tokens only, no class token) and its MAP head.

The peaks are NVIDIA's data-sheet dense rates (no sparsity) of the H100
SXM and PCIe parts, looked up by ``torch.cuda.get_device_name()``. An
unknown card has no peak: the run fails rather than assume one.
"""

from __future__ import annotations

MAC = 2  # FLOPs per multiply-accumulate

H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12, "hbm_bytes_per_s": 3.35e12}
H100_PCIE = {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "int8": 1513e12, "hbm_bytes_per_s": 2.0e12}
# By lower-cased device-name substring, first match wins: torch names the SXM part
# "NVIDIA H100 80GB HBM3" and the PCIe part "NVIDIA H100 PCIe".
PEAKS = (("h100 pcie", H100_PCIE), ("h100 sxm", H100_SXM), ("h100 80gb hbm3", H100_SXM))


class UnknownCard(LookupError):
    """No data-sheet peak is known for the card."""


def peaks(device_name: str) -> dict:
    name = device_name.lower()
    for key, table in PEAKS:
        if key in name:
            return dict(table)
    raise UnknownCard(f"no data-sheet peak for the card {device_name!r}")


def _conv_macs(cin: int, cout: int, k: int, hout: int, wout: int, groups: int = 1) -> int:
    return k * k * (cin // groups) * cout * hout * wout


def resnet_macs_per_image(depth: int = 50, image_size: int = 224, num_classes: int = 1000) -> int:
    """One torchvision-layout ResNet forward, ~4.1 GMac for depth 50 at 224."""
    stage_blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                    152: (3, 8, 36, 3)}[depth]
    bottleneck = depth >= 50
    expansion = 4 if bottleneck else 1
    s = image_size // 2
    macs = _conv_macs(3, 64, 7, s, s)
    s //= 2
    cin = 64
    for stage, n_blocks in enumerate(stage_blocks):
        width = 64 * (2**stage)
        cout = width * expansion
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            s_in, s_out = s, s // stride
            if bottleneck:
                macs += _conv_macs(cin, width, 1, s_in, s_in)
                macs += _conv_macs(width, width, 3, s_out, s_out)
                macs += _conv_macs(width, cout, 1, s_out, s_out)
            else:
                macs += _conv_macs(cin, width, 3, s_out, s_out)
                macs += _conv_macs(width, width, 3, s_out, s_out)
            if stride != 1 or cin != cout:
                macs += _conv_macs(cin, cout, 1, s_out, s_out)
            cin, s = cout, s_out
    return macs + cin * num_classes


def vit_macs_per_image(image_size: int = 224, patch: int = 32, width: int = 768, layers: int = 12,
                       mlp_ratio: float = 4.0, out_dim: int = 512, cls_token: bool = True) -> int:
    """One ViT tower forward (CLIP layout), ~4.4 GMac for ViT-B/32, ~17.5 GMac for ViT-B/16."""
    grid = image_size // patch
    tokens = grid * grid + (1 if cls_token else 0)
    macs = _conv_macs(3, width, patch, grid, grid)
    per_layer = (3 * width * width * tokens + width * width * tokens + 2 * tokens * tokens * width
                 + 2 * int(mlp_ratio * width) * width * tokens)
    return macs + layers * per_layer + width * out_dim


def siglip_macs_per_image(image_size: int = 224, patch: int = 16, width: int = 768, layers: int = 12,
                          mlp_ratio: float = 4.0) -> int:
    """The SigLIP ViT image tower: patch tokens only, then the MAP head (one latent query)."""
    tokens = (image_size // patch) ** 2
    trunk = vit_macs_per_image(image_size, patch, width, layers, mlp_ratio, out_dim=0, cls_token=False)
    hidden = int(mlp_ratio * width)
    head = (width * width  # q of the latent
            + 2 * width * width * tokens  # packed kv of every token
            + 2 * tokens * width  # one query's logits and weighted values
            + width * width  # projection
            + 2 * hidden * width)  # MLP on the pooled token
    return trunk + head


def heads_tap_macs(tokens: int, width: int) -> int:
    """A tapped ``attn.heads`` component: every head's output through its slice of the projection."""
    return tokens * width * width


def search_least_s(queries: int, rows: int, dim: int, k: int, card: dict) -> tuple[float, str]:
    """Least time of a top-k cosine search on the card, and which bound sets it.

    Operations: the dots, 2·Q·N·D, at the TF32 dense peak (the card's
    fastest rate on float32 operands). Bytes: the bank and the queries read
    once, the (Q, k) values and int32 indices written once, at the HBM
    rate. The larger time is the bound; it counts the search's work, not
    any implementation's passes.
    """
    ops_s = 2.0 * queries * rows * dim / card["tf32"]
    bytes_s = (4.0 * rows * dim + 4.0 * queries * dim + 8.0 * queries * k) / card["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
