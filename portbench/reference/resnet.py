"""Plain ResNet-v1.5 (torchvision's layout and names; He et al., arXiv:1512.03385) in float32.

Bottleneck blocks 1×1 → 3×3 (stride here, v1.5) → 1×1, a strided 1×1
projection with BN on the first block of a stage, ReLU after the residual
sum. Inference batch norm (eps 1e-5). ``forward`` returns the outputs of
the named stages (``layer1`` … ``layer4``), NCHW.

Random weights give a residual stream that grows block by block, far from
a trained network's statistics. ``calibrated`` sets every BN's running
mean and variance to the statistics of its input over a batch of images,
as training leaves them, so that each BN normalizes what reaches it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import ops, preprocess, weights

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _bn_specs(prefix: str, ch: int) -> list:
    return [(f"{prefix}.weight", (ch,), ("scale", 0.1)), (f"{prefix}.bias", (ch,), ("normal", 0.1)),
            (f"{prefix}.running_mean", (ch,), ("normal", 0.1)), (f"{prefix}.running_var", (ch,), ("var",))]


def _conv_spec(name: str, c_out: int, c_in: int, k: int) -> tuple:
    return (name, (c_out, c_in, k, k), ("normal", math.sqrt(2.0 / (c_out * k * k))))  # Kaiming, fan-out


def param_specs(cfg: dict) -> list:
    """(name, torch shape, draw) of every tensor of the classifier, torchvision's names."""
    specs = [_conv_spec("conv1.weight", 64, 3, 7), *_bn_specs("bn1", 64)]
    in_ch = 64
    for stage, n_blocks in enumerate(STAGE_BLOCKS[cfg["depth"]], start=1):
        width = 64 * 2 ** (stage - 1)
        out_ch = width * 4
        for b in range(n_blocks):
            p = f"layer{stage}.{b}"
            specs += [_conv_spec(f"{p}.conv1.weight", width, in_ch, 1), *_bn_specs(f"{p}.bn1", width),
                      _conv_spec(f"{p}.conv2.weight", width, width, 3), *_bn_specs(f"{p}.bn2", width),
                      _conv_spec(f"{p}.conv3.weight", out_ch, width, 1), *_bn_specs(f"{p}.bn3", out_ch)]
            if b == 0:
                specs += [_conv_spec(f"{p}.downsample.0.weight", out_ch, in_ch, 1),
                          *_bn_specs(f"{p}.downsample.1", out_ch)]
            in_ch = out_ch
    specs += [("fc.weight", (cfg["num_classes"], in_ch), ("normal", 1.0 / math.sqrt(in_ch))),
              ("fc.bias", (cfg["num_classes"],), ("normal", 0.01))]
    return specs


def _bn(p, prefix, x, calibrate=False):
    if calibrate:  # this BN's statistics from the batch, before it normalizes the batch
        p[f"{prefix}.running_mean"] = x.mean(dim=(0, 2, 3))
        p[f"{prefix}.running_var"] = x.var(dim=(0, 2, 3), correction=0)
    return ops.batch_norm(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"], p[f"{prefix}.running_mean"],
                          p[f"{prefix}.running_var"])


CALIBRATION_IMAGES = 64


def calibrated(p: dict, x, cfg: dict) -> dict:
    """``p`` with every BN's running statistics taken from the normalized NCHW float32 batch ``x``.

    The forward runs on ``p`` widened to float32, without TF32 and with
    cuDNN's deterministic algorithms; the other tensors are returned as
    they were given.
    """
    p32 = weights.as_float32(p)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with ops.strict_float32(), torch.inference_mode():
            forward(p32, x, ("layer4",), cfg, calibrate=True)
    finally:
        torch.backends.cudnn.deterministic = saved
    return {name: p32[name] if name.endswith(("running_mean", "running_var")) else t for name, t in p.items()}


def served(cfg: dict, preprocess_cfg: dict, seed: int, device, dtype) -> dict:
    """The subject's weights for ``seed``: drawn in the served ``dtype``, BN calibrated on scenes from the seed."""
    from portbench.harness import inputs

    p = weights.draw(param_specs(cfg), seed, weights.STREAMS["subject"], device, dtype)
    gen = weights.generator(seed, weights.STREAMS["calibration"], device)
    images = inputs.scenes(gen, CALIBRATION_IMAGES, preprocess_cfg["size"], device)
    return calibrated(p, preprocess.preprocess(images, **preprocess_cfg), cfg)


def forward(p: dict, x, stages: tuple[str, ...], cfg: dict, quant=None, calibrate: bool = False) -> dict:
    """NCHW float32 input → ``{stage: NCHW output}`` for the named stages; stops after the last one.

    ``p`` is float32 (served values widened); with ``calibrate`` each BN first takes the batch's statistics.
    """
    x = ops.conv2d(x, p["conv1.weight"], stride=2, padding=3, quant=quant)
    x = F.max_pool2d(_bn(p, "bn1", x, calibrate).relu(), 3, 2, 1)
    last = max(int(s[len("layer"):]) for s in stages)
    out = {}
    for stage, n_blocks in enumerate(STAGE_BLOCKS[cfg["depth"]][:last], start=1):
        for b in range(n_blocks):
            pre = f"layer{stage}.{b}"
            stride = 2 if stage > 1 and b == 0 else 1
            h = _bn(p, f"{pre}.bn1", ops.conv2d(x, p[f"{pre}.conv1.weight"], quant=quant), calibrate).relu()
            h = _bn(p, f"{pre}.bn2", ops.conv2d(h, p[f"{pre}.conv2.weight"], stride=stride, padding=1,
                                                 quant=quant), calibrate).relu()
            h = _bn(p, f"{pre}.bn3", ops.conv2d(h, p[f"{pre}.conv3.weight"], quant=quant), calibrate)
            if b == 0:
                x = _bn(p, f"{pre}.downsample.1", ops.conv2d(x, p[f"{pre}.downsample.0.weight"], stride=stride,
                                                              quant=quant), calibrate)
            x = (h + x).relu()
        if f"layer{stage}" in stages:
            out[f"layer{stage}"] = x
    return out
