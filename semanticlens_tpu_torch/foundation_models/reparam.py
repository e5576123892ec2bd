"""Structural reparameterization: fold train-form conv branches into one conv (a copy of
``semanticlens_tpu.foundation_models.reparam``; the port imports nothing of the JAX package).

MobileCLIP's image towers (MCi = FastViT/MobileOne hybrids) train with
multi-branch blocks — k×k conv+BN branches, a 1×1 "scale" conv+BN branch and
a BN-only identity branch — that collapse at inference into a single
convolution (MobileOne/RepVGG folding). Apple releases checkpoints in the
train form; the reference consumes them through open_clip after upstream
reparameterization (reference semanticlens/foundation_models/clip.py:214-247).
This module implements the folding math natively so raw train-form state
dicts convert directly into the deployed single-conv layout used by
:mod:`semanticlens_tpu_torch.foundation_models.mobileclip`.

All kernels here are torch-layout OIHW numpy arrays (what ``.pt`` state dicts
contain), the layout the port's towers use.

The three identities (standard RepVGG/MobileOne algebra):

1. conv(x; W) then BN(γ, β, μ, σ²)  ==  conv(x; W·γ/σ) + (β − μγ/σ)
2. a 1×1 (or any smaller) kernel is a k×k kernel zero-padded around center
3. BN alone is a 1×1 identity-kernel conv (per group) followed by BN
"""

from __future__ import annotations

import numpy as np


def fuse_conv_bn(weight, gamma, beta, mean, var, bias=None, eps: float = 1e-5):
    """Fold BatchNorm into the preceding conv. ``weight`` is OIHW.

    Returns (fused_weight OIHW, fused_bias (O,)).
    """
    weight = np.asarray(weight, np.float64)
    gamma, beta = np.asarray(gamma, np.float64), np.asarray(beta, np.float64)
    mean, var = np.asarray(mean, np.float64), np.asarray(var, np.float64)
    scale = gamma / np.sqrt(var + eps)
    fused_w = weight * scale[:, None, None, None]
    b = np.zeros(weight.shape[0]) if bias is None else np.asarray(bias, np.float64)
    fused_b = beta + (b - mean) * scale
    return fused_w, fused_b


def pad_kernel(weight, k: int):
    """Zero-pad a smaller (odd) OIHW kernel to k×k around its center."""
    weight = np.asarray(weight)
    kh, kw = weight.shape[2], weight.shape[3]
    if kh == k and kw == k:
        return weight
    if kh > k or kw > k:
        raise ValueError(f"cannot pad {kh}x{kw} kernel down to {k}x{k}")
    ph, pw = (k - kh) // 2, (k - kw) // 2
    return np.pad(weight, ((0, 0), (0, 0), (ph, k - kh - ph), (pw, k - kw - pw)))


def identity_kernel(channels: int, groups: int, k: int):
    """OIHW kernel acting as identity for a conv with ``groups`` groups.

    For depthwise (groups == channels) this is a (C, 1, k, k) kernel with a
    1 at the center; for dense convs a (C, C, k, k) one-hot per channel.
    """
    in_per_group = channels // groups
    w = np.zeros((channels, in_per_group, k, k))
    c = k // 2
    for o in range(channels):
        w[o, o % in_per_group, c, c] = 1.0
    return w


def fold_branches(branches, k: int):
    """Sum already-fused (weight OIHW, bias) branches, padding kernels to k×k."""
    total_w, total_b = None, None
    for w, b in branches:
        w = pad_kernel(w, k)
        total_w = w if total_w is None else total_w + w
        total_b = b if total_b is None else total_b + b
    if total_w is None:
        raise ValueError("no branches to fold")
    return total_w, total_b


def fuse_mobileone_block(sd: dict, prefix: str, *, channels: int, groups: int, k: int, eps: float = 1e-5):
    """Fold one MobileOne-style block from a torch state dict into (W, b).

    Recognized branch names under ``prefix`` (the apple/ml-mobileone and
    ml-fastvit conventions):

    - ``rbr_conv.{i}.conv.weight`` + ``rbr_conv.{i}.bn.*`` — k×k branches;
    - ``rbr_scale.conv.weight`` + ``rbr_scale.bn.*`` — the 1×1 branch;
    - ``rbr_skip.*`` — BN-only identity branch;
    - already-fused ``reparam_conv.weight/bias`` passes straight through.
    """
    if f"{prefix}.reparam_conv.weight" in sd:
        return (
            np.asarray(sd[f"{prefix}.reparam_conv.weight"]),
            np.asarray(sd.get(f"{prefix}.reparam_conv.bias", np.zeros(channels))),
        )

    def bn(p):
        return (
            sd[f"{p}.weight"],
            sd[f"{p}.bias"],
            sd[f"{p}.running_mean"],
            sd[f"{p}.running_var"],
        )

    branches = []
    i = 0
    while f"{prefix}.rbr_conv.{i}.conv.weight" in sd:
        g, b_, m, v = bn(f"{prefix}.rbr_conv.{i}.bn")
        branches.append(fuse_conv_bn(sd[f"{prefix}.rbr_conv.{i}.conv.weight"], g, b_, m, v, eps=eps))
        i += 1
    if f"{prefix}.rbr_conv.conv.weight" in sd:  # single-branch variant (no ModuleList)
        g, b_, m, v = bn(f"{prefix}.rbr_conv.bn")
        branches.append(fuse_conv_bn(sd[f"{prefix}.rbr_conv.conv.weight"], g, b_, m, v, eps=eps))
    if f"{prefix}.rbr_scale.conv.weight" in sd:
        g, b_, m, v = bn(f"{prefix}.rbr_scale.bn")
        branches.append(fuse_conv_bn(sd[f"{prefix}.rbr_scale.conv.weight"], g, b_, m, v, eps=eps))
    if f"{prefix}.rbr_skip.weight" in sd:
        g, b_, m, v = bn(f"{prefix}.rbr_skip")
        branches.append(fuse_conv_bn(identity_kernel(channels, groups, 1), g, b_, m, v, eps=eps))
    if not branches:
        raise KeyError(f"no reparameterizable branches found under '{prefix}'")
    return fold_branches(branches, k)


def fuse_repmixer(sd: dict, prefix: str, *, channels: int, k: int = 3, eps: float = 1e-5):
    """Fold a FastViT RepMixer into one residual depthwise kernel.

    Train form: ``x + (mixer(x) − norm(x))`` with mixer/norm both depthwise
    MobileOne blocks (mixer has a conv path, norm is BN-only). Inference
    form: ``x + conv(x; W)`` with ``W = W_mixer − W_norm`` and the identity
    absorbed by the residual add, i.e. the deployed kernel is the difference
    of the two fused branches (apple/ml-fastvit ``RepMixer.reparameterize``).
    Already-fused checkpoints carry ``reparam_conv`` directly.
    """
    if f"{prefix}.reparam_conv.weight" in sd:
        w = np.asarray(sd[f"{prefix}.reparam_conv.weight"])
        b = np.asarray(sd.get(f"{prefix}.reparam_conv.bias", np.zeros(channels)))
        # deployed form includes the residual identity inside the conv:
        # subtract it back out since our block adds the residual explicitly
        return w - identity_kernel(channels, channels, w.shape[-1]), b

    w_mixer, b_mixer = fuse_mobileone_block(sd, f"{prefix}.mixer", channels=channels, groups=channels, k=k, eps=eps)
    w_norm, b_norm = fuse_mobileone_block(sd, f"{prefix}.norm", channels=channels, groups=channels, k=k, eps=eps)
    return w_mixer - w_norm, b_mixer - b_norm
