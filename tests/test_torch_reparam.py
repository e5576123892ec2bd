"""The port's copy of the reparameterization module against the JAX package's.

Every folding function on the same random branches (numpy, float64): the
outputs must be equal to the JAX module's exactly (both are numpy code),
and the folded convs must reproduce the train-form torch modules (atol
1e-5 in float32, the JAX test's bound).
"""

import numpy as np
import pytest
import torch

from semanticlens_tpu.foundation_models import reparam as jrep
from semanticlens_tpu_torch.foundation_models import reparam as trep

torch.set_num_threads(2)

BN = ("weight", "bias", "running_mean", "running_var")


def _bn(rng, c, prefix):
    return {f"{prefix}.weight": rng.uniform(0.5, 1.5, c), f"{prefix}.bias": rng.normal(0, 0.1, c),
            f"{prefix}.running_mean": rng.normal(0, 0.2, c), f"{prefix}.running_var": rng.uniform(0.3, 1.3, c)}


def _mobileone_sd(rng, prefix, c, groups, k, n_conv, scale, skip, single=False):
    sd = {}
    cin = c // groups
    convs = [f"{prefix}.rbr_conv"] if single else [f"{prefix}.rbr_conv.{i}" for i in range(n_conv)]
    for p in convs:
        sd[f"{p}.conv.weight"] = rng.normal(0, 0.2, (c, cin, k, k))
        sd.update(_bn(rng, c, f"{p}.bn"))
    if scale:
        sd[f"{prefix}.rbr_scale.conv.weight"] = rng.normal(0, 0.2, (c, cin, 1, 1))
        sd.update(_bn(rng, c, f"{prefix}.rbr_scale.bn"))
    if skip:
        sd.update(_bn(rng, c, f"{prefix}.rbr_skip"))
    return sd


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("bias", [False, True])
def test_fuse_conv_bn_equals_jax_and_torch(bias):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 4, 3, 3))
    bn = _bn(rng, 6, "bn")
    b = rng.normal(size=6) if bias else None
    args = (w, bn["bn.weight"], bn["bn.bias"], bn["bn.running_mean"], bn["bn.running_var"])
    got = trep.fuse_conv_bn(*args, bias=b, eps=1e-3)
    _assert_same(got, jrep.fuse_conv_bn(*args, bias=b, eps=1e-3))
    x = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    module = torch.nn.BatchNorm2d(6, eps=1e-3).eval()
    with torch.no_grad():
        for name in BN:
            getattr(module, name).copy_(torch.from_numpy(bn[f"bn.{name}"]))
        bias = None if b is None else torch.from_numpy(b).float()
        conv = torch.nn.functional.conv2d(x, torch.from_numpy(w).float(), bias, padding=1)
        want = module(conv)
    fused = torch.nn.functional.conv2d(x, torch.from_numpy(got[0]).float(), torch.from_numpy(got[1]).float(), padding=1)
    np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("channels, groups, k", [(5, 1, 3), (6, 6, 3), (4, 2, 5), (3, 3, 1)])
def test_identity_and_pad_kernel_equal_jax(channels, groups, k):
    np.testing.assert_array_equal(trep.identity_kernel(channels, groups, k), jrep.identity_kernel(channels, groups, k))
    small = np.random.default_rng(k).normal(size=(channels, channels // groups, 1, 1))
    np.testing.assert_array_equal(trep.pad_kernel(small, k), jrep.pad_kernel(small, k))
    with pytest.raises(ValueError):
        trep.pad_kernel(np.zeros((1, 1, 5, 5)), 3)


def test_fold_branches_equals_jax_and_rejects_empty():
    rng = np.random.default_rng(2)
    branches = [(rng.normal(size=(4, 4, 3, 3)), rng.normal(size=4)),
                (rng.normal(size=(4, 4, 1, 1)), rng.normal(size=4))]
    _assert_same(trep.fold_branches(branches, 3), jrep.fold_branches(branches, 3))
    with pytest.raises(ValueError, match="no branches"):
        trep.fold_branches([], 3)


@pytest.mark.parametrize("groups, n_conv, scale, skip, single", [
    (1, 2, True, False, False), (1, 1, False, True, False), (8, 1, True, True, False), (8, 3, True, False, False),
    (1, 1, True, True, True),
])
def test_fuse_mobileone_block_equals_jax(groups, n_conv, scale, skip, single):
    rng = np.random.default_rng(groups + n_conv)
    sd = _mobileone_sd(rng, "blk", 8, groups, 3, n_conv, scale, skip, single)
    got = trep.fuse_mobileone_block(sd, "blk", channels=8, groups=groups, k=3)
    _assert_same(got, jrep.fuse_mobileone_block(sd, "blk", channels=8, groups=groups, k=3))
    # The folded conv reproduces the sum of the train-form branches.
    x = torch.randn(1, 8, 6, 6, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    want = 0
    for i in ([None] if single else range(n_conv)):
        p = "blk.rbr_conv" if single else f"blk.rbr_conv.{i}"
        w, b = jrep.fuse_conv_bn(sd[f"{p}.conv.weight"], *(sd[f"{p}.bn.{n}"] for n in BN))
        want = want + torch.nn.functional.conv2d(x, torch.from_numpy(w), torch.from_numpy(b), padding=1, groups=groups)
    if scale:
        w, b = jrep.fuse_conv_bn(sd["blk.rbr_scale.conv.weight"], *(sd[f"blk.rbr_scale.bn.{n}"] for n in BN))
        want = want + torch.nn.functional.conv2d(x, torch.from_numpy(w), torch.from_numpy(b), groups=groups)
    if skip:
        g, b, m, v = (torch.from_numpy(sd[f"blk.rbr_skip.{n}"]) for n in BN)
        want = want + (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + 1e-5) * g[:, None, None] + b[:, None, None]
    fused = torch.nn.functional.conv2d(x, torch.from_numpy(got[0]), torch.from_numpy(got[1]), padding=1, groups=groups)
    np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=1e-10)


def test_fuse_mobileone_block_deployed_and_missing():
    sd = {"blk.reparam_conv.weight": np.ones((4, 1, 3, 3)), "blk.reparam_conv.bias": np.arange(4.0)}
    _assert_same(trep.fuse_mobileone_block(sd, "blk", channels=4, groups=4, k=3),
                 jrep.fuse_mobileone_block(sd, "blk", channels=4, groups=4, k=3))
    with pytest.raises(KeyError, match="no reparameterizable"):
        trep.fuse_mobileone_block({}, "blk", channels=4, groups=4, k=3)


@pytest.mark.parametrize("deployed", [False, True])
def test_fuse_repmixer_equals_jax(deployed):
    rng = np.random.default_rng(7)
    if deployed:
        sd = {"mix.reparam_conv.weight": rng.normal(size=(6, 1, 3, 3)), "mix.reparam_conv.bias": rng.normal(size=6)}
    else:
        sd = _mobileone_sd(rng, "mix.mixer", 6, 6, 3, 1, True, True)
        sd.update(_bn(rng, 6, "mix.norm.rbr_skip"))
    got = trep.fuse_repmixer(sd, "mix", channels=6, k=3)
    _assert_same(got, jrep.fuse_repmixer(sd, "mix", channels=6, k=3))
    if not deployed:  # x + conv(x; W) == x + mixer(x) − norm(x)
        x = torch.randn(1, 6, 5, 5, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
        mixer = trep.fuse_mobileone_block(sd, "mix.mixer", channels=6, groups=6, k=3)
        norm = trep.fuse_mobileone_block(sd, "mix.norm", channels=6, groups=6, k=3)

        def conv(wb):
            return torch.nn.functional.conv2d(x, torch.from_numpy(wb[0]), torch.from_numpy(wb[1]), padding=1, groups=6)

        np.testing.assert_allclose(conv(got).numpy(), (conv(mixer) - conv(norm)).numpy(), atol=1e-10)
