"""The vision zoo's state-dict loaders against the JAX package's.

A torchvision-named state dict (timm-named for ResNet-D and the timm
ConvNeXt) is built here for each family: every tensor the family's specs
name, in torch's layout (conv OIHW, depthwise (C, 1, k, k), linear
(out, in), squeeze-excite 1×1 convs (out, in, 1, 1), torchvision ConvNeXt's
(C, 1, 1) ``layer_scale``), random from a seed, plus the BN
``num_batches_tracked`` buffers a real checkpoint carries. It loads into
the port as it is (the same values, float32 in a float32 model), and
through the JAX ``load_torch_state_dict`` into JAX params that
``convert.zoo_params_from_jax`` maps back to the state dict exactly. A
tensor of the wrong shape is refused by name, as the JAX loader refuses it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semanticlens_tpu.models as J
import semanticlens_tpu_torch.models as T
from semanticlens_tpu_torch import convert

torch.set_num_threads(2)

FAMILIES = [
    ("ResNet", dict(depth=50, variant="d")),
    ("ResNet", dict(depth=50, groups=32, width_per_group=4)),
    ("ResNet", dict(depth=50, width_per_group=128)),
    ("VGG", dict(depth=11, batch_norm=True)),
    ("DenseNet", dict(depth=121)),
    ("ConvNeXt", dict(variant="tiny")),
    ("ConvNeXt", dict(variant="tiny", naming="torchvision")),
    ("EfficientNet", dict(variant="b0")),
    ("EfficientNetV2", dict(variant="v2_s")),
    ("MobileNetV2", dict()),
    ("MobileNetV3", dict(variant="large")),
    ("MNASNet", dict(variant="1_0")),
    ("RegNet", dict(variant="y_400mf")),
]


def _id(case):
    cls, kw = case
    return cls + "".join(f"-{k}={v}" for k, v in kw.items())


def torch_state_dict(model, seed=0):
    """Every tensor of ``model``'s specs in torch's layout, random, with BN ``num_batches_tracked`` buffers."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape, kind in model._param_specs():
        sd[name] = torch.randn(convert.torch_layout_shape(name, shape, kind), generator=gen)
        if name.endswith("running_var"):
            sd[name] = sd[name].abs() + 0.5
            sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    return sd


@pytest.mark.parametrize("case", FAMILIES, ids=[_id(c) for c in FAMILIES])
def test_torch_state_dict_loads_in_both_packages_and_converts_back(case):
    cls, kw = case
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    sd = torch_state_dict(tm)
    names = [name for name, _, _ in tm._param_specs()]

    params = tm.load_torch_state_dict(sd)
    assert list(params) == names
    for name in names:
        assert params[name].dtype == torch.float32 and torch.equal(params[name], sd[name]), name

    jparams = jm.load_torch_state_dict(sd)
    back = convert.zoo_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tm._param_specs())
    assert sorted(back) == sorted(names)
    for name in names:
        assert torch.equal(back[name], sd[name]), name


@pytest.mark.parametrize("case", [c for c in FAMILIES if c[0] in ("EfficientNet", "ConvNeXt", "RegNet")],
                         ids=[_id(c) for c in FAMILIES if c[0] in ("EfficientNet", "ConvNeXt", "RegNet")])
def test_a_tensor_of_the_wrong_shape_is_refused_by_name(case):
    cls, kw = case
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    sd = torch_state_dict(tm)
    name = next(n for n, shape, kind in tm._param_specs() if kind == "se_fc" or n.endswith(("gamma", "layer_scale")))
    sd[name] = sd[name][:-1]  # one output channel short
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        tm.load_torch_state_dict(sd)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        jm.load_torch_state_dict(sd)


def test_bf16_placement_keeps_norms_and_biases_float32():
    """Convs and matrices in the compute dtype (convs channels_last); BN, LayerNorm, biases and layer scale
    float32, which the ops cast at use."""
    tm = T.EfficientNet(variant="b0", dtype=torch.bfloat16, device="cpu")
    params = tm.load_torch_state_dict(torch_state_dict(tm))
    for name, shape, kind in tm._param_specs():
        t = params[name]
        if len(shape) == 4 or kind == "se_fc":
            assert t.dtype == torch.bfloat16 and t.is_contiguous(memory_format=torch.channels_last), name
        elif len(shape) == 2:
            assert t.dtype == torch.bfloat16, name
        else:
            assert t.dtype == torch.float32, name
    cn = T.ConvNeXt(variant="tiny", naming="torchvision", dtype=torch.bfloat16, device="cpu")
    p = cn.load_torch_state_dict(torch_state_dict(cn))
    assert p["features.1.0.layer_scale"].shape == (96, 1, 1) and p["features.1.0.layer_scale"].dtype == torch.float32


def test_loaded_checkpoint_gives_the_jax_forward():
    """One family end to end: the same state dict through each package's loader gives the same logits."""
    jm = J.MNASNet(variant="0_5", dtype=jnp.float32)
    tm = T.MNASNet(variant="0_5", dtype=torch.float32, device="cpu")
    sd = torch_state_dict(tm, seed=1)
    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jm.apply(p, xx)[0])(jm.load_torch_state_dict(sd), jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(tm.load_torch_state_dict(sd), torch.from_numpy(x))[0].numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
