"""The state-dict loaders of the vision zoo's part two against the JAX package's.

A torchvision-named state dict is built here for each family, as
``test_torch_zoo_loaders.py`` builds it (every tensor the specs name, in
torch's layout, random from a seed, with BN ``num_batches_tracked``), plus
what a torchvision checkpoint carries that the specs skip: Swin's and
MaxViT's derived ``relative_position_index`` buffers, Swin-V2's
``relative_coords_table``, GoogLeNet's ``aux1`` / ``aux2`` and
Inception-v3's ``AuxLogits`` heads. It loads into the port as it is, and
through the JAX ``load_torch_state_dict`` into JAX params that
``convert.zoo_params_from_jax`` maps back to the state dict exactly: the
relative-position tables ((2w−1)², heads) and ``logit_scale`` (heads, 1, 1)
keep their layout in both packages, Swin-V2's ``cpb_mlp`` linears and the
patch embedding relayout. A tensor of the wrong shape is refused by name.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import semanticlens_tpu.models as J
import semanticlens_tpu_torch.models as T
from semanticlens_tpu_torch import convert
from test_torch_zoo_loaders import torch_state_dict

torch.set_num_threads(2)

FAMILIES = [
    ("SwinTransformer", dict()),
    ("SwinTransformerV2", dict()),
    ("MaxViT", dict()),
    ("GoogLeNet", dict()),
    ("InceptionV3", dict()),
    ("ShuffleNetV2", dict(variant="x1_0")),
    ("AlexNet", dict()),
    ("SqueezeNet", dict(version="1_0")),
]


def _id(case):
    cls, kw = case
    return cls + "".join(f"-{k}={v}" for k, v in kw.items())


def checkpoint(model, seed=0):
    """:func:`torch_state_dict` with the derived buffers and train-time heads of a torchvision checkpoint."""
    sd = torch_state_dict(model, seed)
    for name in list(sd):
        if name.endswith("relative_position_bias_table"):
            sd[name.replace("relative_position_bias_table", "relative_position_index")] = torch.arange(49 * 49)
        if name.endswith("logit_scale"):
            sd[name.replace("logit_scale", "relative_coords_table")] = torch.zeros(1, 15, 15, 2)
    sd["aux1.conv.conv.weight"] = sd["AuxLogits.fc.weight"] = torch.zeros(3, 3)
    return sd


@pytest.mark.parametrize("case", FAMILIES, ids=[_id(c) for c in FAMILIES])
def test_torch_state_dict_loads_in_both_packages_and_converts_back(case):
    cls, kw = case
    jm = getattr(J, cls)(**kw, dtype=jnp.float32)
    tm = getattr(T, cls)(**kw, dtype=torch.float32, device="cpu")
    sd = checkpoint(tm)
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


def test_bias_tables_keep_their_layout_and_linears_transpose():
    tm = T.SwinTransformerV2(dtype=torch.float32, device="cpu")
    specs = {name: (shape, kind) for name, shape, kind in tm._param_specs()}
    for name, want in (("features.1.0.attn.logit_scale", (3, 1, 1)), ("features.1.0.attn.cpb_mlp.0.weight", (512, 2)),
                       ("features.1.0.attn.cpb_mlp.2.weight", (3, 512)), ("features.0.0.weight", (96, 3, 4, 4))):
        assert convert.torch_layout_shape(name, *specs[name]) == want, name
    sw = T.SwinTransformer(dtype=torch.float32, device="cpu")
    (shape, kind), = [(s, k) for n, s, k in sw._param_specs() if n == "features.1.0.attn.relative_position_bias_table"]
    assert convert.torch_layout_shape("features.1.0.attn.relative_position_bias_table", shape, kind) == (169, 3)


@pytest.mark.parametrize("cls,name", [("SwinTransformer", "features.3.1.attn.relative_position_bias_table"),
                                      ("SwinTransformerV2", "features.1.1.attn.cpb_mlp.2.weight"),
                                      ("MaxViT", "blocks.0.layers.0.layers.MBconv.layers.squeeze_excitation.fc1.weight"),
                                      ("GoogLeNet", "inception4a.branch3.1.conv.weight")])
def test_a_tensor_of_the_wrong_shape_is_refused_by_name(cls, name):
    jm = getattr(J, cls)(dtype=jnp.float32)
    tm = getattr(T, cls)(dtype=torch.float32, device="cpu")
    sd = checkpoint(tm)
    sd[name] = sd[name][:-1]  # one row short
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        tm.load_torch_state_dict(sd)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        jm.load_torch_state_dict(sd)


def test_bf16_placement_keeps_the_attention_bias_float32():
    """In a bf16 model the relative-position tables and Swin-V2's CPB MLP stay float32 (they feed float32
    logits); the other matrices and convs take the compute dtype."""
    for cls in ("SwinTransformerV2", "MaxViT", "SwinTransformer"):
        tm = getattr(T, cls)(dtype=torch.bfloat16, device="cpu")
        params = tm.load_torch_state_dict(checkpoint(tm))
        for name, shape, kind in tm._param_specs():
            bias_path = name.endswith("relative_position_bias_table") or ".cpb_mlp." in name
            if bias_path or len(shape) == 1 or name.endswith("logit_scale"):
                assert params[name].dtype == torch.float32, name
            else:
                assert params[name].dtype == torch.bfloat16, name


def test_loaded_checkpoint_gives_the_jax_forward():
    """Swin-V2 end to end: the same state dict through each package's loader gives the same logits."""
    jm = J.SwinTransformerV2(dtype=jnp.float32)
    tm = T.SwinTransformerV2(dtype=torch.float32, device="cpu")
    sd = {k: v * 0.05 if v.is_floating_point() and not k.endswith(("running_var", "logit_scale")) else v
          for k, v in checkpoint(tm, seed=1).items()}
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: jm.apply(p, xx)[0])(jm.load_torch_state_dict(sd), jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(tm.load_torch_state_dict(sd), torch.from_numpy(x))[0].numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
