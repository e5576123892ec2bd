"""Port parity: ``ResNet(quantize="int8")`` and int8 weights across ``convert`` against the JAX package.

The int8 towers' tests are ``test_torch_quant_towers.py``; the bounds and
helpers here serve both. Weights come from one numpy seed in the JAX
layout (the port's ``init_*_jax_layout``), quantized by each package; the
int8 weights must be equal bit for bit (``q`` and ``scale``, after the
layout transpose) and cover the same keys. Then, on the CPU in float32:

- **Transformer towers** (CLIP ViT and text, SigLIP image and text): the
  embeddings within 1e-5 relative (L2) of the JAX int8 tower's (measured
  2.0e-7 – 4.4e-7); the control, the port's float tower, reads 1.3e-2 –
  1.9e-2 and breaks it.
- **Conv towers** (ResNet, MobileCLIP's image tower): each int8 site fed
  the JAX model's own input to it (recorded during the JAX forward) gives
  the JAX site's output exactly. End to end the two packages' taps can part
  by the quantization noise itself: a per-sample activation scale is the
  sample's absmax, so a last-bit difference upstream that flips one
  rounding of the element holding the max moves that sample's scale and
  re-rounds the whole sample. ResNet-50 reads 0.016 – 0.031 (from
  ``layer2.0.conv2`` on) and MobileCLIP 0.014 where ResNet-18 and ResNeXt
  read ≤ 5.5e-7, so the end-to-end bound is 0.06 relative (L2). The
  control, the int8 scales applied to the wrong channels (reversed), reads
  0.19 – 0.47 and breaks it.

Against its own float model each int8 model keeps the JAX tests' cosines:
≥ 0.995 per embedding, ≥ 0.99 for pooled ResNet taps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import semanticlens_tpu.models.resnet as jres
from semanticlens_tpu.foundation_models import clip as jclip
from semanticlens_tpu.ops.quant import QuantizedTensor as JQT
from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.foundation_models import clip as tclip
from semanticlens_tpu_torch.models import layers as tl
from semanticlens_tpu_torch.models.resnet import ResNet as TResNet
from semanticlens_tpu_torch.ops.quant import QuantizedTensor

torch.set_num_threads(2)

TRANSFORMER_BOUND = 1e-5  # relative L2, port int8 tower against the JAX int8 tower
CONV_E2E_BOUND = 0.06  # relative L2 end to end; the int8 sites themselves are held exactly
FLOAT_COSINE = 0.995  # int8 against the float tower, per embedding (tests/ops/test_quant.py)
POOLED_COSINE = 0.99  # int8 against the float ResNet, pooled taps (tests/ops/test_quant.py)


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def _cos(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _perturbed(params, seed):
    """Norms and biases moved off their 1/0 init, so they matter."""
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32) if v.ndim == 1 else v for k, v in params.items()}


def _int8_keys_equal(tparams, jparams):
    """The same keys quantized in both packages, ``q`` and ``scale`` equal bit for bit."""
    jkeys = {k for k, v in jparams.items() if isinstance(v, JQT)}
    assert jkeys and jkeys == {k for k, v in tparams.items() if isinstance(v, QuantizedTensor)}
    for key in jkeys:
        want = convert.quantized_from_jax(jparams[key])
        assert torch.equal(tparams[key].q.cpu(), want.q) and torch.equal(tparams[key].scale.cpu(), want.scale), key


def _wrong_channel_scales(params):
    """The control: every int8 weight's scales reversed over the out channels."""
    return {k: QuantizedTensor(v.q, v.scale.flip(0)) if isinstance(v, QuantizedTensor) else v
            for k, v in params.items()}


def _recording(module, name, record):
    """Wrap ``module.name`` (a JAX layer op) to record its int8 calls' input, weight, kwargs and output."""
    real = getattr(module, name)

    def wrapped(x, w, b=None, **kw):
        out = real(x, w, b, **kw)
        if isinstance(w, JQT):
            record.append((name, np.array(x), w, None if b is None else np.array(b), kw, np.asarray(out)))
        return out

    return wrapped


def _replay_in_port(record):
    """Each recorded JAX int8 site through the port's layer op on the same input: equal exactly."""
    assert record
    for op, x, w, b, kw, want in record:
        tw, tb = convert.quantized_from_jax(w), None if b is None else torch.from_numpy(b)
        if op == "conv2d":
            got = tl.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), tw, tb, **kw).permute(0, 2, 3, 1)
        else:
            got = tl.linear(torch.from_numpy(x), tw, tb)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{op} {w.q.shape} {kw}")


# Tiny CLIP (also the towers' tests' and the mesh rank's).
CLIP_V = dict(image_size=32, patch_size=8, width=64, layers=3, heads=4)
CLIP_TX = dict(context_length=12, vocab_size=100, width=64, heads=4, layers=2)
CLIP_J = jclip.CLIPConfig(embed_dim=64, vision=jclip.VisionCfg(kind="vit", **CLIP_V), text=jclip.TextCfg(**CLIP_TX))
CLIP_T = tclip.CLIPConfig(embed_dim=64, vision=tclip.VisionCfg(**CLIP_V), text=tclip.TextCfg(**CLIP_TX))


# --------------------------------------------------------------------------- ResNet
RESNETS = {"resnet18": dict(depth=18), "resnet50": dict(depth=50),
           "resnext50_32x4d": dict(depth=50, groups=32, width_per_group=4)}
TAPS = ("layer1", "layer2", "layer3", "layer4", "layer3.0.conv2", "fc")


@pytest.mark.parametrize("arch", list(RESNETS))
def test_resnet_int8_against_jax(arch, monkeypatch):
    kw = RESNETS[arch]
    tm = TResNet(num_classes=10, dtype=torch.float32, device="cpu", quantize="int8", **kw)
    jm = jres.ResNet(num_classes=10, dtype=jnp.float32, quantize="int8", **kw)
    assert repr(tm) == repr(jm) and "quantize='int8'" in repr(tm)
    assert "int8" not in repr(TResNet(num_classes=10, device="cpu", **kw))
    np_params = tm.init_jax_layout(0)
    jparams = jm._maybe_quantize({k: jnp.asarray(v) for k, v in np_params.items()})
    tparams = tm.load_jax_params(np_params)
    _int8_keys_equal(tparams, jparams)
    assert not isinstance(tparams["conv1.weight"], QuantizedTensor)  # the stem, BNs and fc stay float
    assert not isinstance(tparams["fc.weight"], QuantizedTensor) and tparams["layer1.0.bn1.weight"].is_floating_point()
    assert torch.equal(tm.init(0)["layer1.0.conv1.weight"].q, tparams["layer1.0.conv1.weight"].q)

    x = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    record = []
    monkeypatch.setattr(jres, "conv2d", _recording(jres, "conv2d", record))
    _, jtaps = jm.apply(jparams, jnp.asarray(x), TAPS)  # eager: the recorder sees concrete inputs
    monkeypatch.undo()
    assert len(record) == sum(isinstance(v, JQT) for v in jparams.values())
    _replay_in_port(record)

    _, ttaps = tm.apply(tparams, torch.from_numpy(x), TAPS)
    _, control = tm.apply(_wrong_channel_scales(tparams), torch.from_numpy(x), TAPS)
    for name in TAPS:
        assert _rel(ttaps[name], jtaps[name]) <= CONV_E2E_BOUND, name
        assert _rel(control[name], jtaps[name]) > CONV_E2E_BOUND, name

    tf = TResNet(num_classes=10, dtype=torch.float32, device="cpu", **kw)
    _, ftaps = tf.apply(tf.load_jax_params(np_params), torch.from_numpy(x), TAPS[:4])
    for name in TAPS[:4]:
        pooled = [t.mean(dim=(1, 2)).flatten().numpy() for t in (ttaps[name], ftaps[name])]
        assert _cos(*pooled) >= POOLED_COSINE, name


def test_resnet_quantize_rejects_unknown_mode():
    with pytest.raises(ValueError, match="quantize"):
        TResNet(depth=18, quantize="int4", device="cpu")


def test_resnet_d_quantizes_its_stage_convs_by_spec_kind():
    """-D: ``downsample.1`` is a conv (quantized), ``downsample.2`` its BN; the 3-conv stem stays float."""
    tm = TResNet(depth=50, variant="d", num_classes=10, dtype=torch.float32, device="cpu", quantize="int8")
    jm = jres.ResNet(depth=50, variant="d", num_classes=10, dtype=jnp.float32, quantize="int8")
    np_params = tm.init_jax_layout(0)
    tparams = tm.load_jax_params(np_params)
    _int8_keys_equal(tparams, jm._maybe_quantize({k: jnp.asarray(v) for k, v in np_params.items()}))
    assert isinstance(tparams["layer2.0.downsample.1.weight"], QuantizedTensor)
    assert not isinstance(tparams["conv1.0.weight"], QuantizedTensor)


# --------------------------------------------------------------------------- convert
def test_quantized_leaves_convert_from_the_jax_layout():
    """``clip_params_from_jax`` / ``zoo_params_from_jax`` take JAX ``QuantizedTensor`` leaves."""
    np_params = tclip.init_clip_params_jax_layout(0, CLIP_T)
    jparams = jclip.quantize_clip_params({k: jnp.asarray(v) for k, v in np_params.items()}, CLIP_J)
    converted = convert.clip_params_from_jax(jparams)
    fm = tclip.OpenClip("ViT-B-32", cfg=CLIP_T, jax_params=np_params, dtype=torch.float32, device="cpu",
                        quantize="int8")
    _int8_keys_equal(fm.params, jparams)
    for key, value in converted.items():
        if isinstance(value, QuantizedTensor):
            assert value.q.shape == fm.params[key].q.shape and value.q.is_contiguous()
        else:
            assert torch.equal(value, fm.params[key]), key
    tm = TResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu", quantize="int8")
    jm = jres.ResNet(depth=18, num_classes=10, dtype=jnp.float32, quantize="int8")
    np_r = tm.init_jax_layout(0)
    zoo = convert.zoo_params_from_jax(jm._maybe_quantize({k: jnp.asarray(v) for k, v in np_r.items()}),
                                      tm._param_specs())
    _int8_keys_equal(zoo, jm._maybe_quantize({k: jnp.asarray(v) for k, v in np_r.items()}))
    assert zoo["layer1.0.conv1.weight"].q.shape == (64, 64, 3, 3)
