"""Port parity of ``TorchSubjectModel``: any ``torch.nn.Module`` as a subject.

The same torch module runs under both packages' adapters on the CPU
(``semanticlens_tpu.models.TorchSubjectModel`` behind ``jax.pure_callback``,
the port's natively), so outputs and taps must be identical (atol 0). A
collect through each package's visualizer must give equal ids, values within
one bf16 step (2^-7 relative). A torchvision-layout ResNet-18 through the
adapter must equal the port's native ``ResNet(18)`` on the same state dict
(atol 1e-4, float32: the same arithmetic by other code).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from semanticlens_tpu.collect import ActivationComponentVisualizer as JCV
from semanticlens_tpu.data import ArrayDataset as JDataset
from semanticlens_tpu.models import TorchSubjectModel as JAdapter
from semanticlens_tpu.ops.aggregators import aggregate_conv_mean as j_mean
from semanticlens_tpu.utils import make_preprocess_fn as j_pre
from semanticlens_tpu_torch.collect import ActivationComponentVisualizer as TCV
from semanticlens_tpu_torch.data import ArrayDataset as TDataset
from semanticlens_tpu_torch.models import ResNet, TorchSubjectModel
from semanticlens_tpu_torch.ops.aggregators import aggregate_conv_mean as t_mean
from semanticlens_tpu_torch.utils import make_preprocess_fn as t_pre

torch.set_num_threads(2)


class _BasicBlock(nn.Module):
    """torchvision's ``BasicBlock``: names and arithmetic, one in-place ReLU called twice."""

    def __init__(self, in_ch, width, stride):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(in_ch, width, 3, stride, 1, bias=False), nn.BatchNorm2d(width)
        self.conv2, self.bn2 = nn.Conv2d(width, width, 3, 1, 1, bias=False), nn.BatchNorm2d(width)
        self.relu = nn.ReLU(inplace=True)
        if stride != 1 or in_ch != width:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, width, 1, stride, bias=False), nn.BatchNorm2d(width))

    def forward(self, x):
        out = self.bn2(self.conv2(self.relu(self.bn1(self.conv1(x)))))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return self.relu(out + identity)


class _TorchvisionResNet18(nn.Module):
    """A torchvision-layout ResNet-18: its ``state_dict()`` loads into the port's native ``ResNet(18)``."""

    def __init__(self, num_classes):
        super().__init__()
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64)
        self.relu, self.maxpool = nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage in range(1, 5):
            width = 64 * 2 ** (stage - 1)
            blocks = [_BasicBlock(in_ch, width, 2 if stage > 1 else 1), _BasicBlock(width, width, 1)]
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
            in_ch = width
        self.avgpool, self.fc = nn.AdaptiveAvgPool2d(1), nn.Linear(512, num_classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(self.avgpool(x), 1))


class _Pair(nn.Module):
    def forward(self, x):
        return x * 2.0, x + 1.0  # a tuple: taps see its first tensor


class _NoTensor(nn.Module):
    def forward(self, x):
        return [int(x.shape[0])]


class HandBuilt(nn.Module):
    """conv → BN → ReLU, one conv run twice, a tuple output, a tap-only module and an unreached one."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.relu = nn.ReLU()
        self.shared = nn.Conv2d(8, 8, 3, padding=1)
        self.pair = _Pair()
        self.probe = nn.Identity()
        self.head = nn.Linear(8, 5)
        self.unreached = nn.Linear(3, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
            self.bn.running_mean.copy_(torch.randn(8, generator=g) * 0.1)
            self.bn.running_var.copy_(torch.rand(8, generator=g) + 0.5)

    def forward(self, x):
        h = self.relu(self.bn(self.conv(x)))
        h = self.shared(torch.relu(self.shared(h)))  # fires twice: the tap keeps the last
        a, b = self.pair(h)
        self.probe(a.mean(dim=(2, 3)))  # output unused: a tap-only module
        return self.head(b.mean(dim=(2, 3)))


class TapOnly(nn.Module):
    """No tensor output at all: the adapter's output is zeros (B, 1)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.empty = _NoTensor()

    def forward(self, x):
        self.empty(self.conv(x))
        return None


TAPS = ("conv", "bn", "relu", "shared", "pair", "probe", "head")


def _x(shape=(2, 12, 10, 3), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
def test_outputs_and_taps_equal_jax_adapter(channels_last):
    module = HandBuilt()
    x = _x() if channels_last else _x().transpose(0, 3, 1, 2).copy()
    t = TorchSubjectModel(module, channels_last=channels_last, device="cpu")
    j = JAdapter(module, channels_last=channels_last)
    assert t.module_names == j.module_names and "pair" in t.module_names and "" not in t.module_names
    assert t.init() == {} and t.params == {} and t.name == "HandBuilt"
    t_out, t_taps = t.apply({"ignored": 1}, torch.from_numpy(x), TAPS)
    j_out, j_taps = j.apply({}, jnp.asarray(x), TAPS)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    assert t_taps.keys() == set(TAPS)
    for name in TAPS:
        assert t_taps[name].dtype == torch.float32
        np.testing.assert_array_equal(t_taps[name].numpy(), np.asarray(j_taps[name]), err_msg=name)
    if channels_last:
        assert t_taps["conv"].shape == (2, 12, 10, 8)  # NHWC view of an NCHW output
        assert t_taps["conv"].permute(0, 3, 1, 2).is_contiguous()  # a view, not a copy


def test_repeated_module_keeps_last_output_and_taps_are_copies():
    """``shared`` fires twice: its tap is the second call's output. torchvision's in-place ReLU
    after a tapped module does not change the tap (the hook copies)."""
    module = HandBuilt()
    x = torch.from_numpy(_x())
    _, taps = TorchSubjectModel(module, device="cpu").apply({}, x, ("shared", "bn"))
    with torch.no_grad():
        h = module.relu(module.bn(module.conv(x.permute(0, 3, 1, 2))))
        last = module.shared(torch.relu(module.shared(h)))
    np.testing.assert_array_equal(taps["shared"].numpy(), last.permute(0, 2, 3, 1).numpy())
    inplace = nn.Sequential(nn.Conv2d(3, 4, 3), nn.ReLU(inplace=True))
    _, taps = TorchSubjectModel(inplace, device="cpu").apply({}, x, ("0",))
    assert (taps["0"] < 0).any()  # the pre-ReLU conv output, not its in-place rectification


def test_missing_tap_and_non_tensor_output_raise_as_jax():
    t = TorchSubjectModel(HandBuilt(), device="cpu")
    j = JAdapter(HandBuilt())
    x = _x()
    for adapter, arr in ((t, torch.from_numpy(x)), (j, jnp.asarray(x))):
        with pytest.raises(KeyError, match=r"taps \['unreached'\] never fired"):
            adapter.apply({}, arr, ("conv", "unreached"))
    tap_only = TapOnly()
    t2, j2 = TorchSubjectModel(tap_only, device="cpu"), JAdapter(tap_only)
    with pytest.raises(TypeError, match="module 'empty' produced no tensor output to tap"):
        t2.apply({}, torch.from_numpy(x), ("empty",))
    with pytest.raises(Exception, match="module 'empty' produced no tensor output to tap"):
        np.asarray(j2.apply({}, jnp.asarray(x), ("empty",))[0])  # raised through the host callback
    out, taps = t2.apply({}, torch.from_numpy(x), ("conv",))
    j_out, j_taps = j2.apply({}, jnp.asarray(x), ("conv",))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    assert out.shape == (2, 1) and not out.any()
    np.testing.assert_array_equal(taps["conv"].numpy(), np.asarray(j_taps["conv"]))


def test_input_takes_the_module_dtype_and_taps_come_back_float32():
    module = HandBuilt().double()
    x = _x()
    out, taps = TorchSubjectModel(module, device="cpu").apply({}, torch.from_numpy(x), ("bn",))
    j_out, j_taps = JAdapter(module).apply({}, jnp.asarray(x), ("bn",))
    assert out.dtype == taps["bn"].dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(taps["bn"].numpy(), np.asarray(j_taps["bn"]))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSubjectModel(HandBuilt())


def test_actmax_collect_matches_jax():
    """The README collect with the adapter as the subject, in both packages: equal ids, values within
    one bf16 rounding step."""
    images = np.random.default_rng(1).integers(0, 256, size=(11, 20, 24, 3), dtype=np.uint8)
    module = HandBuilt()
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            model, dataset, cv_cls, agg, pre = JAdapter(module, name="hand"), JDataset(images, name="toy"), JCV, j_mean, j_pre
        else:
            model = TorchSubjectModel(module, name="hand", device="cpu")
            dataset, cv_cls, agg, pre = TDataset(images, name="toy"), TCV, t_mean, t_pre
        cv = cv_cls(model=model, dataset_model=dataset, dataset_fm=dataset, layer_names=["relu", "shared"],
                    num_samples=3, aggregate_fn=agg, model_preprocess=pre(size=16))
        cv.run(batch_size=4)
        out[pkg] = {k: (np.asarray(cv.get_max_reference(k)),
                        np.asarray(cv.actmax_cache[k].activations, np.float32) if pkg == "jax"
                        else cv.actmax_cache[k].activations.float().numpy()) for k in ("relu", "shared")}
    for layer in ("relu", "shared"):
        np.testing.assert_array_equal(out["torch"][layer][0], out["jax"][layer][0])
        np.testing.assert_allclose(out["torch"][layer][1], out["jax"][layer][1], rtol=2**-7)


def test_torchvision_resnet18_through_adapter_equals_native_resnet():
    """One state dict, two forwards: the hooked torchvision-layout module and the port's functional ResNet."""
    torch.manual_seed(0)
    module = _TorchvisionResNet18(num_classes=10)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):  # non-trivial statistics
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    native = ResNet(depth=18, num_classes=10, dtype=torch.float32, device="cpu")
    params = native.load_torch_state_dict(module.state_dict())
    adapter = TorchSubjectModel(module, name="resnet18", device="cpu")
    assert set(adapter.module_names) == set(native.module_names)
    x = torch.from_numpy(_x((2, 64, 64, 3), seed=2))
    taps = ("layer1.0.bn2", "layer3", "layer4", "layer4.1.relu", "avgpool")
    a_out, a_taps = adapter.apply({}, x, taps)
    n_out, n_taps = native.apply(params, x, taps)
    np.testing.assert_allclose(a_out.numpy(), n_out.numpy(), atol=1e-4)
    for name in taps:
        assert a_taps[name].shape == n_taps[name].shape, name
        np.testing.assert_allclose(a_taps[name].numpy(), n_taps[name].float().numpy(), atol=1e-4, err_msg=name)
