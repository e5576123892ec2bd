"""Functional torchvision-compatible GoogLeNet and Inception-v3 with named taps.

Counterpart of ``semanticlens_tpu.models.inception``, with the module and
parameter names of torchvision's ``googlenet`` / ``inception_v3``, so their
state dicts load as they are (the train-time ``aux1`` / ``aux2`` /
``AuxLogits`` heads are left out and their keys ignored, as in the JAX
package):

- every conv is a BasicConv2d: bias-free conv, BatchNorm (eps 1e-3) and
  ReLU, tapped at ``.conv``, ``.bn`` and the block's own name;
- GoogLeNet's ``branch3`` is a 3×3 conv (torchvision's Caffe quirk) and
  all its max pools are ``ceil_mode``; Inception-v3's stem and reduction
  pools are not; its ``branch_pool`` average pool counts the padding;
- branches concatenate in torchvision's order, Inception-v3's E blocks
  concatenating their 2a/2b (3a/3b) pairs first;
- ``transform_input`` re-normalises from ImageNet statistics to the
  (0.5, 0.5) ones the torchvision checkpoints were trained with.

Under LRP the concatenations are index maps: autograd splits relevance
into the branches as the JAX package's VJP does.
"""

from __future__ import annotations

import torch

from semanticlens_tpu_torch.models.layers import avg_pool, bn_param_specs, conv2d, global_avg_pool, linear, max_pool
from semanticlens_tpu_torch.models.zoo import ZooModel
from semanticlens_tpu_torch.utils.device import resolve_device

# name -> (in, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj)
_GOOGLENET_BLOCKS = (
    ("inception3a", (192, 64, 96, 128, 16, 32, 32)),
    ("inception3b", (256, 128, 128, 192, 32, 96, 64)),
    ("maxpool3", None),
    ("inception4a", (480, 192, 96, 208, 16, 48, 64)),
    ("inception4b", (512, 160, 112, 224, 24, 64, 64)),
    ("inception4c", (512, 128, 128, 256, 24, 64, 64)),
    ("inception4d", (512, 112, 144, 288, 32, 64, 64)),
    ("inception4e", (528, 256, 160, 320, 32, 128, 128)),
    ("maxpool4", None),
    ("inception5a", (832, 256, 160, 320, 32, 128, 128)),
    ("inception5b", (832, 384, 192, 384, 48, 128, 128)),
)

# Inception-v3's Mixed_* schedule: (name, block kind, c_in, block arg); A: pool_features, C: c7.
_V3_MIXED = (
    ("Mixed_5b", "A", 192, 32),
    ("Mixed_5c", "A", 256, 64),
    ("Mixed_5d", "A", 288, 64),
    ("Mixed_6a", "B", 288, 0),
    ("Mixed_6b", "C", 768, 128),
    ("Mixed_6c", "C", 768, 160),
    ("Mixed_6d", "C", 768, 160),
    ("Mixed_6e", "C", 768, 192),
    ("Mixed_7a", "D", 768, 0),
    ("Mixed_7b", "E", 1280, 0),
    ("Mixed_7c", "E", 2048, 0),
)


def _basic_names(prefix: str) -> list[str]:
    return [prefix, f"{prefix}.conv", f"{prefix}.bn"]


def _basic_specs(prefix: str, c_in: int, c_out: int, k) -> list:
    kh, kw = (k, k) if isinstance(k, int) else k
    return [(f"{prefix}.conv.weight", (kh, kw, c_in, c_out), "conv")] + bn_param_specs(f"{prefix}.bn", c_out)


class _Inception(ZooModel):
    """What both families share: BasicConv2d, the input transform and the JAX package's draw."""

    bn_eps = 1e-3

    def _draw(self, name, shape, kind):
        """Normal(0, 0.01) convs and fc (torchvision's trunc_normal(0.01), untruncated), unit BN."""
        if kind in ("conv", "fc"):
            return "normal", 0.01
        return "const", 1.0 if kind == "bn_w" else 0.0

    def _basic(self, params, x, prefix, tap, *, stride=1, padding=0):
        x = tap(f"{prefix}.conv", conv2d(x, params[f"{prefix}.conv.weight"], stride=stride, padding=padding))
        x = tap(f"{prefix}.bn", self._bn(params, f"{prefix}.bn", x))
        return tap(prefix, torch.relu(x))

    @staticmethod
    def _transform_input(x):
        """torchvision ``_transform_input`` on NCHW, in the activation dtype as the JAX package computes it."""
        scale = torch.tensor([0.229, 0.224, 0.225], dtype=x.dtype, device=x.device) / 0.5
        shift = (torch.tensor([0.485, 0.456, 0.406], dtype=x.dtype, device=x.device) - 0.5) / 0.5
        return x * scale.view(1, 3, 1, 1) + shift.view(1, 3, 1, 1)

    def _head(self, params, x, tap):
        x = tap("avgpool", global_avg_pool(x)).flatten(1)
        x = tap("dropout", x)  # train-time only: identity at inference
        if self.num_classes:
            return tap("fc", linear(x, params["fc.weight"], params["fc.bias"]))
        return x

    def __repr__(self):
        t = ", transform_input=True" if self.transform_input else ""
        return f"{type(self).__name__}(num_classes={self.num_classes}{t})"


class GoogLeNet(_Inception):
    """GoogLeNet (Inception v1, BN flavour) with torchvision-compatible names.

    Parameters
    ----------
    num_classes : classifier width (0 → headless pooled features).
    transform_input : re-normalise ImageNet-normalised inputs to (0.5, 0.5)
        statistics (torchvision's pretrained constructors pass True).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    def __init__(self, num_classes: int = 1000, *, transform_input: bool = False, dtype=torch.bfloat16, device=None):
        self.num_classes = num_classes
        self.transform_input = transform_input
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_features = 1024
        self.module_names = tuple(self._enumerate_module_names())

    def _enumerate_module_names(self):
        names = _basic_names("conv1") + ["maxpool1"] + _basic_names("conv2") + _basic_names("conv3") + ["maxpool2"]
        for name, cfg in _GOOGLENET_BLOCKS:
            names.append(name)
            if cfg is None:
                continue
            names += [f"{name}.branch1"] + _basic_names(f"{name}.branch1")[1:]
            for b in ("branch2", "branch3"):
                names.append(f"{name}.{b}")
                for i in range(2):
                    names += _basic_names(f"{name}.{b}.{i}")
            names += [f"{name}.branch4", f"{name}.branch4.0"] + _basic_names(f"{name}.branch4.1")
        return names + ["avgpool", "dropout"] + (["fc"] if self.num_classes else [])

    def _param_specs(self):
        specs = _basic_specs("conv1", 3, 64, 7) + _basic_specs("conv2", 64, 64, 1) + _basic_specs("conv3", 64, 192, 3)
        for name, cfg in _GOOGLENET_BLOCKS:
            if cfg is None:
                continue
            c_in, c1, c3r, c3, c5r, c5, cp = cfg
            specs += _basic_specs(f"{name}.branch1", c_in, c1, 1)
            specs += _basic_specs(f"{name}.branch2.0", c_in, c3r, 1)
            specs += _basic_specs(f"{name}.branch2.1", c3r, c3, 3)
            specs += _basic_specs(f"{name}.branch3.0", c_in, c5r, 1)
            specs += _basic_specs(f"{name}.branch3.1", c5r, c5, 3)  # 3×3: the torchvision quirk
            specs += _basic_specs(f"{name}.branch4.1", c_in, cp, 1)
        if self.num_classes:
            specs += [("fc.weight", (1024, self.num_classes), "fc"), ("fc.bias", (self.num_classes,), "zeros")]
        return specs

    def _inception(self, params, x, name, tap):
        b1 = tap(f"{name}.branch1", self._basic(params, x, f"{name}.branch1", tap))
        b2 = self._basic(params, x, f"{name}.branch2.0", tap)
        b2 = tap(f"{name}.branch2", self._basic(params, b2, f"{name}.branch2.1", tap, padding=1))
        b3 = self._basic(params, x, f"{name}.branch3.0", tap)
        b3 = tap(f"{name}.branch3", self._basic(params, b3, f"{name}.branch3.1", tap, padding=1))
        b4 = tap(f"{name}.branch4.0", max_pool(x, window=3, stride=1, padding=1, ceil_mode=True))
        b4 = tap(f"{name}.branch4", self._basic(params, b4, f"{name}.branch4.1", tap))
        return tap(name, torch.cat([b1, b2, b3, b4], 1))

    def _forward(self, params, x, tap):
        if self.transform_input:
            x = self._transform_input(x)
        x = self._basic(params, x, "conv1", tap, stride=2, padding=3)
        x = tap("maxpool1", max_pool(x, window=3, stride=2, padding=0, ceil_mode=True))
        x = self._basic(params, x, "conv2", tap)
        x = self._basic(params, x, "conv3", tap, padding=1)
        x = tap("maxpool2", max_pool(x, window=3, stride=2, padding=0, ceil_mode=True))
        for name, cfg in _GOOGLENET_BLOCKS:
            if cfg is None:
                x = tap(name, max_pool(x, window=3 if name == "maxpool3" else 2, stride=2, padding=0, ceil_mode=True))
            else:
                x = self._inception(params, x, name, tap)
        return self._head(params, x, tap)


class InceptionV3(_Inception):
    """Inception-v3 with torchvision-compatible names (no ``AuxLogits`` head).

    Parameters
    ----------
    num_classes : classifier width (0 → headless pooled features).
    transform_input : re-normalise ImageNet-normalised inputs to (0.5, 0.5)
        statistics (torchvision's pretrained constructors pass True).
    dtype : activation dtype (bfloat16 by default).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    # (name, c_in, c_out, kernel, padding, stride); None rows are the max pools
    _STEM = (
        ("Conv2d_1a_3x3", 3, 32, 3, 0, 2),
        ("Conv2d_2a_3x3", 32, 32, 3, 0, 1),
        ("Conv2d_2b_3x3", 32, 64, 3, 1, 1),
        ("maxpool1", None, None, None, None, None),
        ("Conv2d_3b_1x1", 64, 80, 1, 0, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 0, 1),
        ("maxpool2", None, None, None, None, None),
    )

    def __init__(self, num_classes: int = 1000, *, transform_input: bool = False, dtype=torch.bfloat16, device=None):
        self.num_classes = num_classes
        self.transform_input = transform_input
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_features = 2048
        self.module_names = tuple(self._conv_specs_and_names()[1]) + ("avgpool", "dropout") + (
            ("fc",) if num_classes else ())

    @staticmethod
    def _block_convs(kind: str, c_in: int, arg: int):
        """``[(branch, [(conv suffix, c_in, c_out, kernel, padding, stride), ...]), ...]`` of one Mixed block."""
        if kind == "A":
            return [
                ("branch1x1", [("branch1x1", c_in, 64, 1, 0, 1)]),
                ("branch5x5", [("branch5x5_1", c_in, 48, 1, 0, 1), ("branch5x5_2", 48, 64, 5, 2, 1)]),
                ("branch3x3dbl", [("branch3x3dbl_1", c_in, 64, 1, 0, 1), ("branch3x3dbl_2", 64, 96, 3, 1, 1),
                                  ("branch3x3dbl_3", 96, 96, 3, 1, 1)]),
                ("branch_pool", [("branch_pool", c_in, arg, 1, 0, 1)]),
            ]
        if kind == "B":
            return [
                ("branch3x3", [("branch3x3", c_in, 384, 3, 0, 2)]),
                ("branch3x3dbl", [("branch3x3dbl_1", c_in, 64, 1, 0, 1), ("branch3x3dbl_2", 64, 96, 3, 1, 1),
                                  ("branch3x3dbl_3", 96, 96, 3, 0, 2)]),
            ]
        if kind == "C":
            c7 = arg
            return [
                ("branch1x1", [("branch1x1", c_in, 192, 1, 0, 1)]),
                ("branch7x7", [("branch7x7_1", c_in, c7, 1, 0, 1), ("branch7x7_2", c7, c7, (1, 7), (0, 3), 1),
                               ("branch7x7_3", c7, 192, (7, 1), (3, 0), 1)]),
                ("branch7x7dbl", [("branch7x7dbl_1", c_in, c7, 1, 0, 1),
                                  ("branch7x7dbl_2", c7, c7, (7, 1), (3, 0), 1),
                                  ("branch7x7dbl_3", c7, c7, (1, 7), (0, 3), 1),
                                  ("branch7x7dbl_4", c7, c7, (7, 1), (3, 0), 1),
                                  ("branch7x7dbl_5", c7, 192, (1, 7), (0, 3), 1)]),
                ("branch_pool", [("branch_pool", c_in, 192, 1, 0, 1)]),
            ]
        if kind == "D":
            return [
                ("branch3x3", [("branch3x3_1", c_in, 192, 1, 0, 1), ("branch3x3_2", 192, 320, 3, 0, 2)]),
                ("branch7x7x3", [("branch7x7x3_1", c_in, 192, 1, 0, 1), ("branch7x7x3_2", 192, 192, (1, 7), (0, 3), 1),
                                 ("branch7x7x3_3", 192, 192, (7, 1), (3, 0), 1),
                                 ("branch7x7x3_4", 192, 192, 3, 0, 2)]),
            ]
        # E: the 2a/2b (and 3a/3b) pairs both consume their parent conv.
        return [
            ("branch1x1", [("branch1x1", c_in, 320, 1, 0, 1)]),
            ("branch3x3", [("branch3x3_1", c_in, 384, 1, 0, 1), ("branch3x3_2a", 384, 384, (1, 3), (0, 1), 1),
                           ("branch3x3_2b", 384, 384, (3, 1), (1, 0), 1)]),
            ("branch3x3dbl", [("branch3x3dbl_1", c_in, 448, 1, 0, 1), ("branch3x3dbl_2", 448, 384, 3, 1, 1),
                              ("branch3x3dbl_3a", 384, 384, (1, 3), (0, 1), 1),
                              ("branch3x3dbl_3b", 384, 384, (3, 1), (1, 0), 1)]),
            ("branch_pool", [("branch_pool", c_in, 192, 1, 0, 1)]),
        ]

    def _conv_specs_and_names(self):
        """``(param specs, module names)`` of the stem and every Mixed block, in the JAX package's order."""
        specs, names = [], []
        for name, cin, cout, k, _pad, _stride in self._STEM:
            if cin is None:
                names.append(name)
            else:
                specs += _basic_specs(name, cin, cout, k)
                names += _basic_names(name)
        for name, kind, c_in, arg in _V3_MIXED:
            names.append(name)
            for _branch, convs in self._block_convs(kind, c_in, arg):
                for suffix, cin, cout, k, _pad, _stride in convs:
                    specs += _basic_specs(f"{name}.{suffix}", cin, cout, k)
                    names += _basic_names(f"{name}.{suffix}")
        if self.num_classes:
            specs += [("fc.weight", (2048, self.num_classes), "fc"), ("fc.bias", (self.num_classes,), "zeros")]
        return specs, names

    def _param_specs(self):
        return self._conv_specs_and_names()[0]

    def _chain(self, params, x, name, convs, tap):
        for suffix, _cin, _cout, _k, pad, stride in convs:
            x = self._basic(params, x, f"{name}.{suffix}", tap, stride=stride, padding=pad)
        return x

    def _mixed(self, params, x, name, kind, c_in, arg, tap):
        br = dict(self._block_convs(kind, c_in, arg))
        if kind == "B":
            outs = [self._chain(params, x, name, br["branch3x3"], tap),
                    self._chain(params, x, name, br["branch3x3dbl"], tap), max_pool(x, window=3, stride=2, padding=0)]
        elif kind == "D":
            outs = [self._chain(params, x, name, br["branch3x3"], tap),
                    self._chain(params, x, name, br["branch7x7x3"], tap), max_pool(x, window=3, stride=2, padding=0)]
        else:
            outs = [self._chain(params, x, name, br["branch1x1"], tap)]
            if kind == "A":
                outs += [self._chain(params, x, name, br[b], tap) for b in ("branch5x5", "branch3x3dbl")]
            elif kind == "C":
                outs += [self._chain(params, x, name, br[b], tap) for b in ("branch7x7", "branch7x7dbl")]
            else:  # E
                for b, n_parent in (("branch3x3", 1), ("branch3x3dbl", 2)):
                    h = self._chain(params, x, name, br[b][:n_parent], tap)
                    outs.append(torch.cat([self._chain(params, h, name, [conv], tap) for conv in br[b][n_parent:]], 1))
            pooled = avg_pool(x, window=3, stride=1, padding=1)
            outs.append(self._chain(params, pooled, name, br["branch_pool"], tap))
        return tap(name, torch.cat(outs, 1))

    def _forward(self, params, x, tap):
        if self.transform_input:
            x = self._transform_input(x)
        for name, cin, _cout, _k, pad, stride in self._STEM:
            if cin is None:
                x = tap(name, max_pool(x, window=3, stride=2, padding=0))
            else:
                x = self._basic(params, x, name, tap, stride=stride, padding=pad)
        for name, kind, c_in, arg in _V3_MIXED:
            x = self._mixed(params, x, name, kind, c_in, arg, tap)
        return self._head(params, x, tap)
