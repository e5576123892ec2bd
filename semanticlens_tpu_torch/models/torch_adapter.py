"""Any ``torch.nn.Module`` as a tappable subject, running natively on the card.

Counterpart of ``semanticlens_tpu.models.torch_adapter``: the reference's
"bring ANY torch model" promise (hooks on ``named_modules()``, reference
semanticlens/component_visualization/activation_caching.py:266-277). The
JAX package runs the module on the host behind ``jax.pure_callback``; here it
runs where the port runs, on the adapter's ``device``, under
``torch.inference_mode()``, and the taps never leave the device.

Contract (the JAX adapter's):

- ``module_names`` are the non-empty ``named_modules()`` names;
- taps are the hooked modules' outputs; with ``channels_last=True`` the
  (B, H, W, C) input is permuted to a contiguous NCHW tensor for the module
  (as the JAX adapter hands it over), and rank-4 taps come back as
  (B, H, W, C) views (``permute``, no copy), the layout the aggregators
  take. A ``channels_last`` module output (a module converted with
  ``memory_format=torch.channels_last``, which cuDNN prefers) permutes to a
  contiguous view, any other to a strided one;
- a module that runs more than once per forward keeps its last output; a
  non-tensor output is tapped through its first tensor;
- a tap that never fires raises ``KeyError``, a module without a tensor
  output ``TypeError``;
- input is cast to the module's parameter dtype; the output and the taps
  come back in float32, copied when the hook fires, so a later in-place op
  of the module (torchvision's ``ReLU(inplace=True)``) cannot change them;
- ``init`` returns ``{}`` and ``apply`` ignores ``params``: the weights live
  in the module.

An active ``interventions`` context that targets one of the module's names
raises ``NotImplementedError`` naming the targeted modules, as the JAX
adapter does: its host callback cannot feed rewrites back. Here a forward
hook that returns a modified output could rewrite the activation, but the
JAX package refuses instead, and the port adds no capability the JAX
package lacks. The engine sizes its states from the first batch's
aggregates, so the JAX adapter's shape probe ``_result_shapes`` has no
counterpart.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from semanticlens_tpu_torch.models.base import SubjectModel, has_intervention
from semanticlens_tpu_torch.utils.device import resolve_device


def _first_tensor(value):
    """The hookable payload of a module output: the tensor itself, else the first tensor of a tuple/list."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (tuple, list)):
        for item in value:
            if isinstance(item, torch.Tensor):
                return item
    return None


class TorchSubjectModel(SubjectModel):
    """Wrap a ``torch.nn.Module`` (eval mode, weights loaded) as a SubjectModel.

    Parameters
    ----------
    module : the torch module; it is put in ``eval()`` and moved to
        ``device``. For speed on the card, move a convolutional module to
        ``memory_format=torch.channels_last`` first.
    channels_last : if True (default), ``apply`` takes (B, H, W, C) batches,
        permutes them to NCHW for the module, and returns rank-4 taps as
        (B, H, W, C). Set False for models that take the layout you feed.
    name : stable cache-identity name; falls back to the module's class name.
    device : ``None`` → the CUDA card (raises without one), or ``"cpu"``.
    """

    def __init__(self, module: torch.nn.Module, *, channels_last: bool = True, name: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.module = module.eval().to(self.device)
        first_param = next(module.parameters(), None)
        self._in_dtype = first_param.dtype if first_param is not None else torch.float32
        self.channels_last = channels_last
        self.module_names = tuple(n for n, _ in module.named_modules() if n)
        self.params: dict = {}
        self.name = name or type(module).__name__

    def init(self, seed: int = 0) -> dict:
        """Weights live inside the torch module: there is nothing to init."""
        return {}

    def _reject_interventions(self):
        """Silent no-ops would fabricate all-zero causal results, so refuse loudly."""
        targeted = [n for n in self.module_names if has_intervention(n)]
        if targeted:
            raise NotImplementedError(
                f"interventions on TorchSubjectModel modules {targeted} are not "
                "supported (rewrites cannot feed the wrapped module's forward). "
                "Port the subject to a native family for causal analysis."
            )

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, H, W, C) float → (output float32, {name: activation float32}); rank-4 taps NHWC."""
        self._reject_interventions()
        tap_names = tuple(tap_names)
        if self.channels_last and x.ndim == 4:
            x = x.permute(0, 3, 1, 2).contiguous()  # the JAX adapter's NCHW input, in its memory order
        captured: dict[str, torch.Tensor] = {}

        def make_hook(tap_name):
            def hook(_mod, _inputs, output):
                tensor = _first_tensor(output)
                if tensor is None:
                    raise TypeError(f"module '{tap_name}' produced no tensor output to tap")
                captured[tap_name] = tensor.detach().to(torch.float32, copy=True)

            return hook

        modules = dict(self.module.named_modules())
        handles = []
        try:
            for tap_name in tap_names:
                handles.append(modules[tap_name].register_forward_hook(make_hook(tap_name)))
            with torch.inference_mode():
                out = self.module(x.to(self.device, self._in_dtype))
        finally:
            for h in handles:
                h.remove()
        missing = [t for t in tap_names if t not in captured]
        if missing:
            raise KeyError(
                f"taps {missing} never fired — these modules are not reached by this input's forward path"
            )
        out_tensor = _first_tensor(out)
        output = (out_tensor.detach().float() if out_tensor is not None
                  else torch.zeros((x.shape[0], 1), device=self.device))  # tap-only models
        taps = {}
        for t in tap_names:
            v = captured[t]
            taps[t] = v.permute(0, 2, 3, 1) if self.channels_last and v.ndim == 4 else v
        return output, taps

    def __repr__(self):
        return f"TorchSubjectModel({type(self.module).__name__}, n_modules={len(self.module_names)})"
