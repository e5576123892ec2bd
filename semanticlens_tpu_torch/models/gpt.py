"""GPT-2 causal language model with named activation taps, and what the port's LM subjects share.

Counterpart of ``semanticlens_tpu.models.gpt``. Module and parameter names
follow Hugging Face ``GPT2LMHeadModel`` (``transformer.h.3.mlp.c_fc`` …).
Parameters are in the port's layout, linear weights (out, in): HF's
``Conv1D`` stores (in, out), as the JAX package does, so
:meth:`GPT2.load_torch_state_dict` transposes them.

Input is a (B, T) integer token batch; token taps are (B, T, C). With
``pad_id`` set, leading and trailing runs of that id are masked out of
attention and positions count real tokens only, so a left-padded row gives
the unpadded activations at its real positions. Each block's virtual
``…attn.heads`` tap is the norm of each head's residual-stream contribution
(``layers.attn_out_projection``); an intervention on it rescales the heads.
The tied head is ``linear(h, wte)``: the (V, D) embedding matrix is the
(out, in) weight.

:class:`TokenLM` holds what every LM family of the port shares: random
weights drawn in the JAX package's layout from a numpy seed (so one seed
gives both packages the same weights), or drawn on the model's device from
a ``torch.Generator`` for full-width runs on the card, where the numpy draw
of a billion weights takes tens of seconds; placement (matrices in the
compute dtype, vectors in float32) and the token input.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from semanticlens_tpu_torch import convert
from semanticlens_tpu_torch.models.base import SubjectModel, TapCollector
from semanticlens_tpu_torch.models.layers import (
    attn_out_projection,
    edge_pad_mask,
    gelu,
    layer_norm,
    linear,
    residual_add,
    scaled_dot_product_attention,
)
from semanticlens_tpu_torch.utils.device import resolve_device


def pad_positions(ids, pad_id: int):
    """``(is_pad, position ids)``: positions count real tokens, ``cumsum(~is_pad) − 1`` clipped at 0."""
    is_pad = edge_pad_mask(ids, pad_id)
    return is_pad, torch.clamp(torch.cumsum(~is_pad, dim=1) - 1, min=0)


def additive_mask(allowed, is_pad=None):
    """float32 additive mask from a (T, T) bool ``allowed``: (T, T), or (B, 1, T, T) with edge pads.

    Pad keys are dropped; each position keeps itself, so no softmax row is empty.
    """
    if is_pad is not None:
        t = allowed.shape[-1]
        eye = torch.eye(t, dtype=torch.bool, device=allowed.device)
        allowed = (allowed[None] & (~is_pad[:, None, :] | eye[None]))[:, None]
    return torch.zeros(allowed.shape, dtype=torch.float32, device=allowed.device).masked_fill(~allowed, -math.inf)


class TokenLM(SubjectModel):
    """Weights, placement and token input shared by the port's LM subjects.

    Subclasses define ``_param_specs()`` (name, JAX-layout shape, init kind),
    ``_init_std(kind)`` and ``apply``; they set ``dtype`` and ``device``.
    """

    def _param_specs(self):
        raise NotImplementedError

    def _init_std(self, kind: str) -> float:
        raise NotImplementedError

    def _torch_shape(self, name: str, shape: tuple) -> tuple:
        return tuple(shape[::-1]) if len(shape) == 2 and name not in convert.LM_EMBEDDINGS else tuple(shape)

    def init_jax_layout(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Random float32 numpy weights in the JAX package's layout from ``seed``: the JAX
        scheme (unit or zero norms, zero biases, normal matrices) drawn from ``np.random``."""
        rng = np.random.default_rng(seed)
        params = {}
        for name, shape, kind in self._param_specs():
            if kind == "ones":
                params[name] = np.ones(shape, np.float32)
            elif kind == "zeros":
                params[name] = np.zeros(shape, np.float32)
            else:
                params[name] = rng.standard_normal(shape, np.float32) * np.float32(self._init_std(kind))
        return params

    def init(self, seed: int = 0, *, device_draw: bool = False) -> dict[str, torch.Tensor]:
        """Random weights from ``seed``, placed on the model's device.

        ``device_draw=True`` draws them on that device from a
        ``torch.Generator`` (the same scheme, another stream): the numpy draw
        of a billion-weight model takes tens of seconds on a host.
        """
        if not device_draw:
            return self.load_jax_params(self.init_jax_layout(seed))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = {}
        for name, shape, kind in self._param_specs():
            shape = self._torch_shape(name, shape)
            dtype = self.dtype if len(shape) >= 2 else torch.float32
            if kind == "ones":
                params[name] = torch.ones(shape, dtype=dtype, device=self.device)
            elif kind == "zeros":
                params[name] = torch.zeros(shape, dtype=dtype, device=self.device)
            else:
                w = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
                params[name] = w.mul_(self._init_std(kind)).to(dtype)
        return params

    def load_jax_params(self, params: Mapping) -> dict[str, torch.Tensor]:
        """Weights in the JAX package's layout → the port's, placed for the forward."""
        return self._place(convert.lm_params_from_jax(params))

    def _place(self, state_dict: Mapping, *, partial: bool = False) -> dict[str, torch.Tensor]:
        """Port-layout weights, shape-checked; matrices (and stacked experts' matrices) to the compute dtype,
        vectors float32. ``partial``: only the tensors given (a load in parts)."""
        out = {}
        for name, shape, _ in self._param_specs():
            if name not in state_dict:
                if partial:
                    continue
                raise KeyError(f"{name} missing from state dict")
            t = torch.as_tensor(state_dict[name])
            expected = self._torch_shape(name, shape)
            if tuple(t.shape) != expected:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {expected}")
            out[name] = t.to(self.device, self.dtype if t.ndim >= 2 else torch.float32)
        return out

    def _ids(self, x) -> torch.Tensor:
        """(B, T) integer tokens on the model's device (int64, the embedding gather's index)."""
        ids = torch.as_tensor(x).to(self.device, torch.long)
        if ids.ndim != 2:
            raise ValueError(f"tokens must be (B, T), got {tuple(ids.shape)}")
        if ids.shape[1] > self.n_positions:
            raise ValueError(f"sequence length {ids.shape[1]} exceeds n_positions {self.n_positions}")
        return ids


class GPT2(TokenLM):
    """GPT-2 causal LM, HF names, (B, T) integer tokens.

    Parameters
    ----------
    vocab_size, n_positions, width, depth, heads : HF ``gpt2`` by default.
    dtype : activation dtype (bfloat16 by default).
    pad_id : edge-padding token id, or None (see the module docstring).
    device : ``None`` → the CUDA card (raises without one); ``"cpu"`` for the CPU.
    """

    LN_EPS = 1e-5  # HF GPT2Config.layer_norm_epsilon

    # HF zoo: name → (width, depth, heads)
    _HF_VARIANTS = {
        "gpt2": (768, 12, 12),
        "gpt2-medium": (1024, 24, 16),
        "gpt2-large": (1280, 36, 20),
        "gpt2-xl": (1600, 48, 25),
    }

    def __init__(self, vocab_size: int = 50257, n_positions: int = 1024, width: int = 768, depth: int = 12,
                 heads: int = 12, dtype=torch.bfloat16, pad_id: int | None = None, device=None):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.width = width
        self.depth = depth
        self.heads = heads
        self.dtype = dtype
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.module_names = tuple(self._enumerate_module_names())

    @classmethod
    def from_name(cls, name: str, *, dtype=torch.bfloat16, pad_id: int | None = None, device=None):
        """An HF-zoo-sized GPT-2 (``gpt2`` … ``gpt2-xl``)."""
        if name not in cls._HF_VARIANTS:
            raise ValueError(f"name must be one of {sorted(cls._HF_VARIANTS)}, got {name!r}")
        w, d, h = cls._HF_VARIANTS[name]
        return cls(width=w, depth=d, heads=h, dtype=dtype, pad_id=pad_id, device=device)

    def _enumerate_module_names(self):
        names = ["transformer", "transformer.wte", "transformer.wpe", "transformer.h"]
        for i in range(self.depth):
            p = f"transformer.h.{i}"
            names += [p, f"{p}.ln_1", f"{p}.attn", f"{p}.attn.c_attn", f"{p}.attn.heads", f"{p}.attn.c_proj",
                      f"{p}.ln_2", f"{p}.mlp", f"{p}.mlp.c_fc", f"{p}.mlp.act", f"{p}.mlp.c_proj"]
        return names + ["transformer.ln_f", "lm_head"]

    def _param_specs(self):
        """(name, shape, kind) in the JAX package's (and HF ``Conv1D``'s) layout."""
        w = self.width
        specs = [
            ("transformer.wte.weight", (self.vocab_size, w), "embed"),
            ("transformer.wpe.weight", (self.n_positions, w), "embed"),
        ]
        for i in range(self.depth):
            p = f"transformer.h.{i}"
            specs += [
                (f"{p}.ln_1.weight", (w,), "ones"),
                (f"{p}.ln_1.bias", (w,), "zeros"),
                (f"{p}.attn.c_attn.weight", (w, 3 * w), "conv1d"),
                (f"{p}.attn.c_attn.bias", (3 * w,), "zeros"),
                (f"{p}.attn.c_proj.weight", (w, w), "conv1d_resid"),
                (f"{p}.attn.c_proj.bias", (w,), "zeros"),
                (f"{p}.ln_2.weight", (w,), "ones"),
                (f"{p}.ln_2.bias", (w,), "zeros"),
                (f"{p}.mlp.c_fc.weight", (w, 4 * w), "conv1d"),
                (f"{p}.mlp.c_fc.bias", (4 * w,), "zeros"),
                (f"{p}.mlp.c_proj.weight", (4 * w, w), "conv1d_resid"),
                (f"{p}.mlp.c_proj.bias", (w,), "zeros"),
            ]
        return specs + [("transformer.ln_f.weight", (w,), "ones"), ("transformer.ln_f.bias", (w,), "zeros")]

    def _init_std(self, kind: str) -> float:
        """HF GPT-2 init: N(0, 0.02), residual projections scaled by 1/sqrt(2·depth)."""
        return 0.02 * (1.0 / math.sqrt(2 * self.depth) if kind == "conv1d_resid" else 1.0)

    def apply(self, params: Mapping, x, tap_names: Sequence[str] = ()):
        """(B, T) int tokens → (logits (B, T, V), taps). Token taps (B, T, D)."""
        tap = TapCollector(tap_names)
        ids = self._ids(x)
        b, t = ids.shape
        wte = params["transformer.wte.weight"]
        tok = tap("transformer.wte", F.embedding(ids, wte))
        wpe = params["transformer.wpe.weight"]
        causal = torch.ones((t, t), dtype=torch.bool, device=ids.device).tril()
        if self.pad_id is not None:
            is_pad, pos_ids = pad_positions(ids, self.pad_id)
            pos_b = tap("transformer.wpe", F.embedding(pos_ids, wpe))
            mask = additive_mask(causal, is_pad)
        else:
            pos_b = tap("transformer.wpe", wpe[:t][None].expand(b, t, self.width))
            mask = additive_mask(causal)
        h = tok + pos_b

        w = self.width
        for i in range(self.depth):
            p = f"transformer.h.{i}"
            n1 = tap(f"{p}.ln_1", layer_norm(h, params[f"{p}.ln_1.weight"], params[f"{p}.ln_1.bias"],
                                             eps=self.LN_EPS))
            qkv = tap(f"{p}.attn.c_attn", linear(n1, params[f"{p}.attn.c_attn.weight"],
                                                 params[f"{p}.attn.c_attn.bias"]))
            a = scaled_dot_product_attention(qkv[..., :w], qkv[..., w : 2 * w], qkv[..., 2 * w :], self.heads,
                                             mask=mask)
            a = attn_out_projection(tap, f"{p}.attn.heads", f"{p}.attn.c_proj", a,
                                    params[f"{p}.attn.c_proj.weight"], params[f"{p}.attn.c_proj.bias"], self.heads)
            a = tap(f"{p}.attn", a)
            h = residual_add(h, a)
            n2 = tap(f"{p}.ln_2", layer_norm(h, params[f"{p}.ln_2.weight"], params[f"{p}.ln_2.bias"],
                                             eps=self.LN_EPS))
            m = tap(f"{p}.mlp.c_fc", linear(n2, params[f"{p}.mlp.c_fc.weight"], params[f"{p}.mlp.c_fc.bias"]))
            m = tap(f"{p}.mlp.act", gelu(m, approximate=True))  # HF gelu_new
            m = tap(f"{p}.mlp.c_proj", linear(m, params[f"{p}.mlp.c_proj.weight"], params[f"{p}.mlp.c_proj.bias"]))
            m = tap(f"{p}.mlp", m)
            h = residual_add(h, m)
            h = tap(p, h)
        h = tap("transformer.h", h)
        h = tap("transformer.ln_f", layer_norm(h, params["transformer.ln_f.weight"], params["transformer.ln_f.bias"],
                                               eps=self.LN_EPS))
        h = tap("transformer", h)
        logits = tap("lm_head", linear(h, wte))  # tied: the (V, D) embedding is the (out, in) weight
        return logits, tap.taps

    def load_torch_state_dict(self, state_dict: Mapping) -> dict[str, torch.Tensor]:
        """An HF GPT-2 state dict (``GPT2LMHeadModel`` keys, or bare ``GPT2Model`` keys), placed.

        ``Conv1D`` weights are (in, out) there and transpose to (out, in);
        ``lm_head.weight`` (tied) and the mask buffers are ignored.
        """
        picked = {}
        for name, _, _ in self._param_specs():
            bare = name.removeprefix("transformer.")
            if name in state_dict:
                picked[name] = state_dict[name]
            elif bare in state_dict:
                picked[name] = state_dict[bare]
            else:
                raise KeyError(f"{name} (also tried {bare!r}) missing from state dict")
        return self.load_jax_params(picked)

    def __repr__(self):
        return (f"GPT2(vocab_size={self.vocab_size}, n_positions={self.n_positions}, "
                f"width={self.width}, depth={self.depth}, heads={self.heads})")
