"""Functional forward primitives (counterpart of ``semanticlens_tpu.models.layers``).

Everything is a plain function of tensors and a flat parameter dict with
torch names, like the JAX package — but in torch's own layouts: activations
NCHW (channels_last memory on the card, which cuDNN prefers), conv weights
OIHW, linear weights (out, in). ``convert.py`` relayouts the JAX package's
HWIO / (in, out) parameters into these.

Dtype policy follows the JAX package: convs and matmuls run in the
activation dtype (bf16 on the card, float32 accumulation inside
cuDNN/cuBLAS); normalisation statistics are computed in float32 and cast
back.

LRP (layer-wise relevance propagation): inside :func:`lrp_composite` the
linear primitives attach modified backwards (ε, z⁺, flat) as
``torch.autograd.Function`` s whose forward is the plain forward, and the
transformer ops carry the rules of Ali et al. 2022 (detached-denominator
LayerNorm, CP-LRP attention, pass-through GELU, proportional residual
split) — the JAX package's ``jax.custom_vjp`` rules, rule for rule. Each
rule and its ε are fixed when the forward runs: autograd runs CUDA
backwards on threads of its own, which never see the composite.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from semanticlens_tpu_torch.ops.quant import QuantizedTensor, col_slice, dequantize, int8_conv, int8_matmul

# --------------------------------------------------------------------------- #
# LRP context
# --------------------------------------------------------------------------- #
_LRP = threading.local()


@contextmanager
def lrp_composite(name: str = "epsilon_plus_flat", epsilon: float = 1e-6):
    """Activate an LRP composite for every layer whose forward runs inside the context.

    Composites:
    - ``"epsilon_plus_flat"`` (zennit's EpsilonPlusFlat): first conv or
      dense → flat rule, other convs → z⁺ rule, dense/affine → ε rule.
    - ``"epsilon"``: ε rule everywhere.
    - ``"gradient"``: plain gradient (no modified backward).

    Both non-gradient composites also carry the transformer rules:
    detached-denominator LayerNorm, CP-LRP attention, GELU pass-through and
    the proportional residual split.
    """
    _LRP.composite = name
    _LRP.epsilon = epsilon
    _LRP.n_linear_seen = 0
    try:
        yield
    finally:
        _LRP.composite = None


def _lrp_active() -> bool:
    return getattr(_LRP, "composite", None) not in (None, "gradient")


def _next_rule(kind: str) -> tuple[str, float]:
    """The rule for the next linear op whose forward runs under the composite."""
    comp = _LRP.composite
    eps = _LRP.epsilon
    idx = _LRP.n_linear_seen
    _LRP.n_linear_seen += 1
    if comp == "epsilon":
        return "epsilon", eps
    if idx == 0:
        return "flat", eps
    if kind == "conv":
        return "zplus", eps
    return "epsilon", eps


def _stabilised(z, eps: float):
    """``z + ε·sign(z) + ε·[z = 0]`` (the JAX rules' ε denominator), bit for bit, in fewer passes.

    ε is rounded to ``z.dtype`` first, as the JAX package's weakly typed ε
    is, so ``where(z ≥ 0, z + ε, z − ε)`` gives the same values, zeros and
    −0 included.
    """
    e = float(torch.tensor(eps, dtype=z.dtype))
    return torch.where(z >= 0, z + e, z - e)


def _autograd_vjp(f):
    """``(s, x) → fᵀ(s)``, the VJP of ``f`` at ``x`` by autograd."""

    def vjp(s, x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (c,) = torch.autograd.grad(f(xx), xx, s)
        return c

    return vjp


class _LrpRule(torch.autograd.Function):
    """Forward ``true_fwd(x)``; backward the ε, z⁺ or flat rule fixed at forward time."""

    @staticmethod
    def forward(ctx, x, true_fwd, rule, eps, rule_fwd, rule_vjp):
        z = true_fwd(x)
        ctx.rule, ctx.eps, ctx.rule_fwd, ctx.rule_vjp = rule, eps, rule_fwd, rule_vjp
        if rule == "epsilon":
            ctx.save_for_backward(x, z)  # z is what the JAX rule recomputes: one conv less
        else:
            ctx.save_for_backward(x)
        return z

    @staticmethod
    def backward(ctx, R):
        eps = ctx.eps
        if ctx.rule == "zplus":
            (x,) = ctx.saved_tensors
            s = R / (ctx.rule_fwd(x) + eps)
            return x * ctx.rule_vjp(s, x), None, None, None, None, None
        if ctx.rule == "flat":
            (x,) = ctx.saved_tensors
            ones = torch.ones_like(x)
            s = R / (ctx.rule_fwd(ones) + eps)
            return ctx.rule_vjp(s, ones), None, None, None, None, None
        x, z = ctx.saved_tensors
        return x * ctx.rule_vjp(R / _stabilised(z, eps), x), None, None, None, None, None


def _lrp_wrap(true_fwd, x, rule: str, eps: float, rule_fwd=None, rule_vjp=None):
    """Attach an LRP backward to a linear(ish) forward.

    ``true_fwd`` computes the real output; the backward redistributes the
    incoming relevance R by the chosen rule, with ``rule_fwd`` the rule's
    linear map (z⁺: positive weights, flat: unit weights, both without
    bias; ε: ``true_fwd``) and ``rule_vjp(s, x)`` its transpose (autograd's
    VJP of ``rule_fwd`` when not given):

    - ε:     R_x = x ⊙ fᵀ(R / (f(x) + ε·sign(f(x)) + ε·[f(x) = 0]))
    - z⁺:    R_x = x ⊙ f₊ᵀ(R / (f₊(x) + ε))
    - flat:  R_x = f₁ᵀ(R / (f₁(1) + ε))
    """
    rule_fwd = true_fwd if rule_fwd is None else rule_fwd
    rule_vjp = _autograd_vjp(rule_fwd) if rule_vjp is None else rule_vjp
    return _LrpRule.apply(x, true_fwd, rule, eps, rule_fwd, rule_vjp)


class _PassThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, R):
        return R, None


def _lrp_passthrough(fn, x):
    """Identity-relevance activation (zennit's ``Pass`` rule).

    Between two ε-wrapped linears an elementwise nonlinearity hands
    relevance through unchanged; autograd's ``fn'(x)·R`` would de-conserve
    it for any activation whose derivative is not {0, 1} (GELU, sigmoid).
    ReLU needs no wrap: its mask zeroes only coordinates whose relevance is
    already zero under ε/z⁺.
    """
    return _PassThrough.apply(x, fn)


class _ResidualSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, eps):
        z = a + b
        ctx.eps = eps
        ctx.save_for_backward(a, b, z)
        return z

    @staticmethod
    def backward(ctx, R):
        a, b, z = ctx.saved_tensors
        share = R / _stabilised(z, ctx.eps)
        return a * share, b * share, None


def residual_add(x, h):
    """``x + h`` whose LRP backward splits relevance proportionally.

    A bare ``+`` duplicates the cotangent into both branches, which under
    LRP double-counts. Under a composite: R_x = R·x/(x+h), R_h = R·h/(x+h),
    stabilised like the ε rule. Outside a composite it is exactly ``x + h``.
    """
    if not _lrp_active():
        return x + h
    return _ResidualSplit.apply(x, h, _LRP.epsilon)


def conv2d(x, weight, bias=None, *, stride=1, padding=0, groups=1):
    """2-D convolution: NCHW input, OIHW weight, torch-style int padding.

    Under a composite: the flat, z⁺ or ε rule (:func:`_next_rule`), whose
    transpose is cuDNN's backward-data convolution with the rule's weights.

    An int8 :class:`~semanticlens_tpu_torch.ops.quant.QuantizedTensor`
    weight runs :func:`~semanticlens_tpu_torch.ops.quant.int8_conv`
    (per-sample activation scales), the bias added in the output dtype;
    under a composite it is dequantized and the float rules apply.
    """
    if isinstance(weight, QuantizedTensor):
        if _lrp_active():
            weight = dequantize(weight)
        else:
            out = int8_conv(_local(x), weight, stride=stride, padding=padding, groups=groups)
            return out if bias is None else out + bias.to(out.dtype).view(1, -1, 1, 1)
    w = weight.to(x.dtype)

    def conv(xx, ww):
        return F.conv2d(xx, ww, None, stride=stride, padding=padding, groups=groups)

    def true_fwd(xx):
        out = conv(xx, w)
        return out if bias is None else out + bias.to(out.dtype).view(1, -1, 1, 1)

    if not _lrp_active():
        return true_fwd(x)
    rule, eps = _next_rule("conv")
    if rule == "zplus":
        w_rule = w.clamp(min=0)
    elif rule == "flat":
        w_rule = torch.ones_like(w)
    else:
        w_rule = w

    def rule_vjp(s, xx):
        # Backward-data against the real input, whose channels_last layout cuDNN then keeps
        # (``torch.nn.grad.conv2d_input`` passes a stand-in and gets NCHW back for 1×1 convs).
        return torch.ops.aten.convolution_backward(
            s, xx, w_rule, None, _pair(stride), _pair(padding), (1, 1), False, (0, 0), groups,
            (True, False, False))[0]

    return _lrp_wrap(true_fwd, x, rule, eps, rule_fwd=lambda xx: conv(xx, w_rule), rule_vjp=rule_vjp)


def batch_norm(x, weight, bias, running_mean, running_var, *, eps=1e-5):
    """Inference-mode batch norm over the channel axis (dim 1) of NCHW ``x``.

    One fused pass (``F.batch_norm``: statistics and affine in float32, one
    rounding to ``x.dtype``). The JAX package rounds scale and shift to
    ``x.dtype`` and rounds again after the multiply; in bf16 the two differ
    by at most one rounding step, in float32 only in the last bits. Written
    as ``x * scale + shift`` the fold takes two broadcast passes, which run
    at a fraction of the memory rate on channels_last tensors (PERF.md).

    Under a composite it is the JAX package's form, ``x·scale + shift`` with
    scale and shift rounded to ``x.dtype``, carrying the ε rule, so
    heatmaps see the JAX forward.
    """
    if _lrp_active():
        inv = torch.rsqrt(running_var.float() + eps)
        scale = (weight.float() * inv).to(x.dtype).view(1, -1, 1, 1)
        shift = (bias.float() - running_mean.float() * weight.float() * inv).to(x.dtype).view(1, -1, 1, 1)
        return _lrp_wrap(lambda xx: xx * scale + shift, x, "epsilon", _LRP.epsilon,
                         rule_vjp=lambda s, xx: s * scale)
    return F.batch_norm(x, running_mean.float(), running_var.float(), weight.float(), bias.float(),
                        training=False, eps=eps)


def linear(x, weight, bias=None):
    """Dense layer; ``weight`` is torch's (out, in). Under a composite: flat or ε rule.

    An int8 :class:`~semanticlens_tpu_torch.ops.quant.QuantizedTensor`
    weight runs :func:`~semanticlens_tpu_torch.ops.quant.int8_matmul`
    (per-row activation scales), the bias added in the output dtype; under
    a composite it is dequantized and the float rules apply.
    """
    if isinstance(weight, QuantizedTensor):
        if _lrp_active():
            weight = dequantize(weight)
        else:
            out = int8_matmul(_local(x), weight)
            return out if bias is None else out + bias.to(out.dtype)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if not _lrp_active():
        return F.linear(x, w, b)
    rule, eps = _next_rule("linear")
    w_rule = torch.ones_like(w) if rule == "flat" else w
    return _lrp_wrap(lambda xx: F.linear(xx, w, b), x, rule, eps, rule_fwd=lambda xx: F.linear(xx, w_rule),
                     rule_vjp=lambda s, xx: s @ w_rule)


def max_pool(x, *, window=3, stride=2, padding=1, ceil_mode=False):
    """Max pooling over NCHW, −inf padding (torch semantics, incl. ceil_mode)."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)


def avg_pool(x, *, window=2, stride=2, padding=0):
    """Average pooling over NCHW (zero padding counted, as the JAX package's ``reduce_window`` sum).

    torch sums a bf16 input in float32 and rounds the mean once, as the JAX
    package does by casting to float32 around the sum.
    """
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def global_avg_pool(x):
    """(B, C, H, W) → (B, C, 1, 1) adaptive average pool to 1×1."""
    return torch.mean(x, dim=(2, 3), keepdim=True)


def layer_norm(x, weight, bias, *, eps=1e-5):
    """LayerNorm over the last axis, computed in float32, cast back to ``x.dtype``.

    Under a composite: the detached-denominator rule (Ali et al. 2022).
    1/√(var+eps) is a constant, so LN is a linear centring and scaling map
    and relevance goes through it by the ε rule.
    """
    if _lrp_active():
        with torch.no_grad():
            inv = torch.rsqrt(torch.var(x.float(), dim=-1, keepdim=True, correction=0) + eps)
        w32, b32 = weight.float(), bias.float()

        def f(xx):
            xxf = xx.float()
            centered = xxf - torch.mean(xxf, dim=-1, keepdim=True)
            return (centered * inv * w32 + b32).to(x.dtype)

        return _lrp_wrap(f, x, "epsilon", _LRP.epsilon)
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    """x·sigmoid(1.702x) — OpenAI CLIP's activation. LRP: pass-through."""
    if _lrp_active():
        return _lrp_passthrough(lambda xx: xx * torch.sigmoid(1.702 * xx), x)
    return x * torch.sigmoid(1.702 * x)


def gelu(x, *, approximate=False):
    """GELU, exact (erf) or tanh-approximate. LRP: pass-through."""
    mode = "tanh" if approximate else "none"
    if _lrp_active():
        return _lrp_passthrough(lambda xx: F.gelu(xx, approximate=mode), x)
    return F.gelu(x, approximate=mode)


def rms_norm(x, weight, *, eps=1e-6):
    """RMSNorm over the last axis in float32, ``x · rsqrt(mean(x²) + eps) · weight`` (HF ``LlamaRMSNorm``).

    Under a composite: the detached-denominator rule, as for
    :func:`layer_norm`. ``rsqrt(mean(x²) + eps)`` is a constant, so the
    map is a per-row scaling and relevance goes through it by the ε rule.
    """
    xf, w32 = x.float(), weight.float()
    if _lrp_active():
        with torch.no_grad():
            inv = torch.rsqrt(torch.mean(xf.square(), dim=-1, keepdim=True) + eps)
        return _lrp_wrap(lambda xx: (xx.float() * inv * w32).to(x.dtype), x, "epsilon", _LRP.epsilon)
    inv = torch.rsqrt(torch.mean(xf.square(), dim=-1, keepdim=True) + eps)
    return (xf * inv * w32).to(x.dtype)


def silu(x):
    """SiLU. LRP: pass-through (its derivative is not {0, 1})."""
    if _lrp_active():
        return _lrp_passthrough(F.silu, x)
    return F.silu(x)


def relu6(x):
    """min(max(x, 0), 6) (the MobileNet family). LRP: pass-through.

    Unlike ReLU, the clip at 6 leaves a nonzero output with a zero
    derivative, so the raw gradient mask would erase the relevance of every
    unit saturated at 6.
    """
    if _lrp_active():
        return _lrp_passthrough(F.relu6, x)
    return F.relu6(x)


def hardswish(x):
    """x·relu6(x + 3)/6 (torch ``nn.Hardswish``). LRP: pass-through (its derivative is not {0, 1})."""
    if _lrp_active():
        return _lrp_passthrough(F.hardswish, x)
    return F.hardswish(x)


def gate_scale(x, gate):
    """``x * gate`` for a data-dependent gate (a gated MLP's activation).

    Under a composite the gate is a constant (the CP-LRP convention) and the
    scaling carries the ε rule: relevance stays in ``x``, none reaches the
    branch that computed the gate.
    """
    if _lrp_active():
        g = gate.detach()
        return _lrp_wrap(lambda xx: xx * g, x, "epsilon", _LRP.epsilon, rule_vjp=lambda s, xx: s * g)
    return x * gate


def channel_scale(x, gamma):
    """Per-channel (or scalar) scaling. LRP: ε rule, where autograd's γ·R would rescale relevance."""
    if _lrp_active():
        g = gamma.to(x.dtype)
        return _lrp_wrap(lambda xx: xx * g, x, "epsilon", _LRP.epsilon, rule_vjp=lambda s, xx: s * g)
    return x * gamma.to(x.dtype)


def multi_head_attention(x, params, prefix, n_heads, *, mask=None, kv=None):
    """Torch-style ``nn.MultiheadAttention`` with fused in-proj weights.

    Params: ``{prefix}.in_proj_weight`` (3D, D), ``{prefix}.in_proj_bias``
    (3D,), ``{prefix}.out_proj.weight`` (D, D), ``{prefix}.out_proj.bias``.
    x: (B, T, D) queries; kv: optional (B, S, D) keys/values (defaults to x).
    mask: optional additive (T, S) float mask. An int8 in-proj
    (``QuantizedTensor``) is split into Q, K and V by ``col_slice``.
    """
    d_model = x.shape[-1]
    w_in = params[f"{prefix}.in_proj_weight"]
    b_in = params[f"{prefix}.in_proj_bias"]
    if kv is None and not _lrp_active():
        # Self-attention: one (D, 3D) projection, then slice. Not under a
        # composite, whose rule stream stays three linears per attention.
        q, k, v = linear(x, w_in, b_in).split(d_model, dim=-1)
    else:
        kv = x if kv is None else kv
        q = linear(x, col_slice(w_in, 0, d_model), b_in[:d_model])
        k = linear(kv, col_slice(w_in, d_model, 2 * d_model), b_in[d_model : 2 * d_model])
        v = linear(kv, col_slice(w_in, 2 * d_model, 3 * d_model), b_in[2 * d_model :])
    out = scaled_dot_product_attention(q, k, v, n_heads, mask=mask)
    return linear(out, params[f"{prefix}.out_proj.weight"], params[f"{prefix}.out_proj.bias"])


def scaled_dot_product_attention(q, k, v, n_heads, *, mask=None, n_kv_heads=None, scale=None, logit_cap=None,
                                 float32_mask=False):
    """Batched MHA core: (B, T, H·hd) q / (B, S, KV·hd) k, (B, S, KV·vd) v → (B, T, H·vd).

    The value head size ``vd`` may differ from the query/key one (latent
    attention: 192 against 128); it is read from ``v``.

    ``mask`` is additive (−inf blocks): (T, S), (H, T, S) per-head
    biases, or (B, 1, T, S) / (B, H, T, S) per row (pad-aware LMs, Swin's
    windows); lower ranks broadcast from the left. A (G, H, T, S) mask
    whose G divides B but is neither 1 nor B repeats with period G over the
    rows (row i takes ``mask[i % G]``: Swin's windows are batch-major), so
    a shifted-window bias is never materialised per image; it needs one of
    the float32 paths (``float32_mask``, ``logit_cap`` or a composite).
    ``float32_mask`` marks a learned float bias (Swin's and MaxViT's
    relative-position tables, Swin-V2's ``16·sigmoid`` bias): it is added
    to float32 logits as the JAX package adds every mask, on an explicit
    float32 path (SDPA takes a float mask only in q's dtype, and bf16
    would round a bias of 0–16 by up to 2⁻⁵, and swallow a small one
    beside −100); the probabilities then meet the values in their dtype.
    ``scale`` overrides ``head_dim**-0.5`` (Gemma 2's
    ``query_pre_attn_scalar**-0.5``). ``n_kv_heads`` < ``n_heads`` is
    grouped-query attention: kv head g serves the g-th group of
    ``n_heads // n_kv_heads`` consecutive query heads (HF ``repeat_kv``,
    ``repeat_interleave`` over heads). ``logit_cap`` soft-caps the scaled
    logits, ``cap·tanh(logits/cap)``, before the mask is added (Gemma 2);
    that path runs explicitly in float32, as the JAX package's does.
    Otherwise ``F.scaled_dot_product_attention`` (the flash or
    memory-efficient backend on the card), as the JAX package leaves
    attention to XLA.

    Under a composite this is CP-LRP (Ali et al. 2022): the softmax (capped
    where asked) runs in float32 over the repeated keys and is a constant,
    so the head is a linear map of the values and relevance goes through it
    by the ε rule; queries and keys receive none.

    Tensor parallelism: the core never computes on a DTensor
    (:func:`_dtensor_attention` hands it plain tensors).
    """
    if _has_dtensor(q, k, v):
        return _dtensor_attention(q, k, v, n_heads, mask=mask, n_kv_heads=n_kv_heads, scale=scale,
                                  logit_cap=logit_cap, float32_mask=float32_mask)
    b, t, d = q.shape
    s = k.shape[1]
    head_dim = d // n_heads
    kv_heads = n_kv_heads or n_heads

    def split(z, length, heads=n_heads):
        return z.reshape(b, length, heads, z.shape[-1] // heads).transpose(1, 2)

    def split_kv(z):  # (B, S, KV·hd) → (B, H, S, hd), HF grouping order
        z = split(z, s, kv_heads)
        return z if kv_heads == n_heads else z.repeat_interleave(n_heads // kv_heads, dim=1)

    def add_mask(logits):
        m, g = mask.float(), mask.shape[0]
        if mask.ndim == 4 and g not in (1, b):  # period G over the rows
            return (logits.view(b // g, g, *logits.shape[1:]) + m).view(logits.shape)
        return logits + m

    def float32_probs():
        logits = (split(q, t).float() @ split_kv(k).float().transpose(-1, -2)) * (
            head_dim**-0.5 if scale is None else scale)
        if logit_cap is not None:
            logits = torch.tanh(logits / logit_cap) * logit_cap
        if mask is not None:
            logits = add_mask(logits)
        return torch.softmax(logits, dim=-1)

    def merge(out, dtype):
        return out.transpose(1, 2).reshape(b, t, -1).to(dtype)

    if _lrp_active():
        with torch.no_grad():
            probs = float32_probs()
        return _lrp_wrap(lambda vv: merge(probs @ split_kv(vv).float(), vv.dtype), v, "epsilon", _LRP.epsilon)
    if logit_cap is not None:
        return merge(float32_probs() @ split_kv(v).float(), v.dtype)
    if float32_mask:
        return merge(float32_probs().to(v.dtype) @ split_kv(v), v.dtype)
    attn_mask = None if mask is None else mask.to(q.dtype)
    out = F.scaled_dot_product_attention(split(q, t), split_kv(k), split_kv(v), attn_mask=attn_mask, scale=scale)
    return merge(out, q.dtype)


def _local(x):
    """``x`` as a plain tensor: a DTensor activation is gathered whole (the int8 ops take plain tensors)."""
    return x.full_tensor() if _has_dtensor(x) else x


def _has_dtensor(*tensors) -> bool:
    """True when one of ``tensors`` is a DTensor; plain tensors cost a type check each, no import."""
    if all(type(z) is torch.Tensor for z in tensors) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(z, DTensor) for z in tensors)


def _dtensor_attention(q, k, v, n_heads, *, mask=None, n_kv_heads=None, **kwargs):
    """The attention core under tensor parallelism, on plain tensors.

    When q, k and v are split on their last axis over a 1-D mesh of ``tp``
    ranks and ``tp`` divides both head counts, each rank holds whole heads
    (the column-parallel q/k/v projections' output, Megatron's layout): the
    core runs on the local tensors with ``heads/tp`` and ``kv_heads/tp``
    (GQA's groups stay on one rank, since query head h reads kv head
    h·kv/heads), a per-head mask is cut to the local heads, and the output
    is wrapped back split on its last axis for the row-parallel output
    projection. Otherwise q, k and v are replicated first and the output
    is replicated. DTensor's own propagation through SDPA's decomposition
    is avoided: it stalls for heads split this way.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = next(z for z in (q, k, v) if isinstance(z, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim
    q, k, v = (z if isinstance(z, DTensor) else DTensor.from_local(z, mesh, rep, run_check=False) for z in (q, k, v))
    if isinstance(mask, DTensor):
        mask = mask.full_tensor()
    tp, kv_heads = mesh.size(), n_kv_heads or n_heads

    def last_axis_split(z):
        return mesh.ndim == 1 and isinstance(z.placements[0], Shard) and z.placements[0].dim in (z.ndim - 1, -1)

    if all(map(last_axis_split, (q, k, v))) and n_heads % tp == 0 and kv_heads % tp == 0:
        rank, local_heads = mesh.get_local_rank(), n_heads // tp
        if mask is not None and mask.ndim >= 3 and mask.shape[-3] == n_heads > 1:
            mask = mask[..., rank * local_heads : (rank + 1) * local_heads, :, :]
        out = scaled_dot_product_attention(q.to_local(), k.to_local(), v.to_local(), local_heads, mask=mask,
                                           n_kv_heads=kv_heads // tp, **kwargs)
        return DTensor.from_local(out, mesh, [Shard(out.ndim - 1)], run_check=False)
    q, k, v = (z.redistribute(mesh, rep).to_local() for z in (q, k, v))
    out = scaled_dot_product_attention(q, k, v, n_heads, mask=mask, n_kv_heads=n_kv_heads, **kwargs)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def edge_pad_mask(ids, pad_id: int):
    """(B, T) bool: True on the leading and trailing runs of ``pad_id``.

    Fixed-length batching pads at an edge (left or right), so only edge runs
    count as padding; a real mid-text token equal to ``pad_id`` is never
    masked.
    """
    pad = ids == pad_id
    lead = torch.cumprod(pad.to(torch.int32), dim=1).bool()
    trail = torch.cumprod(pad.flip(1).to(torch.int32), dim=1).flip(1).bool()
    return lead | trail


def attn_out_projection(tap, heads_name, proj_name, a, weight, bias, n_heads):
    """Attention out-projection with the virtual per-head components tap.

    The ``…attn.heads`` tap scores each head's residual-stream contribution
    per token: ``‖head h's output × its W_O slice‖`` → (B, T, n_heads).

    - tap not requested, no intervention: the plain ``linear`` projection;
      the per-head einsum is never built;
    - tap requested: the per-head contributions are computed for the norms,
      and the output still takes the plain ``linear`` path, so tapped and
      untapped forwards agree bit for bit;
    - an intervention on ``heads_name``: the tap value (the norms) is
      rewritten and the rewrite is causal — head h's contribution is
      rescaled by ``new_norm / old_norm`` (zero-ablating a head removes it,
      steering a head's score scales it) and the output is the rescaled sum
      plus the bias. A head whose contribution is exactly zero stays zero.
    """
    from semanticlens_tpu_torch.models.base import has_intervention

    live = heads_name is not None and has_intervention(heads_name)
    if heads_name in tap.requested or live:
        b, t, d = a.shape
        hd = d // n_heads
        w_o = weight.to(a.dtype).t()  # (in, out)
        per_head = torch.einsum("bthc,hcd->bthd", a.reshape(b, t, n_heads, hd),
                                w_o.reshape(n_heads, hd, w_o.shape[-1]))
        old = torch.linalg.vector_norm(per_head.float(), dim=-1)  # (B, T, H)
        new = tap(heads_name, old)
        if live:
            scale = torch.where(old > 0.0, new.float() / torch.clamp_min(old, 1e-30), 0.0)
            out = (per_head * scale[..., None].to(per_head.dtype)).sum(dim=2)
            if bias is not None:
                out = out + bias.to(out.dtype)
            return tap(proj_name, out)
    return tap(proj_name, linear(a, weight, bias))


def bn_param_specs(prefix: str, ch: int, *, ones_kind: str = "bn_w", zeros_kind: str = "zeros") -> list:
    """(name, shape, init kind) rows of one torch BatchNorm layer (weight, bias, running mean and var).

    The ``*_kind`` tokens name each family's init vocabulary for scale-like
    and offset-like tensors, as the JAX package's ``bn_param_specs`` does.
    """
    return [
        (f"{prefix}.weight", (ch,), ones_kind),
        (f"{prefix}.bias", (ch,), zeros_kind),
        (f"{prefix}.running_mean", (ch,), zeros_kind),
        (f"{prefix}.running_var", (ch,), ones_kind),
    ]


# Parameters that feed a learned attention bias, kept float32 whatever the compute dtype (Swin's and MaxViT's
# relative-position tables, Swin-V2's continuous-position-bias MLP).
FLOAT32_TABLES = ("relative_position_bias_table", ".cpb_mlp.")


def load_torch_params(param_specs, state_dict, *, device, dtype) -> dict[str, torch.Tensor]:
    """A torch-layout state dict checked against a family's specs and placed for the forward.

    ``param_specs`` are (name, shape, kind) rows in the JAX package's layout
    (the shapes its ``load_torch_params`` checks); each tensor of
    ``state_dict`` must have that shape's torch layout
    (:func:`convert.torch_layout_shape`), so this is a check and a cast, no
    relayout. Entries the specs do not name (derived buffers,
    ``num_batches_tracked``) are skipped. Convs and 2-D weights move to the
    compute ``dtype`` (convs in channels_last); BN statistics, norm scales,
    biases, layer scales and the attention-bias tables and MLPs of
    :data:`FLOAT32_TABLES` stay float32: the ops cast them at use (the bias
    tables never: they are added to float32 logits, as in the JAX package,
    whose parameters are all float32).
    """
    from semanticlens_tpu_torch.convert import torch_layout_shape

    out = {}
    for name, shape, kind in param_specs:
        t = torch.as_tensor(state_dict[name])
        expected = torch_layout_shape(name, shape, kind)
        if tuple(t.shape) != expected:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != expected {expected}")
        if t.ndim == 4 and not name.endswith("layer_scale"):
            t = t.to(device, dtype).contiguous(memory_format=torch.channels_last)
        elif t.ndim == 2 and not any(part in name for part in FLOAT32_TABLES):
            t = t.to(device, dtype)
        else:
            t = t.to(device, torch.float32)
        out[name] = t
    return out
