"""Sparse autoencoders and transcoders: train a dictionary on a tapped layer,
then audit its latents as components.

Counterpart of ``semanticlens_tpu.sae`` with the same flavours, objective,
optimizer and parameter layout: ``W_enc (d_in, n_latents)``, ``W_dec
(n_latents, d_in)``, ``b_enc``, ``b_dec``, plus ``b_in`` (transcoders),
``W_skip`` (skip transcoders) and ``log_theta`` (JumpReLU), and ``k`` as an
int entry once trained. A dictionary therefore has the same cache digest in
both packages, and ``convert.sae_params_from_jax`` / ``sae_params_to_jax``
carry one across either way.

- ``k > 0`` — TopK SAE (arXiv:2406.04093) with the AuxK dead-latent loss;
- ``k == 0`` — ReLU + L1 with unit-norm decoder rows;
- ``jumprelu=True`` — JumpReLU (arXiv:2407.14435) with the rectangle-kernel
  straight-through estimators, as ``torch.autograd.Function`` s;
- ``d_out > 0`` — a transcoder (arXiv:2406.11944), ``skip=True`` with the
  affine bypass of skip transcoders (arXiv:2501.18823).

Where the JAX package jits one donated optimizer step and scans it, the
port runs eager PyTorch on the device of the rows: a loop over minibatches
that reads nothing back to the host unless asked (``log_every``), with the
SAE math in float32 (TF32 as the caller set it). The optimizer is optax's
``chain(clip_by_global_norm(1.0), adam(lr))`` written out in torch
(:class:`ClipAdam`). The TPU's training-path ``approx_max_k`` becomes an
exact ``torch.topk`` + scatter, the selection the JAX package makes on
every backend but the TPU.

``train_sae_from_rows`` draws its minibatch indices from the same host
numpy stream as the JAX trainer, so both take the same rows in the same
order. The streaming trainers (``train_sae_on_layer``,
``train_transcoder_on_layer``) draw positions and permutations from a
``torch.Generator`` on the device, where the JAX ones use ``jax.random``:
they cannot match the JAX trainers draw for draw. Initial parameters come
from an explicit ``torch.Generator`` on the CPU, so a seed gives the same
dictionary on the card and on the CPU (not the JAX package's).

The virtual taps are causal as in the JAX package: an intervention on
``"{layer}.sae"`` substitutes the layer with encode → rewrite → decode, and
``TranscoderSubjectModel(replace=True)`` (or an intervention on
``"{tap_in}.tc"``) substitutes the target tap with the transcoder's
prediction.

With ``mesh=`` (a ``DeviceMesh`` with a ``"data"`` axis) every trainer is
data-parallel, as the JAX package's sharded minibatches are: each rank
computes its rows' part of the loss of the *global* minibatch (every mean
over rows is a sum over the local rows divided by the global row count),
the gradients are summed across ranks before ``ClipAdam`` so every rank
takes the same step, and the metrics reduce sums, never ratios: the fvu's
numerator and denominator (about the global mean of the target), the
fired-latent mask for dead-latent tracking (``MAX``), AuxK's terms.
``train_sae_from_rows`` draws the same index stream on every rank and each
takes its columns of every minibatch. The streaming trainers run the
forward on each rank's rows of every image batch, draw positions and the
permutation for the whole batch from one stream on every rank, all-gather
the extracted rows and take this rank's columns of every minibatch, as the
JAX package reshards the permuted rows: world ``W`` steps through the
minibatches of one process.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Mapping

import numpy as np
import torch

from semanticlens_tpu_torch.core.mesh import all_gather, all_reduce, mesh_axis
from semanticlens_tpu_torch.data.dataset import device_prefetch_batches, iter_batches
from semanticlens_tpu_torch.models.base import SubjectModel, apply_interventions, has_intervention, interventions
from semanticlens_tpu_torch.utils.device import as_tensor, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SAEConfig:
    """Hyperparameters for SAE init + training (the JAX package's fields).

    d_in : width of the tapped layer (conv channels or token features).
    n_latents : dictionary size (components of the virtual tap).
    k : TopK sparsity; 0 selects the ReLU+L1 objective.
    l1_coef : L1 penalty (ReLU+L1 flavour only).
    aux_k / aux_coef / dead_steps : AuxK dead-latent revival (TopK flavour):
        a latent silent for ``dead_steps`` optimizer steps is dead; the top
        ``aux_k`` dead latents must reconstruct the main residual, weighted
        by ``aux_coef``.
    lr : Adam learning rate.
    batch_rows : activation rows per optimizer step.
    approx_topk : the training TopK keeps exactly k slots per row (top-k +
        scatter, gradient through the scattered values); False keeps every
        entry ≥ the k-th (ties keep more). The JAX package selects with
        ``approx_max_k`` on a TPU; the port's selection is exact.
    positions_per_image : spatial/token positions sampled per image by the
        streaming trainers (0 = every position).
    jumprelu / l0_coef / ste_eps / init_theta : JumpReLU flavour
        (requires ``k == 0``): thresholds ``θ = exp(log_theta)`` from
        ``init_theta``, loss ``mse + l0_coef · E[L0]``, rectangle-kernel STE
        bandwidth ``ste_eps``.
    seed : initial parameters and the index stream.
    d_out / skip : transcoder target width; skip-transcoder bypass.
    """

    d_in: int
    n_latents: int
    k: int = 32
    l1_coef: float = 1e-3
    aux_k: int = 0
    aux_coef: float = 1.0 / 32.0
    dead_steps: int = 200
    lr: float = 1e-3
    batch_rows: int = 1024
    positions_per_image: int = 0
    approx_topk: bool = True
    jumprelu: bool = False
    l0_coef: float = 6e-4
    ste_eps: float = 1e-3
    init_theta: float = 1e-3
    seed: int = 0
    d_out: int = 0
    skip: bool = False

    def __post_init__(self):
        if self.jumprelu and self.k:
            raise ValueError("jumprelu=True requires k=0 (thresholded, not TopK)")
        if self.skip and not self.d_out:
            raise ValueError("skip=True is a transcoder option; set d_out")

    @property
    def is_transcoder(self) -> bool:
        """``d_out > 0``: encode from the input tap, decode toward a different target tap."""
        return self.d_out > 0


def _f32(value, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from numpy (or anything ``np.asarray`` takes) or a tensor."""
    return as_tensor(value if isinstance(value, torch.Tensor) else np.array(value, np.float32), device, torch.float32)


def init_sae(generator: torch.Generator, cfg: SAEConfig, device=None) -> dict:
    """Unit-norm decoder rows, encoder = decoderᵀ, zero biases (arXiv:2406.04093
    §A.1); a transcoder gets a lecun-normal encoder, unit-norm decoder rows, an
    input bias ``b_in`` and, with ``skip``, a zero ``W_skip``. JumpReLU adds
    ``log_theta`` at ``log(init_theta)``.

    Draws from ``generator`` on its own device and places the float32 tensors
    on ``device`` (None → the card).
    """
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=generator.device, dtype=torch.float32).to(device)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32, device=device)

    if cfg.is_transcoder:
        w_enc = normal(cfg.d_in, cfg.n_latents) / np.sqrt(cfg.d_in)
        w = normal(cfg.n_latents, cfg.d_out)
        params = {
            "W_enc": w_enc,
            "b_enc": zeros(cfg.n_latents),
            "b_in": zeros(cfg.d_in),
            "W_dec": w / torch.linalg.vector_norm(w, dim=-1, keepdim=True),
            "b_dec": zeros(cfg.d_out),
        }
        if cfg.skip:
            params["W_skip"] = zeros(cfg.d_in, cfg.d_out)
    else:
        w = normal(cfg.n_latents, cfg.d_in)
        w_dec = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        params = {
            "W_enc": w_dec.T.contiguous(),
            "b_enc": zeros(cfg.n_latents),
            "W_dec": w_dec,
            "b_dec": zeros(cfg.d_in),
        }
    if cfg.jumprelu:
        params["log_theta"] = torch.full((cfg.n_latents,), float(np.log(cfg.init_theta)), dtype=torch.float32,
                                         device=device)
    return params


def _topk_mask(pre, k: int):
    """Zero all but the entries ≥ the k-th largest of the last axis (ties keep
    more than k), ReLU-clamped. ``-inf`` entries that are not kept become NaN
    (``-inf · 0``), as in the JAX package; AuxK clears them."""
    vals, _ = torch.topk(pre, k, dim=-1)
    keep = pre >= vals[..., -1:]
    return torch.maximum(pre * keep, pre.new_zeros(()))


def _topk_scatter(pre, k: int):
    """Training-path sparsifier: exactly k slots per row, the ReLU'd winners
    scattered into zeros; the gradient flows through the scattered values."""
    vals, idx = torch.topk(pre, k, dim=-1)
    return torch.zeros_like(pre).scatter(-1, idx, torch.maximum(vals, vals.new_zeros(())))


def _sparsify(pre, k: int, approx: bool):
    if approx and pre.ndim == 2:
        return _topk_scatter(pre, k)
    return _topk_mask(pre, k)


def _rect_kernel(u):
    """Rectangle kernel K(u) = 1{|u| ≤ ½} — the arXiv:2407.14435 default."""
    return (u.abs() <= 0.5).to(torch.float32)


class _JumpReLUSTE(torch.autograd.Function):
    """``pre · H(pre − θ)``; ∂/∂pre is H(pre − θ), ∂/∂θ the kernel pseudo-derivative
    −(θ/ε)K((pre−θ)/ε) (arXiv:2407.14435 §3), chained through θ = exp(log_theta)
    and summed over rows."""

    @staticmethod
    def forward(ctx, pre, log_theta, eps):
        ctx.save_for_backward(pre, log_theta)
        ctx.eps = eps
        return pre * (pre > torch.exp(log_theta))

    @staticmethod
    def backward(ctx, g):
        pre, log_theta = ctx.saved_tensors
        theta = torch.exp(log_theta)
        d_pre = g * (pre > theta)
        d_theta = g * (-(theta / ctx.eps) * _rect_kernel((pre - theta) / ctx.eps))
        d_log = (d_theta * theta).reshape(-1, theta.shape[-1]).sum(dim=0)
        return d_pre, d_log, None


class _L0STE(torch.autograd.Function):
    """``H(pre − θ)``: flat in pre; θ gets −(1/ε)K((pre−θ)/ε), the only signal that
    teaches thresholds to rise."""

    @staticmethod
    def forward(ctx, pre, log_theta, eps):
        ctx.save_for_backward(pre, log_theta)
        ctx.eps = eps
        return (pre > torch.exp(log_theta)).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        pre, log_theta = ctx.saved_tensors
        theta = torch.exp(log_theta)
        d_theta = g * (-(1.0 / ctx.eps) * _rect_kernel((pre - theta) / ctx.eps))
        d_log = (d_theta * theta).reshape(-1, theta.shape[-1]).sum(dim=0)
        return torch.zeros_like(pre), d_log, None


def _pre_activations(params: Mapping, x):
    b_in = params["b_in"] if "b_in" in params else params["b_dec"]
    return (x.to(torch.float32) - b_in) @ params["W_enc"] + params["b_enc"]


def encode(params: Mapping, x, k: int = 0):
    """Rows (..., d_in) → codes (..., n_latents) in float32: TopK when ``k > 0``,
    JumpReLU when the dictionary carries ``log_theta``, else ReLU. Transcoders
    centre by ``b_in`` (their ``b_dec`` lives in the output space)."""
    pre = _pre_activations(params, x)
    if k > 0:
        return _topk_mask(pre, k)
    if "log_theta" in params:
        return pre * (pre > torch.exp(params["log_theta"]))
    return torch.relu(pre)


def decode(params: Mapping, z, x=None):
    """Codes → reconstruction; a skip transcoder also needs the input rows ``x``."""
    out = z @ params["W_dec"] + params["b_dec"]
    if "W_skip" in params:
        if x is None:
            raise ValueError("skip-transcoder decode needs the input rows x")
        out = out + x.to(torch.float32) @ params["W_skip"]
    return out


def finalize_sae_params(params: Mapping, cfg: SAEConfig) -> dict:
    """The trained artifact with its encode-time sparsity stamped in as ``k`` (an int)."""
    return {**{n: v for n, v in params.items() if n != "k"}, "k": int(cfg.k)}


def load_gemma_scope_params(arrays: Mapping, device=None) -> dict:
    """A published Gemma Scope dictionary (arXiv:2408.05147) in this module's convention.

    Gemma Scope encodes without input centering (``pre = x @ W_enc + b_enc``);
    :func:`encode` centres by ``b_dec``, so the centering folds into the
    encoder bias: ``b_enc' = b_enc + b_dec @ W_enc``. Thresholds become
    ``log_theta`` (non-positive ones clamped to 1e-12 first); ``k = 0``.
    """
    w_enc, b_enc, w_dec, b_dec, theta = (_f32(arrays[n], device) for n in ("W_enc", "b_enc", "W_dec", "b_dec",
                                                                            "threshold"))
    if tuple(w_enc.shape) != tuple(w_dec.shape)[::-1]:
        raise ValueError(f"W_enc {tuple(w_enc.shape)} is not W_dec {tuple(w_dec.shape)} transposed")
    return {
        "W_enc": w_enc,
        "b_enc": b_enc + b_dec @ w_enc,
        "W_dec": w_dec,
        "b_dec": b_dec,
        "log_theta": torch.log(torch.clamp_min(theta, 1e-12)),
        "k": 0,
    }


def init_stats(cfg: SAEConfig, device=None) -> dict:
    """Per-latent liveness carried through training: steps since each latent last fired (int32)."""
    device = resolve_device(device)
    return {
        "last_fired": torch.zeros(cfg.n_latents, dtype=torch.int32, device=device),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _fvu(err, target, group=None):
    """Fraction of variance unexplained of a minibatch: Σ err² over Σ (target − its row mean)².

    Over a data-parallel group, numerator, denominator and the mean's sums
    and counts are summed across ranks first: the global minibatch's fvu.
    """
    if group is None:
        var = torch.sum((target - torch.mean(target, dim=0)) ** 2)
        return torch.sum(err * err) / torch.clamp_min(var, 1e-9)
    total = all_reduce(torch.cat([torch.sum(target, dim=0), target.new_tensor([target.shape[0]])]), group)
    mean = total[:-1] / total[-1]
    sums = all_reduce(torch.stack([torch.sum(err * err), torch.sum((target - mean) ** 2)]), group)
    return sums[0] / torch.clamp_min(sums[1], 1e-9)


def _loss_fn(params, x, cfg: SAEConfig, last_fired, y=None, group=None):
    """``(loss, (fired, metrics))`` of one minibatch: the JAX package's objective term for term.

    With a data-parallel ``group`` this rank's rows are its part of the
    global minibatch: every row mean is the local sum over the global row
    count, so the ranks' losses (and gradients) sum to the global ones, and
    the metrics and the fired mask are reduced across the group.
    """
    n_global = x.shape[0] * (1 if group is None else torch.distributed.get_world_size(group))

    def row_mean(v):
        return torch.mean(v) if group is None else torch.sum(v) / n_global

    x = x.to(torch.float32)
    target = x if y is None else y.to(torch.float32)
    pre = _pre_activations(params, x)
    if cfg.jumprelu:
        z = _JumpReLUSTE.apply(pre, params["log_theta"], cfg.ste_eps)
    else:
        z = _sparsify(pre, cfg.k, cfg.approx_topk) if cfg.k > 0 else torch.relu(pre)
    recon = decode(params, z, x if "W_skip" in params else None)
    err = recon - target
    mse = row_mean(torch.sum(err * err, dim=-1))
    loss = mse
    if cfg.jumprelu:
        loss = loss + cfg.l0_coef * row_mean(torch.sum(_L0STE.apply(pre, params["log_theta"], cfg.ste_eps), dim=-1))
    if cfg.k > 0 and cfg.aux_k > 0:
        # AuxK (arXiv:2406.04093 §A.2): the top aux_k dead latents reconstruct the
        # main residual; gradients reach only dead latents.
        dead = last_fired >= cfg.dead_steps
        pre_dead = torch.where(dead, pre, pre.new_tensor(float("-inf")))
        z_aux = _topk_mask(pre_dead, min(cfg.aux_k, cfg.n_latents))
        z_aux = torch.where(torch.isfinite(z_aux), z_aux, z_aux.new_zeros(()))
        aux_err = z_aux @ params["W_dec"] - (-err).detach()
        aux = row_mean(torch.sum(aux_err * aux_err, dim=-1))
        # with no dead latent aux is ‖err‖², a constant of the dead path but not of the main one
        loss = loss + cfg.aux_coef * torch.where(dead.any(), aux, aux.new_zeros(()))
    if cfg.k == 0 and not cfg.jumprelu:
        row_norm = torch.linalg.vector_norm(params["W_dec"], dim=-1)
        loss = loss + cfg.l1_coef * row_mean(torch.sum(z * row_norm, dim=-1))
    with torch.no_grad():
        positive = z > 0.0
        fired = positive.reshape(-1, positive.shape[-1]).any(dim=0)
        l0 = row_mean(torch.sum(positive, dim=-1).to(torch.float32))
        mse_metric = mse.detach()
        if group is not None:
            fired = all_reduce(fired.to(torch.int32), group, torch.distributed.ReduceOp.MAX).bool()
            mse_metric, l0 = all_reduce(torch.stack([mse_metric, l0]), group)
        metrics = {"mse": mse_metric, "fvu": _fvu(err.detach(), target, group), "l0": l0}
    return loss, (fired, metrics)


def _unit_rows(w):
    return w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1, keepdim=True), 1e-9)


def _project_decoder(params, grads):
    """Remove each decoder row's radial gradient component (ReLU+L1 only)."""
    unit = _unit_rows(params["W_dec"])
    g = grads["W_dec"]
    return {**grads, "W_dec": g - torch.sum(g * unit, dim=-1, keepdim=True) * unit}


def _renorm_decoder(params):
    return {**params, "W_dec": _unit_rows(params["W_dec"])}


class Adam:
    """``optax.adam(lr)`` in plain torch, with optax's defaults as constants.

    Moments ``(1 − b)·g + b·m``, bias-corrected by ``1 − bᵗ``, the update
    ``−lr · m̂ / (√v̂ + eps)`` with ``eps`` outside the square root
    (``b1=0.9``, ``b2=0.999``, ``eps=1e-8``). The state is ``{"count":
    int, "mu": {...}, "nu": {...}}`` over a dict of tensors.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: Mapping) -> dict:
        return {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: Mapping, state: Mapping):
        """``(updates, new_state)`` for ``grads``."""
        count = state["count"] + 1
        mu = {n: (1 - self.B1) * g + self.B1 * state["mu"][n] for n, g in grads.items()}
        nu = {n: (1 - self.B2) * (g * g) + self.B2 * state["nu"][n] for n, g in grads.items()}
        # bias corrections in float32, as optax computes ``1 - decay**count`` (0.999 rounds up in float32)
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count)) for b in (self.B1, self.B2))
        updates = {n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.EPS) * -self.lr for n in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}


class ClipAdam(Adam):
    """``optax.chain(clip_by_global_norm(1.0), adam(lr))``: :class:`Adam` after the clip.

    The clip leaves the gradient alone when its global norm is below
    ``MAX_NORM`` and otherwise scales it by ``MAX_NORM / norm`` — without
    the ``+ 1e-6`` that ``torch.nn.utils.clip_grad_norm_`` adds.
    """

    MAX_NORM = 1.0

    def update(self, grads: Mapping, state: Mapping):
        """``(updates, new_state)`` for ``grads``."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        below = norm < self.MAX_NORM
        return super().update({n: torch.where(below, g, g / norm * self.MAX_NORM) for n, g in grads.items()},
                              state)


def make_optimizer(cfg: SAEConfig) -> ClipAdam:
    return ClipAdam(cfg.lr)


def apply_updates(params: Mapping, updates: Mapping) -> dict:
    return {n: p + updates[n] for n, p in params.items()}


def _data_axis(mesh):
    """``(size, rank, group)`` of the mesh's ``"data"`` axis; one rank trains as one process (group None)."""
    size, rank, group = mesh_axis(mesh, "data")
    return size, rank, group if size > 1 else None


def _all_reduce_grads(grads: dict, group) -> dict:
    """Every rank's gradients summed (one flat all-reduce), so every rank takes the same step."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]), group)
    out, at = {}, 0
    for name, g in grads.items():
        out[name] = flat[at : at + g.numel()].view_as(g)
        at += g.numel()
    return out


def make_train_step(cfg: SAEConfig, optimizer=None, *, paired: bool = False, group=None):
    """One optimizer step: ``step(params, opt_state, stats, x_rows)`` → the updated
    triple + scalar metrics as device tensors (``paired=True`` adds ``y_rows``,
    the transcoder target). Nothing is read back to the host. With a
    data-parallel ``group`` the rows are this rank's part of the minibatch
    and the gradients are summed across the group before the update."""
    optimizer = optimizer or make_optimizer(cfg)
    # The unit-norm decoder is the ReLU+L1 anti-scale-gaming device; JumpReLU (L0 is
    # scale-invariant) and transcoders (calibrated decoder scale) train W_dec freely.
    constrain_dec = cfg.k == 0 and not cfg.jumprelu and not cfg.is_transcoder

    def _update(params, opt_state, stats, x, y):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        with torch.enable_grad():
            loss, (fired, metrics) = _loss_fn(leaves, x, cfg, stats["last_fired"], y, group)
            found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), found)}
        with torch.no_grad():
            if group is not None:
                grads = _all_reduce_grads(grads, group)
                loss = all_reduce(loss.detach(), group)
            if constrain_dec:
                grads = _project_decoder(params, grads)
            updates, opt_state = optimizer.update(grads, opt_state)
            params = apply_updates(params, updates)
            if constrain_dec:
                params = _renorm_decoder(params)
            stats = {
                "last_fired": torch.where(fired, 0, stats["last_fired"] + 1),
                "step": stats["step"] + 1,
            }
        return params, opt_state, stats, {"loss": loss.detach(), **metrics}

    if paired:
        def step(params, opt_state, stats, x, y):
            return _update(params, opt_state, stats, x, y)
    else:
        def step(params, opt_state, stats, x):
            return _update(params, opt_state, stats, x, None)

    return step


def _run_steps(cfg: SAEConfig, optimizer, paired: bool = False, group=None):
    """``run(params, opt_state, stats, batches)``: one optimizer step per leading-axis
    minibatch of ``batches`` (S, batch_rows, d_in) — or of an ``(x, y)`` pair when
    ``paired`` — on the device; returns the updated triple and each metric stacked
    over the S steps (as a scan's outputs), still on the device."""
    step = make_train_step(cfg, optimizer, paired=paired, group=group)

    def run(params, opt_state, stats, batches):
        history = []
        for xy in (zip(*batches) if paired else batches):
            params, opt_state, stats, metrics = step(params, opt_state, stats, *(xy if paired else (xy,)))
            history.append(metrics)
        return params, opt_state, stats, {n: torch.stack([m[n] for m in history]) for n in history[0]}

    return run


def _last(metrics: Mapping) -> dict:
    """The final step's metrics as host floats."""
    return {n: float(v[-1]) for n, v in metrics.items()}


def _log_due(log_every: int, done: int, chunk: int) -> bool:
    return bool(log_every) and done % log_every < chunk


def train_sae_from_rows(rows, cfg: SAEConfig, *, targets=None, steps: int = 1000, mesh=None,
                        params: dict | None = None, log_every: int = 0, device=None):
    """Train on a fixed (N, d_in) row matrix (already-extracted activations).

    Rows go to the device once (a tensor stays where it is; numpy goes to
    ``device``, None → the card). Minibatch indices come from chained host
    permutations of ``np.random.default_rng(cfg.seed)``, exactly the JAX
    trainer's stream; the gather runs on the device. Steps run in chunks of
    up to 32, as the JAX trainer dispatches its scans.

    Returns ``(params, stats, metrics)``: the params carry ``k``
    (:func:`finalize_sae_params`), ``stats`` stays on the device, metrics
    are the final step's as floats. ``params`` (numpy or tensors) replaces
    the seeded init.

    With ``mesh`` every rank holds the same ``rows`` and draws the same
    index stream; rank ``r`` of ``W`` takes columns ``[r·b/W, (r+1)·b/W)``
    of each minibatch of ``b = batch_rows`` rows (``W`` must divide ``b``).
    """
    size, rank, group = _data_axis(mesh)
    if cfg.batch_rows % size:
        raise ValueError(f"batch_rows={cfg.batch_rows} must be divisible by the data-parallel degree {size}")
    rows = as_tensor(rows, device, torch.float32)
    n = rows.shape[0]
    if rows.ndim != 2 or rows.shape[1] != cfg.d_in:
        raise ValueError(f"rows must be (N, {cfg.d_in}), got {tuple(rows.shape)}")
    if n < cfg.batch_rows:
        raise ValueError(f"need at least batch_rows={cfg.batch_rows} rows, got {n}")
    paired = targets is not None
    if cfg.is_transcoder != paired:
        raise ValueError(
            "transcoder configs (d_out > 0) train on (rows, targets) pairs; plain SAE configs take rows only"
        )
    if paired:
        targets = as_tensor(targets, rows.device, torch.float32)
        if tuple(targets.shape) != (n, cfg.d_out):
            raise ValueError(f"targets must be (N={n}, d_out={cfg.d_out}), got {tuple(targets.shape)}")
    if params is None:
        params = init_sae(torch.Generator().manual_seed(cfg.seed), cfg, rows.device)
        if paired:
            params = _calibrate_transcoder_init(params, rows, targets)
    else:
        params = {name: _f32(v, rows.device) for name, v in params.items() if name != "k"}
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    stats = init_stats(cfg, rows.device)
    runner = _run_steps(cfg, optimizer, paired=paired, group=group)
    mine = slice(rank * (cfg.batch_rows // size), (rank + 1) * (cfg.batch_rows // size))

    rng = np.random.default_rng(cfg.seed)
    # Epoch-style sampling from chained permutations: every row once per ceil(n / batch_rows) steps.
    perm = rng.permutation(n)
    pos = 0

    def _take(count: int) -> np.ndarray:
        nonlocal perm, pos
        out = np.empty(count, np.int64)
        filled = 0
        while filled < count:
            avail = min(count - filled, n - pos)
            out[filled : filled + avail] = perm[pos : pos + avail]
            pos += avail
            filled += avail
            if pos == n:
                perm = rng.permutation(n)
                pos = 0
        return out

    chunk = max(1, min(steps, 32))
    done = 0
    metrics = {}
    while done < steps:
        s = min(chunk, steps - done)
        idx = torch.from_numpy(_take(s * cfg.batch_rows).reshape(s, cfg.batch_rows)[:, mine]).to(rows.device)
        batches = (rows[idx], targets[idx]) if paired else rows[idx]
        params, opt_state, stats, metrics = runner(params, opt_state, stats, batches)
        done += s
        if _log_due(log_every, done, chunk):
            m = _last(metrics)
            logger.info("sae step %d: loss %.4g fvu %.3f l0 %.1f", done, m["loss"], m["fvu"], m["l0"])
    return finalize_sae_params(params, cfg), stats, _last(metrics)


def _calibrate_transcoder_init(params: dict, x_rows, y_rows) -> dict:
    """Data-dependent transcoder init: encoder centred on the input mean, decoder
    bias at the target mean, decoder rows scaled to the target's standard
    deviation over all entries (the population std, as ``jnp.std``)."""
    x = x_rows.to(torch.float32)
    y = y_rows.to(torch.float32)
    y_std = torch.clamp_min(torch.std(y, correction=0), 1e-8)
    return {**params, "b_in": torch.mean(x, dim=0), "b_dec": torch.mean(y, dim=0),
            "W_dec": params["W_dec"] * y_std}


def train_transcoder_from_rows(rows, targets, cfg: SAEConfig, **kwargs):
    """Train a transcoder on paired (input-tap, target-tap) row matrices: same
    flavours and machinery as :func:`train_sae_from_rows`; ``cfg.d_out`` is
    the target width."""
    return train_sae_from_rows(rows, cfg, targets=targets, **kwargs)


class _PreprocessedModel(SubjectModel):
    """A subject model with an input-preprocess fn composed in front."""

    def __init__(self, base: SubjectModel, prep):
        self.base = base
        self.prep = prep
        self.device = base.device
        self.module_names = tuple(base.module_names)

    def apply(self, params, x, tap_names=()):
        return self.base.apply(params, self.prep(x), tap_names)


def _sampled_rows(cfg: SAEConfig, generator: torch.Generator, *taps: torch.Tensor, part=(0, 1)) -> tuple:
    """Each tap's float32 rows (B·positions, C), every leading/spatial axis flattened; with
    ``positions_per_image`` the same positions of each tap, drawn per image with replacement.
    ``part=(rank, world)``: the taps hold rank ``rank``'s images of a batch ``world`` times larger, whose
    positions are drawn whole and this rank's kept."""
    flats = tuple(h.reshape(h.shape[0], -1, h.shape[-1]) for h in taps)
    b, n_pos = flats[0].shape[:2]
    rank, world = part
    if cfg.positions_per_image and cfg.positions_per_image < n_pos:
        pos = torch.randint(0, n_pos, (b * world, cfg.positions_per_image), generator=generator,
                            device=flats[0].device)[rank * b : (rank + 1) * b, :, None]
        flats = tuple(torch.take_along_dim(f, pos, dim=1) for f in flats)
    return tuple(f.reshape(-1, f.shape[-1]).to(torch.float32) for f in flats)


def _make_row_extractor(model: SubjectModel, layer_name: str, cfg: SAEConfig):
    """``extract(params, images, generator, part=(0, 1))`` → float32 rows (B·positions, d_in) of the tap."""

    def extract(params, images, generator, part=(0, 1)):
        with torch.no_grad():
            _, taps = model.apply(params, images, (layer_name,))
            return _sampled_rows(cfg, generator, taps[layer_name], part=part)[0]

    return extract


def _make_pair_extractor(model: SubjectModel, tap_in: str, tap_out: str, cfg: SAEConfig):
    """``extract(params, images, generator, part=(0, 1))`` → (x_rows, y_rows) from one forward;
    the same sampled positions index both taps."""

    def extract(params, images, generator, part=(0, 1)):
        with torch.no_grad():
            _, taps = model.apply(params, images, (tap_in, tap_out))
            hx, hy = taps[tap_in], taps[tap_out]
            n_in, n_out = hx[0, ..., 0].numel(), hy[0, ..., 0].numel()
            if n_in != n_out:
                raise ValueError(
                    f"taps '{tap_in}' and '{tap_out}' have different position counts "
                    f"({n_in} vs {n_out}); a transcoder needs positionally "
                    "aligned input/target activations"
                )
            return _sampled_rows(cfg, generator, hx, hy, part=part)

    return extract


def _stream_minibatches(model, params, dataset, extract, cfg: SAEConfig, batch_size: int, epochs: int,
                        mesh=None):
    """Per full image batch of each epoch: ``(epoch, extracted, minibatches)`` — the
    extracted rows (or row pairs), and the same permuted on the device and cut
    into ``(S, batch_rows, ·)`` blocks. The zero-padded tail batch is skipped.

    Under a data mesh of ``W`` ranks each rank runs the forward on its rows
    of every image batch, with the positions of the whole batch drawn from
    the one stream every rank holds; the extracted rows are all-gathered in
    image order, so ``extracted`` and the permutation are one process's, and
    the blocks are this rank's ``batch_rows / W`` columns of each minibatch.
    """
    size, rank, group = _data_axis(mesh)
    if batch_size % size or cfg.batch_rows % size:
        raise ValueError(f"batch_size={batch_size} and batch_rows={cfg.batch_rows} must be divisible by the "
                         f"data-parallel degree {size}")
    n_full = (len(dataset) // batch_size) * batch_size
    if n_full == 0:
        raise ValueError(f"dataset of {len(dataset)} samples < batch_size {batch_size}")
    device = model.device
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    per, rows_per_step = batch_size // size, cfg.batch_rows // size
    for epoch in range(epochs):
        for images, start_index, _ in device_prefetch_batches(
            iter_batches(dataset, batch_size, part=(rank, size)), device
        ):
            if start_index - rank * per + batch_size > len(dataset):
                continue  # zero-padded tail batch
            extracted = extract(params, images, generator, (rank, size))
            pair = isinstance(extracted, tuple)
            if group is not None:  # the whole batch's rows on every rank, in image order
                whole = [all_gather(r, group).flatten(0, 1) for r in (extracted if pair else (extracted,))]
                extracted = tuple(whole) if pair else whole[0]
            n_rows = (extracted[0] if pair else extracted).shape[0]
            if n_rows < cfg.batch_rows:
                raise ValueError(
                    f"batch yields {n_rows} rows < batch_rows={cfg.batch_rows}; "
                    "raise batch_size or positions_per_image"
                )
            s = n_rows // cfg.batch_rows
            sel = torch.randperm(n_rows, generator=generator, device=device)[: s * cfg.batch_rows]
            sel = sel.reshape(s, size, rows_per_step)[:, rank]  # this rank's columns of each minibatch

            def cut(r):
                return r[sel]

            yield epoch, extracted, ((cut(extracted[0]), cut(extracted[1])) if pair else cut(extracted))


def train_sae_on_layer(model: SubjectModel, params, dataset, layer_name: str, cfg: SAEConfig, *,
                       batch_size: int = 64, epochs: int = 1, mesh=None, input_preprocess=None,
                       log_every: int = 0):
    """Streaming trainer: per epoch, one pass over the dataset on ``model.device``
    — extract the tap's rows, permute, and step through the minibatches —
    without the rows visiting the host.

    The zero-padded tail batch is dropped. ``input_preprocess`` maps the raw
    uploaded batch to the model's input (default: a float32 cast). Returns
    ``(sae_params, stats, metrics)``; the params carry ``k``. ``mesh``:
    data-parallel over the image batches (:func:`_stream_minibatches`).
    """
    group = _data_axis(mesh)[2]
    if cfg.d_in <= 0:
        raise ValueError("cfg.d_in must be set to the tapped layer's width")
    wrapped = _PreprocessedModel(model, input_preprocess or (lambda x: x.to(torch.float32)))
    extract = _make_row_extractor(wrapped, layer_name, cfg)
    sae_params = init_sae(torch.Generator().manual_seed(cfg.seed), cfg, model.device)
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(sae_params)
    stats = init_stats(cfg, model.device)
    runner = _run_steps(cfg, optimizer, group=group)
    done_steps, metrics = 0, {}
    for epoch, _, mini in _stream_minibatches(wrapped, params, dataset, extract, cfg, batch_size, epochs, mesh):
        sae_params, opt_state, stats, metrics = runner(sae_params, opt_state, stats, mini)
        done_steps += mini.shape[0]
        if _log_due(log_every, done_steps, mini.shape[0]):
            m = _last(metrics)
            logger.info("sae epoch %d step %d: loss %.4g fvu %.3f l0 %.1f",
                        epoch, done_steps, m["loss"], m["fvu"], m["l0"])
    return finalize_sae_params(sae_params, cfg), stats, _last(metrics)


def train_transcoder_on_layer(model: SubjectModel, params, dataset, tap_in: str, tap_out: str, cfg: SAEConfig, *,
                              batch_size: int = 64, epochs: int = 1, mesh=None, input_preprocess=None,
                              log_every: int = 0):
    """Streaming transcoder trainer: positionally aligned (``tap_in``, ``tap_out``)
    row pairs from one forward per batch, the sibling of
    :func:`train_sae_on_layer`. The init is calibrated on the first batch's rows
    (the whole batch's, under a mesh)."""
    group = _data_axis(mesh)[2]
    if not cfg.is_transcoder:
        raise ValueError("set cfg.d_out to the target tap's width")
    if cfg.d_in <= 0:
        raise ValueError("cfg.d_in must be set to the input tap's width")
    wrapped = _PreprocessedModel(model, input_preprocess or (lambda x: x.to(torch.float32)))
    extract = _make_pair_extractor(wrapped, tap_in, tap_out, cfg)
    tc_params = init_sae(torch.Generator().manual_seed(cfg.seed), cfg, model.device)
    optimizer = make_optimizer(cfg)
    opt_state = None  # after the data-dependent calibration
    stats = init_stats(cfg, model.device)
    runner = _run_steps(cfg, optimizer, paired=True, group=group)
    done_steps, metrics = 0, {}
    for epoch, (xr, yr), mini in _stream_minibatches(wrapped, params, dataset, extract, cfg, batch_size, epochs,
                                                     mesh):
        if opt_state is None:
            tc_params = _calibrate_transcoder_init(tc_params, xr, yr)
            opt_state = optimizer.init(tc_params)
        tc_params, opt_state, stats, metrics = runner(tc_params, opt_state, stats, mini)
        s = mini[0].shape[0]
        done_steps += s
        if _log_due(log_every, done_steps, s):
            m = _last(metrics)
            logger.info("transcoder epoch %d step %d: loss %.4g fvu %.3f l0 %.1f",
                        epoch, done_steps, m["loss"], m["fvu"], m["l0"])
    return finalize_sae_params(tc_params, cfg), stats, _last(metrics)


def _place(dictionary: Mapping, device) -> dict:
    """float32 tensors on ``device`` (numpy or tensors in), ``k`` as an int."""
    return {n: int(v) if n == "k" else _f32(v, device) for n, v in dictionary.items()}


class _CodesTap(SubjectModel):
    """A base model plus a dictionary whose codes of ``source`` are the virtual tap ``virtual``."""

    def __init__(self, base: SubjectModel, source: str, virtual: str, key: str, dictionary: Mapping, k,
                 base_params, name: str | None, kind: str, missing_k: str):
        self.base = base
        self.device = base.device
        stored_k = dictionary.get("k")
        if k is None:
            if stored_k is None:
                raise ValueError(missing_k)
            k = stored_k
        elif stored_k is not None and int(stored_k) != int(k):
            raise ValueError(f"k={int(k)} contradicts the sparsity the dictionary was trained for "
                             f"({key}_params['k']={int(stored_k)}).")
        self.k = int(k)
        self._source, self._virtual, self._key = source, virtual, key
        self.module_names = tuple(base.module_names) + (virtual,)
        self._dictionary = _place(dictionary, self.device)
        base_params = base_params if base_params is not None else getattr(base, "params", None)
        if base_params is not None:
            self.params = {"base": base_params, key: self._dictionary}
        if name is None:
            base_name = getattr(base, "name", base.__class__.__name__)
            n_latents = int(self._dictionary["W_dec"].shape[0])
            name = f"{base_name}-{kind}_{source}_{n_latents}k{self.k}_{_params_digest(self._dictionary)}"
        self.name = name

    def init(self, seed: int = 0):
        return {"base": self.base.init(seed), self._key: self._dictionary}

    def apply(self, params, x, tap_names=()):
        tap_names = tuple(tap_names)
        want = self._virtual in tap_names
        base_taps = tuple(t for t in tap_names if t != self._virtual)
        need = base_taps if not want else tuple(dict.fromkeys(base_taps + (self._source,)))
        out, taps = self.base.apply(params["base"], x, need)
        if want:
            codes = encode(params[self._key], taps[self._source], k=self.k)
            if self._source not in base_taps:
                del taps[self._source]
            taps[self._virtual] = codes
        return out, taps


class SAESubjectModel(_CodesTap):
    """Subject model exposing a trained SAE's codes as a virtual tap ``"{layer}.sae"``.

    The codes keep the layer's spatial/token structure — (B, H, W,
    n_latents) for conv taps, (B, T, n_latents) for token taps — so every
    aggregator applies; base taps stay available. ``params`` is ``{"base":
    base_params, "sae": sae_params}``, the dictionary placed on the base
    model's device. The default name carries a digest of ``W_dec``, so a
    retrained dictionary never hits a stale cache.

    Causal path: an SAE latent never feeds the forward directly, so an
    intervention on ``"{layer}.sae"`` substitutes the layer's activation
    with encode → rewrite → decode (the semantics of
    ``causal.sae_latent_ablation``: the baseline includes the SAE's
    reconstruction error; compare against an identity rewrite, not the raw
    forward, to isolate a latent's effect).
    """

    def __init__(self, base: SubjectModel, layer_name: str, sae_params: Mapping, *, k: int | None = None,
                 base_params=None, name: str | None = None):
        if not base.has_module(layer_name):
            raise ValueError(f"Layer '{layer_name}' not found in model.")
        self.layer_name = layer_name
        self.sae_tap = f"{layer_name}.sae"
        super().__init__(
            base, layer_name, self.sae_tap, "sae", sae_params, k, base_params, name, "sae",
            "Encode-time sparsity unknown: sae_params carries no 'k' entry and none was passed. "
            "A TopK-trained dictionary encoded densely (k=0) collects evidence on a code "
            "distribution it was never trained for — pass k= explicitly, or train via "
            "semanticlens_tpu_torch.sae (whose trainers stamp 'k' into the params).",
        )

    def apply(self, params, x, tap_names=()):
        if not has_intervention(self.sae_tap):
            return super().apply(params, x, tap_names)
        if "b_in" in params["sae"]:
            raise ValueError(
                "this dictionary is a transcoder (decodes into a DIFFERENT tap's space); in-place "
                f"substitution of '{self.layer_name}' would be dimensionally wrong — use "
                "TranscoderSubjectModel, which replaces the target tap instead"
            )
        tap_names = tuple(tap_names)
        stash = {}

        def _substitute(v):
            z = apply_interventions(self.sae_tap, encode(params["sae"], v, k=self.k))
            stash["codes"] = z
            return decode(params["sae"], z).to(v.dtype)

        with interventions({self.layer_name: _substitute}):
            out, taps = self.base.apply(params["base"], x, tuple(t for t in tap_names if t != self.sae_tap))
        if self.sae_tap in tap_names:
            taps[self.sae_tap] = stash["codes"]
        return out, taps


class TranscoderSubjectModel(_CodesTap):
    """Subject model exposing a trained transcoder's codes as a virtual tap ``"{tap_in}.tc"``.

    The codes keep the input tap's structure and flow through the standard
    pipeline like SAE latents. ``params`` is ``{"base": base_params, "tc":
    transcoder_params}``.

    Patch path: when the virtual tap carries an intervention, or with
    ``replace=True``, the TARGET tap's activation is substituted with
    ``decode(rewrite(encode(tap_in)))`` (plus ``W_skip`` · ``tap_in`` for a
    skip transcoder) — the MLP-replacement patch of transcoder circuit
    analysis (arXiv:2406.11944); ``replace=True`` with no rewrite measures
    the patched model's fidelity.
    """

    def __init__(self, base: SubjectModel, tap_in: str, tap_out: str, tc_params: Mapping, *, k: int | None = None,
                 base_params=None, replace: bool = False, name: str | None = None):
        for tap in (tap_in, tap_out):
            if not base.has_module(tap):
                raise ValueError(f"Layer '{tap}' not found in model.")
        if tap_in == tap_out:
            raise ValueError(
                "tap_in == tap_out is not a transcoder (it predicts a "
                "DIFFERENT tap); use SAESubjectModel for in-place dictionaries"
            )
        if "b_in" not in tc_params:
            raise ValueError(
                "tc_params is a plain SAE dictionary (no 'b_in'); train via "
                "train_transcoder_on_layer / train_transcoder_from_rows"
            )
        self.tap_in, self.tap_out = tap_in, tap_out
        self.replace = bool(replace)
        self.tc_tap = f"{tap_in}.tc"
        super().__init__(base, tap_in, self.tc_tap, "tc", tc_params, k, base_params, name, "tc",
                         "pass k= or train via semanticlens_tpu_torch.sae (trainers stamp 'k' into the params)")

    def apply(self, params, x, tap_names=()):
        if not (self.replace or has_intervention(self.tc_tap)):
            return super().apply(params, x, tap_names)
        # capture tap_in in flight, rewrite its codes, substitute the prediction for
        # tap_out; tap_in precedes tap_out in the forward, so its stash is ready
        tap_names = tuple(tap_names)
        tc = params["tc"]
        stash = {}

        def _capture(v):
            stash["codes"] = apply_interventions(self.tc_tap, encode(tc, v, k=self.k))
            stash["x"] = v
            return v

        def _substitute(v):
            return decode(tc, stash["codes"], stash["x"] if "W_skip" in tc else None).to(v.dtype)

        with interventions({self.tap_in: _capture, self.tap_out: _substitute}):
            out, taps = self.base.apply(params["base"], x, tuple(t for t in tap_names if t != self.tc_tap))
        if self.tc_tap in tap_names:
            taps[self.tc_tap] = stash["codes"]
        return out, taps


def _params_digest(sae_params: Mapping, n: int = 8) -> str:
    """sha256 of ``W_dec``'s float32 bytes (C order, the JAX layout), first ``n`` hex digits:
    the JAX package's digest, so cache identity follows the dictionary across packages."""
    w = sae_params["W_dec"]
    w = w.detach().to("cpu", torch.float32).numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
    return hashlib.sha256(np.ascontiguousarray(w, np.float32).tobytes()).hexdigest()[:n]
