"""Traffic kind ``sweep``: a closed loop of whole Collect+Embed sweeps, one at a time, back to back.

Each sweep is ``Lens.compute_concept_db(cv, batch_size=B)`` over an
``ActivationComponentVisualizer`` with no cache directory, over the mix's
``images`` distinct scenes held in host memory: the fused pass (subject
forward, aggregation, top-k; preprocess and image embedding) and the
concept DB's gather. The mix (``traffic/<mix>.json``) gives ``images``,
``image_size``, ``batch_size``, ``num_samples`` and ``check_components``;
the configuration gives the models, the components, the aggregation and
both preprocessings.

End-to-end: ``images_per_s``, the images of every sweep over the time from
the first sweep's start to the last sweep's return (the sweep under way
when the window's seconds run out is finished and counted).

Traced runs wrap the subject's ``apply``, the FM's ``preprocess`` and
image encode and the subject preprocess in spans, time the orchestration
after the fused pass on the host, and profile the second sweep.

Correctness, once the window has closed and the program is freed, on the
last sweep's concept DB against the configuration's plain float32
reference over all images. A run computes the numbers that the cell's
``checks/<cell>.json`` names, each against its limit; ``tools/readings.py``
computes all of ``NUMBERS``:

- ``topk_gap`` / ``topk_gap_mean``: the largest / mean amount, in units of
  the component's spread over the images (its standard deviation, floored
  at the median component's), by which the reference's activation of the
  image the program put at a rank falls short of the reference's own value
  at that rank (an empty slot counts as 0);
- ``topk_miss``: the share of the reference's top-k images missing from
  the program's top-k;
- ``topk_value_err`` / ``topk_value_mse``: the largest gap / mean squared
  gap between a stored top-k value and the reference's activation of that
  image, in the same units;
- ``topk_far_share`` / ``topk_value_far_share``: the share of top-k slots
  whose pick / stored value is off by more than ``FAR`` spreads;
  ``topk_far1.25_share``: whose pick is off by more than ``NEAR`` spreads;
- ``topk_dup_ids``: repeated images within one component's top-k;
- ``embed_err`` / ``embed_cos_dist``: for ``check_components`` components
  per layer drawn from the seed, the largest relative distance / cosine
  distance of a concept-DB row from the reference's embedding of its
  image (an empty slot's row must be 0).
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.trace import profiled
from portbench.reference.ops import strict_float32
from portbench.reference.topk import ranked
from portbench.reference.weights import STREAMS

REF_BLOCK = 128  # images per block of the reference
FAR = 2.0  # a pick or a value this many spreads off the reference is wrong, whatever the precision
NEAR = 1.25  # a pick this many spreads off: a share that a fault which slips every pick a little still shows
TOPK_NUMBERS = ("topk_gap", "topk_gap_mean", "topk_miss", "topk_value_err", "topk_value_mse", "topk_far_share",
                "topk_far1.25_share", "topk_value_far_share", "topk_dup_ids")
EMBED_NUMBERS = ("embed_err", "embed_cos_dist")
NUMBERS = TOPK_NUMBERS + EMBED_NUMBERS


def setup(run) -> None:
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import ActivationComponentVisualizer
    from semanticlens_tpu_torch.data import ArrayDataset
    from semanticlens_tpu_torch.ops import aggregators

    cfg, mix = run.config, run.traffic
    run.state["images"] = inputs.images(run.seed, mix["images"], mix["image_size"], run.device)
    if run.variant == "control" and cfg["control"] == "reference-int8":
        return  # the reference takes the program's place: nothing of the program is built
    built = run.program.build(cfg, run.seed, run.device, control=run.variant == "control")
    spans, b = run.spans, mix["batch_size"]
    built.model.apply = spans.wrap("subject", built.model.apply, rows_arg=1, rows=b)
    built.fm.preprocess = spans.wrap("fm_preprocess", built.fm.preprocess, rows_arg=0, rows=b)
    encode = "encode_image_local" if hasattr(built.fm, "encode_image_local") else "encode_image"
    setattr(built.fm, encode, spans.wrap("fm_image", getattr(built.fm, encode), rows_arg=0, rows=b))
    dataset = ArrayDataset(run.state["images"], name=f"portbench-{run.name}")
    cv = ActivationComponentVisualizer(
        model=built.model, dataset_model=dataset, dataset_fm=dataset, layer_names=list(cfg["components"]),
        num_samples=mix["num_samples"], aggregate_fn=getattr(aggregators, cfg["aggregate"]), cache_dir=None,
        params=built.params,
        model_preprocess=spans.wrap("subject_preprocess", built.subject_preprocess, rows_arg=0, rows=b))
    run_fused = cv.engine.run_fused

    def timed_run_fused(*args, **kwargs):  # the orchestration span starts where the fused pass returns
        out = run_fused(*args, **kwargs)
        run.state["fused_returned"] = time.perf_counter()
        return out

    cv.engine.run_fused = timed_run_fused
    run.state.update(cv=cv, lens=Lens(built.fm), flops_per_image=run.program.flops_per_image(cfg))
    if run.warmup:
        sweep(run)


def sweep(run) -> dict:
    """One sweep through the program; returns the concept DB and times the orchestration after the fused pass."""
    db = run.state["lens"].compute_concept_db(run.state["cv"], batch_size=run.traffic["batch_size"])
    run.spans.add_host("orchestration", 1e3 * (time.perf_counter() - run.state["fused_returned"]))
    return db


def window(run) -> None:
    n = run.traffic["images"]
    if run.variant == "control" and run.config["control"] == "reference-int8":
        run.state["outputs"] = reference_in_place(run)
        run.attempted = 1
        return
    min_sweeps = 3 if run.trace else 1  # traced: the second sweep is profiled, the others give the spans
    sweeps, start = [], time.perf_counter()
    while True:
        profile = run.trace and len(sweeps) == 1
        run.spans.active, run.spans.annotate = run.trace and not profile, profile
        t0 = time.perf_counter()
        with profiled(run.traces, run.device) if profile else contextlib.nullcontext():
            with torch.profiler.record_function("portbench.sweep") if profile else contextlib.nullcontext():
                db = sweep(run)
                t1 = time.perf_counter()
        sweeps.append((t0, t1, profile))
        if t1 - start >= run.seconds and len(sweeps) >= min_sweeps:
            break
    run.spans.active = run.spans.annotate = False
    print("sweep seconds " + " ".join(f"{t1 - t0:.4f}" for t0, t1, _ in sweeps), file=sys.stderr, flush=True)
    run.attempted = len(sweeps)
    run.e2e["images_per_s"] = n * len(sweeps) / (sweeps[-1][1] - start)
    plain = [(t0, t1) for t0, t1, p in sweeps if not p]
    run.counters.update(images=n * len(plain), plain_sweeps_s=sum(t1 - t0 for t0, t1 in plain),
                        sweeps=len(sweeps),
                        flops_per_image=run.state["flops_per_image"])
    if run.traces:
        trace = run.traces[0]
        (lo, hi), = trace.windows("portbench.sweep")
        run.slice = (trace, lo, hi)
    cv = run.state["cv"]
    run.state["outputs"] = {
        layer: {"ids": np.asarray(cv.get_max_reference(layer)),
                "values": cv.actmax_cache[layer].activations.float().cpu().numpy(),
                "db": db[layer]}
        for layer in run.config["components"]}


def release(run) -> None:
    """Free the program's objects and its memory on the card before the reference runs."""
    for key in ("cv", "lens"):
        run.state.pop(key, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference_acts(run, ref) -> dict[str, torch.Tensor]:
    """(C, N) float32 reference activations of every component over every image."""
    imgs = run.state["images"]
    blocks: dict[str, list] = {layer: [] for layer in run.config["components"]}
    for s in range(0, len(imgs), REF_BLOCK):
        batch = torch.from_numpy(imgs[s : s + REF_BLOCK]).to(run.device)
        for layer, acts in ref.subject(batch).items():
            blocks[layer].append(acts.t())
    return {layer: torch.cat(b, dim=1) for layer, b in blocks.items()}


def _embed(run, ref, ids: np.ndarray) -> torch.Tensor:
    """Reference embeddings of the images ``ids`` (−1 entries give zero rows), (len(ids), D)."""
    imgs = run.state["images"]
    uniq = np.unique(ids[ids >= 0])
    table = {}
    for s in range(0, len(uniq), REF_BLOCK):
        part = uniq[s : s + REF_BLOCK]
        emb = ref.embed(torch.from_numpy(imgs[part]).to(run.device))
        table.update(zip(part.tolist(), emb))
    dim = next(iter(table.values())).shape[0] if table else 1
    zero = torch.zeros(dim, device=run.device)
    return torch.stack([table[i] if i >= 0 else zero for i in ids.tolist()]) if len(ids) else zero[:0]


def _checked_components(run) -> dict[str, np.ndarray]:
    rng = np.random.default_rng([run.seed, STREAMS["sample"]])
    m = run.traffic["check_components"]
    return {layer: np.sort(rng.choice(c, size=min(m, c), replace=False))
            for layer, c in run.config["components"].items()}


def worst(a: np.ndarray) -> float:
    """The largest entry, a NaN counting as +inf."""
    return float(np.nan_to_num(a, nan=np.inf, posinf=np.inf).max())


def _topk_parts(run, ref) -> dict[str, np.ndarray]:
    """Per top-k slot (flattened over layers and components): the pick's gap, the stored value's error and
    whether the reference's image at that rank is missing from the program's top-k (NaN for an empty
    reference slot); and the count of repeated images."""
    outputs, n, k = run.state["outputs"], run.traffic["images"], run.traffic["num_samples"]
    acts = _reference_acts(run, ref)
    parts = {key: [] for key in ("gap", "value_err", "miss")}
    dups = 0
    for layer, out in outputs.items():
        r = acts.pop(layer)
        spread = r.std(dim=1)
        spread = torch.maximum(spread, spread.median())
        ranked_vals, ranked_ids = ranked(r, k)
        prog = torch.as_tensor(out["ids"], device=r.device).long()
        missing = ~(ranked_ids[:, :, None] == prog[:, None, :]).any(dim=2)
        miss = torch.where(ranked_ids >= 0, missing.float(), torch.nan)
        ranked_vals, spread, r = ranked_vals.cpu().numpy(), spread.cpu().numpy()[:, None], r.cpu().numpy()
        ids = out["ids"]
        valid = (ids >= 0) & (ids < n)
        at_ids = np.where(valid, r[np.arange(ids.shape[0])[:, None], np.clip(ids, 0, n - 1)], 0.0)
        at_ids = np.where((ids >= n) | (ids < -1), -np.inf, at_ids)
        parts["gap"].append((ranked_vals - at_ids) / spread)
        parts["value_err"].append(np.abs(out["values"] - at_ids) / spread)
        parts["miss"].append(miss.cpu().numpy())
        for row in ids:
            real = row[row >= 0]
            dups += len(real) - len(np.unique(real))
    parts = {key: np.concatenate([a.ravel() for a in arrays]) for key, arrays in parts.items()}
    parts["dups"] = dups
    return parts


def _embed_parts(run, ref) -> tuple[np.ndarray, np.ndarray]:
    """Relative distance and cosine distance of each checked concept-DB row from the reference's."""
    outputs = run.state["outputs"]
    rel_l2, cos_dist = [], []
    for layer, comps in _checked_components(run).items():
        ids = outputs[layer]["ids"][comps]
        got = torch.as_tensor(np.asarray(outputs[layer]["db"][comps], np.float32), device=run.device)
        want = _embed(run, ref, ids.reshape(-1)).view(*ids.shape, -1)
        norm = torch.linalg.vector_norm(want, dim=-1)
        filled = torch.from_numpy(ids >= 0).to(run.device)
        scale = torch.where(filled, norm, norm[norm > 0].median())
        rel_l2.append((torch.linalg.vector_norm(got - want, dim=-1) / scale).cpu().numpy().ravel())
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        empty_ok = torch.linalg.vector_norm(got, dim=-1) == 0
        cos_dist.append(torch.where(filled, 1.0 - cos, torch.where(empty_ok, 0.0, 1.0)).cpu().numpy().ravel())
    return np.concatenate(rel_l2), np.concatenate(cos_dist)


def check(run, names=NUMBERS) -> dict[str, float]:
    """The numbers ``names`` (a subset of ``NUMBERS``), from the reference over every image."""
    unknown = set(names) - set(NUMBERS)
    if unknown:
        raise KeyError(f"the sweep's check computes no {sorted(unknown)}")
    out = {}
    with strict_float32(), torch.inference_mode():
        ref = run.reference.Reference(run.config, run.seed, run.device)
        if set(names) & set(TOPK_NUMBERS):
            p = _topk_parts(run, ref)
            out.update(topk_gap=worst(p["gap"]), topk_gap_mean=mean(p["gap"]),
                       topk_miss=float(np.nanmean(p["miss"])), topk_value_err=worst(p["value_err"]),
                       topk_value_mse=mean(p["value_err"] ** 2),
                       topk_far_share=share(p["gap"] > FAR), **{"topk_far1.25_share": share(p["gap"] > NEAR)},
                       topk_value_far_share=share(p["value_err"] > FAR), topk_dup_ids=float(p["dups"]))
        if set(names) & set(EMBED_NUMBERS):
            rel_l2, cos_dist = _embed_parts(run, ref)
            out.update(embed_err=worst(rel_l2), embed_cos_dist=worst(cos_dist))
    return {name: out[name] for name in names}


def share(mask: np.ndarray) -> float:
    return float(np.mean(mask))


def mean(a: np.ndarray) -> float:
    """The mean, a NaN or −inf-made infinity counting as +inf."""
    return float(np.mean(np.nan_to_num(a, nan=np.inf, posinf=np.inf)))


def reference_in_place(run) -> dict:
    """The control where the program has no path of its own: the reference in int8, in the program's place.

    Its outputs have the program's form: per layer the top-k ids and values
    (the same selection rule, empty slots first) and the concept DB rows of
    the checked components (the others are left zero: the check reads no
    other row).
    """
    cfg, k = run.config, run.traffic["num_samples"]
    imgs = run.state["images"]
    with strict_float32(), torch.inference_mode():
        ref = run.reference.Reference(cfg, run.seed, run.device, quant="int8")
        acts = _reference_acts(run, ref)
        outputs = {}
        checked = _checked_components(run)
        for layer, r in acts.items():
            vals, ids = ranked(r, k)
            ids = ids.cpu().numpy()
            db = np.zeros((r.shape[0], k, cfg["fm"]["embed_dim"]), np.float32)
            comps = checked[layer]
            db[comps] = _embed(run, ref, ids[comps].reshape(-1)).view(len(comps), k, -1).cpu().numpy()
            outputs[layer] = {"ids": ids, "values": vals.cpu().numpy(), "db": db}
        del acts, imgs
    return outputs
