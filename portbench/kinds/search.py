"""Traffic kind ``search``: one caller's closed loop of top-k cosine searches over a component bank.

Set-up makes the bank, ``components`` × D float32 vectors (D the
configuration's embedding width), on the card from the seed. Each call is
``scores.topk_cosine_search(queries, bank, k)`` with ``queries`` fresh rows
made from (seed, call index) and the program's default chunk size; the
call's values and indices are copied to the host before the next call.
The mix (``traffic/<mix>.json``) gives ``components``, ``queries``, ``k``,
``warmup_calls``, ``profiled_calls`` and ``check_calls``.

End-to-end: ``search_queries_per_s``, every query answered over the
window, and ``search_p95_ms``, the 95th percentile of all calls'
latencies, from the call to its results on the host.

Traced runs profile calls 2 … ``profiled_calls`` + 1 of the window.

Correctness, once the window has closed: ``check_calls`` calls drawn from
the seed (the last call among them) against the plain reference, a dense
float32 cosine matrix sorted stably. ``NUMBERS``:

- ``value_err``: the largest gap between a returned value and the
  reference's value at that rank;
- ``rank_gap``: the largest amount by which the reference's cosine of the
  component returned at a rank falls short of the reference's value at
  that rank (an index out of range counts as −inf);
- ``dup_ids``: repeated components within one query's top-k.

The control puts the same dense reference in the program's place with
TF32 matmuls, one precision step below float32.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np
import torch

from portbench.harness import inputs
from portbench.harness.trace import profiled
from portbench.reference import topk as ref_topk
from portbench.reference.ops import strict_float32
from portbench.reference.weights import STREAMS

NUMBERS = ("value_err", "rank_gap", "dup_ids")


def _dim(run) -> int:
    return run.config["fm"]["embed_dim"]


def _call(run, i: int):
    """One call of the loop: its latency in ms and its results on the host."""
    mix = run.traffic
    q = inputs.queries(run.seed, i, mix["queries"], _dim(run), run.device)
    t0 = time.perf_counter()
    vals, idx = run.state["search"](q, run.state["bank"], mix["k"])
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    return 1e3 * (time.perf_counter() - t0), vals, idx


def _control_search(queries, bank, k):
    """The dense reference with TF32 matmuls, in the program's place."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return ref_topk.search(queries, bank, k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def setup(run) -> None:
    from semanticlens_tpu_torch import scores

    mix = run.traffic
    run.state["bank"] = inputs.bank(run.seed, mix["components"], _dim(run), run.device)
    run.state["search"] = _control_search if run.variant == "control" else scores.topk_cosine_search
    if run.warmup:
        for i in range(mix["warmup_calls"]):  # distinct from the window's calls: negative indices
            _call(run, -1 - i)


def window(run) -> None:
    mix = run.traffic
    lat, results, profiled_flags = [], [], []
    first_profiled, n_profiled = 1, mix["profiled_calls"] if run.trace else 0
    min_calls = first_profiled + n_profiled + 1 if run.trace else 1
    start = time.perf_counter()
    with contextlib.ExitStack() as stack:
        while True:
            i = len(lat)
            if n_profiled and i == first_profiled:
                stack.enter_context(profiled(run.traces, run.device))
            if n_profiled and i == first_profiled + n_profiled:
                stack.close()
            in_slice = first_profiled <= i < first_profiled + n_profiled
            ctx = torch.profiler.record_function("portbench.call") if in_slice else contextlib.nullcontext()
            with ctx:
                ms, vals, idx = _call(run, i)
            lat.append(ms)
            profiled_flags.append(in_slice)
            results.append((vals, idx))
            if time.perf_counter() - start >= run.seconds and len(lat) >= min_calls:
                break
    elapsed = time.perf_counter() - start
    q = statistics.quantiles(lat, n=20, method="inclusive") if len(lat) > 1 else lat * 19
    print(f"calls {len(lat)} latency_ms p50 {statistics.median(lat):.4f} p95 {q[-1]:.4f} max {max(lat):.4f}",
          file=sys.stderr, flush=True)
    run.attempted = len(lat)
    run.e2e["search_queries_per_s"] = mix["queries"] * len(lat) / elapsed
    run.e2e["search_p95_ms"] = q[-1]
    plain = [ms for ms, p in zip(lat, profiled_flags) if not p]
    run.counters.update(calls=len(lat), unprofiled_calls=len(plain),
                        unprofiled_call_s=1e-3 * sum(plain),
                        search_shape=(mix["queries"], mix["components"], _dim(run), mix["k"]))
    if run.traces:
        trace = run.traces[0]
        calls = trace.windows("portbench.call")
        run.slice = (trace, calls[0][0], calls[-1][1])
        run.counters["profiled_call_windows"] = calls
    run.state["results"] = results


def release(run) -> None:
    run.state.pop("search", None)


def worst(t: torch.Tensor) -> float:
    """The largest entry, a NaN counting as +inf."""
    return float(torch.nan_to_num(t, nan=torch.inf).max())


def _checked_calls(run) -> list[int]:
    n = len(run.state["results"])
    rng = np.random.default_rng([run.seed, STREAMS["sample"]])
    m = min(run.traffic["check_calls"], n)
    return sorted(set(rng.choice(n - 1, size=m - 1, replace=False).tolist()) | {n - 1}) if n > 1 else [0]


def check(run, names=NUMBERS) -> dict[str, float]:
    """The numbers ``names`` (a subset of ``NUMBERS``): all three come from the same calls."""
    unknown = set(names) - set(NUMBERS)
    if unknown:
        raise KeyError(f"the search's check computes no {sorted(unknown)}")
    mix, bank = run.traffic, run.state["bank"]
    errs, gaps = [], []
    dups = 0
    with strict_float32(), torch.inference_mode():
        for i in _checked_calls(run):
            vals, idx = run.state["results"][i]
            q = inputs.queries(run.seed, i, mix["queries"], _dim(run), run.device)
            picked = torch.as_tensor(idx, device=run.device)
            ref_vals, _, at_picked = ref_topk.search(q, bank, mix["k"], picked=picked)
            errs.append((torch.as_tensor(vals, device=run.device) - ref_vals).abs())
            gaps.append(ref_vals - at_picked)
            for row in idx:
                dups += len(row) - len(np.unique(row))
    errs, gaps = torch.cat(errs), torch.cat(gaps)
    out = {"value_err": worst(errs), "rank_gap": worst(gaps), "dup_ids": float(dups)}
    return {name: out[name] for name in names}
