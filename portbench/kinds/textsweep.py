"""Traffic kind ``textsweep``: a closed loop of whole text Collect+Embed sweeps of an LM subject.

Each sweep is ``Lens.compute_concept_db(cv, batch_size=B)`` over a
``TextActivationComponentVisualizer`` with no cache directory: the collect
pass streams the corpus' token rows through the subject (forward, token
mean, top-k), the text Embed stage encodes every sequence's string with the
FM's text tower, then the concept DB's gather. The corpus is
``harness/text_inputs.py``'s, made from the seed on the host: the mix
(``traffic/<mix>.json``) gives ``sequences``, ``seq_len``, the token laws
(``zipf_s``, ``topics``, ``topic_vocab``, ``topic_share``), ``batch_size``,
``num_samples`` and ``check_components``; the configuration gives the
models, the components, the aggregation and ``fm_words``, the ids a
sequence's string renders.

Everything after the set-up is the sweep kind's (``kinds/sweep.py``): the
window, the release and the check, which count a sequence as one sample
(``images``): the end-to-end ``images_per_s`` is the sequences of every
sweep over the window's wall time, and the correctness check holds every
component's top-k over all sequences and the concept-DB rows of
``check_components`` components a layer against the configuration's plain
float32 reference, handed the token rows in blocks. The sweep's
orchestration span starts where the text Embed stage returns.
"""

from __future__ import annotations

import time
from pathlib import Path

from portbench.harness import text_inputs
from portbench.harness.bench import load_module

sweep = load_module(Path(__file__).with_name("sweep.py"), "portbench_kind_sweep")

NUMBERS = sweep.NUMBERS
window, release, check = sweep.window, sweep.release, sweep.check


def setup(run) -> None:
    from semanticlens_tpu_torch import Lens
    from semanticlens_tpu_torch.collect import TextActivationComponentVisualizer, TokenTextDataset
    from semanticlens_tpu_torch.ops import aggregators

    cfg, mix = run.config, run.traffic
    mix["images"] = mix["sequences"]  # the sweep kind's name for its samples
    tokens, texts = text_inputs.corpus(run.seed, mix, cfg["vocab_size"], cfg["fm_words"])
    run.state["images"] = tokens
    if run.variant == "control" and cfg["control"] == "reference-int8":
        return  # the reference takes the program's place: nothing of the program is built
    built = run.program.build(cfg, run.seed, run.device, control=run.variant == "control")
    b = mix["batch_size"]
    built.model.apply = run.spans.wrap("subject", built.model.apply, rows_arg=1, rows=b)
    dataset = TokenTextDataset(tokens, texts, name=f"portbench-{run.name}")
    cv = TextActivationComponentVisualizer(
        model=built.model, dataset_model=dataset, dataset_fm=dataset.texts_view(),
        layer_names=list(cfg["components"]), num_samples=mix["num_samples"],
        aggregate_fn=getattr(aggregators, cfg["aggregate"]), cache_dir=None, params=built.params)
    embed = cv._embed_vision_dataset

    def timed_embed(*args, **kwargs):  # the orchestration span starts where the text Embed stage returns
        out = embed(*args, **kwargs)
        run.state["fused_returned"] = time.perf_counter()
        return out

    cv._embed_vision_dataset = timed_embed
    run.state.update(cv=cv, lens=Lens(built.fm), flops_per_image=run.program.flops_per_image(cfg, mix["seq_len"]))
    if run.warmup:
        sweep.sweep(run)
