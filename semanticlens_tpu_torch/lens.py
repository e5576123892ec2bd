"""Lens: orchestration of concept-DB computation, probing and scores.

Counterpart of ``semanticlens_tpu.lens``. The Lens owns the foundation model
and the concept-DB cache; the component visualizer owns the embed loop
(``cv._compute_concept_db(fm)``). Cache layout and file names are those of
the JAX package and the reference, so concept DBs interchange.

Scores, probes and labels run on the foundation model's device.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from semanticlens_tpu_torch.collect.base import AbstractComponentVisualizer
from semanticlens_tpu_torch.core.mesh import ShardedRows, barrier, is_writer
from semanticlens_tpu_torch.foundation_models.base import AbstractVLM
from semanticlens_tpu_torch.scores import (
    clarity_score,
    cosine_probe,
    fastcav,
    polysemanticity_score,
    redundancy_score,
    soft_wpmi,
    topk_cosine_search,
)
from semanticlens_tpu_torch.utils import safetensors_io
from semanticlens_tpu_torch.utils.helper import get_fallback_name

logger = logging.getLogger(__name__)


def compute_concept_db(cv: AbstractComponentVisualizer, fm: AbstractVLM):
    """Stateless IoC entry point."""
    return cv._compute_concept_db(fm)


def text_probing(fm: AbstractVLM, query, aggregated_concept_db, templates=None, batch_size=None):
    """Cosine-probe an aggregated concept DB with natural-language queries.

    With ``templates``, each empty template's embedding is subtracted from
    the filled one before averaging — the reference's prompt-bias correction,
    including its ``(q t)`` reshape of a template-outer list.
    """
    queries = query if isinstance(query, list) else [query]
    query_embeds = _embed_text_probes(fm, queries, templates, batch_size)
    if query_embeds.ndim != 2 or query_embeds.shape[0] != len(queries):
        raise RuntimeError(f"query embeddings have shape {tuple(query_embeds.shape)}")
    return _probe(query_embeds, aggregated_concept_db)


def image_probing(fm: AbstractVLM, query, aggregated_concept_db):
    """Cosine-probe with image queries; several images mean-pool into one probe."""
    with torch.inference_mode():
        query_embed = fm.encode_image(fm.preprocess(query)).float()
    if query_embed.shape[0] > 1:
        query_embed = query_embed.mean(0, keepdim=True)
    return _probe(query_embed, aggregated_concept_db)


def cav_probing(fm: AbstractVLM, concept_images, negative_images, aggregated_concept_db):
    """Probe components with a FastCAV direction from concept and negative images.

    Both image sets are embedded with the FM; the unit class-mean difference
    (:func:`~semanticlens_tpu_torch.scores.fastcav`) probes the aggregated
    DB. Returns ``{layer: (1, C) scores}`` (or a bare array), as
    :func:`image_probing` does.
    """
    with torch.inference_mode():
        pos = fm.encode_image(fm.preprocess(concept_images)).float()
        neg = fm.encode_image(fm.preprocess(negative_images)).float()
    if pos.ndim != 2 or neg.ndim != 2:
        raise ValueError("concept/negative images must embed to (N, D) batches")
    return _probe(fastcav(pos, neg)[None], aggregated_concept_db)


def _encode_text_chunked(fm: AbstractVLM, texts: list[str], batch_size: int | None) -> torch.Tensor:
    """tokenize+encode ``texts`` in ``batch_size`` chunks (one batch if None)."""
    step = batch_size or len(texts)
    with torch.inference_mode():
        return torch.cat([
            fm.encode_text(fm.tokenize(texts[i : i + step])).float()
            for i in range(0, len(texts), step)
        ])


def _embed_text_probes(fm: AbstractVLM, query: list[str], templates, batch_size):
    """Templating and embedding of text probes."""
    if not templates:
        return _encode_text_chunked(fm, query, batch_size)
    query_templated = [t.format(q) for t in templates for q in query]
    templated = _encode_text_chunked(fm, query_templated, batch_size)
    empty = _encode_text_chunked(fm, [t.format("") for t in templates], None)
    q, t = len(query), len(templates)
    # The list is template-outer / query-inner, but the reference splits the
    # flat axis query-outer ("(q t) d -> q t d"); kept as is for score parity.
    return (templated.reshape(q, t, -1) - empty[None]).mean(1)


def label_components(
    fm: AbstractVLM,
    vocabulary: list[str],
    aggregated_concept_db,
    *,
    top_m: int = 5,
    templates: list[str] | None = None,
    batch_size: int | None = None,
    vocab_embeds=None,
    scoring: str = "cosine",
    evidence_ids=None,
    image_embeds=None,
    **wpmi_kwargs,
):
    """Name each component with its best-matching vocabulary words (CLIP-Dissect style).

    ``scoring="cosine"`` matches each component's mean concept vector
    against every word (:func:`~semanticlens_tpu_torch.scores.topk_cosine_search`);
    ``scoring="wpmi"`` scores words by soft-WPMI over the component's
    top-activating images and needs ``evidence_ids`` ((C, k) per layer) and
    ``image_embeds`` (the (N, D) dataset table, ``cv.embedding_table``);
    extra kwargs go to :func:`~semanticlens_tpu_torch.scores.soft_wpmi`.

    Returns ``{layer: (words (C, top_m) list of lists, scores (C, top_m)
    float32)}``, or one tuple for a bare array.
    """
    if not vocabulary:
        raise ValueError("vocabulary must be a non-empty list of words")
    if scoring not in ("cosine", "wpmi"):
        raise ValueError(f"scoring must be 'cosine' or 'wpmi', got {scoring!r}")
    top_m = min(top_m, len(vocabulary))
    if vocab_embeds is None:
        vocab_embeds = _embed_vocabulary(fm, list(vocabulary), templates, batch_size or 1024)
    elif vocab_embeds.shape[0] != len(vocabulary):
        raise ValueError(f"vocab_embeds has {vocab_embeds.shape[0]} rows for {len(vocabulary)} words")
    if scoring == "wpmi" and (evidence_ids is None or image_embeds is None):
        raise ValueError(
            "scoring='wpmi' needs evidence_ids (top-k sample ids per layer) and "
            "image_embeds (the (N, D) dataset embedding table)"
        )

    def one(bank, ids=None):
        if scoring == "wpmi":
            ids = np.asarray(ids)
            n_bank = bank.shape[0]
            if ids.ndim != 2 or ids.shape[0] != n_bank:
                raise ValueError(
                    f"evidence_ids shape {ids.shape} does not match the "
                    f"{n_bank}-component concept bank (slice both the same way)"
                )
            scores = soft_wpmi(vocab_embeds, image_embeds, ids, device=fm.device, **wpmi_kwargs)
            order = np.argsort(-scores, axis=1)[:, :top_m]
            words = [[vocabulary[j] for j in row] for row in order]
            return words, np.take_along_axis(scores, order, axis=1).astype(np.float32)
        vals, idx = topk_cosine_search(bank, vocab_embeds, k=top_m, device=fm.device)
        words = [[vocabulary[j] for j in row] for row in idx.cpu().numpy()]
        return words, vals.cpu().numpy()

    if isinstance(aggregated_concept_db, dict):
        if scoring == "wpmi":
            if not isinstance(evidence_ids, dict):
                raise ValueError("evidence_ids must be a {layer: (C, k)} dict for a dict DB")
            missing = set(aggregated_concept_db) - set(evidence_ids)
            if missing:
                raise ValueError(f"evidence_ids missing layers: {sorted(missing)}")
        return {
            key: one(value, evidence_ids[key] if scoring == "wpmi" else None)
            for key, value in aggregated_concept_db.items()
        }
    return one(aggregated_concept_db, evidence_ids)


def _embed_vocabulary(fm: AbstractVLM, words: list[str], templates, batch_size: int) -> torch.Tensor:
    """Templated embeddings of a vocabulary with the (word, template) pairing kept straight.

    Not :func:`_embed_text_probes`, whose ``(q t)`` reshape (the reference's
    quirk) scrambles the pairing once there are several words and
    templates: here the list is template-outer and reshaped (t, q, d), each
    template's empty-prompt embedding is subtracted, and the mean is over
    templates. Always chunked by ``batch_size``.
    """
    if not templates:
        return _encode_text_chunked(fm, words, batch_size)
    q, t = len(words), len(templates)
    templated = [tpl.format(w) for tpl in templates for w in words]
    embeds = _encode_text_chunked(fm, templated, batch_size).reshape(t, q, -1)
    empty = _encode_text_chunked(fm, [tpl.format("") for tpl in templates], batch_size)
    return (embeds - empty[:, None, :]).mean(0)


def _probe(query, aggregated_concept_db):
    """(Q, C) cosine scores as float32 numpy, per layer for a dict DB."""

    def one(bank):
        bank = torch.as_tensor(bank, dtype=torch.float32, device=query.device)
        return cosine_probe(query, bank).cpu().numpy()

    if isinstance(aggregated_concept_db, dict):
        return {key: one(value) for key, value in aggregated_concept_db.items()}
    return one(aggregated_concept_db)


class Lens:
    """Stateful entry point: holds a foundation model, orchestrates the flow.

    Scores run on ``fm.device``.
    """

    def __init__(self, fm: AbstractVLM):
        self.fm: AbstractVLM = fm
        self.device = fm.device
        if not hasattr(self.fm, "name"):
            self.fm.name = get_fallback_name(self.fm)

    def compute_concept_db(self, cv: AbstractComponentVisualizer, **kwargs) -> dict[str, np.ndarray]:
        """Compute or load-from-cache the concept database for ``cv``.

        Keyword arguments (``batch_size``, ``checkpoint``: samples between
        sweep checkpoints) go to ``cv._compute_concept_db``. Cache key:
        ``{cv.storage_dir}/concept_database/{fm.name}/concept_db-
        {metadata-values-minus-dataset-and-model}.safetensors``.
        """
        if not cv.caching:
            return cv._compute_concept_db(self.fm, **kwargs)
        fdir = cv.storage_dir / "concept_database" / self.fm.name
        fdir.mkdir(parents=True, exist_ok=True)
        fname = (
            "concept_db-"
            + "-".join([v for k, v in cv.metadata.items() if k not in ["dataset", "model"]])
            + ".safetensors"
        )
        fpath = fdir / fname
        if fpath.exists():
            return {k: v.numpy() for k, v in safetensors_io.load_file(fpath).items()}
        concept_db = cv._compute_concept_db(self.fm, **kwargs)
        mesh = getattr(cv, "mesh", None)  # under a mesh every rank has the DB; global rank 0 writes it
        if is_writer(mesh):
            safetensors_io.save_file(
                {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in concept_db.items()},
                fpath,
            )
        if mesh is not None:
            barrier()
        return concept_db

    def text_probing(self, query, aggregated_concept_db, templates=None, batch_size=None):
        """Wrapper over the stateless :func:`text_probing` with the held FM."""
        return text_probing(self.fm, query, aggregated_concept_db, templates, batch_size)

    def image_probing(self, query, aggregated_concept_db):
        """Wrapper over the stateless :func:`image_probing` with the held FM."""
        return image_probing(self.fm, query, aggregated_concept_db)

    def cav_probing(self, concept_images, negative_images, aggregated_concept_db):
        """Wrapper over the stateless :func:`cav_probing` with the held FM."""
        return cav_probing(self.fm, concept_images, negative_images, aggregated_concept_db)

    def label_components(self, vocabulary, aggregated_concept_db, **kwargs):
        """Wrapper over the stateless :func:`label_components` with the held FM."""
        return label_components(self.fm, vocabulary, aggregated_concept_db, **kwargs)

    def _score_input(self, value):
        """float32 tensor on the Lens device (tensors already there stay); a ``ShardedRows``
        (``core.shard_concept_db``) keeps its split with its rows moved there."""
        if isinstance(value, ShardedRows):
            return dataclasses.replace(value, local=self._score_input(value.local))
        return torch.as_tensor(value).to(self.device, torch.float32)

    def _per_layer(self, fn, db):
        if isinstance(db, dict):
            return {key: fn(self._score_input(value)) for key, value in db.items()}
        return fn(self._score_input(db))

    def eval_clarity(self, concept_db):
        """Clarity per component."""
        return self._per_layer(clarity_score, concept_db)

    def eval_redundancy(self, aggregated_concept_db):
        """Redundancy across components."""
        return self._per_layer(redundancy_score, aggregated_concept_db)

    def eval_polysemanticity(self, concept_db):
        """Polysemanticity per component."""
        return self._per_layer(polysemanticity_score, concept_db)
