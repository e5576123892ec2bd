"""Text-modality Collect+Embed: dissect language models with the same pipeline.

Counterpart of ``semanticlens_tpu.collect.text_based``. Components of a
transformer LM (MLP neurons, attention heads, SAE latents of a token tap)
go through the unchanged Collect→Embed→Analyze machinery; only the Embed
stage differs: evidence samples are strings, embedded by the foundation
model's text tower (``fm.tokenize`` → ``fm.encode_text``). The concept DB
lives in the same joint space, so probing, naming, the scores and causal
checks apply as they are.

Usage sketch::

    lm = GPT2(...); lm.params = lm.init(0); lm.name = "gpt2"
    tokens = TokenTextDataset.from_texts(texts, tokenize_fn, 64, pad_id=lm.pad_id, name="prompts")
    cv = TextActivationComponentVisualizer(
        model=lm, dataset_model=tokens, dataset_fm=tokens.texts_view(),
        layer_names=["transformer.h.3.mlp.act"], num_samples=9, cache_dir="cache")
    db = lens.compute_concept_db(cv, batch_size=64)

The Collect sweep streams (B, T) int32 token batches through the engine as
image batches are streamed (top-k state, checkpoints and cache format are
the same); the engine's input preprocess keeps them integer. A ragged last
batch is padded with token 0 rows, which the engine masks out of the top-k.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from semanticlens_tpu_torch.collect.activation_based import ActivationComponentVisualizer
from semanticlens_tpu_torch.collect.sae_based import SAEComponentVisualizer
from semanticlens_tpu_torch.ops import aggregators
from semanticlens_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class _TextsView:
    """List-of-strings dataset facade with a stable name for cache identity."""

    def __init__(self, texts, name: str | None = None):
        self.texts = list(texts)
        if name is not None:
            self.name = name

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, i):
        return self.texts[i]


class TokenTextDataset:
    """Paired (token row, raw string) samples for LM dissection.

    ``tokens`` is an (N, T) int array (the subject model's tokenization,
    fixed length; prefer left-padding, so
    :func:`~semanticlens_tpu_torch.ops.aggregators.aggregate_transformer_last_token`
    reads a real token at T−1); ``texts`` the N strings the FM embeds. The
    dataset yields token rows (what the collect engine streams);
    :meth:`texts_view` yields the strings (what the Embed stage consumes).

    Padded corpora need a pad-aware subject: build the LM with the same
    ``pad_id`` so pad tokens are masked out of attention and positions count
    real tokens.
    """

    def __init__(self, tokens, texts, name: str | None = None, *, pad_id: int | None = None,
                 pad: str | None = None):
        self.images = np.asarray(tokens)  # `.images`: the batch assembler's fast path
        if self.images.ndim != 2:
            raise ValueError(f"tokens must be (N, T), got {self.images.shape}")
        self.texts = list(texts)
        if len(self.texts) != len(self.images):
            raise ValueError(f"tokens/texts length mismatch: {len(self.images)} vs {len(self.texts)}")
        self.pad_id = pad_id
        self.pad = pad
        if name is not None:
            self.name = name

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i]

    @classmethod
    def from_texts(cls, texts, tokenize_fn, seq_len: int, *, pad: str = "left", pad_id: int = 0,
                   name: str | None = None) -> "TokenTextDataset":
        """Tokenize and pad a corpus into a fixed-length dataset.

        ``tokenize_fn(text) -> sequence of ints`` is the subject model's
        tokenizer. Over-long sequences keep their tail (``ids[-seq_len:]``),
        so the final real token survives; short ones pad with ``pad_id``,
        on the left by default (the final token stays at T−1). Pick a
        ``pad_id`` that never starts or ends a real text: the models mask
        edge runs only.
        """
        if pad not in ("left", "right"):
            raise ValueError(f"pad must be 'left' or 'right', got {pad!r}")
        rows = np.full((len(texts), seq_len), pad_id, np.int32)
        for i, t in enumerate(texts):
            ids = list(tokenize_fn(t))[-seq_len:]
            if pad == "left":
                rows[i, seq_len - len(ids):] = ids
            else:
                rows[i, : len(ids)] = ids
        return cls(rows, texts, name=name, pad_id=pad_id, pad=pad)

    def texts_view(self) -> _TextsView:
        return _TextsView(self.texts, name=getattr(self, "name", None))


def _keep_tokens_integer(x):
    """Engine input preprocess for token batches: int32 ids, never a float cast."""
    return x.to(torch.int32)


class TextActivationComponentVisualizer(ActivationComponentVisualizer):
    """ActivationComponentVisualizer for language-model subjects.

    The vision visualizer's constructor with two text defaults:
    ``aggregate_fn`` falls back to the token mean (activations are (B, T,
    D)), and the engine's input preprocess keeps tokens integer (the
    default float32 cast would break the embedding gather). ``dataset_fm``
    must yield strings (:meth:`TokenTextDataset.texts_view`). ``mesh``:
    data-parallel collect over the token batches, as for images.
    """

    def __init__(
        self,
        model,
        dataset_model,
        dataset_fm,
        layer_names,
        num_samples,
        aggregate_fn=None,
        cache_dir=None,
        mesh=None,
        params=None,
        model_preprocess=None,
    ):
        super().__init__(
            model,
            dataset_model,
            dataset_fm,
            layer_names,
            num_samples,
            aggregate_fn=aggregate_fn or aggregators.aggregate_transformer_mean,
            cache_dir=cache_dir,
            mesh=mesh,
            params=params,
            model_preprocess=model_preprocess or _keep_tokens_integer,
        )

    def _run_fused(self, fm, batch_size: int, checkpoint: int = 0) -> np.ndarray:
        """No fused path for text: Collect streams tokens while Embed consumes strings.
        Reaching here means ``dataset_fm`` was the token dataset itself."""
        raise TypeError(
            "dataset_fm must yield raw strings for the text Embed stage "
            "(pass TokenTextDataset.texts_view(), not the token dataset)"
        )

    def _embed_vision_dataset(self, fm, batch_size: int, checkpoint: int = 512, **kwargs) -> np.ndarray:
        """Embed every evidence string once with the FM text tower → (N, D) float32.

        Replaces the image embed loop under the parent's name, so the
        concept-DB orchestration (embedding table, zero-row sentinels)
        applies as it is.
        """
        texts = [self.dataset_fm[i] for i in range(len(self.dataset_fm))]
        bad = next((t for t in texts if not isinstance(t, str)), None)
        if bad is not None:
            raise TypeError(f"dataset_fm must yield raw strings for the text Embed stage, got {type(bad)}")
        chunks, device = [], getattr(fm, "device", None)
        with torch.inference_mode():
            for start in range(0, len(texts), batch_size):
                tokens = fm.tokenize(texts[start : start + batch_size])
                with span("embed.encode_text", device):
                    chunks.append(fm.encode_text(tokens).float())
        embeds = torch.cat(chunks).cpu().numpy() if chunks else np.zeros((0, 1), np.float32)
        if embeds.shape[0] != len(texts):
            raise RuntimeError("Number of embeddings does not match number of ids!")
        return embeds

    def get_max_reference_texts(self, layer_name: str) -> list[list[str]]:
        """Top-activating evidence strings per component (−1 sentinels → '')."""
        ids = self.get_max_reference(layer_name)
        return [[self.dataset_fm[int(i)] if i >= 0 else "" for i in row] for row in ids]

    def visualize_components(self, component_ids, layer_name: str, n_samples: int = 5, save: bool = True,
                             **kwargs):
        """Text analogue of the image grid: one evidence block per component, returned as a string
        and, with caching, written to ``storage_dir/plots/{layer_name}-components.txt``."""
        texts = self.get_max_reference_texts(layer_name)
        lines = []
        for comp in component_ids:
            lines.append(f"[{layer_name} #{comp}]")
            for rank, t in enumerate(texts[int(comp)][:n_samples]):
                lines.append(f"  {rank + 1}. {t!r}")
        report = "\n".join(lines)
        if save and self.caching:
            out = self.storage_dir / "plots"
            out.mkdir(parents=True, exist_ok=True)
            path = out / f"{layer_name}-components.txt"
            path.write_text(report)
            logger.info(f"Wrote text evidence report to {path}")
        return report


class TextSAEComponentVisualizer(SAEComponentVisualizer, TextActivationComponentVisualizer):
    """SAE latents of a language model audited with text evidence.

    The SAE constructor wraps the subject with the virtual ``"{layer}.sae"``
    tap; the text class supplies the string Embed stage, the integer token
    preprocess and the text report. A latent's per-sample score stays
    ``aggregate_max_auto`` (the max over token positions).
    """

    @staticmethod
    def train(model, dataset, layer_name, cfg, *, model_preprocess=None, **kwargs):
        """SAE training over token batches, with the integer token preprocess by default."""
        return SAEComponentVisualizer.train(model, dataset, layer_name, cfg,
                                            model_preprocess=model_preprocess or _keep_tokens_integer, **kwargs)
