"""Tokenizer-asset discovery: find vocab/merges/SentencePiece files locally (a copy of
``semanticlens_tpu.foundation_models.assets``; the port imports nothing of the JAX package).

The reference gets tokenizer assets implicitly through open_clip/HF downloads
(reference semanticlens/foundation_models/clip.py:58-62). This build is
offline-first: tokenizer *code* is native (tokenizer.py, sentencepiece.py)
and the learned asset files — exactly like model checkpoints — are looked up
on the local machine, in this order (explicitly passed directories first):

1. alongside a given checkpoint path;
2. ``$SEMANTICLENS_ASSETS`` (colon-separated directories), recursively;
3. the standard HuggingFace hub cache layout
   (``~/.cache/huggingface/hub/models--*/snapshots/*/``);
4. an installed ``open_clip`` package's bundled
   ``bpe_simple_vocab_16e6.txt.gz``, if one exists.

Every matched format is supported: open_clip's gzip'd merges, HF
``merges.txt``/``vocab.json`` pairs, HF ``tokenizer.json``, and raw
SentencePiece ``.model`` files.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Iterable, Sequence

logger = logging.getLogger(__name__)

CLIP_BPE_PATTERNS = ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt", "merges.txt", "tokenizer.json")
SENTENCEPIECE_PATTERNS = ("*.spm", "spiece.model", "sentencepiece.model", "tokenizer.model", "*.model")


def _env_dirs() -> list[Path]:
    raw = os.environ.get("SEMANTICLENS_ASSETS", "")
    return [Path(p).expanduser() for p in raw.split(os.pathsep) if p]


def _hf_snapshot_dirs(name_filter: str | None = None) -> Iterable[Path]:
    """HF-hub snapshot dirs, optionally restricted to model names containing
    ``name_filter`` (case-insensitive) — the hub cache is shared across every
    model a user ever downloaded, so unfiltered discovery there could bind an
    unrelated model's tokenizer."""
    hub = Path(os.environ.get("HF_HOME", "~/.cache/huggingface")).expanduser() / "hub"
    if not hub.is_dir():
        return
    for model_dir in sorted(hub.glob("models--*")):
        if name_filter is not None and name_filter.lower() not in model_dir.name.lower():
            continue
        yield from sorted(model_dir.glob("snapshots/*"))


def _open_clip_dir() -> Path | None:
    try:
        import open_clip  # noqa: PLC0415 — optional, not in this image

        return Path(open_clip.__file__).parent
    except ImportError:
        return None


def iter_assets(
    patterns: Sequence[str],
    *,
    near: str | Path | None = None,
    extra_dirs: Sequence[str | Path] = (),
    hf_name_filter: str | None = None,
) -> Iterable[tuple[Path, str]]:
    """Yield (file, source) pairs matching any pattern, best-first.

    ``near`` adds a checkpoint's own directory (assets usually ship next to
    weights). Search order is deterministic: explicit dirs → checkpoint dir →
    $SEMANTICLENS_ASSETS → HF cache snapshots (``hf_name_filter``ed) →
    installed open_clip. ``source`` is one of explicit/near/env/hf/open_clip
    — callers treat explicitly-pointed-at roots as authoritative but validate
    shared-cache hits harder.
    """
    roots: list[tuple[Path, str]] = [(Path(d).expanduser(), "explicit") for d in extra_dirs]
    if near is not None:
        p = Path(near).expanduser()
        roots.append((p if p.is_dir() else p.parent, "near"))
    roots += [(d, "env") for d in _env_dirs()]
    roots += [(d, "hf") for d in _hf_snapshot_dirs(hf_name_filter)]
    oc = _open_clip_dir()
    if oc is not None:
        roots.append((oc, "open_clip"))

    seen = set()
    for root, source in roots:
        if not root.is_dir():
            continue
        for pattern in patterns:
            hits = sorted(root.glob(pattern)) or sorted(root.rglob(pattern))
            for hit in hits:
                if hit.is_file() and hit not in seen:
                    seen.add(hit)
                    yield hit, source


def find_asset(
    patterns: Sequence[str],
    *,
    near: str | Path | None = None,
    extra_dirs: Sequence[str | Path] = (),
) -> Path | None:
    """First file matching any pattern across the search roots, or None."""
    for hit, _source in iter_assets(patterns, near=near, extra_dirs=extra_dirs):
        logger.info("found tokenizer asset %s", hit)
        return hit
    return None


def find_clip_bpe(near: str | Path | None = None) -> Path | None:
    """Locate a CLIP BPE vocabulary in any supported format.

    Hub-cache hits are restricted to model dirs with "clip" in the name —
    other byte-level BPE models (e.g. GPT-2) ship a merges.txt that would
    build a plausible-looking but wrong vocabulary.
    """
    for hit, _source in iter_assets(CLIP_BPE_PATTERNS, near=near, hf_name_filter="clip"):
        logger.info("found CLIP BPE asset %s", hit)
        return hit
    return None


def find_sentencepiece(
    near: str | Path | None = None, *, expected_vocab: int | None = None
) -> Path | None:
    """Locate a SentencePiece ``.model`` file (content-validated).

    ``expected_vocab``: when given, hub-cache hits whose piece count differs
    are skipped (a shared cache can hold many unrelated SentencePiece models);
    explicitly-configured roots only warn — the user pointed there on purpose
    (and tests use tiny vocabularies deliberately).
    """
    from semanticlens_tpu_torch.foundation_models.sentencepiece import parse_model

    for hit, source in iter_assets(SENTENCEPIECE_PATTERNS, near=near):
        try:  # guard against e.g. a torch checkpoint named *.model
            model = parse_model(hit.read_bytes())
        except (ValueError, IndexError):
            logger.warning("%s matched a SentencePiece pattern but is not a .model file", hit)
            continue
        if expected_vocab is not None and model.vocab_size != expected_vocab:
            if source in ("hf", "open_clip"):
                logger.warning(
                    "skipping %s: %d pieces, expected %d", hit, model.vocab_size, expected_vocab
                )
                continue
            logger.warning(
                "%s has %d pieces, expected %d — using it anyway (explicitly configured root)",
                hit,
                model.vocab_size,
                expected_vocab,
            )
        logger.info("found SentencePiece model %s", hit)
        return hit
    return None
