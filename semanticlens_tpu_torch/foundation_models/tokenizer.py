"""Text tokenizers for the CLIP towers (a copy of ``semanticlens_tpu.foundation_models.tokenizer``;
the port imports nothing of the JAX package).

``ClipBpeTokenizer`` implements the CLIP byte-pair-encoding scheme
(byte→unicode table, lowercasing + whitespace cleanup, ``</w>`` word endings,
BPE merge loop, SOT/EOT framing to a fixed context length). It produces the
same token ids as open_clip's SimpleTokenizer given the same
``bpe_simple_vocab_16e6`` merges file — pass its path (plain or ``.gz``) as
``bpe_path``. The merges file ships with open_clip/CLIP distributions and is
not vendored here.

``HashTokenizer`` is a deterministic fallback for weightless testing
(mirrors the reference's ``load_weights=False`` test strategy, reference
tests/foundation_models/test_clip.py): stable ids, correct framing, no
vocabulary file needed. It is NOT CLIP-compatible and says so loudly.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import re
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte→unicode mapping (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _split_numeric_runs(tokens):
    """Split Unicode No/Nl characters (², ½, Ⅷ …) out of letter runs.

    Python's ``\\w`` absorbs them into ``[^\\W\\d_]+`` matches, but open_clip's
    ``\\p{N}`` emits them as single-character number tokens — replicate that.
    (``str.isdigit`` is useless here: it is True for ² although ``\\d`` does
    not match it, so classify by unicodedata category instead.)
    """
    import unicodedata

    def is_non_decimal_number(c):
        return unicodedata.category(c) in ("No", "Nl")

    out = []
    for tok in tokens:
        if any(is_non_decimal_number(c) for c in tok):
            run = ""
            for c in tok:
                if is_non_decimal_number(c):
                    if run:
                        out.append(run)
                        run = ""
                    out.append(c)
                else:
                    run += c
            if run:
                out.append(run)
        else:
            out.append(tok)
    return out


def _load_clip_merges(bpe_path: Path) -> list[tuple[str, str]]:
    """Merge list from any distributed format.

    - open_clip ``bpe_simple_vocab_16e6.txt[.gz]`` (comment line, then merges;
      only the canonical first 48,894 are used — same slice as SimpleTokenizer);
    - HF ``merges.txt`` (``#version`` header, then the same 48,894 merges);
    - HF ``tokenizer.json`` (``model.merges`` as strings or pairs).
    """
    import json

    if bpe_path.suffix == ".json":
        data = json.loads(bpe_path.read_text("utf-8"))
        model = data.get("model", data)
        raw = model.get("merges")
        if raw is None:
            raise ValueError(
                f"{bpe_path} has no merges — pass merges.txt/tokenizer.json, "
                f"not a bare vocab.json"
            )
        return [tuple(m.split()) if isinstance(m, str) else tuple(m) for m in raw]
    if str(bpe_path).endswith(".gz"):
        merges_raw = gzip.open(bpe_path).read().decode("utf-8")
    else:
        merges_raw = bpe_path.read_text("utf-8")
    lines = merges_raw.split("\n")
    lines = lines[1 : 49152 - 256 - 2 + 1]
    return [tuple(m.split()) for m in lines if m]


class ClipBpeTokenizer:
    """CLIP's SimpleTokenizer (BPE over byte-unicode), vocab 49408.

    Parameters
    ----------
    bpe_path : merges in any supported format (see :func:`_load_clip_merges`).
    context_length : default framing length (SOT + tokens + EOT, padded 0).
    """

    VOCAB_SIZE = 49408

    def __init__(self, bpe_path: str | Path, context_length: int = 77):
        self.context_length = context_length
        merges = _load_clip_merges(Path(bpe_path))

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # open_clip's pattern uses \p{L}/\p{N}; stdlib `re` has no \p classes,
        # so emulate them: [^\W\d_] == unicode letter, \d == unicode digit,
        # and the punctuation class excludes both plus whitespace (underscore
        # is punctuation in \p{L}\p{N} terms, so it joins the last class).
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE | re.UNICODE,
        )
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _split_numeric_runs(re.findall(self.pat, text)):
            token_u = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token_u).split(" "))
        return bpe_tokens

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        """Tokenize to a (B, context_length) int32 array with SOT/EOT framing.

        Over-long inputs are truncated with EOT as the last token — matching
        open_clip's ``tokenize`` behavior.
        """
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        result = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > ctx:
                tokens = tokens[:ctx]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result


class HashTokenizer:
    """Deterministic non-CLIP tokenizer for weightless smoke testing.

    Frames like CLIP (SOT=vocab−2, EOT=vocab−1, zero padding) but maps words
    to stable hash buckets. Embeddings produced with it are meaningless —
    use only with random weights.
    """

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot_token = vocab_size - 2
        self.eot_token = vocab_size - 1
        logger.warning(
            "HashTokenizer is a testing fallback, not CLIP-compatible; "
            "pass bpe_path= for real tokenization."
        )

    def encode(self, text: str) -> list[int]:
        import hashlib

        words = _whitespace_clean(_basic_clean(text)).lower().split(" ")
        out = []
        for w in words:
            if not w:
                continue
            h = int(hashlib.sha256(w.encode()).hexdigest(), 16)
            out.append(h % (self.vocab_size - 2))
        return out

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        result = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(tokens) > ctx:
                tokens = tokens[:ctx]
                tokens[-1] = self.eot_token
            result[i, : len(tokens)] = tokens
        return result
