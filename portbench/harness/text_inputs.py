"""A text corpus made from the seed on the host: token sequences for an LM subject, and the FM's strings.

Each of ``sequences`` rows holds ``seq_len`` token ids of the subject's
vocabulary: half drawn from one global Zipf law (exponent ``zipf_s``) over
every id, half from the row's topic, one of ``topics``, each a Zipf law of
the same exponent over its own ``topic_vocab`` ids; which positions are the
topic's is drawn per row. Ranks map to ids through seeded permutations, so
the frequent ids are spread over the vocabulary. The topics make an MoE
subject's routing uneven and its components' top sequences distinct.

The foundation model reads each row's first ``n_words`` ids (the
configuration's ``fm_words``) rendered as
pseudo-words: id i is the three syllables of its base-100 digits, each digit
a syllable of a seeded table (consonant + vowel), so every id has its own
lowercase word. :func:`fm_token_rows` frames those words as the port's hash
tokenizer does (start token, ``sha256(word) mod (vocab − 2)`` per word, end
token, zero padding), written here again for the reference.

Everything comes from (seed, ``TEXT_STREAM``), a stream no other input of
the benchmark draws from.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

TEXT_STREAM = 1 << 25  # beside weights.STREAMS (queries take 1000 + call) and the subjects' layer streams
CONSONANTS = "bdfghklmnprstvz"  # 15 × 7 vowel-likes ≥ 100 syllables
VOWELS = "aeiouyw"


def _rng(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng([seed, TEXT_STREAM, part])


def _zipf(n: int, s: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return p / p.sum()


def tokens(seed: int, mix: dict, vocab: int) -> np.ndarray:
    """(sequences, seq_len) int32 subject token ids."""
    n, t, topics, tv, s = mix["sequences"], mix["seq_len"], mix["topics"], mix["topic_vocab"], mix["zipf_s"]
    rng = _rng(seed, 0)
    global_ids = rng.permutation(vocab)
    topic_ids = np.stack([rng.choice(vocab, size=tv, replace=False) for _ in range(topics)])  # (topics, tv)
    topic_of = rng.integers(0, topics, size=n)
    n_topic = int(round(t * mix["topic_share"]))
    out = global_ids[rng.choice(vocab, size=(n, t), p=_zipf(vocab, s))]
    from_topic = topic_ids[topic_of[:, None], rng.choice(tv, size=(n, n_topic), p=_zipf(tv, s))]
    where = np.argsort(rng.random((n, t)), axis=1)[:, :n_topic]  # the row's topic positions
    np.put_along_axis(out, where, from_topic, axis=1)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=4)
def words(seed: int, vocab: int) -> tuple[str, ...]:
    """The pseudo-word of every subject id."""
    rng = _rng(seed, 1)
    syllables = np.array([c + v for c in CONSONANTS for v in VOWELS])[rng.permutation(len(CONSONANTS) * len(VOWELS))]
    ids = np.arange(vocab)
    parts = [syllables[(ids // 100**k) % 100] for k in (2, 1, 0)]
    return tuple(a + b + c for a, b, c in zip(*parts))


@functools.lru_cache(maxsize=4)
def _word_ids(seed: int, vocab: int, fm_vocab: int) -> np.ndarray:
    """The hash tokenizer's id of each subject id's word."""
    return np.array([int(hashlib.sha256(w.encode()).hexdigest(), 16) % (fm_vocab - 2) for w in words(seed, vocab)],
                    np.int64)


def fm_token_rows(seed: int, rows: np.ndarray, n_words: int, vocab: int, fm_vocab: int, context: int) -> np.ndarray:
    """(len(rows), context) int64 foundation-model token rows of the rows' strings, as the hash tokenizer
    frames them: start (fm_vocab − 2), one id per word, end (fm_vocab − 1), zeros after; cut to ``context``
    with the end token last."""
    ids = _word_ids(seed, vocab, fm_vocab)[np.asarray(rows)[:, :n_words]]
    out = np.zeros((len(ids), context), np.int64)
    body = ids[:, : context - 2]
    out[:, 0] = fm_vocab - 2
    out[:, 1 : 1 + body.shape[1]] = body
    out[:, 1 + body.shape[1]] = fm_vocab - 1
    return out


def corpus(seed: int, mix: dict, vocab: int, n_words: int) -> tuple[np.ndarray, list[str]]:
    """(tokens, strings) of the mix: the subject's rows and the FM's strings of their first ``n_words`` ids."""
    rows = tokens(seed, mix, vocab)
    return rows, [" ".join(words(seed, vocab)[i] for i in row[:n_words]) for row in rows.tolist()]
