"""The port's copy of the SentencePiece module against the JAX package's.

The cases of ``tests/foundation_models/test_sentencepiece.py``, each run on
the port's module, plus ids, pieces, normalization and decodes equal to the
JAX module's (exactly: both are pure Python) on unicode, byte-fallback and
BPE-mode inputs. Models are written in the test with ``serialize_model``.
"""

import numpy as np
import pytest

from semanticlens_tpu.foundation_models import sentencepiece as jsp
from semanticlens_tpu_torch.foundation_models import sentencepiece as tsp
from semanticlens_tpu_torch.foundation_models.sentencepiece import (
    BPE,
    BYTE,
    CONTROL,
    UNIGRAM,
    UNKNOWN,
    SentencePieceProcessor,
    SigLipTokenizer,
    SpModel,
    parse_model,
    serialize_model,
)

WS = "▁"
BYTES = [(f"<0x{b:02X}>", -10.0, BYTE) for b in range(256)]


def _unigram_model(extra=(), **kwargs):
    pieces = [
        ("<unk>", 0.0, UNKNOWN),
        ("<s>", 0.0, CONTROL),
        ("</s>", 0.0, CONTROL),
        (WS + "hello", -1.0, 1),
        (WS + "world", -1.5, 1),
        (WS + "hell", -4.0, 1),
        ("o", -0.5, 1),
        (WS, -3.0, 1),
        ("h", -6.0, 1),
        ("e", -6.0, 1),
        ("l", -6.0, 1),
        ("w", -6.0, 1),
        ("o" + "r", -6.0, 1),
        ("r", -6.0, 1),
        ("d", -6.0, 1),
    ] + list(extra)
    return SpModel(pieces=pieces, model_type=UNIGRAM, unk_id=0, bos_id=1, eos_id=2, pad_id=-1, **kwargs)


def _bpe_model():
    pieces = [
        ("<unk>", 0.0, UNKNOWN),
        ("<s>", 0.0, CONTROL),
        ("</s>", 0.0, CONTROL),
        (WS, -2.0, 1),
        ("a", -3.0, 1),
        ("b", -3.0, 1),
        ("c", -3.0, 1),
        ("ab", -0.5, 1),  # best merge
        ("bc", -1.0, 1),
        ("abc", -6.0, 1),
        (WS + "abc", -0.2, 1),
        (WS + "a", -4.0, 1),
    ]
    return SpModel(pieces=pieces, model_type=BPE, unk_id=0, eos_id=2)


MODELS = {
    "unigram": lambda: _unigram_model(),
    "byte_fallback": lambda: _unigram_model(extra=BYTES, byte_fallback=True),
    "bpe": _bpe_model,
    "bpe_byte_fallback": lambda: SpModel(pieces=_bpe_model().pieces + BYTES, model_type=BPE, unk_id=0, eos_id=2,
                                         byte_fallback=True),
}
TEXTS = ["hello", "hello world", "  hello   world ", "ab", "abc", "abcabc cab", "hello ЖЖ", "Ж", "ﬁ",
         "héllo wörld", "日本語 hello", "😀 emoji", "", "   ", "hello\tworld\n", "ＡＢＣ full width"]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_ids_pieces_and_decodes_equal_the_jax_module(model):
    data = serialize_model(MODELS[model]())
    assert data == jsp.serialize_model(MODELS[model]()), "the wire format must be byte-identical"
    tproc, jproc = tsp.SentencePieceProcessor(data), jsp.SentencePieceProcessor(data)
    for text in TEXTS:
        ids = tproc.encode(text)
        assert ids == jproc.encode(text), text
        assert tproc.encode_as_pieces(text) == jproc.encode_as_pieces(text), text
        assert tproc.normalize(text) == jproc.normalize(text), text
        assert tproc.decode(ids) == jproc.decode(ids), text
    ttok, jtok = tsp.SigLipTokenizer(data, context_length=6), jsp.SigLipTokenizer(data, context_length=6)
    np.testing.assert_array_equal(ttok(TEXTS), jtok(TEXTS))


def test_serialize_parse_roundtrip():
    model = _unigram_model(byte_fallback=True)
    parsed = parse_model(serialize_model(model))
    assert parsed.pieces == model.pieces
    assert parsed.model_type == UNIGRAM
    assert (parsed.unk_id, parsed.bos_id, parsed.eos_id, parsed.pad_id) == (0, 1, 2, -1)
    assert parsed.byte_fallback is True
    assert parsed.add_dummy_prefix and parsed.remove_extra_whitespaces and parsed.escape_whitespaces
    assert jsp.parse_model(serialize_model(model)).pieces == model.pieces


def test_parse_rejects_garbage():
    with pytest.raises(ValueError):
        parse_model(b"not a protobuf at all")


@pytest.mark.parametrize("extra, text, pieces", [
    ((), "hello", [WS + "hello"]),  # "▁hello" -1.0 as one piece beats "▁hell"+"o" = -4.5
    ((), "hello world", [WS + "hello", WS + "world"]),  # the dummy prefix applies once
    (((WS + "ab", -5.0, 1), (WS + "a", -1.0, 1), ("b", -1.0, 1)), "ab", [WS + "a", "b"]),  # score over count
])
def test_unigram_viterbi_picks_best_segmentation(extra, text, pieces):
    assert SentencePieceProcessor(_unigram_model(extra=extra)).encode_as_pieces(text) == pieces


def test_unknown_char_gets_unk_id_and_merges_runs():
    sp = SentencePieceProcessor(_unigram_model())
    ids = sp.encode("hello ЖЖ")  # cyrillic not in vocab
    assert ids == [sp.piece_to_id(WS + "hello"), sp.piece_to_id(WS), sp.model.unk_id]


def test_byte_fallback_expands_unknown_to_bytes():
    sp = SentencePieceProcessor(_unigram_model(extra=BYTES, byte_fallback=True))
    ids = sp.encode("Ж")  # U+0416 → 0xD0 0x96
    assert [sp.id_to_piece(i) for i in ids][-2:] == ["<0xD0>", "<0x96>"]
    assert sp.decode(ids) == "Ж"


def test_normalization_and_options():
    sp = SentencePieceProcessor(_unigram_model())
    assert sp.normalize("  hello   world ") == WS + "hello" + WS + "world"
    assert sp.normalize("ﬁ") == WS + "fi"
    model = _unigram_model()
    model.add_dummy_prefix = False
    model.escape_whitespaces = False
    assert SentencePieceProcessor(model).normalize("hello world") == "hello world"


def test_bpe_mode_merges_by_score_priority():
    sp = SentencePieceProcessor(_bpe_model())
    # ▁ a b c → "ab" (-0.5) first, then abc (-6), then ▁abc (-0.2): one piece.
    assert sp.encode_as_pieces("abc") == [WS + "abc"]
    assert all(i != 0 for i in sp.encode("abc"))


def test_decode_roundtrip_and_control_skipping():
    sp = SentencePieceProcessor(_unigram_model())
    ids = sp.encode("hello world")
    assert sp.decode(ids) == "hello world"
    assert sp.decode([1, 2] + ids) == "hello world"  # bos/eos dropped


def test_siglip_tokenizer_sticky_eos_padding_and_file(tmp_path):
    tok = SigLipTokenizer(serialize_model(_unigram_model()), context_length=8)
    out = tok(["hello world", "hello"])
    assert out.shape == (2, 8) and out.dtype == np.int32
    eos = tok.eot_token
    assert all(t == eos for t in out[0].tolist()[2:]), "padding must be the EOS id (pad_value=1 semantics)"
    assert tok("hello " * 50)[0].tolist()[-1] == eos  # truncation keeps EOS last
    path = tmp_path / "toy.model"
    path.write_bytes(serialize_model(_unigram_model()))
    from_file = SigLipTokenizer(path, context_length=6)
    assert from_file.vocab_size == len(_unigram_model().pieces)
    np.testing.assert_array_equal(from_file(["hello", "world"]), jsp.SigLipTokenizer(path, 6)(["hello", "world"]))
