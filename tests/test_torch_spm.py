"""The port's unigram tokenizer (mmd_tpu_torch/data/spm.py) against the JAX
package's (mmd_tpu/data/spm.py), on the vocabularies and charsmaps that
tests/test_spm.py builds: the same proto and charsmap bytes, the same ids,
masks, token types, pieces and decodes (the JAX side on its Python path),
each package loading the other's spm.json, and the port against the Rust
`tokenizers` Unigram oracle as the JAX package is."""

import numpy as np
import pytest

from mmd_tpu.data import spm as jspm
from mmd_tpu_torch.data import spm as tspm
from test_spm import (
    CHARSMAP_FIXTURES, CHARSMAP_RULES, FIXTURES, _oracle, make_pieces,
)

LONG = ["x" * 900, "café " * 300, "☃" * 40,
        "the quick brown fox jumps over the lazy dog " * 20]


def _pair(charsmap: bool, seed: int = 0):
    """(JAX tokenizer on its Python path, port tokenizer), one vocab."""
    pieces = make_pieces(seed)
    blob = jspm.build_charsmap(CHARSMAP_RULES) if charsmap else None
    jtok = jspm.UnigramTokenizer(pieces, blob)
    jtok._native = None
    return jtok, tspm.UnigramTokenizer(pieces, blob)


@pytest.mark.parametrize("charsmap", [False, True])
def test_proto_bytes_and_parse_match(charsmap):
    pieces = make_pieces()
    cm = tspm.build_charsmap(CHARSMAP_RULES) if charsmap else None
    blob = tspm.build_spm_model(pieces, cm)
    assert blob == jspm.build_spm_model(pieces, cm)
    assert tspm.parse_spm_model_full(blob) == jspm.parse_spm_model_full(blob)
    assert tspm.parse_spm_model(blob) == jspm.parse_spm_model(blob)
    got, got_cm = tspm.parse_spm_model_full(blob)
    assert [p for p, _, _ in got] == [p for p, _, _ in pieces]
    assert got_cm == cm


def test_charsmap_bytes_and_normalize_match():
    blob = tspm.build_charsmap(CHARSMAP_RULES)
    assert blob == jspm.build_charsmap(CHARSMAP_RULES)
    ours, theirs = tspm.PrecompiledCharsmap(blob), jspm.PrecompiledCharsmap(
        blob)
    for text in CHARSMAP_FIXTURES + FIXTURES + ["ée", "☃", "ＡＢ"]:
        assert ours.normalize(text) == theirs.normalize(text), text
    # longest match consumes the combining sequence; no rule copies through
    assert ours.normalize("ée") == "ée"
    assert ours.normalize("☃") == "☃"


def test_charsmap_matches_rust_precompiled_oracle():
    pytest.importorskip("tokenizers")
    from tokenizers.normalizers import Precompiled

    blob = tspm.build_charsmap(CHARSMAP_RULES)
    oracle = Precompiled(blob)
    ours = tspm.PrecompiledCharsmap(blob)
    for text in CHARSMAP_FIXTURES:
        assert ours.normalize(text) == oracle.normalize_str(text), text


def test_charsmap_rejects_corrupt_blobs():
    for blob in (b"\x01", b"\x08\x00\x00\x00abc"):
        with pytest.raises(ValueError):
            tspm.PrecompiledCharsmap(blob)
    with pytest.raises(ValueError):
        tspm.build_charsmap({"": "x"})


@pytest.mark.parametrize("charsmap", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_tokenize_matches_jax(charsmap, seed):
    jtok, ttok = _pair(charsmap, seed)
    for text in FIXTURES + CHARSMAP_FIXTURES + LONG:
        assert ttok.normalize(text) == jtok.normalize(text), text
        assert ttok.tokenize_ids(text) == jtok.tokenize_ids(text), text
        assert ttok.tokenize(text) == jtok.tokenize(text), text
        ids = ttok.encode(text, max_length=64)[0]
        assert ttok.decode(ids) == jtok.decode(ids), text


@pytest.mark.parametrize("max_length", [12, 16, 512])
@pytest.mark.parametrize("charsmap", [False, True])
def test_encode_batch_matches_jax(charsmap, max_length):
    """ids, mask and token types, single texts and pairs, truncation."""
    jtok, ttok = _pair(charsmap)
    texts = FIXTURES + CHARSMAP_FIXTURES + LONG
    for pairs in (None, texts[::-1]):
        got = ttok.encode_batch(texts, pairs, max_length=max_length)
        want = jtok.encode_batch(texts, pairs, max_length=max_length)
        for g, w, name in zip(got, want, ("ids", "mask", "types")):
            assert g.dtype == np.int32 and g.shape == (len(texts), max_length)
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_segmentation_matches_rust_unigram():
    blob = tspm.build_spm_model(make_pieces())
    ours = tspm.UnigramTokenizer.from_spm_model(blob)
    oracle = _oracle(tspm.parse_spm_model(blob))
    for text in FIXTURES:
        assert ours.tokenize_ids(text) == oracle.encode(text).ids, text


def test_conventions_match_jax():
    jtok, ttok = _pair(False)
    for attr in ("pad_id", "cls_id", "sep_id", "unk_id", "mask_id",
                 "vocab_size", "min_score", "unk_score"):
        assert getattr(ttok, attr) == getattr(jtok, attr), attr
    assert (ttok.pad_id, ttok.cls_id, ttok.sep_id, ttok.unk_id) == (0, 1, 2, 3)
    # consecutive unknowns fuse into one [UNK]
    assert ttok.tokenize_ids("☃❤").count(ttok.unk_id) == 1
    ids, mask, _ = ttok.encode_batch(["", "hello world"], max_length=8)
    assert list(ids[0][mask[0] == 1]) == [ttok.cls_id, ttok.sep_id]


@pytest.mark.parametrize("charsmap", [False, True])
def test_spm_json_loads_across_packages(tmp_path, charsmap):
    jtok, ttok = _pair(charsmap)
    ttok.save(tmp_path / "t.json")
    jtok.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json"
                                                 ).read_text()
    from_j = tspm.UnigramTokenizer.load(tmp_path / "j.json")
    from_t = jspm.UnigramTokenizer.load(tmp_path / "t.json")
    from_t._native = None
    assert (from_j.charsmap is not None) == charsmap
    for text in FIXTURES + CHARSMAP_FIXTURES:
        assert from_j.tokenize_ids(text) == jtok.tokenize_ids(text), text
        assert from_t.tokenize_ids(text) == ttok.tokenize_ids(text), text


def test_from_spm_model_matches_jax():
    blob = tspm.build_spm_model(make_pieces(),
                                tspm.build_charsmap(CHARSMAP_RULES))
    ours = tspm.UnigramTokenizer.from_spm_model(blob)
    theirs = jspm.UnigramTokenizer.from_spm_model(blob)
    theirs._native = None
    assert ours.pieces == theirs.pieces
    assert ours.charsmap.blob == theirs.charsmap.blob
    for text in FIXTURES + CHARSMAP_FIXTURES:
        assert ours.tokenize_ids(text) == theirs.tokenize_ids(text), text


def test_frozen_resolver_prefers_spm_vocab(tmp_path):
    """spm.json wins over tokenizer.json and over training one, as in the
    JAX package, and feeds fixed-shape batches."""
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmd_tpu_torch.models.frozen import load_or_init_frozen

    tspm.UnigramTokenizer(make_pieces()).save(tmp_path / "spm.json")
    WordPieceTokenizer.train(["a claim"], 50).save(tmp_path / "tokenizer.json")
    enc = load_or_init_frozen(tmp_path, vocab_texts=["unused"], tiny=True)
    assert isinstance(enc.tokenizer, tspm.UnigramTokenizer)
    ids, mask, _ = enc.tokenizer.encode_batch(["hello world", "the dog"],
                                              max_length=32)
    assert ids.shape == (2, 32) and mask.sum() > 4
    assert enc.text_cfg.vocab_size == max(enc.tokenizer.vocab_size, 128)
