"""The port's native host libraries (mmd_tpu_torch/native/) against the JAX
package's Python encoders and numpy gathers, on the CPU.

The cases of tests/test_native.py -- the WordPiece batch encoder at three
lengths, the ASCII dispatch, the non-ASCII fallback, the row gather in 2-D
and 3-D, the store's batches -- with the port's bindings held bit for bit
against the JAX package's Python paths (its native hooks switched off);
then the unigram Viterbi encoder and the charsmap normalizer on
tests/test_spm.py's vocabularies and charsmap rules, the Python paths that
remain (pairs, NUL in WordPiece text, no compiler, MMD_NATIVE=0), and a
build from two processes at once. Beyond the JAX package's cases: the
encoder and the gather at several thread counts, the thread rule, the
gather writing rows to their batch positions, and the store sending only
a column of at least NATIVE_GATHER_MIN_BYTES a batch to the native
gather. Every comparison is exact.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import mmd_tpu.native.bindings as jbindings
from mmd_tpu.data import spm as jspm
from mmd_tpu.data.store import ArrayStore as JStore
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTok
from mmd_tpu_torch.data import spm as tspm
from mmd_tpu_torch.data.store import NATIVE_GATHER_MIN_BYTES, write_store
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer as TTok
from mmd_tpu_torch.native import bindings as B
from test_spm import CHARSMAP_RULES, FIXTURES, make_pieces
from test_torch_spm import CHARSMAP_FIXTURES, LONG

CORPUS = [
    "The quick brown fox jumps over the lazy dog!",
    "Misinformation spreads quickly on social media platforms.",
    "Claims require strong evidence, from reliable sources (always).",
] * 4

TEXTS = [
    "The quick brown fox",
    "claims require evidence!!!",
    "an unseen-word xylophone78 and punct... marks",
    "",
    "a",
    "word " * 200,  # truncation
]


@pytest.fixture(scope="module", autouse=True)
def built():
    for name in B.SOURCES:
        if B.load(name) is None:
            pytest.fail(f"the native {name} library did not build: "
                        f"{B.build_errors.get(name)}")


@pytest.fixture(scope="module")
def vocab():
    return TTok.train(CORPUS, vocab_size=600).vocab


def _jax_python(vocab) -> JTok:
    tok = JTok(vocab)
    tok._native = False                     # the JAX package's Python path
    return tok


def _calls(name):
    return B.calls[name]


@pytest.mark.parametrize("length", [16, 64, 512])
def test_native_tokenizer_matches_python(vocab, length):
    native = B.NativeTokenizer(vocab)
    before = _calls("tokenizer")
    got = native.encode_batch(TEXTS, length)
    assert _calls("tokenizer") == before + 1
    want = _jax_python(vocab).encode_batch(TEXTS, max_length=length)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_native_tokenizer_at_any_thread_count(vocab, threads):
    texts = TEXTS * 5
    got = B.NativeTokenizer(vocab)._encode(B._payload(texts), len(texts),
                                           64, threads)
    want = _jax_python(vocab).encode_batch(texts, max_length=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dispatch_uses_native_for_ascii(vocab):
    tok = TTok(vocab)
    before = _calls("tokenizer")
    out = tok.encode_batch(["the quick fox"] + TEXTS, max_length=16)
    assert tok._get_native() is not None
    assert _calls("tokenizer") == before + 1
    ref = _jax_python(vocab).encode_batch(["the quick fox"] + TEXTS,
                                          max_length=16)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("texts", [["café naïve 北京 emoji 🙂", "plain ascii"],
                                   ["nul \x00 inside", "plain ascii"]])
def test_non_ascii_and_nul_fall_back_to_python(vocab, texts):
    tok = TTok(vocab)
    before = _calls("tokenizer")
    out = tok.encode_batch(texts, max_length=32)
    assert _calls("tokenizer") == before
    ref = _jax_python(vocab).encode_batch(texts, max_length=32)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_pairs_take_the_python_path(vocab):
    tok = TTok(vocab)
    before = _calls("tokenizer")
    out = tok.encode_batch(TEXTS, TEXTS[::-1], max_length=24)
    assert _calls("tokenizer") == before
    ref = _jax_python(vocab).encode_batch(TEXTS, TEXTS[::-1], max_length=24)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_gather_rows_parity(rng):
    src = np.ascontiguousarray(rng.standard_normal((1000, 37)).astype(np.float16))
    idx = rng.integers(0, 1000, 256)
    before = _calls("gather")
    out = B.gather_rows(src, idx, np.arange(len(idx)))
    assert _calls("gather") == before + 1
    np.testing.assert_array_equal(out, src[idx])


def test_gather_rows_3d(rng):
    src = np.ascontiguousarray(rng.integers(0, 255, (50, 4, 6), dtype=np.uint8))
    idx = np.array([0, 49, 7, 7, 13])
    at = np.arange(len(idx))
    np.testing.assert_array_equal(B.gather_rows(src, idx, at), src[idx])
    assert B.gather_rows(src[:, ::2], idx, at) is None  # not C-contiguous
    with pytest.raises(IndexError):
        B.gather_rows(src, np.array([50]), [0])


def test_store_batches_use_native_gather(tmp_path, rng):
    """A column of at least NATIVE_GATHER_MIN_BYTES a batch goes through the
    native gather, a narrower one through numpy; both give the JAX
    store's batches."""
    wide = NATIVE_GATHER_MIN_BYTES // (16 * 4)          # float32 a row
    arrays = {"x": rng.standard_normal((64, 8)).astype(np.float32),
              "y": rng.integers(0, 9, (64, 3, 2)).astype(np.int32),
              "w": rng.standard_normal((64, wide)).astype(np.float32)}
    store = write_store(tmp_path / "s", arrays)
    before = _calls("gather")
    got = list(store.batches(16, shuffle=True, seed=3))
    assert _calls("gather") == before + 4               # "w" only
    want = list(JStore(tmp_path / "s").batches(16, shuffle=True, seed=3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for c in arrays:
            np.testing.assert_array_equal(g[c], w[c])


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_gather_rows_to_batch_positions(rng, threads):
    """Sorted rows written to their batch positions in one copy: the
    store's numpy path (sorted rows, then the batch order), bit for bit,
    at any thread count."""
    src = np.ascontiguousarray(rng.standard_normal((300, 5, 7)))
    idx = rng.permutation(300)[:41]
    pos = np.argsort(idx, kind="stable")
    got = B._gather(B._gather_lib(), src, idx[pos], pos, threads)
    np.testing.assert_array_equal(got, src[idx[pos]][np.argsort(pos)])
    np.testing.assert_array_equal(B.gather_rows(src, idx[pos], pos),
                                  src[idx])
    with pytest.raises(IndexError):
        B.gather_rows(src, idx[pos], np.zeros_like(pos))  # not a permutation


def test_threads_grow_with_work_up_to_the_cap(monkeypatch):
    monkeypatch.setattr(B, "cpus", lambda: 8)
    per = B.GATHER_BYTES_PER_THREAD
    assert [B.threads_for(w, per) for w in (0, per - 1, per, 3 * per,
                                            100 * per)] == \
        [1, 1, 1, 3, B.MAX_THREADS]
    monkeypatch.setattr(B, "cpus", lambda: 2)
    assert B.threads_for(100 * per, per) == 2


def _spm_pair(charsmap: bool, seed: int):
    """(JAX tokenizer on its Python paths, port tokenizer on its native)."""
    pieces = make_pieces(seed)
    blob = jspm.build_charsmap(CHARSMAP_RULES) if charsmap else None
    jtok = jspm.UnigramTokenizer(pieces, blob)
    jtok._native = None
    return jtok, tspm.UnigramTokenizer(pieces, blob)


@pytest.mark.parametrize("max_length", [12, 512])
@pytest.mark.parametrize("charsmap", [False, True])
def test_native_viterbi_matches_python(monkeypatch, charsmap, max_length):
    """native/spm.cpp's Viterbi, unknown fusing and layout, bit-identical
    to the JAX package's Python encoder: unicode, empties, truncation."""
    monkeypatch.setattr(jbindings, "_spm_lib", None)
    monkeypatch.setattr(jbindings, "_spm_checked", True)
    jtok, ttok = _spm_pair(charsmap, seed=1)
    texts = FIXTURES + CHARSMAP_FIXTURES + LONG
    before = dict(B.calls)
    got = ttok.encode_batch(texts, max_length=max_length)
    assert B.calls["spm"] == before["spm"] + 1
    assert (B.calls["charsmap"] > before["charsmap"]) == charsmap
    want = jtok.encode_batch(texts, max_length=max_length)
    for g, w, name in zip(got, want, ("ids", "mask", "types")):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("charsmap", [False, True])
def test_spm_pairs_take_the_python_path(charsmap):
    jtok, ttok = _spm_pair(charsmap, seed=0)
    before = B.calls["spm"]
    got = ttok.encode_batch(FIXTURES, FIXTURES[::-1], max_length=24)
    want = jtok.encode_batch(FIXTURES, FIXTURES[::-1], max_length=24)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert B.calls["spm"] == before


def test_native_charsmap_matches_python(monkeypatch):
    """Longest-prefix match, unmatched copy-through, multi-byte keys."""
    monkeypatch.setattr(jbindings, "_spm_lib", None)
    monkeypatch.setattr(jbindings, "_spm_checked", True)
    rules = {"A": "a", "ßß": "ss", "É": "e", "\t": " ", "abc": "xyz",
             "ab": "q"}
    for blob in (tspm.build_charsmap(rules), tspm.build_charsmap(
            CHARSMAP_RULES)):
        py = jspm.PrecompiledCharsmap(blob)
        for t in (["AÉßß\tx", "plain", "ÉÉÉ", "ßßß", "ß", "abcab", "ababc",
                   "", "x" * 5000] + CHARSMAP_FIXTURES + FIXTURES):
            before = B.calls["charsmap"]
            assert B.charsmap_normalize(blob, t) == py.normalize(t), t
            assert B.calls["charsmap"] == before + 1
            assert tspm.PrecompiledCharsmap(blob).normalize(t) == \
                py.normalize(t)
    assert B.charsmap_normalize(b"\x01", "x") is None      # corrupt blob


def test_python_paths_without_native(monkeypatch, vocab):
    """MMD_NATIVE=0, and a machine without a compiler: the libraries read
    as absent and every caller takes its Python path."""
    monkeypatch.setenv("MMD_NATIVE", "0")
    assert B.load("tok") is None and B.gather_rows(np.zeros((2, 2)), [0],
                                                   [0]) is None
    assert TTok(vocab)._get_native() is None
    monkeypatch.delenv("MMD_NATIVE")
    monkeypatch.setattr(B, "_loaded", {})
    monkeypatch.setattr(B, "build_errors", {})
    monkeypatch.setattr(B, "find_cxx", lambda: None)
    assert B.load("gather") is None
    assert "no C++ compiler" in B.build_errors["gather"]
    jtok, ttok = _spm_pair(True, seed=0)
    with pytest.raises(RuntimeError, match="unavailable"):
        B.NativeSpm(make_pieces(0), 3, 0, 1, 2, -20.0)
    got = ttok.encode_batch(FIXTURES, max_length=32)
    for g, w in zip(got, jtok.encode_batch(FIXTURES, max_length=32)):
        np.testing.assert_array_equal(g, w)


def test_build_from_two_processes_at_once(tmp_path):
    """Two processes building one library into an empty directory at once
    both load the same complete library; no partial file is left."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import numpy as np
        from mmd_tpu_torch.native import bindings as B
        B.BUILD_DIR = Path({str(tmp_path / 'build')!r})
        src = np.arange(40, dtype=np.int64).reshape(10, 4)
        out = B.gather_rows(src, np.array([9, 0, 3]), np.arange(3))
        assert out is not None, B.build_errors
        assert (out == src[[9, 0, 3]]).all()
        print(B.library_path("gather", B.find_cxx()))
    """)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    name = Path(paths.pop()).name
    assert built == sorted([name, Path(name).with_suffix(".lock").name])
