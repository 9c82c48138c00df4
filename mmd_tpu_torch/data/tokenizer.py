"""WordPiece tokenizer: trainable from the corpus, fixed-shape batch encode
(counterpart of mmd_tpu/data/tokenizer.py).

The same algorithm and the same vocabulary file format as the JAX
package's tokenizer, so a `tokenizer.json` written by either package loads
in the other and gives the same ids (tests/test_torch_serving.py). Kept as
the port's own module so the port loads nothing of the JAX package. As in
the JAX package, `encode_batch` hands ASCII, pair-free batches to the C++
twin of its encode loop (native/tokenizer.cpp, built at first use) and
keeps the Python loop for the rest and where no compiler is at hand.

Vocabularies are TRAINED from the dataset text itself: whole-word
vocabulary by frequency plus greedy longest-match "##" subword fallback —
the standard WordPiece encode algorithm. Output is always fixed-shape
(B, max_length) int32 + attention mask.
"""

from __future__ import annotations

import json
import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

from mmd_tpu_torch.native.bindings import NativeTokenizer

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def basic_tokenize(text: str) -> list[str]:
    text = unicodedata.normalize("NFKC", str(text)).lower()
    return _WORD_RE.findall(text)


def train_wordpiece(texts: Iterable[str], vocab_size: int = 30000,
                    min_freq: int = 2) -> list[str]:
    """Frequency-based WordPiece vocabulary: specials + single chars +
    frequent whole words + frequent suffix pieces."""
    word_counts: Counter = Counter()
    for t in texts:
        word_counts.update(basic_tokenize(t))

    chars: Counter = Counter()
    for w, c in word_counts.items():
        for ch in w:
            chars[ch] += c

    vocab: list[str] = list(SPECIALS)
    seen = set(vocab)

    def add(tok):
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)

    for ch, c in chars.most_common():
        add(ch)
        add("##" + ch)

    # frequent whole words
    for w, c in word_counts.most_common():
        if len(vocab) >= vocab_size:
            break
        if c >= min_freq:
            add(w)

    # frequent suffix pieces from remaining budget
    if len(vocab) < vocab_size:
        suffixes: Counter = Counter()
        for w, c in word_counts.items():
            for i in range(1, min(len(w), 8)):
                suffixes["##" + w[i:i + 6]] += c
        for s, c in suffixes.most_common():
            if len(vocab) >= vocab_size:
                break
            if c >= min_freq:
                add(s)
    return vocab


class WordPieceTokenizer:
    def __init__(self, vocab: Sequence[str]):
        self.vocab = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(self.vocab)}
        missing = [s for s in SPECIALS if s not in self.token_to_id]
        if missing:
            raise ValueError(f"vocabulary lacks the special tokens {missing}")
        self.pad_id = self.token_to_id[PAD]
        self.unk_id = self.token_to_id[UNK]
        self.cls_id = self.token_to_id[CLS]
        self.sep_id = self.token_to_id[SEP]
        self._native = None  # the C++ encoder, attached at first use

    # -- persistence -----------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({"vocab": self.vocab}))

    @classmethod
    def load(cls, path: str | Path) -> "WordPieceTokenizer":
        return cls(json.loads(Path(path).read_text())["vocab"])

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 30000
              ) -> "WordPieceTokenizer":
        return cls(train_wordpiece(texts, vocab_size))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- encode ----------------------------------------------------------

    def _wordpiece(self, word: str, max_chars: int = 64) -> list[int]:
        if len(word) > max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.token_to_id:
                    cur = self.token_to_id[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 512) -> tuple[list[int], list[int]]:
        """-> (ids, token_type_ids), unpadded, with [CLS]/[SEP] structure."""
        ids = [self.cls_id]
        types = [0]
        for w in basic_tokenize(text):
            ids.extend(self._wordpiece(w))
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        types = [0] * len(ids)
        if text_pair is not None:
            pair: list[int] = []
            for w in basic_tokenize(text_pair):
                pair.extend(self._wordpiece(w))
            pair = pair[: max_length - len(ids) - 1]
            ids = ids + pair + [self.sep_id]
            types = types + [1] * (len(pair) + 1)
        return ids[:max_length], types[:max_length]

    def encode_batch(self, texts: Sequence[str],
                     pairs: Optional[Sequence[str]] = None,
                     max_length: int = 512):
        """Fixed-shape batch: (ids (B, L) i32, mask (B, L) i32,
        token_type_ids (B, L) i32)."""
        native = self._get_native()
        if (native is not None and pairs is None
                and all(isinstance(t, str) and t.isascii() and "\x00" not in t
                        for t in texts)):
            # the native path is ASCII-exact; non-ASCII normalization (NFKC)
            # stays in Python, and a NUL would split the C++ side's text
            return native.encode_batch(texts, max_length)
        b = len(texts)
        out = np.full((b, max_length), self.pad_id, np.int32)
        mask = np.zeros((b, max_length), np.int32)
        types = np.zeros((b, max_length), np.int32)
        for i, t in enumerate(texts):
            ids, ty = self.encode(t, pairs[i] if pairs is not None else None,
                                  max_length)
            out[i, :len(ids)] = ids
            mask[i, :len(ids)] = 1
            types[i, :len(ty)] = ty
        return out, mask, types

    def decode(self, ids) -> str:
        """Token ids -> text: drop specials, merge '##' continuations."""
        words: list[str] = []
        for i in ids:
            tok = self.vocab[int(i)] if 0 <= int(i) < len(self.vocab) else UNK
            if tok in SPECIALS:
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)

    def _get_native(self):
        """The C++ batch encoder (native/tokenizer.cpp), built at first use;
        None where it cannot be built or MMD_NATIVE=0."""
        if self._native is None:
            try:
                self._native = NativeTokenizer(self.vocab)
            except RuntimeError:
                self._native = False
        return self._native or None
