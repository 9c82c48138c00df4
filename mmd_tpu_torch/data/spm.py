"""SentencePiece-unigram tokenizer: host-side encode matching HF DeBERTa-v2
(counterpart of mmd_tpu/data/spm.py).

The reference tokenizes with HF `DebertaV2Tokenizer` (reference
train.py:136-140), which wraps a SentencePiece unigram model
(tokenization_deberta_v2.py SPMTokenizer: `spm.encode(text, out_type=str)`
plus the [PAD]=0/[CLS]=1/[SEP]=2/[UNK]=3 id convention). This module
re-derives that pipeline without the sentencepiece C++ dependency, with
the same algorithms and the same `spm.json` format as the JAX package's
tokenizer, so a file written by either package loads in the other and
gives the same ids (tests/test_torch_spm.py). Kept as the port's own
module so the port loads nothing of the JAX package:

  * a minimal protobuf wire-format reader for spm `ModelProto` (pieces,
    scores, types and the precompiled charsmap), so
    `python -m mmd_tpu_torch.convert_hf` exports the vocab from a
    downloaded spm.model with no extra deps, plus a writer used to build
    test fixtures;
  * Viterbi unigram segmentation over a piece trie (the SentencePiece /
    HF-`tokenizers` Unigram algorithm: maximize summed piece log-probs;
    characters not covered by any piece become unknowns at
    min_score - 10.0, consecutive unknowns fused);
  * metaspace pre-tokenization (" " -> "▁", dummy prefix) and exact
    normalization: when the spm model carries a precompiled charsmap
    (nmt_nfkc -- a darts-clone double-array trie of UTF-8 replacement
    rules inside ModelProto.normalizer_spec), PrecompiledCharsmap applies
    it byte-exactly (longest-prefix match, sentencepiece
    normalizer.cc::NormalizePrefix semantics). Corpus-trained tokenizers
    without a charsmap fall back to NFKC + whitespace collapsing.

As in the JAX package, the charsmap normalization and the Viterbi,
unknown-fusing and layout loop of pair-free batches run in C++
(native/spm.cpp, built at first use); the Python loops stay for pairs, a
text holding NUL, and where no compiler is at hand.

Batch output contract matches data/tokenizer.py: fixed-shape (B, L) int32
ids/mask/token_type_ids, [CLS] x [SEP] structure, so the DeBERTa encoder
sees reference-identical inputs end to end.
"""

from __future__ import annotations

import base64
import json
import struct
import unicodedata
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mmd_tpu_torch.native.bindings import NativeSpm, charsmap_normalize

METASPACE = "▁"
UNK_PENALTY = 10.0

# spm ModelProto.SentencePiece.type values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# -- minimal protobuf wire format (ModelProto pieces only) ---------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def parse_spm_model(data: bytes) -> list[tuple[str, float, int]]:
    """spm ModelProto bytes -> [(piece, score, type)], in id order.
    ModelProto field 1 = repeated SentencePiece{piece:1 string,
    score:2 float, type:3 enum (default NORMAL)}."""
    return parse_spm_model_full(data)[0]


def parse_spm_model_full(
    data: bytes,
) -> tuple[list[tuple[str, float, int]], Optional[bytes]]:
    """Like parse_spm_model, plus the precompiled charsmap blob from
    ModelProto field 4 = NormalizerSpec{name:1, precompiled_charsmap:2
    bytes, ...} (None when the model carries no charsmap)."""
    charsmap = None
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 4 and wire == 2:
            n, pos = _read_varint(data, pos)
            sub = data[pos:pos + n]
            pos += n
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 2 and swire == 2:
                    ln, sp = _read_varint(sub, sp)
                    blob = sub[sp:sp + ln]
                    sp += ln
                    if blob:
                        charsmap = blob
                else:
                    sp = _skip_field(sub, sp, swire)
        elif field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            sub = data[pos:pos + n]
            pos += n
            piece, score, ptype = "", 0.0, NORMAL
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    ln, sp = _read_varint(sub, sp)
                    piece = sub[sp:sp + ln].decode("utf-8")
                    sp += ln
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[sp:sp + 4])
                    sp += 4
                elif sfield == 3 and swire == 0:
                    ptype, sp = _read_varint(sub, sp)
                else:
                    sp = _skip_field(sub, sp, swire)
            pieces.append((piece, float(score), int(ptype)))
        else:
            pos = _skip_field(data, pos, wire)
    return pieces, charsmap


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def build_spm_model(pieces: Sequence[tuple[str, float, int]],
                    charsmap: Optional[bytes] = None) -> bytes:
    """Inverse of parse_spm_model (test fixtures / re-export)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        raw = piece.encode("utf-8")
        sub += _write_varint((1 << 3) | 2) + _write_varint(len(raw)) + raw
        sub += _write_varint((2 << 3) | 5) + struct.pack("<f", score)
        if ptype != NORMAL:
            sub += _write_varint((3 << 3) | 0) + _write_varint(ptype)
        out += _write_varint((1 << 3) | 2) + _write_varint(len(sub)) + sub
    if charsmap is not None:
        sub = bytearray()
        sub += (_write_varint((2 << 3) | 2) + _write_varint(len(charsmap))
                + charsmap)
        out += _write_varint((4 << 3) | 2) + _write_varint(len(sub)) + sub
    return bytes(out)


# -- precompiled charsmap (nmt_nfkc normalization) -----------------------------
# The spm NormalizerSpec carries its normalization rules as a precompiled
# blob: <uint32 LE trie_size> <darts-clone double-array trie over UTF-8
# keys> <replacement pool ('\0'-separated UTF-8 strings)>. Trie values are
# byte offsets into the pool. Normalization is a left-to-right LONGEST
# prefix match over the raw UTF-8 bytes; unmatched positions copy one
# UTF-8 character unchanged (sentencepiece normalizer.cc NormalizePrefix).
#
# darts-clone unit layout (uint32): label = bits 0-7 (bit 31 set only on
# VALUE units so label() never equals a byte there), has_leaf = bit 8,
# offset = bits 10-30, left-shifted 8 more when bit 9 is set. Traversal
# XORs: child(pos) = (pos ^ offset(pos)) ^ byte; a node's value unit sits
# at pos ^ offset(pos) directly.


class PrecompiledCharsmap:
    """Byte-exact applier for an spm precompiled_charsmap blob."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (n,) = struct.unpack("<I", blob[:4])
        if 4 + n > len(blob) or n % 4 != 0:
            raise ValueError("corrupt charsmap blob")
        self.blob = bytes(blob)
        self._units = np.frombuffer(blob, dtype="<u4",
                                    count=n // 4, offset=4)
        self._pool = blob[4 + n:]

    @staticmethod
    def _offset(u: int) -> int:
        return (u >> 10) << ((u & (1 << 9)) >> 6)

    def _longest_match(self, data: bytes, start: int) -> tuple[int, int]:
        """Longest trie prefix of data[start:] -> (length, pool offset);
        (0, -1) when nothing matches."""
        units = self._units
        n_units = len(units)
        upos = self._offset(int(units[0]))
        best_len, best_val = 0, -1
        for i in range(start, len(data)):
            c = data[i]
            upos ^= c
            if upos >= n_units:
                break
            u = int(units[upos])
            if (u & ((1 << 31) | 0xFF)) != c:
                break
            upos ^= self._offset(u)
            if (u >> 8) & 1:
                best_len = i - start + 1
                best_val = int(units[upos]) & 0x7FFFFFFF
        return best_len, best_val

    def _pool_str(self, off: int) -> str:
        end = self._pool.index(b"\0", off)
        return self._pool[off:end].decode("utf-8")

    def normalize(self, text: str) -> str:
        native = charsmap_normalize(self.blob, str(text))
        if native is not None:
            return native
        data = str(text).encode("utf-8")
        out: list[str] = []
        i, n = 0, len(data)
        while i < n:
            ln, val = self._longest_match(data, i)
            if ln > 0:
                out.append(self._pool_str(val))
                i += ln
            else:
                c = data[i]
                ln = 1 if c < 0x80 else 2 if c < 0xE0 else 3 if c < 0xF0 else 4
                out.append(data[i:i + ln].decode("utf-8"))
                i += ln
        return "".join(out)


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """Build a precompiled-charsmap blob from {source: replacement} rules
    (darts-clone-compatible double array; fixture/export counterpart of
    PrecompiledCharsmap — oracle-validated against the Rust
    tokenizers.normalizers.Precompiled in tests/test_spm.py)."""
    pool = bytearray()
    trie: dict = {}
    for key in sorted(mapping):
        kb = key.encode("utf-8")
        if not kb or 0 in kb:
            raise ValueError(f"invalid charsmap key {key!r}")
        node = trie
        for b in kb:
            node = node.setdefault(b, {})
        node[-1] = len(pool)                     # value = pool offset
        pool += mapping[key].encode("utf-8") + b"\0"

    units: dict[int, int] = {}
    occupied = {0}
    used_bases = {0}       # one node per base, or label checks can collide

    def place(node: dict, pos: int) -> None:
        labels = sorted(l for l in node if l != -1)
        base = 0
        while True:
            base += 1
            if base in used_bases:
                continue
            slots = [base ^ l for l in labels] + ([base] if -1 in node else [])
            if all(s not in occupied for s in slots):
                offset = pos ^ base
                if offset < (1 << 21):
                    break
        used_bases.add(base)
        has_leaf = 1 if -1 in node else 0
        units[pos] = units.get(pos, 0) | (offset << 10) | (has_leaf << 8)
        if has_leaf:
            occupied.add(base)
            units[base] = (1 << 31) | node[-1]
        for l in labels:
            occupied.add(base ^ l)
            units[base ^ l] = l                  # child label; offset later
        for l in labels:
            place(node[l], base ^ l)

    place(trie, 0)
    size = max(units) + 1
    arr = np.zeros(size, dtype="<u4")
    for p, u in units.items():
        arr[p] = u
    trie_bytes = arr.tobytes()
    return struct.pack("<I", len(trie_bytes)) + trie_bytes + bytes(pool)


# -- unigram segmentation ------------------------------------------------------

class UnigramTokenizer:
    """SentencePiece-unigram encoder with the DeBERTa-v2 special-token
    convention ([PAD]=0, [CLS]=1, [SEP]=2, [UNK]=3 inside the spm vocab;
    [MASK] appended past the end, matching HF deberta-v3)."""

    def __init__(self, pieces: Sequence[tuple[str, float, int]],
                 charsmap: Optional[bytes] = None):
        self.charsmap = (PrecompiledCharsmap(charsmap)
                         if charsmap is not None else None)
        self.pieces = [(p, float(s), int(t)) for p, s, t in pieces]
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(self.pieces) if t == UNKNOWN), 3)
        self.pad_id = self.piece_to_id.get("[PAD]", 0)
        self.cls_id = self.piece_to_id.get("[CLS]", 1)
        self.sep_id = self.piece_to_id.get("[SEP]", 2)
        self.mask_id = self.piece_to_id.get("[MASK]", len(self.pieces))
        scores = [s for _, s, t in self.pieces if t == NORMAL]
        self.min_score = min(scores) if scores else 0.0
        self.unk_score = self.min_score - UNK_PENALTY
        # prefix trie over encodable pieces: nested dicts, "\0" terminal
        # holding (piece_id, score)
        self._trie: dict = {}
        for i, (p, s, t) in enumerate(self.pieces):
            if t in (NORMAL, USER_DEFINED) and p:
                node = self._trie
                for ch in p:
                    node = node.setdefault(ch, {})
                node["\0"] = (i, s)
        self._max_piece_len = max(
            (len(p) for p, _, t in self.pieces if t in (NORMAL, USER_DEFINED)),
            default=1)

    # -- persistence -------------------------------------------------------

    def save(self, path: str | Path) -> None:
        doc = {"pieces": self.pieces}
        if self.charsmap is not None:
            doc["charsmap"] = base64.b64encode(
                self.charsmap.blob).decode("ascii")
        Path(path).write_text(json.dumps(doc))

    @classmethod
    def load(cls, path: str | Path) -> "UnigramTokenizer":
        doc = json.loads(Path(path).read_text())
        cm = doc.get("charsmap")
        return cls(doc["pieces"],
                   base64.b64decode(cm) if cm is not None else None)

    @classmethod
    def from_spm_model(cls, data: bytes) -> "UnigramTokenizer":
        pieces, charsmap = parse_spm_model_full(data)
        return cls(pieces, charsmap)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces) + (1 if self.mask_id == len(self.pieces) else 0)

    # -- pipeline ----------------------------------------------------------

    def normalize(self, text: str) -> str:
        """Precompiled charsmap (byte-exact nmt_nfkc) when the model
        carries one; NFKC + whitespace collapsing otherwise (corpus-trained
        tokenizers). remove_extra_whitespaces (on for nmt_nfkc) collapses
        runs of ' ' and strips the ends — post-charsmap the only
        whitespace left IS ' ' (nmt rules map tabs/newlines/unicode
        spaces to it)."""
        if self.charsmap is not None:
            text = self.charsmap.normalize(str(text))
            return " ".join(p for p in text.split(" ") if p)
        text = unicodedata.normalize("NFKC", str(text))
        text = "".join(" " if ch.isspace() else ch for ch in text)
        text = " ".join(text.split())
        return text

    def _viterbi(self, text: str) -> list[int]:
        """Maximize summed piece scores; uncovered chars -> unk at
        min_score - 10; consecutive unks fuse into ONE unk token (the
        HF-tokenizers Unigram fuse_unk semantics used for spm models)."""
        n = len(text)
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: list[Optional[tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        for start in range(n):
            if best[start] == -np.inf:
                continue
            node = self._trie
            for end in range(start, min(n, start + self._max_piece_len)):
                node = node.get(text[end])
                if node is None:
                    break
                term = node.get("\0")
                if term is not None:
                    cand = best[start] + term[1]
                    if cand > best[end + 1]:
                        best[end + 1] = cand
                        back[end + 1] = (start, term[0])
            # single-char unknown candidate (always available, as in spm)
            cand = best[start] + self.unk_score
            if cand > best[start + 1]:
                best[start + 1] = cand
                back[start + 1] = (start, self.unk_id)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid)
            pos = start
        ids.reverse()
        # fuse consecutive unknowns
        fused: list[int] = []
        for pid in ids:
            if pid == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(pid)
        return fused

    def tokenize_ids(self, text: str) -> list[int]:
        """Raw text -> spm piece ids (no specials)."""
        text = self.normalize(text)
        if not text:
            return []
        text = METASPACE + text.replace(" ", METASPACE)
        return self._viterbi(text)

    def tokenize(self, text: str) -> list[str]:
        return [self.pieces[i][0] if i < len(self.pieces) else "[UNK]"
                for i in self.tokenize_ids(text)]

    # -- fixed-shape batch encode (contract of data/tokenizer.py) ----------

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 512) -> tuple[list[int], list[int]]:
        ids = [self.cls_id] + self.tokenize_ids(text)
        ids = ids[: max_length - 1] + [self.sep_id]
        types = [0] * len(ids)
        if text_pair is not None:
            pair = self.tokenize_ids(text_pair)[: max_length - len(ids) - 1]
            ids = ids + pair + [self.sep_id]
            types = types + [1] * (len(pair) + 1)
        return ids[:max_length], types[:max_length]

    def _get_native(self):
        """The C++ Viterbi encoder (native/spm.cpp), built at first use;
        None where it cannot be built or MMD_NATIVE=0."""
        if not hasattr(self, "_native"):
            try:
                self._native = NativeSpm(
                    self.pieces, self.unk_id, self.pad_id, self.cls_id,
                    self.sep_id, self.unk_score)
            except RuntimeError:
                self._native = None
        return self._native

    def encode_batch(self, texts: Sequence[str],
                     pairs: Optional[Sequence[str]] = None,
                     max_length: int = 512):
        """Fixed-shape batch: (ids (B, L) i32, mask (B, L) i32,
        token_type_ids (B, L) i32)."""
        native = self._get_native() if pairs is None else None
        if native is not None:
            # normalization and the metaspace stay in Python (NFKC or the
            # charsmap's own native port); Viterbi and layout run in C++
            prepared = []
            for t in texts:
                s = self.normalize(t)
                prepared.append(METASPACE + s.replace(" ", METASPACE)
                                if s else "")
            if not any("\x00" in s for s in prepared):   # NUL ends a text
                return native.encode_batch(prepared, max_length)
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
        out = []
        for i in ids:
            i = int(i)
            if i in (self.pad_id, self.cls_id, self.sep_id):
                continue
            out.append(self.pieces[i][0] if i < len(self.pieces) else "[UNK]")
        return "".join(out).replace(METASPACE, " ").strip()
