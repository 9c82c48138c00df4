"""Text-to-text evidence retrieval: bi-encoder recall + cross-encoder
re-rank (counterpart of mmd_tpu/retrieval/text.py).

Parity with the reference protocol (reference text2text_retrieval.py):
  * TextCorpus.encode_corpus: embed every `evidence_enriched` row with the
    bi-encoder (mean-pooled sentence embeddings, float16 store + ids
    `f"{split}_{id}"`, :123-157);
  * SemanticSearch.search(query, top_k): bi-encode the query, take top
    (top_k*5) from the train AND test corpora (:56-64), re-rank the union
    with the cross-encoder over [query, evidence] PAIRS (:69-95), merge,
    sort by cross score, exact-score dedup, truncate (:97-120).

Corpora live on the card as one matrix per split; recall is one GEMM and
a top-k (ops/topk.py); the cross-encoder re-rank runs as ONE batched
forward over all candidate pairs, through the flash-attention kernel where
the routing rule sends it (the MiniLM's head dim 32, bf16). The corpus
rows are l2-normalized once, at load: the JAX package normalizes them on
every call, and the normalized rows are the same either way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from mmd_tpu_torch.core.checkpoint import load_params
from mmd_tpu_torch.data.store import ArrayStore, ArrayStoreWriter
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models.frozen import asset_path
from mmd_tpu_torch.models.transformer import TransformerConfig
from mmd_tpu_torch.ops.topk import (
    dense_topk, dense_topk_int8, exact_score_dedup, l2_normalize,
    quantize_rows_int8,
)


class TextCorpus:
    """Builds + serves one split's evidence-embedding matrix."""

    def __init__(self, store_dir: str | Path, tokenizer: WordPieceTokenizer,
                 cfg: Optional[TransformerConfig] = None, params=None,
                 seed: int = 11, max_length: int = 512, int8: bool = False,
                 device: str | torch.device = "cuda"):
        """With `int8`, the corpus matrix lives per-row-quantized int8 on
        the card (+ f32 scales) and scoring runs the int8 GEMM
        (ops/topk.dense_topk_int8): half the corpus memory and traffic,
        near-tie ordering within the ~1/127 step. Without params, a seeded
        encoder of cfg at the tokenizer's vocabulary size."""
        self.dir = Path(store_dir)
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.cfg = cfg or te.BI_ENCODER_BASE
        if params is None:
            self.cfg = dataclasses.replace(
                self.cfg, vocab_size=tokenizer.vocab_size)
            params = te.init_text_encoder(
                torch.Generator().manual_seed(seed), self.cfg)
        self.params = params.to(self.device)
        self.max_length = max_length
        self.int8 = int8
        self._emb = None
        self._q8 = None
        self._scales = None
        self._ids: Optional[list] = None

    @torch.no_grad()
    def encode_texts(self, texts: Sequence[str], batch_size: int = 64
                     ) -> np.ndarray:
        """(len(texts), hidden) float32 mean-pooled embeddings, batch by
        batch (rows do not depend on the batch they share)."""
        out = []
        texts = [str(t) for t in texts]
        for lo in range(0, len(texts), batch_size):
            ids, mask, _ = self.tokenizer.encode_batch(
                texts[lo:lo + batch_size], max_length=self.max_length)
            ids = torch.from_numpy(ids).to(self.device, torch.int64)
            mask = torch.from_numpy(mask).to(self.device)
            hidden = te.encode(self.params, self.cfg, ids, mask)
            out.append(te.mean_pool(hidden, mask).cpu().numpy())
        if not out:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        return np.concatenate(out)

    def encode_corpus(self, texts: Sequence[str], ids: Sequence[str],
                      batch_size: int = 64) -> int:
        emb = self.encode_texts(texts, batch_size).astype(np.float16)
        writer = ArrayStoreWriter(
            self.dir, capacity=len(emb),
            columns={"embeddings": ((self.cfg.hidden_size,), np.float16)})
        if len(emb):
            writer.append_batch({"embeddings": emb})
        writer.finalize()
        (self.dir / "ids.json").write_text(json.dumps(list(map(str, ids))))
        print(f"[text2text] corpus {self.dir}: {len(emb)} embeddings")
        return len(emb)

    def load(self):
        """-> (rows, ids): the l2-normalized bf16 rows on the card (None
        with int8, whose codes and scales are kept instead)."""
        if self._ids is None:
            store = ArrayStore(self.dir)
            ids = json.loads((self.dir / "ids.json").read_text())
            feats = torch.from_numpy(np.array(
                store.col("embeddings"))).to(self.device)
            if self.int8:
                self._q8, self._scales = quantize_rows_int8(
                    l2_normalize(feats.float()))
            else:
                self._emb = l2_normalize(feats.to(torch.bfloat16))
            self._ids = ids
        return self._emb, self._ids

    def topk(self, queries, k: int):
        """(scores (Q, k) f32, indices (Q, k) int64) over this corpus, on
        the card: cosine over bf16 rows, or the int8 GEMM per the `int8`
        flag."""
        self.load()
        q = torch.as_tensor(np.asarray(queries), device=self.device)
        if self.int8:
            return dense_topk_int8(q.float(), self._q8, self._scales, k)
        return dense_topk(l2_normalize(q.to(torch.bfloat16)), self._emb, k,
                          normalize=False)


def resolve_retrieval_encoders(assets_dir) -> dict:
    """Converted retrieval assets (convert_hf's mpnet and cross-encoder
    conversions, or tools/orbax_to_torch.py): {"bi_cfg", "bi_params",
    "bi_tokenizer", "cross_cfg", "cross_params"}, entries None when no
    converted checkpoint is present (the seeded-init fallback applies).
    An orbax <name>.ckpt with no <name>.pt beside it raises and names the
    script that converts it. Params are on the CPU."""
    assets = Path(assets_dir)
    out = {"bi_cfg": None, "bi_params": None, "bi_tokenizer": None,
           "cross_cfg": None, "cross_params": None}
    bi, cross = asset_path(assets, "bi_encoder"), asset_path(
        assets, "cross_encoder")
    gen = torch.Generator().manual_seed(0)
    if bi is not None:
        cfg = TransformerConfig(**json.loads(
            (assets / "bi_encoder_config.json").read_text()))
        out["bi_cfg"] = cfg
        out["bi_params"] = load_params(str(bi), te.init_text_encoder(gen, cfg))
        if (assets / "bi_tokenizer.json").exists():
            out["bi_tokenizer"] = WordPieceTokenizer.load(
                assets / "bi_tokenizer.json")
    if cross is not None:
        cfg = TransformerConfig(**json.loads(
            (assets / "cross_encoder_config.json").read_text()))
        state = torch.load(cross, map_location="cpu", weights_only=True)
        params = te.init_cross_encoder(
            gen, cfg, pooler=any(k.startswith("pooler.") for k in state))
        params.load_state_dict(state)
        out["cross_cfg"], out["cross_params"] = cfg, params
    return out


class SemanticSearch:
    """Two-stage search over one or more corpora with optional re-rank."""

    def __init__(self, bi_encoder: TextCorpus, corpora: Sequence[TextCorpus],
                 cross_encoder_params=None, cross_cfg=None,
                 evidence_lookup=None, rerank_max_length: int = 256):
        """evidence_lookup: id -> evidence text (needed for re-ranking).
        The cross-encoder runs on the bi-encoder's device."""
        self.bi = bi_encoder
        self.corpora = list(corpora)
        self.lookup = evidence_lookup or {}
        self.cross_cfg = cross_cfg
        self.cross_params = (None if cross_encoder_params is None else
                             cross_encoder_params.to(self.bi.device))
        self.rerank_max_length = rerank_max_length

    @torch.no_grad()
    def _cross_scores(self, query: str, cand_ids: list[str]) -> np.ndarray:
        texts = [str(self.lookup.get(c, "")) for c in cand_ids]
        ids, mask, types = self.bi.tokenizer.encode_batch(
            [query] * len(texts), pairs=texts,
            max_length=self.rerank_max_length)
        dev = self.bi.device
        scores = te.cross_encoder_score(
            self.cross_params, self.cross_cfg,
            torch.from_numpy(ids).to(dev, torch.int64),
            torch.from_numpy(mask).to(dev),
            torch.from_numpy(types).to(dev, torch.int64))
        return scores.float().cpu().numpy()

    def search(self, query: str, top_k: int = 5, recall_factor: int = 5,
               dedup: bool = True):
        """-> list[(id, score)]; cross-encoder scores when available, else
        bi-encoder cosine."""
        q = self.bi.encode_texts([query])  # (1, D)
        cands: list[tuple[str, float]] = []
        fetch = top_k * recall_factor
        for corpus in self.corpora:
            _, ids = corpus.load()
            k = min(fetch, len(ids))
            if k == 0:
                continue
            s, i = corpus.topk(q, k)
            s, i = s[0].cpu().numpy(), i[0].cpu().numpy()
            cands.extend((ids[j], float(v)) for v, j in zip(s, i))

        if self.cross_params is not None and cands:
            cand_ids = [c for c, _ in cands]
            scores = self._cross_scores(query, cand_ids)
            cands = list(zip(cand_ids, scores.tolist()))

        cands.sort(key=lambda x: -x[1])
        if dedup:
            s, i = exact_score_dedup(
                np.array([c[1] for c in cands]),
                np.arange(len(cands)), top_k)
            return [(cands[j][0], v) for v, j in zip(s, i)]
        return cands[:top_k]


def main(argv=None):
    """CLI parity with `python -m src.evidence.text2text_retrieval`
    (reference text2text_retrieval.py:160-195: build corpora, run one demo
    query). Runs on the card unless --device cpu."""
    import pandas as pd
    from mmd_tpu_torch.data.schema import get_project_root
    p = argparse.ArgumentParser()
    p.add_argument("--splits", nargs="+", default=["train", "test"])
    p.add_argument("--assets", type=str, default="assets/encoders")
    p.add_argument("--query", type=str, default=None)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="serve the corpora int8-quantized (half the "
                        "memory, int8 GEMM scoring)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    root = get_project_root()
    tok = WordPieceTokenizer.load(Path(args.assets) / "tokenizer.json")
    cfg = te.TINY_TEST if args.tiny else None
    corpora = []
    lookup = {}
    for split in args.splits:
        csv = root / "data" / "preprocessed" / f"{split}_enriched.csv"
        if not csv.exists():
            csv = root / "data" / "preprocessed" / f"{split}.csv"
        df = pd.read_csv(csv)
        col = "evidence_enriched" if "evidence_enriched" in df else "evidence"
        corpus = TextCorpus(root / "data" / "retrieval" / f"text_{split}",
                            tok, cfg=cfg, int8=args.int8, device=device)
        if not (corpus.dir / "meta.json").exists():
            corpus.encode_corpus(df[col].fillna("").astype(str).tolist(),
                                 [f"{split}_{i}" for i in df["id"]])
        lookup.update({f"{split}_{r['id']}": str(r[col])
                       for _, r in df.iterrows()})
        corpora.append(corpus)
    if args.query:
        search = SemanticSearch(corpora[0], corpora, evidence_lookup=lookup)
        for eid, score in search.search(args.query, args.top_k):
            print(f"{score:.4f}  {eid}  {lookup.get(eid, '')[:100]}")


if __name__ == "__main__":
    main()
