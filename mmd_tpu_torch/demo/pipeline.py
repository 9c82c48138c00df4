"""End-to-end claim verification: the demo's five steps as one offline,
batched pipeline (counterpart of mmd_tpu/demo/pipeline.py).

Mirrors reference src/demo/app.py's flow (caption :45-54 -> enrich :57-61 ->
text retrieval :93-163 -> image retrieval :171-234 -> per-evidence classify
:242-263 -> two-stage path agreement :313-340 -> corpus majority vote
:343-371) with the reference's perf cliff removed: all retrieved evidence
pairs classify in ONE `evaluate_batch` (the predictor's fixed batches, on
its device) instead of a tokenizer+encoder run per pair (app.py:461-476).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import pandas as pd

from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.inference.rules import (
    determine_final_classification, get_final_classification,
)


@dataclasses.dataclass
class Evidence:
    id: str
    text: str
    image_path: Optional[str]
    score: float
    source: str                           # "text" | "image"
    classification_result_all: Optional[tuple] = None
    classification_result_final: Optional[str] = None


@dataclasses.dataclass
class VerificationResult:
    claim: str
    claim_enriched: str
    caption: str
    final_classification: str
    contributing_indices: list
    evidences: list


class EvidenceIndex:
    """id -> (text, image_path) lookup over the enriched CSVs, with ids in
    the retrieval format f\"{split}_{id}\" (reference text2text corpus ids)."""

    def __init__(self, csv_by_split: dict[str, str | Path],
                 root: Optional[Path] = None):
        self.rows: dict[str, dict] = {}
        for split, csv_path in csv_by_split.items():
            df = pd.read_csv(csv_path)
            text_col = ("evidence_enriched" if "evidence_enriched" in df
                        else "evidence")
            for _, r in df.iterrows():
                img = r.get("evidence_image")
                if isinstance(img, str) and root is not None:
                    img = str(root / img)
                self.rows[f"{split}_{r['id']}"] = {
                    "text": str(r[text_col]),
                    "image": img if isinstance(img, str) else None,
                }

    def __getitem__(self, key: str) -> dict:
        return self.rows[key]

    def get(self, key: str, default=None):
        return self.rows.get(key, default)

    def text_lookup(self) -> dict[str, str]:
        return {k: v["text"] for k, v in self.rows.items()}


class ClaimVerificationPipeline:
    def __init__(self, predictor: MisinformationPredictor,
                 text_search=None, image_corpus=None,
                 caption_engine=None, evidence_index: EvidenceIndex = None,
                 image_id_resolver=None):
        """image_id_resolver: corpus image path -> evidence id in the index
        (default: `Path(p).stem` minus trailing `_evidence` -> `train_{id}`
        style left to the caller)."""
        self.predictor = predictor
        self.text_search = text_search
        self.image_corpus = image_corpus
        self.caption_engine = caption_engine
        self.index = evidence_index
        self.image_id_resolver = image_id_resolver or self._default_resolver
        self._verify_cache: dict = {}

    @staticmethod
    def _default_resolver(path: str) -> Optional[str]:
        # evidence_corpus naming: {split}_{id}_evidence.jpg (reference
        # corpus_utils.py:7-32)
        name = Path(path).name
        if name.endswith("_evidence.jpg"):
            return name[: -len("_evidence.jpg")]
        return None

    # -- the demo's five steps (reference app.py:418-479), individually
    # callable so a UI can render progress between them --------------------

    def caption_step(self, claim_image_path: Optional[str]) -> str:
        """Step 1 (reference app.py:418-422): generate the claim caption."""
        if claim_image_path and self.caption_engine is not None:
            return self.caption_engine.caption_paths([claim_image_path])[0]
        return ""

    @staticmethod
    def enrich_step(claim_text: str, caption: str) -> str:
        """Step 2 (reference app.py:57-61,426-429): `{claim}. {caption}`."""
        return f"{claim_text}. {caption}" if caption else claim_text

    def retrieve_text_step(self, claim_enriched: str,
                           top_k: int = 5) -> list[Evidence]:
        """Step 3 (reference app.py:433-442): text2text retrieval."""
        out: list[Evidence] = []
        if self.text_search is not None:
            for eid, score in self.text_search.search(claim_enriched, top_k):
                row = self.index.get(eid) if self.index else None
                out.append(Evidence(
                    id=eid, text=row["text"] if row else "",
                    image_path=row["image"] if row else None,
                    score=float(score), source="text"))
        return out

    def retrieve_image_step(self, claim_image_path: Optional[str],
                            top_k: int = 5) -> list[Evidence]:
        """Step 4 (reference app.py:446-455): im2im retrieval."""
        out: list[Evidence] = []
        if claim_image_path and self.image_corpus is not None:
            for path, score in self.image_corpus.retrieve_similar_images(
                    claim_image_path, top_k):
                eid = self.image_id_resolver(path)
                row = self.index.get(eid) if (self.index and eid) else None
                out.append(Evidence(
                    id=eid or path, text=row["text"] if row else "",
                    image_path=path, score=float(score), source="image"))
        return out

    def classify_step(self, claim_enriched: str,
                      claim_image_path: Optional[str],
                      evidences: list[Evidence]) -> tuple[str, list]:
        """Step 5 (reference app.py:459-479): classify ALL (claim, evidence)
        pairs in one batch, then the two-stage agreement rule + majority
        vote. Mutates the evidences' classification fields; returns
        (final_classification, contributing_indices)."""
        if evidences:
            results = self.predictor.evaluate_batch(
                [claim_enriched] * len(evidences),
                [claim_image_path] * len(evidences),
                [e.text for e in evidences],
                [e.image_path for e in evidences])
            for e, r in zip(evidences, results):
                paths = (r["text_text"], r["text_image"],
                         r["image_text"], r["image_image"])
                e.classification_result_all = paths
                e.classification_result_final = get_final_classification(paths)
        return determine_final_classification(
            [e.classification_result_final for e in evidences])

    def verify(self, claim_text: str, claim_image_path: Optional[str] = None,
               top_k: int = 5,
               top_k_image: Optional[int] = None) -> VerificationResult:
        """Cached per pipeline: repeat queries (streamlit reruns re-invoke the
        whole page on every widget change) return the memoized result, the
        role of the reference's @st.cache_data on its retrieve/caption
        helpers (reference app.py:62-90)."""
        key = (claim_text, claim_image_path, top_k, top_k_image)
        cached = self._verify_cache.get(key)
        if cached is not None:
            return cached
        result = self._verify_uncached(claim_text, claim_image_path, top_k,
                                       top_k_image)
        if len(self._verify_cache) >= 64:     # bound the cache's memory
            self._verify_cache.pop(next(iter(self._verify_cache)))
        self._verify_cache[key] = result
        return result

    def _verify_uncached(self, claim_text, claim_image_path, top_k,
                         top_k_image) -> VerificationResult:
        caption = self.caption_step(claim_image_path)
        claim_enriched = self.enrich_step(claim_text, caption)
        evidences = self.retrieve_text_step(claim_enriched, top_k)
        evidences += self.retrieve_image_step(
            claim_image_path, top_k if top_k_image is None else top_k_image)
        final, contributing = self.classify_step(
            claim_enriched, claim_image_path, evidences)
        return VerificationResult(
            claim=claim_text, claim_enriched=claim_enriched, caption=caption,
            final_classification=final, contributing_indices=contributing,
            evidences=evidences)
