"""Retrieval top-k accuracy experiments (counterpart of
mmd_tpu/retrieval/experiments.py).

Protocol parity with reference src/evidence/experiment_image.py (query =
every test `{id}_claim.jpg`, relevant = same id's `_evidence`, k in
{1,2,5,10}) and experiment_text.py (query = test `claim`, relevant =
`test_{id}`), with the reference's platform bugs fixed (its '\\\\'-only path
split :43,54 and the nonexistent `similarity.device` attribute :21).

Results append to a txt file like the reference, plus a JSON line for
machines.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from mmd_tpu_torch.training.metrics import topk_accuracy

DEFAULT_KS = (1, 2, 5, 10)


def evaluate_topk(
    query_ids: Sequence[str],
    retrieve: Callable[[str, int], list],
    relevant_for: Callable[[str], str],
    result_id: Callable[[object], str],
    ks: Sequence[int] = DEFAULT_KS,
) -> dict[int, float]:
    """Generic protocol: for each query, check whether its relevant id is in
    the top-k retrieved ids. `retrieve(query, k) -> list of results`."""
    k_max = max(ks)
    hits = {k: [] for k in ks}
    for qid in query_ids:
        results = retrieve(qid, k_max)
        ids = [result_id(r) for r in results]
        rel = relevant_for(qid)
        for k in ks:
            hits[k].append(rel in ids[:k])
    return {k: topk_accuracy(np.array(v)) for k, v in hits.items()}


def image_retrieval_experiment(corpus, query_paths: Sequence[str],
                               ks: Sequence[int] = DEFAULT_KS,
                               out_file: str | None = None) -> dict[int, float]:
    """corpus: ImageCorpus whose ids are paths `{id}_evidence.jpg` (reference
    per-split layout, experiment_image.py:40-54) or `{split}_{id}_evidence.jpg`
    (flat evidence_corpus/ layout, corpus_utils.py:7-32); queries are
    `{id}_claim.jpg` paths. The reference's hit key is `f"{id}_evidence"`
    (experiment_image.py:52-57) — so for corpus names we keep only the LAST
    two underscore tokens, which strips any split prefix."""
    def query_id(path: str) -> str:
        # ".../12_claim.jpg" -> "12"
        return Path(str(path)).name.rsplit("_", 1)[0]

    def result_id(r) -> str:
        # "test_12_evidence.jpg" or "12_evidence.jpg" -> "12_evidence"
        parts = Path(str(r[0])).name.rsplit(".", 1)[0].split("_")
        return "_".join(parts[-2:])

    def retrieve(qpath, k):
        return corpus.retrieve_similar_images(qpath, top_k=k)

    acc = evaluate_topk(
        query_paths, retrieve,
        relevant_for=lambda q: query_id(q) + "_evidence",
        result_id=result_id,
        ks=ks,
    )
    _write_results("image_retrieval_topk_accuracy_results.txt", acc, out_file)
    return acc


def text_retrieval_experiment(search, queries: Sequence[tuple[str, str]],
                              ks: Sequence[int] = DEFAULT_KS,
                              out_file: str | None = None) -> dict[int, float]:
    """queries: list of (query_text, relevant_id)."""
    rel = {q: r for q, r in queries}
    acc = evaluate_topk(
        [q for q, _ in queries],
        retrieve=lambda q, k: search.search(q, top_k=k),
        relevant_for=lambda q: rel[q],
        result_id=lambda r: r[0],
        ks=ks,
    )
    _write_results("topk_accuracy_results.txt", acc, out_file)
    return acc


def _write_results(default_name: str, acc: dict[int, float],
                   out_file: str | None):
    path = Path(out_file) if out_file else Path(default_name)
    with open(path, "a") as f:
        f.write(f"--- {time.strftime('%Y-%m-%d %H:%M:%S')} ---\n")
        for k, v in sorted(acc.items()):
            f.write(f"top-{k} accuracy: {v:.4f}\n")
        f.write(json.dumps({f"top{k}": v for k, v in acc.items()}) + "\n")
