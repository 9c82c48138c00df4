"""Prompting baselines: zero-shot LLM fact-checking and LLM-as-reranker
(counterpart of mmd_tpu/baselines/prompting.py: pure Python and numpy).

Covers the capability surface of the two vendored prompting baselines:

  * kumar_et_al (reference src/baselines/kumar_et_al/eval_bloom.py): a
    fact-checker prompt template, greedy generation, keyword label parsing
    into {support, NEI, refute} (:31-42), and 3-class P/R/F1 (:127-152).
  * LVLM4FV (reference src/baselines/LVLM4FV): yes/no verification by
    softmaxing only the yes/no token logits of the FIRST generated token
    (models.py:60-73,189-206), one- and two-level prompting verification
    (sufficiency gate -> support/refute, FNdetection_llm.py:187-245) with
    majority voting (:337), and retrieval metrics P@k / R@k / MAP@k
    (eval_ir_llms.py:285-323).

The LLM itself is an injected callable (`llm(prompt) -> str` or
`first_token_logits(prompt, tokens) -> dict`), so the protocols run and test
offline; plug in a real decoder (e.g. models/captioner-style LM or a served
endpoint) where available.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from mmd_tpu_torch.training import metrics as M

SUPPORT, NEI, REFUTE = 0, 1, 2

FACT_CHECK_PROMPT = (
    "You are a fact checker. Given a claim and evidence, decide whether the "
    "evidence supports the claim, refutes the claim, or there is not enough "
    "information.\n\nClaim: {claim}\nEvidence: {evidence}\nAnswer:"
)

SUFFICIENCY_PROMPT = (
    "Does the following evidence contain enough information to verify the "
    "claim? Answer yes or no.\n\nClaim: {claim}\nEvidence: {evidence}\nAnswer:"
)

VERIFY_PROMPT = (
    "Does the evidence support the claim? Answer yes or no.\n\n"
    "Claim: {claim}\nEvidence: {evidence}\nAnswer:"
)

RERANK_PROMPT = (
    "Is this document relevant evidence for verifying the claim? Answer yes "
    "or no.\n\nClaim: {claim}\nDocument: {document}\nAnswer:"
)


def parse_label(text: str) -> int:
    """Keyword label parse (kumar_et_al eval_bloom.py:31-42 semantics):
    scan the generation for decisive keywords; default NEI."""
    t = str(text).lower()
    has_support = "support" in t or "true" in t
    has_refute = "refute" in t or "false" in t or "not true" in t
    if "not enough" in t or "insufficient" in t:
        return NEI
    if has_refute and not has_support:
        return REFUTE
    if has_support and not has_refute:
        return SUPPORT
    return NEI


def evaluate_zero_shot(llm: Callable[[str], str],
                       pairs: Sequence[tuple[str, str]],
                       labels: Sequence[int],
                       prompt: str = FACT_CHECK_PROMPT) -> dict:
    """Zero-shot 3-class eval: prompt -> generate -> parse -> P/R/F1."""
    preds = [parse_label(llm(prompt.format(claim=c, evidence=e)))
             for c, e in pairs]
    y_true = np.asarray(labels)
    y_pred = np.asarray(preds)
    prec, rec, f1, _ = M.precision_recall_f1(y_true, y_pred, 3)
    return {
        "accuracy": M.accuracy(y_true, y_pred),
        "micro_f1": M.f1_score(y_true, y_pred, 3, "micro"),
        "weighted_f1": M.f1_score(y_true, y_pred, 3, "weighted"),
        "per_class_precision": prec.tolist(),
        "per_class_recall": rec.tolist(),
        "per_class_f1": f1.tolist(),
        "predictions": preds,
    }


def yes_no_probability(first_token_logits: Mapping[str, float]) -> float:
    """P(yes) from the first generated token's yes/no logits only
    (LVLM4FV models.py:60-73)."""
    ly = float(first_token_logits["yes"])
    ln = float(first_token_logits["no"])
    m = max(ly, ln)
    ey, en = np.exp(ly - m), np.exp(ln - m)
    return float(ey / (ey + en))


def two_level_verify(
    score: Callable[[str], float],
    claim: str,
    evidences: Sequence[str],
    sufficiency_threshold: float = 0.5,
    support_threshold: float = 0.5,
) -> tuple[int, list[int]]:
    """Two-level prompting verification with majority vote
    (FNdetection_llm.py:187-245,337): per evidence, a sufficiency gate
    (NEI when P(yes) < threshold) then support/refute; corpus-level majority
    with ties -> NEI. `score(prompt) -> P(yes)`. Returns (label, votes)."""
    votes: list[int] = []
    for ev in evidences:
        p_suff = score(SUFFICIENCY_PROMPT.format(claim=claim, evidence=ev))
        if p_suff < sufficiency_threshold:
            votes.append(NEI)
            continue
        p_sup = score(VERIFY_PROMPT.format(claim=claim, evidence=ev))
        votes.append(SUPPORT if p_sup >= support_threshold else REFUTE)
    counts = Counter(votes)
    s, r = counts[SUPPORT], counts[REFUTE]
    if s == r:
        return NEI, votes
    return (SUPPORT if s > r else REFUTE), votes


def llm_rerank(score: Callable[[str], float], claim: str,
               candidates: Sequence[str]) -> list[int]:
    """LLM-as-reranker: order candidate indices by P(yes) relevance
    (eval_ir_llms.py protocol)."""
    scores = [score(RERANK_PROMPT.format(claim=claim, document=c))
              for c in candidates]
    return list(np.argsort(-np.asarray(scores)))


# -- retrieval metrics (eval_ir_llms.py:285-323) -------------------------------

def precision_at_k(retrieved: Sequence, relevant: set, k: int) -> float:
    top = list(retrieved)[:k]
    return sum(1 for r in top if r in relevant) / max(k, 1)


def recall_at_k(retrieved: Sequence, relevant: set, k: int) -> float:
    if not relevant:
        return 0.0
    top = list(retrieved)[:k]
    return sum(1 for r in top if r in relevant) / len(relevant)


def average_precision_at_k(retrieved: Sequence, relevant: set, k: int) -> float:
    if not relevant:
        return 0.0
    hits, score = 0, 0.0
    for i, r in enumerate(list(retrieved)[:k], 1):
        if r in relevant:
            hits += 1
            score += hits / i
    return score / min(len(relevant), k)


def map_at_k(all_retrieved: Iterable[Sequence], all_relevant: Iterable[set],
             k: int) -> float:
    aps = [average_precision_at_k(r, rel, k)
           for r, rel in zip(all_retrieved, all_relevant)]
    return float(np.mean(aps)) if aps else 0.0
