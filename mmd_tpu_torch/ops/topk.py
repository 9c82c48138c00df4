"""Dense retrieval: corpus matmul + top-k (counterpart of mmd_tpu/ops/topk.py).

Scoring stays in library calls, as the JAX package keeps it outside any
Pallas kernel: a GEMM (bf16 operands, fp32 accumulation and output) or an
int8 GEMM (`torch._int_mm`, int32 accumulation), then `torch.topk`.

Ties follow `lax.top_k`: among equal scores the lower corpus index comes
first, and at the k-th place the lower index is the one kept. `torch.topk`
promises no order among ties, so the top-k is a stable descending sort of
the scores' order-preserving int32 bits (which, as `lax.top_k` does, put
+0.0 above -0.0). Duplicate corpus rows therefore come back lower index
first, and `exact_score_dedup` keeps that one (the reference's
duplicate-image heuristic).

`make_sharded_topk` serves a corpus whose rows shard over a mesh axis
(core/mesh.py): each rank takes its local top-k, offsets its indices by its
first row, and the ranks all-gather the (Q, k) candidates for one global
re-top-k in the same order, so the lower global index still comes first
among equal scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA wants more than 16 rows in its first operand and
# multiples of 8 for the inner and outer widths
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rows over their fp32 L2 norm, cast back to x's dtype."""
    n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return (x / n.clamp_min(eps)).to(x.dtype)


def topk_lower_index_first(scores: torch.Tensor, k: int):
    """`lax.top_k` over the last axis of fp32 (Q, N) scores -> (values
    (Q, k) f32, indices (Q, k) int64), lower index first among ties."""
    scores = scores.float().contiguous()
    bits = scores.view(torch.int32)
    # order-preserving: negative floats flip their magnitude bits
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    i = torch.sort(ordered, dim=-1, descending=True, stable=True
                   ).indices[..., :k]
    return torch.gather(scores, -1, i), i


def _scores(query: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) fp32, products of the operands' dtype
    summed in fp32: one GEMM with an fp32 output on CUDA; on the CPU the
    operands widen to fp32 first (bf16 products are exact in fp32)."""
    if query.device.type == "cuda" and query.dtype != torch.float32:
        return torch.mm(query, corpus.t(), out_dtype=torch.float32)
    return query.float() @ corpus.float().t()


def dense_topk(query: torch.Tensor, corpus: torch.Tensor, k: int,
               normalize: bool = True):
    """query (Q, D), corpus (N, D) -> (scores (Q, k) f32, indices (Q, k)
    int64). Cosine when normalize, else dot."""
    if normalize:
        query, corpus = l2_normalize(query), l2_normalize(corpus)
    return topk_lower_index_first(_scores(query, corpus), k)


def make_sharded_topk(mesh, axis: str, n_corpus: int, k: int,
                      normalize: bool = True):
    """Sharded retrieval: corpus rows sharded over `axis` (this rank holds
    rows [i * n_local, (i + 1) * n_local), n_local = n_corpus / axis size),
    the query replicated. -> fn(query (Q, D), corpus shard (n_local, D)) ->
    (scores (Q, k) f32, global indices (Q, k) int64), the same on every
    rank of the axis. n_corpus must divide evenly: pad the corpus with zero
    rows otherwise and drop their indices."""
    from mmd_tpu_torch.parallel import collectives as C

    n_dev = mesh.shape[axis]
    if n_corpus % n_dev:
        raise ValueError(f"n_corpus={n_corpus} must divide by the {n_dev} "
                         f"ranks of axis {axis!r}")
    n_local = n_corpus // n_dev
    offset = mesh.axis_index(axis) * n_local

    def local(query: torch.Tensor, shard: torch.Tensor):
        s, i = dense_topk(query, shard, min(k, n_local), normalize)
        i = i + offset
        # (n_dev * Q, k') in axis order -> (Q, n_dev * k'): rank r's
        # candidates, all of lower index than rank r + 1's, come first
        q_n = s.shape[0]
        s_all = C.all_gather(s, mesh, axis, dim=0).view(n_dev, q_n, -1)
        i_all = C.all_gather(i, mesh, axis, dim=0).view(n_dev, q_n, -1)
        s_flat = s_all.transpose(0, 1).reshape(q_n, -1)
        i_flat = i_all.transpose(0, 1).reshape(q_n, -1)
        s_top, pos = topk_lower_index_first(s_flat, k)
        return s_top, torch.gather(i_flat, 1, pos)

    return local


def quantize_rows_int8(x: torch.Tensor):
    """Symmetric per-row int8: q = round(x / s) (half to even), clipped to
    +-127, s = max|row| / 127, so x ~= q * s[:, None]. Returns (q (N, D)
    int8, s (N,) f32). Duplicate rows quantize identically."""
    x = x.float()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which can differ from the quotient by an ulp
    s = (x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
         / x.new_full((), 127.0))
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_products(query_q8: torch.Tensor, corpus_q8: torch.Tensor
                  ) -> torch.Tensor:
    """(Q, D) x (N, D) int8 -> (Q, N) int32 raw products through
    torch._int_mm. The corpus supplies the GEMM's rows and the queries its
    columns, padded with zero rows to a multiple of 8 (and the corpus,
    when it has 16 rows or fewer, to 24; D to a multiple of 8); zeros add
    nothing and the padding is sliced off."""
    q, n = query_q8.shape[0], corpus_q8.shape[0]
    d = _round_up(corpus_q8.shape[1], _INT_MM_ALIGN)
    c = corpus_q8
    if d != c.shape[1] or n < _INT_MM_MIN_ROWS:
        c = _pad_to(c, max(n, _round_up(_INT_MM_MIN_ROWS, _INT_MM_ALIGN)),
                    d)
    p = _pad_to(query_q8, _round_up(q, _INT_MM_ALIGN), d)
    raw = torch._int_mm(c, p.t())                      # (N', Q')
    return raw[:n, :q].t()


def dense_topk_int8(query: torch.Tensor, corpus_q8: torch.Tensor,
                    corpus_scale: torch.Tensor, k: int,
                    normalize: bool = True):
    """int8 corpus scoring: queries quantized per row as the corpus is,
    int32 raw products, then raw * query scale * corpus scale in fp32.
    Corpus rows must be quantized after l2 normalization (the corpora's
    loaders do so). Relative score error is ~1/127 per side."""
    if normalize:
        query = l2_normalize(query)
    p8, ps = quantize_rows_int8(query)
    raw = int8_products(p8, corpus_q8)
    scores = raw.float() * ps[:, None] * corpus_scale[None, :]
    return topk_lower_index_first(scores, k)


def exact_score_dedup(scores, indices, k: int):
    """Host-side: drop results whose score exactly equals an earlier one
    (the reference's duplicate-image heuristic, im2im_retrieval.py:94-103;
    text2text_retrieval.py:105-118), then truncate to k. Operates on one
    query's (n,) arrays; returns (scores, indices) lists."""
    import numpy as np
    scores = np.asarray(scores)
    indices = np.asarray(indices)
    seen = set()
    out_s, out_i = [], []
    for s, i in zip(scores, indices):
        key = float(s)
        if key in seen:
            continue
        seen.add(key)
        out_s.append(float(s))
        out_i.append(int(i))
        if len(out_s) == k:
            break
    return out_s, out_i
