"""Synthetic pre-embedded Factify-shaped batches for tests, smoke runs and
benchmarks (the port's copy of mmd_tpu/data/synthetic.py's
synthetic_preembed_batch).

Batches have the exact shapes of the embedding store (text (512, 384),
image (64, 1024) -- reference preprocess_embeddings.py:63-92) and make the
same numpy draws as the JAX package's, so one seed gives the same batches
in both. The raw Factify tree writer belongs to the pipelines slice.
"""

from __future__ import annotations

import numpy as np

from mmd_tpu_torch.data import labels as lb


def synthetic_preembed_batch(
    rng: np.random.Generator,
    batch_size: int = 32,
    text_seq: int = 512,
    image_seq: int = 64,
    text_dim: int = 384,
    image_dim: int = 1024,
    learnable: bool = True,
    dtype=np.float32,
) -> dict:
    """One pre-embedded batch. With `learnable`, class-dependent signal is
    injected so a working model can actually fit it (loss must decrease)."""
    cat_idx = rng.integers(0, len(lb.CATEGORIES), size=batch_size)
    labels = lb.LABEL_TABLE[cat_idx]

    def emb(seq, dim, scale=1.0):
        return rng.standard_normal((batch_size, seq, dim)).astype(dtype) * scale

    batch = {
        "claim_text_embeds": emb(text_seq, text_dim),
        "doc_text_embeds": emb(text_seq, text_dim),
        "claim_image_embeds": emb(image_seq, image_dim),
        "doc_image_embeds": emb(image_seq, image_dim),
        "labels": labels.astype(np.int32),
    }
    if learnable:
        # Plant a per-category mean shift in the first feature channels so the
        # labels are recoverable from the inputs.
        shift = (cat_idx[:, None, None].astype(dtype) - 2.0) * 0.5
        batch["claim_text_embeds"][..., :8] += shift
        batch["claim_image_embeds"][..., :8] += shift
    return batch
