"""Synthetic Factify-shaped data for tests, smoke runs and benchmarks (the
port's copy of mmd_tpu/data/synthetic.py).

(a) Pre-embedded batches with the exact shapes of the embedding store (text
(512, 384), image (64, 1024) -- reference preprocess_embeddings.py:63-92);
(b) a small raw Factify tree (TSV + JPEG images) for the preprocess and
raw-store pipelines. Both make the same numpy draws as the JAX package's,
so one seed gives the same data in both.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from mmd_tpu_torch.data import labels as lb
from mmd_tpu_torch.data.schema import HEADERS


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


# Per-category signal for `learnable` trees: distinct vocabulary (text
# signal for the classifiers) and a distinct RGB tint (image signal).
CAT_SIGNAL_WORDS = {
    "Support_Text": "confirmed verified corroborated accurate",
    "Support_Multimodal": "authentic consistent matching documented",
    "Insufficient_Text": "unclear ambiguous vague unspecified",
    "Insufficient_Multimodal": "tangential mismatched stray unrelated",
    "Refute": "false debunked fabricated misleading",
}
CAT_TINT = {
    "Support_Text": (120, 0, 0),
    "Support_Multimodal": (0, 120, 0),
    "Insufficient_Text": (0, 0, 120),
    "Insufficient_Multimodal": (90, 90, 0),
    "Refute": (0, 90, 90),
}


def synthetic_factify_tree(
    root: str | os.PathLike,
    n_train: int = 20,
    n_test: int = 10,
    image_size: int = 64,
    seed: int = 0,
    learnable: bool = False,
) -> Path:
    """Write a mini raw Factify tree: extracted/{train,test}.csv (TSV with
    HEADERS) + images/{split}/{id}_{claim|evidence}.jpg. Returns root.

    About 15% of the images are left out, to exercise skip-and-count. With
    `learnable`, label and retrieval signal is planted (the demo's report,
    demo/render_html.py): category words, repeated so that they outweigh
    the per-id tokens, in claim AND evidence; a per-id entity token shared
    by claim and evidence (text retrieval signal); a per-id base image
    shared by the claim and evidence images (image retrieval signal); and
    a per-category tint (image classification signal)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root = Path(root)
    for split, n in (("train", n_train), ("test", n_test)):
        extracted = root / "data" / "raw" / "factify" / "extracted"
        img_dir = extracted / "images" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        for i in range(1, n + 1):
            cat = lb.CATEGORIES[int(rng.integers(0, len(lb.CATEGORIES)))]
            shape = (image_size, image_size, 3)
            # `base` is drawn only on learnable trees, so the draws of the
            # other trees (and which samples lack images) stay as they were
            base = rng.integers(0, 255, shape) if learnable else None
            for kind in ("claim", "evidence"):
                if rng.random() < 0.85:
                    if learnable:
                        tint = np.asarray(CAT_TINT[cat], np.float32)
                        noise = rng.standard_normal(shape) * 12.0
                        arr = np.clip(base * 0.5 + tint + noise,
                                      0, 255).astype(np.uint8)
                    else:
                        arr = rng.integers(0, 255, shape, dtype=np.uint8)
                    Image.fromarray(arr).save(img_dir / f"{i}_{kind}.jpg")
            if learnable:
                words = CAT_SIGNAL_WORDS[cat]
                claim_txt = (f"claim entity{split}{i} reports {words} "
                             f"news about topic {i % 5} rated {words} "
                             f"overall {words}")
                ev_txt = (f"evidence entity{split}{i} is {words} "
                          f"coverage discussing topic {i % 5} in detail "
                          f"rated {words} overall {words}")
            else:
                claim_txt = f"claim text number {i} about topic {i % 5}"
                ev_txt = (f"evidence document {i} discussing topic "
                          f"{i % 5} in detail")
            rows.append([
                str(i), claim_txt, f"http://example.com/{split}/{i}_claim.jpg",
                ev_txt, f"http://example.com/{split}/{i}_evidence.jpg",
                cat, "[]", "[]",
            ])
        with open(extracted / f"{split}.csv", "w") as f:
            f.write("\t".join(HEADERS) + "\n")
            for r in rows:
                f.write("\t".join(r) + "\n")
    return root
