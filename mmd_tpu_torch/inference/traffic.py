"""Synthetic serving traffic made from a seed: claim/evidence texts and
image files, for driving the predictor at full width without a dataset."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def corpus(rng: np.random.Generator, n: int) -> list[str]:
    """n synthetic texts, from a few words to beyond the 512-token window."""
    syl = ["ka", "ro", "mi", "ten", "sul", "va", "dor", "pli", "est", "un",
           "qua", "bre", "zo", "lin", "ghe", "fa"]
    words = sorted({"".join(rng.choice(syl, rng.integers(1, 4)))
                    for _ in range(3000)})
    return [" ".join(rng.choice(words, int(m)))
            for m in np.geomspace(2, 700, n)]


def write_images(d: Path, rng: np.random.Generator, n: int) -> list[str]:
    """n random-pixel PNG files of 200-400 px a side under d."""
    from PIL import Image
    paths = []
    for i in range(n):
        arr = rng.integers(0, 256, (rng.integers(200, 400),
                                    rng.integers(200, 400), 3), np.uint8)
        paths.append(str(d / f"img{i}.png"))
        Image.fromarray(arr).save(paths[-1])
    return paths
