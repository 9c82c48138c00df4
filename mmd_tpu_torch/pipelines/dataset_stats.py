"""Dataset statistics report (counterpart of
mmd_tpu/pipelines/dataset_stats.py; the reference keeps these in
notebooks: src/experimental/dataset_stats.ipynb / dataset_search.ipynb).

Prints, per split: row count, per-category counts, rows with claim /
evidence images present, enriched-caption coverage. One JSON line at the
end for machines. Host only: nothing runs on a device.

Usage: python -m mmd_tpu_torch.pipelines.dataset_stats [--splits train test]
"""

from __future__ import annotations

import argparse
import json

import pandas as pd

from mmd_tpu_torch.data.labels import CATEGORIES
from mmd_tpu_torch.data.schema import preprocessed_dir


def split_stats(split: str) -> dict | None:
    base = preprocessed_dir()
    csv = base / f"{split}_enriched.csv"
    if not csv.exists():
        csv = base / f"{split}.csv"
    if not csv.exists():
        return None
    df = pd.read_csv(csv)
    stats = {
        "split": split,
        "rows": len(df),
        "categories": {c: int((df["category"] == c).sum()) for c in CATEGORIES},
        "claim_images_present": int(df["claim_image"].notna().sum()),
        "evidence_images_present": int(df["evidence_image"].notna().sum()),
    }
    if "claim_image_caption" in df:
        stats["captions_present"] = int(
            df["claim_image_caption"].notna().sum())
    return stats


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--splits", nargs="+", default=["train", "test"])
    args = p.parse_args(argv)
    all_stats = []
    for split in args.splits:
        s = split_stats(split)
        if s is None:
            print(f"{split}: no preprocessed CSV found")
            continue
        all_stats.append(s)
        print(f"== {split}: {s['rows']} rows ==")
        for c, n in s["categories"].items():
            print(f"  {c:26s} {n}")
        print(f"  claim images:    {s['claim_images_present']}")
        print(f"  evidence images: {s['evidence_images_present']}")
    print(json.dumps(all_stats))
    return all_stats


if __name__ == "__main__":
    main()
