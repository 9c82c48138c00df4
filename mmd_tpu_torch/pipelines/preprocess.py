"""Raw Factify TSV -> preprocessed CSV with local image paths (the port's
copy of mmd_tpu/pipelines/preprocess.py).

Parity with the reference's `python -m src.preprocess.preprocess`: read the
raw TSV with the HEADERS schema, rename the URL columns to `*_original`, and
write `claim_image` / `evidence_image` as root-relative local paths iff the
downloaded file exists, else None.

Usage: python -m mmd_tpu_torch.pipelines.preprocess [--root DIR] [--datasets train test]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import pandas as pd

from mmd_tpu_torch.data.schema import HEADERS, get_project_root


def preprocess_csv(dataset: str, root: Path | None = None) -> Path | None:
    root = Path(root) if root else get_project_root()
    raw_dir = root / "data" / "raw" / "factify"
    csv_path = raw_dir / "extracted" / f"{dataset}.csv"
    out_dir = root / "data" / "preprocessed"
    images_folder = raw_dir / "extracted" / "images" / dataset
    if not csv_path.exists():
        print(f"Dataset CSV not found: {csv_path}")
        return None
    out_dir.mkdir(parents=True, exist_ok=True)

    df = pd.read_csv(csv_path, names=HEADERS, header=None, sep="\t", skiprows=1)
    df = df.rename(columns={"claim_image": "claim_image_original",
                            "evidence_image": "evidence_image_original"})

    def local_path(file_id, kind):
        p = images_folder / f"{file_id}_{kind}.jpg"
        return str(p.relative_to(root)) if p.exists() else None

    df["claim_image"] = [local_path(i, "claim") for i in df["id"]]
    df["evidence_image"] = [local_path(i, "evidence") for i in df["id"]]

    out = out_dir / f"{dataset}.csv"
    df.to_csv(out, index=False)
    n_imgs = df["claim_image"].notna().sum()
    print(f"Processed {dataset}.csv -> {out} "
          f"({len(df)} rows, {n_imgs} claim images present)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--datasets", nargs="+", default=["train", "test"])
    args = p.parse_args(argv)
    for ds in args.datasets:
        preprocess_csv(ds, args.root)


if __name__ == "__main__":
    main()
