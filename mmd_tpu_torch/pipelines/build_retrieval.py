"""Stage 4 build: retrieval corpora from the enriched CSVs (counterpart of
mmd_tpu/pipelines/build_retrieval.py).

Builds what the demo serves from (reference builds these ad hoc in
text2text_retrieval.py:129-157 __main__ and im2im_retrieval.py:145-167):
  * data/retrieval/text_{split}/  — bi-encoder embeddings of
    `evidence_enriched` with ids `f"{split}_{id}"`;
  * data/retrieval/image_corpus/  — ResNet features of every evidence image
    (ids are the flat evidence_corpus paths, built if missing).

The converted bi-encoder and its tokenizer (bi_encoder.pt,
bi_tokenizer.json) and resnet50.pt are used when the assets directory has
them; an orbax .ckpt with no .pt beside it raises and names
tools/orbax_to_torch.py.

Usage: python -m mmd_tpu_torch.pipelines.build_retrieval
           [--splits train test] [--assets assets/encoders] [--tiny]
           [--skip_images] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.inference.predictor import resolve_device


def build_text_corpora(splits, tokenizer, root: Path, tiny: bool = False,
                       batch_size: int = 64,
                       assets: str | Path = "assets/encoders",
                       device: str | torch.device = "cuda"):
    import pandas as pd

    from mmd_tpu_torch.models import text_encoder as te
    from mmd_tpu_torch.retrieval.text import (
        TextCorpus, resolve_retrieval_encoders,
    )
    cfg = te.TINY_TEST if tiny else None
    params = None
    if not tiny:
        conv = resolve_retrieval_encoders(assets)
        if conv["bi_params"] is not None:
            cfg, params = conv["bi_cfg"], conv["bi_params"]
            tokenizer = conv["bi_tokenizer"] or tokenizer
            print(f"[build_retrieval] using converted bi-encoder from {assets}")
    out = []
    for split in splits:
        csv = root / "data" / "preprocessed" / f"{split}_enriched.csv"
        if not csv.exists():
            csv = root / "data" / "preprocessed" / f"{split}.csv"
        if not csv.exists():
            print(f"[build_retrieval] no CSV for {split}, skipping")
            continue
        df = pd.read_csv(csv)
        col = "evidence_enriched" if "evidence_enriched" in df else "evidence"
        corpus = TextCorpus(root / "data" / "retrieval" / f"text_{split}",
                            tokenizer, cfg=cfg, params=params, device=device)
        corpus.encode_corpus(
            df[col].fillna("").astype(str).tolist(),
            [f"{split}_{i}" for i in df["id"]], batch_size=batch_size)
        out.append(corpus)
    return out


def build_image_corpus(splits, root: Path, tiny: bool = False,
                       batch_size: int = 32,
                       assets: str | Path = "assets/encoders",
                       device: str | torch.device = "cuda"):
    from mmd_tpu_torch.core.checkpoint import load_params
    from mmd_tpu_torch.models.frozen import asset_path
    from mmd_tpu_torch.models.resnet import (
        RESNET_TEST, ResNetConfig, init_resnet,
    )
    from mmd_tpu_torch.retrieval.corpus_utils import build_evidence_corpus_dir
    from mmd_tpu_torch.retrieval.image import ImageCorpus
    cfg = RESNET_TEST if tiny else ResNetConfig()
    # converted torchvision weights (convert_hf --resnet) if present
    resnet_params = None
    pt = None if tiny else asset_path(Path(assets), "resnet50")
    if pt is not None:
        resnet_params = load_params(
            str(pt), init_resnet(torch.Generator().manual_seed(0), cfg))
        print(f"[im2im] using converted weights from {pt}")
    corpus_dir = build_evidence_corpus_dir(splits, root=root)
    paths = sorted(str(p) for p in corpus_dir.glob("*.jpg"))
    corpus = ImageCorpus(root / "data" / "retrieval" / "image_corpus",
                         resnet_params=resnet_params, cfg=cfg, device=device)
    corpus.create_feature_corpus(paths, batch_size=batch_size)
    return corpus


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--splits", nargs="+", default=["train", "test"])
    p.add_argument("--assets", type=str, default="assets/encoders")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--skip_images", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    root = get_project_root()
    tok = WordPieceTokenizer.load(Path(args.assets) / "tokenizer.json")
    build_text_corpora(args.splits, tok, root, args.tiny, args.batch_size,
                       assets=args.assets, device=device)
    if not args.skip_images:
        build_image_corpus(args.splits, root, args.tiny, assets=args.assets,
                           device=device)


if __name__ == "__main__":
    main()
