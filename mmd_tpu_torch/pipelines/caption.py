"""Stage 2b: BLIP-style caption enrichment of the preprocessed CSVs
(counterpart of mmd_tpu/pipelines/caption.py).

Parity with `python -m src.preprocess.caption` (reference
src/preprocess/caption.py): caption both images of every row, append the
caption to the text (`claim_enriched = f"{claim}. {caption}"`, :34-47),
write `{split}_enriched.csv` with 4 new columns, RESUMABLE: restarts after
the last row whose `evidence_image_caption` is non-NA (:50-59) and flushes
every `save_every` rows (:84-117), at most once every 30 s.

Images go through the card in fixed batches (padded with empty slots):
host decode, device-side normalize, one ViT forward and one KV-cached
greedy decode a batch (models/captioner.generate), instead of one HF
generate() call per image.

Usage: python -m mmd_tpu_torch.pipelines.caption [--datasets train test]
           [--batch_size 32] [--assets assets/encoders] [--tiny]
           [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from pathlib import Path

import pandas as pd
import torch

from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.captioner import (
    CAPTIONER_TEST, CaptionerConfig, generate, init_captioner,
    load_captioner_assets,
)
from mmd_tpu_torch.ops.image_ops import (
    TRAIN_TRANSFORM, load_images_parallel, normalize_on_device,
)

BATCH_SIZE = 32
SAVE_EVERY = 20  # rows, parity with reference BATCH_SIZE=20 flush cadence


def image_transform(cfg: CaptionerConfig):
    """The training transform at the captioner's image size."""
    size = cfg.vit.image_size
    return (TRAIN_TRANSFORM if size == TRAIN_TRANSFORM.size
            else dataclasses.replace(TRAIN_TRANSFORM, size=size))


class CaptionEngine:
    """Batched captioner around generate()."""

    def __init__(self, tokenizer: WordPieceTokenizer,
                 cfg: CaptionerConfig | None = None, params=None,
                 seed: int = 21, batch_size: int = BATCH_SIZE,
                 device: str | torch.device = "cuda"):
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        if cfg is None:
            cfg = CaptionerConfig()
        self.cfg = dataclasses.replace(
            cfg, decoder=dataclasses.replace(
                cfg.decoder, vocab_size=tokenizer.vocab_size))
        if params is None:
            params = init_captioner(torch.Generator().manual_seed(seed),
                                    self.cfg)
        self.params = params.to(self.device)
        self.batch_size = batch_size
        self.transform = image_transform(self.cfg)
        # BLIP starts decoding from its [DEC] token (converted checkpoints
        # carry it in the exported vocab); otherwise [CLS] is the BOS
        self.bos_id = tokenizer.token_to_id.get("[DEC]", tokenizer.cls_id)

    @torch.no_grad()
    def generate_uint8(self, images_uint8) -> torch.Tensor:
        """(B, S, S, 3) uint8, a host array or a tensor (the fused
        pipeline's banks hand over device tensors) -> (B, t_max) token ids
        on the device."""
        x = normalize_on_device(
            torch.as_tensor(images_uint8).to(self.device), self.transform,
            L.dtype_of(self.cfg.vit.compute_dtype))
        return generate(self.params, self.cfg, x, bos_id=self.bos_id,
                        eos_id=self.tokenizer.sep_id,
                        pad_id=self.tokenizer.pad_id)

    def caption_paths(self, paths, io_workers: int = 16) -> list[str]:
        """Caption a list of image paths (None/missing -> ""). Any length;
        internally padded to the fixed batch."""
        out = [""] * len(paths)
        for lo in range(0, len(paths), self.batch_size):
            chunk = list(paths[lo:lo + self.batch_size])
            pad = chunk + [None] * (self.batch_size - len(chunk))
            imgs, ok = load_images_parallel(pad, self.transform, io_workers)
            tokens = self.generate_uint8(imgs).cpu().numpy()
            for j in range(len(chunk)):
                if ok[j]:
                    out[lo + j] = self.tokenizer.decode(tokens[j])
        return out


def get_last_processed_index(df: pd.DataFrame) -> int:
    """Last row index with a non-NA evidence_image_caption, -1 if none
    (reference caption.py:50-59 backwards-scan semantics)."""
    col = df.get("evidence_image_caption")
    if col is None:
        return -1
    notna = col.notna().to_numpy().nonzero()[0]
    return int(notna[-1]) if len(notna) else -1


def process_csv(dataset: str, engine: CaptionEngine,
                root: Path | None = None, save_every: int = SAVE_EVERY,
                batch_size: int | None = None) -> Path | None:
    root = Path(root) if root else get_project_root()
    in_csv = root / "data" / "preprocessed" / f"{dataset}.csv"
    out_csv = root / "data" / "preprocessed" / f"{dataset}_enriched.csv"
    if not in_csv.exists():
        print(f"CSV not found: {in_csv}")
        return None
    batch_size = batch_size or engine.batch_size

    if out_csv.exists():
        df = pd.read_csv(out_csv)
        start = get_last_processed_index(df) + 1
        print(f"[caption] resuming {dataset} at row {start}")
    else:
        df = pd.read_csv(in_csv)
        for col in ("claim_image_caption", "evidence_image_caption",
                    "claim_enriched", "evidence_enriched"):
            df[col] = pd.NA
        start = 0

    def abspath(p):
        if isinstance(p, str) and p:
            return p if os.path.isabs(p) else str(root / p)
        return None

    t0 = time.time()
    done = start
    last_flush = time.time()
    for lo in range(start, len(df), batch_size):
        rows = df.iloc[lo:lo + batch_size]
        # one captioner pass over claim + evidence images together
        n = len(rows)
        caps = engine.caption_paths(
            [abspath(p) for p in rows["claim_image"]]
            + [abspath(p) for p in rows["evidence_image"]])
        c_caps, e_caps = caps[:n], caps[n:]
        for off, (i, row) in enumerate(rows.iterrows()):
            cc, ec = c_caps[off], e_caps[off]
            df.at[i, "claim_image_caption"] = cc
            df.at[i, "evidence_image_caption"] = ec
            df.at[i, "claim_enriched"] = (
                f"{row['claim']}. {cc}" if cc else str(row["claim"]))
            df.at[i, "evidence_enriched"] = (
                f"{row['evidence']}. {ec}" if ec else str(row["evidence"]))
        done = lo + len(rows)
        # the reference rewrites the whole CSV every 20 rows (quadratic on
        # a large frame): keep its resume granularity, at most one flush
        # every 30 s
        if ((done - start) % save_every < batch_size
                and time.time() - last_flush > 30.0):
            df.to_csv(out_csv, index=False)
            last_flush = time.time()
    df.to_csv(out_csv, index=False)
    dt = time.time() - t0
    print(f"[caption] {dataset}: rows {start}..{done} captioned in {dt:.1f}s "
          f"({(done - start) / max(dt, 1e-9):.2f} rows/s) -> {out_csv}")
    return out_csv


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="+", default=["train", "test"])
    p.add_argument("--batch_size", type=int, default=BATCH_SIZE)
    p.add_argument("--assets", type=str, default="assets/encoders")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    root = Path(args.root) if args.root else get_project_root()
    assets = Path(args.assets)
    tok_path = assets / "tokenizer.json"
    if tok_path.exists():
        tok = WordPieceTokenizer.load(tok_path)
    else:
        df = pd.read_csv(root / "data" / "preprocessed"
                         / f"{args.datasets[0]}.csv")
        texts = (df["claim"].fillna("").astype(str).tolist()
                 + df["evidence"].fillna("").astype(str).tolist())
        tok = WordPieceTokenizer.train(texts, 30000)
        tok_path.parent.mkdir(parents=True, exist_ok=True)
        tok.save(tok_path)

    cfg = CAPTIONER_TEST if args.tiny else None
    # a trained (pipelines/train_captioner.py) or converted-BLIP
    # (convert_hf.py --blip) checkpoint when there is one; an orbax
    # captioner.ckpt alone raises, naming tools/orbax_to_torch.py
    params = None
    if (assets / "captioner.pt").exists() or (
            assets / "captioner.ckpt").exists():
        tok, cfg, params = load_captioner_assets(assets, device)
    engine = CaptionEngine(tok, cfg=cfg, params=params,
                           batch_size=args.batch_size, device=device)
    for ds in args.datasets:
        process_csv(ds, engine, root)


if __name__ == "__main__":
    main()
