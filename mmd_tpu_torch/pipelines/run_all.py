"""End-to-end pipeline runner (counterpart of mmd_tpu/pipelines/run_all.py):
preprocess -> caption -> embed -> retrieval corpora -> train -> eval ->
demo verification.

The offline, batched equivalent of the reference demo's five steps plus
training (BASELINE.json "end-to-end" config), with per-stage wall-clock
timings. `--synthetic N` fabricates a Factify-shaped tree first so the whole
thing runs anywhere (no network). Every stage runs on `--device` (the card
unless the caller asks for the CPU); on the card the fusion model's
attention takes the kernels where the routing rules send it.

The JAX package's `--fused` flow (pipelines/fused.py: images cross to the
device once into resident banks) is not ported yet and raises.

Usage:
  python -m mmd_tpu_torch.pipelines.run_all --synthetic 64 --tiny --epochs 2
      [--device cpu]
  python -m mmd_tpu_torch.pipelines.run_all --epochs 5   # real data under ./data
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import pandas as pd


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate a synthetic Factify tree with N train rows")
    p.add_argument("--tiny", action="store_true",
                   help="tiny encoder/captioner configs (smoke)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--image_size", type=int, default=None,
                   help="synthetic image size (default 64; use 256 to price "
                        "production host decode)")
    p.add_argument("--reference_encoders", action="store_true",
                   help="seeded DeBERTa-v3-xsmall + Swinv2-base (the "
                        "reference's actual encoder families) instead of "
                        "the BERT-class/ViT substitutes")
    p.add_argument("--reuse_tree", action="store_true",
                   help="skip synthesis when the tree already exists at "
                        "--root (pre-generated)")
    p.add_argument("--timings_json", type=str, default=None,
                   help="dump per-stage wall-clock timings (plus row "
                        "counts) as JSON")
    p.add_argument("--fused", action="store_true",
                   help="the JAX package's device-centric fused flow "
                        "(pipelines/fused.py); not ported yet")
    p.add_argument("--train_batch", type=int, default=64,
                   help="fused: train/eval batch")
    p.add_argument("--steps_per_call", type=int, default=8,
                   help="fused: train steps per dispatch")
    p.add_argument("--chunk", type=int, default=256,
                   help="fused: ingest chunk rows")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs every stage; returns what a caller checks: the stage timer,
    the trained state, the eval metrics, the demo's verification result
    and its pipeline, the two stores, the encoders, the fusion config and
    the train batch."""
    from mmd_tpu_torch.core.profiling import Stages
    from mmd_tpu_torch.inference.predictor import resolve_device

    args = parse_args(argv)
    if args.fused:
        raise NotImplementedError(
            "run_all --fused (the fused flow of pipelines/fused.py) is not "
            "ported yet (ROADMAP A14, pipelines/fused.py)")
    device = resolve_device(args.device)
    stages = Stages()

    if args.synthetic:
        from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
        root = Path(args.root or Path(tempfile.gettempdir())
                    / "mmd_pipeline")
        marker = (root / "data" / "raw" / "factify" / "extracted"
                  / "train.csv")
        if args.reuse_tree and marker.exists():
            print(f"[run_all] reusing existing tree at {root}")
        else:
            with stages.stage("synthesize"):
                synthetic_factify_tree(root, n_train=args.synthetic,
                                       n_test=max(args.synthetic // 4, 4),
                                       image_size=args.image_size or 64)
        os.environ["MMD_TPU_ROOT"] = str(root)
    elif args.root:
        os.environ["MMD_TPU_ROOT"] = str(args.root)

    from mmd_tpu_torch.data.schema import get_project_root
    root = get_project_root()
    assets = root / "assets" / "encoders"
    stages.wall_t0 = time.perf_counter()   # excludes synthesize

    # 1. preprocess
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
    with stages.stage("preprocess"):
        train_csv = preprocess_csv("train", root)
        test_csv = preprocess_csv("test", root)
    if not (train_csv and test_csv):
        raise FileNotFoundError(f"no raw Factify CSVs under {root}")

    # frozen encoder assets (the tokenizer trains on first use)
    from mmd_tpu_torch.models.frozen import load_or_init_frozen
    with stages.stage("assets"):
        df = pd.read_csv(train_csv)
        texts = (df["claim"].fillna("").astype(str).tolist()
                 + df["evidence"].fillna("").astype(str).tolist())
        enc = load_or_init_frozen(assets, vocab_texts=texts, tiny=args.tiny,
                                  reference_families=args.reference_encoders)

    # 2. caption enrichment
    from mmd_tpu_torch.models.captioner import CAPTIONER_TEST
    from mmd_tpu_torch.pipelines.caption import CaptionEngine, process_csv
    with stages.stage("caption"):
        engine = CaptionEngine(enc.tokenizer,
                               cfg=CAPTIONER_TEST if args.tiny else None,
                               batch_size=min(args.batch_size, 32),
                               device=device)
        process_csv("train", engine, root)
        process_csv("test", engine, root)

    # 3. embed
    from mmd_tpu_torch.pipelines.embed import embed_csv
    with stages.stage("embed"):
        train_store = embed_csv(str(train_csv), enc, enriched=False,
                                batch_size=args.batch_size, device=device)
        test_store = embed_csv(str(test_csv), enc, enriched=False,
                               batch_size=args.batch_size, device=device)

    # 4. retrieval corpora
    from mmd_tpu_torch.pipelines.build_retrieval import (
        build_image_corpus, build_text_corpora,
    )
    with stages.stage("retrieval_build"):
        text_corpora = build_text_corpora(["train", "test"], enc.tokenizer,
                                          root, tiny=args.tiny,
                                          batch_size=args.batch_size,
                                          device=device)
        image_corpus = build_image_corpus(["train"], root, tiny=args.tiny,
                                          batch_size=args.batch_size,
                                          device=device)

    # 5. train the fusion classifier
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.training.loop import run_training
    from mmd_tpu_torch.training.trainer import Trainer
    model = ModelConfig(
        text_input_dim=enc.text_cfg.hidden_size,
        image_input_dim=enc.vit_cfg.hidden_size,
        embed_dim=args.embed_dim if not args.tiny else 32,
        num_heads=8 if not args.tiny else 4,
        hidden_dim=64 if not args.tiny else 16,
        fused_attn=device.type == "cuda")
    bs = min(args.batch_size, max(len(train_store) // 2, 1))
    cfg = TrainConfig(model=model, batch_size=bs, epochs=args.epochs,
                      lr=1e-3, output_dir=str(root / "results"),
                      save_every=0, log_every=5)
    trainer = Trainer(cfg, device=device)
    columns = [c for c in train_store.columns if c != "id"]
    with stages.stage("train"):
        state = run_training(
            trainer,
            lambda e: train_store.batches(bs, shuffle=True, seed=e,
                                          columns=columns))

    # 6. evaluation
    from mmd_tpu_torch.pipelines.eval_models import evaluate_store
    with stages.stage("eval"):
        metrics = evaluate_store(test_store, model, state.params,
                                 batch_size=bs,
                                 results_csv=str(root / "results"
                                                 / "eval.csv"),
                                 device=device)
    print("[run_all] eval:", {k: round(v, 3) for k, v in metrics.items()
                              if "unified" in k})

    # 7. demo verification of one claim
    result, pipe = _demo_verify(args, stages, root, enc, engine, model,
                                state.params, text_corpora, image_corpus,
                                test_csv, bs, device)
    _write_timings(args, stages, enc, len(train_store), len(test_store))
    return {"stages": stages, "state": state, "metrics": metrics,
            "result": result, "pipeline": pipe, "train_store": train_store,
            "test_store": test_store, "enc": enc, "model": model,
            "batch_size": bs}


def _demo_verify(args, stages, root, enc, engine, model, fusion_params,
                 text_corpora, image_corpus, test_csv, bs, device):
    from mmd_tpu_torch.demo.pipeline import (
        ClaimVerificationPipeline, EvidenceIndex,
    )
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.retrieval.text import SemanticSearch
    with stages.stage("demo_verify"):
        index = EvidenceIndex(
            {"train": root / "data" / "preprocessed" / "train_enriched.csv",
             "test": root / "data" / "preprocessed" / "test_enriched.csv"},
            root=root)
        search = SemanticSearch(text_corpora[0], text_corpora,
                                evidence_lookup=index.text_lookup())
        predictor = MisinformationPredictor(
            model, fusion_params=fusion_params.state_dict(), encoders=enc,
            batch_size=min(bs, 16), device=device)
        pipe = ClaimVerificationPipeline(
            predictor, text_search=search, image_corpus=image_corpus,
            caption_engine=engine, evidence_index=index)
        df_test = pd.read_csv(test_csv)
        row = df_test.iloc[0]
        img = row["claim_image"]
        img_path = str(root / img) if isinstance(img, str) else None
        result = pipe.verify(str(row["claim"]), img_path, top_k=args.top_k)
    print(f"[run_all] demo verdict for test row 0: "
          f"{result.final_classification} "
          f"({len(result.evidences)} evidences, caption={result.caption!r})")
    return result, pipe


def _write_timings(args, stages, enc, n_train, n_test):
    print(stages.report())
    if not args.timings_json:
        return
    doc = {
        "date": time.strftime("%Y-%m-%d"),
        "args": dict(vars(args)),
        "n_train_rows": int(n_train),
        "n_test_rows": int(n_test),
        "text_encoder": type(enc.text_cfg).__name__,
        "image_encoder": type(enc.vit_cfg).__name__,
        "stages_sec": {k: round(v, 2) for k, v in stages.summary().items()},
        # the wall clock excluding synthesize, beside the stages' sum
        "wall_sec_excl_synthesize": round(
            time.perf_counter() - stages.wall_t0, 2),
    }
    Path(args.timings_json).write_text(json.dumps(doc, indent=1))
    print(f"[run_all] timings -> {args.timings_json}")


if __name__ == "__main__":
    main()
