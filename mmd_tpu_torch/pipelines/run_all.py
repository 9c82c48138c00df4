"""End-to-end pipeline runner (counterpart of mmd_tpu/pipelines/run_all.py):
preprocess -> caption -> embed -> retrieval corpora -> train -> eval ->
demo verification.

The offline, batched equivalent of the reference demo's five steps plus
training (BASELINE.json "end-to-end" config), with per-stage wall-clock
timings. `--synthetic N` fabricates a Factify-shaped tree first so the whole
thing runs anywhere (no network). Every stage runs on `--device` (the card
unless the caller asks for the CPU); on the card the fusion model's
attention takes the kernels where the routing rules send it.

`--fused` runs the device-resident flow of pipelines/fused.py instead:
each split is uploaded once into banks on the device, and captions, the
image corpus, training and eval read from them (`_run_fused`).

Under torch.distributed.run the fusion model trains data-parallel over the
ranks of the launch, as the JAX package's default path trains over every
local device (`Trainer(cfg, make_mesh())`): each rank joins the world
(parallel/launch.init_from_env: cuda:{LOCAL_RANK}, the --dist_backend
asked for, nccl on CUDA by default, which runs one rank a card), rank 0
alone runs the stages that write the tree while the others wait, every
rank trains its rows of each batch from the train store rank 0 wrote
(training/trainer.py over a data-parallel mesh), and rank 0 alone
evaluates, verifies the demo claim and writes the results and the
timings. The batch must divide over the ranks. The ranks share one host
and read the tree at --root. `--fused` runs on one device, as the JAX
package's bank lives on one chip: a launch of more ranks raises before
any stage.

Usage:
  python -m mmd_tpu_torch.pipelines.run_all --synthetic 64 --tiny --epochs 2
      [--device cpu]
  python -m torch.distributed.run --standalone --nproc_per_node N \\
      -m mmd_tpu_torch.pipelines.run_all --synthetic 64 [--dist_backend gloo]
  python -m mmd_tpu_torch.pipelines.run_all --synthetic 256 --image_size 256
      --reference_encoders --fused --train_batch 64 --steps_per_call 8
  python -m mmd_tpu_torch.pipelines.run_all --epochs 5   # real data under ./data
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from pathlib import Path

import pandas as pd
import torch


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
                   help="device-resident fused flow (pipelines/fused.py): "
                        "images cross to the device once, into banks that "
                        "captioning, the image corpus, training and eval "
                        "read from")
    p.add_argument("--train_batch", type=int, default=64,
                   help="fused: train/eval batch")
    p.add_argument("--steps_per_call", type=int, default=8,
                   help="fused: train steps per window of bank rows")
    p.add_argument("--chunk", type=int, default=256,
                   help="fused: ingest chunk rows (the upload granularity)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend under torch.distributed.run "
                        "(nccl on CUDA by default, gloo on the CPU; nccl "
                        "runs one rank a card)")
    return p.parse_args(argv)


# Under a launch the other ranks wait while rank 0 captions and embeds every
# row of both splits, which takes hours on a real split: the world's
# collectives time out after this long.
STAGES_TIMEOUT_S = 6 * 3600.0


def main(argv=None) -> dict:
    """Runs every stage; returns what a caller checks: the stage timer,
    the trained state and its whole params, the eval metrics, the demo's
    verification result and its pipeline, the two stores (with --fused the
    two banks), the encoders, the fusion config and the train batch. Under
    a launch the ranks but rank 0 return the training's entries alone
    (the others None)."""
    import torch.distributed as dist

    args = parse_args(argv)
    own_group = not dist.is_initialized()
    try:
        return _main(args)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _main(args) -> dict:
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.core.profiling import Stages
    from mmd_tpu_torch.data.schema import preprocessed_dir
    from mmd_tpu_torch.data.store import ArrayStore
    from mmd_tpu_torch.inference.predictor import resolve_device
    from mmd_tpu_torch.parallel.launch import launch_mesh, on_rank0
    from mmd_tpu_torch.pipelines.embed import store_path_for_csv
    from mmd_tpu_torch.training.loop import run_training
    from mmd_tpu_torch.training.trainer import Trainer

    mesh = launch_mesh(args.dist_backend, args.device,
                       timeout_s=STAGES_TIMEOUT_S)
    if args.fused and mesh is not None and mesh.size > 1:
        raise ValueError(
            f"--fused runs on one device: pipelines/fused.py banks each "
            f"split on one card, as the JAX package's fused flow banks it "
            f"on one chip; this launch has {mesh.size} ranks (run --fused "
            f"without torch.distributed.run)")
    device = resolve_device(args.device) if mesh is None else mesh.device
    stages = Stages()
    root = _tree_root(args)
    made = on_rank0(lambda: _write_tree(args, stages, root, device))
    if args.fused:
        return _run_fused(args, stages, device=device, **made)

    # 5. train the fusion classifier: every rank its rows of each batch
    train_store = ArrayStore(store_path_for_csv(
        str(preprocessed_dir() / "train.csv")))
    dims = {c: train_store.column_specs[c]["shape"][-1]
            for c in ("claim_text_embeds", "claim_image_embeds")}
    model = ModelConfig(
        text_input_dim=dims["claim_text_embeds"],
        image_input_dim=dims["claim_image_embeds"],
        embed_dim=args.embed_dim if not args.tiny else 32,
        num_heads=8 if not args.tiny else 4,
        hidden_dim=64 if not args.tiny else 16,
        fused_attn=device.type == "cuda")
    bs = min(args.batch_size, max(len(train_store) // 2, 1))
    cfg = TrainConfig(model=model, batch_size=bs, epochs=args.epochs,
                      lr=1e-3, output_dir=str(root / "results"),
                      save_every=0, log_every=5)
    trainer = Trainer(cfg, device=device, mesh=mesh)
    columns = [c for c in train_store.columns if c != "id"]
    with stages.stage("train"):
        state = run_training(
            trainer,
            lambda e: train_store.batches(bs, shuffle=True, seed=e,
                                          columns=columns))
    params = trainer.whole_params(state)      # a collective: every rank

    # 6.-7. evaluation and the demo on rank 0; the ranks meet at its end
    shown = on_rank0(lambda: _evaluate_and_verify(
        args, stages, root, made, model, params, bs, len(train_store),
        device)) or {}
    made = made or {}
    return {"stages": stages, "state": state, "params": params,
            "metrics": shown.get("metrics"), "result": shown.get("result"),
            "pipeline": shown.get("pipeline"), "train_store": train_store,
            "test_store": made.get("test_store"), "enc": made.get("enc"),
            "model": model, "batch_size": bs}


def _tree_root(args) -> Path:
    """The tree's root; MMD_TPU_ROOT points at it for the rest of the
    process (on every rank)."""
    from mmd_tpu_torch.data.schema import get_project_root
    if args.synthetic:
        os.environ["MMD_TPU_ROOT"] = str(
            args.root or Path(tempfile.gettempdir()) / "mmd_pipeline")
    elif args.root:
        os.environ["MMD_TPU_ROOT"] = str(args.root)
    return get_project_root()


def _write_tree(args, stages, root: Path, device) -> dict:
    """The stages that write the tree (rank 0's under a launch):
    synthesize, preprocess and the encoders' assets, then, but for
    --fused, the captions, the embedding stores and the retrieval
    corpora."""
    if args.synthetic:
        from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
        marker = (root / "data" / "raw" / "factify" / "extracted"
                  / "train.csv")
        if args.reuse_tree and marker.exists():
            print(f"[run_all] reusing existing tree at {root}")
        else:
            with stages.stage("synthesize"):
                synthetic_factify_tree(root, n_train=args.synthetic,
                                       n_test=max(args.synthetic // 4, 4),
                                       image_size=args.image_size or 64)
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
    if args.fused:
        return {"root": root, "train_csv": train_csv, "test_csv": test_csv,
                "enc": enc}

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
        embed_csv(str(train_csv), enc, enriched=False,
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
    return {"enc": enc, "engine": engine, "test_csv": test_csv,
            "test_store": test_store, "text_corpora": text_corpora,
            "image_corpus": image_corpus}


def _evaluate_and_verify(args, stages, root: Path, made: dict, model,
                         params, bs: int, n_train: int, device) -> dict:
    """Evaluation over the test store (appending to results/eval.csv), the
    demo's verification of one claim and the timings (rank 0's under a
    launch)."""
    from mmd_tpu_torch.pipelines.eval_models import evaluate_store
    with stages.stage("eval"):
        metrics = evaluate_store(made["test_store"], model, params,
                                 batch_size=bs,
                                 results_csv=str(root / "results"
                                                 / "eval.csv"),
                                 device=device)
    print("[run_all] eval:", {k: round(v, 3) for k, v in metrics.items()
                              if "unified" in k})

    # 7. demo verification of one claim
    result, pipe = _demo_verify(args, stages, root, made["enc"],
                                made["engine"], model, params,
                                made["text_corpora"], made["image_corpus"],
                                made["test_csv"], bs, device)
    _write_timings(args, stages, made["enc"], n_train,
                   len(made["test_store"]))
    return {"metrics": metrics, "result": result, "pipeline": pipe}


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


def _run_fused(args, stages, root, train_csv, test_csv, enc, device):
    """The device-resident flow (pipelines/fused.py):

      * ingest banks the frozen image encoder's output (the compute dtype,
        smaller than the uint8 pixels) chunk by chunk; the raw chunk feeds
        the caption generator and the ResNet retrieval features before it
        is dropped, so every image crosses to the device once;
      * the TEST split ingests on a thread, on a CUDA stream of its own,
        while the train split's captions are collected and the train loop
        runs; the thread is joined, its error re-raised and its stream
        fenced before its bank and captions are read."""
    import threading

    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.models.captioner import CAPTIONER_TEST
    from mmd_tpu_torch.pipelines import fused as F
    from mmd_tpu_torch.pipelines.build_retrieval import build_text_corpora
    from mmd_tpu_torch.pipelines.caption import CaptionEngine
    from mmd_tpu_torch.training.trainer import Trainer

    image_size = enc.vit_cfg.image_size
    cap_batch = 8 if args.tiny else 64
    chunk = max(args.chunk, cap_batch)
    chunk -= chunk % cap_batch            # caption blocks must tile chunks
    engine = CaptionEngine(enc.tokenizer,
                           cfg=CAPTIONER_TEST if args.tiny else None,
                           batch_size=cap_batch, device=device)
    train_capt = F.BankCaptioner(engine, batch=cap_batch,
                                 bank_image_size=image_size)
    test_capt = F.BankCaptioner(engine, batch=cap_batch,
                                bank_image_size=image_size)
    resnet_feats = F.BankResNetFeatures(tiny=args.tiny)

    model = ModelConfig(
        text_input_dim=enc.text_cfg.hidden_size,
        image_input_dim=enc.vit_cfg.hidden_size,
        embed_dim=args.embed_dim if not args.tiny else 32,
        num_heads=8 if not args.tiny else 4,
        hidden_dim=64 if not args.tiny else 16,
        fused_attn=device.type == "cuda")
    n_train_csv = len(pd.read_csv(train_csv))
    bs = min(args.train_batch, max(n_train_csv // 4, 1))
    k = max(1, min(args.steps_per_call, n_train_csv // max(bs, 1)))
    cfg = TrainConfig(model=model, batch_size=bs, epochs=args.epochs,
                      lr=1e-3, output_dir=str(root / "results"),
                      save_every=0, log_every=50)
    trainer = Trainer(cfg, device=device, encoders=enc)

    def train_hook(imgs, start, n):
        train_capt.on_chunk(imgs, start, n)
        resnet_feats.on_chunk(imgs, start, n)

    ingest = dict(image_size=image_size, chunk=chunk, embed_images=True,
                  vis_dtype=model.compute_dtype, root=root, device=device)
    with stages.stage("ingest"):
        bank = F.ingest_split(train_csv, enc, on_chunk=train_hook, **ingest)
    print(f"[run_all] fused ingest: train {bank.n} rows "
          f"({bank.skipped} skipped)")

    # the test split ingests on a thread while captions collect and the
    # train loop runs
    test_box: dict = {}
    test_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def _ingest_test():
        try:
            with contextlib.ExitStack() as ctx:
                if test_stream is not None:
                    ctx.enter_context(torch.cuda.stream(test_stream))
                with stages.stage("ingest_test_overlap"):
                    test_box["bank"] = F.ingest_split(
                        test_csv, enc, on_chunk=test_capt.on_chunk, **ingest)
        except BaseException as e:               # re-raised on join
            test_box["error"] = e

    test_thread = threading.Thread(target=_ingest_test, daemon=True,
                                   name="mmd-ingest-test")
    test_thread.start()
    try:
        pre = root / "data" / "preprocessed"
        with stages.stage("caption"):
            cc, dc = train_capt.collect(bank.n)
            F.write_enriched_csv(pd.read_csv(train_csv), bank.ids, cc, dc,
                                 pre / "train_enriched.csv")

        with stages.stage("retrieval_build"):
            text_corpora = build_text_corpora(
                ["train"], enc.tokenizer, root, tiny=args.tiny,
                batch_size=max(args.batch_size, 64), device=device)
            image_corpus = resnet_feats.write(bank, root)

        with stages.stage("train"):
            state = F.train_from_bank(trainer, bank, steps_per_call=k,
                                      log_every=cfg.log_every)
    finally:
        test_thread.join()
    if "error" in test_box:
        raise test_box["error"]
    test_bank = test_box["bank"]
    if test_stream is not None:
        # the main stream waits for the thread's work, and the allocator
        # learns that the main stream uses the thread's tensors
        torch.cuda.current_stream(device).wait_stream(test_stream)
        for t in [*test_bank.data.values(), *test_capt.pending_tensors()]:
            t.record_stream(torch.cuda.current_stream(device))
    print(f"[run_all] fused ingest: test {test_bank.n} rows "
          f"({test_bank.skipped} skipped)")

    with stages.stage("caption_test"):
        tcc, tdc = test_capt.collect(test_bank.n)
        F.write_enriched_csv(pd.read_csv(test_csv), test_bank.ids, tcc, tdc,
                             pre / "test_enriched.csv")
    with stages.stage("retrieval_build_test"):
        text_corpora += build_text_corpora(
            ["test"], enc.tokenizer, root, tiny=args.tiny,
            batch_size=max(args.batch_size, 64), device=device)

    with stages.stage("eval"):
        metrics = F.evaluate_from_bank(
            test_bank, enc, model, state.params, batch_size=bs,
            results_csv=str(root / "results" / "eval.csv"))
    print("[run_all] eval:", {k_: round(v, 3) for k_, v in metrics.items()
                              if "unified" in k_})

    result, pipe = _demo_verify(args, stages, root, enc, engine, model,
                                state.params, text_corpora, image_corpus,
                                test_csv, bs, device)
    _write_timings(args, stages, enc, bank.n, test_bank.n)
    return {"stages": stages, "state": state, "metrics": metrics,
            "result": result, "pipeline": pipe, "train_bank": bank,
            "test_bank": test_bank, "enc": enc, "model": model,
            "batch_size": bs, "steps_per_call": k, "chunk": chunk,
            "cap_batch": cap_batch, "engine": engine}


if __name__ == "__main__":
    main()
