"""python -m mmd_tpu_torch.pipelines.run_all on the CPU at tiny widths: every
stage of the JAX package's run_all runs and writes its files, the stores
hold exactly the rows with both images and their cursor is the CSV's
length, the timings JSON has the JAX run_all's keys and stages; `--fused`
runs every stage of the JAX package's fused flow and writes eval.csv, both
enriched CSVs, the image corpus and final_model.pt; and without `--device
cpu` run_all, fused or not, refuses a missing card before it writes
anything. The stages themselves are held against the JAX package in
tests/test_torch_{embed,eval_pipelines,demo,fused}.py and the earlier
slices' files."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from mmd_tpu.core import profiling as JP
from mmd_tpu_torch.core import profiling as TP
from mmd_tpu_torch.pipelines import run_all as RA

torch.set_num_threads(2)

STAGES = {"synthesize", "preprocess", "assets", "caption", "embed",
          "retrieval_build", "train", "eval", "demo_verify"}
FUSED_STAGES = {"synthesize", "preprocess", "assets", "ingest",
                "ingest_test_overlap", "caption", "retrieval_build", "train",
                "caption_test", "retrieval_build_test", "eval", "demo_verify"}
TIMING_KEYS = {"date", "args", "n_train_rows", "n_test_rows", "text_encoder",
               "image_encoder", "stages_sec", "wall_sec_excl_synthesize"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One tiny run; run_all points MMD_TPU_ROOT at its tree, as the JAX
    one does, and the fixture restores it."""
    root = tmp_path_factory.mktemp("run_all")
    old = os.environ.get("MMD_TPU_ROOT")
    out = RA.main(["--synthetic", "16", "--tiny", "--epochs", "2",
                   "--batch_size", "8", "--device", "cpu", "--root",
                   str(root), "--timings_json", str(root / "timings.json")])
    yield root, out
    if old is None:
        os.environ.pop("MMD_TPU_ROOT", None)
    else:
        os.environ["MMD_TPU_ROOT"] = old


def test_every_stage_and_file(run):
    root, out = run
    doc = json.loads((root / "timings.json").read_text())
    assert set(doc) == TIMING_KEYS
    assert set(doc["stages_sec"]) == STAGES
    assert doc["text_encoder"] == "TransformerConfig"
    assert doc["image_encoder"] == "ViTConfig"
    assert doc["args"]["device"] == "cpu"
    pre = root / "data" / "preprocessed"
    for f in ("train.csv", "test.csv", "train_enriched.csv",
              "test_enriched.csv"):
        assert (pre / f).exists(), f
    for d in ("text_train", "text_test", "image_corpus"):
        assert (root / "data" / "retrieval" / d / "meta.json").exists(), d
    assert (root / "assets" / "encoders" / "tokenizer.json").exists()
    steps = out["state"].step
    ckpt = torch.load(root / "results" / "checkpoints" / f"step_{steps}.pt",
                      weights_only=True)
    assert all(torch.isfinite(v).all() for v in ckpt["params"].values())
    assert (root / "results" / "metrics.jsonl").exists()
    assert steps == 2 * (len(out["train_store"]) // out["batch_size"])


@pytest.mark.parametrize("split", ["train", "test"])
def test_stores_hold_the_rows_with_both_images(run, split):
    root, out = run
    df = pd.read_csv(root / "data" / "preprocessed" / f"{split}.csv")
    both = (df["claim_image"].notna() & df["evidence_image"].notna()
            ).to_numpy()
    store = out[f"{split}_store"]
    assert 0 < len(store) == both.sum()
    np.testing.assert_array_equal(store.col("id"), df["id"].to_numpy()[both])
    meta = json.loads((store.dir / "meta.json").read_text())
    assert meta["extra"] == {"csv_cursor": len(df)}


def test_eval_csv_and_the_demo_verdict(run):
    root, out = run
    ev = pd.read_csv(root / "results" / "eval.csv")
    assert list(ev["path"]) == ["text_text", "text_image", "image_text",
                                "image_image", "unified"]
    metrics = ev.drop(columns=["timestamp", "path"]).to_numpy(float)
    assert np.isfinite(metrics).all()
    assert set(out["metrics"]) >= {"unified/accuracy", "text_text/micro_f1"}
    result = out["result"]
    assert result.final_classification in (
        "support", "not_enough_information", "refute")
    sources = [e.source for e in result.evidences]
    assert sources.count("text") == 3
    assert sources.count("image") in (0, 3)
    assert out["model"].fused_attn is False      # the CPU: explicit path


def test_fused_runs_every_stage_and_writes_its_files(tmp_path):
    """--fused on the CPU: the JAX package's _run_fused stages, timed; the
    banks hold the rows with both images; the enriched CSVs caption every
    banked row; eval.csv, the image corpus over the train bank's evidence
    paths, the two text corpora and final_model.pt."""
    old = os.environ.get("MMD_TPU_ROOT")
    try:
        out = RA.main(["--fused", "--synthetic", "16", "--tiny", "--epochs",
                       "2", "--device", "cpu", "--root", str(tmp_path),
                       "--timings_json", str(tmp_path / "timings.json")])
    finally:
        if old is None:
            os.environ.pop("MMD_TPU_ROOT", None)
        else:
            os.environ["MMD_TPU_ROOT"] = old
    doc = json.loads((tmp_path / "timings.json").read_text())
    assert set(doc) == TIMING_KEYS
    assert set(doc["stages_sec"]) == FUSED_STAGES
    pre = tmp_path / "data" / "preprocessed"
    for split in ("train", "test"):
        df = pd.read_csv(pre / f"{split}.csv")
        bank = out[f"{split}_bank"]
        both = (df["claim_image"].notna() & df["evidence_image"].notna()
                ).to_numpy()
        assert 0 < bank.n == both.sum() == doc[f"n_{split}_rows"]
        assert bank.n + bank.skipped == len(df)
        np.testing.assert_array_equal(bank.ids, df["id"].to_numpy()[both])
        assert set(bank.data) >= {"claim_vis", "doc_vis"}
        assert "claim_image" not in bank.data
        enriched = pd.read_csv(pre / f"{split}_enriched.csv")
        banked = enriched["id"].isin(set(map(int, bank.ids)))
        assert enriched.loc[banked, ["claim_enriched", "evidence_enriched"]
                            ].notna().all().all()
    ev = pd.read_csv(tmp_path / "results" / "eval.csv")
    assert list(ev["path"]) == ["text_text", "text_image", "image_text",
                                "image_image", "unified"]
    assert np.isfinite(ev.drop(columns=["timestamp", "path"]).to_numpy(
        float)).all()
    corpus = tmp_path / "data" / "retrieval" / "image_corpus"
    ids = json.loads((corpus / "ids.json").read_text())
    assert ids == [str(p) for p in out["train_bank"].doc_paths]
    for d in ("text_train", "text_test"):
        assert (tmp_path / "data" / "retrieval" / d / "meta.json").exists()
    final = torch.load(tmp_path / "results" / "final_model.pt",
                       weights_only=True)
    for name, p in out["state"].params.state_dict().items():
        assert torch.equal(final[name], p), name
    assert out["result"].final_classification in (
        "support", "not_enough_information", "refute")
    assert out["model"].fused_attn is False


def test_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RA.main(["--synthetic", "8", "--tiny", "--root", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_fused_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RA.main(["--fused", "--synthetic", "8", "--tiny", "--root",
                 str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_stages_report_as_jax(capsys):
    """core/profiling.py's Stages: the same totals, counts, summary and
    report layout as the JAX package's for the same stage times; the log
    line; the module-level timer."""
    t, j = TP.Stages(), JP.Stages()
    for s in (t, j):
        for name in ("b", "a", "a"):
            with s.stage(name, log=False):
                pass
        s.totals.update({"a": 0.5, "b": 1.25})
    assert t.summary() == j.summary() and t.counts == j.counts
    assert t.report() == j.report()
    with t.stage("logged"):
        pass
    assert capsys.readouterr().out.startswith("[stage] logged: ")
    with TP.stage("module_level", log=False):
        pass
    assert "module_level" in TP.global_report()


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with TP.trace(str(tmp_path / "tr")):
        with TP.annotate("embed_batch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "embed_batch" in names
