"""The eval pipelines (pipelines/{eval_models,eval_text,eval_factify}.py) and
dataset_stats of the port against the JAX package, on the CPU.

One float16 store of 21 rows (batch 8: a padded tail), the same fusion
params in both packages (the JAX init carried over by bridge.py), fp32.
Tolerances:
  * predictions: equal wherever the JAX package's top-two logit margin
    exceeds 1e-4 (the two forwards agree within ~1e-6 in fp32; a margin
    below 1e-4 is a near tie either package may break the other way);
  * the results CSVs: the same rows and columns, every value equal but the
    timestamp (their metrics are computed from equal predictions);
  * unified_from_paths over all 81 path combinations and split_stats:
    exactly.
"""

import functools
import itertools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.data import schema as JS
from mmd_tpu.data.store import write_store
from mmd_tpu.data.synthetic import synthetic_factify_tree, \
    synthetic_preembed_batch
from mmd_tpu.models.fusion import fusion_forward as j_fusion_forward
from mmd_tpu.models.fusion import init_fusion_params as j_init
from mmd_tpu.pipelines import dataset_stats as JD
from mmd_tpu.pipelines import eval_factify as JEF
from mmd_tpu.pipelines import eval_models as JEM
from mmd_tpu.pipelines import eval_text as JET
from mmd_tpu.pipelines.preprocess import preprocess_csv
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data import schema as TS
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.pipelines import dataset_stats as TD
from mmd_tpu_torch.pipelines import eval_factify as TEF
from mmd_tpu_torch.pipelines import eval_models as TEM
from mmd_tpu_torch.pipelines import eval_text as TET

torch.set_num_threads(2)

MARGIN = 1e-4
B = 8
DIMS = dict(text_input_dim=16, image_input_dim=24, embed_dim=32,
            num_heads=4, hidden_dim=16, compute_dtype="float32")
MODES = {"multipath": {}, "factify": dict(factify=True, num_classes=5),
         "text_only": dict(text_only=True, num_classes=3)}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    rng = np.random.default_rng(3)
    b = synthetic_preembed_batch(rng, 21, text_seq=8, image_seq=4,
                                 text_dim=16, image_dim=24)
    b = {k: (v.astype(np.float16) if v.dtype.kind == "f" else v)
         for k, v in b.items()}
    b["id"] = np.arange(21, dtype=np.int64)
    d = tmp_path_factory.mktemp("es") / "s"
    write_store(d, b)
    return ArrayStore(d)


@functools.lru_cache(maxsize=None)
def _params(mode):
    """(JAX config, JAX params, port config, port params) of one mode; the
    port's tree is shared by the tests, which only read it."""
    jcfg = JModelConfig(**DIMS, **MODES[mode])
    tree = jax.jit(lambda k: j_init(k, jcfg))(jax.random.key(5))
    tcfg = ModelConfig(**DIMS, **MODES[mode])
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return jcfg, tree, tcfg, bridge.fusion_from_jax(tree, tcfg)


def _jax_logits(store, jcfg, tree) -> np.ndarray:
    """(N, P, C) logits of the JAX package's forward over the whole store."""
    cols = {k: jnp.asarray(store.col(k)) for k in
            ("claim_text_embeds", "claim_image_embeds", "doc_text_embeds",
             "doc_image_embeds")}
    out = jax.jit(lambda p, c: j_fusion_forward(
        p, jcfg, c["claim_text_embeds"], c["claim_image_embeds"],
        c["doc_text_embeds"], c["doc_image_embeds"],
        deterministic=True))(tree, cols)
    if jcfg.factify or jcfg.text_only:
        return np.asarray(out[0], np.float32)[:, None, :]
    (tt, ti), (it, ii) = out
    return np.asarray(jnp.stack([tt, ti, it, ii], 1), np.float32)


def _decided(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > MARGIN


def _csv(path) -> pd.DataFrame:
    return pd.read_csv(path).drop(columns="timestamp")


@pytest.mark.parametrize("mode", list(MODES))
def test_predictions_match_jax(store, mode):
    jcfg, tree, tcfg, params = _params(mode)
    jl = _jax_logits(store, jcfg, tree)
    tl, labels = TEM.store_logits(store, tcfg, params, B, "cpu")
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    preds, _ = TEM.predict_store(store, tcfg, params.state_dict(), B, "cpu")
    jpreds, jlabels = JEM.predict_store(store, jcfg, tree, B)
    np.testing.assert_array_equal(labels, store.col("labels"))
    decided = _decided(jl)
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(preds[decided], jpreds[decided])
    np.testing.assert_array_equal(preds.shape, jpreds.shape)


def test_evaluate_store_csv_matches_jax(store, tmp_path):
    jcfg, tree, tcfg, params = _params("multipath")
    m = TEM.evaluate_store(store, tcfg, params, B, str(tmp_path / "t.csv"),
                           device="cpu")
    jm = JEM.evaluate_store(store, jcfg, tree, B, str(tmp_path / "j.csv"))
    assert m == pytest.approx(jm, abs=0)
    t, j = _csv(tmp_path / "t.csv"), _csv(tmp_path / "j.csv")
    assert list(t["path"]) == ["text_text", "text_image", "image_text",
                               "image_image", "unified"]
    pd.testing.assert_frame_equal(t, j)


def test_evaluate_text_only_matches_jax(store, tmp_path):
    jcfg, tree, tcfg, params = _params("text_only")
    m = TET.evaluate_text_only(store, tcfg, params, B,
                               str(tmp_path / "t.csv"), "cpu")
    jm = JET.evaluate_text_only(store, jcfg, tree, B, str(tmp_path / "j.csv"))
    assert m == pytest.approx(jm, abs=0)
    pd.testing.assert_frame_equal(_csv(tmp_path / "t.csv"),
                                  _csv(tmp_path / "j.csv"))
    with pytest.raises(ValueError):
        TET.evaluate_text_only(store, ModelConfig(**DIMS), params, B,
                               device="cpu")


@pytest.mark.parametrize("matplotlib", [True, False])
def test_evaluate_factify_matches_jax(store, tmp_path, monkeypatch,
                                      matplotlib):
    """The metrics, and the confusion matrix as a PNG, or as the .txt
    beside its path when matplotlib cannot be imported."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    jcfg, tree, tcfg, params = _params("factify")
    m = TEF.evaluate_factify(store, tcfg, params, B,
                             str(tmp_path / "t.png"), "cpu")
    jm = JEF.evaluate_factify(store, jcfg, tree, B, str(tmp_path / "j.png"))
    assert m == pytest.approx(jm, abs=0)
    if matplotlib:
        assert (tmp_path / "t.png").read_bytes()[:4] == b"\x89PNG"
    else:
        assert (tmp_path / "t.png.txt").read_text() == (
            tmp_path / "j.png.txt").read_text()
        assert not (tmp_path / "t.png").exists()


def test_unified_from_paths_all_81_combinations():
    combos = np.array(list(itertools.product(range(3), repeat=4)))
    np.testing.assert_array_equal(TEM.unified_from_paths(combos),
                                  JEM.unified_from_paths(combos))
    rng = np.random.default_rng(0)
    preds, labels = (rng.integers(0, 3, (40, 4)) for _ in range(2))
    assert TEM.metrics_from_preds(preds, labels) == pytest.approx(
        JEM.metrics_from_preds(preds, labels), abs=0)


def test_split_stats_and_main_match_jax(tmp_path, monkeypatch, capsys):
    synthetic_factify_tree(tmp_path, n_train=9, n_test=4, seed=6)
    monkeypatch.setenv("MMD_TPU_ROOT", str(tmp_path))
    for split in ("train", "test"):
        preprocess_csv(split, tmp_path)
    enriched = tmp_path / "data" / "preprocessed" / "test_enriched.csv"
    df = pd.read_csv(tmp_path / "data" / "preprocessed" / "test.csv")
    df["claim_image_caption"] = ["a cap", None, "b", None]
    df.to_csv(enriched, index=False)
    for split in ("train", "test", "val"):
        assert TD.split_stats(split) == JD.split_stats(split), split
    assert "captions_present" in TD.split_stats("test")
    assert TD.split_stats("val") is None
    stats = TD.main(["--splits", "train", "test", "val"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == stats and len(stats) == 2
    assert "val: no preprocessed CSV found" in out


def test_schema_paths_and_rows_match_jax(tmp_path, monkeypatch):
    """data/schema.py's paths, get_preprocessed_data and
    load_images_for_row against the JAX package's: the same frame, and
    the same images decoded (None for a missing or unreadable file)."""
    synthetic_factify_tree(tmp_path, n_train=6, n_test=2, seed=8)
    monkeypatch.setenv("MMD_TPU_ROOT", str(tmp_path))
    preprocess_csv("train", tmp_path)
    for name in ("raw_dir", "preprocessed_dir", "images_dir"):
        assert getattr(TS, name)() == getattr(JS, name)(), name
    assert TS.ENRICHED_COLUMNS == JS.ENRICHED_COLUMNS
    df = TS.get_preprocessed_data("train")
    pd.testing.assert_frame_equal(df, JS.get_preprocessed_data("train"))
    with pytest.raises(FileNotFoundError):
        TS.get_preprocessed_data("val")
    (tmp_path / "bad.jpg").write_bytes(b"not a jpeg")
    rows = [dict(r) for _, r in df.iterrows()]
    rows[0]["claim_image"] = str(tmp_path / "bad.jpg")
    rows[1]["evidence_image"] = None
    for row in rows:
        row = {k: (str(tmp_path / v) if k.endswith("_image")
                   and isinstance(v, str) and not v.startswith("/") else v)
               for k, v in row.items()}
        got, want = TS.load_images_for_row(row), JS.load_images_for_row(row)
        for key in ("claim_image", "evidence_image"):
            assert (got[key] is None) == (want[key] is None), key
            if got[key] is not None:
                np.testing.assert_array_equal(np.asarray(got[key]),
                                              np.asarray(want[key]))
    assert TS.load_images_for_row(
        {**rows[0], "claim_image": str(tmp_path / "bad.jpg")}
    )["claim_image"] is None


@pytest.mark.parametrize("cli,mode,extra", [
    (TEM, "multipath", ["--results_csv"]),
    (TET, "text_only", ["--results_csv"]),
    (TEF, "factify", ["--confusion_png"])])
def test_mains_run_on_the_cpu_and_refuse_a_missing_card(store, tmp_path,
                                                         cli, mode,
                                                         extra):
    """Each eval CLI with a best_model.pt, on the CPU when asked: the
    metrics of its function over the same params. Without --device it
    runs on the card, and raises where there is none."""
    _, _, tcfg, params = _params(mode)
    ckpt = tmp_path / "best_model.pt"
    save_params(str(ckpt), params)
    argv = ["--store", str(store.dir), "--checkpoint", str(ckpt),
            "--batch_size", str(B), "--text_input_dim", "16",
            "--image_input_dim", "24", "--embed_dim", "32", "--num_heads",
            "4", "--hidden_dim", "16", extra[0], str(tmp_path / "out")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    # the CLI's model computes in the config's default dtype, bf16
    got = cli.main(argv + ["--device", "cpu"])
    cfg = ModelConfig(**{**DIMS, "compute_dtype": "bfloat16"},
                      **MODES[mode])
    if cli is TEM:
        want = TEM.evaluate_store(store, cfg, params, B, device="cpu")
    elif cli is TET:
        want = TET.evaluate_text_only(store, cfg, params, B, device="cpu")
    else:
        want = TEF.evaluate_factify(store, cfg, params, B, device="cpu")
    assert got == want
