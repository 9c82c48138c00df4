"""The caption pipeline, the captioner's assets and the prompting
baselines in the port (pipelines/caption.py, models/captioner.py's
load_captioner_assets, the captioner asset of tools/orbax_to_torch.py,
baselines/{prompting,eval_prompting}.py) against the JAX package, on the
CPU; tests/test_torch_train_captioner.py holds pipelines/train_captioner.py.

The same params go to both packages (through bridge.captioner_from_jax,
or as the JAX package's captioner.ckpt beside the port's captioner.pt),
the same CSVs, JPEG files and tokenizer. Tolerances:
  * caption_csv: the same four columns, captions and resume row, exactly
    (CAPTIONER_TEST, fp32: the decoders agree within 1e-5, far below
    these tiny models' top-2 gaps, tests/test_torch_captioner.py);
  * the prompting baselines: the same generated text, labels, votes and
    reranked orders; P(yes) within 1e-5.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mmd_tpu.baselines import eval_prompting as JE
from mmd_tpu.baselines import prompting as JP
from mmd_tpu.core.checkpoint import save_params as jsave_params
from mmd_tpu.data.synthetic import synthetic_factify_tree
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import captioner as JC
from mmd_tpu.pipelines import caption as JCAP
from mmd_tpu.pipelines.preprocess import preprocess_csv
from mmd_tpu_torch import bridge
from mmd_tpu_torch.baselines import eval_prompting as TE
from mmd_tpu_torch.baselines import prompting as TP
from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import captioner as TC
from mmd_tpu_torch.pipelines import caption as TCAP

torch.set_num_threads(2)

TOL = 1e-5
COLUMNS = ["claim_image_caption", "evidence_image_caption",
           "claim_enriched", "evidence_enriched"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(vocab: int, base=JC.CAPTIONER_TEST):
    return dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, vocab_size=vocab))


def _port_cfg(jcfg):
    return TC.config_from_dict(dataclasses.asdict(jcfg))


def _jax_init(jcfg, seed):
    return jax.jit(lambda k: JC.init_captioner(k, jcfg))(jax.random.key(seed))


def _init(jcfg, seed):
    """A seeded numpy param tree in the JAX package's layout, drawn by the
    port's init (no JAX compile)."""
    return bridge.to_jax_tree(TC.init_captioner(
        torch.Generator().manual_seed(seed), _port_cfg(jcfg)))


def _assets(path: Path, tok: JTokenizer, jcfg, tree) -> Path:
    """An assets dir with the tokenizer, the config, the JAX package's
    captioner.ckpt and the port's captioner.pt of the same params."""
    path.mkdir(parents=True, exist_ok=True)
    tok.save(path / "tokenizer.json")
    (path / "captioner_config.json").write_text(
        json.dumps(dataclasses.asdict(jcfg)))
    jsave_params(str(path / "captioner.ckpt"), tree)
    save_params(str(path / "captioner.pt"),
                bridge.captioner_from_jax(_np(tree), _port_cfg(jcfg)))
    return path


# -- the caption pipeline -------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("factify")
    synthetic_factify_tree(root, n_train=6, n_test=2, seed=5)
    preprocess_csv("train", root)
    # one image path that does not exist
    csv = root / "data" / "preprocessed" / "train.csv"
    df = pd.read_csv(csv)
    df.loc[1, "evidence_image"] = "data/missing.jpg"
    df.to_csv(csv, index=False)
    return root


def _engines(tok_texts, seed=0):
    jtok = JTokenizer.train(tok_texts, 200)
    jcfg = _cfg(jtok.vocab_size)
    tree = _jax_init(jcfg, seed)
    je = JCAP.CaptionEngine(jtok, cfg=jcfg, params=tree, batch_size=4)
    te = TCAP.CaptionEngine(WordPieceTokenizer(jtok.vocab),
                            cfg=_port_cfg(jcfg),
                            params=bridge.captioner_from_jax(
                                _np(tree), _port_cfg(jcfg)),
                            batch_size=4, device="cpu")
    return je, te


def test_process_csv_matches_jax(tree_root, tmp_path, capsys):
    """Both packages caption the same CSV alike, padded batches and a
    missing image included, and resume at the same row."""
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / name
        shutil.copytree(tree_root, roots[name])
    je, te = _engines(["a b c d claim evidence"])
    outs = {"jax": JCAP.process_csv("train", je, roots["jax"], save_every=4),
            "port": TCAP.process_csv("train", te, roots["port"],
                                     save_every=4)}
    dfs = {k: pd.read_csv(v) for k, v in outs.items()}
    assert set(COLUMNS) <= set(dfs["port"].columns)
    pd.testing.assert_frame_equal(dfs["port"], dfs["jax"])
    assert dfs["port"].loc[1, "evidence_enriched"] == str(
        dfs["port"].loc[1, "evidence"])          # the missing image
    assert TCAP.get_last_processed_index(dfs["port"]) == len(dfs["port"]) - 1
    # cut both after row 2: each resumes at row 3 and ends where it was
    for name, out in outs.items():
        df = dfs[name].copy()
        df.loc[3:, COLUMNS] = np.nan
        df.to_csv(out, index=False)
    capsys.readouterr()
    JCAP.process_csv("train", je, roots["jax"])
    TCAP.process_csv("train", te, roots["port"])
    said = capsys.readouterr().out
    assert said.count("resuming train at row 3") == 2
    for name, out in outs.items():
        pd.testing.assert_frame_equal(pd.read_csv(out), dfs["jax"])


def test_caption_engine_starts_from_dec(tmp_path):
    """BLIP's [DEC] is the start token where the vocabulary has it."""
    vocab = JTokenizer.train(["a b c"], 50).vocab
    for extra, want in (([], "[CLS]"), (["[DEC]"], "[DEC]")):
        tok = WordPieceTokenizer(vocab + extra)
        engine = TCAP.CaptionEngine(
            tok, cfg=TC.CAPTIONER_TEST, device="cpu")
        assert engine.bos_id == tok.token_to_id[want]


def test_caption_main_runs_on_the_cpu_when_asked(tree_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(tree_root, root)
    TCAP.main(["--datasets", "train", "--tiny", "--device", "cpu",
               "--batch_size", "4", "--root", str(root),
               "--assets", str(tmp_path / "assets")])
    df = pd.read_csv(root / "data" / "preprocessed" / "train_enriched.csv")
    assert TCAP.get_last_processed_index(df) == len(df) - 1
    assert (tmp_path / "assets" / "tokenizer.json").exists()


# -- the captioner assets ------------------------------------------------------------------

@pytest.mark.parametrize("head", [False, True])
def test_orbax_captioner_carries_over(tmp_path, rng, head):
    """tools/orbax_to_torch.py turns the JAX package's captioner.ckpt (a
    trained one, or a converted BLIP with its prediction head) into
    captioner.pt: the same params, and the port's load_captioner_assets
    then generates what the JAX package's does."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import orbax_to_torch

    tok = JTokenizer.train(["a small caption about the sea"], 100)
    jcfg = _cfg(tok.vocab_size)
    tree = _np(_init(jcfg, 5))
    if head:
        d, v = jcfg.decoder.hidden_size, tok.vocab_size
        tree["lm_head"] = {
            "transform": {"w": rng.standard_normal((d, d)).astype(np.float32)
                          * 0.1, "b": np.zeros(d, np.float32)},
            "ln": {"scale": np.ones(d, np.float32),
                   "bias": np.zeros(d, np.float32)},
            "decoder_w": rng.standard_normal((v, d)).astype(np.float32),
            "bias": rng.standard_normal(v).astype(np.float32)}
    tok.save(tmp_path / "tokenizer.json")
    (tmp_path / "captioner_config.json").write_text(
        json.dumps(dataclasses.asdict(jcfg)))
    jsave_params(str(tmp_path / "captioner.ckpt"), tree)
    with pytest.raises(FileNotFoundError, match="orbax_to_torch"):
        TC.load_captioner_assets(tmp_path, "cpu")
    assert [p.name for p in orbax_to_torch.convert_assets(tmp_path)] == [
        "captioner.pt"]
    _, cfg, params = TC.load_captioner_assets(tmp_path, "cpu")
    got = jax.tree_util.tree_leaves(bridge.to_jax_tree(params))
    assert all(np.array_equal(a, b) for a, b in
               zip(got, jax.tree_util.tree_leaves(tree)))
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, x: JC.generate(
        t, jcfg, x, tok.cls_id, tok.sep_id, tok.pad_id))(
            tree, jnp.asarray(images)))
    assert np.array_equal(
        TC.generate(params, cfg, torch.from_numpy(images), tok.cls_id,
                    tok.sep_id, tok.pad_id).numpy(), want)


# -- the prompting baselines --------------------------------------------------------------

@pytest.fixture(scope="module")
def prompting_assets(tmp_path_factory):
    """The assets of tests/test_captioner.py's baseline tests, with a
    captioner checkpoint in both packages' formats."""
    tok = JTokenizer.train(
        ["yes no the claim is supported", "evidence refutes everything",
         "answer yes or no please", "claim text about support",
         "not enough information to decide"], vocab_size=120)
    jcfg = _cfg(tok.vocab_size)
    return _assets(tmp_path_factory.mktemp("assets"), tok, jcfg,
                   _init(jcfg, 7))


def test_captioner_llm_matches_jax(prompting_assets):
    j = JE.make_llm("captioner", assets=str(prompting_assets))
    t = TE.make_llm("captioner", assets=str(prompting_assets), device="cpu")
    prompts = ["Claim: the sky is green. Evidence: the sky is blue. Answer:",
               "Claim: a. Evidence: b. Answer:"]
    assert [t(p) for p in prompts] == [j(p) for p in prompts]
    pairs = [("the sky is green", "the sky is blue"), ("a", "b")]
    want = JP.evaluate_zero_shot(j, pairs, [2, 0])
    assert TP.evaluate_zero_shot(t, pairs, [2, 0]) == want


def test_lvlm_scorer_matches_jax(prompting_assets, tmp_path, rng):
    img = tmp_path / "img.jpg"
    Image.fromarray(rng.integers(0, 255, (32, 32, 3),
                                 dtype=np.uint8)).save(img)
    j = JE.make_lvlm_scorer(str(prompting_assets))
    t = TE.make_lvlm_scorer(str(prompting_assets), device="cpu")
    prompt = "Claim: a. Evidence: b. Answer:"
    p1, p2 = t(prompt), t(prompt, image_path=str(img))
    assert abs(p1 - j(prompt)) <= TOL
    assert abs(p2 - j(prompt, image_path=str(img))) <= TOL
    assert p1 != p2                      # the image conditions the logits
    assert TP.two_level_verify(t, "a claim", ["ev1", "ev2"]) == \
        JP.two_level_verify(j, "a claim", ["ev1", "ev2"])
    docs = ["doc a", "doc b", "doc c"]
    assert TP.llm_rerank(t, "a claim", docs) == JP.llm_rerank(
        j, "a claim", docs)


def test_prompting_protocols_match_jax():
    texts = ["It supports the claim", "refuted: false", "Not enough info",
             "true but false", "", "The evidence is insufficient",
             "not true", "SUPPORT"]
    assert [TP.parse_label(x) for x in texts] == [JP.parse_label(x)
                                                  for x in texts]
    stub_t, stub_j = TE.make_llm("stub"), JE.make_llm("stub")
    pairs = [("c1", "this is false"), ("c2", "supports it"), ("c3", "meh"),
             ("c4", "true story")]
    labels = [2, 0, 1, 1]
    assert TP.evaluate_zero_shot(stub_t, pairs, labels) == \
        JP.evaluate_zero_shot(stub_j, pairs, labels)
    logits = {"yes": 1.25, "no": -0.5}
    assert TP.yes_no_probability(logits) == JP.yes_no_probability(logits)
    retrieved, relevant = [[3, 1, 4, 5, 9], [2, 6, 5]], [{1, 5}, {7}]
    for k in (1, 3, 5):
        for r, rel in zip(retrieved, relevant):
            for fn in ("precision_at_k", "recall_at_k",
                       "average_precision_at_k"):
                assert getattr(TP, fn)(r, rel, k) == getattr(JP, fn)(
                    r, rel, k)
        assert TP.map_at_k(retrieved, relevant, k) == JP.map_at_k(
            retrieved, relevant, k)


def test_eval_prompting_main_matches_jax(prompting_assets, tmp_path,
                                         monkeypatch):
    csv = tmp_path / "test.csv"
    pd.DataFrame({"claim": ["the sky is green", "water is wet"],
                  "evidence": ["the sky is blue", "it supports this"],
                  "category": ["Refute", "Support_Multimodal"]}).to_csv(
        csv, index=False)
    out = {}
    for name, main, extra in (("jax", JE.main, []),
                              ("port", TE.main, ["--device", "cpu"])):
        res = tmp_path / f"{name}.json"
        argv = ["--csv", str(csv), "--llm", "captioner", "--assets",
                str(prompting_assets), "--results_json", str(res), *extra]
        monkeypatch.setattr(sys, "argv", ["eval_prompting", *argv])
        main()
        out[name] = json.loads(res.read_text())
    assert out["port"] == out["jax"]


def test_entry_points_refuse_a_missing_card(prompting_assets, tmp_path):
    """The default device is the card: without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    csv = tmp_path / "x.csv"
    pd.DataFrame({"claim_image": ["a.jpg"], "claim_image_caption": ["a"],
                  "claim": ["c"], "evidence": ["e"],
                  "category": ["Refute"]}).to_csv(csv, index=False)
    tok = WordPieceTokenizer.load(prompting_assets / "tokenizer.json")
    for call in (
            lambda: TCAP.main(["--tiny", "--root", str(tmp_path),
                               "--assets", str(prompting_assets)]),
            lambda: TCAP.CaptionEngine(tok, cfg=TC.CAPTIONER_TEST),
            lambda: TE.main(["--csv", str(csv), "--llm", "captioner",
                             "--assets", str(prompting_assets)]),
            lambda: TE.make_lvlm_scorer(str(prompting_assets))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
