"""The demo (demo/{pipeline,render_html,app}.py) of the port against the
JAX package, on the CPU: the slice as a whole.

One tiny learnable tree (its enriched CSVs captioned by the JAX package);
one text corpus per split and one image corpus, written once and read by
both packages; the same tokenizer; the same params in both packages for
the frozen encoders (TINY_TEST, VIT_TEST), the fusion model, the
captioner (CAPTIONER_TEST), the bi-encoder and the ResNet (the JAX params
carried over by bridge.py); fp32. `ClaimVerificationPipeline.verify` runs
in both over the same claims. Tolerances:
  * the caption, the enriched claim, the evidence ids in order with their
    sources and texts, every per-path label, the per-evidence and final
    verdicts and the contributing indices: exactly;
  * the scores: within 4e-3 of the largest |score| (cosines over bf16
    corpus rows in both packages, queries encoded in fp32 sums of another
    order);
  * render_html: the same bytes for the same result; render_app: the same
    recorded calls as the JAX page's, on the stub pipeline of
    tests/test_demo_app.py and on the two real pipelines.
"""

import dataclasses
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.data.synthetic import synthetic_factify_tree
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.demo import app as JA
from mmd_tpu.demo import pipeline as JDP
from mmd_tpu.demo import render_html as JH
from mmd_tpu.inference.predictor import MisinformationPredictor as JPredictor
from mmd_tpu.models import captioner as JC
from mmd_tpu.models import frozen as JF
from mmd_tpu.models import resnet as JR
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.fusion import init_fusion_params as j_init
from mmd_tpu.pipelines import caption as JCAP
from mmd_tpu.pipelines.preprocess import preprocess_csv
from mmd_tpu.retrieval import image as JI
from mmd_tpu.retrieval import text as JS
from mmd_tpu.retrieval.corpus_utils import build_evidence_corpus_dir
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.demo import app as TA
from mmd_tpu_torch.demo import pipeline as TDP
from mmd_tpu_torch.demo import render_html as TH
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.models import captioner as TC
from mmd_tpu_torch.models import frozen as TF
from mmd_tpu_torch.models import resnet as TR
from mmd_tpu_torch.models import text_encoder as tte
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.pipelines import caption as TCAP
from mmd_tpu_torch.retrieval import image as TI
from mmd_tpu_torch.retrieval import text as TS
from test_demo_app import FakeSt, StubPipeline

torch.set_num_threads(2)

SCORE_TOL = 4e-3
MAX_LEN = 24
DIMS = dict(text_input_dim=32, image_input_dim=32, embed_dim=32,
            num_heads=4, hidden_dim=16, compute_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """(JAX pipeline, the port's, the tree's root)."""
    root = tmp_path_factory.mktemp("demo")
    synthetic_factify_tree(root, n_train=12, n_test=4, image_size=40,
                           seed=11, learnable=True)
    old = os.environ.get("MMD_TPU_ROOT")
    os.environ["MMD_TPU_ROOT"] = str(root)
    csvs = {s: preprocess_csv(s, root) for s in ("train", "test")}
    df = pd.read_csv(csvs["train"])
    JTokenizer.train(df[["claim", "evidence"]].stack().astype(str).tolist(),
                     300).save(root / "tok.json")
    jtok = JTokenizer.load(root / "tok.json")
    ttok = WordPieceTokenizer.load(root / "tok.json")
    vocab = max(jtok.vocab_size, 128)

    # the frozen encoders and the fusion model
    jtc = dataclasses.replace(jte.TINY_TEST, vocab_size=vocab)
    ttc = _port(tte.TransformerConfig, jtc)
    tp = _np(jte.init_text_encoder(jax.random.key(1), jtc))
    vp = _np(jvit.init_vit(jax.random.key(2), jvit.VIT_TEST))
    jenc = JF.FrozenEncoders(jtok, jtc, tp, jvit.VIT_TEST, vp)
    tenc = TF.FrozenEncoders(
        ttok, ttc, bridge.text_encoder_from_jax(tp, ttc), tvit.VIT_TEST,
        bridge.vit_from_jax(vp, tvit.VIT_TEST))
    jmodel, tmodel = JModelConfig(**DIMS), ModelConfig(**DIMS)
    fusion = _np(jax.jit(lambda k: j_init(k, jmodel))(jax.random.key(3)))
    jpred = JPredictor(jmodel, fusion_params=fusion, encoders=jenc,
                       max_length=MAX_LEN, batch_size=8)
    tpred = MisinformationPredictor(
        tmodel, fusion_params=bridge.fusion_from_jax(
            fusion, tmodel).state_dict(),
        encoders=tenc, max_length=MAX_LEN, batch_size=8, device="cpu")

    # the captioner, and the enriched CSVs it writes
    jcap = dataclasses.replace(JC.CAPTIONER_TEST, decoder=dataclasses.replace(
        JC.CAPTIONER_TEST.decoder, vocab_size=jtok.vocab_size))
    pcap = TC.config_from_dict(dataclasses.asdict(jcap))
    cap_tree = bridge.to_jax_tree(TC.init_captioner(
        torch.Generator().manual_seed(4), pcap))
    jengine = JCAP.CaptionEngine(jtok, cfg=jcap, params=cap_tree,
                                 batch_size=4)
    tengine = TCAP.CaptionEngine(
        ttok, cfg=pcap, params=bridge.captioner_from_jax(cap_tree, pcap),
        batch_size=4, device="cpu")
    enriched = {s: JCAP.process_csv(s, jengine, root) for s in csvs}

    # the corpora: written by the JAX package, read by both
    bi_tree = _np(jte.init_text_encoder(jax.random.key(5), jtc))
    bi_params = bridge.text_encoder_from_jax(bi_tree, ttc)
    jcorp, tcorp = [], []
    for split, csv in enriched.items():
        d = root / "data" / "retrieval" / f"text_{split}"
        e = pd.read_csv(csv)
        c = JS.TextCorpus(d, jtok, cfg=jtc, params=bi_tree,
                          max_length=MAX_LEN)
        c.encode_corpus(e["evidence_enriched"].astype(str).tolist(),
                        [f"{split}_{i}" for i in e["id"]], batch_size=4)
        jcorp.append(c)
        tcorp.append(TS.TextCorpus(d, ttok, cfg=ttc, params=bi_params,
                                   max_length=MAX_LEN, device="cpu"))
    rcfg = _port(TR.ResNetConfig, JR.RESNET_TEST)
    r_tree = _np(JR.init_resnet(jax.random.key(6), JR.RESNET_TEST))
    img_dir = root / "data" / "retrieval" / "image_corpus"
    jimg = JI.ImageCorpus(img_dir, resnet_params=r_tree, cfg=JR.RESNET_TEST)
    jimg.create_feature_corpus(sorted(
        str(p) for p in build_evidence_corpus_dir(["train"], root).glob(
            "*.jpg")), batch_size=4)
    timg = TI.ImageCorpus(img_dir, resnet_params=bridge.resnet_from_jax(
        r_tree, rcfg), cfg=rcfg, device="cpu")

    jindex = JDP.EvidenceIndex(enriched, root=root)
    tindex = TDP.EvidenceIndex(enriched, root=root)
    jpipe = JDP.ClaimVerificationPipeline(
        jpred, text_search=JS.SemanticSearch(
            jcorp[0], jcorp, evidence_lookup=jindex.text_lookup()),
        image_corpus=jimg, caption_engine=jengine, evidence_index=jindex)
    tpipe = TDP.ClaimVerificationPipeline(
        tpred, text_search=TS.SemanticSearch(
            tcorp[0], tcorp, evidence_lookup=tindex.text_lookup()),
        image_corpus=timg, caption_engine=tengine, evidence_index=tindex)
    yield jpipe, tpipe, root
    if old is None:
        os.environ.pop("MMD_TPU_ROOT")
    else:
        os.environ["MMD_TPU_ROOT"] = old


def _claims(root):
    """Each test row's claim, with its image path when the file is there."""
    df = pd.read_csv(root / "data" / "preprocessed" / "test.csv")
    out = []
    for _, r in df.iterrows():
        img = r["claim_image"]
        out.append((str(r["claim"]),
                    str(root / img) if isinstance(img, str) else None))
    return out


def _assert_same(got, want):
    for field in ("claim", "claim_enriched", "caption",
                  "final_classification", "contributing_indices"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.evidences) == len(want.evidences)
    for g, w in zip(got.evidences, want.evidences):
        assert (g.id, g.text, g.image_path, g.source) == (
            w.id, w.text, w.image_path, w.source)
        assert g.classification_result_all == w.classification_result_all
        assert g.classification_result_final == w.classification_result_final
    scores = np.array([e.score for e in want.evidences])
    np.testing.assert_allclose(
        [e.score for e in got.evidences], scores, rtol=0,
        atol=SCORE_TOL * max(np.abs(scores).max(), 1e-30))


def test_verify_matches_jax(pipes):
    jpipe, tpipe, root = pipes
    claims = _claims(root)
    assert any(p for _, p in claims) and any(p is None for _, p in claims)
    sources = set()
    for claim, img in claims:
        got = tpipe.verify(claim, img, top_k=3)
        want = jpipe.verify(claim, img, top_k=3)
        _assert_same(got, want)
        assert got.final_classification in (
            "support", "not_enough_information", "refute")
        sources |= {e.source for e in got.evidences}
        # the verify cache hands back the same result
        assert tpipe.verify(claim, img, top_k=3) is got
    assert sources == {"text", "image"}


def test_verify_cache_is_bounded(pipes):
    _, tpipe, _ = pipes
    tpipe._verify_cache.clear()
    for i in range(64):
        tpipe._verify_cache[("k", i)] = i
    tpipe.verify("a claim that is new", None, top_k=1)
    assert len(tpipe._verify_cache) == 64
    assert ("k", 0) not in tpipe._verify_cache


def test_render_html_same_bytes(pipes, tmp_path):
    _, tpipe, root = pipes
    claim, img = next(c for c in _claims(root) if c[1])
    result = tpipe.verify(claim, img, top_k=2)
    TH.render_html(result, tmp_path / "port.html")
    JH.render_html(result, tmp_path / "jax.html")
    html = (tmp_path / "port.html").read_bytes()
    assert html == (tmp_path / "jax.html").read_bytes()
    assert TH.CATEGORY_MAPPING[result.final_classification].encode() in html


def test_render_app_records_the_jax_pages_calls(pipes):
    jpipe, tpipe, _ = pipes
    for make in ((lambda: StubPipeline(), lambda: StubPipeline()),
                 (lambda: jpipe, lambda: tpipe)):
        for kw in ({}, {"text_input": ""}, {"press_button": False}):
            jst, tst = FakeSt(**kw), FakeSt(**kw)
            JA.render_app(jst, pipeline_factory=make[0])
            TA.render_app(tst, pipeline_factory=make[1])
            assert tst.calls == jst.calls
    st = FakeSt()
    TA.render_app(st, pipeline_factory=lambda: tpipe)
    verdict = tpipe.verify("the claim", None, top_k=5).final_classification
    assert ("write", "**Classification Result:** "
            + TA.CATEGORY_MAPPING[verdict]) in st.calls


def test_render_html_main_on_the_cpu(tmp_path):
    out = tmp_path / "r.html"
    argv = ["--out", str(out), "--root", str(tmp_path / "tree"), "--n", "8"]
    old = os.environ.get("MMD_TPU_ROOT")
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                TH.main(argv)
            assert not out.exists()
        result = TH.main(argv + ["--device", "cpu"])
    finally:
        if old is None:
            os.environ.pop("MMD_TPU_ROOT", None)
        else:
            os.environ["MMD_TPU_ROOT"] = old
    html = out.read_text()
    assert TH.CATEGORY_MAPPING[result.final_classification] in html
    assert "Final Combined Classification" in html and result.evidences


def test_app_imports_without_streamlit_and_refuses_a_missing_card(tmp_path):
    import sys
    assert "streamlit" not in sys.modules
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.build_pipeline(str(tmp_path), assets=str(tmp_path))
    with pytest.raises(ModuleNotFoundError):
        TA.main()
