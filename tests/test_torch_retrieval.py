"""Evidence retrieval in the port (mmd_tpu_torch/retrieval,
pipelines/build_retrieval.py, the MPNet parts of models/transformer.py, the
cross-encoder) against the JAX package, on the CPU.

The same params go to both through the bridge; the same texts, JPEG files
and stores go through both. Tolerances:
  * encoders (fp32): MPNet encode + mean_pool and cross_encoder_score
    within 1e-5 of the largest |value|;
  * re-ranked searches: the same ids in the same order, cross-encoder
    scores within 1e-5 (the tiny corpora are recalled whole, so the
    candidates are the same set);
  * bi-encoder and image cosines, scored over bf16 rows as in JAX: the same
    ids, scores within 4e-3 (one bf16 step at 1: the two packages' fp32
    rows, within 1e-5 of each other, may round to neighbouring bf16
    values);
  * the experiments: the same accuracies.
The stores are the JAX layout: a corpus written by either package loads
in the other.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.core.checkpoint import save_params as jsave_params
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import resnet as JR
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import transformer as JT
from mmd_tpu.retrieval import experiments as JX
from mmd_tpu.retrieval import image as JI
from mmd_tpu.retrieval import text as JS
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import resnet as TR
from mmd_tpu_torch.models import text_encoder as tte
from mmd_tpu_torch.models import transformer as TT
from mmd_tpu_torch.ops import topk as T
from mmd_tpu_torch.retrieval import experiments as TX
from mmd_tpu_torch.retrieval import image as TI
from mmd_tpu_torch.retrieval import text as TS

torch.set_num_threads(2)

ENC_TOL = 1e-5
BF16_SCORE_TOL = 4e-3

DOCS = [
    "the supreme court ruled on immigration policy today",
    "a new vaccine study shows strong efficacy results",
    "the football team won the championship game",
    "stock markets fell sharply after the announcement",
    "scientists discovered a new species of frog",
    "the senate passed the infrastructure spending bill",
    "heavy rain flooded the streets of the old town",
]
IDS = [f"train_{i}" for i in range(len(DOCS))]
MAX_LEN = 48


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bi_cfg(vocab):
    """A tiny mpnet-arch bi-encoder (fp32): shared relative bias, RoBERTa
    positions from the pad id."""
    return JT.TransformerConfig(
        vocab_size=vocab, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=MAX_LEN + 2, type_vocab_size=0,
        relative_bias_buckets=32, mpnet_positions=True, pad_token_id=0,
        layer_norm_eps=1e-5, compute_dtype="float32")


def _cross_cfg(vocab):
    """A tiny cross-encoder (fp32) with head dim 32, so the port routes it
    to the fused attention path as it routes the MiniLM."""
    return JT.TransformerConfig(
        vocab_size=vocab, hidden_size=64, num_layers=2, num_heads=2,
        intermediate_size=128, max_position=MAX_LEN, compute_dtype="float32")


def _port_cfg(jcfg):
    return TT.TransformerConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def text_setup(tmp_path_factory):
    """The same tokenizer vocabulary, bi-encoder and cross-encoder (with
    the HF pooler) in both packages, and a corpus each package wrote."""
    jtok = JTokenizer.train(DOCS, vocab_size=300)
    ttok = WordPieceTokenizer(jtok.vocab)
    bi = _bi_cfg(jtok.vocab_size)
    cross = _cross_cfg(jtok.vocab_size)
    bi_tree = _np_tree(jte.init_text_encoder(jax.random.key(1), bi))
    k1, k2 = jax.random.split(jax.random.key(2))
    cross_tree = _np_tree({**jte.init_cross_encoder(k1, cross),
                           "pooler": jte.L.linear_init(k2, 64, 64)})
    d = tmp_path_factory.mktemp("text")
    jc = JS.TextCorpus(d / "jax", jtok, cfg=bi, params=bi_tree,
                       max_length=MAX_LEN)
    jc.encode_corpus(DOCS, IDS, batch_size=4)
    tc = TS.TextCorpus(d / "port", ttok, cfg=_port_cfg(bi),
                       params=bridge.text_encoder_from_jax(bi_tree,
                                                           _port_cfg(bi)),
                       max_length=MAX_LEN, device="cpu")
    tc.encode_corpus(DOCS, IDS, batch_size=4)
    return dict(jtok=jtok, ttok=ttok, bi=bi, cross=cross, bi_tree=bi_tree,
                cross_tree=cross_tree, jc=jc, tc=tc, dir=d)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# -- MPNet ---------------------------------------------------------------------

def test_relative_position_buckets_identical_to_jax():
    for t, nb in ((8, 32), (64, 32), (512, 32), (40, 8)):
        np.testing.assert_array_equal(
            TT.relative_position_bucket(t, nb),
            JT.relative_position_bucket(t, nb))


def _ids_with_pads(vocab, pad):
    rng = np.random.default_rng(3)
    ids = rng.integers(pad + 1, vocab, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    ids[1, 9:] = pad
    mask[1, 9:] = 0
    ids[2, 4] = pad                                 # a pad inside the text
    return ids, mask


def test_mpnet_positions_match_jax():
    """RoBERTa positions (non-pad tokens numbered from pad + 1, pads on the
    pad row) through embed: identical tables give identical rows."""
    cfg = dataclasses.replace(_bi_cfg(50), pad_token_id=1)
    tree = _np_tree(JT.init_embeddings(jax.random.key(4), cfg))
    ids, _ = _ids_with_pads(50, 1)
    want = np.asarray(JT.embed(tree, cfg, jnp.asarray(ids)))
    params = bridge.text_encoder_from_jax(
        {"embeddings": tree, "layers": [], "rel_bias": np.zeros((32, 4))},
        _port_cfg(dataclasses.replace(cfg, num_layers=0)))
    got = TT.embed(params["embeddings"], _port_cfg(cfg),
                   torch.from_numpy(ids).long())
    _close(got.detach().numpy(), want, 1e-6)


def test_mpnet_encode_mean_pool_matches_jax():
    cfg = dataclasses.replace(_bi_cfg(60), pad_token_id=1)
    tree = _np_tree(jte.init_text_encoder(jax.random.key(5), cfg))
    ids, mask = _ids_with_pads(60, 1)
    want = np.asarray(jte.mean_pool(
        jte.encode(tree, cfg, jnp.asarray(ids), jnp.asarray(mask)),
        jnp.asarray(mask)))
    params = bridge.text_encoder_from_jax(tree, _port_cfg(cfg))
    with torch.no_grad():
        m = torch.from_numpy(mask)
        got = tte.mean_pool(tte.encode(params, _port_cfg(cfg),
                                       torch.from_numpy(ids).long(), m), m)
    _close(got.numpy(), want, ENC_TOL)


@pytest.mark.parametrize("pooler", [False, True])
def test_cross_encoder_score_matches_jax(text_setup, pooler):
    cfg = text_setup["cross"]
    tree = dict(text_setup["cross_tree"])
    if not pooler:
        del tree["pooler"]
    ids, mask, types = text_setup["jtok"].encode_batch(
        [DOCS[0]] * 3, pairs=DOCS[1:4], max_length=MAX_LEN)
    want = np.asarray(jte.cross_encoder_score(
        tree, cfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    params = bridge.cross_encoder_from_jax(tree, _port_cfg(cfg))
    assert ("pooler" in params) == pooler
    with torch.no_grad():
        got = tte.cross_encoder_score(
            params, _port_cfg(cfg), torch.from_numpy(ids).long(),
            torch.from_numpy(mask), torch.from_numpy(types).long())
    _close(got.numpy(), want, ENC_TOL)


# -- TextCorpus / SemanticSearch ---------------------------------------------------

def _searches(s):
    jsearch = JS.SemanticSearch(
        s["jc"], [s["jc"]], cross_encoder_params=s["cross_tree"],
        cross_cfg=s["cross"], evidence_lookup=dict(zip(IDS, DOCS)),
        rerank_max_length=MAX_LEN)
    tsearch = TS.SemanticSearch(
        s["tc"], [s["tc"]],
        cross_encoder_params=bridge.cross_encoder_from_jax(
            s["cross_tree"], _port_cfg(s["cross"])),
        cross_cfg=_port_cfg(s["cross"]),
        evidence_lookup=dict(zip(IDS, DOCS)), rerank_max_length=MAX_LEN)
    return jsearch, tsearch


def test_text_corpora_encode_alike(text_setup):
    s = text_setup
    _close(s["tc"].encode_texts(DOCS, batch_size=3),
           s["jc"].encode_texts(DOCS, batch_size=4), ENC_TOL)


def test_semantic_search_with_rerank_matches_jax(text_setup):
    jsearch, tsearch = _searches(text_setup)
    for q in (DOCS[1], "a vaccine for frogs", "markets and the senate"):
        want = jsearch.search(q, top_k=4)
        got = tsearch.search(q, top_k=4)
        assert [i for i, _ in got] == [i for i, _ in want]
        _close([v for _, v in got], [v for _, v in want], ENC_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_bi_encoder_search_matches_jax(text_setup, int8):
    """No re-rank: cosine over each package's own store; self-retrieval at
    rank 1 in both."""
    s = text_setup
    jc = JS.TextCorpus(s["jc"].dir, s["jtok"], cfg=s["bi"],
                       params=s["bi_tree"], max_length=MAX_LEN, int8=int8)
    tc = TS.TextCorpus(s["tc"].dir, s["ttok"], cfg=s["tc"].cfg,
                       params=s["tc"].params, max_length=MAX_LEN, int8=int8,
                       device="cpu")
    jsearch, tsearch = JS.SemanticSearch(jc, [jc]), TS.SemanticSearch(tc, [tc])
    for i in (0, 3, 6):
        want = jsearch.search(DOCS[i], top_k=3)
        got = tsearch.search(DOCS[i], top_k=3)
        assert got[0][0] == IDS[i]
        assert [a for a, _ in got] == [a for a, _ in want]
        _close([v for _, v in got], [v for _, v in want], BF16_SCORE_TOL)


def test_corpus_written_by_either_package_loads_in_the_other(text_setup):
    s = text_setup
    for writer, reader in (("jax", "port"), ("port", "jax")):
        d = s["dir"] / writer
        raw = np.load(d / "embeddings.npy")
        assert raw.dtype == np.float16 and raw.shape == (len(DOCS), 32)
        if reader == "port":
            rows, ids = TS.TextCorpus(d, s["ttok"], cfg=s["tc"].cfg,
                                      params=s["tc"].params,
                                      device="cpu").load()
            want = T.l2_normalize(torch.from_numpy(raw).bfloat16())
            assert torch.equal(rows, want)
        else:
            rows, ids = JS.TextCorpus(d, s["jtok"], cfg=s["bi"],
                                      params=s["bi_tree"]).load()
            np.testing.assert_array_equal(
                np.asarray(rows, np.float32),
                torch.from_numpy(raw).bfloat16().float().numpy())
        assert ids == IDS
    np.testing.assert_allclose(np.load(s["dir"] / "port/embeddings.npy"),
                               np.load(s["dir"] / "jax/embeddings.npy"),
                               rtol=2e-3, atol=1e-4)


def test_rows_normalized_at_load_are_the_per_call_rows(text_setup):
    """The port normalizes the corpus once, where JAX normalizes it on
    every call: the loaded rows equal l2_normalize of the stored bf16 rows
    bit for bit, and so do the top-k scores and indices."""
    s = text_setup
    rows, _ = s["tc"].load()
    raw = torch.from_numpy(np.load(s["tc"].dir / "embeddings.npy"))
    assert torch.equal(rows, T.l2_normalize(raw.bfloat16()))
    q = s["tc"].encode_texts(DOCS[:2])
    got = s["tc"].topk(q, 5)
    want = T.dense_topk(torch.from_numpy(q).bfloat16(), raw.bfloat16(), 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_resolve_retrieval_encoders(text_setup, tmp_path):
    s = text_setup
    empty = TS.resolve_retrieval_encoders(tmp_path)
    assert all(v is None for v in empty.values())
    bi = bridge.text_encoder_from_jax(s["bi_tree"], _port_cfg(s["bi"]))
    cross = bridge.cross_encoder_from_jax(s["cross_tree"],
                                          _port_cfg(s["cross"]))
    for name, params, cfg in (("bi_encoder", bi, s["bi"]),
                              ("cross_encoder", cross, s["cross"])):
        save_params(str(tmp_path / f"{name}.pt"), params)
        (tmp_path / f"{name}_config.json").write_text(
            json.dumps(dataclasses.asdict(cfg)))
    s["ttok"].save(tmp_path / "bi_tokenizer.json")
    got = TS.resolve_retrieval_encoders(tmp_path)
    assert got["bi_cfg"] == _port_cfg(s["bi"])
    assert got["cross_cfg"] == _port_cfg(s["cross"])
    assert got["bi_tokenizer"].vocab == s["ttok"].vocab
    for a, b in ((got["bi_params"], bi), (got["cross_params"], cross)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    (tmp_path / "bi_encoder.pt").unlink()
    (tmp_path / "bi_encoder.ckpt").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax_to_torch"):
        TS.resolve_retrieval_encoders(tmp_path)


def test_orbax_retrieval_assets_carry_over(text_setup, tmp_path):
    """The JAX converter's bi_encoder.ckpt and cross_encoder.ckpt (with
    their sidecars) and resnet50.ckpt (none: ResNetConfig()) become .pt
    files that hold the same params."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import orbax_to_torch

    s = text_setup
    resnet_tree = _np_tree(JR.init_resnet(jax.random.key(6)))
    for name, tree, cfg in (("bi_encoder", s["bi_tree"], s["bi"]),
                            ("cross_encoder", s["cross_tree"], s["cross"]),
                            ("resnet50", resnet_tree, None)):
        jsave_params(str(tmp_path / f"{name}.ckpt"), tree)
        if cfg is not None:
            (tmp_path / f"{name}_config.json").write_text(
                json.dumps(dataclasses.asdict(cfg)))
    written = orbax_to_torch.convert_assets(tmp_path)
    assert sorted(p.name for p in written) == [
        "bi_encoder.pt", "cross_encoder.pt", "resnet50.pt"]
    got = TS.resolve_retrieval_encoders(tmp_path)
    for key, tree in (("bi_params", s["bi_tree"]),
                      ("cross_params", s["cross_tree"])):
        flat = jax.tree_util.tree_leaves(bridge.to_jax_tree(got[key]))
        want = jax.tree_util.tree_leaves(tree)
        assert all(np.array_equal(a, b) for a, b in zip(flat, want))
    resnet = TR.init_resnet(torch.Generator().manual_seed(0))
    resnet.load_state_dict(torch.load(tmp_path / "resnet50.pt",
                                      weights_only=True))
    flat = jax.tree_util.tree_leaves(bridge.resnet_to_jax(resnet))
    assert all(np.array_equal(a, b) for a, b in
               zip(flat, jax.tree_util.tree_leaves(resnet_tree)))


# -- ImageCorpus ---------------------------------------------------------------

RESNET = dataclasses.replace(JR.RESNET_TEST, compute_dtype="float32")


@pytest.fixture(scope="module")
def image_setup(tmp_path_factory):
    """Six near-duplicate claim/evidence JPEG pairs (64 px), a corrupt
    file among the evidence, and one store built by each package from the
    same ResNet params."""
    from PIL import Image
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("imgs")
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    for i in range(6):
        fx, fy = rng.uniform(1, 4, 2)
        phase = rng.uniform(0, 6.28, 3)
        chans = [np.sin(2 * np.pi * (fx * xx + fy * yy) + p) for p in phase]
        base = ((np.stack(chans, -1) * 0.5 + 0.5) * 255).astype(np.uint8)
        Image.fromarray(base).save(d / f"{i}_evidence.jpg")
        noisy = np.clip(base.astype(int) + rng.integers(-3, 4, base.shape),
                        0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(d / f"{i}_claim.jpg")
    (d / "5x_evidence.jpg").write_bytes(b"not a jpeg")
    paths = sorted(str(p) for p in d.glob("*_evidence.jpg"))
    tree = _np_tree(JR.init_resnet(jax.random.key(7), RESNET))
    params = bridge.resnet_from_jax(tree, TR.ResNetConfig(
        **dataclasses.asdict(RESNET)))
    store = tmp_path_factory.mktemp("istore")
    jc = JI.ImageCorpus(store / "jax", resnet_params=tree, cfg=RESNET)
    tc = TI.ImageCorpus(store / "port", resnet_params=params,
                        cfg=TR.ResNetConfig(**dataclasses.asdict(RESNET)),
                        device="cpu")
    counts = (jc.create_feature_corpus(paths, batch_size=4),
              tc.create_feature_corpus(paths, batch_size=4))
    return dict(dir=d, paths=paths, tree=tree, params=params, jc=jc, tc=tc,
                counts=counts)


def test_image_corpus_build_skips_the_corrupt_file(image_setup, capsys):
    s = image_setup
    assert s["counts"] == (6, 6) and len(s["paths"]) == 7
    jrows = ArrayStore(s["jc"].dir).col("features")
    trows = ArrayStore(s["tc"].dir).col("features")
    assert trows.dtype == np.float16 and trows.shape == jrows.shape
    np.testing.assert_allclose(trows.astype(np.float32),
                               jrows.astype(np.float32), rtol=2e-3,
                               atol=2e-3 * np.abs(jrows).max())
    assert json.loads((s["tc"].dir / "ids.json").read_text()) == \
        json.loads((s["jc"].dir / "ids.json").read_text())
    assert not any("5x_" in p for p in s["tc"]._ids or [])


@pytest.mark.parametrize("int8", [False, True])
def test_image_search_matches_jax(image_setup, int8):
    """Each package over its own store: the near-duplicate evidence at
    rank 1 in both, the same ids, scores within the bf16 tolerance."""
    s = image_setup
    jc = JI.ImageCorpus(s["jc"].dir, resnet_params=s["tree"], cfg=RESNET,
                        int8=int8)
    tc = TI.ImageCorpus(s["tc"].dir, resnet_params=s["params"],
                        cfg=s["tc"].cfg, int8=int8, device="cpu")
    for i in (0, 2, 5):
        q = str(s["dir"] / f"{i}_claim.jpg")
        want, got = jc.retrieve_similar_images(q, 3), \
            tc.retrieve_similar_images(q, 3)
        assert Path(got[0][0]).name == f"{i}_evidence.jpg"
        assert [p for p, _ in got] == [p for p, _ in want]
        _close([v for _, v in got], [v for _, v in want], BF16_SCORE_TOL)
    _close(tc.extract_features(q), jc.extract_features(q), ENC_TOL)
    assert tc.extract_features(str(s["dir"] / "5x_evidence.jpg")) is None


def test_image_store_written_by_jax_serves_in_the_port(image_setup,
                                                       tmp_path):
    """The JAX store read by the port, and write_feature_corpus's store read
    by JAX: the same rows, ids and duplicates dropped by dedup."""
    s = image_setup
    tc = TI.ImageCorpus(s["jc"].dir, resnet_params=s["params"],
                        cfg=s["tc"].cfg, device="cpu")
    assert len(tc) == 6
    feats = ArrayStore(s["jc"].dir).col("features").astype(np.float32)
    dup = np.concatenate([feats, feats[2:3]])          # row 6 = row 2
    ids = [f"img{i}" for i in range(7)]
    TI.ImageCorpus(tmp_path / "dup", resnet_params=s["params"],
                   cfg=s["tc"].cfg, device="cpu").write_feature_corpus(
                       dup, ids)
    jc = JI.ImageCorpus(tmp_path / "dup", resnet_params=s["tree"],
                        cfg=RESNET)
    tc = TI.ImageCorpus(tmp_path / "dup", resnet_params=s["params"],
                        cfg=s["tc"].cfg, device="cpu")
    # distinct rows may also tie exactly in fp32, depending on the
    # summation order; only the duplicate's fate is compared
    for res in (jc.retrieve_by_features(dup[2:3], top_k=3)[0],
                tc.retrieve_by_features(dup[2:3], top_k=3)[0]):
        assert res[0][0] == "img2" and "img6" not in [p for p, _ in res]
    raw = tc.retrieve_by_features(dup[2:3], top_k=2, dedup=False)[0]
    assert [p for p, _ in raw] == ["img2", "img6"]
    assert raw[0][1] == raw[1][1]


# -- experiments ----------------------------------------------------------------

def test_experiments_match_jax(image_setup, text_setup, tmp_path):
    s, t = image_setup, text_setup
    queries = sorted(str(p) for p in s["dir"].glob("*_claim.jpg"))
    want = JX.image_retrieval_experiment(s["jc"], queries, ks=(1, 2, 5),
                                         out_file=tmp_path / "j.txt")
    got = TX.image_retrieval_experiment(s["tc"], queries, ks=(1, 2, 5),
                                        out_file=tmp_path / "t.txt")
    assert got == want and got[1] >= 0.8
    lines = (tmp_path / "t.txt").read_text().splitlines()
    assert lines[1] == "top-1 accuracy: %.4f" % got[1]
    assert json.loads(lines[-1]) == {f"top{k}": v for k, v in got.items()}
    jsearch, tsearch = _searches(t)
    pairs = [(DOCS[i], IDS[i]) for i in range(len(DOCS))] + [
        ("a vaccine for frogs", IDS[1])]
    want = JX.text_retrieval_experiment(jsearch, pairs, ks=(1, 3),
                                        out_file=tmp_path / "jt.txt")
    got = TX.text_retrieval_experiment(tsearch, pairs, ks=(1, 3),
                                       out_file=tmp_path / "tt.txt")
    assert got == want


# -- the pipeline and the entry points -------------------------------------------

@pytest.fixture()
def trees(tmp_path, monkeypatch):
    """The same synthetic Factify tree (preprocessed) once for each
    package."""
    from mmd_tpu.data.synthetic import synthetic_factify_tree as jtree
    from mmd_tpu.pipelines.preprocess import preprocess_csv as jprep
    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
    out = {}
    for name, make, prep in (("jax", jtree, jprep),
                             ("port", synthetic_factify_tree,
                              preprocess_csv)):
        root = tmp_path / name
        make(root, n_train=10, n_test=4, seed=11)
        for split in ("train", "test"):
            prep(split, root)
        out[name] = root
    monkeypatch.delenv("MMD_TPU_ROOT", raising=False)
    return out


def test_build_retrieval_matches_jax(trees, monkeypatch):
    import pandas as pd

    from mmd_tpu.pipelines import build_retrieval as JB
    from mmd_tpu_torch.pipelines import build_retrieval as TB
    df = pd.read_csv(trees["jax"] / "data/preprocessed/train.csv")
    jtok = JTokenizer.train(df["evidence"].astype(str), 300)
    got = {}
    for name, mod, tok, kw in (
            ("jax", JB, jtok, {}),
            ("port", TB, WordPieceTokenizer(jtok.vocab), {"device": "cpu"})):
        monkeypatch.setenv("MMD_TPU_ROOT", str(trees[name]))
        corpora = mod.build_text_corpora(["train", "test"], tok, trees[name],
                                         tiny=True, batch_size=4, **kw)
        img = mod.build_image_corpus(["train"], trees[name], tiny=True,
                                     batch_size=4, **kw)
        img._load()
        got[name] = ([c.load()[1] for c in corpora],
                     [np.load(c.dir / "embeddings.npy").shape
                      for c in corpora],
                     [Path(p).name for p in img._ids])
    assert got["port"] == got["jax"]
    texts, _, images = got["port"]
    assert len(texts) == 2 and len(texts[0]) == 10
    assert texts[0][0].startswith("train_")
    assert images and all(p.startswith("train_") and
                          p.endswith("_evidence.jpg") for p in images)


def test_entry_points_run_on_the_cpu_when_asked(trees, monkeypatch, capsys):
    from mmd_tpu_torch.pipelines import build_retrieval as TB
    root = trees["port"]
    monkeypatch.setenv("MMD_TPU_ROOT", str(root))
    assets = root / "assets"
    assets.mkdir()
    WordPieceTokenizer.train(["claim text evidence document topic"] * 4,
                             100).save(assets / "tokenizer.json")
    TB.main(["--tiny", "--device", "cpu", "--assets", str(assets)])
    out = capsys.readouterr().out
    assert "[text2text] corpus" in out and "[im2im] corpus built" in out
    TS.main(["--tiny", "--device", "cpu", "--assets", str(assets),
             "--query", "evidence document 3", "--top_k", "2", "--int8"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert 1 <= len(lines) <= 2        # exact-score ties are dropped
    assert all(ln.split()[1].startswith(("train_", "test_")) for ln in lines)
    query = next((root / "data" / "evidence_corpus").glob("*.jpg"))
    TI.main(["--tiny", "--device", "cpu", "--store",
             str(root / "data/retrieval/image_corpus"), "--query",
             str(query), "--top_k", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert Path(line.split()[1]).parent == query.parent


def test_entry_points_refuse_a_missing_card(tmp_path):
    """The default device is the card: without one they raise instead of
    running on the CPU."""
    from mmd_tpu_torch.pipelines import build_retrieval as TB
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.main(["--tiny", "--assets", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(["--tiny", "--assets", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.main(["--tiny", "--store", str(tmp_path)])
