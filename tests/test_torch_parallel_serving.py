"""Multi-device serving's entry points over a world of 4 gloo ranks on the
CPU: MisinformationPredictor(mesh=, text_parallelism=) in every mode,
`python -m mmd_tpu_torch.evaluate --text_parallelism`, make_sharded_topk
and ImageCorpus(mesh=), against tests/test_inference.py:65-100 and
tests/test_sharded_retrieval.py.

One world for the module (the `world` fixture) runs every case on the
meshes (1, 4), (2, 2) and (4, 1), and each rank hands back what it served:
  * the predictor with a 4-layer BERT-class and a 4-layer DeBERTa text
    encoder, the tiny ViT and a fusion head (numpy-seeded weights: the
    port's init in the JAX layout, each leaf moved by seeded noise, which
    bridge carries across), under "sp", "sp_ring", "pp" and "tp": the
    text embeddings and evaluate_batch's probabilities, six pairs at
    batch 4 (a ragged tail), two of them with images;
  * evaluate.main with --text_parallelism sp over the world (rank 0's
    printout) on tiny converted assets (a one-layer text encoder: the CLI
    encodes 512 tokens);
  * make_sharded_topk over "data" and over "model", on a corpus with equal
    rows inside a shard and across shards;
  * ImageCorpus(mesh=) on a store of 10 images (12 rows once padded to
    the mesh's 4 ranks).
Comparisons: the port's single-device predictor (embeddings at the JAX
tests' limits, rtol 2e-5 and atol 2e-6, the ring atol 2e-5; probabilities
within 1e-5; labels equal), the single-device CLI's printout (equal), the
port's dense_topk and ImageCorpus (indices and paths equal, in lax.top_k's
tie order: the lower index first), and the JAX package: its predictor with
the same text_parallelism on the virtual CPU mesh (2, 2) (BERT-class under
"sp", DeBERTa under "pp"; tests/test_torch_{sp,pp,tp_serving}.py hold
every encoder against the JAX package's), embeddings within
rtol 1e-4 and atol 1e-5 and probabilities within 1e-4 (fp32 summed in
another order), its dense_topk (indices equal) and its sharded ImageCorpus
over the same store (paths equal, scores within 1e-2: it scores bf16 rows).
Besides: one FrozenEncoders serves every mode and then single-device
(the split predictors hold copies), the mesh lays the ranks out as the
JAX package's grid, and a
world whose rank raises or hangs fails within a bounded time. JAX is
imported only inside the fixtures and tests: a rank imports this file to
unpickle its body and must not load JAX.
"""

import contextlib
import copy
import dataclasses
import io
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.core.mesh import corpus_sharding, make_mesh, shard_batch
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.models import text_encoder as TTE
from mmd_tpu_torch.models import vit as TV
from mmd_tpu_torch.models.frozen import FrozenEncoders
from mmd_tpu_torch.models.resnet import RESNET_TEST
from mmd_tpu_torch.ops import topk as T
from mmd_tpu_torch.parallel.launch import spawn
from mmd_tpu_torch.retrieval.image import ImageCorpus

WORLD = 4
MESHES = (4, 2, 1)                 # model_parallel: (1, 4), (2, 2), (4, 1)
MODES = ("sp", "sp_ring", "pp", "tp")
FAMILIES = ("bert", "deberta")
TOL = dict(rtol=2e-5, atol=2e-6)
RING_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
PROB_TOL = 1e-5
JAX_PROB_TOL = 1e-4
LAYERS = 4
MAX_LEN = 16
BATCH = 4
TEXTS = ["a first claim about frogs", "some evidence text", "a third one",
         "claims and evidence", "frogs are green", "the last claim"]
EVIDENCE = TEXTS[3:] + TEXTS[:3]
MODEL = dict(text_input_dim=32, image_input_dim=32, embed_dim=32,
             num_heads=4, hidden_dim=16, compute_dtype="float32")
CLI_ARGS = ["--claim_text", "frogs are green", "--evidence_text",
            "some evidence text", "--text_input_dim", "32",
            "--image_input_dim", "32", "--embed_dim", "32", "--num_heads",
            "4", "--hidden_dim", "16", "--device", "cpu", "--detailed"]
JAX_MODES = (("bert", "sp"), ("deberta", "pp"))
# make_sharded_topk: 24 rows of 8 (rows 9 = 2 and 17 = 5 in value), k 6
TOPK_N, TOPK_K = 24, 6


def _topk_corpus():
    rng = np.random.default_rng(5)
    c = rng.standard_normal((TOPK_N, 8)).astype(np.float32)
    c[9], c[17] = c[2], c[5]
    q = np.stack([c[5], c[2] + 0.01, rng.standard_normal(8)]).astype(
        np.float32)
    return torch.from_numpy(q), torch.from_numpy(c)


def _seeded_tree(params, seed: int):
    """The JAX-layout tree of a port param tree (bridge.to_jax_tree), each
    leaf moved by numpy-seeded noise: the weights both packages serve."""
    rng = np.random.default_rng(seed)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return (node + rng.normal(0.0, 0.02, node.shape)).astype(np.float32)

    return move(bridge.to_jax_tree(params))


def _encoders(family: str, tokenizer_path: Path):
    """(the JAX package's encoders, the port's) of a family, 4 text layers
    and the tiny ViT, on the same numpy-seeded weights."""
    from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTok
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    from mmd_tpu.models import vit as JV
    from mmd_tpu.models.frozen import FrozenEncoders as JFrozen
    tok = WordPieceTokenizer.load(tokenizer_path)
    gen = torch.Generator().manual_seed(1)
    kw = dict(num_layers=LAYERS, vocab_size=max(tok.vocab_size, 128),
              compute_dtype="float32")
    if family == "deberta":
        jcfg = dataclasses.replace(JD.DEBERTA_TEST, **kw)
        tcfg = dataclasses.replace(TD.DEBERTA_TEST, **kw)
        text = _seeded_tree(TD.init_deberta(gen, tcfg), 1)
    else:
        jcfg = dataclasses.replace(JTE.TINY_TEST, **kw)
        tcfg = dataclasses.replace(TTE.TINY_TEST, **kw)
        text = _seeded_tree(TTE.init_text_encoder(gen, tcfg), 1)
    vit = _seeded_tree(TV.init_vit(gen, TV.VIT_TEST), 2)
    return (JFrozen(JTok.load(tokenizer_path), jcfg, text, JV.VIT_TEST, vit),
            FrozenEncoders(tok, tcfg, bridge.text_from_jax(text, tcfg),
                           TV.VIT_TEST, bridge.vit_from_jax(vit, TV.VIT_TEST)))


def _serve(pred, images):
    claim_imgs = [images[0], None, None, images[1], None, None]
    ev_imgs = [None, images[1], None, None, None, images[0]]
    emb = pred._encode_texts(TEXTS)
    res = pred.evaluate_batch(TEXTS, claim_imgs, EVIDENCE, ev_imgs,
                              detailed=True)
    return torch.tensor(np.asarray(emb)), res


def _rank(rank, world, dev, job):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in MESHES}
    out = {"jax_loaded": "jax" in sys.modules}
    cfg = ModelConfig(**job["model"])
    with torch.no_grad():
        for family, enc in job["encoders"].items():
            for mode in MODES:
                for mp, mesh in meshes.items():
                    pred = MisinformationPredictor(
                        cfg, fusion_params=job["fusion"], encoders=enc,
                        max_length=MAX_LEN, batch_size=BATCH, mesh=mesh,
                        text_parallelism=mode)
                    out[family, mode, mp] = _serve(pred, job["images"])
            # the same encoders, after serving split, serve whole
            out[family, "after"] = _serve(MisinformationPredictor(
                cfg, fusion_params=job["fusion"], encoders=enc,
                max_length=MAX_LEN, batch_size=BATCH, device=dev),
                job["images"])
        q, corpus = _topk_corpus()
        for mp, mesh in meshes.items():
            out["mesh", mp] = (
                mesh.shape, mesh.axis_index("data"), mesh.axis_index("model"),
                mesh.axis_ranks("data"), mesh.axis_ranks("model"),
                shard_batch({"x": np.arange(8)}, mesh)["x"].tolist())
            for axis in ("data", "model"):
                fn = T.make_sharded_topk(mesh, axis, TOPK_N, TOPK_K)
                out["topk", axis, mp] = fn(
                    q, corpus[corpus_sharding(mesh, TOPK_N, axis)])
            ic = ImageCorpus(job["store"], cfg=RESNET_TEST, mesh=mesh)
            out["corpus", mp] = ic.retrieve_by_features(job["query"],
                                                        top_k=4)
    from mmd_tpu_torch import evaluate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main(CLI_ARGS + ["--assets", job["assets"],
                                  "--text_parallelism", "sp"])
    out["cli"] = buf.getvalue()
    return out


def _write_images(d: Path) -> list[str]:
    from PIL import Image
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    paths = []
    for i in range(10):
        fx, fy = rng.uniform(1, 4, 2)
        chans = [np.sin(2 * np.pi * (fx * xx + fy * yy) + p)
                 for p in rng.uniform(0, 6.28, 3)]
        arr = ((np.stack(chans, -1) * 0.5 + 0.5) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{i}_evidence.jpg")
        paths.append(str(d / f"{i}_evidence.jpg"))
    return paths


def _write_cli_assets(d: Path, tokenizer) -> None:
    """Converted-asset files of a one-layer BERT-class encoder and the tiny
    ViT, seeded, which load_or_init_frozen(d) reads back."""
    from mmd_tpu_torch.core.checkpoint import save_params
    cfg = dataclasses.replace(TTE.TINY_TEST, num_layers=1,
                              vocab_size=max(tokenizer.vocab_size, 128))
    gen = torch.Generator().manual_seed(4)
    enc = FrozenEncoders(tokenizer, cfg, TTE.init_text_encoder(gen, cfg),
                         TV.VIT_TEST, TV.init_vit(gen, TV.VIT_TEST))
    enc.tokenizer.save(d / "tokenizer.json")
    save_params(str(d / "text_encoder.pt"), enc.text_params)
    (d / "text_encoder_config.json").write_text(json.dumps(
        dataclasses.asdict(enc.text_cfg)))
    save_params(str(d / "vit.pt"), enc.vit_params)
    (d / "vit_config.json").write_text(json.dumps(
        dataclasses.asdict(enc.vit_cfg)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from mmd_tpu.core.config import ModelConfig as JModelConfig
    from mmd_tpu_torch.models.fusion import init_fusion_params
    root = tmp_path_factory.mktemp("parallel_serving")
    tok_path = root / "tokenizer.json"
    WordPieceTokenizer.train(TEXTS * 4, 300).save(tok_path)
    both = {f: _encoders(f, tok_path) for f in FAMILIES}
    jencs = {f: j for f, (j, _) in both.items()}
    encs = {f: t for f, (_, t) in both.items()}
    jcfg = JModelConfig(**MODEL)
    cfg = ModelConfig(**MODEL)
    jfusion = _seeded_tree(init_fusion_params(
        torch.Generator().manual_seed(3), cfg), 3)
    fusion = bridge.fusion_from_jax(jfusion, cfg).state_dict()
    img_dir = root / "imgs"
    img_dir.mkdir()
    paths = _write_images(img_dir)
    single = ImageCorpus(root / "store", cfg=RESNET_TEST, device="cpu")
    single.create_feature_corpus(paths, batch_size=4)
    query = single.extract_features(paths[3])[None]
    assets = root / "assets"
    assets.mkdir()
    _write_cli_assets(assets, encs["bert"].tokenizer)
    job = dict(model=MODEL, encoders=encs, fusion=fusion,
               images=paths[:2], store=str(root / "store"), query=query,
               assets=str(assets))
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(job,), timeout_s=600)
    return dict(job=job, outs=outs, jencs=jencs, jfusion=jfusion,
                jcfg=jcfg, cfg=cfg, single=single, root=root)


@pytest.fixture(scope="module")
def single_device(world):
    """The port's single-device predictor's embeddings and results."""
    with torch.no_grad():
        return {f: _serve(MisinformationPredictor(
            world["cfg"], fusion_params=world["job"]["fusion"],
            encoders=enc, max_length=MAX_LEN, batch_size=BATCH,
            device="cpu"), world["job"]["images"])
            for f, enc in world["job"]["encoders"].items()}


def _probs(results) -> np.ndarray:
    return np.array([[list(r[p]["probabilities"].values()) if r[p] else
                      [np.nan] * 3 for p in r] for r in results])


def _labels(results) -> list:
    return [{p: (r[p] or {}).get("label") for p in r} for r in results]


@pytest.mark.parametrize("mp", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_predictor_serves_single_device_labels(world, single_device, family,
                                               mode, mp):
    want_emb, want = single_device[family]
    tol = RING_TOL if mode == "sp_ring" else TOL
    for rank, out in enumerate(world["outs"]):
        emb, got = out[family, mode, mp]
        np.testing.assert_allclose(emb.numpy(), want_emb.numpy(), **tol,
                                   err_msg=f"rank {rank}")
        assert _labels(got) == _labels(want)
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=PROB_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_encoders_serve_single_device_after_serving_split(world,
                                                          single_device,
                                                          family):
    """One FrozenEncoders, handed to a predictor in every mode on every
    mesh (tp and pp among them), then to a single-device predictor: the
    split predictors worked on copies, so the last serves the
    single-device embeddings and labels."""
    want_emb, want = single_device[family]
    for rank, out in enumerate(world["outs"]):
        emb, got = out[family, "after"]
        np.testing.assert_allclose(emb.numpy(), want_emb.numpy(), **TOL,
                                   err_msg=f"rank {rank}")
        assert _labels(got) == _labels(want)
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=PROB_TOL)


@pytest.mark.parametrize("family,mode", JAX_MODES)
def test_predictor_matches_jax(world, family, mode):
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    from mmd_tpu.inference.predictor import (
        MisinformationPredictor as JPredictor)
    jenc = copy.copy(world["jencs"][family])
    mesh = jax_mesh(jax.devices()[:WORLD], model_parallel=2)
    pred = JPredictor(world["jcfg"], fusion_params=world["jfusion"],
                      encoders=jenc, max_length=MAX_LEN, batch_size=BATCH,
                      mesh=mesh, text_parallelism=mode)
    want_emb, want = _serve(pred, world["job"]["images"])
    emb, got = world["outs"][0][family, mode, 2]
    np.testing.assert_allclose(emb.numpy(), want_emb.numpy(), **JAX_TOL)
    assert _labels(got) == _labels(want)
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                               atol=JAX_PROB_TOL)


@pytest.mark.parametrize("mp", MESHES)
def test_mesh_lays_the_ranks_out_as_the_jax_grid(world, mp):
    """Rank r sits where the JAX package's make_mesh puts device r:
    np.asarray(devices).reshape(n // mp, mp); shard_batch gives each rank
    its data row's rows."""
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    ids = np.vectorize(lambda d: d.id)(
        jax_mesh(jax.devices()[:WORLD], model_parallel=mp).devices)
    for r, out in enumerate(world["outs"]):
        shape, di, mi, col, row, rows = out["mesh", mp]
        assert shape == {"data": WORLD // mp, "model": mp}
        assert ids[di, mi] == r
        assert row == ids[di].tolist() and col == ids[:, mi].tolist()
        n = 8 // (WORLD // mp)
        assert rows == list(range(di * n, (di + 1) * n))


def test_predictor_requires_a_mesh(world):
    enc = world["job"]["encoders"]["bert"]
    with pytest.raises(ValueError, match="requires a mesh"):
        MisinformationPredictor(world["cfg"], encoders=enc,
                                text_parallelism="pp", device="cpu")
    with pytest.raises(ValueError, match="unknown text parallelism"):
        MisinformationPredictor(world["cfg"], encoders=enc, device="cpu",
                                mesh=SimpleNamespace(device="cpu"),
                                text_parallelism="dp")


def test_cli_over_the_world_prints_the_single_device_labels(world):
    from mmd_tpu_torch import evaluate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main(CLI_ARGS + ["--assets", world["job"]["assets"]])
    outs = [out["cli"] for out in world["outs"]]
    assert outs[0] == buf.getvalue() and "final:" in outs[0]
    assert outs[1:] == [""] * (WORLD - 1)       # only rank 0 prints


def test_cli_refuses_a_launch_it_cannot_serve(monkeypatch, world):
    from mmd_tpu_torch import evaluate
    args = CLI_ARGS + ["--assets", world["job"]["assets"],
                       "--text_parallelism", "sp"]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        evaluate.main(args)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        evaluate.main(args + ["--dist_backend", "nccl"])


@pytest.mark.parametrize("mp", MESHES)
@pytest.mark.parametrize("axis", ["data", "model"])
def test_sharded_topk_matches_dense_in_tie_order(world, axis, mp):
    from mmd_tpu.ops.topk import dense_topk as jax_dense_topk
    q, corpus = _topk_corpus()
    want_s, want_i = T.dense_topk(q, corpus, TOPK_K)
    _, jax_i = jax_dense_topk(q.numpy(), corpus.numpy(), TOPK_K)
    assert want_i[0, :2].tolist() == [5, 17]     # the tie, lower first
    for out in world["outs"]:
        s, i = out["topk", axis, mp]
        assert i.tolist() == want_i.tolist() == np.asarray(jax_i).tolist()
        np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=0,
                                   atol=1e-6)


def test_sharded_topk_validates_divisibility():
    mesh = SimpleNamespace(shape={"data": 4, "model": 1},
                           axis_index=lambda axis: 0)
    with pytest.raises(ValueError, match="must divide"):
        T.make_sharded_topk(mesh, "data", 10, 2)


@pytest.mark.parametrize("mp", MESHES)
def test_sharded_image_corpus_matches_single(world, mp):
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    from mmd_tpu.models.resnet import RESNET_TEST as JRESNET_TEST
    from mmd_tpu.retrieval.image import ImageCorpus as JCorpus
    q = world["job"]["query"]
    want = world["single"].retrieve_by_features(q, top_k=4)[0]
    # retrieval reads the store only: no ResNet params needed
    jax_corpus = JCorpus(world["job"]["store"], cfg=JRESNET_TEST,
                         resnet_params={},
                         mesh=jax_mesh(jax.devices()[:WORLD], 1))
    jax_want = jax_corpus.retrieve_by_features(q, top_k=4)[0]
    assert [p for p, _ in want] == [p for p, _ in jax_want]
    for out in world["outs"]:
        got = out["corpus", mp][0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b), (_, c) in zip(got, want, jax_want):
            assert a == pytest.approx(b, abs=1e-6)
            assert a == pytest.approx(c, abs=1e-2)


def test_image_corpus_int8_is_single_device(tmp_path):
    with pytest.raises(ValueError, match="single-device"):
        ImageCorpus(tmp_path, cfg=RESNET_TEST, int8=True, device="cpu",
                    mesh=SimpleNamespace(device="cpu"))


def _rank_raises(rank, world, dev):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def _rank_hangs(rank, world, dev):
    if rank == 1:
        time.sleep(120)
    return rank


def test_a_failing_or_hanging_rank_fails_the_world_in_bounded_time():
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        spawn(_rank_raises, 2, "gloo", "cpu", timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ran past"):
        spawn(_rank_hangs, 2, "gloo", "cpu", timeout_s=4)
    assert time.monotonic() - t0 < 60
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        spawn(_rank_raises, 2, "nccl", "cpu")


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world["outs"])
