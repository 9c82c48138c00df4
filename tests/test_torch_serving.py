"""The port's serving path (mmd_tpu_torch/inference) against the JAX package.

The slice as a whole: one set of JAX encoder and fusion params, carried
into the port by the bridge, serves the same (claim, evidence) pairs —
real PNG files, a corrupt file and missing images — through both
packages' MisinformationPredictor.evaluate_batch. Widths reach the
attention kernel (head dim 32; the JAX side runs its Pallas kernel in
interpret mode). Labels and None-paths must be identical and the
probabilities within 1e-4. (tests/test_torch_reference_serving.py does the
same with the reference's own encoder families.)
"""

import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.data.tokenizer import WordPieceTokenizer
from mmd_tpu.inference.predictor import (
    MisinformationPredictor as JPredictor,
)
from mmd_tpu.models import fusion as jfusion
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.frozen import FrozenEncoders as JEncoders
from mmd_tpu.models.transformer import TransformerConfig as JTransformerConfig
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer as TWordPiece
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.models import deberta as tdeberta
from mmd_tpu_torch.models import frozen as tfrozen
from mmd_tpu_torch.models import swin as tswin
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CORPUS = [f"claim {i} says the river {w} rose by {i} metres near town {i % 4}"
          for i, w in enumerate(["quickly", "slowly", "again", "never"] * 3)]
LABELS = {"support", "not_enough_information", "refute"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_png(path, seed, size=(48, 40)):
    from PIL import Image
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return str(path)


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """(JAX predictor, port predictor, image dir) over the same params."""
    tok = WordPieceTokenizer.train(CORPUS, 200)
    text_cfg = JTransformerConfig(
        vocab_size=max(tok.vocab_size, 128), hidden_size=64, num_layers=2,
        num_heads=2, intermediate_size=128, max_position=64,
        compute_dtype="float32")
    vit_cfg = jvit.ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                             num_layers=2, num_heads=2, intermediate_size=128,
                             compute_dtype="float32")
    kw = dict(text_input_dim=64, image_input_dim=64, embed_dim=64,
              num_heads=2, hidden_dim=16, compute_dtype="float32",
              fused_attn=True)
    text_tree = _np_tree(jte.init_text_encoder(jax.random.key(0), text_cfg))
    vit_tree = _np_tree(jvit.init_vit(jax.random.key(1), vit_cfg))
    fusion_tree = _np_tree(jfusion.init_fusion_params(
        jax.random.key(2), JModelConfig(**kw)))

    jpred = JPredictor(JModelConfig(**kw), fusion_params=fusion_tree,
                       encoders=JEncoders(tok, text_cfg, text_tree, vit_cfg,
                                          vit_tree),
                       max_length=32, batch_size=4)
    ptext = TransformerConfig(**dataclasses.asdict(text_cfg))
    pvit = tvit.ViTConfig(**dataclasses.asdict(vit_cfg))
    enc = tfrozen.FrozenEncoders(
        TWordPiece(tok.vocab), ptext,
        bridge.text_encoder_from_jax(text_tree, ptext),
        pvit, bridge.vit_from_jax(vit_tree, pvit))
    cfg = ModelConfig(**kw)
    tpred = MisinformationPredictor(
        cfg, fusion_params=bridge.fusion_from_jax(fusion_tree, cfg).state_dict(),
        encoders=enc, max_length=32, batch_size=4, device="cpu")
    img_dir = tmp_path_factory.mktemp("slice_images")
    return jpred, tpred, img_dir


def test_evaluate_batch_matches_jax(slice_pair):
    _check_evaluate_batch(*slice_pair)


def _check_evaluate_batch(jpred, tpred, d):
    imgs = [_write_png(d / f"img{i}.png", i) for i in range(4)]
    corrupt = d / "corrupt.png"
    corrupt.write_bytes(b"not an image")
    missing = str(d / "missing.png")
    claims = [CORPUS[i] for i in range(6)]
    evidence = [CORPUS[i + 5] + " and more detail" for i in range(6)]
    claim_imgs = [imgs[0], None, imgs[1], missing, imgs[2], str(corrupt)]
    ev_imgs = [imgs[3], imgs[1], None, imgs[0], missing, imgs[2]]

    want = jpred.evaluate_batch(claims, claim_imgs, evidence, ev_imgs,
                                detailed=True)
    got = tpred.evaluate_batch(claims, claim_imgs, evidence, ev_imgs,
                               detailed=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for path in g:
            assert (g[path] is None) == (w[path] is None), path
            if g[path] is None:
                continue
            assert g[path]["label"] == w[path]["label"]
            for label, p in g[path]["probabilities"].items():
                assert p == pytest.approx(w[path]["probabilities"][label],
                                          abs=1e-4)
    # the image paths that exist and decode are the only ones served
    assert [r["image_text"] is not None for r in got] == [
        True, False, True, False, True, False]
    assert [r["text_image"] is not None for r in got] == [
        True, True, False, True, False, True]


def test_evaluate_single_pair_matches_jax(slice_pair):
    jpred, tpred, d = slice_pair
    img = _write_png(d / "single.png", 11)
    want = jpred.evaluate(CORPUS[1], img, CORPUS[2], None)
    got = tpred.evaluate(CORPUS[1], img, CORPUS[2], None)
    assert got == want                      # labels, None-paths


def test_tokenizer_matches_jax(tmp_path):
    """Same vocabulary from the same corpus, same ids (non-ASCII and pairs
    included), and each package loads the other's tokenizer.json."""
    corpus = CORPUS + ["Café naïve — ÉTÉ 2024!", "river rose, again?"]
    jtok = WordPieceTokenizer.train(corpus, 120)
    ttok = TWordPiece.train(corpus, 120)
    assert ttok.vocab == jtok.vocab
    texts = corpus[-3:] + ["unseen wording entirely", ""]
    for got, want in zip(ttok.encode_batch(texts, max_length=24),
                         jtok.encode_batch(texts, max_length=24)):
        np.testing.assert_array_equal(got, want)
    pairs = [t[::-1] for t in texts]
    for got, want in zip(ttok.encode_batch(texts, pairs, max_length=24),
                         jtok.encode_batch(texts, pairs, max_length=24)):
        np.testing.assert_array_equal(got, want)
    jtok.save(tmp_path / "j.json")
    ttok.save(tmp_path / "t.json")
    assert TWordPiece.load(tmp_path / "j.json").vocab == jtok.vocab
    assert WordPieceTokenizer.load(tmp_path / "t.json").vocab == ttok.vocab
    assert ttok.decode(ttok.encode(texts[0])[0]) == jtok.decode(
        jtok.encode(texts[0])[0])


# -- ServingEngine ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_predictor(tmp_path_factory):
    assets = tmp_path_factory.mktemp("assets_srv")
    enc = tfrozen.load_or_init_frozen(
        assets, vocab_texts=["claim evidence text"], vocab_size=300,
        tiny=True)
    cfg = ModelConfig(text_input_dim=enc.text_cfg.hidden_size,
                      image_input_dim=enc.vit_cfg.hidden_size,
                      embed_dim=32, num_heads=4, hidden_dim=16,
                      compute_dtype="float32")
    # max_length within TINY_TEST's 64 positions (JAX clamps the position
    # lookup past its table; the port refuses it)
    return MisinformationPredictor(cfg, encoders=enc, batch_size=4,
                                   max_length=64, device="cpu")


def test_serving_engine_batches_and_matches_direct(tiny_predictor):
    from mmd_tpu_torch.inference.server import ServingEngine

    n = 7                                     # not a multiple of max_batch
    claims = [f"claim number {i} about topic {i % 3}" for i in range(n)]
    evs = [f"evidence text {i} with details" for i in range(n)]
    direct = tiny_predictor.evaluate_batch(
        claims, [None] * n, evs, [None] * n, detailed=True)

    eng = ServingEngine(tiny_predictor, max_batch=4, max_wait_ms=50.0)
    try:
        futures = [eng.submit(claims[i], None, evs[i], None, detailed=True)
                   for i in range(n)]
        results = [f.result(timeout=120) for f in futures]
    finally:
        eng.close()

    for got, want in zip(results, direct):
        assert set(got) == set(want)
        for path in got:
            if want[path] is None:
                assert got[path] is None
            else:
                assert got[path]["label"] == want[path]["label"]
                assert got[path]["confidence"] == pytest.approx(
                    want[path]["confidence"], rel=1e-6)

    st = eng.stats()
    assert st["served"] == n
    assert st["batches"] == 2                 # 4 + 3(padded to 4)
    assert st["padded_rows"] == 1
    assert st["latency_p50_ms"] > 0


def test_serving_engine_concurrent_submitters(tiny_predictor):
    from mmd_tpu_torch.inference.server import ServingEngine

    eng = ServingEngine(tiny_predictor, max_batch=4, max_wait_ms=20.0)
    results = {}
    lock = threading.Lock()

    def client(i):
        out = eng.evaluate(f"concurrent claim {i}", None,
                           f"concurrent evidence {i}", None)
        with lock:
            results[i] = out

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        eng.close()

    assert not any(t.is_alive() for t in threads)
    assert len(results) == 8
    for out in results.values():
        assert out["text_text"] in LABELS
        assert out["image_image"] is None     # no images were sent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("x", None, "y", None)


def test_encode_images_takes_uint8_batches(tiny_predictor):
    """The split-out device step: uint8 arrays in, embeddings out, the
    same as decoding the same pixels from files."""
    rng = np.random.default_rng(0)
    size = tiny_predictor.enc.vit_cfg.image_size
    u8 = rng.integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    with torch.inference_mode():
        emb = tiny_predictor.encode_images(u8)
    assert emb.shape == (5, tiny_predictor.enc.vit_cfg.num_tokens,
                         tiny_predictor.enc.vit_cfg.hidden_size)
    assert torch.isfinite(emb).all()
    res = tiny_predictor.evaluate_arrays(
        ["a claim"] * 5, u8, np.ones(5, bool), ["some evidence"] * 5, u8,
        np.ones(5, bool), detailed=True)
    assert all(r["image_image"]["label"] in LABELS for r in res)


# -- entry points and refusals -----------------------------------------------

def test_evaluate_cli_on_cpu(tmp_path):
    """python -m mmd_tpu_torch.evaluate --device cpu on small assets: a
    tokenizer and a small ViT config sidecar; the text encoder is the
    full-width default."""
    TWordPiece.train(CORPUS, 200).save(tmp_path / "tokenizer.json")
    (tmp_path / "vit_config.json").write_text(
        '{"image_size": 32, "patch_size": 8, "hidden_size": 64, '
        '"num_layers": 1, "num_heads": 2, "intermediate_size": 128}')
    img = _write_png(tmp_path / "claim.png", 3)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "mmd_tpu_torch.evaluate", "--device", "cpu",
         "--assets", str(tmp_path), "--image_input_dim", "64",
         "--claim_text", CORPUS[0], "--evidence_text", CORPUS[3],
         "--claim_image", img, "--detailed"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stderr
    final = res.stdout.strip().splitlines()[-1]
    assert final.split(": ")[1] in LABELS
    assert '"image_text": {' in res.stdout and '"image_image": null' in \
        res.stdout


def test_cuda_device_without_card_raises(monkeypatch, tiny_predictor):
    from mmd_tpu_torch import evaluate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MisinformationPredictor(tiny_predictor.cfg,
                                encoders=tiny_predictor.enc, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--claim_text", "a", "--evidence_text", "b",
                       "--device", "cuda"])


@pytest.mark.parametrize("ckpt", ["deberta.ckpt", "swinv2.ckpt",
                                  "text_encoder.ckpt", "vit.ckpt",
                                  "spm.json"])
def test_load_or_init_frozen_refuses_checkpoints(tmp_path, ckpt):
    """An orbax <name>.ckpt with no <name>.pt beside it raises and names
    the conversion script; an unreadable spm.json raises. Neither gives
    way to a seeded encoder or a trained tokenizer."""
    (tmp_path / ckpt).mkdir()
    match = (rf"{ckpt}.*orbax_to_torch" if ckpt.endswith(".ckpt")
             else ckpt)
    with pytest.raises(OSError, match=match):
        tfrozen.load_or_init_frozen(tmp_path, vocab_texts=CORPUS)


def test_load_or_init_frozen_refuses_reference_families(tmp_path):
    """The reference families' orbax checkpoints, which the JAX package
    loads ahead of its seeded init, raise without their .pt files rather
    than give way to the seeded families; `tiny` ignores them there and
    here."""
    (tmp_path / "deberta.ckpt").mkdir()
    (tmp_path / "swinv2.ckpt").mkdir()
    with pytest.raises(FileNotFoundError, match="deberta.ckpt"):
        tfrozen.load_or_init_frozen(tmp_path, vocab_texts=CORPUS,
                                    reference_families=True)
    (tmp_path / "deberta.ckpt").rmdir()
    with pytest.raises(FileNotFoundError, match="swinv2.ckpt"):
        tfrozen.load_or_init_frozen(tmp_path, vocab_texts=CORPUS,
                                    reference_families=True)
    tiny = tfrozen.load_or_init_frozen(tmp_path, vocab_texts=CORPUS,
                                       tiny=True, reference_families=True)
    assert isinstance(tiny.text_cfg, TransformerConfig)


def test_load_or_init_frozen_resolves_reference_families(tmp_path):
    """reference_families=True seeds the reference's own encoder families
    (tests/test_encoders.py's resolver test), and `tiny` ignores it."""
    enc = tfrozen.load_or_init_frozen(tmp_path, vocab_texts=CORPUS,
                                      vocab_size=300, reference_families=True)
    assert isinstance(enc.text_cfg, tdeberta.DebertaConfig)
    assert isinstance(enc.vit_cfg, tswin.SwinConfig)
    assert enc.text_cfg.vocab_size >= 128
    assert enc.text_cfg.compute_dtype == "bfloat16"
    assert enc.vit_cfg.num_tokens == 64 and enc.vit_cfg.hidden_size == 1024
    assert enc.text_params["embeddings"]["word"].shape == (
        enc.text_cfg.vocab_size, 384)
    tiny = tfrozen.load_or_init_frozen(tmp_path, tiny=True,
                                       reference_families=True)
    assert isinstance(tiny.text_cfg, TransformerConfig)
    assert isinstance(tiny.vit_cfg, tvit.ViTConfig)


def test_predictor_checkpoint_path_raises(tiny_predictor):
    """A fusion checkpoint that is not there raises; the seeded head is
    not served in its place."""
    with pytest.raises(FileNotFoundError, match="ckpt"):
        MisinformationPredictor(tiny_predictor.cfg, checkpoint_path="ckpt",
                                encoders=tiny_predictor.enc, device="cpu")


def test_synthetic_traffic_is_seeded(tmp_path):
    """The traffic chip_smoke.py and profile_serve.py send: one seed gives
    the same texts, from two words to beyond the 512-token window, and PNG
    files of 200-400 px a side that the predictor decodes."""
    from PIL import Image

    from mmd_tpu_torch.inference.traffic import corpus, write_images

    texts = corpus(np.random.default_rng(0), 16)
    assert texts == corpus(np.random.default_rng(0), 16)
    lengths = [len(t.split()) for t in texts]
    assert lengths[0] == 2 and lengths[-1] == 700 and lengths == sorted(lengths)
    paths = write_images(tmp_path, np.random.default_rng(1), 3)
    for p in paths:
        with Image.open(p) as im:
            assert im.mode == "RGB" and all(200 <= s < 400 for s in im.size)
