"""The port's fused device-resident pipeline (pipelines/fused.py) against the
JAX package's, on the CPU.

One synthetic tree (24 train and 8 test rows, some images missing), the
same tokenizer file, the JAX package's tiny encoders (TINY_TEST, VIT_TEST,
fp32), captioner (CAPTIONER_TEST), ResNet (RESNET_TEST) and fusion params
carried into the port through bridge.py. Ingest chunks of 8 rows, fewer
than the split's, so the staging buffers are refilled. Tolerances:
  * bank columns, ids, paths, skipped rows, captions, the enriched CSV,
    the bank window against the port's plain steps: exact;
  * the embed bank's vis columns against JAX's chunk embed: 1e-5 (fp32
    sums in another order through two ViT layers);
  * the bank window against JAX's at dropout 0, fp32: losses 1e-5
    relative, params 2e-5 relative plus 1e-6 (tests/test_fused.py's),
    but for the attention key biases, whose exact gradient is 0 (AdamW
    turns each package's rounding noise into steps of up to lr): within
    K lr of their start;
  * the embed bank against the raw bank through the window: 1e-4 / 1e-5
    (tests/test_fused.py's: the ViT at another batch size);
  * eval metrics: 1e-9 (the same predictions);
  * ResNet corpus features: 2e-2 (a bf16 network; they are 0.05-0.4
    apart between images);
  * resize_bilinear against jax.image.resize: floats within 1e-5 of the
    255 range, and after round and clip within one uint8 level.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn.functional as Fn

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.core.config import TrainConfig as JTrainConfig
from mmd_tpu.core.mesh import make_mesh
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import captioner as JC
from mmd_tpu.models import frozen as JF
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.fusion import init_fusion_params as j_init_fusion
from mmd_tpu.pipelines import caption as JCAP
from mmd_tpu.pipelines import fused as JFU
from mmd_tpu.training import trainer as JT
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import captioner as TC
from mmd_tpu_torch.models import frozen as TF
from mmd_tpu_torch.models import resnet as TRN
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.ops.image_ops import resize_bilinear, resize_uint8
from mmd_tpu_torch.pipelines import caption as TCAP
from mmd_tpu_torch.pipelines import fused as TFU
from mmd_tpu_torch.pipelines import raw_store as TR
from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
from mmd_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

N_TRAIN, N_TEST, CHUNK, MAX_LEN, SIZE = 24, 8, 8, 24, 32
RESIZE_TOL = 1e-5 * 255
CLAMP_CAP, CLAMP_B = 20, 12          # a bank cut to 20 rows, blocks of 12
KEY_BIASES = {"['cross_attn']['image_evidence_key']['b']",
              "['cross_attn']['text_evidence_key']['b']",
              "['representation']['image_WK']['b']",
              "['representation']['text_WK']['b']"}
DIMS = dict(embed_dim=32, num_heads=4, hidden_dim=16,
            compute_dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tree, both packages' encoders with the same params, and each
    package's raw-image bank of the train split; MMD_TPU_ROOT points at
    the tree while the module runs."""
    root = tmp_path_factory.mktemp("fused")
    synthetic_factify_tree(root, n_train=N_TRAIN, n_test=N_TEST, seed=3)
    train_csv = preprocess_csv("train", root)
    test_csv = preprocess_csv("test", root)
    df = pd.read_csv(train_csv)
    texts = df[["claim", "evidence"]].stack().astype(str).tolist()
    JTokenizer.train(texts, 200).save(root / "tok.json")
    jtok = JTokenizer.load(root / "tok.json")
    ttok = WordPieceTokenizer.load(root / "tok.json")
    jtc = dataclasses.replace(jte.TINY_TEST,
                              vocab_size=max(jtok.vocab_size, 128))
    ttc = te.TransformerConfig(**dataclasses.asdict(jtc))
    tp = jte.init_text_encoder(jax.random.key(1), jtc)
    vp = jvit.init_vit(jax.random.key(2), jvit.VIT_TEST)
    jenc = JF.FrozenEncoders(jtok, jtc, tp, jvit.VIT_TEST, vp)

    def port_enc():
        return TF.FrozenEncoders(
            ttok, ttc, bridge.text_encoder_from_jax(_np(tp), ttc),
            tvit.VIT_TEST, bridge.vit_from_jax(_np(vp), tvit.VIT_TEST))

    old = os.environ.get("MMD_TPU_ROOT")
    os.environ["MMD_TPU_ROOT"] = str(root)
    kw = dict(max_length=MAX_LEN, image_size=SIZE, chunk=CHUNK,
              io_workers=2, root=root)
    enc = port_enc()
    yield dict(root=root, train_csv=train_csv, test_csv=test_csv, jenc=jenc,
               enc=enc, port_enc=port_enc, kw=kw,
               jbank=JFU.ingest_split(train_csv, jenc, **kw),
               bank=TFU.ingest_split(train_csv, enc, device="cpu", **kw))
    if old is None:
        os.environ.pop("MMD_TPU_ROOT")
    else:
        os.environ["MMD_TPU_ROOT"] = old


# -- ingest ----------------------------------------------------------------


def test_ingest_matches_jax_and_the_raw_store(world):
    """Every column over the whole capacity, ids, paths and skipped rows
    equal JAX's exactly; the token, image and label columns equal the raw
    store of the same CSV."""
    bank, jbank = world["bank"], world["jbank"]
    assert 0 < bank.n == jbank.n < N_TRAIN > CHUNK
    assert bank.skipped == jbank.skipped == N_TRAIN - bank.n
    assert set(bank.data) == set(jbank.data) == set(TFU.BANK_COLS)
    for col, t in bank.data.items():
        j = np.asarray(jbank.data[col])
        assert t.shape == j.shape == (N_TRAIN + CHUNK, *j.shape[1:]), col
        np.testing.assert_array_equal(t.numpy(), j, err_msg=col)
    np.testing.assert_array_equal(bank.ids, jbank.ids)
    assert bank.claim_paths == jbank.claim_paths
    assert bank.doc_paths == jbank.doc_paths
    assert bank.h2d_bytes == sum(
        t.element_size() * t[:CHUNK].numel() for t in bank.data.values()
    ) * -(-bank.n // CHUNK)
    store = TR.build_raw_store(str(world["train_csv"]),
                               world["enc"].tokenizer, max_length=MAX_LEN,
                               image_size=SIZE, batch_size=5, io_workers=2)
    np.testing.assert_array_equal(store.col("id"), bank.ids)
    for col in TR.TRAIN_COLUMNS:
        np.testing.assert_array_equal(bank.data[col][:bank.n].numpy(),
                                      store.col(col), err_msg=col)


def test_on_chunk_gets_copies_of_the_staging_buffers(world):
    """A hook that keeps every chunk it is handed still holds the right
    images after ingest has refilled the staging buffers: chunks are
    copied out of them (a tensor made from a numpy buffer on the CPU IS
    the buffer). Both the streamed (keep_images=False) and the banked
    images."""
    bank = world["bank"]
    for keep in (False, True):
        kept = []
        b2 = TFU.ingest_split(world["train_csv"], world["enc"],
                              keep_images=keep, device="cpu",
                              on_chunk=lambda imgs, s, n: kept.append(
                                  (s, n, imgs)), **world["kw"])
        assert ("claim_image" in b2.data) is keep
        assert [s for s, _, _ in kept] == list(range(0, bank.n, CHUNK))
        for start, n, imgs in kept:
            for kind in ("claim", "doc"):
                got = imgs[kind]
                assert got.shape[0] == CHUNK
                want = bank.data[f"{kind}_image"][start:start + CHUNK]
                assert torch.equal(got, want), (keep, start, kind)


@pytest.fixture(scope="module")
def ebank(world):
    """The port's embed bank of the train split, fp32."""
    return TFU.ingest_split(world["train_csv"], world["enc"],
                            embed_images=True, vis_dtype="float32",
                            device="cpu", **world["kw"])


def test_embed_bank_vis_matches_jax(world, ebank):
    """embed_images banks the frozen ViT's output in place of the images:
    the vis columns against JAX's embed bank and JAX's _make_chunk_embed
    over the raw bank's images, fp32, 1e-5."""
    jebank = JFU.ingest_split(world["train_csv"], world["jenc"],
                              embed_images=True, vis_dtype="float32",
                              **world["kw"])
    assert "claim_image" not in ebank.data and "doc_image" not in ebank.data
    assert TFU.vis_embed_shape(world["enc"], SIZE) == JFU.vis_embed_shape(
        world["jenc"], SIZE) == tuple(ebank.data["claim_vis"].shape[1:])
    assert ebank.data["claim_vis"].dtype == torch.float32
    embed = JFU._make_chunk_embed(world["jenc"], "float32", sub=8)
    for col in ("claim_ids", "doc_mask", "labels"):
        assert torch.equal(ebank.data[col], world["bank"].data[col])
    for vcol, icol in (("claim_vis", "claim_image"),
                       ("doc_vis", "doc_image")):
        got = ebank.data[vcol].numpy()
        np.testing.assert_allclose(got, np.asarray(jebank.data[vcol]),
                                   rtol=1e-5, atol=1e-5, err_msg=vcol)
        want = np.asarray(embed(world["jenc"].vit_params,
                                world["jbank"].data[icol][:16]))
        np.testing.assert_allclose(got[:16], want, rtol=1e-5, atol=1e-5)


# -- training and eval -----------------------------------------------------


def _model(enc, **kw):
    return ModelConfig(text_input_dim=enc.text_cfg.hidden_size,
                       image_input_dim=enc.vit_cfg.hidden_size,
                       **{**DIMS, **kw})


def _port_trainer(world, tmp_path, epochs=1, **model_kw):
    cfg = TrainConfig(model=_model(world["enc"], **model_kw), batch_size=4,
                      lr=1e-3, epochs=epochs, save_every=0,
                      output_dir=str(tmp_path))
    return TT.Trainer(cfg, device="cpu", encoders=world["enc"])


def test_window_equals_plain_port_steps(world, tmp_path):
    """K steps of the bank window (dropout 0.1) against K plain steps on
    host-gathered batches of the same rows: losses, preds and params bit
    for bit (the same step generators)."""
    trainer = _port_trainer(world, tmp_path, dropout=0.1)
    bank = world["bank"]
    k, b = 3, 4
    idx = np.random.default_rng(0).permutation(bank.n)[:k * b].reshape(k, b)
    window = TFU.make_bank_window(trainer.cfg, world["enc"], k)
    sw, aux = window(trainer.init(), bank.data, torch.from_numpy(idx))
    state = trainer.init()
    host = {c: t.numpy() for c, t in bank.data.items()}
    for i in range(k):
        state, a = trainer.train_step(
            state, trainer.shard_batch({c: v[idx[i]]
                                        for c, v in host.items()}))
        assert torch.equal(aux["loss"][i], a["loss"]), i
        assert torch.equal(aux["preds"][i], a["preds"]), i
    assert sw.step == state.step == k
    for (name, p), q in zip(sw.params.named_parameters(),
                            state.params.parameters()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="window takes 3"):
        window(sw, bank.data, torch.from_numpy(idx[:2]))


def test_window_matches_jax(world, tmp_path):
    """The bank window against JAX's make_bank_window on each package's
    bank, same initial fusion params, dropout 0, fp32."""
    jenc, k = world["jenc"], 2
    jcfg = JTrainConfig(model=JModelConfig(
        text_input_dim=jenc.text_cfg.hidden_size,
        image_input_dim=jenc.vit_cfg.hidden_size, dropout=0.0, **DIMS),
        batch_size=4, lr=1e-3, epochs=1, save_every=0)
    jtrainer = JT.Trainer(jcfg, make_mesh(jax.devices()[:1]), encoders=jenc)
    j0 = jtrainer.init()
    p0 = _np(j0.params)
    idx = (np.arange(k * 4, dtype=np.int32).reshape(k, 4) * 3) % \
        world["bank"].n
    frozen = {"text": jenc.text_params, "vit": jenc.vit_params}
    js, jaux = JFU.make_bank_window(jcfg, jenc, k)(
        j0, frozen, world["jbank"].data, jnp.asarray(idx))

    trainer = _port_trainer(world, tmp_path, dropout=0.0)
    state = trainer.init()
    state.params = bridge.fusion_from_jax(p0, trainer.cfg.model)
    state.optimizer = TT.make_optimizer(trainer.cfg, state.params)
    ts, taux = TFU.make_bank_window(trainer.cfg, world["enc"], k)(
        state, world["bank"].data, torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_allclose(taux["loss"].numpy(), np.asarray(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(taux["labels"].numpy(),
                                  np.asarray(jaux["labels"]))
    got, want = _flat(bridge.to_jax_tree(ts.params)), _flat(js.params)
    assert got.keys() == want.keys()
    init = _flat(p0)
    for name, w in want.items():
        if name in KEY_BIASES:
            # softmax ignores a bias shared by every key: the exact gradient
            # is 0, and AdamW scales each package's rounding noise up to a
            # step of up to lr
            for x in (got[name], w):
                assert np.abs(x - init[name]).max() <= k * 1e-3 * 1.01, name
            continue
        np.testing.assert_allclose(got[name], w, rtol=2e-5, atol=1e-6,
                                   err_msg=name)


def test_jax_bank_window_refuses_a_mesh_of_more_than_one_device(world):
    """The JAX fused flow is one device's: its bank is committed to
    jax.devices()[0] (mmd_tpu/pipelines/fused.py:250) and its Trainer
    replicates the state over the whole mesh, so over the default mesh
    of the conftest's 8 CPU devices its first bank window raises. The
    port's run_all --fused refuses a launch of more ranks before any stage
    (tests/test_torch_run_all_parallel.py)."""
    jenc = world["jenc"]
    assert len(jax.devices()) > 1
    jcfg = JTrainConfig(model=JModelConfig(
        text_input_dim=jenc.text_cfg.hidden_size,
        image_input_dim=jenc.vit_cfg.hidden_size, **DIMS),
        batch_size=len(jax.devices()), lr=1e-3, epochs=1, save_every=0)
    jtrainer = JT.Trainer(jcfg, make_mesh(), encoders=jenc)
    state = jtrainer.init()
    bank = world["jbank"].data
    assert all(x.devices() == {jax.devices()[0]} for x in bank.values())
    idx = jnp.arange(jcfg.batch_size, dtype=jnp.int32)[None] % world["jbank"].n
    frozen = {"text": jenc.text_params, "vit": jenc.vit_params}
    with pytest.raises(ValueError, match="incompatible devices"):
        JFU.make_bank_window(jcfg, jenc, 1)(state, frozen, bank, idx)


def test_embed_bank_equals_raw_bank_in_window_and_eval(world, ebank,
                                                       tmp_path):
    bank = world["bank"]
    trainer = _port_trainer(world, tmp_path, dropout=0.0)
    window = TFU.make_bank_window(trainer.cfg, world["enc"], 2)
    idx = torch.arange(8).reshape(2, 4)
    s_r, a_r = window(trainer.init(), bank.data, idx)
    s_e, a_e = window(trainer.init(), ebank.data, idx)
    np.testing.assert_allclose(a_e["loss"].numpy(), a_r["loss"].numpy(),
                               rtol=1e-4)
    for (name, p), q in zip(s_r.params.named_parameters(),
                            s_e.params.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    m_r = TFU.evaluate_from_bank(bank, world["enc"], trainer.cfg.model,
                                 s_r.params, batch_size=4)
    m_e = TFU.evaluate_from_bank(ebank, world["enc"], trainer.cfg.model,
                                 s_r.params, batch_size=4)
    assert m_r.keys() == m_e.keys()
    for key in m_r:
        assert abs(m_e[key] - m_r[key]) < 1e-9, key


def test_train_from_bank_schedule_and_final_model(world, tmp_path):
    """train_from_bank: JAX's schedule (seeded permutations, whole windows,
    a window shrunk to a small bank), final_model.pt holds the params."""
    trainer = _port_trainer(world, tmp_path, epochs=2, dropout=0.1)
    bank = world["bank"]
    state = TFU.train_from_bank(trainer, bank, steps_per_call=2,
                                log_every=1)
    windows = bank.n // 8
    assert state.step == 2 * 2 * windows
    saved = torch.load(tmp_path / "final_model.pt", weights_only=True)
    for name, p in state.params.state_dict().items():
        assert torch.equal(saved[name], p), name
    # a bank smaller than b * k: k = n // b, as in the JAX package
    small = dataclasses.replace(bank, n=6)
    trainer = _port_trainer(world, tmp_path, dropout=0.1)
    assert TFU.train_from_bank(trainer, small, steps_per_call=8).step == 1


def test_eval_streaming_and_from_bank_match_jax(world, tmp_path):
    jenc = world["jenc"]
    jmodel = JModelConfig(text_input_dim=jenc.text_cfg.hidden_size,
                          image_input_dim=jenc.vit_cfg.hidden_size, **DIMS)
    jparams = j_init_fusion(jax.random.key(0), jmodel)
    model = _model(world["enc"])
    params = bridge.fusion_from_jax(_np(jparams), model)
    kw = dict(batch_size=4, image_size=SIZE, max_length=MAX_LEN,
              io_workers=2, root=world["root"])
    want = JFU.evaluate_streaming(world["test_csv"], jenc, jmodel, jparams,
                                  **kw)
    got = TFU.evaluate_streaming(world["test_csv"], world["enc"], model,
                                 params, device="cpu",
                                 results_csv=str(tmp_path / "e.csv"), **kw)
    tb = TFU.ingest_split(world["test_csv"], world["enc"], device="cpu",
                          **{**world["kw"], "chunk": 4})
    assert 0 < tb.n < N_TEST and tb.n % 4          # a wrapped last window
    banked = TFU.evaluate_from_bank(tb, world["enc"], model, params,
                                    batch_size=4)
    assert got.keys() == want.keys() == banked.keys()
    assert "unified/accuracy" in got
    for key in want:
        assert abs(got[key] - want[key]) < 1e-9, key
        assert abs(banked[key] - want[key]) < 1e-9, key
    assert pd.read_csv(tmp_path / "e.csv")["path"].iloc[-1] == "unified"


# -- captions --------------------------------------------------------------


def _engines(world, batch):
    jtok = world["jenc"].tokenizer
    jcfg = dataclasses.replace(JC.CAPTIONER_TEST, decoder=dataclasses.replace(
        JC.CAPTIONER_TEST.decoder, vocab_size=jtok.vocab_size))
    tree = jax.jit(lambda key: JC.init_captioner(key, jcfg))(
        jax.random.key(21))
    tcfg = TC.config_from_dict(dataclasses.asdict(jcfg))
    je = JCAP.CaptionEngine(jtok, cfg=jcfg, params=tree, batch_size=batch)
    tengine = TCAP.CaptionEngine(
        world["enc"].tokenizer, cfg=tcfg,
        params=bridge.captioner_from_jax(_np(tree), tcfg), batch_size=batch,
        device="cpu")
    return je, tengine


@pytest.mark.parametrize("image_size", [SIZE, 48])
def test_bank_captioner_on_chunk_dispatch_bank_and_jax(world, image_size):
    """Captions streamed through the ingest hook equal dispatch_bank's over
    a banked split, and both equal JAX's; at 48 px the bank images are
    resized to the captioner's 32 px first."""
    je, tengine = _engines(world, 4)
    kw = {**world["kw"], "image_size": image_size}
    caps = {}
    for name, pkg, engine, extra in (
            ("jax", JFU, je, {}), ("port", TFU, tengine, {"device": "cpu"})):
        capt = pkg.BankCaptioner(engine, batch=4, bank_image_size=image_size)
        streamed = pkg.ingest_split(world["train_csv"],
                                    world["jenc" if name == "jax" else "enc"],
                                    keep_images=False,
                                    on_chunk=capt.on_chunk, **kw, **extra)
        caps[name] = capt.collect(streamed.n)
        banked = pkg.ingest_split(world["train_csv"],
                                  world["jenc" if name == "jax" else "enc"],
                                  **kw, **extra)
        capt.dispatch_bank(banked)
        assert capt.collect(banked.n) == caps[name], name
    assert caps["port"] == caps["jax"]
    assert len(caps["port"][0]) == world["bank"].n
    assert all(caps["port"][0]) and all(caps["port"][1])


def _trimmed(bank, cap=CLAMP_CAP):
    """The bank cut to a capacity of `cap` rows."""
    return dataclasses.replace(bank, data={k: v[:cap]
                                           for k, v in bank.data.items()})


def test_dispatch_bank_takes_the_rows_jax_clamps_to(world):
    """A 12-row block at row 12 of a 20-row capacity runs past its end: the
    JAX package's dynamic_slice starts it at row 8 and files its captions
    under rows 12-.. The port takes the same rows."""
    je, tengine = _engines(world, CLAMP_B)
    bank, jbank = _trimmed(world["bank"]), _trimmed(world["jbank"])
    assert CLAMP_B < bank.n and 2 * CLAMP_B > CLAMP_CAP
    caps = {}
    for name, pkg, engine, b in (("jax", JFU, je, jbank),
                                 ("port", TFU, tengine, bank)):
        capt = pkg.BankCaptioner(engine, batch=CLAMP_B, bank_image_size=SIZE)
        capt.dispatch_bank(b)
        caps[name] = capt.collect(b.n)
    assert caps["port"] == caps["jax"]
    # the clamped block's captions are those of the rows it started at
    start = CLAMP_CAP - CLAMP_B
    own = [tengine.tokenizer.decode(t) for t in tengine.generate_uint8(
        bank.data["claim_image"][start:CLAMP_CAP]).numpy()]
    assert caps["port"][0][CLAMP_B:] == own[:bank.n - CLAMP_B]


def test_write_enriched_csv_is_jax_byte_for_byte(world, tmp_path):
    bank = world["bank"]
    cc = [f"claim cap {i}" if i % 3 else "" for i in range(bank.n)]
    dc = [f"doc cap {i}" for i in range(bank.n)]
    df = pd.read_csv(world["train_csv"])
    got = TFU.write_enriched_csv(df, bank.ids, cc, dc, tmp_path / "p.csv")
    want = JFU.write_enriched_csv(df, world["jbank"].ids, cc, dc,
                                  tmp_path / "j.csv")
    assert got.read_bytes() == want.read_bytes()
    out = pd.read_csv(got)
    banked = out["id"].isin(set(map(int, bank.ids)))
    assert 0 < banked.sum() < len(out)
    assert out.loc[banked, "claim_enriched"].notna().all()
    assert out.loc[~banked, "evidence_image_caption"].isna().all()


# -- the image corpus ------------------------------------------------------


def _feats(path) -> np.ndarray:
    """The stored float16 features (not normalized: normalized, the rows
    of these seeded networks are nearly parallel, within 1.3e-2 of each
    other)."""
    return ArrayStore(path).col("features").astype(np.float32)


@pytest.mark.parametrize("batch", [4, CLAMP_B])
def test_image_corpus_hook_bank_and_jax(world, tmp_path, monkeypatch, batch):
    """BankResNetFeatures over the ingest chunks and
    build_image_corpus_from_bank against each other and against JAX's
    build_image_corpus_from_bank, the same ResNet params; at batch 12 of a
    20-row capacity the second block is clamped to start at row 8."""
    jparams, cfg = JFU._load_resnet(True, "unused")
    tparams = bridge.resnet_from_jax(_np(jparams), TRN.RESNET_TEST)
    monkeypatch.setattr(TFU, "_load_resnet", lambda tiny, assets: (
        tparams, TRN.RESNET_TEST))
    bank, jbank = world["bank"], world["jbank"]
    if batch == CLAMP_B:
        bank, jbank = _trimmed(bank), _trimmed(jbank)
    jax_c = JFU.build_image_corpus_from_bank(jbank, tmp_path / "j",
                                             tiny=True, batch=batch)
    port_c = TFU.build_image_corpus_from_bank(bank, tmp_path / "p",
                                              tiny=True, batch=batch)
    hook = TFU.BankResNetFeatures(tiny=True, sub=4)
    for lo in range(0, bank.n, CHUNK):
        hook.on_chunk({"doc": bank.data["doc_image"][lo:lo + CHUNK]}, lo,
                      min(CHUNK, bank.n - lo))
    hook_c = hook.write(bank, tmp_path / "h")
    assert len(jax_c) == len(port_c) == len(hook_c) == bank.n
    assert port_c._ids == hook_c._ids == jax_c._ids == bank.doc_paths
    want = _feats(jax_c.dir)
    np.testing.assert_allclose(_feats(port_c.dir), want, atol=2e-2)
    if batch == 4:
        np.testing.assert_allclose(_feats(hook_c.dir), want, atol=2e-2)
    else:           # the clamped block: rows 12.. hold rows 8..'s features
        start = CLAMP_CAP - CLAMP_B
        np.testing.assert_allclose(
            _feats(port_c.dir)[CLAMP_B:],
            _feats(hook_c.dir)[start:start + bank.n - CLAMP_B], atol=2e-2)
    assert hook_c.retrieve_similar_images(bank.doc_paths[0], top_k=1)


# -- the resize ------------------------------------------------------------


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (32, 24), (32, 48)])
def test_resize_bilinear_matches_jax_image_resize(size_in, size_out):
    x = np.random.default_rng(size_in + size_out).integers(
        0, 256, (2, size_in, size_in, 3)).astype(np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32),
                                       (2, size_out, size_out, 3),
                                       "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size_out).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL
    want8 = np.clip(np.round(want), 0, 255).astype(np.int32)
    got8 = resize_uint8(torch.from_numpy(x), size_out).numpy()
    assert got8.dtype == np.uint8
    assert np.abs(got8.astype(np.int32) - want8).max() <= 1
    # the untreated rule (no antialias, no renormalized edges) is caught
    plain = Fn.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2).float(),
                           size=(size_out, size_out), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    if size_out < size_in:
        assert np.abs(plain - want).max() > 100 * RESIZE_TOL
