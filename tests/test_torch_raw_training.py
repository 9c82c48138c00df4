"""The port's raw-batch path (ROADMAP A11a) against the JAX package: the
synthetic Factify tree, preprocess_csv and build_raw_store (column by
column, exactly), make_encoding_raw_step with seeded tiny frozen encoders,
and the CLI's raw branch on the CPU.

Parity of the encoding step: the JAX package's tiny encoders (TINY_TEST,
VIT_TEST) and initial fusion params go through the bridge into the port;
the same numpy raw batches (token ids with padded tails, uint8 images) go
through two steps of each, dropout 0 (the JAX package draws its masks from
jax.random, which no torch generator reproduces), fp32. The JAX step's
gradients are read from its optimizer state through a recorder, as in
tests/test_torch_training.py. Tolerances: loss within 1e-5 relative; each
grad leaf within 1e-4 of its largest |value| plus 1e-7 (fp32 sums in
another order through two encoder layers and the fusion model).
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.core.config import TrainConfig as JTrainConfig
from mmd_tpu.data.labels import LABEL_TABLE
from mmd_tpu.data.synthetic import synthetic_factify_tree as j_tree
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import frozen as JF
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.pipelines import preprocess as JP
from mmd_tpu.pipelines import raw_store as JR
from mmd_tpu.training import trainer as JT
from mmd_tpu_torch import bridge
from mmd_tpu_torch import train as T
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import frozen as TF
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.pipelines import preprocess as TP
from mmd_tpu_torch.pipelines import raw_store as TR
from mmd_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
LR, B, SEQ, STEPS = 1e-3, 4, 16, 2
DIMS = dict(text_input_dim=32, image_input_dim=32, embed_dim=64,
            num_heads=2, hidden_dim=16, compute_dtype="float32",
            dropout=0.0, fused_attn=True)


def _recorder():
    """An optax transformation whose state is the incoming gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _flat(tree) -> dict:
    got = {jax.tree_util.keystr(p): np.array(x)
           for p, x in jax.tree_util.tree_leaves_with_path(tree)}
    assert got
    return got


def assert_grads_close(got: dict, want: dict, step, rel=GRAD_REL,
                       atol=GRAD_ATOL) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max())
        assert gap <= rel * float(np.abs(w).max()) + atol, (step, k, gap)


def raw_batches(n, seed, vocab, seq, image_size):
    """Raw batches as the raw store yields them: token ids with padded
    tails (one claim of a single token), uint8 NHWC images, 4-path
    labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {}
        for side in ("claim", "doc"):
            lengths = rng.integers(1, seq + 1, size=B)
            lengths[0] = 1 if side == "claim" else seq
            mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
            ids = rng.integers(1, vocab, size=(B, seq)).astype(np.int32)
            batch[f"{side}_ids"] = ids * mask
            batch[f"{side}_mask"] = mask
            batch[f"{side}_image"] = rng.integers(
                0, 256, size=(B, image_size, image_size, 3), dtype=np.uint8)
        batch["labels"] = LABEL_TABLE[rng.integers(0, 5, size=B)].astype(
            np.int32)
        out.append(batch)
    return out


def test_tree_preprocess_and_raw_store_match_jax(tmp_path, monkeypatch):
    """One seed gives the JAX package's tree; preprocess_csv writes the same
    csv; build_raw_store the same store, column by column and exactly."""
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    kw = dict(n_train=12, n_test=3, image_size=48, seed=3)
    j_tree(jroot, **kw)
    synthetic_factify_tree(troot, **kw)
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(troot) for p in troot.rglob("*")
                           if p.is_file())
    for f in files:
        assert (jroot / f).read_bytes() == (troot / f).read_bytes(), f
    jcsv, tcsv = JP.preprocess_csv("train", jroot), TP.preprocess_csv(
        "train", troot)
    assert jcsv.read_text() == tcsv.read_text()

    texts = pd.read_csv(tcsv)[["claim", "evidence"]].stack().tolist()
    JTokenizer.train(texts, 200).save(tmp_path / "tok.json")
    jtok = JTokenizer.load(tmp_path / "tok.json")
    ttok = WordPieceTokenizer.load(tmp_path / "tok.json")
    stores = {}
    for name, root, csv, build, tok in (
            ("jax", jroot, jcsv, JR.build_raw_store, jtok),
            ("torch", troot, tcsv, TR.build_raw_store, ttok)):
        monkeypatch.setenv("MMD_TPU_ROOT", str(root))
        assert TR.raw_store_path(str(csv)) == JR.raw_store_path(str(csv))
        stores[name] = build(str(csv), tok, max_length=24, image_size=32,
                             batch_size=5, io_workers=2)
    js, ts = stores["jax"], stores["torch"]
    assert 0 < len(ts) == len(js) < 12           # images went missing
    assert ts.column_specs == js.column_specs
    for col in js.column_specs:
        np.testing.assert_array_equal(ts.col(col), js.col(col), err_msg=col)
    for got, want in zip(ts.batches(4, shuffle=True, seed=1,
                                    columns=TR.TRAIN_COLUMNS),
                         js.batches(4, shuffle=True, seed=1,
                                    columns=TR.TRAIN_COLUMNS)):
        assert list(got) == TR.TRAIN_COLUMNS
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def _tiny_encoders():
    """(JAX FrozenEncoders, the port's) with the same seeded params."""
    tp = jte.init_text_encoder(jax.random.key(1), jte.TINY_TEST)
    vp = jvit.init_vit(jax.random.key(2), jvit.VIT_TEST)
    np_tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    jenc = JF.FrozenEncoders(None, jte.TINY_TEST, tp, jvit.VIT_TEST, vp)
    tenc = TF.FrozenEncoders(
        None, te.TINY_TEST, bridge.text_encoder_from_jax(np_tree(tp),
                                                         te.TINY_TEST),
        tvit.VIT_TEST, bridge.vit_from_jax(np_tree(vp), tvit.VIT_TEST))
    return jenc, tenc


@pytest.mark.parametrize("accum", [1, 2])
def test_encoding_step_matches_jax(accum):
    jcfg = JTrainConfig(model=JModelConfig(**DIMS), batch_size=B, lr=LR,
                        accum_steps=accum)
    tcfg = TrainConfig(model=ModelConfig(**DIMS), batch_size=B, lr=LR,
                       accum_steps=accum)
    jenc, tenc = _tiny_encoders()
    before = {k: v.clone() for k, v in tenc.text_params.state_dict().items()}
    opt = optax.chain(_recorder(), JT.make_optimizer(jcfg))
    j0 = JT.init_state(jcfg, jax.random.key(0))
    jstate = JT.TrainState(j0.step, j0.params, opt.init(j0.params), j0.rng)
    jstep = jax.jit(JT.make_encoding_raw_step(jcfg, jenc, opt))
    frozen = {"text": jenc.text_params, "vit": jenc.vit_params}

    trainer = TT.Trainer(tcfg, device="cpu", encoders=tenc)
    state = trainer.init()
    state.params = bridge.fusion_from_jax(
        jax.tree_util.tree_map(np.asarray, j0.params), tcfg.model)
    state.optimizer = TT.make_optimizer(tcfg, state.params)
    for i, batch in enumerate(raw_batches(STEPS, 7, 128, SEQ, 32)):
        jstate, jaux = jstep(jstate, frozen, batch)
        state, taux = trainer.train_step(state, trainer.shard_batch(batch))
        jl, tl = float(jaux["loss"]), float(taux["loss"])
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
        np.testing.assert_array_equal(taux["labels"].numpy(),
                                      np.asarray(jaux["labels"]))
        assert_grads_close(_flat(bridge.to_jax_tree(state.params,
                                                    grads=True)),
                           _flat(jstate.opt_state[0]), i)
    # the frozen encoders took no gradient and no update
    assert all(p.grad is None for p in tenc.text_params.parameters())
    assert all(p.grad is None for p in tenc.vit_params.parameters())
    for k, v in tenc.text_params.state_dict().items():
        assert torch.equal(v, before[k]), k


def _cli_tree(tmp_path, monkeypatch):
    """A synthetic tree, preprocessed, and the CLI pointed at it with tiny
    encoders: the raw store builds at the tiny ViT's 32 px and the tiny
    text encoder's 64 positions."""
    synthetic_factify_tree(tmp_path, n_train=12, n_test=2, image_size=48)
    csv = TP.preprocess_csv("train", tmp_path)
    monkeypatch.setenv("MMD_TPU_ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path)       # assets/encoders lands in tmp_path
    monkeypatch.setattr(TF, "load_or_init_frozen", functools.partial(
        TF.load_or_init_frozen, tiny=True))
    monkeypatch.setattr(TR, "build_raw_store", functools.partial(
        TR.build_raw_store, image_size=32, max_length=24, io_workers=2))
    return str(csv)


@pytest.mark.parametrize("finetune", [False, True])
def test_cli_raw_branch_runs_on_cpu(tmp_path, monkeypatch, finetune):
    csv = _cli_tree(tmp_path, monkeypatch)
    out = tmp_path / "run"
    argv = ["--device", "cpu", "--train_data", csv, "--batch_size", "4",
            "--epochs", "2", "--log_every", "1", "--compute_dtype",
            "float32", "--fused_attn", "--embed_dim", "64", "--num_heads",
            "2", "--hidden_dim", "16", "--text_input_dim", "32",
            "--image_input_dim", "32", "--output_dir", str(out)]
    state = T.main(argv + (["--finetune_encoders"] if finetune else []))
    assert (tmp_path / "data" / "preprocessed" / "train.store"
            / "meta.json").exists()
    assert (tmp_path / "assets" / "encoders" / "tokenizer.json").exists()
    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/total_loss"] for r in recs if "train/total_loss" in r]
    assert len(losses) == state.step >= 2
    assert all(map(math.isfinite, losses))
    # fine-tuning trains the joint tree, the frozen path the fusion model
    assert ("text" in state.params.keys()) is finetune
