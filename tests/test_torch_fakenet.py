"""FakeNet in the port (mmd_tpu_torch/baselines/fakenet{,_train}.py)
against the JAX package's (mmd_tpu/baselines/fakenet{,_train}.py), on the
CPU.

The same params go to both: a numpy tree in the JAX package's layout
(drawn by the port's init, or by JAX's where train_fakenet draws it) that
the JAX functions take as it is and bridge.fakenet_from_jax carries into
the port; and the same numpy-seeded inputs. The JAX side is jitted.
Tolerances, relative to the largest |value| of the JAX output:
  * fp32 logits and concat embeddings within 1e-5;
  * bf16 within 2e-2: the two packages round to bf16 at other points (the
    port's Linear rounds the product before adding its bias, JAX after;
    erf-GELU and LayerNorm run on bf16 values), and 12 post-LN blocks carry
    those roundings (one bf16 step is 2^-8 = 3.9e-3 relative; 2.3e-3 to
    4.4e-3 seen);
  * fp32 gradients at dropout 0 within 1e-4 of each leaf's largest |g|,
    no leaf held to less than 1e-3 of the model's largest gradient;
  * train_fakenet's history over 3 epochs: losses within 1e-4 relative,
    weighted F1 equal;
  * predict_fakenet's probabilities within 1e-5, predictions equal;
  * ensemble_grid_search and warmup_linear_schedule exactly.
FAKENET_TEST has head dim 16, which both packages send to the explicit
path; DH128 (hidden 256, 2 heads: the CLI's head dim) sends every
attention to JAX's Pallas flash kernel in interpret mode and to the port's
flash_attention_plain.
"""

import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.baselines import fakenet as JF
from mmd_tpu.baselines import fakenet_train as JFT
from mmd_tpu_torch import bridge
from mmd_tpu_torch.baselines import fakenet as TF
from mmd_tpu_torch.baselines import fakenet_train as TFT
from mmd_tpu_torch.data.store import write_store
from mmd_tpu_torch.ops import attention as A

torch.set_num_threads(2)

TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3

DH128 = dataclasses.replace(JF.FAKENET_TEST, hidden_dim=256, head=2)
CONFIGS = {"test": (JF.FAKENET_TEST, 6, 4), "dh128": (DH128, 16, 8)}


def _port_cfg(jcfg) -> TF.FakeNetConfig:
    return TF.FakeNetConfig(**dataclasses.asdict(jcfg))


def _setup(jcfg, seed=0):
    tcfg = _port_cfg(jcfg)
    tree = bridge.to_jax_tree(TF.init_fakenet(
        torch.Generator().manual_seed(seed), tcfg))
    return tree, bridge.fakenet_from_jax(tree, tcfg)


def _batch(rng, cfg, b, lt, li):
    return {
        "claim_text_embeds": rng.standard_normal((b, lt, cfg.text_dim)).astype(np.float32),
        "doc_text_embeds": rng.standard_normal((b, lt, cfg.text_dim)).astype(np.float32),
        "claim_image_embeds": rng.standard_normal((b, li, cfg.image_dim)).astype(np.float32),
        "doc_image_embeds": rng.standard_normal((b, li, cfg.image_dim)).astype(np.float32),
        "add_feature": rng.standard_normal((b, cfg.add_feature_dim)).astype(np.float32),
        "category": rng.integers(0, 5, b).astype(np.int32),
    }


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _jax_forward(cfg):
    @jax.jit
    def fwd(params, b):
        return JF.fakenet_forward(
            params, cfg, b["claim_text_embeds"], b["claim_image_embeds"],
            b["doc_text_embeds"], b["doc_image_embeds"], b["add_feature"])
    return fwd


def _torch_inputs(b):
    return [torch.from_numpy(b[k]) for k in TFT.INPUTS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, dtype):
    jcfg, lt, li = CONFIGS[name]
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    tree, params = _setup(jcfg)
    b = _batch(np.random.default_rng(1), jcfg, 3, lt, li)
    want_logits, want_emb = _jax_forward(jcfg)(tree, b)
    fused = A.fused_ok(jcfg.hidden_dim, jcfg.head)
    assert fused == (name == "dh128")
    with torch.no_grad():
        logits, emb = TF.fakenet_forward(params, _port_cfg(jcfg),
                                         *_torch_inputs(b))
    assert logits.dtype == torch.float32 and logits.shape == (3, 5)
    assert emb.shape == (3, 16 + jcfg.hidden_dim)
    assert emb.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(logits, want_logits, tol)
    _close(emb.float(), jnp.asarray(want_emb, jnp.float32), tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_match_jax_at_dropout_0(name):
    jcfg, lt, li = CONFIGS[name]
    jcfg = dataclasses.replace(jcfg, dropout=0.0)
    tree, params = _setup(jcfg, seed=2)
    b = _batch(np.random.default_rng(3), jcfg, 3, lt, li)

    @jax.jit
    def jloss(p, batch):
        logits, _ = JF.fakenet_forward(
            p, jcfg, batch["claim_text_embeds"], batch["claim_image_embeds"],
            batch["doc_text_embeds"], batch["doc_image_embeds"],
            batch["add_feature"], rng=jax.random.key(0), deterministic=False)
        return JFT.cross_entropy(logits, batch["category"])

    want_loss, want = jax.value_and_grad(jloss)(tree, b)
    logits, _ = TF.fakenet_forward(params, _port_cfg(jcfg),
                                   *_torch_inputs(b), seed=5,
                                   deterministic=False)
    loss = TFT.cross_entropy(logits, torch.from_numpy(b["category"]))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    got = jax.tree_util.tree_leaves(bridge.to_jax_tree(params, grads=True))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), floor)


def _planted(rng, cfg, n_batches=3, b=8, lt=6, li=4):
    batches = []
    for _ in range(n_batches):
        batch = _batch(rng, cfg, b, lt, li)
        batch["claim_text_embeds"] += (batch["category"][:, None, None]
                                       - 2) * 0.8
        batches.append(batch)
    return batches


def test_train_fakenet_matches_jax_history(monkeypatch):
    """Dropout 0, 3 epochs from JAX's own init (train_fakenet draws it from
    key(seed)); the port's init is replaced by the same tree."""
    jcfg = dataclasses.replace(JF.FAKENET_TEST, dropout=0.0)
    batches = _planted(np.random.default_rng(4), jcfg)
    kw = dict(epochs=3, lr=3e-3, warmup_steps=2, seed=11)
    _, want = JFT.train_fakenet(jcfg, lambda e: iter(batches), **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, JF.init_fakenet(jax.random.key(11), jcfg))
    monkeypatch.setattr(TFT, "init_fakenet",
                        lambda gen, cfg: bridge.fakenet_from_jax(tree, cfg))
    _, got = TFT.train_fakenet(_port_cfg(jcfg), lambda e: iter(batches),
                               device="cpu", **kw)
    assert [h["epoch"] for h in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
        assert g["weighted_f1"] == pytest.approx(w["weighted_f1"], abs=1e-12)
    assert got[-1]["loss"] < got[0]["loss"]


def test_best_params_are_a_copy_of_the_best_epoch(monkeypatch):
    """The best epoch's params stay as they were when later epochs update
    the live params in place."""
    cfg = _port_cfg(JF.FAKENET_TEST)
    batches = _planted(np.random.default_rng(5), JF.FAKENET_TEST)
    live = TF.init_fakenet(torch.Generator().manual_seed(3), cfg)
    after_epoch_0 = {}

    def per_epoch(epoch):
        if epoch == 1:                          # the params after epoch 0
            after_epoch_0.update({k: v.clone()
                                  for k, v in live.state_dict().items()})
        return iter(batches)

    f1s = iter([0.9, 0.5, 0.1])                 # epoch 0 is the best
    monkeypatch.setattr(TFT.M, "f1_score", lambda *a, **k: next(f1s))
    monkeypatch.setattr(TFT, "init_fakenet", lambda gen, c: live)
    best, history = TFT.train_fakenet(cfg, per_epoch, epochs=3, lr=3e-3,
                                      warmup_steps=1, seed=3, device="cpu")
    assert [h["weighted_f1"] for h in history] == [0.9, 0.5, 0.1]
    assert best is not live
    for name, p in best.state_dict().items():
        assert torch.equal(p, after_epoch_0[name]), name
    assert any(not torch.equal(p, live.state_dict()[name])
               for name, p in best.state_dict().items())


def test_predict_fakenet_matches_jax():
    jcfg = JF.FAKENET_TEST
    tree, params = _setup(jcfg, seed=6)
    rng = np.random.default_rng(7)
    batches = [_batch(rng, jcfg, 4, 6, 4) for _ in range(3)]
    want_pred, want_true, want_probs = JFT.predict_fakenet(
        tree, jcfg, batches, return_probs=True)
    pred, true, probs = TFT.predict_fakenet(params, _port_cfg(jcfg), batches,
                                            return_probs=True)
    np.testing.assert_array_equal(true, want_true)
    np.testing.assert_array_equal(pred, want_pred)
    _close(probs, want_probs, TOL)
    again = TFT.predict_fakenet(params, _port_cfg(jcfg), batches)
    np.testing.assert_array_equal(again[0], pred)
    assert again[1] is not None


def test_ensemble_grid_search_matches_jax(rng):
    y = rng.integers(0, 5, 60)
    sets = [rng.dirichlet(np.ones(5), 60) for _ in range(3)]
    sets[1][np.arange(60), y] += 0.3
    assert TFT.ensemble_grid_search(sets, y) == JFT.ensemble_grid_search(
        sets, y)
    assert TFT.ensemble_grid_search(sets[:2], y, weights=(0, 1),
                                    powers=(0.5, 2.0)) == \
        JFT.ensemble_grid_search(sets[:2], y, weights=(0, 1),
                                 powers=(0.5, 2.0))


@pytest.mark.parametrize("lr,warmup,total", [(5e-5, 100, 1500),
                                             (3e-4, 4, 24), (1e-3, 0, 10),
                                             (2e-3, 12, 8)])
def test_warmup_linear_schedule_matches_optax(lr, warmup, total):
    want = JFT.warmup_linear_schedule(lr, warmup, total)
    got = TFT.warmup_linear_schedule(lr, warmup, total)
    steps = np.arange(total + 5)
    want = np.asarray(jax.vmap(want)(jnp.asarray(steps)), np.float32)
    assert [got(int(s)) for s in steps] == want.tolist()


def _fakenet_store(directory, rng, n, lt=6, li=4, text_dim=16,
                   image_dim=24):
    from mmd_tpu_torch.data import labels as lb
    labels = lb.LABEL_TABLE[rng.integers(0, 5, n)]
    return write_store(directory, {
        "claim_text_embeds": rng.standard_normal((n, lt, text_dim)).astype(np.float16),
        "doc_text_embeds": rng.standard_normal((n, lt, text_dim)).astype(np.float16),
        "claim_image_embeds": rng.standard_normal((n, li, image_dim)).astype(np.float16),
        "doc_image_embeds": rng.standard_normal((n, li, image_dim)).astype(np.float16),
        "labels": labels.astype(np.int32)})


def test_main_trains_on_the_cpu_and_writes_the_answer_csv(tmp_path, rng):
    _fakenet_store(tmp_path / "s", rng, 20)
    answer = tmp_path / "answer.csv"
    argv = ["--store", str(tmp_path / "s"), "--epochs", "2", "--batch_size",
            "4", "--text_dim", "16", "--image_dim", "24", "--hidden_dim",
            "32", "--head", "2", "--answer_csv", str(answer)]
    out = TFT.main(argv + ["--device", "cpu"])
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    with open(answer) as f:
        rows = list(csv.reader(f))
    # the JAX CLI's columns (mmd_tpu/baselines/fakenet_train.py main)
    assert rows[0] == ["idx", "pred", "p0", "p1", "p2", "p3", "p4"]
    assert len(rows) == 1 + 20
    probs = np.array([[float(x) for x in r[2:]] for r in rows[1:]])
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
    np.testing.assert_array_equal([int(r[1]) for r in rows[1:]],
                                  out["y_pred"])


def test_main_runs_on_the_card_unless_asked(tmp_path, rng):
    """The CLI's default device is the card: without one it raises instead
    of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _fakenet_store(tmp_path / "s", rng, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFT.main(["--store", str(tmp_path / "s"), "--epochs", "1",
                  "--text_dim", "16", "--image_dim", "24", "--hidden_dim",
                  "32", "--answer_csv", str(tmp_path / "a.csv")])
