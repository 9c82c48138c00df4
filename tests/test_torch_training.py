"""The port's fusion train step (mmd_tpu_torch/training) against the JAX
package's make_raw_step, and its loop, CLI, checkpoints and store reader.

Parity: the JAX initial params go through the bridge into the port; the
same numpy batches go through three AdamW steps of each, JAX's jitted once
per mode with its fused attention path (Pallas in interpret mode), in fp32
and, in two modes, in bf16 (tolerances at BF16_LOSS_RTOL). dropout
is 0: the TPU PRNG behind the JAX package's masks has no interpret mode,
and off the TPU JAX draws its masks from jax.random, which no torch
generator reproduces, so dropout is held against the port's own paths
(tests/test_torch_attention.py, tests/test_torch_dropout.py) and here by a
falling loss. The JAX step's gradients are read from its own optimizer
state: make_raw_step takes the optimizer, and a chain of a recorder (whose
state is the last gradient) and make_optimizer's AdamW updates exactly as
make_optimizer alone does.

Tolerances (fp32): loss within 1e-5 relative (sums in another order).
Grads at every step: each leaf within 1e-4 of its largest |value| plus
1e-7 absolute (a few fp32 layers, reassociated). Params after 3 steps are
held against AdamW written out in float64 from optax's formulas (_adamw):
each package's params against _adamw of its own gradients, within 1e-6
absolute plus 1e-5 relative (fp32 rounding), and the two packages' params
apart by no more than that plus the gap between _adamw of the port's and
of JAX's gradients. AdamW's step m_hat / (sqrt(v_hat) + eps) has size ~1
whatever the gradient's size, so where a gradient is near zero -- the key
projections' biases above all, whose true gradient is zero (softmax
ignores a shift shared by all keys) and which both packages compute as
fp32 noise of ~1e-9 -- the grads' small gap moves a param by up to ~lr;
the bound allows exactly what the measured gradients make, no more.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.core.config import TrainConfig as JTrainConfig
from mmd_tpu.data.store import write_store
from mmd_tpu.data.synthetic import synthetic_preembed_batch as j_batch
from mmd_tpu.training import trainer as JT
from mmd_tpu_torch import bridge
from mmd_tpu_torch import train as T
from mmd_tpu_torch.core.checkpoint import load_params
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
from mmd_tpu_torch.training import trainer as TT
from mmd_tpu_torch.training.loop import run_training

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
LR, STEPS = 1e-3, 3
DIMS = dict(text_input_dim=16, image_input_dim=24, embed_dim=64,
            num_heads=2, hidden_dim=16, compute_dtype="float32")
SEQ = dict(text_seq=16, image_seq=8, text_dim=16, image_dim=24)
B = 4
MODES = {"default": ({}, 1), "factify": ({"factify": True}, 1),
         "text_only": ({"text_only": True}, 1), "accum2": ({}, 2),
         "bf16": ({"compute_dtype": "bfloat16"}, 1),
         "bf16_factify": ({"compute_dtype": "bfloat16", "factify": True}, 1)}
# bf16: the two frameworks round matmul outputs and GELU and softmax
# inputs to bf16 at other points, each rounding moving a value by up to
# 2^-8 of itself. The loss within 1e-2 relative. Grads: each leaf within
# 0.3 of its largest |value|, but of no less than 5% of the model's largest
# gradient: at batch 4 a rounding of the logits moves softmax's gradient by
# an amount comparable to a small head gradient, and the key projections'
# biases, whose true gradient is zero, hold only rounding noise; over the
# three steps each package's params also follow its own grads
BF16_LOSS_RTOL = 1e-2
BF16_GRAD = (0.3, 0.0, 0.05)            # rel, atol, floor


def _recorder():
    """An optax transformation whose state is the incoming gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [j_batch(rng, B, **SEQ) for _ in range(n)]


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _flat(tree) -> dict:
    """keystr -> a numpy copy (the port's leaves may share memory with
    tensors that a later step changes in place)."""
    got = {jax.tree_util.keystr(p): np.array(x) for p, x in _leaves(tree)}
    assert got
    return got


def _adamw(params: dict, grads: list) -> dict:
    """optax.adamw (= torch.optim.AdamW) in float64: `params` after one
    step for each dict of `grads`."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, TrainConfig().weight_decay
    p = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v = {k: np.zeros_like(x) for k, x in p.items()}
    for t, g in enumerate(grads, 1):
        for k in p:
            gk = g[k].astype(np.float64)
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            u = (m[k] / (1 - b1 ** t)) / (np.sqrt(v[k] / (1 - b2 ** t))
                                          + eps)
            p[k] = p[k] - LR * (u + wd * p[k])
    return p


def _assert_grads_close(got: dict, want: dict, step: int,
                        rel: float = GRAD_REL, atol: float = GRAD_ATOL,
                        floor: float = 0.0) -> None:
    """Each leaf within rel of its largest |value| (but of no less than
    `floor` of the model's largest gradient) plus atol."""
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max())
        scale = max(float(np.abs(w).max()), floor * top)
        assert gap <= rel * scale + atol, (step, k, gap)


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode):
    kw, accum = MODES[mode]
    classes = 5 if kw.get("factify") else 3
    dims = {**DIMS, **kw}
    bf16 = dims["compute_dtype"] == "bfloat16"
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    grad_tol = BF16_GRAD if bf16 else (GRAD_REL, GRAD_ATOL)
    jcfg = JTrainConfig(model=JModelConfig(**dims, dropout=0.0,
                                           fused_attn=True,
                                           num_classes=classes),
                        batch_size=B, lr=LR, accum_steps=accum)
    tcfg = TrainConfig(model=ModelConfig(**dims, dropout=0.0,
                                         fused_attn=True,
                                         num_classes=classes),
                       batch_size=B, lr=LR, accum_steps=accum)
    opt = optax.chain(_recorder(), JT.make_optimizer(jcfg))
    j0 = JT.init_state(jcfg, jax.random.key(0))
    jstate = JT.TrainState(j0.step, j0.params, opt.init(j0.params), j0.rng)
    jstep = jax.jit(JT.make_raw_step(jcfg, opt))

    state = TT.init_state(tcfg, "cpu")
    state.params = bridge.fusion_from_jax(
        jax.tree_util.tree_map(np.asarray, j0.params), tcfg.model)
    state.optimizer = TT.make_optimizer(tcfg, state.params)
    tstep = TT.make_raw_step(tcfg)

    p0 = _flat(j0.params)
    tgrads, jgrads = [], []
    for i, batch in enumerate(_batches(STEPS)):
        jstate, jaux = jstep(jstate, batch)
        state, taux = tstep(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        jl, tl = float(jaux["loss"]), float(taux["loss"])
        assert abs(tl - jl) <= loss_rtol * abs(jl), (i, tl, jl)
        np.testing.assert_array_equal(taux["labels"].numpy(),
                                      np.asarray(jaux["labels"]))
        jgrads.append(_flat(jstate.opt_state[0]))
        tgrads.append(_flat(bridge.to_jax_tree(state.params, grads=True)))
        _assert_grads_close(tgrads[-1], jgrads[-1], i, *grad_tol)
    assert state.step == int(jstate.step) == STEPS
    got, want = _flat(bridge.to_jax_tree(state.params)), _flat(jstate.params)
    assert got.keys() == want.keys() == p0.keys()
    from_t, from_j = _adamw(p0, tgrads), _adamw(p0, jgrads)
    for k, w in want.items():
        tol = PARAM_ATOL + PARAM_RTOL * np.abs(w)
        for name, gap, bound in (
                ("port", np.abs(got[k] - from_t[k]), tol),
                ("jax", np.abs(w - from_j[k]), tol),
                ("port-jax", np.abs(got[k] - w),
                 tol + np.abs(from_t[k] - from_j[k]))):
            assert bool((gap <= bound).all()), (name, k, float(gap.max()))

def small_cfg(**model_kw):
    """tests/test_training.py's small config, at head dim 32 so the fused
    path (the plain flash forward and backward on the CPU) runs, with the
    default dropout of 0.1."""
    model = ModelConfig(text_input_dim=16, image_input_dim=24, embed_dim=64,
                        num_heads=2, hidden_dim=16, compute_dtype="float32",
                        fused_attn=True, **model_kw)
    return TrainConfig(model=model, batch_size=16, lr=1e-3)


def test_loss_falls_with_dropout_on():
    """Mirrors tests/test_training.py::test_train_step_loss_decreases with
    dropout 0.1 on every site."""
    cfg = small_cfg()
    assert cfg.model.dropout == 0.1
    tr = TT.Trainer(cfg, device="cpu")
    state = tr.init()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(30):
        batch = tr.shard_batch(synthetic_preembed_batch(
            rng, batch_size=16, text_seq=8, image_seq=4, text_dim=16,
            image_dim=24))
        state, aux = tr.train_step(state, batch)
        losses.append(float(aux["loss"]))
    # 4-path CE at chance is 4*ln(3) ~ 4.39; must fit the planted signal
    assert losses[0] > 3.0
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_dropout_draws_follow_the_step():
    """Two runs from one seed give the same steps; the step's generator is
    derived from (seed, step), so another step draws other masks."""
    cfg = small_cfg()
    tr = TT.Trainer(cfg, device="cpu")
    batch = tr.shard_batch(synthetic_preembed_batch(
        np.random.default_rng(1), 16, 8, 4, 16, 24))
    losses = []
    for step in (0, 0, 1):
        state = tr.init()
        state.step = step
        losses.append(float(tr.train_step(state, batch)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]


ARGS = ["--device", "cpu", "--batch_size", "4", "--compute_dtype", "float32",
        "--fused_attn", "--text_input_dim", "384", "--image_input_dim",
        "1024", "--embed_dim", "64", "--num_heads", "2", "--hidden_dim", "16",
        "--log_every", "1", "--save_every", "2"]


def test_cli_trains_logs_checkpoints_and_resumes(tmp_path):
    """python -m mmd_tpu_torch.train --device cpu --synthetic_samples 16:
    metrics.jsonl and checkpoints; a run resumed from the first epoch's
    checkpoint ends where an uninterrupted run does."""
    full = T.main(ARGS + ["--synthetic_samples", "16", "--epochs", "2",
                          "--output_dir", str(tmp_path / "full")])
    first = T.main(ARGS + ["--synthetic_samples", "16", "--epochs", "1",
                           "--output_dir", str(tmp_path / "a")])
    assert first.step == 4 and full.step == 8
    lines = [json.loads(x) for x in
             (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/total_loss"]) for r in lines)
    ckpts = tmp_path / "a" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_2.pt",
                                                       "step_4.pt"]
    resumed = T.main(ARGS + ["--synthetic_samples", "16", "--epochs", "1",
                             "--output_dir", str(tmp_path / "b"),
                             "--resume_from", str(ckpts)])
    assert resumed.step == 8
    for (name, a), (_, b) in zip(full.params.state_dict().items(),
                                 resumed.params.state_dict().items()):
        assert torch.equal(a, b), name


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Multi-device training raises; the raw path and fine-tuning are
    ported (tests/test_torch_raw_training.py), so a raw run without its
    csv stops at reading the csv, as the JAX package's does."""
    out = ["--output_dir", str(tmp_path)]
    with pytest.raises(FileNotFoundError):
        T.main(ARGS + out + ["--train_data", str(tmp_path / "none.csv")])
    with pytest.raises(NotImplementedError, match="A16"):
        T.main(ARGS + out + ["--synthetic_samples", "4", "--zero1"])
    with pytest.raises(NotImplementedError, match="A16"):
        T.main(ARGS + out + ["--synthetic_samples", "4", "--model_parallel",
                             "2"])
    with pytest.raises(NotImplementedError, match="A16"):
        T.main(ARGS + out + ["--synthetic_samples", "4",
                             "--text_parallelism", "sp"])


def test_cuda_is_the_default_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    args = T.parse_args(["--synthetic_samples", "4"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build(args)


def test_pre_embed_reads_a_store_the_jax_package_wrote(tmp_path):
    rng = np.random.default_rng(3)
    arrays = j_batch(rng, 10, text_seq=512, image_seq=64, text_dim=384,
                     image_dim=1024)
    write_store(tmp_path / "train_embeddings.store", arrays)
    store = ArrayStore(tmp_path / "train_embeddings.store")
    from mmd_tpu.data.store import ArrayStore as JStore
    jstore = JStore(tmp_path / "train_embeddings.store")
    for got, want in zip(store.batches(4, shuffle=True, seed=5,
                                       drop_last=False),
                         jstore.batches(4, shuffle=True, seed=5,
                                        drop_last=False)):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    state = T.main(ARGS + ["--pre_embed", "--train_data",
                           str(tmp_path / "train.csv"), "--epochs", "1",
                           "--output_dir", str(tmp_path / "run")])
    assert state.step == 2          # 10 samples, batches of 4, tail dropped


def test_reverse_bridge_round_trips():
    cfg = ModelConfig(**DIMS)
    params = TT.init_state(TrainConfig(model=cfg), "cpu").params
    tree = bridge.to_jax_tree(params)
    again = bridge.fusion_from_jax(tree, cfg)
    for (n, a), (_, b) in zip(params.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="gradient"):
        bridge.to_jax_tree(params, grads=True)


def test_trainer_validates_like_the_jax_trainer():
    cfg = dataclasses.replace(small_cfg(), accum_steps=3)
    with pytest.raises(ValueError, match="accum_steps"):
        TT.Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires encoders"):
        TT.Trainer(small_cfg(), device="cpu", finetune=True)
    with pytest.raises(NotImplementedError, match="A16"):
        TT.Trainer(small_cfg(), device="cpu", tensor_parallel=True)


def test_steps_per_call_window_gives_the_same_numbers(tmp_path):
    """steps_per_call is accepted and ignored: every batch is one step, so
    a run with steps_per_call=2 ends with the same params as single steps,
    logs every step and writes every save_every checkpoint, those of the
    steps that would fall outside a whole window of two included."""
    data = [synthetic_preembed_batch(np.random.default_rng(i), 16, 8, 4, 16,
                                     24) for i in range(3)]
    finals = []
    for spc in (1, 2):
        out = tmp_path / f"w{spc}"
        cfg = dataclasses.replace(small_cfg(), steps_per_call=spc, epochs=2,
                                  log_every=1, save_every=3,
                                  output_dir=str(out))
        tr = TT.Trainer(cfg, device="cpu")
        finals.append(run_training(tr, lambda epoch: iter(data)))
        steps = [json.loads(x)["step"] for x in
                 (out / "metrics.jsonl").read_text().splitlines()]
        assert steps == [1, 2, 3, 4, 5, 6]
        assert sorted(p.name for p in (out / "checkpoints").iterdir()) == [
            "step_3.pt", "step_6.pt"]
    assert finals[0].step == finals[1].step == 6
    for (n, a), (_, b) in zip(finals[0].params.state_dict().items(),
                              finals[1].params.state_dict().items()):
        assert torch.equal(a, b), n


def test_save_best_writes_params_that_load_params_reads(tmp_path):
    """--validate_every_epoch --save_best: best_model.pt holds the params
    of the best validation epoch (here the only one), and load_params
    restores them into a fresh model."""
    data = [synthetic_preembed_batch(np.random.default_rng(i), 16, 8, 4, 16,
                                     24) for i in range(2)]
    cfg = dataclasses.replace(small_cfg(), epochs=1, log_every=1,
                              save_every=0, validate_every_epoch=True,
                              save_best=True, output_dir=str(tmp_path))
    tr = TT.Trainer(cfg, device="cpu")
    state = run_training(tr, lambda epoch: iter(data),
                         lambda: iter([dict(b) for b in data]))
    recs = [json.loads(x) for x in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any("val/best_metric" in r for r in recs)
    fresh = tr.init(seed=7).params
    load_params(str(tmp_path / "best_model.pt"), fresh)
    for (n, a), (_, b) in zip(state.params.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
