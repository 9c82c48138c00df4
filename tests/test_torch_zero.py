"""Data parallelism, ZeRO-1 and ZeRO-3 in the Trainer, checkpoints across
meshes, and the train CLI over a world of 4 gloo ranks on the CPU, against
tests/test_scaling.py and tests/test_tp.py:280-428.

One world for the module (the `world` fixture) runs every case and each
rank hands back what it computed:
  * three fp32 steps at dropout 0 of DP, ZeRO-1 and ZeRO-3 on (4, 1), from
    numpy-seeded weights that bridge.fusion_from_jax carries across:
    losses against the port's single-device Trainer (rtol 1e-6, atol 1e-6;
    ZeRO against DP at rtol 2e-5) and the JAX package's single-device step
    (rtol 1e-5), the first step's gradient as AdamW received it
    (reduce-scattered, or the rank's rows) gathered within
    tests/test_torch_training.py's gradient limit of the single-device
    one, params within the lr-scaled noise budget of
    tests/test_scaling.py:91-97 of both, and every rank's blocks of the
    JAX package's shard shapes; the eval step on ZeRO-3's shards against
    the single-device eval;
  * accumulation (accum 2 against 1) under ZeRO-3; the raw path under
    ZeRO-1; fine-tuning tiny encoders with ZeRO-1 and ZeRO-3 on (4, 1)
    against the single-device fine-tuning step;
  * a run saved under TP + ZeRO-1 on (2, 2) resumed under ZeRO-3 on (4, 1)
    and, in the test process, on one device: both end where the
    uninterrupted single-device run does; the checkpoint holds the
    single-device state;
  * `python -m mmd_tpu_torch.train --model_parallel 2 --tensor_parallel
    --zero1 --dist_backend gloo` over the world: rank 0's metrics.jsonl
    against the single-device CLI's at dropout 0 (losses within 1e-5,
    metrics equal), best_model.pt loaded on one device, nothing written by
    the other ranks.
The spec tables (`zero1_specs`, `zero3_specs`) are held leaf for leaf
against the JAX package's over jax.eval_shape(init_state). JAX is
imported only inside fixtures and tests.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mmd_tpu_torch import bridge
from mmd_tpu_torch import train as T
from mmd_tpu_torch.core.checkpoint import CheckpointManager, load_params
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.core.mesh import make_mesh
from mmd_tpu_torch.models.fusion import init_fusion_params
from mmd_tpu_torch.parallel import tp as TP
from mmd_tpu_torch.parallel.launch import spawn
from mmd_tpu_torch.training import trainer as TT
from mmd_tpu_torch.training.loop import run_training
from test_torch_tp_training import (
    B, LOSS_TOL, LR, MODEL, PARAM_TOL, RAW_MODEL, WORLD, _batches,
    _cfg, _encoders, _flat_jax, _jax_specs, _jax_state_shape, _pad,
    _raw_batch, _run, _seeded_tree, _shapes, _step_grads, assert_grads_close,
)

TRAJ = {"dp": {}, "zero1": dict(zero1=True), "zero3": dict(zero3=True)}
JAX_LOSS_RTOL = 1e-5
CLI = ["--device", "cpu", "--batch_size", "16", "--compute_dtype", "float32",
       "--text_input_dim", "384", "--image_input_dim", "1024", "--embed_dim",
       "64", "--num_heads", "2", "--hidden_dim", "16", "--log_every", "1",
       "--save_every", "0", "--dropout", "0", "--synthetic_samples", "32",
       "--epochs", "1", "--validate_every_epoch", "--save_best"]
CLI_MESH = ["--model_parallel", "2", "--tensor_parallel", "--zero1",
            "--dist_backend", "gloo"]


def _whole_state(trainer, state) -> dict:
    return {k: v.clone()
            for k, v in trainer.whole_params(state).state_dict().items()}


def _fit(trainer, batches, output_dir, resume_from=None, state=None):
    """run_training over `batches` (one epoch), then a barrier, so that
    what rank 0 wrote is there for every rank."""
    trainer.cfg = dataclasses.replace(trainer.cfg, epochs=1, save_every=0,
                                      log_every=1, output_dir=output_dir,
                                      resume_from=resume_from)
    state = run_training(trainer, lambda epoch: iter(batches), state=state)
    dist.barrier()
    return state


def _rank(rank, world, dev, job):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in (1, 2)}
    out = {"jax_loaded": "jax" in sys.modules}
    dp_mesh = meshes[1]
    for name, flags in TRAJ.items():
        tr = TT.Trainer(_cfg(), mesh=dp_mesh, **flags)
        out["grads1", name] = _step_grads(_run(tr, job["sd"],
                                               job["batches"][:1])[1])
        losses, state = _run(tr, job["sd"], job["batches"])
        out["traj", name] = (losses, _whole_state(tr, state),
                             _shapes(state))
    tr = TT.Trainer(_cfg(), mesh=dp_mesh, zero3=True)
    st = tr.init(seed=0)
    tr.load_params(st, job["sd"])
    out["eval"] = tr.eval_step(st.params, tr.shard_batch(job["batches"][0]))
    for accum in (1, 2):
        tr = TT.Trainer(_cfg(accum_steps=accum), mesh=dp_mesh, zero3=True)
        out["accum", accum] = _run(tr, job["sd"], job["batches"][:1])[0][0]
    tr = TT.Trainer(_cfg(RAW_MODEL), mesh=dp_mesh, encoders=_encoders(),
                    zero1=True)
    out["raw"] = _run(tr, job["sd_raw"], [job["raw"]])[0][0]
    for flag in ("zero1", "zero3"):
        tr = TT.Trainer(_cfg(RAW_MODEL), mesh=dp_mesh, encoders=_encoders(),
                        finetune=True, **{flag: True})
        state = tr.init(seed=0)
        losses = []
        for _ in range(2):
            state, aux = tr.train_step(state, tr.shard_batch(job["raw"]))
            losses.append(float(aux["loss"]))
        out["finetune", flag] = (losses, _whole_state(tr, state))
    root = Path(job["root"])
    tr = TT.Trainer(_cfg(), mesh=meshes[2], tensor_parallel=True, zero1=True)
    state = tr.init(seed=0)
    tr.load_params(state, job["sd"])
    _fit(tr, job["batches"][:2], str(root / "saved"), state=state)
    tr = TT.Trainer(_cfg(), mesh=dp_mesh, zero3=True)
    state = _fit(tr, job["batches"][2:], str(root / "resumed"),
                 resume_from=str(root / "saved" / "checkpoints"))
    out["resumed"] = (state.step, _whole_state(tr, state))
    T.main(CLI + CLI_MESH + ["--output_dir", str(root / "cli")])
    out["cli_files"] = sorted(p.name for p in (root / "cli").iterdir())
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero")
    job = {}
    jtrees = {}
    for name, model in (("sd", MODEL), ("sd_raw", RAW_MODEL)):
        cfg = ModelConfig(**model)
        tree = _seeded_tree(init_fusion_params(
            torch.Generator().manual_seed(3), cfg), 3)
        jtrees[name] = tree
        job[name] = bridge.fusion_from_jax(tree, cfg).state_dict()
    job.update(batches=_batches(), raw=_raw_batch(), root=str(root))
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(job,), timeout_s=600)
    return dict(job=job, outs=outs, jtree=jtrees["sd"], root=root)


@pytest.fixture(scope="module")
def single(world):
    tr = TT.Trainer(_cfg(), device="cpu")
    grads = _step_grads(_run(tr, world["job"]["sd"],
                             world["job"]["batches"][:1])[1])
    losses, state = _run(tr, world["job"]["sd"], world["job"]["batches"])
    return (losses, {k: v.clone() for k, v in state.params.state_dict().items()},
            grads)


@pytest.fixture(scope="module")
def jax_single(world):
    import jax
    import jax.numpy as jnp
    from mmd_tpu.core.config import ModelConfig as JModelConfig
    from mmd_tpu.core.config import TrainConfig as JTrainConfig
    from mmd_tpu.training import trainer as JT
    jcfg = JTrainConfig(model=JModelConfig(**MODEL, dropout=0.0),
                        batch_size=B, lr=LR)
    opt = JT.make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, world["jtree"])
    state = JT.TrainState(jnp.zeros((), jnp.int32), params, opt.init(params),
                          jax.random.key(0))
    step = jax.jit(JT.make_raw_step(jcfg, opt))
    losses = []
    for b in world["job"]["batches"]:
        state, aux = step(state, b)
        losses.append(float(aux["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("model", [MODEL, {}], ids=["small", "default"])
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_zero_spec_tables_match_jax(model, dp):
    from mmd_tpu.parallel import tp as JTP
    shape = _jax_state_shape(model)
    whole = init_fusion_params(torch.Generator().manual_seed(0),
                               ModelConfig(**model))
    ndim = {n: p.dim() for n, p in whole.named_parameters()}
    for port, jax_fn in ((TP.zero1_specs, JTP.zero1_specs),
                         (TP.zero3_specs, JTP.zero3_specs)):
        got, want = port(whole, dp), jax_fn(shape, dp)
        want_p, want_m = (_jax_specs(want.params),
                          _jax_specs(want.opt_state[0].mu))
        assert got["params"].keys() == want_p.keys() == ndim.keys()
        for n in ndim:
            assert got["params"][n] == _pad(want_p[n], ndim[n]), n
            assert got["moments"][n] == _pad(want_m[n], ndim[n]), n


@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_single_device_and_jax(world, single, jax_single,
                                                  name):
    want_l, want_p, want_g = single
    jl, jparams = jax_single
    jflat = {n: (w.T if w.ndim == 2 else w)
             for n, w in zip(want_p, _flat_jax(jparams, list(want_p)))}
    dp = world["outs"][0]["traj", "dp"][0]
    for rank, out in enumerate(world["outs"]):
        assert_grads_close(out["grads1", name], want_g)
        losses, params, _ = out["traj", name]
        np.testing.assert_allclose(losses, want_l, **LOSS_TOL)
        np.testing.assert_allclose(losses, dp, rtol=2e-5)
        np.testing.assert_allclose(losses, jl, rtol=JAX_LOSS_RTOL)
        for n, w in want_p.items():
            np.testing.assert_allclose(params[n].numpy(), w.numpy(),
                                       **PARAM_TOL, err_msg=f"{rank} {n}")
            np.testing.assert_allclose(params[n].numpy(), jflat[n],
                                       **PARAM_TOL, err_msg=f"{rank} {n}")


@pytest.mark.parametrize("name", ["zero1", "zero3"])
def test_ranks_hold_the_jax_shard_shapes(world, name):
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from mmd_tpu.parallel import tp as JTP
    shape = _jax_state_shape(MODEL)
    specs = (JTP.zero1_specs if name == "zero1" else JTP.zero3_specs)(
        shape, WORLD)
    want_p, want_m = _jax_specs(specs.params), _jax_specs(specs.opt_state[0].mu)
    gshape = {n: tuple(s.shape) for n, s in zip(
        want_p, _flat_jax(shape.params, list(want_p)))}
    jmesh = JMesh(np.array(jax.devices()[:WORLD]).reshape(WORLD, 1),
                  ("data", "model"))
    split = 0
    for rank, out in enumerate(world["outs"]):
        params, moments = out["traj", name][2]
        for n in params:
            for got, spec in ((params[n], want_p[n]), (moments[n], want_m[n])):
                want = NamedSharding(jmesh, P(*spec)).shard_shape(gshape[n])
                port = tuple(reversed(got)) if len(got) == 2 else got
                assert port == tuple(want), (rank, n, got, want)
                split += port != gshape[n]
    assert split > 0


def test_zero3_eval_gathers_its_shards(world):
    tr = TT.Trainer(_cfg(), device="cpu")
    st = tr.init(seed=0)
    st.params.load_state_dict(world["job"]["sd"])
    want = tr.eval_step(st.params, tr.shard_batch(world["job"]["batches"][0]))
    for out in world["outs"]:
        got = out["eval"]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(got["nll"].numpy(), want["nll"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(got["preds"], want["preds"])


def test_accumulation_composes_with_zero3(world):
    for out in world["outs"]:
        np.testing.assert_allclose(out["accum", 2], out["accum", 1],
                                   rtol=2e-6)


def test_raw_path_under_zero1_matches_single_device(world):
    tr = TT.Trainer(_cfg(RAW_MODEL), device="cpu", encoders=_encoders())
    want = _run(tr, world["job"]["sd_raw"], [world["job"]["raw"]])[0][0]
    for out in world["outs"]:
        np.testing.assert_allclose(out["raw"], want, **LOSS_TOL)


@pytest.mark.parametrize("flag", ["zero1", "zero3"])
def test_finetune_with_zero_matches_single_device(world, flag):
    tr = TT.Trainer(_cfg(RAW_MODEL), device="cpu", encoders=_encoders(),
                    finetune=True)
    state = tr.init(seed=0)
    losses = []
    for _ in range(2):
        state, aux = tr.train_step(state, tr.shard_batch(world["job"]["raw"]))
        losses.append(float(aux["loss"]))
    want = state.params.state_dict()
    for out in world["outs"]:
        got_l, got = out["finetune", flag]
        np.testing.assert_allclose(got_l, losses, **LOSS_TOL)
        assert got.keys() == want.keys()
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4,
                                       atol=2 * LR, err_msg=n)


def test_checkpoint_resumes_across_meshes_and_on_one_device(world, single):
    """Saved under TP + ZeRO-1 on (2, 2) after two steps: the checkpoint is
    the single-device state; resumed under ZeRO-3 on (4, 1) and on one
    device, the third step ends where the uninterrupted run does."""
    _, want, _ = single
    ckpts = world["root"] / "saved" / "checkpoints"
    ckpt = CheckpointManager(ckpts).restore(map_location="cpu")
    assert ckpt["step"] == 2
    ref = TT.Trainer(_cfg(), device="cpu").init(seed=0)
    assert {k: v.shape for k, v in ckpt["params"].items()} == {
        k: v.shape for k, v in ref.params.state_dict().items()}
    for i, p in enumerate(ref.params.parameters()):     # the single layout
        for k in ("exp_avg", "exp_avg_sq"):
            assert ckpt["optimizer"]["state"][i][k].shape == p.shape
    cfg = dataclasses.replace(_cfg(), epochs=1, save_every=0, log_every=1,
                              output_dir=str(world["root"] / "one"),
                              resume_from=str(ckpts))
    one = run_training(TT.Trainer(cfg, device="cpu"),
                       lambda epoch: iter(world["job"]["batches"][2:]))
    assert one.step == 3
    for n, w in want.items():
        np.testing.assert_allclose(one.params.state_dict()[n].numpy(),
                                   w.numpy(), **PARAM_TOL, err_msg=n)
    for out in world["outs"]:
        step, got = out["resumed"]
        assert step == 3
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w.numpy(),
                                       **PARAM_TOL, err_msg=n)


def test_cli_over_the_world_logs_the_single_device_metrics(world, tmp_path):
    T.main(CLI + ["--output_dir", str(tmp_path)])

    def lines(d):
        return [json.loads(x) for x in
                (Path(d) / "metrics.jsonl").read_text().splitlines()]

    want, got = lines(tmp_path), lines(world["root"] / "cli")
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k in ("t", "train/samples_per_sec"):
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert world["outs"][0]["cli_files"] == [
        "best_model.pt", "checkpoints", "metrics.jsonl"]
    cfg = ModelConfig(text_input_dim=384, image_input_dim=1024, embed_dim=64,
                      num_heads=2, hidden_dim=16)
    load_params(str(world["root"] / "cli" / "best_model.pt"),
                init_fusion_params(torch.Generator().manual_seed(0), cfg))


def test_zero_flags_on_a_world_of_one_change_nothing(tmp_path):
    """Without a launch --zero1 and --zero3 train on a mesh of this one
    device, as on a one-device JAX mesh: the same metrics as without."""
    args = CLI[:CLI.index("--synthetic_samples")] + [
        "--synthetic_samples", "16", "--epochs", "1"]
    want = T.main(args + ["--output_dir", str(tmp_path / "a")])
    for flag in ("--zero1", "--zero3"):
        got = T.main(args + [flag, "--output_dir", str(tmp_path / flag)])
        assert got.step == want.step
        # a mesh of one holds the whole params
        g = got.params.state_dict()
        for n, w in want.params.state_dict().items():
            assert torch.equal(g[n], w), (flag, n)


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world["outs"])
