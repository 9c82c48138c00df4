"""Tensor-parallel training of the fusion model over a world of 4 gloo ranks
on the CPU: the Megatron specs, the TP pieces, TP and TP + ZeRO-1 in the
Trainer, and the dropout seeds of a mesh, against tests/test_tp.py.

One world for the module (the `world` fixture) runs every case and each
rank hands back what it computed:
  * fused_mlp(tp_mesh=) at rate 0 on (2, 2) and (1, 4) (the plain path),
    held against the unsplit fused_mlp (rtol 2e-5, atol 2e-6);
  * the gradients of the mean loss with the params split by the Megatron
    specs against those with the params replicated, on (2, 2) and (1, 4),
    explicit attention (rtol 5e-5, atol 1e-7) and fused_attn at head dim 32
    (the plain flash forward and backward; rtol 5e-4, atol 1e-6);
  * three fp32 steps at dropout 0 of DP on (2, 2), TP on (2, 2) and
    (1, 4), and TP + ZeRO-1 on (2, 2), from numpy-seeded weights that
    bridge.fusion_from_jax carries across: losses against the port's
    single-device Trainer (rtol 1e-6, atol 1e-6; TP + ZeRO-1 against DP at
    rtol 2e-5) and against the JAX package's single-device step
    (tests/test_torch_training.py's loss limit, rtol 1e-5); the first
    step's gradient (gathered from the blocks AdamW stepped) within that
    file's gradient limit of the single-device one; params within
    the lr-scaled noise budget of tests/test_scaling.py:91-97 (rtol 1e-4,
    atol steps * lr) of both; every rank's blocks of the params and the
    moments of the JAX package's shard shapes on the same mesh;
  * accumulation (accum 2 against 1, rtol 2e-6) under TP, and the raw
    path under TP (tiny frozen encoders whole on every rank) against the
    single-device raw step;
  * the dropout pins: the seeds of a rank-local site differ on every rank,
    a replicated site's agree along "model", the fused MLP's output mask
    is the same on every model rank, and its output at rate 0.1 is the
    unsplit layer with the ranks' hidden masks side by side.
The spec tables (`state_specs`, `tp_zero1_specs`) are held leaf for leaf
against the JAX package's over jax.eval_shape(init_state). A world of one
reproduces the single-device step bit for bit at dropout 0.1. JAX is
imported only inside fixtures and tests: a rank imports this file to
unpickle its body and must not load JAX.
"""

import sys

import numpy as np
import pytest
import torch

from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.core.mesh import DATA_AXIS, batch_sharding, make_mesh
from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models import text_encoder as TTE
from mmd_tpu_torch.models import vit as TV
from mmd_tpu_torch.models.fusion import init_fusion_params
from mmd_tpu_torch.models.frozen import FrozenEncoders
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops import mlp as M
from mmd_tpu_torch.parallel import collectives as C
from mmd_tpu_torch.parallel import tp as TP
from mmd_tpu_torch.parallel import zero as Z
from mmd_tpu_torch.parallel.launch import spawn
from mmd_tpu_torch.training import trainer as TT

WORLD = 4
MODEL = dict(text_input_dim=16, image_input_dim=24, embed_dim=32,
             num_heads=4, hidden_dim=16, compute_dtype="float32")
FUSED = dict(MODEL, embed_dim=128, fused_attn=True)     # head dim 32
SEQ = dict(text_seq=8, image_seq=4, text_dim=16, image_dim=24)
B, LR, STEPS = 16, 1e-3, 3
TRAJ = {"dp_2x2": (2, {}), "tp_2x2": (2, dict(tensor_parallel=True)),
        "tp_1x4": (4, dict(tensor_parallel=True)),
        "tp_zero1_2x2": (2, dict(tensor_parallel=True, zero1=True))}
MLP_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-5, atol=1e-7)
FUSED_GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
JAX_LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=STEPS * LR)


def _cfg(model=MODEL, dropout=0.0, **kw) -> TrainConfig:
    return TrainConfig(model=ModelConfig(**model, dropout=dropout),
                       batch_size=B, lr=LR, **kw)


def _batches(n=STEPS, seed=0) -> list:
    rng = np.random.default_rng(seed)
    return [synthetic_preembed_batch(rng, B, **SEQ) for _ in range(n)]


def _seeded_tree(params, seed: int):
    """The JAX-layout tree of a port param tree, each leaf moved by
    numpy-seeded noise: the weights both packages start from."""
    rng = np.random.default_rng(seed)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return (node + rng.normal(0.0, 0.02, node.shape)).astype(np.float32)

    return move(bridge.to_jax_tree(params))


def _whole(model: dict, sd: dict) -> L.ParamTree:
    params = init_fusion_params(torch.Generator().manual_seed(0),
                                ModelConfig(**model))
    params.load_state_dict(sd)
    return params


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _run(trainer, sd: dict, batches: list):
    """Losses and the gathered state of STEPS steps from the whole params
    `sd`."""
    state = trainer.init(seed=0)
    trainer.load_params(state, sd)
    losses = []
    for b in batches:
        state, aux = trainer.train_step(state, trainer.shard_batch(b))
        losses.append(float(aux["loss"]))
    return losses, state


def _step_grads(state) -> dict:
    """The whole gradient AdamW stepped with (over a mesh: its blocks,
    gathered)."""
    if not isinstance(state.optimizer, Z.ShardedAdamW):
        return {n: p.grad.clone() for n, p in state.params.named_parameters()}
    lay = state.optimizer.layout
    leaves = state.optimizer.inner.param_groups[0]["params"]
    whole = TP.gather_blocks([p.grad for p in leaves],
                             [lay.moment_dims[n] for n in lay.names],
                             lay.mesh)
    return {n: g.clone() for n, g in zip(lay.names, whole)}


def assert_grads_close(got: dict, want: dict, rel=1e-4, atol=1e-7) -> None:
    """Each leaf within rel of its largest |value| plus atol
    (tests/test_torch_training.py's gradient limit)."""
    assert got.keys() == want.keys()
    for n, w in want.items():
        gap = float((got[n] - w).abs().max())
        assert gap <= rel * float(w.abs().max()) + atol, (n, gap)


def _shapes(state) -> tuple:
    params = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
    inner = state.optimizer.inner
    moments = {n: tuple(inner.state[leaf]["exp_avg"].shape)
               for n, leaf in zip(params, inner.param_groups[0]["params"])}
    return params, moments


def _grads(model: dict, sd: dict, batch: dict, mesh, tensor_parallel: bool
           ) -> dict:
    """The whole gradients of the mean loss over the mesh's batch."""
    cfg = ModelConfig(**model, dropout=0.0, tensor_parallel=tensor_parallel)
    params = _whole(model, sd)
    specs = (TP.state_specs(params) if tensor_parallel else
             {n: (None,) * p.dim() for n, p in params.named_parameters()})
    params = TP.shard_tree(params, specs, mesh)
    rows = {k: v[batch_sharding(mesh, B)] for k, v in _tensors(batch).items()}
    loss, _ = TT._loss_fn(params, cfg, rows, None, deterministic=True,
                          mesh=mesh)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params.parameters()]      # leaves this mode skips
    C.pmean_(grads, mesh, DATA_AXIS)
    dims = TP.port_dims(params, specs)
    whole = TP.gather_blocks(grads, list(dims.values()), mesh)
    return {n: g.clone() for n, g in zip(dims, whole)}


def _mlp_inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 8, 128)).astype(np.float32)
    w1 = (rng.standard_normal((128, 256)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(256) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(128) * 0.1).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]


def _mlp_tp(mesh, rate: float, seed: int):
    """fused_mlp(tp_mesh=) on the rank's rows and slices, its two mask
    seeds split from `seed` and folded as the fusion forward folds an MLP's
    (FusionParallel.split); with the seeds the kernel drew from."""
    x, w1, b1, w2, b2 = _mlp_inputs()
    tp, i = mesh.shape["model"], mesh.axis_index("model")
    f = w1.shape[1] // tp
    x = x[batch_sharding(mesh, x.shape[0])]
    seed = tuple(TP.FusionParallel(mesh, tensor_parallel=True).split(seed, 2))
    seen = []
    real = M.fused_mlp_fwd

    def record(x2, w1_, b1_, w2_, b2_, seeds, rate_):
        seen.append(seeds)
        return real(x2, w1_, b1_, w2_, b2_, seeds, rate_)
    M.fused_mlp_fwd = record
    try:
        y = M.fused_mlp(x, w1[:, i * f:(i + 1) * f], b1[i * f:(i + 1) * f],
                        w2[i * f:(i + 1) * f], b2, rate, seed,
                        torch.float32, tp_mesh=mesh)
    finally:
        M.fused_mlp_fwd = real
    return y.detach(), seen[0]


def _raw_batch():
    rng = np.random.default_rng(4)
    return {
        "claim_ids": rng.integers(1, 100, (B, 16)).astype(np.int32),
        "claim_mask": np.ones((B, 16), np.int32),
        "doc_ids": rng.integers(1, 100, (B, 16)).astype(np.int32),
        "doc_mask": np.ones((B, 16), np.int32),
        "claim_image": rng.integers(0, 255, (B, 32, 32, 3)).astype(np.uint8),
        "doc_image": rng.integers(0, 255, (B, 32, 32, 3)).astype(np.uint8),
        "labels": np.stack([np.array([0, 1, 1, 1], np.int32)] * B),
    }


def _encoders() -> FrozenEncoders:
    gen = torch.Generator().manual_seed(2)
    return FrozenEncoders(None, TTE.TINY_TEST,
                          TTE.init_text_encoder(gen, TTE.TINY_TEST),
                          TV.VIT_TEST, TV.init_vit(gen, TV.VIT_TEST))


RAW_MODEL = dict(MODEL, text_input_dim=32, image_input_dim=32)


def _rank(rank, world, dev, job):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in (2, 4, 1)}
    out = {"jax_loaded": "jax" in sys.modules}
    for mp in (2, 4):
        mesh = meshes[mp]
        out["mlp", mp] = _mlp_tp(mesh, 0.0, 0)[0]
        out["mlp_drop", mp] = _mlp_tp(mesh, 0.1, 11)
        try:
            M.fused_mlp(*_mlp_inputs(), 0.1, 11, torch.float32, tp_mesh=mesh)
            out["layer_seed_refused", mp] = False
        except ValueError:
            out["layer_seed_refused", mp] = True
        for name, model, sd in (("explicit", MODEL, job["sd"]),
                                ("fused", FUSED, job["sd_fused"])):
            out["grads", name, mp] = (
                _grads(model, sd, job["batches"][0], mesh, False),
                _grads(model, sd, job["batches"][0], mesh, True))
        par = TP.FusionParallel(mesh, tensor_parallel=True)
        out["seeds", mp] = (par.seed(123, local=True), par.seed(123))
    out["seeds_dp"] = TP.FusionParallel(meshes[1]).seed(123, local=True)
    for name, (mp, flags) in TRAJ.items():
        tr = TT.Trainer(_cfg(), mesh=meshes[mp], **flags)
        out["grads1", name] = _step_grads(_run(tr, job["sd"],
                                               job["batches"][:1])[1])
        losses, state = _run(tr, job["sd"], job["batches"])
        whole = tr.whole_params(state)
        out["traj", name] = (losses, {k: v.clone() for k, v in
                                      whole.state_dict().items()},
                             _shapes(state))
    for accum in (1, 2):
        tr = TT.Trainer(_cfg(accum_steps=accum), mesh=meshes[2],
                        tensor_parallel=True)
        out["accum", accum] = _run(tr, job["sd"], job["batches"][:1])[0][0]
    tr = TT.Trainer(_cfg(RAW_MODEL), mesh=meshes[2], encoders=_encoders(),
                    tensor_parallel=True)
    out["raw"] = _run(tr, job["sd_raw"], [job["raw"]])[0][0]
    return out


@pytest.fixture(scope="module")
def world():
    trees = {}
    for name, model in (("sd", MODEL), ("sd_fused", FUSED),
                        ("sd_raw", RAW_MODEL)):
        cfg = ModelConfig(**model)
        tree = _seeded_tree(init_fusion_params(
            torch.Generator().manual_seed(3), cfg), 3)
        trees[name] = (tree, bridge.fusion_from_jax(tree, cfg).state_dict())
    job = {k: sd for k, (_, sd) in trees.items()}
    job.update(batches=_batches(), raw=_raw_batch())
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(job,), timeout_s=600)
    return dict(job=job, outs=outs, jtree=trees["sd"][0])


@pytest.fixture(scope="module")
def single(world):
    """The port's single-device trajectory from the same weights, and its
    first step's gradient."""
    tr = TT.Trainer(_cfg(), device="cpu")
    grads = _step_grads(_run(tr, world["job"]["sd"],
                             world["job"]["batches"][:1])[1])
    losses, state = _run(tr, world["job"]["sd"], world["job"]["batches"])
    return (losses, {k: v.clone() for k, v in state.params.state_dict().items()},
            grads)


@pytest.fixture(scope="module")
def jax_single(world):
    """The JAX package's single-device step from the same weights: losses
    and params (JAX layout) after each of STEPS steps."""
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


def _jax_specs(tree) -> dict:
    """{port state-dict name: spec tuple} of a JAX PartitionSpec tree over
    fusion params, each padded with None to its leaf's rank later."""
    import jax
    from jax.sharding import PartitionSpec as P
    names = {"w": "weight", "b": "bias", "scale": "weight"}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        keys[-1] = names.get(keys[-1], keys[-1])
        out[".".join(keys)] = tuple(spec)
    return out


def _pad(spec: tuple, n: int) -> tuple:
    return tuple(spec) + (None,) * (n - len(spec))


def _jax_state_shape(model: dict):
    import jax
    from mmd_tpu.core.config import ModelConfig as JModelConfig
    from mmd_tpu.core.config import TrainConfig as JTrainConfig
    from mmd_tpu.training import trainer as JT
    jcfg = JTrainConfig(model=JModelConfig(**model))
    return jax.eval_shape(lambda: JT.init_state(jcfg, jax.random.key(0)))


@pytest.mark.parametrize("model", [MODEL, {}], ids=["small", "default"])
def test_tp_spec_tables_match_jax(model):
    from mmd_tpu.parallel import tp as JTP
    shape = _jax_state_shape(model)
    whole = init_fusion_params(torch.Generator().manual_seed(0),
                               ModelConfig(**model))
    ndim = {n: p.dim() for n, p in whole.named_parameters()}
    specs = JTP.state_specs(shape)
    want = _jax_specs(specs.params)
    mu = _jax_specs(specs.opt_state[0].mu)
    got = TP.state_specs(whole)
    assert got.keys() == want.keys() == mu.keys()
    for n in got:
        assert got[n] == _pad(want[n], ndim[n]) == _pad(mu[n], ndim[n]), n
    for dp in (2, 4):
        jz = JTP.tp_zero1_specs(shape, dp)
        pz = TP.tp_zero1_specs(whole, dp)
        want_p, want_m = _jax_specs(jz.params), _jax_specs(jz.opt_state[0].mu)
        for n in got:
            assert pz["params"][n] == _pad(want_p[n], ndim[n]), n
            assert pz["moments"][n] == _pad(want_m[n], ndim[n]), (dp, n)


def test_tp_specs_split_the_right_leaves():
    """The port's layout of tests/test_tp.py:38-63: a column split is the
    port's dim 0, a row split its dim 1."""
    whole = init_fusion_params(torch.Generator().manual_seed(0),
                               ModelConfig(**MODEL))
    dims = TP.port_dims(whole, TP.state_specs(whole))
    rep = "representation."
    assert dims[rep + "text_WQ.weight"] == {"model": 0}
    assert dims[rep + "text_WQ.bias"] == {"model": 0}
    assert dims[rep + "text_self_attn_out.weight"] == {"model": 1}
    assert dims[rep + "text_self_attn_out.bias"] == {}
    assert dims[rep + "text_mlp.fc1.weight"] == {"model": 0}
    assert dims[rep + "text_mlp.fc2.weight"] == {"model": 1}
    assert dims[rep + "text_self_ln1.weight"] == {}
    assert dims[rep + "text_proj.weight"] == {}
    head = "classifier.mlp_text_given_text."
    assert dims[head + "fc0.weight"] == {"model": 0}
    assert dims[head + "fc1.weight"] == {"model": 1}


@pytest.mark.parametrize("mp", [2, 4])
def test_fused_mlp_tp_matches_unsplit(world, mp):
    x, w1, b1, w2, b2 = _mlp_inputs()
    want = M.fused_mlp(x, w1, b1, w2, b2, 0.0, None, torch.float32)
    for rank, out in enumerate(world["outs"]):
        rows = slice((rank // mp) * (16 // (4 // mp)),
                     (rank // mp + 1) * (16 // (4 // mp)))
        np.testing.assert_allclose(out["mlp", mp].numpy(),
                                   want[rows].detach().numpy(), **MLP_TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("attn", ["explicit", "fused"])
def test_tp_grads_match_replicated(world, attn, mp):
    tol = FUSED_GRAD_TOL if attn == "fused" else GRAD_TOL
    for rank, out in enumerate(world["outs"]):
        repl, split = out["grads", attn, mp]
        assert repl.keys() == split.keys()
        for n in repl:
            np.testing.assert_allclose(split[n].numpy(), repl[n].numpy(),
                                       **tol, err_msg=f"rank {rank} {n}")


@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_single_device_and_jax(world, single, jax_single,
                                                  name):
    want_l, want_p, want_g = single
    jl, jparams = jax_single
    jflat = {n: (w.T if w.ndim == 2 else w)
             for n, w in zip(want_p, _flat_jax(jparams, list(want_p)))}
    for rank, out in enumerate(world["outs"]):
        assert_grads_close(out["grads1", name], want_g)
        losses, params, _ = out["traj", name]
        np.testing.assert_allclose(losses, want_l, **LOSS_TOL)
        np.testing.assert_allclose(losses, jl, rtol=JAX_LOSS_RTOL)
        for n, w in want_p.items():
            np.testing.assert_allclose(params[n].numpy(), w.numpy(),
                                       **PARAM_TOL, err_msg=f"{rank} {n}")
            np.testing.assert_allclose(params[n].numpy(), jflat[n],
                                       **PARAM_TOL, err_msg=f"{rank} {n}")
    dp = world["outs"][0]["traj", "dp_2x2"][0]
    np.testing.assert_allclose(world["outs"][0]["traj", name][0], dp,
                               rtol=2e-5)


def _flat_jax(tree, names) -> list:
    """The JAX tree's leaves in the order of the port's state-dict names."""
    out = []
    for n in names:
        node = tree
        *path, leaf = n.split(".")
        for k in path:
            node = node[k]
        out.append(node[{"weight": "w", "bias": "b"}[leaf]] if "w" in node
                   else node[{"weight": "scale", "bias": "bias"}[leaf]])
    return out


@pytest.mark.parametrize("name", ["tp_2x2", "tp_1x4", "tp_zero1_2x2"])
def test_ranks_hold_the_jax_shard_shapes(world, name):
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from mmd_tpu.parallel import tp as JTP
    mp, flags = TRAJ[name]
    shape = _jax_state_shape(MODEL)
    specs = (JTP.tp_zero1_specs(shape, WORLD // mp) if flags.get("zero1")
             else JTP.state_specs(shape))
    want_p, want_m = _jax_specs(specs.params), _jax_specs(specs.opt_state[0].mu)
    gshape = {n: tuple(s.shape) for n, s in zip(
        want_p, _flat_jax(shape.params, list(want_p)))}
    jmesh = JMesh(np.array(jax.devices()[:WORLD]).reshape(WORLD // mp, mp),
                  ("data", "model"))
    for rank, out in enumerate(world["outs"]):
        params, moments = out["traj", name][2]
        for n, (got_p, got_m) in ((n, (params[n], moments[n]))
                                  for n in params):
            for got, spec in ((got_p, want_p[n]), (got_m, want_m[n])):
                want = NamedSharding(jmesh, P(*spec)).shard_shape(gshape[n])
                port = tuple(reversed(got)) if len(got) == 2 else got
                assert port == tuple(want), (rank, n, got, want)


def test_accumulation_composes_with_tp(world):
    for out in world["outs"]:
        np.testing.assert_allclose(out["accum", 2], out["accum", 1],
                                   rtol=2e-6)


def test_raw_path_under_tp_matches_single_device(world):
    tr = TT.Trainer(_cfg(RAW_MODEL), device="cpu", encoders=_encoders())
    want = _run(tr, world["job"]["sd_raw"], [world["job"]["raw"]])[0][0]
    for out in world["outs"]:
        np.testing.assert_allclose(out["raw"], want, **LOSS_TOL)


def test_dropout_seeds_fold_by_rank(world):
    """Documented divergence (ROADMAP §C): under a mesh the ranks draw
    from folded seeds. A rank-local site's seed differs on every rank; a
    replicated site's agrees along "model" and differs along "data"."""
    outs = world["outs"]
    for mp in (2, 4):
        local = [o["seeds", mp][0] for o in outs]
        repl = [o["seeds", mp][1] for o in outs]
        assert len(set(local)) == WORLD
        for r in range(WORLD):
            same_data = [repl[q] for q in range(WORLD) if q // mp == r // mp]
            assert set(same_data) == {repl[r]}
        assert len(set(repl)) == WORLD // mp
    assert len({o["seeds_dp"] for o in outs}) == WORLD
    masks = [D.keep_scale(s, (8, 64), 0.1) for s in
             (o["seeds", 2][0] for o in outs)]
    assert all(not torch.equal(masks[a], masks[b])
               for a in range(WORLD) for b in range(a))


@pytest.mark.parametrize("mp", [2, 4])
def test_fused_mlp_under_tp_refuses_an_unfolded_layer_seed(world, mp):
    """Under tp_mesh the seeds must come folded (FusionParallel.split): a
    bare layer seed would give every model rank the same hidden mask, so
    fused_mlp refuses it."""
    assert all(o["layer_seed_refused", mp] for o in world["outs"])


@pytest.mark.parametrize("mp", [2, 4])
def test_fused_mlp_output_mask_is_shared_along_model(world, mp):
    """The output mask's seed is folded by data alone, so every model rank
    drops the same outputs, and the output at rate 0.1 is the unsplit
    layer with the ranks' hidden masks side by side (mask * sum(partials)
    == sum(mask * partials))."""
    x, w1, b1, w2, b2 = _mlp_inputs()
    rate = 0.1
    outs = world["outs"]
    f = w1.shape[1] // mp
    for d in range(WORLD // mp):
        ranks = range(d * mp, (d + 1) * mp)
        seeds = [outs[r]["mlp_drop", mp][1] for r in ranks]
        assert len({s[1] for s in seeds}) == 1
        assert len({s[0] for s in seeds}) == mp
        rows = slice(d * (16 // (WORLD // mp)),
                     (d + 1) * (16 // (WORLD // mp)))
        xr = x[rows].reshape(-1, 128)
        m1 = torch.cat([D.keep_scale(s[0], (xr.shape[0], f), rate)
                        for s in seeds], dim=1)
        m2 = D.keep_scale(seeds[0][1], (xr.shape[0], 128), rate)
        h = M.gelu_tanh(xr @ w1 + b1) * m1
        want = ((h @ w2 + b2) * m2).reshape(x[rows].shape)
        for r in ranks:
            np.testing.assert_allclose(outs[r]["mlp_drop", mp][0].numpy(),
                                       want.numpy(), **MLP_TOL)
        assert torch.equal(outs[ranks[0]]["mlp_drop", mp][0],
                           outs[ranks[-1]]["mlp_drop", mp][0])


@pytest.mark.parametrize("flags", [{}, dict(zero1=True), dict(zero3=True)])
def test_world_of_one_is_the_single_device_step_bit_for_bit(flags):
    """At dropout 0.1 a mesh of one device draws the single-device masks
    (index (0, 0) leaves every seed unchanged) and its AdamW steps the
    same tensors: two steps give the same losses and params, bit for
    bit."""
    cfg = _cfg(dropout=0.1)
    sd = init_fusion_params(torch.Generator().manual_seed(5),
                            cfg.model).state_dict()
    want_l, want = _run(TT.Trainer(cfg, device="cpu"), sd, _batches(2))
    tr = TT.Trainer(cfg, mesh=make_mesh(1, device="cpu"), **flags)
    got_l, got = _run(tr, sd, _batches(2))
    assert got_l == want_l
    got = tr.whole_params(got)
    for (n, a), (_, b) in zip(got.state_dict().items(),
                              want.params.state_dict().items()):
        assert torch.equal(a, b), n


def test_tp_validation_refuses_what_jax_refuses():
    mesh = make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="model axis >= 2"):
        TT.Trainer(_cfg(), mesh=mesh, tensor_parallel=True)
    with pytest.raises(ValueError, match="finetune composes"):
        TT.Trainer(_cfg(), mesh=mesh, encoders=_encoders(), finetune=True,
                   tensor_parallel=True)
    with pytest.raises(ValueError, match="exclusive"):
        TT.Trainer(_cfg(), mesh=mesh, zero3=True, tensor_parallel=True)

    class Axis:        # a model axis of 3: 4 heads do not divide
        shape = {"data": 1, "model": 3}
    with pytest.raises(ValueError, match="num_heads"):
        TP.validate_tp_config(ModelConfig(**MODEL), Axis())
    with pytest.raises(ValueError,
                       match="text_parallelism needs a model axis >= 2"):
        TT.Trainer(_cfg(), mesh=mesh, encoders=_encoders(), finetune=True,
                   text_parallelism="pp")


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world["outs"])
