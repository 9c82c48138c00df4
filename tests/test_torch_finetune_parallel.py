"""Fine-tuning under text parallelism (sequence-, ring- and pipeline-parallel
text encoding in Trainer(text_parallelism=) and the train CLI) over a world
of 4 gloo ranks on the CPU, against tests/test_finetune_parallel.py.

One world for the module (the `world` fixture) runs every case of RUNS and
each rank hands back what it computed: one fp32 step at dropout 0 of the
joint tree (TINY_TEST with vocab 128 + VIT_TEST, and DEBERTA_TEST in fp32 +
VIT_TEST; batch 16, 16 tokens with padded tails, 32 px images) from
numpy-seeded weights, the loss and the whole gradient AdamW stepped with
(summed over "model", meaned over "data", gathered from the blocks). Both
are held against the JAX package's unsplit make_finetune_raw_step (its
loss within 1e-5 relative, its gradients at its own tolerances:
JAX_GRAD_TOL) and against the port's single-device fine-tuning step
(PORT_GRAD_REL of each leaf's largest |value|, as measured); no leaf's
gradient norm is off by a factor (FACTOR_RTOL). Beside them the Trainer
surface: sp with remat, pp with ZeRO-3 (each rank holds zero3_specs' shard
shapes, the text params move), ZeRO-1; the validations, message for
message; and `python -m torch.distributed.run --nproc_per_node 2 -m
mmd_tpu_torch.train --finetune_encoders --model_parallel 2
--text_parallelism pp --dist_backend gloo` on a small raw store (this file
as the launched module, which makes the encoders tiny): rank 0 alone
writes, its losses are the single-device CLI's, and its checkpoint resumes
on one device where the single-device run's does.

JAX is imported only inside fixtures and tests: a rank imports this file
to unpickle its body and must not load JAX.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmd_tpu_torch import bridge
from mmd_tpu_torch import train as T
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.core.mesh import make_mesh
from mmd_tpu_torch.data.labels import LABEL_TABLE
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models import text_encoder as TTE
from mmd_tpu_torch.models import vit as TV
from mmd_tpu_torch.models.fusion import init_fusion_params
from mmd_tpu_torch.models.frozen import FrozenEncoders
from mmd_tpu_torch.parallel import tp as TP
from mmd_tpu_torch.parallel import zero as Z
from mmd_tpu_torch.parallel.launch import spawn
from mmd_tpu_torch.training import trainer as TT

WORLD = 4
B, SEQ, IMAGE, LR = 16, 16, 32, 1e-3
MODEL = dict(text_input_dim=32, image_input_dim=32, embed_dim=32,
             num_heads=4, hidden_dim=16, compute_dtype="float32",
             dropout=0.0)
TEXT = {"bert": dataclasses.replace(TTE.TINY_TEST, vocab_size=128,
                                    dropout=0.0),
        "deberta": dataclasses.replace(TD.DEBERTA_TEST,
                                       compute_dtype="float32")}
# run -> (text family, text_parallelism, model axis, Trainer flags, remat)
RUNS = {
    "bert_sp": ("bert", "sp", 2, {}, False),
    "bert_sp_remat": ("bert", "sp", 2, {}, True),
    "bert_sp_ring_zero1": ("bert", "sp_ring", 2, {"zero1": True}, False),
    "bert_pp": ("bert", "pp", 2, {}, False),
    "bert_pp_remat": ("bert", "pp", 2, {}, True),
    "bert_pp_zero3": ("bert", "pp", 2, {"zero3": True}, False),
    "bert_sp_1x4": ("bert", "sp", 4, {}, False),
    "deberta_sp": ("deberta", "sp", 2, {}, False),
    "deberta_sp_ring": ("deberta", "sp_ring", 2, {}, False),
    "deberta_pp_zero1": ("deberta", "pp", 2, {"zero1": True}, False),
}
LOSS_RTOL = 1e-5
# the JAX package's tolerances (tests/test_finetune_parallel.py:79-104):
# rtol 1e-4 and this atol
JAX_GRAD_TOL = {("bert", "sp"): 1e-5, ("bert", "sp_ring"): 1e-3,
                ("bert", "pp"): 1e-3, ("deberta", "sp"): 2e-5,
                ("deberta", "sp_ring"): 1e-3, ("deberta", "pp"): 1e-3}
# against the port's single-device step: each leaf within this share of
# its largest |value|, plus PORT_GRAD_ATOL (the key projections' biases,
# whose true gradient is zero, hold noise of ~1e-9). The largest gap
# measured was 2.2e-6 (sp on (1, 4)), the order of fp32 sums in another
# split
PORT_GRAD_REL, PORT_GRAD_ATOL = 1e-5, 1e-8
# each leaf's gradient norm against the single-device one's (leaves of a
# norm above 1e-6): a leaf summed or not where it should be is off by a
# factor of 2 or 4; measured at most 7.8e-7 off
FACTOR_RTOL = 1e-4
CLI_ARGS = ["--device", "cpu", "--batch_size", "4", "--epochs", "1",
            "--lr", str(LR),
            "--log_every", "1", "--save_every", "0", "--compute_dtype",
            "float32", "--fused_attn", "--dropout", "0", "--embed_dim",
            "32", "--num_heads", "2", "--hidden_dim", "16",
            "--text_input_dim", "32", "--image_input_dim", "32",
            "--finetune_encoders"]
CLI_MESH = ["--model_parallel", "2", "--text_parallelism", "pp",
            "--dist_backend", "gloo"]


def _cfg(remat: bool = False) -> TrainConfig:
    return TrainConfig(model=ModelConfig(**MODEL), batch_size=B, lr=LR,
                       remat=remat)


def _batch(seed: int = 11) -> dict:
    """A raw batch: token ids with padded tails (a claim of one token),
    uint8 NHWC images, 4-path labels."""
    rng = np.random.default_rng(seed)
    batch = {}
    for side in ("claim", "doc"):
        lengths = rng.integers(1, SEQ + 1, size=B)
        lengths[0] = 1 if side == "claim" else SEQ
        mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, 100, size=(B, SEQ)).astype(np.int32)
        batch[f"{side}_ids"] = ids * mask
        batch[f"{side}_mask"] = mask
        batch[f"{side}_image"] = rng.integers(
            0, 256, size=(B, IMAGE, IMAGE, 3), dtype=np.uint8)
    batch["labels"] = LABEL_TABLE[rng.integers(0, 5, size=B)].astype(
        np.int32)
    return batch


def _joint_tree(family: str) -> L.ParamTree:
    """The port's joint tree of a family at init (the shapes)."""
    gen = torch.Generator().manual_seed(4)
    text = (TD.init_deberta(gen, TEXT[family]) if family == "deberta"
            else TTE.init_text_encoder(gen, TEXT[family]))
    return L.ParamTree({
        "fusion": init_fusion_params(gen, ModelConfig(**MODEL)),
        "text": text, "vit": TV.init_vit(gen, TV.VIT_TEST)})


def _seeded_jax_tree(family: str) -> dict:
    """The JAX-layout joint tree, each leaf moved by numpy-seeded noise:
    the weights both packages start from."""
    rng = np.random.default_rng(3)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return (node + rng.normal(0.0, 0.02, node.shape)).astype(np.float32)

    return move(bridge.to_jax_tree(_joint_tree(family)))


def _port_tree(family: str, jtree: dict) -> L.ParamTree:
    return bridge.finetune_from_jax(jtree, ModelConfig(**MODEL),
                                    TEXT[family], TV.VIT_TEST)


def _encoders(family: str, tree: L.ParamTree) -> FrozenEncoders:
    return FrozenEncoders(None, TEXT[family], tree["text"], TV.VIT_TEST,
                          tree["vit"])


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


def _one_step(trainer, sd: dict, batch: dict):
    """(loss, whole gradient, the state) of one step from the whole params
    `sd`."""
    state = trainer.init(seed=0)
    trainer.load_params(state, sd)
    state, aux = trainer.train_step(state, trainer.shard_batch(batch))
    return float(aux["loss"]), _step_grads(state), state


def _rank(rank, world, dev, job):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in (2, 4)}
    out = {"jax_loaded": "jax" in sys.modules}
    batch = job["batch"]
    for name, (family, mode, mp, flags, remat) in RUNS.items():
        sd = job["sd"][family]
        tree = _port_tree(family, job["jtree"][family])
        tr = TT.Trainer(_cfg(remat), mesh=meshes[mp],
                        encoders=_encoders(family, tree), finetune=True,
                        text_parallelism=mode, **flags)
        loss, grads, state = _one_step(tr, sd, batch)
        shapes = {n: tuple(p.shape) for n, p in state.params.named_parameters()}
        moved = {n: float((p.detach() - sd[n]).abs().max())
                 for n, p in tr.whole_params(state).named_parameters()}
        out[name] = {"loss": loss, "grads": grads, "shapes": shapes,
                     "moved": moved}
    return out


def _port_grads(family: str, grads: dict) -> dict:
    """{JAX key path: gradient} of a port gradient dict over the joint
    tree."""
    from tests.test_torch_raw_training import _flat
    tree = _port_tree(family, _seeded_jax_tree(family))
    for n, p in tree.named_parameters():
        p.grad = grads[n]
    return _flat(bridge.to_jax_tree(tree, grads=True))


@pytest.fixture(scope="module")
def world():
    jtree = {f: _seeded_jax_tree(f) for f in TEXT}
    job = {"jtree": jtree, "batch": _batch(),
           "sd": {f: _port_tree(f, t).state_dict() for f, t in jtree.items()}}
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(job,), timeout_s=600)
    return dict(job=job, outs=outs)


@pytest.fixture(scope="module")
def single(world):
    """The port's single-device fine-tuning step from the same weights, by
    family: (loss, gradient)."""
    out = {}
    for family in TEXT:
        tree = _port_tree(family, world["job"]["jtree"][family])
        tr = TT.Trainer(_cfg(), device="cpu",
                        encoders=_encoders(family, tree), finetune=True)
        loss, grads, _ = _one_step(tr, world["job"]["sd"][family],
                                   world["job"]["batch"])
        out[family] = (loss, grads)
    return out


@pytest.fixture(scope="module")
def jax_unsplit(world):
    """The JAX package's unsplit make_finetune_raw_step from the same
    weights, by family: (loss, {key path: gradient})."""
    import jax
    import jax.numpy as jnp
    from mmd_tpu.core.config import ModelConfig as JModelConfig
    from mmd_tpu.core.config import TrainConfig as JTrainConfig
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    from mmd_tpu.models import vit as JV
    from mmd_tpu.models.frozen import FrozenEncoders as JFrozen
    from mmd_tpu.training import trainer as JT
    from tests.test_torch_raw_training import _flat
    text = {"bert": dataclasses.replace(JTE.TINY_TEST, vocab_size=128,
                                        dropout=0.0),
            "deberta": dataclasses.replace(JD.DEBERTA_TEST,
                                           compute_dtype="float32")}
    cfg = JTrainConfig(model=JModelConfig(**MODEL), batch_size=B, lr=LR)
    out = {}
    for family, tcfg in text.items():
        params = jax.tree_util.tree_map(jnp.asarray,
                                        world["job"]["jtree"][family])
        enc = JFrozen(None, tcfg, params["text"], JV.VIT_TEST, params["vit"])
        step = JT.make_finetune_raw_step(cfg, enc)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            step.joint_loss, has_aux=True))(params, world["job"]["batch"],
                                            jax.random.key(1))
        out[family] = (float(loss), _flat(grads))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_grads_match_the_jax_unsplit_step(world, jax_unsplit, name):
    family, mode, *_ = RUNS[name]
    want_l, want = jax_unsplit[family]
    for rank, out in enumerate(world["outs"]):
        got = _port_grads(family, out[name]["grads"])
        assert abs(out[name]["loss"] - want_l) <= LOSS_RTOL * abs(want_l)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                       atol=JAX_GRAD_TOL[family, mode],
                                       err_msg=f"{name} rank {rank} {k}")


@pytest.mark.parametrize("name", list(RUNS))
def test_grads_match_the_single_device_step(world, single, name):
    family = RUNS[name][0]
    want_l, want = single[family]
    for rank, out in enumerate(world["outs"]):
        got = out[name]["grads"]
        assert abs(out[name]["loss"] - want_l) <= LOSS_RTOL * abs(want_l)
        assert got.keys() == want.keys()
        for n, w in want.items():
            gap = float((got[n] - w).abs().max())
            assert gap <= PORT_GRAD_REL * float(w.abs().max()) + PORT_GRAD_ATOL, (
                name, rank, n, gap)
            wn = float(w.norm())
            if wn > 1e-6:        # no leaf off by a factor of sp or pp
                assert abs(float(got[n].norm()) / wn - 1) <= FACTOR_RTOL, (
                    name, rank, n)


def test_pp_zero3_ranks_hold_the_zero3_shards(world):
    """Under pp with ZeRO-3 each rank holds zero3_specs' shard of every leaf
    (split over "data" along the JAX leading dim where it divides), and
    the text params move."""
    tree = _joint_tree("bert")
    dims = TP.port_dims(tree, TP.zero3_specs(tree, WORLD // 2)["params"])
    whole = {n: tuple(p.shape) for n, p in tree.named_parameters()}
    split = 0
    for out in world["outs"]:
        got = out["bert_pp_zero3"]["shapes"]
        assert got.keys() == whole.keys()
        for n, shape in whole.items():
            want = list(shape)
            for d in dims[n].values():
                want[d] //= WORLD // 2
            assert got[n] == tuple(want), n
            split += got[n] != shape
        moved = out["bert_pp_zero3"]["moved"]
        assert max(v for n, v in moved.items() if n.startswith("text.")) > 0
    assert split > 0


def test_remat_changes_no_gradient(world):
    for out in world["outs"]:
        for run, base in (("bert_sp_remat", "bert_sp"),
                          ("bert_pp_remat", "bert_pp")):
            assert out[run]["loss"] == out[base]["loss"]
            for n, w in out[base]["grads"].items():
                got = out[run]["grads"][n]
                assert float((got - w).abs().max()) <= (
                    1e-6 * float(w.abs().max())), (run, n)


def test_text_parallelism_validation():
    """The JAX Trainer's ValueErrors, message for message
    (mmd_tpu/training/trainer.py:517-526)."""
    tree = _joint_tree("bert")
    enc = _encoders("bert", tree)
    mesh = make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="fine-tuning surface"):
        TT.Trainer(_cfg(), mesh=mesh, text_parallelism="sp")
    with pytest.raises(ValueError, match="unknown text_parallelism"):
        TT.Trainer(_cfg(), mesh=mesh, encoders=enc, finetune=True,
                   text_parallelism="tp")
    for kw in (dict(mesh=mesh), dict(device="cpu")):
        with pytest.raises(ValueError, match="model axis >= 2"):
            TT.Trainer(_cfg(), encoders=enc, finetune=True,
                       text_parallelism="sp", **kw)
    with pytest.raises(ValueError, match="requires a mesh"):
        TT.make_finetune_raw_step(_cfg(), enc, text_mode="pp")


def _tree(root: Path) -> str:
    """A synthetic Factify tree, preprocessed: the train csv."""
    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
    synthetic_factify_tree(root, n_train=12, n_test=2, image_size=48)
    return str(preprocess_csv("train", root))


def _tiny_cli(setattr_=setattr) -> None:
    """The train CLI with tiny encoders and a 32 px store of 24 tokens."""
    from mmd_tpu_torch.models import frozen as TF
    from mmd_tpu_torch.pipelines import raw_store as TR
    setattr_(TF, "load_or_init_frozen", functools.partial(
        TF.load_or_init_frozen, tiny=True))
    setattr_(TR, "build_raw_store", functools.partial(
        TR.build_raw_store, image_size=32, max_length=24, io_workers=2))


def _metrics(d: Path) -> list:
    return [json.loads(x) for x in (d / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLI over a torchrun launch of 2 CPU ranks under pp, and on one
    device; each checkpoint resumed on one device for an epoch."""
    root = tmp_path_factory.mktemp("ft_cli")
    csv = _tree(root)
    env = {**os.environ, "MMD_TPU_ROOT": str(root), "PYTHONPATH": os.pathsep
           .join([str(Path(__file__).parent.parent), str(Path(__file__)
                                                        .parent)])}
    args = CLI_ARGS + ["--train_data", csv]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMD_TPU_ROOT", str(root))
        mp.chdir(root)
        _tiny_cli(mp.setattr)
        T.main(args + ["--output_dir", str(root / "one")])
        launch = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "test_torch_finetune_parallel",
             *args, *CLI_MESH, "--output_dir", str(root / "pp")],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        resumed = {run: T.main(
            args + ["--output_dir", str(root / f"{run}_resumed"),
                    "--resume_from", str(root / run / "checkpoints")])
            for run in ("one", "pp")}
    return dict(root=root, launch=launch, resumed=resumed)


def test_torchrun_cli_trains_under_pp_and_rank0_alone_writes(cli):
    root, launch = cli["root"], cli["launch"]
    assert launch.returncode == 0, launch.stderr[-3000:]
    assert launch.stdout.count("[train] done at step") == 1
    assert sorted(p.name for p in (root / "pp").iterdir()) == [
        "checkpoints", "metrics.jsonl"]
    got, want = _metrics(root / "pp"), _metrics(root / "one")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train/total_loss"],
                                   w["train/total_loss"], rtol=LOSS_RTOL)


def test_pp_checkpoint_resumes_on_one_device(cli):
    """The checkpoint written under pp is the single-device state: resumed
    on one device for an epoch, it ends where the single-device run's
    checkpoint, resumed the same way, does."""
    from mmd_tpu_torch.core.checkpoint import CheckpointManager
    root = cli["root"]
    ckpts = {run: CheckpointManager(root / run / "checkpoints").restore(
        map_location="cpu") for run in ("one", "pp")}
    assert ckpts["pp"]["step"] == ckpts["one"]["step"] == 3
    assert ckpts["pp"]["params"].keys() == ckpts["one"]["params"].keys()
    for n, w in ckpts["one"]["params"].items():
        np.testing.assert_allclose(ckpts["pp"]["params"][n].numpy(),
                                   w.numpy(), rtol=1e-4, atol=3 * LR,
                                   err_msg=n)
    one, pp = cli["resumed"]["one"], cli["resumed"]["pp"]
    assert one.step == pp.step == 6
    want = one.params.state_dict()
    for n, w in want.items():
        np.testing.assert_allclose(pp.params.state_dict()[n].numpy(),
                                   w.numpy(), rtol=1e-4, atol=6 * LR,
                                   err_msg=n)


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world["outs"])


if __name__ == "__main__":
    # the module a torch.distributed.run launch of the tests starts
    _tiny_cli()
    T.main(sys.argv[1:])
