"""Pipeline-parallel encoder serving (mmd_tpu_torch/parallel/pp.py) over a
world of 4 gloo ranks on the CPU, against tests/test_pp.py's claims.

One world for the module (the `world` fixture) runs every case on the
meshes (1, 4), (2, 2) and (4, 1) -- 4 stages, 2 stages with each
microbatch sharded over "data", and 1 stage over 4 data ranks (where a
microbatch of 2 rows does not divide and stays replicated) -- and each
rank hands back its (B, T, D) output. Cases: the BERT-class stack of 4
layers at 2 and 4 microbatches, without a mask, on the kernel path (the
kernel's plain version on the CPU); the MPNet relative-bias path; DeBERTa
at 2 and 4 microbatches and without a mask.

Two comparisons, on numpy-seeded weights (the port's init in the JAX
layout, each leaf moved by seeded noise) that
bridge.{text_encoder,deberta}_from_jax carries across, and numpy-seeded
inputs:
  * every rank's output against the port's own unsplit forward, at the JAX
    tests' limits: rtol 2e-5, atol 2e-6;
  * the JAX package's pipeline_encode(_deberta), jitted on the virtual CPU
    mesh (2, 2) with the same microbatches, within rtol 1e-4, atol 1e-5
    (fp32 matmuls summed in another order on each side).
JAX is imported only inside the fixtures and tests: a rank imports this
file to unpickle its body and must not load JAX.
"""

import dataclasses
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.mesh import make_mesh
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.models import text_encoder as TTE
from mmd_tpu_torch.parallel import pp as PP
from mmd_tpu_torch.parallel.launch import spawn

WORLD = 4
MESHES = (4, 2, 1)                 # model_parallel: (1, 4), (2, 2), (4, 1)
TOL = dict(rtol=2e-5, atol=2e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
LAYERS = 4

# name -> (family, microbatches, masked, fused)
CASES = {
    "bert_m4": ("bert", 4, True, False),
    "bert_m2": ("bert", 2, True, False),
    "bert_no_mask": ("bert", 2, False, False),
    "bert_kernel_path": ("bert", 4, True, True),
    "mpnet": ("mpnet", 4, True, False),
    "deberta_m4": ("deberta", 4, True, False),
    "deberta_m2": ("deberta", 2, True, False),
    "deberta_no_mask": ("deberta", 2, False, False),
}
JAX_CASES = ("bert_m4", "bert_kernel_path", "mpnet", "deberta_m2")


def _configs(family: str, fused: bool):
    """(JAX config, port config) of one family, the same fields."""
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    if family == "deberta":
        kw = dict(num_layers=LAYERS, compute_dtype="float32")
        return (dataclasses.replace(JD.DEBERTA_TEST, **kw),
                dataclasses.replace(TD.DEBERTA_TEST, **kw))
    kw = dict(vocab_size=120, num_layers=LAYERS, dropout=0.0,
              compute_dtype="float32")
    if family == "mpnet":
        kw.update(relative_bias_buckets=8, mpnet_positions=True,
                  type_vocab_size=0, pad_token_id=1)
    return (dataclasses.replace(JTE.TINY_TEST, fused_attn=False, **kw),
            dataclasses.replace(TTE.TINY_TEST, fused_attn=fused, **kw))


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


def _weights(family: str, cfg, seed: int):
    """(JAX tree, port params) of the same numpy-seeded weights."""
    gen = torch.Generator().manual_seed(seed)
    if family == "deberta":
        tree = _seeded_tree(TD.init_deberta(gen, cfg), seed)
        return tree, bridge.deberta_from_jax(tree, cfg)
    tree = _seeded_tree(TTE.init_text_encoder(gen, cfg), seed)
    return tree, bridge.text_encoder_from_jax(tree, cfg)


def _inputs(seed: int, masked: bool, b=8, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 100, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[:, 13:] = 0
    mask[5, 4:] = 0
    return ids, (mask if masked else None)


def _encode(c, mesh=None):
    """The case's pipelined encode over `mesh`, or its unsplit forward."""
    if mesh is None:
        fn = TD.deberta_encode if c["deberta"] else TTE.encode
        return fn(c["params"], c["cfg"], c["ids"], c["mask"])
    fn = PP.pipeline_encode_deberta if c["deberta"] else PP.pipeline_encode
    return fn(c["params"], c["cfg"], c["ids"], c["mask"], mesh=mesh,
              num_microbatches=c["m"])


def _rank(rank, world, dev, cases):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in MESHES}
    out = {"jax_loaded": "jax" in sys.modules}
    with torch.no_grad():
        for name, c in cases.items():
            for mp, mesh in meshes.items():
                out[name, mp] = _encode(c, mesh)
    return out


@pytest.fixture(scope="module")
def world():
    cases, jax_side = {}, {}
    for seed, (name, (family, m, masked, fused)) in enumerate(CASES.items()):
        jcfg, tcfg = _configs(family, fused)
        tree, params = _weights(family, tcfg, seed)
        ids, mask = _inputs(seed, masked)
        cases[name] = dict(
            cfg=tcfg, params=params.eval(), deberta=family == "deberta", m=m,
            ids=torch.from_numpy(ids).long(),
            mask=None if mask is None else torch.from_numpy(mask))
        jax_side[name] = (jcfg, tree, ids, mask)
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(cases,), timeout_s=300)
    with torch.no_grad():
        want = {name: _encode(c) for name, c in cases.items()}
    return cases, jax_side, outs, want


@pytest.mark.parametrize("mp", MESHES)
@pytest.mark.parametrize("name", CASES)
def test_pipeline_encode_matches_unsplit(world, name, mp):
    _, _, outs, want = world
    for rank, out in enumerate(outs):
        got = out[name, mp]
        assert got.shape == want[name].shape
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), **TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_pipeline_encode_matches_jax(world, name):
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    from mmd_tpu.parallel import pp as JPP
    cases, jax_side, outs, _ = world
    jcfg, tree, ids, mask = jax_side[name]
    fn = (JPP.pipeline_encode_deberta if cases[name]["deberta"]
          else JPP.pipeline_encode)
    mesh = jax_mesh(jax.devices()[:WORLD], model_parallel=2)
    m = cases[name]["m"]
    want = np.asarray(jax.jit(lambda p, i, a: fn(
        p, jcfg, i, a, mesh=mesh, num_microbatches=m))(tree, ids, mask))
    np.testing.assert_allclose(outs[0][name, 2].numpy(), want, **JAX_TOL)


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world[2])


def _stub_mesh(stages: int, stage: int, device="meta"):
    return SimpleNamespace(shape={"data": 1, "model": stages},
                           axis_index=lambda axis: stage,
                           device=torch.device(device))


@pytest.mark.parametrize("stage", [0, 1])
def test_each_stage_holds_only_its_layers(stage):
    """shard_stages copies the tree with the embeddings, the shared tables
    and the stage's own layers on the mesh's device (here `meta`, to tell
    them apart) and the other stages' layers on the host; the caller's
    tree stays whole on the host."""
    _, cfg = _configs("deberta", False)
    params = TD.init_deberta(torch.Generator().manual_seed(0), cfg)
    before = {k: v.clone() for k, v in params.state_dict().items()}
    staged = PP.shard_stages(params, _stub_mesh(4, stage))
    assert staged["rel_embeddings"].device.type == "meta"
    assert staged["embeddings"]["word"].device.type == "meta"
    on = [j for j, lp in enumerate(staged["layers"])
          if lp["q"].weight.device.type == "meta"]
    assert on == [stage]
    after = params.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert list(PP.stage_layers(_stub_mesh(2, stage), LAYERS)) == [
        2 * stage, 2 * stage + 1]


def test_pipeline_encode_validates_divisibility():
    _, cfg = _configs("bert", False)
    cfg = dataclasses.replace(cfg, num_layers=3)
    params = TTE.init_text_encoder(torch.Generator().manual_seed(0), cfg)
    ids = torch.ones(8, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="num_layers"):
        PP.pipeline_encode(params, cfg, ids, mesh=_stub_mesh(2, 0, "cpu"))
    with pytest.raises(ValueError, match="microbatches"):
        PP._split_microbatches(6, 4, 2, 4)
