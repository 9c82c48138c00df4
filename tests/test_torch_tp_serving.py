"""Tensor-parallel encoder serving (mmd_tpu_torch/parallel/tp.py) over a
world of 4 gloo ranks on the CPU, against tests/test_tp.py:195-250.

One world for the module (the `world` fixture) runs every case on the
meshes (1, 4), (2, 2) and (4, 1) -- the Megatron split over 4 ranks (one
head of 8 each), over 2 (replicated over "data"), and no split -- each
rank holding only its slices (shard_encoder) and handing back its
(B, T, D) output and its slices' shapes. Cases: the BERT-class stack with
and without a key mask and on the kernel path (the kernel's plain
version on the CPU, at the rank's heads), the MPNet relative-bias path
(the bias's heads split with the rest), DeBERTa with and without a mask.

Two comparisons, on numpy-seeded weights (the port's init in the JAX
layout, each leaf moved by seeded noise) that
bridge.{text_encoder,deberta}_from_jax carries across, and numpy-seeded
inputs:
  * every rank's output against the port's own unsplit forward, at the JAX
    tests' limits: rtol 2e-5, atol 2e-6;
  * the JAX package's serving TP -- the encode of params put by its
    tp.shard_encoder on the virtual CPU mesh (2, 2), jitted, GSPMD
    partitioning the jnp path -- within rtol 1e-4, atol 1e-5 (fp32
    matmuls summed in another order on each side).
The split rules themselves (`encoder_specs`) are held leaf by leaf against
the JAX package's. JAX is imported only inside the fixtures and tests: a
rank imports this file to unpickle its body and must not load JAX.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.mesh import make_mesh
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.models import text_encoder as TTE
from mmd_tpu_torch.parallel import tp as TP
from mmd_tpu_torch.parallel.launch import spawn

WORLD = 4
MESHES = (4, 2, 1)                 # model_parallel: (1, 4), (2, 2), (4, 1)
TOL = dict(rtol=2e-5, atol=2e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)

# name -> (family, masked, fused)
CASES = {
    "bert": ("bert", True, False),
    "bert_no_mask": ("bert", False, False),
    "bert_kernel_path": ("bert", True, True),
    "mpnet": ("mpnet", True, False),
    "deberta": ("deberta", True, False),
    "deberta_no_mask": ("deberta", False, False),
}
JAX_CASES = ("bert", "mpnet", "deberta")


def _configs(family: str, fused: bool):
    """(JAX config, port config) of one family, the same fields: 8 heads
    of 4, FFN 64, so that 4 ranks split both."""
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    if family == "deberta":
        kw = dict(num_heads=8, compute_dtype="float32", fused_attn=False)
        return (dataclasses.replace(JD.DEBERTA_TEST, **kw),
                dataclasses.replace(TD.DEBERTA_TEST, **kw))
    kw = dict(vocab_size=120, num_heads=8, dropout=0.0,
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
    mask[:, 12:] = 0
    mask[3, 5:] = 0
    return ids, (mask if masked else None)


def _rank(rank, world, dev, cases):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in MESHES}
    out = {"jax_loaded": "jax" in sys.modules}
    with torch.no_grad():
        for name, c in cases.items():
            for mp, mesh in meshes.items():
                params = TP.shard_encoder(c["params"], mesh)
                out[name, mp] = TP.tensor_parallel_encode(
                    params, c["cfg"], c["ids"], c["mask"], mesh=mesh)
                layer = params["layers"][0]
                out[name, mp, "shapes"] = {
                    n: tuple(layer[n].weight.shape)
                    for n in ("q", "ffn_in", "attn_out", "ffn_out")}
    return out


@pytest.fixture(scope="module")
def world():
    cases, jax_side = {}, {}
    for seed, (name, (family, masked, fused)) in enumerate(CASES.items()):
        jcfg, tcfg = _configs(family, fused)
        tree, params = _weights(family, tcfg, seed)
        ids, mask = _inputs(seed, masked)
        cases[name] = dict(
            cfg=tcfg, params=params.eval(), deberta=family == "deberta",
            ids=torch.from_numpy(ids).long(),
            mask=None if mask is None else torch.from_numpy(mask))
        jax_side[name] = (jcfg, tree, ids, mask)
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(cases,), timeout_s=300)
    with torch.no_grad():
        want = {name: (TD.deberta_encode if c["deberta"] else TTE.encode)(
            c["params"], c["cfg"], c["ids"], c["mask"])
            for name, c in cases.items()}
    return cases, jax_side, outs, want


@pytest.mark.parametrize("mp", MESHES)
@pytest.mark.parametrize("name", CASES)
def test_encoder_tp_matches_unsplit(world, name, mp):
    _, _, outs, want = world
    for rank, out in enumerate(outs):
        got = out[name, mp]
        assert got.shape == want[name].shape
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), **TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("mp", MESHES)
def test_each_rank_holds_only_its_slices(world, mp):
    cases, _, outs, _ = world
    cfg = cases["bert"]["cfg"]
    d, f = cfg.hidden_size, cfg.intermediate_size
    want = {"q": (d // mp, d), "ffn_in": (f // mp, d),
            "attn_out": (d, d // mp), "ffn_out": (d, f // mp)}
    for out in outs:
        assert out["bert", mp, "shapes"] == want


@pytest.mark.parametrize("name", JAX_CASES)
def test_encoder_tp_matches_jax(world, name):
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    from mmd_tpu.parallel import tp as JTP
    cases, jax_side, outs, _ = world
    jcfg, tree, ids, mask = jax_side[name]
    fn = JD.deberta_encode if cases[name]["deberta"] else JTE.encode
    mesh = jax_mesh(jax.devices()[:WORLD], model_parallel=2)
    want = np.asarray(jax.jit(lambda p, i, a: fn(p, jcfg, i, a))(
        JTP.shard_encoder(tree, mesh), ids, mask))
    np.testing.assert_allclose(outs[0][name, 2].numpy(), want, **JAX_TOL)


@pytest.mark.parametrize("family", ["bert", "mpnet", "deberta"])
def test_encoder_specs_match_jax(family):
    """Each leaf splits as the JAX package's encoder_specs splits it: a
    column split (P(None, model) on a (in, out) weight, P(model) on its
    bias) is dim 0 of the port's (out, in) weight and of the bias; a row
    split (P(model, None)) is dim 1; P() is replicated."""
    from jax.sharding import PartitionSpec as P

    from mmd_tpu.parallel import tp as JTP
    _, tcfg = _configs(family, False)
    tree, params = _weights(family, tcfg, 0)
    specs = JTP.encoder_specs(tree)
    split = {P(None, "model"): 0, P("model"): 0, P("model", None): 1,
             P(): None}
    leaf_names = {"weight": ("w", "scale"), "bias": ("b", "bias")}
    got = TP.encoder_specs(params)
    assert got and any(v is not None for v in got.values())
    for key, dim in got.items():
        node = specs
        *path, leaf = key.split(".")
        for part in path:
            node = node[int(part)] if part.isdigit() else node[part]
        if isinstance(node, P):           # a bare parameter
            want = node
        else:
            want = next(node[n] for n in leaf_names.get(leaf, (leaf,))
                        if n in node)
        assert dim == split[want], key


def test_tp_validates_heads():
    from types import SimpleNamespace
    _, cfg = _configs("bert", False)
    cfg = dataclasses.replace(cfg, num_heads=6, hidden_size=36)
    params = TTE.init_text_encoder(torch.Generator().manual_seed(0), cfg)
    mesh = SimpleNamespace(shape={"data": 1, "model": 4},
                           axis_index=lambda axis: 0)
    with pytest.raises(ValueError, match="num_heads"):
        TP.tensor_parallel_encode(params, cfg, torch.ones(1, 4).long(),
                                  mesh=mesh)
    with pytest.raises(ValueError, match="divisible by model axis"):
        TP.shard_encoder(params, SimpleNamespace(
            shape={"data": 1, "model": 5}, axis_index=lambda axis: 0,
            device=torch.device("cpu")))


@pytest.mark.parametrize("family", ["bert", "deberta"])
def test_shard_encoder_leaves_the_callers_tree(family):
    """shard_encoder hands back a copy holding the rank's slices; the
    tree it was given keeps every tensor whole and unchanged, so it can
    be split again or served unsplit."""
    from types import SimpleNamespace
    _, cfg = _configs(family, False)
    init = (TD.init_deberta if family == "deberta"
            else TTE.init_text_encoder)
    params = init(torch.Generator().manual_seed(0), cfg)
    before = {k: v.clone() for k, v in params.state_dict().items()}
    mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                           axis_index=lambda axis: 1,
                           device=torch.device("cpu"))
    split = TP.shard_encoder(params, mesh)
    q = params["layers"][0]["q"]
    assert split["layers"][0]["q"].weight.shape[0] * 2 == q.weight.shape[0]
    assert split["layers"][0]["q"].out_features * 2 == q.out_features
    after = params.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world[2])
