"""Sequence-parallel encoder serving (mmd_tpu_torch/parallel/sp.py) over a
world of 4 gloo ranks on the CPU, against tests/test_sp.py's claims.

One world for the module (the `world` fixture) runs every case on the
meshes (1, 4), (2, 2) and (4, 1) -- sp 4, sp 2 with the batch sharded over
"data", and sp 1 with the batch over 4 data ranks -- and each rank hands
back its (B, T, D) output. Cases: the BERT-class stack with and without a
key mask, on the explicit path and on the kernel path (here the kernel's
plain version, at Tq = T/sp against Tk = T), with a fully padded row; the
MPNet relative-bias path; ring attention on each; DeBERTa's disentangled
attention, all-gather and ring, with and without a mask, and a fully
padded row (the uniform mean of V).

Two comparisons, on numpy-seeded weights (the port's init in the JAX
layout, each leaf moved by seeded noise) that
bridge.{text_encoder,deberta}_from_jax carries across, and numpy-seeded
inputs:
  * every rank's output against the port's own unsplit forward, at the JAX
    tests' limits: rtol 2e-5, atol 2e-6 (atol 2e-5 for the ring);
  * the JAX package's sequence_parallel_encode(_deberta), jitted on the
    virtual CPU mesh (2, 2), within rtol 1e-4, atol 1e-5 (fp32 matmuls and
    softmax summed in another order on each side; the JAX side takes its
    explicit path, the function the kernel path computes).
JAX is imported only inside the fixtures and tests: a rank imports this
file to unpickle its body and must not load JAX.
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
from mmd_tpu_torch.parallel import sp as SP
from mmd_tpu_torch.parallel.launch import spawn

WORLD = 4
MESHES = (4, 2, 1)                 # model_parallel: (1, 4), (2, 2), (4, 1)
TOL = dict(rtol=2e-5, atol=2e-6)
RING_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)

# name -> (family, masked, ring, fused, fully padded row)
CASES = {
    "bert": ("bert", True, False, False, False),
    "bert_no_mask": ("bert", False, False, False, False),
    "bert_kernel_path": ("bert", True, False, True, True),
    "bert_empty_row": ("bert", True, False, False, True),
    "mpnet": ("mpnet", True, False, False, False),
    "ring": ("bert", True, True, False, False),
    "ring_no_mask": ("bert", False, True, False, False),
    "ring_mpnet": ("mpnet", True, True, False, False),
    "deberta": ("deberta", True, False, False, False),
    "deberta_no_mask": ("deberta", False, False, False, False),
    "deberta_empty_row": ("deberta", True, False, False, True),
    "ring_deberta": ("deberta", True, True, False, False),
    "ring_deberta_no_mask": ("deberta", False, True, False, False),
}
JAX_CASES = ("bert", "bert_kernel_path", "mpnet", "ring", "ring_mpnet",
             "deberta", "deberta_empty_row", "ring_deberta")


def _configs(family: str, fused: bool):
    """(JAX config, port config) of one family, the same fields."""
    from mmd_tpu.models import deberta as JD
    from mmd_tpu.models import text_encoder as JTE
    if family == "deberta":
        kw = dict(compute_dtype="float32")
        return (dataclasses.replace(JD.DEBERTA_TEST, **kw),
                dataclasses.replace(TD.DEBERTA_TEST, **kw))
    kw = dict(vocab_size=120, dropout=0.0, compute_dtype="float32")
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


def _inputs(seed: int, masked: bool, empty_row: bool, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 100, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[:, 13:] = 0
    mask[1, 6:] = 0
    if empty_row:
        mask[2] = 0
    return ids, (mask if masked else None)


def _encode(c, ids, mask, mesh=None):
    """The case's parallel encode over `mesh`, or its unsplit forward."""
    if mesh is None:
        fn = TD.deberta_encode if c["deberta"] else TTE.encode
        return fn(c["params"], c["cfg"], ids, mask)
    fn = (SP.sequence_parallel_encode_deberta if c["deberta"]
          else SP.sequence_parallel_encode)
    return fn(c["params"], c["cfg"], ids, mask, mesh=mesh, ring=c["ring"])


def _rank(rank, world, dev, cases):
    torch.set_num_threads(1)
    meshes = {mp: make_mesh(mp, device=dev) for mp in MESHES}
    out = {"jax_loaded": "jax" in sys.modules}
    with torch.no_grad():
        for name, c in cases.items():
            for mp, mesh in meshes.items():
                out[name, mp] = _encode(c, c["ids"], c["mask"], mesh)
    return out


@pytest.fixture(scope="module")
def world():
    cases, jax_side = {}, {}
    for seed, (name, (family, masked, ring, fused, empty)) in enumerate(
            CASES.items()):
        jcfg, tcfg = _configs(family, fused)
        tree, params = _weights(family, tcfg, seed)
        ids, mask = _inputs(seed, masked, empty)
        cases[name] = dict(
            cfg=tcfg, params=params.eval(), deberta=family == "deberta",
            ring=ring, ids=torch.from_numpy(ids).long(),
            mask=None if mask is None else torch.from_numpy(mask))
        jax_side[name] = (jcfg, tree, ids, mask)
    outs = spawn(_rank, WORLD, "gloo", "cpu", args=(cases,), timeout_s=300)
    with torch.no_grad():
        want = {name: _encode(c, c["ids"], c["mask"])
                for name, c in cases.items()}
    return cases, jax_side, outs, want


@pytest.mark.parametrize("mp", MESHES)
@pytest.mark.parametrize("name", CASES)
def test_sp_encode_matches_unsplit(world, name, mp):
    cases, _, outs, want = world
    tol = RING_TOL if cases[name]["ring"] else TOL
    for rank, out in enumerate(outs):
        got = out[name, mp]
        assert got.shape == want[name].shape
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), **tol,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_sp_encode_matches_jax(world, name):
    import jax

    from mmd_tpu.core.mesh import make_mesh as jax_mesh
    from mmd_tpu.parallel import sp as JSP
    cases, jax_side, outs, _ = world
    jcfg, tree, ids, mask = jax_side[name]
    fn = (JSP.sequence_parallel_encode_deberta if cases[name]["deberta"]
          else JSP.sequence_parallel_encode)
    mesh = jax_mesh(jax.devices()[:WORLD], model_parallel=2)
    ring = cases[name]["ring"]
    want = np.asarray(jax.jit(lambda p, i, a: fn(p, jcfg, i, a, mesh=mesh,
                                                 ring=ring))(tree, ids, mask))
    np.testing.assert_allclose(outs[0][name, 2].numpy(), want, **JAX_TOL)


def test_ranks_never_load_jax(world):
    assert not any(out["jax_loaded"] for out in world[2])


def test_sp_validates_divisibility():
    from types import SimpleNamespace
    _, cfg = _configs("bert", False)
    params = TTE.init_text_encoder(torch.Generator().manual_seed(0), cfg)
    mesh = SimpleNamespace(shape={"data": 1, "model": 4})
    ids = torch.ones(2, 18, dtype=torch.long)
    with pytest.raises(ValueError, match="seq len"):
        SP.sequence_parallel_encode(params, cfg, ids, mesh=mesh)
    with pytest.raises(NotImplementedError, match="post-LN"):
        SP.sequence_parallel_encode(
            params, dataclasses.replace(cfg, pre_ln=True), ids, mesh=mesh)
