"""The fusion model's train step and forward at the CLI's wider widths
(`--embed_dim 384|512 --num_heads 4`: flash attention at head dims 96 and
128, the MLPs at D 384 / F 1536 and D 512 / F 2048) against the JAX
package, on the CPU, with weights carried by `bridge.fusion_from_jax`.

fp32, dropout 0 (the TPU PRNG behind the JAX package's masks has no
interpret mode), the fused attention path: Pallas in interpret mode on the
JAX side, the flash kernels' plain versions here. Tolerances, the bounds of
tests/test_torch_training.py and tests/test_torch_models.py: the loss of one
step within 1e-5 relative and every grad within 1e-4 of its leaf's largest
|value| plus 1e-7 (a few fp32 layers, reassociated); the forward's logits
within 1e-4. The kernels' own cases at these widths are in
tests/test_torch_wide_fusion.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.core.config import TrainConfig as JTrainConfig
from mmd_tpu.data.synthetic import synthetic_preembed_batch as j_batch
from mmd_tpu.models import fusion as jfusion
from mmd_tpu.training import trainer as JT
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.models import fusion as tfusion
from mmd_tpu_torch.ops import attention as A
from mmd_tpu_torch.training import trainer as TT

torch.set_num_threads(2)

WIDTHS = [384, 512]
SEQ = dict(text_seq=8, image_seq=4, text_dim=16, image_dim=24)


def _dims(embed: int) -> dict:
    return dict(text_input_dim=16, image_input_dim=24, embed_dim=embed,
                num_heads=4, hidden_dim=16, compute_dtype="float32")


def _recorder():
    """An optax transformation whose state is the incoming gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.array(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("embed", WIDTHS)
def test_train_step_matches_jax_at_wide_embed(embed):
    """One fp32 step, dropout 0, batch 2, the fused attention path (head
    dims 96 and 128; Pallas in interpret mode on the JAX side, the plain
    flash versions here): loss and every grad, the JAX grads read from its
    optimizer state as tests/test_torch_training.py reads them."""
    dims = _dims(embed)
    jcfg = JTrainConfig(model=JModelConfig(**dims, dropout=0.0,
                                           fused_attn=True),
                        batch_size=2, lr=1e-3)
    tcfg = TrainConfig(model=ModelConfig(**dims, dropout=0.0,
                                         fused_attn=True),
                       batch_size=2, lr=1e-3)
    assert A.fused_ok(embed, 4)
    opt = optax.chain(_recorder(), JT.make_optimizer(jcfg))
    j0 = JT.init_state(jcfg, jax.random.key(0))
    jstate = JT.TrainState(j0.step, j0.params, opt.init(j0.params), j0.rng)
    state = TT.init_state(tcfg, "cpu")
    state.params = bridge.fusion_from_jax(
        jax.tree_util.tree_map(np.asarray, j0.params), tcfg.model)
    state.optimizer = TT.make_optimizer(tcfg, state.params)

    batch = j_batch(np.random.default_rng(embed), 2, **SEQ)
    jstate, jaux = jax.jit(JT.make_raw_step(jcfg, opt))(jstate, batch)
    state, taux = TT.make_raw_step(tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    jl, tl = float(jaux["loss"]), float(taux["loss"])
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    got = _flat(bridge.to_jax_tree(state.params, grads=True))
    want = _flat(jstate.opt_state[0])
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max())
        assert gap <= 1e-4 * float(np.abs(w).max()) + 1e-7, (k, gap)


@pytest.mark.parametrize("embed", WIDTHS)
def test_fusion_forward_matches_jax_at_wide_embed(embed):
    """The deterministic forward (the fused attention path) at 4 heads:
    every path's logits within 1e-4."""
    kw = dict(_dims(embed), fused_attn=True)
    rng = np.random.default_rng(embed + 1)
    inputs = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 12, 16), (2, 6, 24), (2, 12, 16), (2, 6, 24))]
    jcfg = JModelConfig(**kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jfusion.init_fusion_params(jax.random.key(3), jcfg))
    want = jfusion.fusion_forward(tree, jcfg, *map(jnp.asarray, inputs))
    pcfg = ModelConfig(**kw)
    with torch.no_grad():
        got = tfusion.fusion_forward(bridge.fusion_from_jax(tree, pcfg),
                                     pcfg, *map(torch.from_numpy, inputs))
    got_l = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), got,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
