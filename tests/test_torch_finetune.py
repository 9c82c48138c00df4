"""The port's end-to-end fine-tuning step (ROADMAP A11b) against the JAX
package's make_finetune_raw_step, in both encoder families, with
accumulation and remat.

The JAX package's seeded tiny encoders and its init_finetune_state's
fusion params go through the bridge (`finetune_from_jax`) into the port;
the same numpy raw batches go through two steps of each, each step from
the JAX package's params, dropout 0 (the JAX package's masks come from
jax.random), fp32. Families:
  * "bert_vit": TINY_TEST + VIT_TEST, the default families' tiny configs;
  * "deberta_swin": DEBERTA_TEST and a one-stage Swinv2 with 8 x 8 windows
    at head dim 32 and fused_train, so that the fused, differentiable
    window attention runs -- the Pallas kernels in interpret mode in JAX,
    #8/#9's plain versions under their autograd Function here, with the
    continuous position bias MLP training through dbias; one shifted
    block. DeBERTa's kernel path needs CUDA (JAX: a TPU), so both packages
    take its explicit path here; tests/test_torch_deberta_bwd.py holds
    #11 against JAX.
Tolerances: loss within 1e-5 relative; each grad leaf of the joint tree
within 2e-4 of its largest |value| plus 1e-7 (fp32 sums in another order
through the encoders and the fusion model; the key projections' biases,
whose true gradient is zero, hold noise of ~1e-9). remat: the same grads
as without it, within 1e-6 of each leaf's largest |value| (the same ops
recomputed).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.core.config import TrainConfig as JTrainConfig
from mmd_tpu.models import deberta as jdeb
from mmd_tpu.models import frozen as JF
from mmd_tpu.models import swin as jswin
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.training import trainer as JT
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.models import deberta as tdeb
from mmd_tpu_torch.models import frozen as TF
from mmd_tpu_torch.models import swin as tswin
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.ops import swin_attention as SA
from mmd_tpu_torch.training import trainer as TT
from tests.test_torch_raw_training import (_flat, _recorder,
                                           assert_grads_close, raw_batches)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ATOL = 2e-4, 1e-7
REMAT_REL = 1e-6
LR, B, SEQ, STEPS = 1e-3, 4, 16, 2

SWIN_KW = dict(image_size=32, patch_size=2, embed_dim=64, depths=(2,),
               num_heads=(2,), window_size=8, pretrained_window_sizes=(0,),
               compute_dtype="float32", fused_train=True)
# (JAX text cfg, port text cfg, init, JAX image cfg, port image cfg, init,
#  vocab, image size)
FAMILIES = {
    "bert_vit": (jte.TINY_TEST, te.TINY_TEST, jte.init_text_encoder,
                 jvit.VIT_TEST, tvit.VIT_TEST, jvit.init_vit, 128, 32),
    "deberta_swin": (jdeb.DEBERTA_TEST, tdeb.DEBERTA_TEST, jdeb.init_deberta,
                     jswin.SwinConfig(**SWIN_KW), tswin.SwinConfig(**SWIN_KW),
                     jswin.init_swin, 120, 32),
}


def _setup(family: str, accum: int = 1, remat: bool = False):
    (jtc, ttc, tinit, jic, tic, iinit, vocab, size) = FAMILIES[family]
    dims = dict(text_input_dim=jtc.hidden_size,
                image_input_dim=jic.hidden_size, embed_dim=64, num_heads=2,
                hidden_dim=16, compute_dtype="float32", dropout=0.0,
                fused_attn=True)
    jcfg = JTrainConfig(model=JModelConfig(**dims), batch_size=B, lr=LR,
                        accum_steps=accum, remat=remat)
    tcfg = TrainConfig(model=ModelConfig(**dims), batch_size=B, lr=LR,
                       accum_steps=accum, remat=remat)
    jenc = JF.FrozenEncoders(None, jtc, tinit(jax.random.key(1), jtc), jic,
                             iinit(jax.random.key(2), jic))
    tenc = TF.FrozenEncoders(None, ttc, None, tic, None)
    return jcfg, tcfg, jenc, tenc, raw_batches(STEPS, 11, vocab, SEQ, size)


def _port_state(tcfg, tenc, jparams):
    state = TT.TrainState(0, bridge.finetune_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg.model,
        tenc.text_cfg, tenc.vit_cfg), None, 0)
    state.optimizer = TT.make_optimizer(tcfg, state.params)
    return state


@pytest.mark.parametrize("family,accum", [("bert_vit", 1), ("bert_vit", 2),
                                          ("deberta_swin", 1),
                                          ("deberta_swin", 2)])
def test_finetune_step_matches_jax(family, accum):
    jcfg, tcfg, jenc, tenc, batches = _setup(family, accum)
    opt = optax.chain(_recorder(), JT.make_optimizer(jcfg))
    j0 = JT.init_finetune_state(jcfg, jenc, jax.random.key(0))
    jstate = JT.TrainState(j0.step, j0.params, opt.init(j0.params), j0.rng)
    jstep = jax.jit(JT.make_finetune_raw_step(jcfg, jenc, opt))
    state = _port_state(tcfg, tenc, j0.params)
    step = TT.make_finetune_raw_step(tcfg, tenc)
    was = (SA.train_launches, SA.train_bwd_launches)
    for i, batch in enumerate(batches):
        # each step starts from the JAX package's params: AdamW moves a
        # param whose true gradient is zero (a key projection's bias) by ~lr
        # whatever its fp32 noise, so two steps would compare that noise
        bridge.load_jax_tree(state.params, jax.tree_util.tree_map(
            np.asarray, jstate.params), "finetune")
        jstate, jaux = jstep(jstate, batch)
        state, taux = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        jl, tl = float(jaux["loss"]), float(taux["loss"])
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
        got = _flat(bridge.to_jax_tree(state.params, grads=True))
        want = _flat(jstate.opt_state[0])
        assert {k.split("]")[0] for k in got} == {"['fusion'", "['text'",
                                                  "['vit'"}
        assert_grads_close(got, want, i, GRAD_REL, GRAD_ATOL)
    # the CPU never launches a kernel: the fused Swin path ran the plain
    # versions under the autograd Function
    assert (SA.train_launches, SA.train_bwd_launches) == was
    assert state.step == int(jstate.step) == STEPS


def test_finetune_step_reaches_the_position_bias_through_dbias():
    """With fused_train, the CPB MLP's grads come through dbias: they match
    the explicit path's (fused_train off)."""
    _, tcfg, jenc, tenc, batches = _setup("deberta_swin")
    params = jax.tree_util.tree_map(np.asarray, JT.init_finetune_state(
        _setup("deberta_swin")[0], jenc, jax.random.key(0)).params)
    grads = {}
    for fused in (True, False):
        enc = TF.FrozenEncoders(None, tenc.text_cfg, None, tswin.SwinConfig(
            **{**SWIN_KW, "fused_train": fused}), None)
        state = _port_state(tcfg, enc, params)
        state, _ = TT.make_finetune_raw_step(tcfg, enc)(
            state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
        grads[fused] = _flat(bridge.to_jax_tree(state.params, grads=True))
    cpb = [k for k in grads[True] if "cpb" in k]
    assert cpb and all(np.abs(grads[True][k]).max() > 0 for k in cpb)
    assert_grads_close(grads[True], grads[False], 0, GRAD_REL, GRAD_ATOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gives_the_same_grads(family):
    grads, losses = {}, {}
    for remat in (False, True):
        jcfg, tcfg, jenc, tenc, batches = _setup(family, remat=remat)
        params = JT.init_finetune_state(jcfg, jenc, jax.random.key(0)).params
        state = _port_state(tcfg, tenc, params)
        state, aux = TT.make_finetune_raw_step(tcfg, tenc)(
            state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
        losses[remat] = float(aux["loss"])
        grads[remat] = _flat(bridge.to_jax_tree(state.params, grads=True))
    assert losses[True] == losses[False]
    assert_grads_close(grads[True], grads[False], 0, REMAT_REL, 0.0)


def test_init_finetune_state_copies_the_encoders():
    _, tcfg, jenc, tenc, _ = _setup("bert_vit")
    enc = TF.FrozenEncoders(
        None, tenc.text_cfg,
        bridge.text_encoder_from_jax(jax.tree_util.tree_map(
            np.asarray, jenc.text_params), tenc.text_cfg),
        tenc.vit_cfg, bridge.vit_from_jax(jax.tree_util.tree_map(
            np.asarray, jenc.vit_params), tenc.vit_cfg))
    state = TT.init_finetune_state(tcfg, enc, "cpu")
    assert sorted(state.params.keys()) == ["fusion", "text", "vit"]
    text = state.params["text"]
    assert text is not enc.text_params
    for (n, a), (_, b) in zip(text.state_dict().items(),
                              enc.text_params.state_dict().items()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), n
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == len(list(state.params.parameters()))


def test_finetune_gating_follows_the_jax_trainer():
    cfg = TrainConfig(remat=True)
    deb = tdeb.DebertaConfig(fused_train=False)
    sw = tswin.SwinConfig()
    t, v = TT.finetune_encoder_configs(cfg, deb, sw)
    assert t.remat and v.remat and not t.fused_attn
    assert not v.fused_attn and not v.fused_ln
    t, v = TT.finetune_encoder_configs(
        TrainConfig(), tdeb.DebertaConfig(),
        tswin.SwinConfig(fused_train=True))
    assert t.fused_attn and v.fused_attn and v.fused_train
    assert not v.fused_ln and not t.remat
    with pytest.raises(ValueError, match="requires encoders"):
        TT.Trainer(TrainConfig(), device="cpu", finetune=True)


def test_finetune_eval_step_is_deterministic():
    _, tcfg, jenc, tenc, batches = _setup("bert_vit")
    tcfg.model.dropout = 0.1
    enc = TF.FrozenEncoders(
        None, tenc.text_cfg,
        bridge.text_encoder_from_jax(jax.tree_util.tree_map(
            np.asarray, jenc.text_params), tenc.text_cfg),
        tenc.vit_cfg, bridge.vit_from_jax(jax.tree_util.tree_map(
            np.asarray, jenc.vit_params), tenc.vit_cfg))
    trainer = TT.Trainer(tcfg, device="cpu", encoders=enc, finetune=True)
    state = trainer.init()
    batch = trainer.shard_batch(batches[0])
    a, b = (trainer.eval_step(state.params, batch) for _ in range(2))
    assert torch.equal(a["loss"], b["loss"]) and "nll" in a
    assert all(p.grad is None for p in state.params.parameters())
