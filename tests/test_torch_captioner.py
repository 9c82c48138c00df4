"""The captioner in the port (mmd_tpu_torch/models/captioner.py and the
decoder of models/transformer.py) against the JAX package, on the CPU.

The same seeded params go to both: a numpy tree in the JAX package's
layout (drawn by the port's init, which costs no JAX compile) that the
JAX functions take as it is and bridge.captioner_from_jax carries into
the port; and the same numpy inputs. Tolerances (fp32):
  * hidden states, caches and logits within 1e-5 of the largest |value|;
  * gradients within 1e-4 of each leaf's largest |value| (no leaf held to
    less than 1e-3 of the model's largest gradient);
  * token ids are compared teacher-forced: the port's logits along the
    JAX package's tokens are held to 1e-5, and the port's own greedy
    tokens must equal JAX's up to the first step whose JAX top-2 gap is
    within that tolerance (a near tie, after which the sequences may
    part). Within the port, the cached decode equals the naive full
    re-forward exactly, and hoisting the cross-attention's K and V out of
    the step loop changes no bit.
CAPTIONER_TEST has head dim 8, which both packages send to the explicit
path; the dh-64 case sends the ViT's and the cross-attention's heads to
JAX's Pallas kernel in interpret mode and to the port's
flash_attention_plain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import captioner as JC
from mmd_tpu.models import transformer as JT
from mmd_tpu.models import vit as JV
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import captioner as TC
from mmd_tpu_torch.models import transformer as TT
from mmd_tpu_torch.models import vit as TV
from mmd_tpu_torch.ops import attention as A

torch.set_num_threads(2)

TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3
BOS, EOS, PAD = 2, 3, 0


def _port_cfg(jcfg) -> TC.CaptionerConfig:
    return TC.config_from_dict(dataclasses.asdict(jcfg))


def _setup(jcfg, seed=0):
    tcfg = _port_cfg(jcfg)
    tree = bridge.to_jax_tree(TC.init_captioner(
        torch.Generator().manual_seed(seed), tcfg))
    return tree, bridge.captioner_from_jax(tree, tcfg)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _images(rng, cfg, b):
    s = cfg.vit.image_size
    return rng.standard_normal((b, s, s, 3)).astype(np.float32)


MIXED = JC.CaptionerConfig(
    vit=dataclasses.replace(JV.VIT_TEST, hidden_size=48, num_heads=4),
    decoder=JT.TransformerConfig(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=16, type_vocab_size=0,
        is_decoder=True, encoder_hidden_size=48, compute_dtype="float32"),
    max_caption_len=8)

# head dim 64 everywhere: JAX's fused path runs the Pallas kernel
DH64 = JC.CaptionerConfig(
    vit=dataclasses.replace(JV.VIT_TEST, hidden_size=64, num_heads=1,
                            num_layers=1, intermediate_size=64),
    decoder=JT.TransformerConfig(
        vocab_size=48, hidden_size=64, num_layers=1, num_heads=1,
        intermediate_size=64, max_position=8, type_vocab_size=0,
        is_decoder=True, encoder_hidden_size=64, compute_dtype="float32"),
    max_caption_len=4)


@pytest.fixture(scope="module")
def cap():
    return (JC.CAPTIONER_TEST,) + _setup(JC.CAPTIONER_TEST)


@pytest.fixture(scope="module")
def mixed():
    return (MIXED,) + _setup(MIXED, seed=1)


# -- the decoder layer ------------------------------------------------------------

def test_decoder_layer_with_cache_matches_jax(rng):
    """encoder_layer with a cache at idx 2 (a 3-token step), cross-attending
    to states of another width (48 -> 32) under a key mask: the same x and
    the same cache rows."""
    jcfg = MIXED.decoder
    tcfg = TT.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = bridge.to_jax_tree(TT.init_layer(torch.Generator().manual_seed(3),
                                          tcfg))
    tp = TT.init_layer(torch.Generator().manual_seed(0), tcfg)
    bridge.load_jax_tree(tp, jp)
    b, t, t_max, s = 2, 3, 8, 5
    x = rng.standard_normal((b, t, 32)).astype(np.float32)
    enc = rng.standard_normal((b, s, 48)).astype(np.float32)
    ck = rng.standard_normal((b, t_max, 32)).astype(np.float32)
    cv = rng.standard_normal((b, t_max, 32)).astype(np.float32)
    cross = np.ones((b, s), np.int32)
    cross[1, 3:] = 0
    valid = np.arange(t_max)[None, :] <= (2 + np.arange(t))[:, None]
    mask = np.where(valid, 0.0, -1e9).astype(np.float32)[None, None]
    jx, jc = jax.jit(lambda p, x, m, e, c, km: JT.encoder_layer(
        p, jcfg, x, m, e, None, c, cross_key_mask=km))(
            jp, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(enc),
            {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "idx": 2},
            jnp.asarray(cross))
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
          "idx": 2}
    with torch.no_grad():
        tx, tnc = TT.encoder_layer(
            tp, tcfg, torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(enc), None, tc,
            cross_key_mask=torch.from_numpy(cross))
    _close(tx, jx)
    _close(tnc["k"], jc["k"])
    _close(tnc["v"], jc["v"])
    assert tnc["idx"] == int(jc["idx"]) == 5
    assert tnc["k"] is tc["k"]                      # written in place


def test_causal_cross_attending_forward_matches_jax(rng):
    cfg = MIXED.decoder
    tcfg = TT.TransformerConfig(**dataclasses.asdict(cfg))
    jp = bridge.to_jax_tree(TT.init_transformer(
        torch.Generator().manual_seed(4), tcfg))
    tp = TT.init_transformer(torch.Generator().manual_seed(0), tcfg)
    bridge.load_jax_tree(tp, jp)
    ids = rng.integers(0, 64, (2, 7)).astype(np.int32)
    am = np.ones((2, 7), np.int32)
    am[1, 5:] = 0
    enc = rng.standard_normal((2, 5, 48)).astype(np.float32)
    em = np.ones((2, 5), np.int32)
    em[0, 4:] = 0
    want = jax.jit(lambda p, i, a, e, m: JT.transformer_forward(
        p, cfg, i, a, encoder_states=e, encoder_mask=m, causal=True))(
            jp, jnp.asarray(ids), jnp.asarray(am), jnp.asarray(enc),
            jnp.asarray(em))
    with torch.no_grad():
        got = TT.transformer_forward(
            tp, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(am),
            encoder_states=torch.from_numpy(enc),
            encoder_mask=torch.from_numpy(em), causal=True)
    _close(got, want)


def test_embed_position_offset_matches_jax(rng):
    cfg = MIXED.decoder
    tcfg = TT.TransformerConfig(**dataclasses.asdict(cfg))
    jp = bridge.to_jax_tree(TT.init_embeddings(
        torch.Generator().manual_seed(5), tcfg))
    tp = TT.init_embeddings(torch.Generator().manual_seed(0), tcfg)
    bridge.load_jax_tree(tp, jp)
    ids = rng.integers(0, 64, (2, 3)).astype(np.int32)
    for offset in (0, 5):
        want = JT.embed(jp, cfg, jnp.asarray(ids), position_offset=offset)
        with torch.no_grad():
            got = TT.embed(tp, tcfg, torch.from_numpy(ids).long(),
                           position_offset=offset)
        _close(got, want)


# -- generate ---------------------------------------------------------------------

def _jax_greedy(tree, jcfg, images, t_max):
    """JAX's greedy tokens, and its logits of every decode step along
    them: one causal forward over [BOS, tokens[:, :-1]] (the oracle of
    tests/test_captioner.py, teacher-forced); one jit for both."""
    dcfg = jcfg.decoder

    @jax.jit
    def run(tree, images):
        tokens = JC.generate(tree, jcfg, images, BOS, EOS, PAD, t_max)
        seq = jnp.concatenate([jnp.full((len(tokens), 1), BOS, jnp.int32),
                               tokens[:, :-1].astype(jnp.int32)], axis=1)
        enc = JV.vit_forward(tree["vit"], jcfg.vit, images)
        x = JT.embed(tree["decoder"]["embeddings"], dcfg, seq)
        x, _ = JC._decoder_stack(tree, dcfg, x, JT.causal_mask(t_max), enc,
                                 None)
        return tokens, JC._lm_logits(tree, dcfg, x)

    tokens, logits = run(tree, jnp.asarray(images))
    return np.array(tokens), np.asarray(logits)


def _check_greedy(got_tokens, want_tokens, want_logits, tol):
    """Equal ids up to the first step where JAX's top-2 gap is within
    `tol`; past a near tie the sequences may part."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    for row in range(len(want_tokens)):
        for s in range(want_tokens.shape[1]):
            if gap[row, s] <= tol:
                break
            assert got_tokens[row, s] == want_tokens[row, s], (row, s)


@pytest.mark.parametrize("name", ["cap", "mixed"])
def test_generate_matches_jax_teacher_forced(rng, request, name):
    jcfg, tree, params = request.getfixturevalue(name)
    tcfg = _port_cfg(jcfg)
    images = _images(rng, jcfg, 3)
    jt, want = _jax_greedy(tree, jcfg, images, 8)
    x = torch.from_numpy(images)
    enc = TV.vit_forward(params["vit"], tcfg.vit, x)
    forced_tokens, logits = TC.decode(params, tcfg, enc, BOS, EOS, PAD, 8,
                                      forced=torch.from_numpy(jt).long())
    _close(logits, want)
    tol = TOL * np.abs(want).max()
    _check_greedy(TC.generate(params, tcfg, x, BOS, EOS, PAD, 8).numpy(),
                  jt, want, tol)
    assert forced_tokens.shape == (3, 8)


def _naive_greedy(params, cfg, images, t_max):
    """The port's oracle: a full re-forward at every step, no cache."""
    dcfg = cfg.decoder
    with torch.no_grad():
        enc = TV.vit_forward(params["vit"], cfg.vit, images)
        b = images.shape[0]
        seq = torch.full((b, 1), BOS, dtype=torch.long)
        done = torch.zeros(b, dtype=torch.bool)
        outs = []
        for _ in range(t_max):
            x = TT.embed(params["decoder"]["embeddings"], dcfg, seq)
            x, _ = TC._decoder_stack(params, dcfg, x,
                                     TT.causal_mask(seq.shape[1]), enc)
            nxt = TC._lm_logits(params, dcfg, x)[:, -1].argmax(-1)
            nxt = torch.where(done, PAD, nxt)
            done = done | (nxt == EOS)
            outs.append(nxt)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    return torch.stack(outs, dim=1)


def test_kv_cached_decode_matches_naive(cap, rng):
    jcfg, _, params = cap
    tcfg = _port_cfg(jcfg)
    x = torch.from_numpy(_images(rng, jcfg, 2))
    fast = TC.generate(params, tcfg, x, BOS, EOS, PAD, 8)
    assert torch.equal(fast, _naive_greedy(params, tcfg, x, 8))


def test_hoisted_cross_kv_is_bit_identical(cap, rng, monkeypatch):
    """The caches' cross-attention K and V, computed once a batch, give
    the logits of recomputing them at every step, to the bit."""
    jcfg, _, params = cap
    tcfg = _port_cfg(jcfg)
    x = torch.from_numpy(_images(rng, jcfg, 3))
    enc = TV.vit_forward(params["vit"], tcfg.vit, x).detach()
    forced = torch.from_numpy(rng.integers(4, 128, (3, 8)))
    hoisted = TC.decode(params, tcfg, enc, BOS, EOS, PAD, 8, forced=forced)
    monkeypatch.setattr(TC, "cross_keys_values", lambda p, cfg, enc: {})
    recomputed = TC.decode(params, tcfg, enc, BOS, EOS, PAD, 8,
                           forced=forced)
    assert torch.equal(hoisted[1], recomputed[1])
    assert torch.equal(hoisted[0], recomputed[0])
    assert torch.equal(TC.generate(params, tcfg, x, BOS, EOS, PAD, 8),
                       _naive_greedy(params, tcfg, x, 8))


def test_generate_pads_after_eos_and_keeps_the_first_maximum(cap, rng):
    jcfg, _, params = cap
    tcfg = _port_cfg(jcfg)
    x = torch.from_numpy(_images(rng, jcfg, 3))
    enc = TV.vit_forward(params["vit"], tcfg.vit, x).detach()
    # the most frequent first token as EOS, so that rows end early
    first = TC.generate(params, tcfg, x, BOS, EOS, PAD, 1)[:, 0]
    eos = int(first.mode().values)
    out = TC.decode(params, tcfg, enc, BOS, eos, PAD, 8)[0].numpy()
    assert out.shape == (3, 8)
    ended = 0
    for row in out:
        hit = np.nonzero(row == eos)[0]
        if len(hit):
            ended += 1
            assert (row[hit[0] + 1:] == PAD).all()
    assert ended >= 1
    ties = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    assert int(ties.argmax()) == int(jnp.argmax(jnp.asarray(ties.numpy()))) \
        == 1


def test_decode_refuses_more_steps_than_positions(cap, rng):
    jcfg, _, params = cap
    x = torch.from_numpy(_images(rng, jcfg, 1))
    with pytest.raises(ValueError, match="positions"):
        TC.generate(params, _port_cfg(jcfg), x, BOS, EOS, PAD,
                    jcfg.decoder.max_position + 1)


# -- the LM paths of the prompting baselines ---------------------------------------

def _prompts(rng, vocab, plen=6, lens=(6, 4, 2)):
    ids = np.full((len(lens), plen), PAD, np.int32)
    mask = np.zeros((len(lens), plen), np.int32)
    for i, n in enumerate(lens):          # left-padded ragged prompts
        ids[i, plen - n:] = rng.integers(4, vocab, size=n)
        mask[i, plen - n:] = 1
    return ids, mask


def test_lm_generate_matches_jax(cap, rng):
    jcfg, tree, params = cap
    ids, mask = _prompts(rng, jcfg.decoder.vocab_size)
    want = np.array(jax.jit(lambda t, i, m: JC.lm_generate(
        t, jcfg, i, m, eos_id=EOS, pad_id=PAD, max_new_tokens=4))(
            tree, jnp.asarray(ids), jnp.asarray(mask)))
    got = TC.lm_generate(params, _port_cfg(jcfg), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), eos_id=EOS, pad_id=PAD,
                         max_new_tokens=4).numpy()
    # JAX's first-token logits of each prompt; every later step has its own
    # gap, checked through the full forward along JAX's tokens below
    dcfg = jcfg.decoder
    seq = np.concatenate([ids, want[:, :-1]], axis=1)
    m = np.concatenate([mask, np.ones_like(want[:, :-1])], axis=1)

    @jax.jit
    def full(tree, seq, m):
        x = JT.embed(tree["decoder"]["embeddings"], dcfg, seq)
        am = (JT.causal_mask(seq.shape[1])
              + JT.attention_mask_from_ids(m, seq.shape[1]))
        x, _ = JC._decoder_stack(tree, dcfg, x, am, None, None)
        return JC._lm_logits(tree, dcfg, x)

    logits = np.asarray(full(tree, jnp.asarray(seq), jnp.asarray(m))
                        )[:, ids.shape[1] - 1:]
    _check_greedy(got, want, logits, TOL * np.abs(logits).max())
    assert got.shape == (3, 4)


@pytest.mark.parametrize("with_image", [False, True])
def test_first_token_logits_match_jax(cap, rng, with_image):
    jcfg, tree, params = cap
    ids, mask = _prompts(rng, jcfg.decoder.vocab_size)
    images = _images(rng, jcfg, 3) if with_image else None
    want = jax.jit(lambda t, i, m, x: JC.first_token_logits(
        t, jcfg, i, m, x))(tree, jnp.asarray(ids), jnp.asarray(mask),
                           None if images is None else jnp.asarray(images))
    with torch.no_grad():
        got = TC.first_token_logits(
            params, _port_cfg(jcfg), torch.from_numpy(ids).long(),
            torch.from_numpy(mask),
            None if images is None else torch.from_numpy(images))
    _close(got, want)


# -- the loss and its gradients ------------------------------------------------------

def _grads_close(got_tree, want_tree):
    got = jax.tree_util.tree_leaves(got_tree)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want_tree)]
    top = max(np.abs(w).max() for w in want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(np.abs(w).max(), GRAD_FLOOR * top)
        assert np.abs(g - w).max() <= GRAD_TOL * scale


def _loss_case(jcfg, tree, params, rng, b=3, t=8):
    images = _images(rng, jcfg, b)
    ids = rng.integers(4, jcfg.decoder.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 5:] = 0
    loss, grads = jax.jit(jax.value_and_grad(
        lambda t, x, i, m: JC.caption_loss(t, jcfg, x, i, m)))(
            tree, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
    got = TC.caption_loss(params, _port_cfg(jcfg), torch.from_numpy(images),
                          torch.from_numpy(ids).long(),
                          torch.from_numpy(mask))
    got.backward()
    assert abs(got.item() - float(loss)) <= TOL * abs(float(loss))
    _grads_close(bridge.to_jax_tree(params, grads=True), grads)


@pytest.mark.parametrize("name", ["cap", "mixed"])
def test_caption_loss_and_grads_match_jax(rng, request, name):
    jcfg, tree, params = request.getfixturevalue(name)
    _loss_case(jcfg, tree, params, rng)


def test_dh64_fused_path_matches_jax(rng, monkeypatch):
    """Head dim 64: JAX runs the flash kernel (#1, and #2 in the
    backward) in interpret mode, the port flash_attention_plain and
    flash_attention_bwd_plain. Loss, gradients and teacher-forced decode
    logits agree; the port's decode took the fused path at every
    cross-attention (1 ViT block + 4 steps x 1 layer)."""
    tree, params = _setup(DH64, seed=3)
    tcfg = _port_cfg(DH64)
    assert A.fused_ok(64, 1) and tcfg.vit.fused_attn and tcfg.decoder.fused_attn
    _loss_case(DH64, tree, params, rng, b=2, t=4)
    calls = []
    plain = A.flash_attention_plain
    monkeypatch.setattr(A, "flash_attention_plain",
                        lambda *a, **k: calls.append(a[0].shape) or plain(
                            *a, **k))
    images = _images(rng, DH64, 2)
    jt, want = _jax_greedy(tree, DH64, images, 4)
    x = torch.from_numpy(images)
    enc = TV.vit_forward(params["vit"], tcfg.vit, x).detach()
    _, logits = TC.decode(params, tcfg, enc, BOS, EOS, PAD, 4,
                          forced=torch.from_numpy(jt).long())
    _close(logits, want)
    assert calls == [(2, 16, 64)] + [(2, 1, 64)] * 4
