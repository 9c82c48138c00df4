"""pipelines/train_captioner.py in the port against the JAX package's, on
the CPU: the CLI from the same initial params and data, and the AdamW step
against optax.adamw. Tolerances (fp32):
  * the loss within 1e-4, the resolution the CLIs print it at; the
    params' update within 1e-2 of its norm. Adam's
    first steps map each gradient entry to about +-lr whatever its size,
    so an entry whose gradient is near eps (1e-8) turns the two packages'
    fp32 gradient differences (within 1e-4 of each leaf's scale,
    tests/test_torch_captioner.py) into update differences of up to ~lr
    (measured: 1.1e-3 of the update's norm, 0.3% of the entries apart by
    more than 1e-6). Given the same gradients, the AdamW step itself
    lands within 2.4e-7 (two fp32 steps at 1) of optax.adamw's.
"""

import dataclasses
import json
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mmd_tpu.core.checkpoint import load_params as jload_params
from mmd_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
from mmd_tpu.models import captioner as JC
from mmd_tpu.pipelines import train_captioner as JTRAIN
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import captioner as TC
from mmd_tpu_torch.pipelines import train_captioner as TTRAIN

torch.set_num_threads(2)

UPDATE_RTOL = 1e-2
OPT_ATOL = 2.4e-7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(vocab: int, base=JC.CAPTIONER_TEST):
    return dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, vocab_size=vocab))


def _update_gap(got, want, start) -> float:
    """|got - want| over |want - start|, all leaves as one vector: how far
    the port's update is from the JAX package's."""
    dg = np.concatenate([(g - s).ravel() for g, s in zip(got, start)])
    dw = np.concatenate([(w - s).ravel() for w, s in zip(want, start)])
    return float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))


def _port_cfg(jcfg):
    return TC.config_from_dict(dataclasses.asdict(jcfg))


def _caption_csv(tmp_path, rng, n):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rows = []
    for i in range(n):
        p = img_dir / f"{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (32, 32, 3),
                                     dtype=np.uint8)).save(p)
        rows.append({"claim_image": str(p),
                     "claim_image_caption": f"caption number {i % 3}"})
    rows[n - 1]["claim_image"] = str(img_dir / "missing.jpg")
    csv = tmp_path / "caps.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return csv


def test_train_captioner_matches_jax(tmp_path, rng, monkeypatch, capsys):
    """Both CLIs (--tiny, 6 pairs, batch 4, 1 epoch: one AdamW step on the
    rows the epoch's permutation puts first, a missing image masked out)
    from the same initial params: the same loss and the same update, so
    the data order, the tokenizer, the masks and the step are the JAX
    package's."""
    csv = _caption_csv(tmp_path, rng, n=6)
    tok = JTokenizer.train([f"caption number {i}" for i in range(3)], 30000)
    jcfg = dataclasses.replace(_cfg(tok.vocab_size), max_caption_len=8)
    # the JAX CLI's own initial params, handed to the port's CLI
    held = {}
    jinit = JC.init_captioner
    monkeypatch.setattr(JC, "init_captioner", lambda key, cfg: held.setdefault(
        "tree", _np(jinit(key, cfg))))
    monkeypatch.setattr(
        TTRAIN, "init_captioner",
        lambda gen, cfg: bridge.captioner_from_jax(held["tree"], cfg))
    losses = {}
    for name, mod, extra in (("jax", JTRAIN, []),
                             ("port", TTRAIN, ["--device", "cpu"])):
        assets = tmp_path / name
        assets.mkdir()
        tok.save(assets / "tokenizer.json")
        monkeypatch.setattr(sys, "argv", [
            "train_captioner", "--csv", str(csv), "--assets", str(assets),
            "--tiny", "--epochs", "1", "--batch_size", "4", "--max_len", "8",
            *extra])
        capsys.readouterr()
        got = mod.main()
        said = capsys.readouterr().out
        losses[name] = float(said.split("epoch 0: loss ")[1].split()[0])
        if name == "port":
            assert len(got) == 1 and got[-1] == pytest.approx(
                losses["port"], abs=1e-4)
    assert abs(losses["port"] - losses["jax"]) <= 1e-4
    assert json.loads((tmp_path / "port" / "captioner_config.json"
                       ).read_text()) == dataclasses.asdict(jcfg)
    tree = held["tree"]
    want = jax.tree_util.tree_leaves(_np(jload_params(
        str(tmp_path / "jax" / "captioner.ckpt"), tree)))
    params = TC.init_captioner(torch.Generator().manual_seed(0),
                               _port_cfg(jcfg))
    params.load_state_dict(torch.load(tmp_path / "port" / "captioner.pt",
                                      weights_only=True))
    got = jax.tree_util.tree_leaves(bridge.to_jax_tree(params))
    start = jax.tree_util.tree_leaves(_np(tree))
    assert _update_gap(got, want, start) <= UPDATE_RTOL


def test_adamw_step_matches_optax(rng):
    """Given the same gradients, make_optimizer's step lands within two
    fp32 steps at 1 (the LayerNorm scales) of optax.adamw(lr)'s, twice:
    weight decay 1e-4 on every leaf (torch's default of 1e-2 would move a
    scale of 1 by 3e-6 more a step)."""
    import optax
    tcfg = _port_cfg(_cfg(64))
    params = TC.init_captioner(torch.Generator().manual_seed(4), tcfg)
    tree = bridge.to_jax_tree(params)
    opt = optax.adamw(3e-4)
    state = opt.init(tree)
    topt = TTRAIN.make_optimizer(params, 3e-4)
    want = tree
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            * 10.0 ** rng.integers(-9, 0), want)
        updates, state = opt.update(grads, state, want)
        want = _np(optax.apply_updates(want, updates))
        for p, g in zip(params.parameters(),
                        bridge.captioner_from_jax(grads, tcfg).parameters()):
            p.grad = g.detach().clone()
        topt.step()
    got = jax.tree_util.tree_leaves(bridge.to_jax_tree(params))
    want = jax.tree_util.tree_leaves(want)
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= OPT_ATOL


def test_train_captioner_runs_on_the_card_unless_asked(tmp_path, rng):
    """Without a card the default device raises instead of training on
    the CPU; --device cpu trains and writes the assets."""
    csv = _caption_csv(tmp_path, rng, n=4)
    argv = ["--csv", str(csv), "--tiny", "--epochs", "1", "--batch_size",
            "2", "--max_len", "8", "--assets", str(tmp_path / "assets")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTRAIN.main(argv)
    losses = TTRAIN.main(argv + ["--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    for name in ("captioner.pt", "captioner_config.json", "tokenizer.json"):
        assert (tmp_path / "assets" / name).exists()
