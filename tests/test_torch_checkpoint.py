"""The trained-model serving slice: checkpoints and converted assets.

The JAX package writes its assets and its fusion best_model with orbax
(mmd_tpu.core.checkpoint.save_params, here in the test): a DeBERTa-v3 and a
Swinv2 encoder with their sidecar configs, an spm.json vocabulary and the
fusion params. The JAX MisinformationPredictor(checkpoint_path=...) serves
them; tools/orbax_to_torch.py writes the port's .pt files beside them; the
port's MisinformationPredictor(checkpoint_path=..., assets_dir=...) serves
the same pairs: labels and None-paths identical, probabilities within 1e-4
(fp32, as tests/test_torch_reference_serving.py). The refusals: an orbax
file with no .pt beside it, a missing key or sidecar, a fusion checkpoint
of another ModelConfig, a joint fine-tuning state. (A best_model.pt that
the port's trainer wrote, served by python -m mmd_tpu_torch.evaluate, is
in tests/test_torch_evaluate_checkpoint.py.)
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmd_tpu.core.checkpoint import save_params as jsave_params
from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.data.spm import UnigramTokenizer as JUnigram
from mmd_tpu.inference.predictor import (
    MisinformationPredictor as JPredictor,
)
from mmd_tpu.models import deberta as jdeberta
from mmd_tpu.models import fusion as jfusion
from mmd_tpu.models import swin as jswin
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data.spm import UnigramTokenizer
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.models import deberta as tdeberta
from mmd_tpu_torch.models import frozen as tfrozen
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models import swin as tswin
from test_spm import make_pieces
from test_torch_serving import _check_evaluate_batch, _np_tree

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import orbax_to_torch  # noqa: E402

torch.set_num_threads(2)

KW = dict(text_input_dim=64, image_input_dim=64, embed_dim=64, num_heads=2,
          hidden_dim=16, compute_dtype="float32")
TEXT = jdeberta.DebertaConfig(vocab_size=128, hidden_size=64, num_layers=2,
                              num_heads=2, intermediate_size=128,
                              max_position=64, position_buckets=16)
IMAGE = jswin.SwinConfig(image_size=32, patch_size=4, embed_dim=32,
                         depths=(2, 2), num_heads=(2, 4), window_size=4,
                         pretrained_window_sizes=(0, 0),
                         compute_dtype="float32", fused_attn=False,
                         fused_ln=False)


def _write_jax_assets(assets: Path, out: Path) -> dict:
    """The JAX package's files: orbax encoders with sidecars, spm.json, an
    orbax best_model. Returns the trees."""
    assets.mkdir(parents=True)
    trees = {"deberta": jdeberta.init_deberta(jax.random.key(0), TEXT),
             "swinv2": jswin.init_swin(jax.random.key(1), IMAGE),
             "fusion": jfusion.init_fusion_params(jax.random.key(2),
                                                  JModelConfig(**KW))}
    for name, cfg in (("deberta", TEXT), ("swinv2", IMAGE)):
        jsave_params(str(assets / f"{name}.ckpt"), trees[name])
        (assets / f"{name}_config.json").write_text(
            json.dumps(dataclasses.asdict(cfg), indent=1))
    JUnigram(make_pieces()).save(assets / "spm.json")
    jsave_params(str(out / "best_model"), trees["fusion"])
    return {k: _np_tree(v) for k, v in trees.items()}


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkpoint_slice")
    assets, out = root / "assets", root / "run"
    trees = _write_jax_assets(assets, out)
    jpred = JPredictor(JModelConfig(**KW), checkpoint_path=str(
        out / "best_model"), assets_dir=str(assets), max_length=64,
        batch_size=4)
    flags = [f"--{k}={v}" for k, v in KW.items()]
    orbax_to_torch.main(["--assets", str(assets), "--fusion",
                         str(out / "best_model"), *flags])
    tpred = MisinformationPredictor(
        ModelConfig(**KW), checkpoint_path=str(out / "best_model.pt"),
        assets_dir=str(assets), max_length=64, batch_size=4, device="cpu")
    return dict(jpred=jpred, tpred=tpred, trees=trees, assets=assets,
                out=out, img_dir=root)


def test_orbax_assets_serve_like_jax(slice_run):
    """The whole slice: JAX's orbax files -> orbax_to_torch -> the port's
    predictor, against the JAX predictor on the same files."""
    assert isinstance(slice_run["tpred"].enc.tokenizer, UnigramTokenizer)
    assert isinstance(slice_run["tpred"].enc.text_cfg, tdeberta.DebertaConfig)
    assert isinstance(slice_run["tpred"].enc.vit_cfg, tswin.SwinConfig)
    _check_evaluate_batch(slice_run["jpred"], slice_run["tpred"],
                          slice_run["img_dir"])


@pytest.mark.parametrize("name", ["deberta", "swinv2", "fusion"])
def test_orbax_to_torch_carries_every_param(slice_run, name):
    """The .pt files hold the JAX trees bit for bit."""
    tpred = slice_run["tpred"]
    module = {"deberta": tpred.enc.text_params, "swinv2": tpred.enc.vit_params,
              "fusion": tpred.params}[name]
    got = bridge.to_jax_tree(module.cpu())
    want = slice_run["trees"][name]
    for (gp, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=jax.tree_util.keystr(gp))
    assert len(jax.tree_util.tree_leaves(got)) == len(
        jax.tree_util.tree_leaves(want))


def _copy_assets(slice_run, dst: Path, drop=()) -> Path:
    shutil.copytree(slice_run["assets"], dst)
    for name in drop:
        (dst / name).unlink()
    return dst


@pytest.mark.parametrize("name", ["deberta", "swinv2"])
def test_orbax_asset_without_pt_raises(slice_run, tmp_path, name):
    """A .ckpt with no .pt beside it names the conversion script; nothing
    is served in its place, reference families or not."""
    assets = _copy_assets(slice_run, tmp_path / "a", drop=[f"{name}.pt"])
    for reference_families in (False, True):
        with pytest.raises(FileNotFoundError,
                           match=rf"{name}\.ckpt.*orbax_to_torch"):
            tfrozen.load_or_init_frozen(
                assets, reference_families=reference_families)


def test_missing_key_and_sidecar_raise(slice_run, tmp_path):
    assets = _copy_assets(slice_run, tmp_path / "a")
    sd = torch.load(assets / "swinv2.pt", weights_only=True)
    del sd["stages.1.blocks.0.cpb2.weight"]
    torch.save(sd, assets / "swinv2.pt")
    with pytest.raises(RuntimeError, match=r"stages\.1\.blocks\.0\.cpb2"):
        tfrozen.load_or_init_frozen(assets)
    assets = _copy_assets(slice_run, tmp_path / "b",
                          drop=["deberta_config.json"])
    with pytest.raises(FileNotFoundError, match="deberta_config.json"):
        tfrozen.load_or_init_frozen(assets)


def test_predictor_refuses_orbax_best_model(slice_run):
    with pytest.raises(FileNotFoundError, match="orbax_to_torch"):
        MisinformationPredictor(ModelConfig(**KW), checkpoint_path=str(
            slice_run["out"] / "best_model"),
            encoders=slice_run["tpred"].enc, device="cpu")


def test_predictor_refuses_a_mismatched_config(slice_run):
    with pytest.raises(ValueError, match="do not fit"):
        MisinformationPredictor(
            ModelConfig(**dict(KW, hidden_dim=32)), checkpoint_path=str(
                slice_run["out"] / "best_model.pt"),
            encoders=slice_run["tpred"].enc, device="cpu")


def test_predictor_refuses_a_joint_state(slice_run, tmp_path):
    tpred = slice_run["tpred"]
    joint = L.ParamTree({"fusion": tpred.params, "text": tpred.enc.text_params,
                         "vit": tpred.enc.vit_params})
    save_params(str(tmp_path / "best_model.pt"), joint)
    with pytest.raises(ValueError, match="joint fine-tuning state"):
        MisinformationPredictor(ModelConfig(**KW), checkpoint_path=str(
            tmp_path / "best_model.pt"), encoders=tpred.enc, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        MisinformationPredictor(
            ModelConfig(**KW), checkpoint_path=str(tmp_path / "x.pt"),
            fusion_params=tpred.params.state_dict(), encoders=tpred.enc,
            device="cpu")
