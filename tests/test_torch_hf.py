"""The port's HF loaders and its converter (mmd_tpu_torch/convert_hf.py),
fully offline.

Each loader (DeBERTa-v3, Swinv2, BERT, ViT) reads the state dict of a
random-init `transformers` model built from tests/test_hf_parity.py's config
objects: the port's encoder must reproduce the HF model's output within
that file's rtol=3e-4, atol=3e-5 (fp32), and every parameter must be
bit-identical to the JAX package's loader on the same state dict (through
bridge.to_jax_tree, which transposes each nn.Linear weight back to the JAX
(in, out) layout: a loader that transposed once too often fails here,
square layers included). The converter runs on model directories written
in the test, as pytorch_model.bin and as model.safetensors, with the task
wrapper's prefix and head keys present.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mmd_tpu.models import deberta as jdeberta
from mmd_tpu.models import swin as jswin
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.transformer import TransformerConfig as JTransformer
from mmd_tpu_torch import bridge, convert_hf
from mmd_tpu_torch.data.spm import CONTROL, NORMAL, UNKNOWN, build_spm_model
from mmd_tpu_torch.models import deberta as tdeberta
from mmd_tpu_torch.models import frozen as tfrozen
from mmd_tpu_torch.models import swin as tswin
from mmd_tpu_torch.models import text_encoder as tte
from mmd_tpu_torch.models import vit as tvit

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

RTOL, ATOL = 3e-4, 3e-5


# -- the HF models of tests/test_hf_parity.py ----------------------------------

def _bert():
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12)
    return transformers.BertModel(cfg, add_pooling_layer=False).eval()


def _deberta():
    cfg = transformers.DebertaV2Config(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, relative_attention=True,
        position_buckets=8, norm_rel_ebd="layer_norm", share_att_key=True,
        pos_att_type=["p2c", "c2p"], position_biased_input=False,
        type_vocab_size=0, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-7,
        hidden_act="gelu")
    return transformers.DebertaV2Model(cfg).eval()


def _vit():
    cfg = transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
        hidden_act="gelu")
    return transformers.ViTModel(cfg, add_pooling_layer=False).eval()


def _swinv2():
    cfg = transformers.Swinv2Config(
        image_size=32, patch_size=4, embed_dim=16, depths=[2, 2],
        num_heads=[2, 4], window_size=4, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, drop_path_rate=0.0,
        layer_norm_eps=1e-5, hidden_act="gelu")
    return transformers.Swinv2Model(cfg, add_pooling_layer=False).eval()


def _fp32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _state_dict(hf):
    return {k: v.detach().clone() for k, v in hf.state_dict().items()}


def _text_inputs(seed, lo, n_real):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, 120, (2, 16)).astype(np.int64)
    mask = np.ones((2, 16), np.int64)
    mask[1, n_real:] = 0
    return ids, mask


def _images(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def _encode_text(params, cfg, ids, mask):
    fn = (tdeberta.deberta_encode if isinstance(cfg, tdeberta.DebertaConfig)
          else tte.encode)
    return fn(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))


# family -> (HF model, port config_from_hf, port loader, JAX loader, JAX
#            config class)
FAMILIES = {
    "deberta": (_deberta, tdeberta.config_from_hf,
                tdeberta.load_hf_deberta_state_dict,
                jdeberta.load_hf_deberta_state_dict, jdeberta.DebertaConfig),
    "bert": (_bert, tte.config_from_hf, tte.load_hf_state_dict,
             jte.load_hf_state_dict, JTransformer),
    "vit": (_vit, tvit.config_from_hf, tvit.load_hf_vit_state_dict,
            jvit.load_hf_vit_state_dict, jvit.ViTConfig),
    "swinv2": (_swinv2, tswin.config_from_hf,
               tswin.load_hf_swinv2_state_dict,
               jswin.load_hf_swinv2_state_dict, jswin.SwinConfig),
}


def _port_output(family, params, cfg):
    with torch.no_grad():
        if family in ("deberta", "bert"):
            ids, mask = _text_inputs(0, 1, 11)
            return _encode_text(params, cfg, ids, mask).numpy()
        x = torch.from_numpy(_images(1))
        fwd = tvit.vit_forward if family == "vit" else tswin.swin_forward
        return fwd(params, cfg, x).numpy()


def _hf_output(family, hf):
    with torch.no_grad():
        if family in ("deberta", "bert"):
            ids, mask = _text_inputs(0, 1, 11)
            out = hf(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).last_hidden_state
            return out.numpy()
        out = hf(pixel_values=torch.from_numpy(
            _images(1).transpose(0, 3, 1, 2))).last_hidden_state.numpy()
        return out[:, 1:] if family == "vit" else out      # ViT's CLS row


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_matches_transformers(family):
    make, config_from_hf, load, _, _ = FAMILIES[family]
    hf = make()
    cfg = _fp32(config_from_hf(hf.config.to_dict()))
    params = load(_state_dict(hf), cfg)
    got, want = _port_output(family, params, cfg), _hf_output(family, hf)
    assert got.shape == want.shape
    if family in ("deberta", "bert"):      # padded positions differ
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[1, :11], want[1, :11], rtol=RTOL,
                                   atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_trees_identical(got, want, where="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_identical(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_identical(g, w, f"{where}[{i}]")
    else:
        w = np.asarray(want)
        assert got.dtype == np.float32 and got.shape == w.shape, where
        np.testing.assert_array_equal(got, w, err_msg=where)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_is_bit_identical_to_jax_loader(family):
    """Same state dict, numpy values as the JAX loader takes them; the
    port's params walked back to the JAX layout equal the JAX tree bit for
    bit, ln_pre's identity included."""
    make, config_from_hf, load, jload, jcls = FAMILIES[family]
    hf = make()
    cfg = _fp32(config_from_hf(hf.config.to_dict()))
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    want = jload(sd, jcls(**dataclasses.asdict(cfg)))
    got = bridge.to_jax_tree(load(sd, cfg))
    _assert_trees_identical(got, want)


def test_deberta_config_rules():
    c = _deberta().config.to_dict()
    assert tdeberta.config_from_hf(c).max_position == 32   # -1 -> max pos
    assert tdeberta.config_from_hf(dict(c, max_relative_positions=16)
                                   ).max_position == 16
    assert tdeberta.config_from_hf(c).compute_dtype == "float32"
    for bad in (dict(share_att_key=False), dict(position_biased_input=True),
                dict(pos_att_type=["c2p"]), dict(relative_attention=False)):
        with pytest.raises(ValueError):
            tdeberta.config_from_hf(dict(c, **bad))


def test_swin_config_from_hf_matches_jax():
    hf_cfg = _swinv2().config
    got = tswin.config_from_hf(hf_cfg.to_dict())
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jswin.config_from_hf(hf_cfg))


def test_unported_loaders_name_their_slice():
    with pytest.raises(NotImplementedError, match="A12"):
        tte.load_hf_mpnet_state_dict({}, tte.TINY_TEST)
    with pytest.raises(NotImplementedError, match="A12"):
        tte.load_hf_cross_encoder_state_dict({}, tte.TINY_TEST)
    with pytest.raises(NotImplementedError, match="A13"):
        tvit.load_hf_blip_vision_state_dict({}, tvit.VIT_TEST)


# -- the converter --------------------------------------------------------------

def _spm_model():
    pieces = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL),
              ("[SEP]", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN)]
    rng = np.random.default_rng(0)
    for tok in list("abcdefghijklmnopqrstuvwxyz") + ["▁the", "▁claim", "▁"]:
        pieces.append((tok, float(-1.0 - 10.0 * rng.random()), NORMAL))
    return build_spm_model(pieces)


# family -> (HF factory, task prefix, extra head keys, extra files)
HEADS = {
    "deberta": ("deberta.", {"lm_predictions.lm_head.bias": (120,),
                             "mask_predictions.dense.weight": (32, 32),
                             "deberta.embeddings.position_ids": (1, 32)}),
    "bert": ("bert.", {"cls.predictions.bias": (120,),
                       "pooler.dense.weight": (32, 32)}),
    "vit": ("vit.", {"classifier.weight": (5, 32), "classifier.bias": (5,)}),
    "swinv2": ("swinv2.", {"classifier.weight": (5, 32)}),
}
ASSET = {"deberta": "deberta", "bert": "text_encoder", "vit": "vit",
         "swinv2": "swinv2"}


def _write_hf_dir(path, family, fmt, drop=None):
    hf = FAMILIES[family][0]()
    prefix, heads = HEADS[family]
    sd = {prefix + k: v.detach().clone().contiguous()
          for k, v in hf.state_dict().items()}
    for k, shape in heads.items():
        sd[k] = torch.zeros(shape)
    if drop is not None:
        del sd[prefix + drop]
    path.mkdir(parents=True)
    hf.config.to_json_file(path / "config.json")
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file
        save_file(sd, str(path / "model.safetensors"))
    if family == "deberta":
        (path / "spm.model").write_bytes(_spm_model())
    if family == "bert":
        from mmd_tpu_torch.data.tokenizer import SPECIALS
        vocab = SPECIALS + [f"w{i}" for i in range(115)]
        (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return hf


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_convert_hf_writes_the_assets(tmp_path, family, fmt):
    """The converted files equal the loader's params on the bare state
    dict; the sidecar is the config; the tokenizer files are written."""
    hf = _write_hf_dir(tmp_path / "hf", family, fmt)
    out = tmp_path / "assets"
    convert_hf.main(["--text" if family in ("deberta", "bert") else "--image",
                     str(tmp_path / "hf"), "--out", str(out)])
    name = ASSET[family]
    _, config_from_hf, load, _, _ = FAMILIES[family]
    cfg = config_from_hf(hf.config.to_dict())
    want = load(_state_dict(hf), cfg).state_dict()
    got = torch.load(out / f"{name}.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert json.loads((out / f"{name}_config.json").read_text()) == json.loads(
        json.dumps(dataclasses.asdict(cfg)))
    if family == "deberta":
        assert (out / "spm.json").exists()
    if family == "bert":
        assert json.loads((out / "tokenizer.json").read_text())["vocab"][:5] \
            == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_assets_serve_through_frozen(tmp_path, family):
    """load_or_init_frozen picks the converted file up (the DeBERTa and
    Swinv2 files ahead of the seeded reference families, which in turn go
    ahead of the BERT and ViT files) and gives the HF output."""
    hf = _write_hf_dir(tmp_path / "hf", family, "safetensors")
    out = tmp_path / "assets"
    convert_hf.convert(tmp_path / "hf", out)
    if family not in ("deberta", "bert"):
        from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
        WordPieceTokenizer.train(["a claim"], 50).save(out / "tokenizer.json")
    enc = tfrozen.load_or_init_frozen(
        out, reference_families=family in ("deberta", "swinv2"))
    if family in ("deberta", "bert"):
        cfg, params = _fp32(enc.text_cfg), enc.text_params
    else:
        cfg, params = _fp32(enc.vit_cfg), enc.vit_params
    got, want = _port_output(family, params, cfg), _hf_output(family, hf)
    if family in ("deberta", "bert"):
        got, want = got[0], want[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_hf_missing_key_raises(tmp_path, fmt):
    _write_hf_dir(tmp_path / "hf", "swinv2", fmt,
                  drop="encoder.layers.1.blocks.0.attention.self.logit_scale")
    with pytest.raises(KeyError, match=r"encoder\.layers\.1\.blocks\.0\."
                                       r"attention\.self\.logit_scale"):
        convert_hf.convert(tmp_path / "hf", tmp_path / "out")
    assert not (tmp_path / "out" / "swinv2.pt").exists()


def test_convert_hf_refuses_unread_keys_and_families(tmp_path):
    hf = _write_hf_dir(tmp_path / "hf", "vit", "bin")
    sd = torch.load(tmp_path / "hf" / "pytorch_model.bin", weights_only=True)
    sd["vit.embeddings.extra_table"] = torch.zeros(3)
    torch.save(sd, tmp_path / "hf" / "pytorch_model.bin")
    with pytest.raises(ValueError, match="extra_table"):
        convert_hf.convert(tmp_path / "hf", tmp_path / "out")
    with pytest.raises(ValueError, match="vit"):
        convert_hf.convert(tmp_path / "hf", tmp_path / "out",
                           convert_hf.TEXT_FAMILIES)
    cfg = hf.config.to_dict()
    (tmp_path / "hf" / "config.json").write_text(
        json.dumps(dict(cfg, model_type="mpnet")))
    with pytest.raises(NotImplementedError, match="A12"):
        convert_hf.convert(tmp_path / "hf", tmp_path / "out")


def test_read_safetensors_matches_the_library(tmp_path):
    from safetensors.torch import load_file, save_file
    tensors = {"a": torch.randn(3, 5), "b": torch.arange(7, dtype=torch.int64),
               "c": torch.randn(4).to(torch.bfloat16),
               "d": torch.randn(2, 2).half(), "e": torch.zeros(0)}
    save_file(tensors, str(tmp_path / "x.safetensors"),
              metadata={"format": "pt"})
    got = convert_hf.read_safetensors(tmp_path / "x.safetensors")
    want = load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
