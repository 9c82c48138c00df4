"""The port's HF loaders and its converter (mmd_tpu_torch/convert_hf.py),
fully offline.

Each loader (DeBERTa-v3, Swinv2, BERT, ViT, the retrieval encoders:
MPNet and the BertForSequenceClassification cross-encoder, and the BLIP
captioner: its vision tower and its cross-attending text decoder, whose
teacher-forced logits are held to tests/test_hf_parity.py's BLIP
tolerances, rtol 2e-4 with atol 2e-5 for the vision states and 2e-4 for
the logits) reads the state dict of a
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

from mmd_tpu.models import captioner as jcaptioner
from mmd_tpu.models import deberta as jdeberta
from mmd_tpu.models import swin as jswin
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.transformer import TransformerConfig as JTransformer
from mmd_tpu_torch import bridge, convert_hf
from mmd_tpu_torch.data.spm import CONTROL, NORMAL, UNKNOWN, build_spm_model
from mmd_tpu_torch.models import captioner as tcaptioner
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


# -- BLIP, the captioner --------------------------------------------------------

def _blip():
    """tests/test_hf_parity.py's random-init BlipForConditionalGeneration."""
    vc = transformers.BlipVisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, projection_dim=16,
        attention_dropout=0.0)
    tc = transformers.BlipTextConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, encoder_hidden_size=32,
        projection_dim=16, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.BlipForConditionalGeneration(transformers.BlipConfig(
        text_config=tc.to_dict(), vision_config=vc.to_dict())).eval()


def _blip_cfg(hf):
    return tcaptioner.blip_config(hf.config.vision_config.to_dict(),
                                  hf.config.text_config.to_dict())


def _blip_logits(params, cfg, images, ids, mask):
    """The port's vision states and teacher-forced decoder logits."""
    from mmd_tpu_torch.models.transformer import (
        attention_mask_from_ids, causal_mask, embed,
    )
    with torch.no_grad():
        vis = tvit.vit_forward(params["vit"], cfg.vit, images)
        x = embed(params["decoder"]["embeddings"], cfg.decoder, ids)
        t = ids.shape[1]
        m = causal_mask(t) + attention_mask_from_ids(mask, t)
        h, _ = tcaptioner._decoder_stack(params, cfg.decoder, x, m, vis)
        return vis, tcaptioner._lm_logits(params, cfg.decoder, h)


def test_blip_loader_matches_transformers():
    hf = _blip()
    cfg = _blip_cfg(hf)
    params = tcaptioner.load_hf_blip_state_dict(_state_dict(hf), cfg)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 100, (2, 10)).astype(np.int64)
    mask = np.ones((2, 10), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        vis = hf.vision_model(pixel_values=torch.tensor(
            images.transpose(0, 3, 1, 2))).last_hidden_state
        want = hf.text_decoder(
            input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
            encoder_hidden_states=vis,
            encoder_attention_mask=torch.ones(2, vis.shape[1],
                                              dtype=torch.long)).logits
    got_vis, got = _blip_logits(params, cfg, torch.tensor(images),
                                torch.tensor(ids), torch.tensor(mask))
    np.testing.assert_allclose(got_vis.numpy(), vis.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_blip_loader_is_bit_identical_to_jax_loader():
    hf = _blip()
    sd = _state_dict(hf)
    jcfg = jcaptioner.blip_config(hf.config.vision_config.to_dict(),
                                  hf.config.text_config.to_dict())
    cfg = _blip_cfg(hf)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = jcaptioner.load_hf_blip_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    got = bridge.to_jax_tree(tcaptioner.load_hf_blip_state_dict(sd, cfg))
    import jax
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    assert tree_got == tree_want
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(flat_got, flat_want))


def test_blip_vision_loader_refuses_another_vit():
    with pytest.raises(ValueError, match="keep_cls"):
        tvit.load_hf_blip_vision_state_dict({}, tvit.VIT_TEST)


def _write_blip_dir(path, fmt):
    """A BLIP model directory: save_pretrained's (model.safetensors
    without the tied head weights, a config.json of the fields that differ
    from the defaults) or a full pytorch_model.bin with a full config; a
    vocab.txt with the WordPiece specials, and BLIP's [DEC] and [ENC] in
    tokenizer_config.json's added_tokens_decoder (with the safetensors)
    or in added_tokens.json (with the bin)."""
    from mmd_tpu_torch.data.tokenizer import SPECIALS
    hf = _blip()
    if fmt == "safetensors":
        hf.save_pretrained(path)
    else:
        path.mkdir(parents=True)
        hf.config.to_json_file(path / "config.json", use_diff=False)
        torch.save(_state_dict(hf), path / "pytorch_model.bin")
    vocab = SPECIALS + [f"w{i}" for i in range(93)]
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    if fmt == "safetensors":
        (path / "tokenizer_config.json").write_text(json.dumps(
            {"added_tokens_decoder": {"98": {"content": "[DEC]"},
                                      "99": {"content": "[ENC]"}}}))
    else:
        (path / "added_tokens.json").write_text(
            json.dumps({"[DEC]": 98, "[ENC]": 99}))
    return hf


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_convert_hf_writes_the_captioner(tmp_path, fmt):
    """captioner.pt equals the loader's params on the model's state dict;
    the sidecar is blip_config's; tokenizer.json keeps [DEC]; the assets
    caption as the params in memory do."""
    hf = _write_blip_dir(tmp_path / "hf", fmt)
    out = tmp_path / "assets"
    convert_hf.main(["--blip", str(tmp_path / "hf"), "--out", str(out)])
    cfg = _blip_cfg(hf)
    want = tcaptioner.load_hf_blip_state_dict(_state_dict(hf), cfg)
    got = torch.load(out / "captioner.pt", weights_only=True)
    assert got.keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    assert json.loads((out / "captioner_config.json").read_text()) == \
        json.loads(json.dumps(dataclasses.asdict(cfg)))
    tok, cfg2, params = tcaptioner.load_captioner_assets(out, "cpu")
    assert tok.vocab[-2:] == ["[DEC]", "[ENC]"] and tok.vocab_size == 100
    images = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    dec = tok.token_to_id["[DEC]"]
    assert torch.equal(
        tcaptioner.generate(params, cfg2, images, dec, tok.sep_id, 0, 6),
        tcaptioner.generate(want, cfg, images, dec, tok.sep_id, 0, 6))


def test_convert_hf_blip_refuses_a_head_bias_it_does_not_read(tmp_path):
    _write_blip_dir(tmp_path / "hf", "bin")
    path = tmp_path / "hf" / "pytorch_model.bin"
    sd = torch.load(path, weights_only=True)
    sd["text_decoder.cls.predictions.decoder.bias"] = sd[
        "text_decoder.cls.predictions.bias"] + 1.0
    torch.save(sd, path)
    with pytest.raises(ValueError, match="decoder.bias"):
        convert_hf.convert_blip(tmp_path / "hf", tmp_path / "assets")
    _write_hf_dir(tmp_path / "bert", "bert", "bin")
    with pytest.raises(ValueError, match="blip"):
        convert_hf.convert_blip(tmp_path / "bert", tmp_path / "assets")


# -- the retrieval encoders: MPNet and the cross-encoder --------------------------

def _mpnet():
    cfg = transformers.MPNetConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, relative_attention_num_buckets=32,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-5)
    return transformers.MPNetModel(cfg, add_pooling_layer=False).eval()


def _cross():
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
        num_labels=1, classifier_dropout=0.0)
    return transformers.BertForSequenceClassification(cfg).eval()


def _mpnet_inputs():
    """Row 1 padded from 10 with MPNet's pad id (1)."""
    ids, mask = _text_inputs(3, 3, 10)
    ids[1, 10:] = 1
    return ids, mask


def _cross_inputs():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 120, (3, 20)).astype(np.int64)
    mask = np.ones((3, 20), np.int64)
    mask[2, 12:] = 0
    types = np.zeros((3, 20), np.int64)
    types[:, 10:] = 1
    return ids, mask, types


def _mpnet_output(params, cfg):
    ids, mask = _mpnet_inputs()
    with torch.no_grad():
        return _encode_text(params, cfg, ids, mask).numpy()


def _cross_output(params, cfg):
    with torch.no_grad():
        return tte.cross_encoder_score(
            params, cfg, *map(torch.from_numpy, _cross_inputs())).numpy()


def test_mpnet_loader_matches_transformers():
    hf = _mpnet()
    cfg = _fp32(tte.mpnet_config_from_hf(hf.config.to_dict()))
    assert (cfg.relative_bias_buckets, cfg.mpnet_positions, cfg.pad_token_id,
            cfg.type_vocab_size, cfg.max_position) == (32, True, 1, 0, 48)
    got = _mpnet_output(tte.load_hf_mpnet_state_dict(_state_dict(hf), cfg),
                        cfg)
    ids, mask = _mpnet_inputs()
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask)
                  ).last_hidden_state.numpy()
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1, :10], want[1, :10], rtol=RTOL,
                               atol=ATOL)


def test_cross_encoder_loader_matches_transformers():
    hf = _cross()
    cfg = _fp32(tte.config_from_hf(hf.config.to_dict(),
                                   cap_positions=False))
    got = _cross_output(
        tte.load_hf_cross_encoder_state_dict(_state_dict(hf), cfg), cfg)
    ids, mask, types = map(torch.from_numpy, _cross_inputs())
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask,
                  token_type_ids=types).logits.numpy()[:, 0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["mpnet", "cross_encoder"])
def test_retrieval_loader_is_bit_identical_to_jax_loader(which):
    hf = _mpnet() if which == "mpnet" else _cross()
    c = hf.config.to_dict()
    cfg = _fp32(tte.mpnet_config_from_hf(c) if which == "mpnet"
                else tte.config_from_hf(c, cap_positions=False))
    jcfg = JTransformer(**dataclasses.asdict(cfg))
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    if which == "mpnet":
        want = jte.load_hf_mpnet_state_dict(sd, jcfg)
        got = tte.load_hf_mpnet_state_dict(sd, cfg)
    else:
        want = jte.load_hf_cross_encoder_state_dict(sd, jcfg)
        got = tte.load_hf_cross_encoder_state_dict(sd, cfg)
    _assert_trees_identical(bridge.to_jax_tree(got), want)


def test_mpnet_loader_refuses_a_bert_config():
    with pytest.raises(ValueError, match="mpnet"):
        tte.load_hf_mpnet_state_dict(_state_dict(_mpnet()), tte.TINY_TEST)


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
    with pytest.raises(ValueError, match="vit"):
        convert_hf.convert(tmp_path / "hf", tmp_path / "out", ("mpnet",))


def _save_dir(path, hf, sd, vocab=None):
    from safetensors.torch import save_file
    path.mkdir(parents=True)
    hf.config.to_json_file(path / "config.json")
    save_file({k: v.detach().clone().contiguous() for k, v in sd.items()},
              str(path / "model.safetensors"))
    if vocab is not None:
        (path / "vocab.txt").write_text("\n".join(vocab) + "\n")


# the head of MPNet's vocab.txt: RoBERTa-style specials first
MPNET_VOCAB = (["<s>", "<pad>", "</s>", "<unk>"] + [f"w{i}" for i in range(115)]
               + ["<mask>"])


@pytest.mark.parametrize("flag", ["--text", "--bi_encoder"])
def test_convert_hf_mpnet_writes_the_bi_encoder(tmp_path, flag):
    """An MPNetForMaskedLM-style directory (mpnet. prefix, lm_head and
    pooler keys): bi_encoder.pt equal to the loader's params, its sidecar,
    and bi_tokenizer.json with the specials renamed; the converted files
    give the HF output through resolve_retrieval_encoders."""
    from mmd_tpu_torch.retrieval.text import resolve_retrieval_encoders
    hf = _mpnet()
    sd = {"mpnet." + k: v for k, v in hf.state_dict().items()}
    sd["lm_head.bias"] = torch.zeros(120)
    sd["mpnet.pooler.dense.weight"] = torch.zeros(32, 32)
    _save_dir(tmp_path / "hf", hf, sd, MPNET_VOCAB)
    out = tmp_path / "assets"
    convert_hf.main([flag, str(tmp_path / "hf"), "--out", str(out)])
    cfg = tte.mpnet_config_from_hf(hf.config.to_dict())
    want = tte.load_hf_mpnet_state_dict(_state_dict(hf), cfg).state_dict()
    got = torch.load(out / "bi_encoder.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert json.loads((out / "bi_encoder_config.json").read_text()) == \
        json.loads(json.dumps(dataclasses.asdict(cfg)))
    vocab = json.loads((out / "bi_tokenizer.json").read_text())["vocab"]
    assert vocab[:4] == ["[CLS]", "[PAD]", "[SEP]", "[UNK]"]
    assert vocab[-1] == "[MASK]"
    enc = resolve_retrieval_encoders(out)
    assert enc["bi_cfg"] == cfg and enc["bi_tokenizer"].pad_id == 1
    np.testing.assert_allclose(
        _mpnet_output(enc["bi_params"], _fp32(enc["bi_cfg"]))[0],
        _mpnet_output(tte.load_hf_mpnet_state_dict(_state_dict(hf), cfg),
                      _fp32(cfg))[0], rtol=0, atol=0)


def test_convert_hf_writes_the_cross_encoder(tmp_path):
    from mmd_tpu_torch.retrieval.text import resolve_retrieval_encoders
    hf = _cross()
    _save_dir(tmp_path / "hf", hf, hf.state_dict())
    out = tmp_path / "assets"
    convert_hf.main(["--cross_encoder", str(tmp_path / "hf"), "--out",
                     str(out)])
    cfg = tte.config_from_hf(hf.config.to_dict(), cap_positions=False)
    want = tte.load_hf_cross_encoder_state_dict(_state_dict(hf), cfg)
    got = torch.load(out / "cross_encoder.pt", weights_only=True)
    assert got.keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    enc = resolve_retrieval_encoders(out)
    assert enc["cross_cfg"] == cfg and "pooler" in enc["cross_params"]
    with torch.no_grad():
        want_logits = hf(*map(torch.from_numpy, _cross_inputs())
                         ).logits.numpy()[:, 0]
    np.testing.assert_allclose(
        _cross_output(enc["cross_params"], _fp32(cfg)), want_logits,
        rtol=RTOL, atol=ATOL)
    # a cross-encoder must be a BERT classifier; an unread key raises
    sd = dict(hf.state_dict(), **{"bert.extra": torch.zeros(2)})
    (tmp_path / "hf" / "model.safetensors").unlink()
    from safetensors.torch import save_file
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "hf" / "model.safetensors"))
    with pytest.raises(ValueError, match="bert.extra"):
        convert_hf.convert_cross_encoder(tmp_path / "hf", tmp_path / "o2")
    _save_dir(tmp_path / "mp", _mpnet(), _mpnet().state_dict())
    with pytest.raises(ValueError, match="mpnet"):
        convert_hf.convert_cross_encoder(tmp_path / "mp", tmp_path / "o3")


def test_convert_hf_writes_resnet50(tmp_path):
    """A torchvision resnet50 state dict file (its fc head and counters
    included) -> resnet50.pt, the loader's params; an unread key raises."""
    from mmd_tpu_torch.models import resnet as tresnet
    from test_torch_resnet import _torchvision_state_dict
    sd = {k: torch.from_numpy(v) for k, v in
          _torchvision_state_dict(tresnet.ResNetConfig(), seed=5).items()}
    torch.save(sd, tmp_path / "resnet50.pth")
    convert_hf.main(["--resnet", str(tmp_path / "resnet50.pth"), "--out",
                     str(tmp_path / "assets")])
    want = tresnet.load_torchvision_state_dict(sd).state_dict()
    got = torch.load(tmp_path / "assets" / "resnet50.pt", weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    torch.save(dict(sd, extra=torch.zeros(1)), tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="extra"):
        convert_hf.convert_resnet(tmp_path / "bad.pth", tmp_path / "o")


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
