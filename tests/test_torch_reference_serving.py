"""The reference-families serving slice (DeBERTa-v3 + Swinv2 + fusion) of
the port against the JAX package.

One set of JAX params, carried into the port by the bridge, serves the
same (claim, evidence) pairs -- real PNG files, a corrupt file and missing
images -- through both packages' MisinformationPredictor.evaluate_batch.
The widths reach every kernel of the path: DeBERTa hidden 128, 2 heads and
64 tokens pass its attention kernel's gate; the Swin config's blocks (dh
32, 8 x 8 windows, one shifted, one patch merge) and LayerNorms all take
their kernels; the fusion model's attentions take the flash kernel (the
JAX side runs its Pallas kernels in interpret mode, and on the CPU takes
DeBERTa's explicit path, as the port does). Labels and None-paths must be
identical and the probabilities within 1e-4 (fp32).
"""

import dataclasses

import jax
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.data.tokenizer import WordPieceTokenizer
from mmd_tpu.inference.predictor import (
    MisinformationPredictor as JPredictor,
)
from mmd_tpu.models import deberta as jdeberta
from mmd_tpu.models import fusion as jfusion
from mmd_tpu.models import swin as jswin
from mmd_tpu.models.frozen import FrozenEncoders as JEncoders
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer as TWordPiece
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.models import deberta as tdeberta
from mmd_tpu_torch.models import frozen as tfrozen
from mmd_tpu_torch.models import swin as tswin
from test_torch_serving import CORPUS, _check_evaluate_batch, _np_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference_pair(tmp_path_factory):
    """(JAX predictor, port predictor, image dir) with DeBERTa-v3 and
    Swinv2 encoders: hidden 128, 2 heads and 64 tokens pass the DeBERTa
    kernel's gate; the Swin config's blocks (dh 32, 8 x 8 windows, one
    shifted, one patch merge) and LayerNorms all take their kernels."""
    tok = WordPieceTokenizer.train(CORPUS, 200)
    text_cfg = jdeberta.DebertaConfig(
        vocab_size=max(tok.vocab_size, 128), hidden_size=128, num_layers=2,
        num_heads=2, intermediate_size=256, max_position=64,
        position_buckets=16)
    img_cfg = jswin.SwinConfig(image_size=64, patch_size=4, embed_dim=128,
                               depths=(2, 2), num_heads=(4, 8),
                               window_size=8, pretrained_window_sizes=(0, 0),
                               compute_dtype="float32")
    kw = dict(text_input_dim=128, image_input_dim=256, fused_attn=True,
              compute_dtype="float32")
    text_tree = _np_tree(jdeberta.init_deberta(jax.random.key(0), text_cfg))
    img_tree = _np_tree(jswin.init_swin(jax.random.key(1), img_cfg))
    fusion_tree = _np_tree(jfusion.init_fusion_params(
        jax.random.key(2), JModelConfig(**kw)))
    jpred = JPredictor(JModelConfig(**kw), fusion_params=fusion_tree,
                       encoders=JEncoders(tok, text_cfg, text_tree, img_cfg,
                                          img_tree),
                       max_length=64, batch_size=4)
    ptext = tdeberta.DebertaConfig(**dataclasses.asdict(text_cfg))
    pimg = tswin.SwinConfig(**dataclasses.asdict(img_cfg))
    enc = tfrozen.FrozenEncoders(
        TWordPiece(tok.vocab), ptext, bridge.deberta_from_jax(text_tree, ptext),
        pimg, bridge.swin_from_jax(img_tree, pimg))
    cfg = ModelConfig(**kw)
    tpred = MisinformationPredictor(
        cfg, fusion_params=bridge.fusion_from_jax(fusion_tree, cfg).state_dict(),
        encoders=enc, max_length=64, batch_size=4, device="cpu")
    return jpred, tpred, tmp_path_factory.mktemp("reference_images")


def test_reference_families_evaluate_batch_matches_jax(reference_pair):
    _check_evaluate_batch(*reference_pair)
