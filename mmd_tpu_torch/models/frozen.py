"""Frozen-encoder asset management (counterpart of mmd_tpu/models/frozen.py).

Encoders resolve in the JAX package's priority order:

  1. converted checkpoints under <assets>: deberta.pt + deberta_config.json
     (the reference's DeBERTa-v3) before text_encoder.pt (BERT-class),
     swinv2.pt + swinv2_config.json (the reference's Swinv2) before vit.pt
     (vit_config.json, when present, sets the ViT's shape);
  2. a deterministic seeded init (same seed -> same params in every run of
     the port): the BERT-class text encoder and the ViT, or with
     `reference_families=True` the reference's own families,
     DeBERTa-v3-xsmall and Swinv2-base.

`python -m mmd_tpu_torch.convert_hf` writes these files from a HF download,
tools/orbax_to_torch.py from the JAX package's orbax assets
(<name>.ckpt). Each .pt file is a state dict of the port's module, loaded
strictly; a <name>.ckpt with no <name>.pt beside it raises and names the
script, never serving a seeded encoder in its place.

The tokenizer is data-dependent and therefore always persisted: spm.json
(the unigram vocab exported with a DeBERTa checkpoint, which reproduces
DebertaV2Tokenizer's ids) before tokenizer.json (WordPiece, the JAX
package's format), trained from the corpus text on first use.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Iterable, Optional

import torch

from mmd_tpu_torch.core.checkpoint import load_params, orbax_error
from mmd_tpu_torch.data.spm import UnigramTokenizer
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import deberta as D
from mmd_tpu_torch.models import swin as SW
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as V
from mmd_tpu_torch.models.transformer import TransformerConfig

DEFAULT_ASSETS = "assets/encoders"


@dataclasses.dataclass
class FrozenEncoders:
    tokenizer: WordPieceTokenizer | UnigramTokenizer   # one encode_batch
    text_cfg: TransformerConfig | D.DebertaConfig
    text_params: torch.nn.Module
    vit_cfg: V.ViTConfig | SW.SwinConfig   # both expose image_size,
    vit_params: torch.nn.Module            # compute_dtype, num_tokens and
                                           # hidden_size


def text_encode(params, cfg, input_ids, attention_mask=None):
    """Text-encoder dispatch on the config family: DeBERTa-v3 or the
    BERT-class stack. (B, T) ids -> (B, T, hidden)."""
    if isinstance(cfg, D.DebertaConfig):
        return D.deberta_encode(params, cfg, input_ids, attention_mask)
    if isinstance(cfg, TransformerConfig):
        return te.encode(params, cfg, input_ids, attention_mask)
    raise TypeError(f"no text encoder for {type(cfg).__name__}")


TEXT_PARALLELISM = ("tp", "pp", "sp", "sp_ring")


def text_encode_parallel(params, cfg, input_ids, attention_mask=None, *,
                         mesh, mode: str, local_rows: bool = False):
    """text_encode under a parallelism strategy over the ranks of `mesh`
    (core/mesh.py):

      "tp"       Megatron head/FFN split (the params already sharded by
                 parallel/tp.shard_encoder)
      "pp"       GPipe layer stages over the model axis (BERT/MPNet/DeBERTa;
                 each rank's stage placed by parallel/pp.shard_stages)
      "sp"       sequence parallel: local query rows against all-gathered
                 K/V (BERT/MPNet post-LN stacks and DeBERTa)
      "sp_ring"  sequence parallel with ring attention

    The (B, T, D) result is on every rank, as the JAX package's global
    array; for "pp" and "sp" that costs one final gather (a broadcast from
    the last stage, an all-gather of the sequence blocks).

    "pp", "sp" and "sp_ring" are also the fine-tuning step's training call
    (training/trainer.py): where autograd records, gradients reach every
    text param, and `local_rows=True` says the batch is this rank's rows
    of the global batch already, which is then never split or gathered
    over "data"."""
    is_deberta = isinstance(cfg, D.DebertaConfig)
    if mode == "tp":
        from mmd_tpu_torch.parallel.tp import tensor_parallel_encode
        return tensor_parallel_encode(params, cfg, input_ids, attention_mask,
                                      mesh=mesh)
    if mode == "pp":
        from mmd_tpu_torch.parallel.pp import (
            pipeline_encode, pipeline_encode_deberta)
        fn = pipeline_encode_deberta if is_deberta else pipeline_encode
        return fn(params, cfg, input_ids, attention_mask, mesh=mesh,
                  local_rows=local_rows)
    if mode in ("sp", "sp_ring"):
        from mmd_tpu_torch.parallel.sp import (
            sequence_parallel_encode, sequence_parallel_encode_deberta)
        fn = (sequence_parallel_encode_deberta if is_deberta
              else sequence_parallel_encode)
        return fn(params, cfg, input_ids, attention_mask, mesh=mesh,
                  ring=(mode == "sp_ring"), local_rows=local_rows)
    raise ValueError(f"unknown text parallelism mode: {mode!r}")


def image_encode(params, cfg, images):
    """Image-encoder dispatch on the config family: Swinv2 or the ViT.
    images (B, H, W, 3) float NHWC -> (B, num_tokens, hidden)."""
    if isinstance(cfg, SW.SwinConfig):
        return SW.swin_forward(params, cfg, images)
    if isinstance(cfg, V.ViTConfig):
        return V.vit_forward(params, cfg, images)
    raise TypeError(f"no image encoder for {type(cfg).__name__}")


def asset_path(assets: Path, name: str) -> Optional[Path]:
    """<assets>/<name>.pt, or None; an orbax <name>.ckpt in its place
    raises."""
    pt = assets / f"{name}.pt"
    if pt.exists():
        return pt
    if (assets / f"{name}.ckpt").exists():
        raise orbax_error(assets / f"{name}.ckpt", pt)
    return None


def _sidecar(assets: Path, name: str, cls):
    return cls(**json.loads((assets / f"{name}_config.json").read_text()))


def load_or_init_frozen(
    assets_dir: str | os.PathLike = DEFAULT_ASSETS,
    vocab_texts: Optional[Iterable[str]] = None,
    vocab_size: int = 30000,
    seed: int = 0,
    tiny: bool = False,
    reference_families: bool = False,
) -> FrozenEncoders:
    """Converted checkpoints take priority either way.
    `reference_families=True` makes the seeded fallbacks DeBERTa-v3-xsmall
    (bf16) and Swinv2-base instead of the BERT-class/ViT substitutes.
    `tiny` ignores it and the DeBERTa/Swinv2 checkpoints, as in the JAX
    package; the BERT/ViT checkpoints and the tokenizers load either way.
    A BERT checkpoint takes its shape from text_encoder_config.json when
    the converter wrote one, else from the tokenizer (the JAX package's
    rule)."""
    assets = Path(assets_dir)
    # every asset this call would read, before any is built: a missing
    # conversion raises at once
    deberta = None if tiny else asset_path(assets, "deberta")
    swin = None if tiny else asset_path(assets, "swinv2")
    seed_text = deberta is None and reference_families and not tiny
    seed_image = swin is None and reference_families and not tiny
    text_pt = (None if deberta is not None or seed_text
               else asset_path(assets, "text_encoder"))
    vit_pt = (None if swin is not None or seed_image
              else asset_path(assets, "vit"))
    assets.mkdir(parents=True, exist_ok=True)

    spm_path = assets / "spm.json"
    tok_path = assets / "tokenizer.json"
    if spm_path.exists():
        tokenizer = UnigramTokenizer.load(spm_path)
    elif tok_path.exists():
        tokenizer = WordPieceTokenizer.load(tok_path)
    else:
        if vocab_texts is None:
            raise FileNotFoundError(
                f"no tokenizer at {tok_path}; pass vocab_texts to train one")
        tokenizer = WordPieceTokenizer.train(vocab_texts, vocab_size)
        tokenizer.save(tok_path)

    if tiny:
        text_cfg = dataclasses.replace(
            te.TINY_TEST, vocab_size=max(tokenizer.vocab_size, 128))
        vit_cfg = V.VIT_TEST
    else:
        text_cfg = dataclasses.replace(
            te.TEXT_ENCODER_XSMALL, vocab_size=tokenizer.vocab_size)
        vit_cfg_path = assets / "vit_config.json"
        if vit_cfg_path.exists():
            vit_cfg = V.ViTConfig(**json.loads(vit_cfg_path.read_text()))
        else:
            vit_cfg = V.ViTConfig()

    text_gen = torch.Generator().manual_seed(seed)
    vit_gen = torch.Generator().manual_seed(seed + 1)
    if deberta is not None:
        text_cfg = _sidecar(assets, "deberta", D.DebertaConfig)
        text_params = load_params(deberta, D.init_deberta(text_gen, text_cfg))
    elif seed_text:
        text_cfg = dataclasses.replace(
            D.DEBERTA_V3_XSMALL, vocab_size=max(tokenizer.vocab_size, 128),
            compute_dtype="bfloat16")
        text_params = D.init_deberta(text_gen, text_cfg)
    else:
        if text_pt is not None and (
                assets / "text_encoder_config.json").exists():
            text_cfg = _sidecar(assets, "text_encoder", TransformerConfig)
        text_params = te.init_text_encoder(text_gen, text_cfg)
        if text_pt is not None:
            load_params(text_pt, text_params)
    if swin is not None:
        vit_cfg = _sidecar(assets, "swinv2", SW.SwinConfig)
        vit_params = load_params(swin, SW.init_swin(vit_gen, vit_cfg))
    elif seed_image:
        vit_cfg = SW.SWIN_BASE_256
        vit_params = SW.init_swin(vit_gen, vit_cfg)
    else:
        vit_params = V.init_vit(vit_gen, vit_cfg)
        if vit_pt is not None:
            load_params(vit_pt, vit_params)
    return FrozenEncoders(tokenizer, text_cfg, text_params, vit_cfg,
                          vit_params)
