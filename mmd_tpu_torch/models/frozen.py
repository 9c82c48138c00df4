"""Frozen-encoder asset management (counterpart of mmd_tpu/models/frozen.py).

The encoders come from a deterministic seeded init (same seed -> same
params in every run of the port): the BERT-class text encoder and the ViT,
or with `reference_families=True` the reference's own families,
DeBERTa-v3-xsmall and Swinv2-base. The tokenizer is data-dependent and
therefore always persisted (<assets>/tokenizer.json, the JAX package's
format), trained on first use from the corpus text.

Converted checkpoints (orbax directories, which need JAX to read) and the
spm vocabulary exported with the DeBERTa checkpoint load with the
checkpoint port. When one is present, loading raises instead of serving a
different encoder or tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Iterable, Optional

import torch

from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.models import deberta as D
from mmd_tpu_torch.models import swin as SW
from mmd_tpu_torch.models import text_encoder as te
from mmd_tpu_torch.models import vit as V
from mmd_tpu_torch.models.transformer import TransformerConfig

DEFAULT_ASSETS = "assets/encoders"

# converted assets; the checkpoint port loads them
_UNPORTED_ASSETS = ("deberta.ckpt", "swinv2.ckpt", "text_encoder.ckpt",
                    "vit.ckpt", "spm.json")


@dataclasses.dataclass
class FrozenEncoders:
    tokenizer: WordPieceTokenizer
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


def image_encode(params, cfg, images):
    """Image-encoder dispatch on the config family: Swinv2 or the ViT.
    images (B, H, W, 3) float NHWC -> (B, num_tokens, hidden)."""
    if isinstance(cfg, SW.SwinConfig):
        return SW.swin_forward(params, cfg, images)
    if isinstance(cfg, V.ViTConfig):
        return V.vit_forward(params, cfg, images)
    raise TypeError(f"no image encoder for {type(cfg).__name__}")


def load_or_init_frozen(
    assets_dir: str | os.PathLike = DEFAULT_ASSETS,
    vocab_texts: Optional[Iterable[str]] = None,
    vocab_size: int = 30000,
    seed: int = 0,
    tiny: bool = False,
    reference_families: bool = False,
) -> FrozenEncoders:
    """Same resolution as the JAX package, minus converted assets, which
    raise NotImplementedError where the JAX package would load them.
    `reference_families=True` seeds DeBERTa-v3-xsmall (bf16) and
    Swinv2-base instead of the BERT-class/ViT substitutes; `tiny` ignores
    it, as in the JAX package."""
    assets = Path(assets_dir)
    # tiny configs ignore the DeBERTa/Swinv2 checkpoints in the JAX
    # package; the BERT/ViT checkpoints and the spm vocabulary load either
    # way
    for name in _UNPORTED_ASSETS:
        if tiny and name in ("deberta.ckpt", "swinv2.ckpt"):
            continue
        if (assets / name).exists():
            raise NotImplementedError(
                f"{assets / name} is present; converted assets load with "
                f"the checkpoint port")
    assets.mkdir(parents=True, exist_ok=True)

    tok_path = assets / "tokenizer.json"
    if tok_path.exists():
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
    if reference_families and not tiny:
        text_cfg = dataclasses.replace(
            D.DEBERTA_V3_XSMALL, vocab_size=max(tokenizer.vocab_size, 128),
            compute_dtype="bfloat16")
        text_params = D.init_deberta(text_gen, text_cfg)
        vit_cfg = SW.SWIN_BASE_256
        vit_params = SW.init_swin(vit_gen, vit_cfg)
    else:
        text_params = te.init_text_encoder(text_gen, text_cfg)
        vit_params = V.init_vit(vit_gen, vit_cfg)
    return FrozenEncoders(tokenizer, text_cfg, text_params, vit_cfg,
                          vit_params)
