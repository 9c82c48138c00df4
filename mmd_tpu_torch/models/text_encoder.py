"""Frozen BERT-class text encoder (counterpart of
mmd_tpu/models/text_encoder.py's encoder path and its BERT-family HF loader;
the MPNet and cross-encoder loaders arrive with the retrieval slice)."""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.transformer import (
    TransformerConfig, init_transformer, transformer_forward,
)

# Dim-parity presets (hidden sizes per reference §2.5)
TEXT_ENCODER_XSMALL = TransformerConfig(     # deberta-v3-xsmall contract
    vocab_size=128100, hidden_size=384, num_layers=12, num_heads=6,
    intermediate_size=1536, max_position=512,
)
TINY_TEST = TransformerConfig(
    vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, max_position=64, compute_dtype="float32",
)


def init_text_encoder(gen: torch.Generator, cfg: TransformerConfig
                      ) -> L.ParamTree:
    return init_transformer(gen, cfg)


def encode(params: L.ParamTree, cfg: TransformerConfig,
           input_ids: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """last_hidden_state (B, T, D) — the embedding the fusion model consumes
    (reference train.py:137 `.last_hidden_state`)."""
    return transformer_forward(params, cfg, input_ids,
                               attention_mask=attention_mask,
                               token_type_ids=token_type_ids)


def mean_pool(hidden: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean pooling (SBERT sentence embedding semantics)."""
    h = hidden.float()
    if attention_mask is None:
        return h.mean(dim=1)
    m = attention_mask[..., None].float()
    return (h * m).sum(1) / m.sum(1).clamp_min(1e-9)


def cls_pool(hidden: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0].float()


# -- HF weight conversion ------------------------------------------------------

def config_from_hf(config_json: Mapping) -> TransformerConfig:
    """The TransformerConfig of a HF BERT-family `config.json` (a dict):
    tools/convert_hf.py's fields (positions capped at 512), with HF's
    LayerNorm epsilon and token-type count."""
    c = config_json
    if c.get("hidden_act", "gelu") != "gelu":
        raise ValueError("the encoder computes GELU BERT-family stacks only")
    return TransformerConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position=min(c.get("max_position_embeddings", 512), 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        layer_norm_eps=c["layer_norm_eps"])


def load_hf_state_dict(state_dict: Mapping, cfg: TransformerConfig
                       ) -> L.ParamTree:
    """A HF BERT-family state dict (bert/minilm-style
    `encoder.layer.{i}.attention.self.{query,key,value}` names, torch or
    numpy values, no task prefix) as the port's encoder params. The
    position table is cut to cfg.max_position rows; the token-type table
    is read when the config has one."""
    get = functools.partial(L.hf_tensor, state_dict)
    tensors = {
        "embeddings.word": get("embeddings.word_embeddings.weight"),
        "embeddings.position": get("embeddings.position_embeddings.weight"
                                   )[:cfg.max_position],
        **L.hf_modules(state_dict, {"embeddings.ln": "embeddings.LayerNorm"})}
    if cfg.type_vocab_size:
        tensors["embeddings.token_type"] = get(
            "embeddings.token_type_embeddings.weight")
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}"
        tensors.update(L.hf_modules(state_dict, {
            f"layers.{i}.q": f"{pre}.attention.self.query",
            f"layers.{i}.k": f"{pre}.attention.self.key",
            f"layers.{i}.v": f"{pre}.attention.self.value",
            f"layers.{i}.attn_out": f"{pre}.attention.output.dense",
            f"layers.{i}.ln1": f"{pre}.attention.output.LayerNorm",
            f"layers.{i}.ffn_in": f"{pre}.intermediate.dense",
            f"layers.{i}.ffn_out": f"{pre}.output.dense",
            f"layers.{i}.ln2": f"{pre}.output.LayerNorm"}))
    params = init_text_encoder(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, tensors, "text_encoder")


def load_hf_mpnet_state_dict(state_dict: Mapping, cfg: TransformerConfig):
    raise NotImplementedError(
        "the MPNet loader arrives with the retrieval slice (ROADMAP A12)")


def load_hf_cross_encoder_state_dict(state_dict: Mapping,
                                     cfg: TransformerConfig):
    raise NotImplementedError(
        "the cross-encoder loader arrives with the retrieval slice "
        "(ROADMAP A12)")
