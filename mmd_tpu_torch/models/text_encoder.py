"""Frozen text encoders: the BERT-class claim/document encoder, the MPNet
retrieval bi-encoder and the MiniLM cross-encoder re-ranker (counterpart of
mmd_tpu/models/text_encoder.py), with their HF loaders.

Converted HF weights load by module name (layers.hf_modules): nn.Linear
keeps HF's (out, in) layout, so nothing is transposed."""

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
BI_ENCODER_BASE = TransformerConfig(         # multi-qa-mpnet-base-dot-v1
    vocab_size=30527, hidden_size=768, num_layers=12, num_heads=12,
    intermediate_size=3072, max_position=514, type_vocab_size=0,
    relative_bias_buckets=32, mpnet_positions=True, pad_token_id=1,
    layer_norm_eps=1e-5,                     # true mpnet arch: shared T5-style
)                                            # relative bias, RoBERTa positions
CROSS_ENCODER_MINI = TransformerConfig(      # ms-marco-MiniLM-L-6-v2 contract
    vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
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


# -- Cross-encoder re-ranker ---------------------------------------------------

def init_cross_encoder(gen: torch.Generator, cfg: TransformerConfig,
                       pooler: bool = False) -> L.ParamTree:
    """Backbone and a 1-wide scorer; `pooler` adds the dense + tanh of a
    converted HF cross-encoder (BertForSequenceClassification)."""
    p = {"backbone": init_transformer(gen, cfg),
         "scorer": L.linear_init(gen, cfg.hidden_size, 1)}
    if pooler:
        p["pooler"] = L.linear_init(gen, cfg.hidden_size, cfg.hidden_size)
    return L.ParamTree(p)


def cross_encoder_score(params: L.ParamTree, cfg: TransformerConfig,
                        input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        token_type_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B,) fp32 relevance score for [CLS] query [SEP] doc [SEP] pair
    inputs (re-rank contract of text2text_retrieval.py:69-95). Converted HF
    cross-encoders carry a pooler (dense+tanh on CLS) before the
    classifier; scratch models score raw CLS."""
    hidden = transformer_forward(params["backbone"], cfg, input_ids,
                                 attention_mask=attention_mask,
                                 token_type_ids=token_type_ids)
    pooled = cls_pool(hidden)
    if "pooler" in params:
        pooled = torch.tanh(L.linear(params["pooler"], pooled))
    return L.linear(params["scorer"], pooled)[:, 0]


# -- HF weight conversion ------------------------------------------------------

def config_from_hf(config_json: Mapping, cap_positions: bool = True
                   ) -> TransformerConfig:
    """The TransformerConfig of a HF BERT-family `config.json` (a dict):
    tools/convert_hf.py's fields, with HF's LayerNorm epsilon and
    token-type count. Positions are capped at 512 for a text encoder; the
    cross-encoder conversion keeps the whole table (cap_positions=False)."""
    c = config_json
    if c.get("hidden_act", "gelu") != "gelu":
        raise ValueError("the encoder computes GELU BERT-family stacks only")
    positions = c.get("max_position_embeddings", 512)
    return TransformerConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position=min(positions, 512) if cap_positions else positions,
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


def mpnet_config_from_hf(config_json: Mapping) -> TransformerConfig:
    """The TransformerConfig of a HF MPNet `config.json` (a dict), with the
    fields tools/convert_hf.py's bi-encoder conversion gives it: the whole
    position table, no token types, the shared relative bias and RoBERTa
    positions from the pad id."""
    c = config_json
    if c.get("hidden_act", "gelu") != "gelu":
        raise ValueError("the encoder computes GELU MPNet stacks only")
    return TransformerConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position=c["max_position_embeddings"], type_vocab_size=0,
        layer_norm_eps=c["layer_norm_eps"],
        relative_bias_buckets=c["relative_attention_num_buckets"],
        mpnet_positions=True, pad_token_id=c["pad_token_id"])


def load_hf_mpnet_state_dict(state_dict: Mapping, cfg: TransformerConfig
                             ) -> L.ParamTree:
    """A HF MPNetModel state dict (torch or numpy values, no task prefix)
    as the port's encoder params, the shared relative bias table included.
    Requires an mpnet-arch config (relative_bias_buckets, mpnet_positions,
    no token types) -- the reference's SBERT bi-encoder family
    (text2text_retrieval.py:21-22)."""
    if not (cfg.relative_bias_buckets and cfg.mpnet_positions
            and not cfg.type_vocab_size):
        raise ValueError("mpnet conversion needs the mpnet-arch "
                         "TransformerConfig flags")
    get = functools.partial(L.hf_tensor, state_dict)
    tensors = {
        "embeddings.word": get("embeddings.word_embeddings.weight"),
        "embeddings.position": get("embeddings.position_embeddings.weight"
                                   )[:cfg.max_position],
        "rel_bias": get("encoder.relative_attention_bias.weight"),
        **L.hf_modules(state_dict, {"embeddings.ln": "embeddings.LayerNorm"})}
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}"
        tensors.update(L.hf_modules(state_dict, {
            f"layers.{i}.q": f"{pre}.attention.attn.q",
            f"layers.{i}.k": f"{pre}.attention.attn.k",
            f"layers.{i}.v": f"{pre}.attention.attn.v",
            f"layers.{i}.attn_out": f"{pre}.attention.attn.o",
            f"layers.{i}.ln1": f"{pre}.attention.LayerNorm",
            f"layers.{i}.ffn_in": f"{pre}.intermediate.dense",
            f"layers.{i}.ffn_out": f"{pre}.output.dense",
            f"layers.{i}.ln2": f"{pre}.output.LayerNorm"}))
    params = init_text_encoder(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, tensors, "bi_encoder")


def load_hf_cross_encoder_state_dict(state_dict: Mapping,
                                     cfg: TransformerConfig) -> L.ParamTree:
    """A HF BertForSequenceClassification state dict (the ms-marco
    cross-encoder packaging, reference text2text_retrieval.py:24) as
    backbone ("bert." names), pooler and scorer ("classifier")."""
    bert = L.HFPrefixed(state_dict, "bert.")
    params = init_cross_encoder(torch.Generator().manual_seed(0), cfg,
                                pooler=True)
    tensors = {f"backbone.{k}": v
               for k, v in load_hf_state_dict(bert, cfg).state_dict().items()}
    tensors.update(L.hf_modules(state_dict, {
        "pooler": "bert.pooler.dense", "scorer": "classifier"}))
    return L.load_tensors(params, tensors, "cross_encoder")
