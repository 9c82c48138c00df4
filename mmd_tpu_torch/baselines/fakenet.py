"""FakeNet (Pre-CoFactv2, AAAI-23 Factify-2 winner) as a PyTorch baseline
(counterpart of mmd_tpu/baselines/fakenet.py).

Re-derives the vendored baseline's architecture (reference
src/baselines/Pre-CoFactv2/model.py:15-235, layers.py:26-96): four
Linear+ReLU embedders, a 16-way grid of cross-attention features built from
SIX shared post-LN attention modules + FFNs (module reuse preserved exactly,
including the crossed pos_ffn pairing at model.py:172-186 where the
image->text attention output goes through the text->image FFN and vice
versa), mean-pool, 16*hidden concat -> fusion -> concat with the 32-d OCR
add_features embedding -> 5-way classifier.

Attention is the baseline's own post-LN variant (residual+LN INSIDE the
block, bias-free projections, temperature sqrt(d_k), LN eps 1e-6, exact
GELU in the FFN) and runs through ops.attention.multi_head_attention with
fused=True: on CUDA tensors the flash kernels #1 and #2, which take the
CLI's 2 heads of dh 128. Params are the JAX tree name for name
(`bridge.fakenet_from_jax` loads one).

Dropout: every site takes its own seed, split from the one integer seed of
the call (`ops.dropout.split_seed`) in the JAX package's call order -- the
attention weights, the attention block's output, the FFN's output, block by
block. The JAX package folds a step key instead, so the masks differ from
JAX's by design; at dropout 0 (or deterministic) the two agree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass
class FakeNetConfig:
    text_dim: int = 1024      # deberta-large (baseline config.yaml)
    image_dim: int = 1024
    hidden_dim: int = 256
    head: int = 2
    dropout: float = 0.1
    add_feature_dim: int = 32
    num_classes: int = 5
    compute_dtype: str = "bfloat16"


FAKENET_TEST = FakeNetConfig(text_dim=16, image_dim=24, hidden_dim=32,
                             head=2, compute_dtype="float32")

ATTN_NAMES = (
    "claim_document_text", "claim_document_image",
    "text_image", "image_text",
    "claim_document_text_image", "claim_document_image_text",
)

# The twelve blocks in call order: (attention module, FFN module, query
# input, key/value input) over the embedded claim text (ct) / image (ci)
# and document text (dt) / image (di).
BLOCKS = (
    # claim-document attentions (shared modules, both directions)
    ("claim_document_text", "claim_document_text", "ct", "dt"),
    ("claim_document_text", "claim_document_text", "dt", "ct"),
    ("claim_document_image", "claim_document_image", "ci", "di"),
    ("claim_document_image", "claim_document_image", "di", "ci"),
    # text-image co-attentions (text_image / image_text modules, 3 uses each)
    ("text_image", "text_image", "ct", "ci"),
    ("image_text", "image_text", "ci", "ct"),
    ("text_image", "text_image", "dt", "di"),
    ("image_text", "image_text", "di", "dt"),
    ("text_image", "text_image", "ct", "di"),
    ("image_text", "image_text", "ci", "dt"),
    # crossed ffn quirk (reference model.py:172-186)
    ("claim_document_image_text", "claim_document_text_image", "di", "ct"),
    ("claim_document_text_image", "claim_document_image_text", "dt", "ci"),
)
SEEDS_PER_BLOCK = 3       # attention weights, attention output, FFN output


def _attn_init(gen: torch.Generator, d: int) -> L.ParamTree:
    return L.ParamTree({
        "w_qs": L.linear_init(gen, d, d, bias=False),
        "w_ks": L.linear_init(gen, d, d, bias=False),
        "w_vs": L.linear_init(gen, d, d, bias=False),
        "fc": L.linear_init(gen, d, d, bias=False),
        "ln": L.layernorm_init(d)})


def _ffn_init(gen: torch.Generator, d: int) -> L.ParamTree:
    return L.ParamTree({"w1": L.linear_init(gen, d, d * 2),
                        "w2": L.linear_init(gen, d * 2, d),
                        "ln": L.layernorm_init(d)})


def init_fakenet(gen: torch.Generator, cfg: FakeNetConfig) -> L.ParamTree:
    """Xavier-uniform weights, zero biases, unit LayerNorms: the JAX init's
    distributions (not its draws)."""
    d = cfg.hidden_dim
    p: dict = {
        "text_embedding": L.linear_init(gen, cfg.text_dim, d),
        "document_text_embedding": L.linear_init(gen, cfg.text_dim, d),
        "image_embedding": L.linear_init(gen, cfg.image_dim, d),
        "document_image_embedding": L.linear_init(gen, cfg.image_dim, d),
    }
    for name in ATTN_NAMES:
        p[f"{name}_attention"] = _attn_init(gen, d)
        p[f"{name}_pos_ffn"] = _ffn_init(gen, d)
    p["attention_fusion"] = L.linear_init(gen, d * 16, d)
    p["feature_embedding"] = L.linear_init(gen, cfg.add_feature_dim, 16)
    p["classifier_fc1"] = L.linear_init(gen, 16 + d, 128)
    p["classifier_fc2"] = L.linear_init(gen, 128, cfg.num_classes)
    return L.ParamTree(p)


def _attn(p, cfg: FakeNetConfig, q, kv, seeds, deterministic, dtype):
    """Post-LN block: LN(q + dropout(fc(attn(Wq q, Wk kv, Wv kv))))."""
    ctx = multi_head_attention(
        L.linear(p["w_qs"], q, dtype), L.linear(p["w_ks"], kv, dtype),
        L.linear(p["w_vs"], kv, dtype), cfg.head, dropout_rate=cfg.dropout,
        dropout_seed=seeds[0], deterministic=deterministic, fused=True)
    out = L.dropout(L.linear(p["fc"], ctx, dtype), cfg.dropout, seeds[1],
                    deterministic)
    return L.layernorm(p["ln"], q + out, eps=1e-6)


def _ffn(p, cfg: FakeNetConfig, x, seed, deterministic, dtype):
    h = L.linear(p["w2"], F.gelu(L.linear(p["w1"], x, dtype)), dtype)
    h = L.dropout(h, cfg.dropout, seed, deterministic)
    return L.layernorm(p["ln"], x + h, eps=1e-6)


def _pool(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.float().mean(dim=1).to(dtype)


def fakenet_forward(params: L.ParamTree, cfg: FakeNetConfig,
                    claim_text, claim_image, document_text, document_image,
                    add_feature, seed: Optional[int] = None,
                    deterministic: bool = True):
    """-> (logits (B, 5) fp32, concat_embeddings (B, 16 + hidden)).

    Inputs are (B, L, text_dim) / (B, L, image_dim) token embeddings and a
    (B, add_feature_dim) feature row. `seed` feeds every dropout site when
    not deterministic."""
    dtype = L.dtype_of(cfg.compute_dtype)
    n_sites = SEEDS_PER_BLOCK * len(BLOCKS)
    seeds = (D.split_seed(int(seed), n_sites) if seed is not None
             else [None] * n_sites)

    def emb(name, x):
        return torch.relu(L.linear(params[name], x.to(dtype), dtype))

    x = {"ct": emb("text_embedding", claim_text),
         "ci": emb("image_embedding", claim_image),
         "dt": emb("document_text_embedding", document_text),
         "di": emb("document_image_embedding", document_image)}
    pooled = [_pool(x[k], dtype) for k in ("ct", "ci", "dt", "di")]
    for i, (attn_name, ffn_name, q, kv) in enumerate(BLOCKS):
        s = seeds[SEEDS_PER_BLOCK * i:SEEDS_PER_BLOCK * (i + 1)]
        a = _attn(params[f"{attn_name}_attention"], cfg, x[q], x[kv], s,
                  deterministic, dtype)
        y = _ffn(params[f"{ffn_name}_pos_ffn"], cfg, a, s[2], deterministic,
                 dtype)
        pooled.append(_pool(y, dtype))
    concat = torch.cat(pooled, dim=-1)

    fused = torch.relu(L.linear(params["attention_fusion"], concat, dtype))
    feat = torch.relu(L.linear(params["feature_embedding"],
                               add_feature.to(dtype), dtype))
    concat_emb = torch.cat([fused, feat], dim=-1)
    h = torch.relu(L.linear(params["classifier_fc1"], concat_emb, dtype))
    logits = L.linear(params["classifier_fc2"], h, torch.float32)
    return logits.float(), concat_emb
