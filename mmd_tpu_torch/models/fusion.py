"""Evidence-conditioned multimodal fusion model, serving and training
forward (counterpart of mmd_tpu/models/fusion.py).

  1. MultiViewClaimRepresentation (reference model.py:6-121): project
     text/image claims to embed_dim, per-modality self-attention, then a
     second attention whose K/V source is `cfg.parity_cross_kv` (True: the
     same modality's K/V, the reference's quirk; False: the other
     modality's).
  2. CrossAttentionEvidenceConditioning (model.py:124-237): 4 evidence
     paths (claim-rep x evidence-modality), each with its own out-proj + 2
     LNs and a per-claim-modality shared MLP.
  3. ClassificationModule (model.py:240-347): per-path 2-layer heads over
     mean-pooled sequences, or one 3-layer head over the concat (factify),
     or a text-only 3-layer head (model.py:393-403).

Every attention goes through ops.attention: the CUDA flash kernels when
cfg.fused_attn, the explicit path otherwise. The training forward
(deterministic=False) drops attention weights, MLP activations and
classifier-head activations at cfg.dropout, each site with its own seed
drawn from the step's torch.Generator in the JAX package's call order
(`_Rngs`).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops.attention import multi_head_attention


class _Rngs:
    """One 63-bit seed per call from a torch.Generator (None-safe), the
    counterpart of the JAX package's stream of fold_in subkeys: sites are
    called in the same order, so site i of a step always gets draw i."""

    def __init__(self, generator: Optional[torch.Generator]):
        self._gen = generator

    def __call__(self) -> Optional[int]:
        if self._gen is None:
            return None
        return int(torch.randint(0, 2 ** 63 - 1, (), generator=self._gen))

# -----------------------------------------------------------------------------
# Init
# -----------------------------------------------------------------------------


def _init_representation(gen: torch.Generator, cfg: ModelConfig
                         ) -> L.ParamTree:
    d = cfg.embed_dim
    names_linear = {
        "text_proj": (cfg.text_input_dim, d),
        "image_proj": (cfg.image_input_dim, d),
        "text_WQ": (d, d), "text_WK": (d, d), "text_WV": (d, d),
        "image_WQ": (d, d), "image_WK": (d, d), "image_WV": (d, d),
        "text_self_attn_out": (d, d), "image_self_attn_out": (d, d),
        "text_cross_attn_out": (d, d), "image_cross_attn_out": (d, d),
    }
    p = {name: L.linear_init(gen, i, o)
         for name, (i, o) in names_linear.items()}
    for ln in ("text_self_ln1", "text_self_ln2", "image_self_ln1",
               "image_self_ln2", "text_cross_ln1", "text_cross_ln2",
               "image_cross_ln1", "image_cross_ln2"):
        p[ln] = L.layernorm_init(d)
    p["text_mlp"] = L.mlp_init(gen, d, cfg.mlp_ratio)
    p["image_mlp"] = L.mlp_init(gen, d, cfg.mlp_ratio)
    return L.ParamTree(p)


def _init_cross_attn(gen: torch.Generator, cfg: ModelConfig) -> L.ParamTree:
    d = cfg.embed_dim
    names_linear = {
        "text_WQ": (d, d), "image_WQ": (d, d),
        "text_evidence_key": (cfg.text_input_dim, d),
        "text_evidence_value": (cfg.text_input_dim, d),
        "image_evidence_key": (cfg.image_input_dim, d),
        "image_evidence_value": (cfg.image_input_dim, d),
        "text_text_out": (d, d), "text_image_out": (d, d),
        "image_text_out": (d, d), "image_image_out": (d, d),
    }
    p = {name: L.linear_init(gen, i, o)
         for name, (i, o) in names_linear.items()}
    for path in ("text_text", "text_image", "image_text", "image_image"):
        p[f"{path}_ln1"] = L.layernorm_init(d)
        p[f"{path}_ln2"] = L.layernorm_init(d)
    p["text_mlp"] = L.mlp_init(gen, d, cfg.mlp_ratio)
    p["image_mlp"] = L.mlp_init(gen, d, cfg.mlp_ratio)
    return L.ParamTree(p)


def _init_classifier(gen: torch.Generator, cfg: ModelConfig) -> L.ParamTree:
    d, h, c = cfg.embed_dim, cfg.hidden_dim, cfg.num_classes
    if cfg.text_only:
        return L.ParamTree(
            {"text_classifier": L.head_init(gen, [d, h * 2, h, c])})
    if cfg.factify:
        return L.ParamTree(
            {"unified_mlp": L.head_init(gen, [d * 4, h * 2, h, c])})
    return L.ParamTree({
        name: L.head_init(gen, [d, h, c])
        for name in ("mlp_text_given_text", "mlp_text_given_image",
                     "mlp_image_given_text", "mlp_image_given_image")})


def init_fusion_params(gen: torch.Generator, cfg: ModelConfig) -> L.ParamTree:
    return L.ParamTree({
        "representation": _init_representation(gen, cfg),
        "cross_attn": _init_cross_attn(gen, cfg),
        "classifier": _init_classifier(gen, cfg),
    })


# -----------------------------------------------------------------------------
# Forward
# -----------------------------------------------------------------------------

def _core(cfg: ModelConfig, q, k, v, rngs: _Rngs, deterministic):
    return multi_head_attention(q, k, v, cfg.num_heads,
                                dropout_rate=cfg.dropout,
                                dropout_seed=rngs(),
                                deterministic=deterministic,
                                fused=cfg.fused_attn)


def _representation(p, cfg: ModelConfig, X_t, X_i, rngs: _Rngs,
                    deterministic, dtype):
    """Multi-view claim representation. Returns (H_t, H_i) (either may be
    None)."""
    if X_t is not None:
        X_t = L.linear(p["text_proj"], X_t, dtype)
        tQ = L.linear(p["text_WQ"], X_t, dtype)
        tK = L.linear(p["text_WK"], X_t, dtype)
        tV = L.linear(p["text_WV"], X_t, dtype)
    if X_i is not None:
        X_i = L.linear(p["image_proj"], X_i, dtype)
        iQ = L.linear(p["image_WQ"], X_i, dtype)
        iK = L.linear(p["image_WK"], X_i, dtype)
        iV = L.linear(p["image_WV"], X_i, dtype)

    def attn(q, k, v, out):
        return L.linear(p[out], _core(cfg, q, k, v, rngs, deterministic),
                        dtype)

    def mlp(name, x):
        return L.mlp(p[name], x, cfg.dropout, rngs(), deterministic, dtype)

    if X_t is not None and X_i is None:
        H_t = X_t + attn(tQ, tK, tV, "text_self_attn_out")
        H_t = L.layernorm(p["text_self_ln1"], H_t)
        H_t = H_t + mlp("text_mlp", H_t)
        return L.layernorm(p["text_self_ln2"], H_t), None

    if X_i is not None and X_t is None:
        H_i = X_i + attn(iQ, iK, iV, "image_self_attn_out")
        H_i = L.layernorm(p["image_self_ln1"], H_i)
        H_i = H_i + mlp("image_mlp", H_i)
        return None, L.layernorm(p["image_self_ln2"], H_i)

    # Multimodal. The second attention's K/V source is the parity quirk.
    H_t = X_t + attn(tQ, tK, tV, "text_self_attn_out")
    H_t = L.layernorm(p["text_self_ln1"], H_t)
    H_i = X_i + attn(iQ, iK, iV, "image_self_attn_out")
    H_i = L.layernorm(p["image_self_ln1"], H_i)

    t_kv = (tK, tV) if cfg.parity_cross_kv else (iK, iV)
    i_kv = (iK, iV) if cfg.parity_cross_kv else (tK, tV)

    C_t = H_t + attn(H_t, *t_kv, "text_cross_attn_out")
    C_t = L.layernorm(p["text_cross_ln1"], C_t)
    C_t = C_t + mlp("text_mlp", C_t)
    C_t = L.layernorm(p["text_cross_ln2"], C_t)

    C_i = H_i + attn(H_i, *i_kv, "image_cross_attn_out")
    C_i = L.layernorm(p["image_cross_ln1"], C_i)
    C_i = C_i + mlp("image_mlp", C_i)
    C_i = L.layernorm(p["image_cross_ln2"], C_i)
    return C_t, C_i


def _evidence_conditioning(p, cfg: ModelConfig, H_t, H_i, E_t, E_i,
                           rngs: _Rngs, deterministic, dtype):
    """4-path evidence conditioning. Returns ((S_t_t, S_t_i), (S_i_t,
    S_i_i))."""
    def lin(name, x):
        return L.linear(p[name], x, dtype) if x is not None else None

    tQ, iQ = lin("text_WQ", H_t), lin("image_WQ", H_i)
    etK, etV = lin("text_evidence_key", E_t), lin("text_evidence_value", E_t)
    eiK, eiV = lin("image_evidence_key", E_i), lin("image_evidence_value", E_i)

    def path(H, Q, K, V, name, mlp_name):
        if H is None or K is None:
            return None
        ctx = _core(cfg, Q, K, V, rngs, deterministic)
        s = L.linear(p[f"{name}_out"], ctx, dtype)
        s = L.layernorm(p[f"{name}_ln1"], H + s)
        s = s + L.mlp(p[mlp_name], s, cfg.dropout, rngs(), deterministic,
                      dtype)
        return L.layernorm(p[f"{name}_ln2"], s)

    return (
        (path(H_t, tQ, etK, etV, "text_text", "text_mlp"),
         path(H_t, tQ, eiK, eiV, "text_image", "text_mlp")),
        (path(H_i, iQ, etK, etV, "image_text", "image_mlp"),
         path(H_i, iQ, eiK, eiV, "image_image", "image_mlp")),
    )


def _pool(x, dtype):
    return x.float().mean(dim=1).to(dtype)


def _classify(p, cfg: ModelConfig, S_t, S_i, rngs: _Rngs, deterministic,
              dtype):
    if cfg.factify:
        pooled = [_pool(s, dtype) for s in (*S_t, *S_i) if s is not None]
        logits = L.head_apply(p["unified_mlp"], torch.cat(pooled, dim=-1),
                              cfg.dropout, rngs(), deterministic, dtype)
        return logits.float(), None

    def head(name, s):
        if s is None:
            return None
        return L.head_apply(p[name], _pool(s, dtype), cfg.dropout, rngs(),
                            deterministic, dtype).float()

    (S_t_t, S_t_i), (S_i_t, S_i_i) = S_t, S_i
    return (
        (head("mlp_text_given_text", S_t_t), head("mlp_text_given_image", S_t_i)),
        (head("mlp_image_given_text", S_i_t), head("mlp_image_given_image", S_i_i)),
    )


def fusion_forward(params: L.ParamTree, cfg: ModelConfig,
                   X_t: Optional[torch.Tensor] = None,
                   X_i: Optional[torch.Tensor] = None,
                   E_t: Optional[torch.Tensor] = None,
                   E_i: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   deterministic: bool = True):
    """Full model forward. The training forward (deterministic=False) draws
    one seed per dropout site from `generator`.

    Returns, matching the reference's contract (model.py:426-468):
      text_only:  (logits (B, C), None)
      factify:    (logits (B, C), None)
      default:    ((y_t_t, y_t_i), (y_i_t, y_i_i)) each (B, C) or None
    """
    dtype = L.dtype_of(cfg.compute_dtype)
    rngs = _Rngs(generator)

    def cast(x):
        return None if x is None else x.to(dtype)

    X_t, X_i, E_t, E_i = cast(X_t), cast(X_i), cast(E_t), cast(E_i)

    if cfg.text_only:
        H_t, _ = _representation(params["representation"], cfg, X_t, None,
                                 rngs, deterministic, dtype)
        (S_t_t, _), _ = _evidence_conditioning(
            params["cross_attn"], cfg, H_t, None, E_t, None, rngs,
            deterministic, dtype)
        logits = L.head_apply(params["classifier"]["text_classifier"],
                              _pool(S_t_t, dtype), cfg.dropout, rngs(),
                              deterministic, dtype)
        return logits.float(), None

    H_t, H_i = _representation(params["representation"], cfg, X_t, X_i,
                               rngs, deterministic, dtype)
    S_t, S_i = _evidence_conditioning(params["cross_attn"], cfg, H_t, H_i,
                                      E_t, E_i, rngs, deterministic, dtype)
    return _classify(params["classifier"], cfg, S_t, S_i, rngs,
                     deterministic, dtype)
