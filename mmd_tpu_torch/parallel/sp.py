"""Sequence (context) parallelism for the text encoders, serving and
fine-tuning (counterpart of mmd_tpu/parallel/sp.py).

Activations shard along T over the `sp` ranks of a mesh axis, so the
per-token work -- projections, residuals, LayerNorms, the FFN -- runs on
T/sp tokens a rank with replicated weights, and only attention talks.
Query rows of a non-causal attention are independent: each rank keeps its
local Q rows and all-gathers the K/V blocks over the axis, once a layer,
after which the flash kernel (#1) runs on the rank's card with Tq = T/sp
against Tk = T, as the JAX package's shard_map runs its Pallas kernel
device-locally. The MPNet relative-position bias is replicated and each
rank slices its own query rows onto the explicit path; key-padding masks
are replicated (they describe keys, which every rank sees in full).
`ring=True` swaps the all-gather for ring attention: the K/V blocks hop
the ring under an online softmax, so a rank holds one block at a time.

The batch shards over the mesh's "data" axis when it divides evenly
(`_batch_axis`), else every data rank runs it whole, as for a ragged
serving batch; `local_rows=True` says the batch is this rank's rows
already (the Trainer's), and nothing splits or gathers it over "data".
The result is (B, T, D) on every rank, as the JAX package's global array:
that costs one final gather over the axis (and one over "data" when the
batch was sharded).

Gradients go through as through the JAX package's shard_map: the K/V
gather's backward reduce-scatters (collectives.all_gather_grad), the
ring's ppermute sends the gradient back along the inverted pairs, and the
final gather hands each rank its own block of the output gradient
(collectives.gather_replicated: the work downstream is repeated on every
model rank). Every text param's gradient is then this rank's part of the
whole, to be summed over the axis (training/trainer.py). With cfg.remat
each layer runs under torch.utils.checkpoint, as the JAX bodies wrap each
layer in jax.checkpoint; its collectives then run again in the backward,
in the same order on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mmd_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, shard_rows
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops.attention import (
    _merge_heads, _split_heads, explicit_attention, multi_head_attention,
)
from mmd_tpu_torch.parallel import collectives as C


def _batch_axis(mesh, b: int, local_rows: bool = False) -> Optional[str]:
    """Shard the batch over the mesh's data axis when it divides evenly, so
    SP composes with DP (each data rank runs the sequence-parallel schedule
    on its rows); replicated for ragged serving batches, and never split
    when it is the rank's rows already."""
    d = mesh.shape.get(DATA_AXIS, 1)
    return (DATA_AXIS if (d > 1 and b % d == 0 and not local_rows)
            else None)


def _gather_sequence(h_loc: torch.Tensor, mesh, axis: str,
                    ba: Optional[str]) -> torch.Tensor:
    """(B_loc, T/sp, D) blocks -> (B, T, D) on every rank."""
    h = C.gather_replicated(h_loc, mesh, axis, dim=1)
    return (C.gather_replicated(h, mesh, ba, dim=0) if ba is not None
            else h)



def _ring_attention(q, k_loc, v_loc, num_heads: int, mesh, axis: str,
                    sp: int, tl: int, i: int, km_full, bias_loc):
    """Blockwise ring attention: each rank keeps its local Q rows and
    rotates the K/V blocks around the ring (ppermute), folding each
    arriving block into a running softmax (max, denominator, output in
    fp32). km_full: optional (B, T) {0,1} key mask -- the arriving block's
    absolute origin is (i - step) mod sp, so its slice is taken locally;
    bias_loc: optional (B|1, h, tl, T) additive bias of the local rows.
    Same math as softmax(QK^T / sqrt(dh) + bias) V up to fp
    reassociation."""
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k_loc, v_loc))
    b, h, _, dh = qh.shape
    scale = 1.0 / math.sqrt(dh)
    qf = qh.float()
    m = torch.full((b, h, tl, 1), -math.inf, device=q.device)
    lsum = torch.zeros((b, h, tl, 1), device=q.device)
    o = torch.zeros((b, h, tl, dh), device=q.device)
    perm = [(s, (s + 1) % sp) for s in range(sp)]
    for step in range(sp):
        # the block arriving at rank i on this step began at rank i - step
        src = (i - step) % sp
        cols = slice(src * tl, (src + 1) * tl)
        s_blk = (qf @ kh.float().transpose(-1, -2)) * scale
        if bias_loc is not None:
            s_blk = s_blk + bias_loc[..., cols]
        if km_full is not None:
            s_blk = s_blk + (1.0 - km_full[:, None, None, cols]) * -1e9
        m_new = torch.maximum(m, s_blk.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(vh.dtype).float() @ vh.float()
        m = m_new
        if step < sp - 1:
            kh = C.ppermute_grad(kh, mesh, axis, perm)
            vh = C.ppermute_grad(vh, mesh, axis, perm)
    return _merge_heads(o / lsum).to(q.dtype)


def sequence_parallel_encode(params, cfg, input_ids: torch.Tensor,
                             attention_mask: Optional[torch.Tensor] = None,
                             *, mesh, axis: str = MODEL_AXIS,
                             token_type_ids: Optional[torch.Tensor] = None,
                             ring: bool = False, local_rows: bool = False
                             ) -> torch.Tensor:
    """last_hidden_state (B, T, D) == text_encoder.encode, with the
    activations sequence-sharded over `axis` (weights replicated). ring=True
    swaps the per-layer K/V all-gather for ring attention; local_rows: see
    the module docstring."""
    from mmd_tpu_torch.models.transformer import embed, mpnet_position_bias

    if cfg.pre_ln or cfg.is_decoder:
        raise NotImplementedError(
            "sequence_parallel_encode serves the post-LN encoder stacks")
    sp = mesh.shape[axis]
    b, t = input_ids.shape
    if t % sp != 0:
        raise ValueError(f"seq len {t} must divide by sp ranks {sp}")
    tl = t // sp
    dtype = L.dtype_of(cfg.compute_dtype)
    eps = cfg.layer_norm_eps

    x = embed(params["embeddings"], cfg, input_ids, token_type_ids)
    ba = _batch_axis(mesh, b, local_rows)
    rows = shard_rows(mesh, b, ba) if ba else slice(0, b)
    i = mesh.axis_index(axis)
    h = x[rows, i * tl:(i + 1) * tl].contiguous()
    km = (attention_mask[rows].float() if attention_mask is not None
          else None)
    mask_loc = None
    if cfg.relative_bias_buckets:
        # this rank's query rows of the shared (1, H, T, T) bias, plus the
        # padding: the additive path, as in the unsplit rel-bias stack
        mask_loc = mpnet_position_bias(params, cfg, t)[:, :, i * tl:
                                                       (i + 1) * tl]
        if km is not None:
            mask_loc = mask_loc + (1.0 - km[:, None, None, :]) * -1e9

    def layer(p, h, km, mask_loc):
        q = L.linear(p["q"], h, dtype)
        k = L.linear(p["k"], h, dtype)
        v = L.linear(p["v"], h, dtype)
        if ring:
            # the padding folds into mask_loc on the bias path; otherwise
            # the replicated key mask is sliced per arriving block
            ctx = _ring_attention(q, k, v, cfg.num_heads, mesh, axis, sp, tl,
                                  i, None if mask_loc is not None else km,
                                  mask_loc)
        else:
            k_full = C.all_gather_grad(k, mesh, axis, dim=1)
            v_full = C.all_gather_grad(v, mesh, axis, dim=1)
            if mask_loc is not None:
                ctx = explicit_attention(q, k_full, v_full, cfg.num_heads,
                                         mask_loc)
            else:
                ctx = multi_head_attention(q, k_full, v_full, cfg.num_heads,
                                           fused=cfg.fused_attn, key_mask=km)
        h = L.layernorm(p["ln1"], h + L.linear(p["attn_out"], ctx, dtype),
                        eps)
        f = torch.nn.functional.gelu(L.linear(p["ffn_in"], h, dtype))
        return L.layernorm(p["ln2"], h + L.linear(p["ffn_out"], f, dtype),
                           eps)

    h = L.run_layers(layer, params["layers"], h, km, mask_loc,
                     remat=cfg.remat)
    return _gather_sequence(h, mesh, axis, ba)


def sequence_parallel_encode_deberta(params, cfg, input_ids: torch.Tensor,
                                     attention_mask: Optional[torch.Tensor]
                                     = None, *, mesh, axis: str = MODEL_AXIS,
                                     ring: bool = False,
                                     local_rows: bool = False
                                     ) -> torch.Tensor:
    """last_hidden_state (B, T, D) == deberta.deberta_encode, with the
    activations sequence-sharded over `axis`: local Q rows against the
    all-gathered K/V, the diagonal selections rebuilt from each rank's
    absolute row offset (deberta._disentangled_attention_sp); ring=True
    rotates the K/V blocks under an online softmax instead
    (deberta._disentangled_attention_ring). The shared relative-position
    table and the key mask are replicated. Both take the explicit path,
    as in the JAX package. local_rows: see the module docstring."""
    from mmd_tpu_torch.models import deberta as D

    sp = mesh.shape[axis]
    b, t = input_ids.shape
    if t % sp != 0:
        raise ValueError(f"seq len {t} must divide by sp ranks {sp}")
    tl = t // sp
    dtype = L.dtype_of(cfg.compute_dtype)
    dev = input_ids.device
    c2p_map, p2c_map = (torch.as_tensor(m, device=dev, dtype=torch.long)
                        for m in D._diag_maps(t, cfg))
    x, rel_emb = D.deberta_embed(params, cfg, input_ids, attention_mask)
    ba = _batch_axis(mesh, b, local_rows)
    rows = shard_rows(mesh, b, ba) if ba else slice(0, b)
    rank = mesh.axis_index(axis)
    h = x[rows, rank * tl:(rank + 1) * tl].contiguous()
    km = (attention_mask[rows].float() if attention_mask is not None
          else None)

    def layer(p, h, rel_emb, km):
        return D.deberta_layer_sp(p, cfg, h, rel_emb, c2p_map, p2c_map, km,
                                  dtype, mesh, axis, t, rank * tl, sp=sp,
                                  rank=rank, ring=ring)

    h = L.run_layers(layer, params["layers"], h, rel_emb, km,
                     remat=cfg.remat)
    return _gather_sequence(h, mesh, axis, ba)
