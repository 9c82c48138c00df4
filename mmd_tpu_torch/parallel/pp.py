"""Pipeline parallelism for the text encoders, GPipe-style, serving and
fine-tuning (counterpart of mmd_tpu/parallel/pp.py).

The encoder's layer stack splits into `pp` contiguous stages over a mesh
axis and the batch into M microbatches; activations hop stage to stage by
send and recv while different stages work on different microbatches. For
serving each stage rank holds only its num_layers/pp layers on its device
(`shard_stages`), as the JAX package's P(axis) does on the stacked layers.
Embeddings and the shared per-model tables (MPNet's (1, H, T, T) relative
bias, DeBERTa's LayerNormed relative embeddings and diagonal maps) are
replicated: every rank embeds, and only the layers are split.

The JAX schedule runs M + pp - 1 ticks on every stage and masks the bubble
ticks' output; eager PyTorch skips them: stage s receives microbatch j from
s - 1, runs its layers and sends it on, so every send has its recv and the
outputs are those of the unsplit stack. The last stage's microbatches then
reach every rank of the axis (a broadcast, where the JAX package sums
zeros from the other stages). Stages run #1 (BERT-class) or #10 (DeBERTa)
where the single-device encoder would. The within-microbatch batch shards
over "data" when it divides evenly (`_pp_batch_axis`), else it is
replicated; `local_rows=True` says the batch is this rank's rows already
(the Trainer's), and nothing splits or gathers it over "data". The result
is (B, T, D) on every rank.

Where autograd records, the schedule is one autograd Function
(`_Pipeline`) with the reverse pipeline as its backward, driven by its own
schedule so that the blocking hops come in the same order on every rank:
the last stage takes the output gradient of each microbatch (its own
copy: the work downstream is repeated on every model rank), each stage
differentiates its layers one microbatch at a time and sends the input
gradient back one stage, and stage 0's reaches the embeddings. Each stage
returns the gradients of its own layers and its part of the shared
tables'; the whole is their sum over the axis (training/trainer.py). With
cfg.remat each layer of a stage runs under torch.utils.checkpoint, as the
JAX stage scans wrap each layer in jax.checkpoint. Stages take #1/#2
(BERT-class) or #10/#11 (DeBERTa) where the unsplit fine-tuning step does.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmd_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, shard_rows
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.parallel import collectives as C


def _forward(stage, x_mb: torch.Tensor, km_mb: Optional[torch.Tensor],
             shared: list, mesh, axis: str, pp: int, m: int,
             record: Optional[list] = None) -> torch.Tensor:
    """The GPipe schedule's forward: `stage(h, km, *shared)` is this rank's
    layer-slice forward; -> the (M, b, T, D) outputs of the last stage, on
    every rank of the axis. `record` collects each microbatch's (input,
    output) where autograd records."""
    i = mesh.axis_index(axis)
    out = torch.empty_like(x_mb)
    for j in range(m):
        h = x_mb[j] if i == 0 else C.recv(x_mb[j], mesh, axis, i - 1)
        if record is not None:
            h = h.detach().requires_grad_()
        y = stage(h, km_mb[j] if km_mb is not None else None, *shared)
        if record is not None:
            record.append((h, y))
        if i < pp - 1:
            C.send(y.detach(), mesh, axis, i + 1)
        else:
            out[j] = y.detach()
    return C.broadcast(out, mesh, axis, pp - 1)


class _Pipeline(torch.autograd.Function):
    """The schedule for autograd: inputs (run, x_mb, *shared, *params),
    `run` the schedule's other arguments and the stage. The forward keeps
    each microbatch's graph; the backward runs the reverse pipeline, last
    microbatch first, and returns x_mb's gradient (stage 0's; zero
    elsewhere), the shared tables' and the stage params' (this stage's
    part of each)."""

    @staticmethod
    def forward(ctx, run, x_mb, *tensors):
        shared = [t.detach().requires_grad_(t.requires_grad)
                  for t in tensors[:run["n_shared"]]]
        record = []
        with torch.enable_grad():
            out = _forward(run["stage"], x_mb, run["km_mb"], shared,
                           run["mesh"], run["axis"], run["pp"], run["m"],
                           record)
        ctx.run, ctx.record, ctx.shared = run, record, shared
        ctx.params = tensors[run["n_shared"]:]
        return out

    @staticmethod
    def backward(ctx, g):
        run, shared, params = ctx.run, ctx.shared, ctx.params
        mesh, axis, pp = run["mesh"], run["axis"], run["pp"]
        i = mesh.axis_index(axis)
        wrt = [t for t in (*shared, *params) if t.requires_grad]
        sums = [None] * len(wrt)
        gx = torch.zeros_like(g)
        for j in reversed(range(run["m"])):
            h, y = ctx.record[j]
            gy = g[j] if i == pp - 1 else C.recv(y, mesh, axis, i + 1)
            got = torch.autograd.grad(y, [h, *wrt], gy, allow_unused=True)
            gh = got[0] if got[0] is not None else torch.zeros_like(h)
            if i > 0:
                C.send(gh, mesh, axis, i - 1)
            else:
                gx[j] = gh
            sums = [a if b is None else (b if a is None else a + b)
                    for a, b in zip(sums, got[1:])]
            ctx.record[j] = None
        by_id = {id(t): s for t, s in zip(wrt, sums)}
        return (None, gx, *(by_id.get(id(t)) for t in (*shared, *params)))


def _gpipe_schedule(stage, x_mb: torch.Tensor,
                    km_mb: Optional[torch.Tensor], mesh, axis: str, pp: int,
                    m: int, shared: tuple = (), params: list = ()
                    ) -> torch.Tensor:
    """Run the GPipe schedule (`_forward`); where autograd records and a
    gradient is wanted, as `_Pipeline` over x_mb, the shared tables and the
    stage's params."""
    tensors = [x_mb, *shared, *params]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return _forward(stage, x_mb, km_mb, list(shared), mesh, axis, pp, m)
    run = {"stage": stage, "km_mb": km_mb, "n_shared": len(shared),
           "mesh": mesh, "axis": axis, "pp": pp, "m": m}
    return _Pipeline.apply(run, x_mb, *shared, *params)


def _stage_params(layers: list) -> list:
    return [p for lp in layers for p in lp.parameters()]


def _split_microbatches(b: int, num_microbatches: Optional[int], pp: int,
                        n_layers: int) -> tuple[int, int]:
    m = num_microbatches or pp
    if n_layers % pp != 0:
        raise ValueError(f"num_layers={n_layers} must divide by "
                         f"pipeline stages {pp}")
    if b % m != 0:
        raise ValueError(f"batch {b} must divide by microbatches {m}")
    return m, b // m


def _pp_batch_axis(mesh, bm: int, local_rows: bool = False
                   ) -> Optional[str]:
    """Shard the within-microbatch batch dim over the data axis when it
    divides evenly, so PP composes with DP (each data rank pipelines its
    rows); replicated otherwise, and never split when the batch is the
    rank's rows already."""
    d = mesh.shape.get(DATA_AXIS, 1)
    return (DATA_AXIS if (d > 1 and bm % d == 0 and not local_rows)
            else None)


def stage_layers(mesh, n_layers: int, axis: str = MODEL_AXIS) -> range:
    """The layer indices this rank's stage runs."""
    pp = mesh.shape[axis]
    if n_layers % pp != 0:
        raise ValueError(f"num_layers={n_layers} must divide by "
                         f"pipeline stages {pp}")
    per = n_layers // pp
    s = mesh.axis_index(axis)
    return range(s * per, (s + 1) * per)


def shard_stages(params: torch.nn.Module, mesh, axis: str = MODEL_AXIS
                 ) -> torch.nn.Module:
    """A copy of an encoder param tree with this rank's stage on the mesh's
    device: the embeddings, the shared tables and its own layers; the other
    stages' layers on the host. params stay as they were."""
    params = L.shared_copy(params)
    layers = params["layers"]
    mine = set(stage_layers(mesh, len(layers), axis))
    for name, child in params.named_children():
        if name != "layers":
            child.to(mesh.device)
    for name, prm in list(params.named_parameters(recurse=False)):
        setattr(params, name, torch.nn.Parameter(
            prm.detach().to(mesh.device), requires_grad=prm.requires_grad))
    for j, layer in enumerate(layers):
        layer.to(mesh.device if j in mine else "cpu")
    return params


def _microbatched(x: torch.Tensor, m: int, bm: int, rows: slice
                  ) -> torch.Tensor:
    return x.reshape(m, bm, *x.shape[1:])[:, rows].contiguous()


def _finish(out: torch.Tensor, mesh, ba: Optional[str], b: int
            ) -> torch.Tensor:
    if ba is not None:
        out = C.gather_replicated(out, mesh, ba, dim=1)
    return out.reshape(b, *out.shape[2:])


def pipeline_encode(params, cfg, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None, *, mesh,
                    axis: str = MODEL_AXIS,
                    num_microbatches: Optional[int] = None,
                    token_type_ids: Optional[torch.Tensor] = None,
                    local_rows: bool = False) -> torch.Tensor:
    """last_hidden_state (B, T, D) == text_encoder.encode, with the layer
    stack pipeline-split over `axis`: the key-padding path (BERT/MiniLM)
    on the fused kernel where the unsplit stack takes it, and the MPNet
    relative-bias path (the replicated bias plus each microbatch's
    padding in the additive slot). local_rows: see the module
    docstring."""
    from mmd_tpu_torch.models.transformer import (
        attention_mask_from_ids, embed, encoder_layer, mpnet_position_bias)

    pp = mesh.shape[axis]
    b = input_ids.shape[0]
    m, bm = _split_microbatches(b, num_microbatches, pp, cfg.num_layers)
    x = embed(params["embeddings"], cfg, input_ids, token_type_ids)
    t = x.shape[1]
    ba = _pp_batch_axis(mesh, bm, local_rows)
    rows = shard_rows(mesh, bm, ba) if ba else slice(0, bm)
    x_mb = _microbatched(x, m, bm, rows)
    km_mb = (_microbatched(attention_mask, m, bm, rows)
             if attention_mask is not None else None)
    shared = ((mpnet_position_bias(params, cfg, t),)
              if cfg.relative_bias_buckets else ())
    layers = [params["layers"][j]
              for j in stage_layers(mesh, cfg.num_layers, axis)]

    def layer(lp, h, mask, kmask):
        return encoder_layer(lp, cfg, h, mask, key_mask=kmask)[0]

    def stage(h, km, bias=None):
        if bias is not None:
            # rel-bias layers take the additive-mask slot, as
            # transformer_forward routes them
            mask = bias if km is None else bias + attention_mask_from_ids(
                km, t)
            kmask = None
        else:
            mask, kmask = None, km
        return L.run_layers(layer, layers, h, mask, kmask, remat=cfg.remat)

    return _finish(_gpipe_schedule(stage, x_mb, km_mb, mesh, axis, pp, m,
                                   shared, _stage_params(layers)),
                   mesh, ba, b)


def pipeline_encode_deberta(params, cfg, input_ids: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None,
                            *, mesh, axis: str = MODEL_AXIS,
                            num_microbatches: Optional[int] = None,
                            local_rows: bool = False) -> torch.Tensor:
    """last_hidden_state (B, T, D) == deberta.deberta_encode, with the
    layer stack pipeline-split over `axis`. The LayerNormed relative
    embeddings and the diagonal maps are per model and replicate to every
    stage; the stages take #10 (and #11 in the backward) where
    `use_fused_attn` admits the geometry, as the unsplit encoder does.
    local_rows: see the module docstring."""
    from mmd_tpu_torch.models import deberta as D
    from mmd_tpu_torch.models import layers as L
    from mmd_tpu_torch.ops.deberta_attention import key_bytes

    dtype = L.dtype_of(cfg.compute_dtype)
    pp = mesh.shape[axis]
    b, t = input_ids.shape
    m, bm = _split_microbatches(b, num_microbatches, pp, cfg.num_layers)
    dev = input_ids.device
    c2p_map, p2c_map = (torch.as_tensor(mp, device=dev, dtype=torch.long)
                        for mp in D._diag_maps(t, cfg))
    fused = D.use_fused_attn(cfg, t, dev)
    x, rel_emb = D.deberta_embed(params, cfg, input_ids, attention_mask)
    ba = _pp_batch_axis(mesh, bm, local_rows)
    rows = shard_rows(mesh, bm, ba) if ba else slice(0, bm)
    x_mb = _microbatched(x, m, bm, rows)
    km_mb = None
    if attention_mask is not None:
        km = key_bytes(attention_mask) if fused else attention_mask
        km_mb = _microbatched(km, m, bm, rows)
    layers = [params["layers"][j]
              for j in stage_layers(mesh, cfg.num_layers, axis)]

    def layer(lp, h, rel_emb, km):
        return D.deberta_layer(lp, cfg, h, rel_emb, c2p_map, p2c_map, km,
                               dtype, fused)

    def stage(h, km, rel_emb):
        return L.run_layers(layer, layers, h, rel_emb, km, remat=cfg.remat)

    return _finish(_gpipe_schedule(stage, x_mb, km_mb, mesh, axis, pp, m,
                                   (rel_emb,), _stage_params(layers)),
                   mesh, ba, b)
