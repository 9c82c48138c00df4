"""The fusion train step on one device (counterpart of
mmd_tpu/training/trainer.py).

Three steps, as in the JAX package:
  * `make_raw_step`: pre-embedded batches;
  * `make_encoding_raw_step`: raw batches (token ids and uint8 images,
    pipelines/raw_store.py); the frozen encoders run inside the step under
    torch.no_grad (the JAX package's stop_gradient), inside each micro
    step when accumulating;
  * `make_finetune_raw_step`: raw batches, and the encoders' params train
    with the fusion model's under one AdamW (`init_finetune_state`), with
    the JAX package's kernel gating (`finetune_encoder_configs`); over a
    mesh the text encoder can train sequence-, ring- or pipeline-parallel
    over "model" (`text_mode`).

The JAX package compiles one function per step: loss, grads, AdamW update.
Here the step runs eagerly: `fusion_forward(deterministic=False)` ->
`multipath_loss` (or `single_loss` in the factify / text-only modes) ->
`backward` -> `torch.optim.AdamW.step`, with the attention, dropout and
(bf16 with dropout) fused-MLP kernels on CUDA tensors (ops/attention.py,
ops/dropout.py, ops/mlp.py). The state is updated in place: params and the
optimizer's moments are the tensors the optimizer owns, and `step_fn`
returns the same TrainState with its step advanced.

Randomness: the JAX step draws its dropout keys from
fold_in(state.rng, step). The port derives the step's torch.Generator from
(seed, step) -- and from (seed, step, micro) for each micro-batch of an
accumulated step -- so a resumed run draws the same masks, and no step ever
touches the global RNG.

Over a mesh (core/mesh.py: a rank of a torch.distributed world a device)
the Trainer runs the JAX Trainer's `mesh`, `tensor_parallel`, `zero1` and
`zero3` (mmd_tpu/training/trainer.py:462-621): each rank takes its rows of
the global batch, the forward folds its dropout seeds by the rank's
indices and, under TP, runs on its Megatron slices (models/fusion.py),
and parallel/zero.ShardedAdamW means the gradients over "data" and steps
the rank's blocks of the state under parallel/tp.py's specs. The step's
loss and per-path losses are global means, its preds and labels the
global batch, on every rank. With `text_parallelism` ("sp", "sp_ring" or
"pp", fine-tuning only) the text encoder's forward and backward run split
over "model" (models/frozen.text_encode_parallel on the rank's rows,
parallel/sp.py, parallel/pp.py) while the fusion model and the image
encoder run whole on every model rank: the text leaves' gradients are
then each rank's part of the whole, which ShardedAdamW sums over "model"
(parallel/zero.Layout's `model_partial`) before it means over "data".
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.core.mesh import (DATA_AXIS, MODEL_AXIS, host_rows,
                                     make_mesh, shard_batch)
from mmd_tpu_torch.data.labels import (PATHS, paths_to_category_idx_torch,
                                       paths_to_simplified_torch)
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.deberta import DebertaConfig
from mmd_tpu_torch.models.frozen import (image_encode, text_encode,
                                         text_encode_parallel)
from mmd_tpu_torch.models.fusion import fusion_forward, init_fusion_params
from mmd_tpu_torch.models.swin import SwinConfig
from mmd_tpu_torch.ops.image_ops import TRAIN_TRANSFORM, normalize_on_device
from mmd_tpu_torch.parallel import collectives as C
from mmd_tpu_torch.parallel import tp as TP
from mmd_tpu_torch.parallel import zero as Z
from mmd_tpu_torch.training.losses import (cross_entropy_per_sample,
                                           multipath_loss, single_loss)

_MASK64 = 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass
class TrainState:
    """step, fusion params, the AdamW optimizer holding the moments, and the
    seed every step's dropout generator derives from. Over a mesh the
    params are the rank's blocks and the optimizer a
    parallel/zero.ShardedAdamW."""

    step: int
    params: L.ParamTree
    optimizer: torch.optim.Optimizer
    seed: int


def _mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit torch seed."""
    z = 0
    for w in words:
        z = ((z ^ (w & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def step_generator(seed: int, step: int, micro: Optional[int] = None
                   ) -> torch.Generator:
    """The CPU generator a step (or one micro-batch of it) draws its
    dropout seeds from."""
    words = (seed, step) if micro is None else (seed, step, micro + 1)
    return torch.Generator().manual_seed(_mix(*words))


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """AdamW with torch-default hyperparameters (reference train.py:356;
    the same decoupled decay as optax.adamw, trainer.py:34-42) over a
    module's parameters or a list of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return torch.optim.AdamW(params, lr=cfg.lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_state(cfg: TrainConfig, device="cuda",
               seed: Optional[int] = None) -> TrainState:
    """Step 0: fusion params from `seed` (cfg.seed by default) on `device`,
    which is cuda unless the caller asks for the CPU, and a fresh AdamW."""
    seed = cfg.seed if seed is None else seed
    params = init_fusion_params(torch.Generator().manual_seed(seed),
                                cfg.model).to(device)
    return TrainState(0, params, make_optimizer(cfg, params), seed)


def _loss_fn(params, mcfg: ModelConfig, batch: dict,
             generator: Optional[torch.Generator], deterministic=False,
             mesh=None):
    """(loss, aux): aux holds the detached loss, preds and labels, the
    per-path losses, and per-sample nll when deterministic (eval). Over a
    mesh all are the rank's rows' (see `_global_aux`)."""
    outputs = fusion_forward(
        params, mcfg,
        X_t=batch["claim_text_embeds"],
        X_i=batch.get("claim_image_embeds"),
        E_t=batch["doc_text_embeds"],
        E_i=batch.get("doc_image_embeds"),
        generator=generator, deterministic=deterministic, mesh=mesh,
    )
    labels = batch["labels"]
    if mcfg.factify or mcfg.text_only:
        # stores carry 4-path labels; derive the single target on device
        if labels.dim() == 2:
            labels = (paths_to_category_idx_torch(labels) if mcfg.factify
                      else paths_to_simplified_torch(labels))
        logits, _ = outputs
        loss = single_loss(logits, labels)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        aux = {"loss": loss.detach(), "preds": preds[:, None],
               "labels": labels[:, None].to(torch.int32)}
        if deterministic:   # eval: per-sample nll so padded rows can be masked
            aux["nll"] = cross_entropy_per_sample(logits, labels).detach()
        return loss, aux
    total, per_path = multipath_loss(outputs, labels)
    (y_t_t, y_t_i), (y_i_t, y_i_i) = outputs
    preds = torch.stack(
        [torch.argmax(y, dim=-1) for y in (y_t_t, y_t_i, y_i_t, y_i_i)],
        dim=1).to(torch.int32)
    aux = {"loss": total.detach(), "preds": preds,
           "labels": labels.to(torch.int32)}
    if deterministic:
        aux["nll"] = sum(
            cross_entropy_per_sample(y, labels[:, idx])
            for idx, y in enumerate((y_t_t, y_t_i, y_i_t, y_i_i))
            if y is not None).detach()
    for name in PATHS:
        if name in per_path:
            aux[f"{name}_loss"] = per_path[name].detach()
    return total, aux


def _zero_grads(params: torch.nn.Module) -> None:
    """Zero every param's .grad, allocating it where missing. A param the
    mode does not use (say the unimodal-only LayerNorms in the multimodal
    forward) then gets a zero gradient, as under jax.grad, and AdamW still
    applies its weight decay to it, as optax.adamw does; torch's AdamW
    would skip a param whose .grad is None."""
    for p in params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def _accum_grads(loss_fn: Callable, params: torch.nn.Module, batch: dict,
                 generators: list, accum: int) -> dict:
    """Micro-batched gradient accumulation: the batch splits into `accum`
    INTERLEAVED micro-batches (row r goes to micro r % accum, as in the JAX
    package), each micro's grads add into .grad, and the sum is divided by
    `accum` -- the full-batch mean gradient up to fp reassociation.
    Per-sample aux tensors concatenate micro after micro (paired preds and
    labels survive the reorder); scalar aux entries average."""
    auxes = []
    for i in range(accum):
        micro = {k: v[i::accum] for k, v in batch.items()}
        loss, aux = loss_fn(params, micro, generators[i])
        loss.backward()
        auxes.append(aux)
    with torch.no_grad():
        for p in params.parameters():
            if p.grad is not None:
                p.grad.div_(accum)

    def merge(xs):
        if xs[0].dim() >= 1:
            return torch.cat(xs, dim=0)
        return torch.stack(xs).mean()

    return {k: merge([a[k] for a in auxes]) for k in auxes[0]}


def _global_aux(aux: dict, mesh) -> dict:
    """A rank's aux over the whole batch: scalars (the losses) averaged
    over "data" in one all-reduce, per-sample tensors all-gathered in rank
    order."""
    scalars = [k for k, v in aux.items() if v.dim() == 0]
    out = {k: C.all_gather(v, mesh, DATA_AXIS) for k, v in aux.items()
           if v.dim() >= 1}
    if scalars:
        vals = torch.stack([aux[k].float() for k in scalars])
        vals = C.psum(vals, mesh, DATA_AXIS) / mesh.shape[DATA_AXIS]
        out.update({k: vals[i] for i, k in enumerate(scalars)})
    return {k: out[k] for k in aux}


def _make_step(cfg: TrainConfig, loss_fn: Callable, mesh=None
               ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """step_fn(state, batch) -> (state, aux): one AdamW step of
    loss_fn(params, batch, generator) -> (loss, aux). cfg.accum_steps > 1
    runs the step as that many micro-batches with accumulated grads and ONE
    optimizer update. After the call each param's .grad holds the step's
    gradient.

    Over a mesh the batch is the rank's rows and state.optimizer a
    ShardedAdamW: the loss is differentiated on the tree it gives
    (`working`), its step means the gradients over "data", and the aux is
    the whole batch's (`_global_aux`)."""
    accum = max(1, cfg.accum_steps)

    def step_fn(state: TrainState, batch: dict):
        params = (state.optimizer.working() if mesh is not None
                  else state.params)
        _zero_grads(params)
        if accum > 1:
            gens = [step_generator(state.seed, state.step, i)
                    for i in range(accum)]
            aux = _accum_grads(loss_fn, params, batch, gens, accum)
        else:
            loss, aux = loss_fn(params, batch,
                                step_generator(state.seed, state.step))
            loss.backward()
        state.optimizer.step()
        state.step += 1
        if mesh is not None:
            aux = _global_aux(aux, mesh)
        return state, aux

    return step_fn


def make_raw_step(cfg: TrainConfig, mesh=None
                  ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """step_fn(state, batch) -> (state, aux): one AdamW step on a batch of
    pre-embedded tensors on the params' device (see `_make_step`)."""
    mcfg = cfg.model

    def loss_fn(params, batch, generator):
        return _loss_fn(params, mcfg, batch, generator, mesh=mesh)

    return _make_step(cfg, loss_fn, mesh)


def _embed_raw(text_params, text_cfg, vit_params, vit_cfg, batch: dict,
               dtype: torch.dtype, text_fn=text_encode) -> dict:
    """A raw batch -> the fusion model's inputs: both texts through the text
    encoder (`text_fn`), both images (uint8, normalized on the device with
    the training transform) through the image encoder. A batch of an embed
    bank (pipelines/fused.py) carries the frozen image encoder's output as
    `claim_vis` / `doc_vis` instead of images: it is used as it is (the
    fusion model casts its inputs to the compute dtype at entry)."""
    def image(u8):
        return image_encode(vit_params, vit_cfg,
                            normalize_on_device(u8, TRAIN_TRANSFORM, dtype))

    if "claim_vis" in batch:
        vis_c, vis_d = batch["claim_vis"], batch["doc_vis"]
    else:
        vis_c, vis_d = image(batch["claim_image"]), image(batch["doc_image"])
    return {
        "claim_text_embeds": text_fn(text_params, text_cfg,
                                     batch["claim_ids"], batch["claim_mask"]),
        "doc_text_embeds": text_fn(text_params, text_cfg, batch["doc_ids"],
                                   batch["doc_mask"]),
        "claim_image_embeds": vis_c,
        "doc_image_embeds": vis_d,
        "labels": batch.get("labels"),       # none in a batch to predict
    }


def make_encoding_raw_step(cfg: TrainConfig, enc, mesh=None
                           ) -> Callable[[TrainState, dict],
                                         tuple[TrainState, dict]]:
    """step_fn(state, batch) -> (state, aux) on RAW batches: the frozen
    encoders of `enc` (a FrozenEncoders whose params lie on the step's
    device) run inside the step under torch.no_grad -- the JAX package's
    stop_gradient -- then the fusion loss and update. With accumulation the
    encoding happens inside each micro step, so the encoders' activations
    exist for one micro-batch at a time."""
    mcfg = cfg.model
    dtype = L.dtype_of(mcfg.compute_dtype)

    def loss_fn(params, batch, generator):
        with torch.no_grad():
            emb = _embed_raw(enc.text_params, enc.text_cfg, enc.vit_params,
                             enc.vit_cfg, batch, dtype)
        return _loss_fn(params, mcfg, emb, generator, mesh=mesh)

    return _make_step(cfg, loss_fn, mesh)


def finetune_encoder_configs(cfg: TrainConfig, text_cfg, vit_cfg):
    """The encoders' configs in a fine-tuning step, gated as the JAX
    package gates them (trainer.py:301-327): remat from cfg; DeBERTa keeps
    its kernels only with fused_train; Swin takes the explicit path unless
    fused_train; Swin's fused LayerNorm is off."""
    if cfg.remat:
        text_cfg = dataclasses.replace(text_cfg, remat=True)
        vit_cfg = dataclasses.replace(vit_cfg, remat=True)
    if (isinstance(text_cfg, DebertaConfig) and text_cfg.fused_attn
            and not text_cfg.fused_train):
        text_cfg = dataclasses.replace(text_cfg, fused_attn=False)
    if isinstance(vit_cfg, SwinConfig):
        if vit_cfg.fused_attn and not vit_cfg.fused_train:
            vit_cfg = dataclasses.replace(vit_cfg, fused_attn=False)
        if vit_cfg.fused_ln:
            vit_cfg = dataclasses.replace(vit_cfg, fused_ln=False)
    return text_cfg, vit_cfg


def init_finetune_state(cfg: TrainConfig, enc, device="cuda",
                        seed: Optional[int] = None) -> TrainState:
    """Step 0 of fine-tuning: params {"fusion", "text", "vit"} -- fresh
    fusion params from `seed` and COPIES of the encoders' params, so the
    caller's encoders stay as they were -- on `device`, under one AdamW."""
    seed = cfg.seed if seed is None else seed
    params = L.ParamTree({
        "fusion": init_fusion_params(torch.Generator().manual_seed(seed),
                                     cfg.model),
        "text": copy.deepcopy(enc.text_params),
        "vit": copy.deepcopy(enc.vit_params),
    }).to(device)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(0, params, make_optimizer(cfg, params), seed)


def make_finetune_raw_step(cfg: TrainConfig, enc, mesh=None,
                           text_mode: Optional[str] = None
                           ) -> Callable[[TrainState, dict],
                                         tuple[TrainState, dict]]:
    """End-to-end fine-tuning step on RAW batches: the text and image
    encoders run inside the step with gradients, their params in
    state.params next to the fusion model's (`init_finetune_state`), one
    AdamW over the joint tree; composes with accumulation and cfg.remat.
    text_mode ("sp" | "sp_ring" | "pp", with `mesh`): the text encoder's
    forward and backward run under that parallelism over the mesh's
    "model" axis, on the rank's rows (models/frozen.text_encode_parallel).
    `step_fn.joint_loss(params, batch, generator, deterministic=False)` is
    the loss, for the eval step."""
    mcfg = cfg.model
    dtype = L.dtype_of(mcfg.compute_dtype)
    text_cfg, vit_cfg = finetune_encoder_configs(cfg, enc.text_cfg,
                                                 enc.vit_cfg)
    text_fn = text_encode
    if text_mode is not None:
        if mesh is None:
            raise ValueError("text parallelism requires a mesh")

        def text_fn(p, c, ids, mask):
            return text_encode_parallel(p, c, ids, mask, mesh=mesh,
                                        mode=text_mode, local_rows=True)

    def joint_loss(params, batch, generator, deterministic=False):
        emb = _embed_raw(params["text"], text_cfg, params["vit"], vit_cfg,
                         batch, dtype, text_fn)
        return _loss_fn(params["fusion"], mcfg, emb, generator,
                        deterministic=deterministic, mesh=mesh)

    step_fn = _make_step(cfg, joint_loss, mesh)
    step_fn.joint_loss = joint_loss
    return step_fn


def _eval_step(loss: Callable, mesh=None, layout=None
               ) -> Callable[[torch.nn.Module, dict], dict]:
    """eval_fn(params, batch) -> loss(params, batch)'s aux without autograd;
    over a mesh the whole batch's, under ZeRO-3 (`layout`) with the params
    gathered on use."""
    def eval_fn(params, batch):
        with torch.no_grad():
            if layout is not None and layout.zero3:
                params = layout.gather(params)
            aux = loss(params, batch)
        return aux if mesh is None else _global_aux(aux, mesh)

    return eval_fn


def make_eval_step(cfg: TrainConfig, mesh=None, layout=None
                   ) -> Callable[[torch.nn.Module, dict], dict]:
    """eval_fn(params, batch) -> aux: loss and preds without updates
    (deterministic, no autograd). Over a mesh: the rank's rows in, the
    whole batch's aux out (see `_eval_step`)."""
    mcfg = cfg.model
    return _eval_step(lambda p, b: _loss_fn(p, mcfg, b, None,
                                            deterministic=True,
                                            mesh=mesh)[1], mesh, layout)


@dataclasses.dataclass
class Trainer:
    """Config, device or mesh, and the step functions for the train loop.

    With `encoders` (a FrozenEncoders) batches are RAW (token ids and uint8
    images from pipelines/raw_store.py): the frozen encoders, moved to the
    device, run inside the step; with `finetune` as well, they train with
    the fusion model. Otherwise batches are pre-embedded.

    `mesh` (core/mesh.Mesh) trains over the ranks of a torch.distributed
    world, each on its own device (the mesh's): data parallelism over
    "data", with `tensor_parallel` the Megatron split of the fusion model
    over "model" (pre-embedded and raw paths; the frozen encoders whole
    on every rank), with `zero1` the moments and with `zero3` the params
    and the moments sharded over "data" (every path, fine-tuning included,
    over the joint tree). zero1 or zero3 without a mesh trains on a mesh of
    this one device, where they change nothing. With `finetune` and
    `text_parallelism` ("sp", "sp_ring" or "pp") the text encoder's
    forward and backward run sequence-, ring- or pipeline-parallel over
    "model" (a model axis >= 2), the batch still split over "data"; it
    composes with zero1, zero3, accumulation and cfg.remat. The JAX
    Trainer's validations hold (mmd_tpu/training/trainer.py:501-541).

    `device` defaults to cuda and never falls back: without a card it
    raises; tests pass "cpu"."""

    cfg: TrainConfig
    device: Any = "cuda"
    encoders: Any = None
    tensor_parallel: bool = False
    zero1: bool = False
    zero3: bool = False
    finetune: bool = False
    text_parallelism: Optional[str] = None
    mesh: Any = None

    def __post_init__(self):
        if self.zero3 and (self.zero1 or self.tensor_parallel):
            raise ValueError("zero3 is exclusive with zero1/tensor_parallel")
        if (self.cfg.accum_steps > 1
                and self.cfg.batch_size % self.cfg.accum_steps != 0):
            raise ValueError(
                f"batch_size={self.cfg.batch_size} must divide by "
                f"accum_steps={self.cfg.accum_steps}")
        if self.finetune:
            if self.encoders is None:
                raise ValueError("finetune=True requires encoders")
            if self.tensor_parallel:
                raise ValueError(
                    "finetune composes with zero1/zero3, not TP (the TP "
                    "name rules cover the fusion tree only)")
        if self.text_parallelism is not None:
            if not self.finetune:
                raise ValueError(
                    "text_parallelism on the Trainer is the fine-tuning "
                    "surface (serving uses MisinformationPredictor)")
            if self.text_parallelism not in ("sp", "sp_ring", "pp"):
                raise ValueError(
                    f"unknown text_parallelism {self.text_parallelism!r}")
            model = 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]
            if model < 2:
                raise ValueError("text_parallelism needs a model axis >= 2")
        if self.mesh is None and (self.tensor_parallel or self.zero1
                                  or self.zero3):
            self.mesh = make_mesh(1, device=self.device)
        self._layout = None
        if self.mesh is not None:
            self._init_mesh()
        else:
            self.device = torch.device(self.device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("training on cuda, but torch sees no CUDA "
                                   "device; pass --device cpu to train on "
                                   "the CPU")
        mesh = self.mesh
        self.eval_step = make_eval_step(self.cfg, mesh, self._layout)
        if self.finetune:
            self.train_step = make_finetune_raw_step(
                self.cfg, self.encoders, mesh, self.text_parallelism)
            joint_loss = self.train_step.joint_loss
            self.eval_step = _eval_step(
                lambda p, b: joint_loss(p, b, None, deterministic=True)[1],
                mesh, self._layout)
        elif self.encoders is not None:
            for params in (self.encoders.text_params,
                           self.encoders.vit_params):
                params.to(self.device).requires_grad_(False)
            self.train_step = make_encoding_raw_step(self.cfg, self.encoders,
                                                     mesh)
        else:
            self.train_step = make_raw_step(self.cfg, mesh)

    def _init_mesh(self) -> None:
        mesh = self.mesh
        self.device = mesh.device
        dp, mp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        if self.tensor_parallel:
            if mp < 2:
                raise ValueError("tensor_parallel needs a model axis >= 2")
            TP.validate_tp_config(self.cfg.model, mesh)
            self.cfg = dataclasses.replace(
                self.cfg, model=dataclasses.replace(self.cfg.model,
                                                    tensor_parallel=True))
        local = self.cfg.batch_size // dp
        if self.cfg.batch_size % dp or local % max(1, self.cfg.accum_steps):
            raise ValueError(
                f"batch_size={self.cfg.batch_size} must divide over the "
                f"{dp} data ranks, and each rank's {local} rows by "
                f"accum_steps={self.cfg.accum_steps}")
        whole = self._whole(0)
        partial = ([n for n, _ in whole.named_parameters()
                    if n.startswith("text.")]
                   if self.text_parallelism else ())
        self._layout = Z.Layout(whole, mesh, Z.train_specs(
            whole, dp, self.tensor_parallel, self.zero1, self.zero3),
            model_partial=partial)

    def _whole(self, seed: int) -> L.ParamTree:
        """The whole trainable tree from `seed`, on the CPU (the
        encoders' params as they are)."""
        fusion = init_fusion_params(torch.Generator().manual_seed(seed),
                                    self.cfg.model)
        if not self.finetune:
            return fusion
        return L.ParamTree({"fusion": fusion,
                            "text": self.encoders.text_params,
                            "vit": self.encoders.vit_params})

    @property
    def is_writer(self) -> bool:
        """Whether this process writes logs, metrics and checkpoints (rank
        0 of the mesh; the one process without one)."""
        return self.mesh is None or self.mesh.rank == 0

    def init(self, seed: Optional[int] = None) -> TrainState:
        """Step 0: the whole state from the seed, as the JAX package builds
        it, then, over a mesh, the rank's blocks of it."""
        if self.mesh is None:
            if self.finetune:
                return init_finetune_state(self.cfg, self.encoders,
                                           self.device, seed)
            return init_state(self.cfg, self.device, seed)
        seed = self.cfg.seed if seed is None else seed
        params = self._layout.shard(self._whole(seed))
        for p in params.parameters():
            p.requires_grad_(True)
        cfg = self.cfg
        return TrainState(0, params, Z.ShardedAdamW(
            params, self._layout, lambda ps: make_optimizer(cfg, ps)), seed)

    def host_rows(self, batch: dict) -> dict:
        """This rank's rows of a host batch (the batch itself without a
        mesh), for a stream that copies them to the device itself."""
        if self.mesh is None:
            return batch
        return host_rows(batch, self.mesh)

    def shard_batch(self, batch: dict) -> dict:
        """Host numpy batch -> this rank's rows as tensors on the device (a
        copy: no aliasing of the caller's arrays)."""
        if self.mesh is not None:
            return shard_batch(batch, self.mesh)
        return {k: torch.tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- the single-device layout (checkpoints, best_model.pt) -------------
    # Over a mesh each of these is a collective: every rank calls it.

    def whole_params(self, state: TrainState) -> torch.nn.Module:
        """The single-device params of `state` (over a mesh gathered from
        the ranks' blocks; leaves kept whole are shared, not copied)."""
        if self._layout is None:
            return state.params
        return self._layout.gather(state.params)

    def load_params(self, state: TrainState, params: dict) -> None:
        """Load a single-device params state dict into `state` (over a mesh
        the rank keeps its blocks of it)."""
        if self._layout is None:
            state.params.load_state_dict(params)
        else:
            self._layout.load(state.params, params)

    def state_dict(self, state: TrainState) -> dict:
        """`state` as one device holds it: step, params, the AdamW state
        (as torch.optim.AdamW over the whole params gives it) and seed."""
        return {"step": state.step,
                "params": self.whole_params(state).state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "seed": state.seed}

    def load_state_dict(self, state: TrainState, ckpt: dict) -> TrainState:
        """Load a `state_dict` (saved under any mesh, or none) into
        `state`."""
        self.load_params(state, ckpt["params"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
        return state
