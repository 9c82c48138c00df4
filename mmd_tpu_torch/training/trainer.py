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
    the JAX package's kernel gating (`finetune_encoder_configs`).

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

The multi-device variants (zero1, zero3, tensor_parallel,
text_parallelism) raise: ROADMAP A16.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.labels import (PATHS, paths_to_category_idx_torch,
                                       paths_to_simplified_torch)
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.deberta import DebertaConfig
from mmd_tpu_torch.models.frozen import image_encode, text_encode
from mmd_tpu_torch.models.fusion import fusion_forward, init_fusion_params
from mmd_tpu_torch.models.swin import SwinConfig
from mmd_tpu_torch.ops.image_ops import TRAIN_TRANSFORM, normalize_on_device
from mmd_tpu_torch.training.losses import (cross_entropy_per_sample,
                                           multipath_loss, single_loss)

_MASK64 = 0xFFFFFFFFFFFFFFFF


@dataclasses.dataclass
class TrainState:
    """step, fusion params, the AdamW optimizer holding the moments, and the
    seed every step's dropout generator derives from."""

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


def make_optimizer(cfg: TrainConfig, params: torch.nn.Module
                   ) -> torch.optim.AdamW:
    """AdamW with torch-default hyperparameters (reference train.py:356;
    the same decoupled decay as optax.adamw, trainer.py:34-42)."""
    return torch.optim.AdamW(params.parameters(), lr=cfg.lr,
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
             generator: Optional[torch.Generator], deterministic=False):
    """(loss, aux): aux holds the detached loss, preds and labels, the
    per-path losses, and per-sample nll when deterministic (eval)."""
    outputs = fusion_forward(
        params, mcfg,
        X_t=batch["claim_text_embeds"],
        X_i=batch.get("claim_image_embeds"),
        E_t=batch["doc_text_embeds"],
        E_i=batch.get("doc_image_embeds"),
        generator=generator, deterministic=deterministic,
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


def _make_step(cfg: TrainConfig, loss_fn: Callable
               ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """step_fn(state, batch) -> (state, aux): one AdamW step of
    loss_fn(params, batch, generator) -> (loss, aux). cfg.accum_steps > 1
    runs the step as that many micro-batches with accumulated grads and ONE
    optimizer update. After the call each param's .grad holds the step's
    gradient."""
    accum = max(1, cfg.accum_steps)

    def step_fn(state: TrainState, batch: dict):
        _zero_grads(state.params)
        if accum > 1:
            gens = [step_generator(state.seed, state.step, i)
                    for i in range(accum)]
            aux = _accum_grads(loss_fn, state.params, batch, gens, accum)
        else:
            loss, aux = loss_fn(state.params, batch,
                                step_generator(state.seed, state.step))
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, aux

    return step_fn


def make_raw_step(cfg: TrainConfig) -> Callable[[TrainState, dict],
                                                tuple[TrainState, dict]]:
    """step_fn(state, batch) -> (state, aux): one AdamW step on a batch of
    pre-embedded tensors on the params' device (see `_make_step`)."""
    mcfg = cfg.model

    def loss_fn(params, batch, generator):
        return _loss_fn(params, mcfg, batch, generator)

    return _make_step(cfg, loss_fn)


def _embed_raw(text_params, text_cfg, vit_params, vit_cfg, batch: dict,
               dtype: torch.dtype) -> dict:
    """A raw batch -> the fusion model's inputs: both texts through the text
    encoder, both images (uint8, normalized on the device with the training
    transform) through the image encoder."""
    def image(u8):
        return image_encode(vit_params, vit_cfg,
                            normalize_on_device(u8, TRAIN_TRANSFORM, dtype))

    return {
        "claim_text_embeds": text_encode(text_params, text_cfg,
                                         batch["claim_ids"],
                                         batch["claim_mask"]),
        "doc_text_embeds": text_encode(text_params, text_cfg,
                                       batch["doc_ids"], batch["doc_mask"]),
        "claim_image_embeds": image(batch["claim_image"]),
        "doc_image_embeds": image(batch["doc_image"]),
        "labels": batch["labels"],
    }


def make_encoding_raw_step(cfg: TrainConfig, enc
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
        return _loss_fn(params, mcfg, emb, generator)

    return _make_step(cfg, loss_fn)


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


def make_finetune_raw_step(cfg: TrainConfig, enc
                           ) -> Callable[[TrainState, dict],
                                         tuple[TrainState, dict]]:
    """End-to-end fine-tuning step on RAW batches: the text and image
    encoders run inside the step with gradients, their params in
    state.params next to the fusion model's (`init_finetune_state`), one
    AdamW over the joint tree; composes with accumulation and cfg.remat.
    `step_fn.joint_loss(params, batch, generator, deterministic=False)` is
    the loss, for the eval step."""
    mcfg = cfg.model
    dtype = L.dtype_of(mcfg.compute_dtype)
    text_cfg, vit_cfg = finetune_encoder_configs(cfg, enc.text_cfg,
                                                 enc.vit_cfg)

    def joint_loss(params, batch, generator, deterministic=False):
        emb = _embed_raw(params["text"], text_cfg, params["vit"], vit_cfg,
                         batch, dtype)
        return _loss_fn(params["fusion"], mcfg, emb, generator,
                        deterministic=deterministic)

    step_fn = _make_step(cfg, joint_loss)
    step_fn.joint_loss = joint_loss
    return step_fn


def make_eval_step(cfg: TrainConfig) -> Callable[[torch.nn.Module, dict],
                                                 dict]:
    """eval_fn(params, batch) -> aux: loss and preds without updates
    (deterministic, no autograd)."""
    mcfg = cfg.model

    def eval_fn(params, batch):
        with torch.no_grad():
            _, aux = _loss_fn(params, mcfg, batch, None, deterministic=True)
        return aux

    return eval_fn


@dataclasses.dataclass
class Trainer:
    """Config, device, and the step functions for the train loop on one
    device.

    With `encoders` (a FrozenEncoders) batches are RAW (token ids and uint8
    images from pipelines/raw_store.py): the frozen encoders, moved to the
    device, run inside the step; with `finetune` as well, they train with
    the fusion model. Otherwise batches are pre-embedded.

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

    def __post_init__(self):
        if self.tensor_parallel or self.zero1 or self.zero3 \
                or self.text_parallelism is not None:
            raise NotImplementedError(
                "multi-device training (tensor parallelism, ZeRO, text "
                "parallelism) is not ported yet (ROADMAP A16)")
        if self.finetune and self.encoders is None:
            raise ValueError("finetune=True requires encoders")
        if (self.cfg.accum_steps > 1
                and self.cfg.batch_size % self.cfg.accum_steps != 0):
            raise ValueError(
                f"batch_size={self.cfg.batch_size} must divide by "
                f"accum_steps={self.cfg.accum_steps}")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("training on cuda, but torch sees no CUDA "
                               "device; pass --device cpu to train on the "
                               "CPU")
        self.eval_step = make_eval_step(self.cfg)
        if self.finetune:
            self.train_step = make_finetune_raw_step(self.cfg, self.encoders)
            joint_loss = self.train_step.joint_loss

            def eval_step(params, batch):
                with torch.no_grad():
                    return joint_loss(params, batch, None,
                                      deterministic=True)[1]
            self.eval_step = eval_step
        elif self.encoders is not None:
            for params in (self.encoders.text_params,
                           self.encoders.vit_params):
                params.to(self.device).requires_grad_(False)
            self.train_step = make_encoding_raw_step(self.cfg, self.encoders)
        else:
            self.train_step = make_raw_step(self.cfg)

    def init(self, seed: Optional[int] = None) -> TrainState:
        if self.finetune:
            return init_finetune_state(self.cfg, self.encoders, self.device,
                                       seed)
        return init_state(self.cfg, self.device, seed)

    def shard_batch(self, batch: dict) -> dict:
        """Host numpy batch -> tensors on the device (a copy: no aliasing
        of the caller's arrays)."""
        return {k: torch.tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}
