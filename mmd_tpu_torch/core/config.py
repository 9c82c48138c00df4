"""Config tree with CLI overrides (counterpart of mmd_tpu/core/config.py).

One dataclass tree feeds every entry point; the CLI keeps the reference's flag
names (--epochs --batch_size --lr --pre_embed --factify --text_only ...).
`--device` picks the torch device (cuda unless the caller asks for cpu).
The mesh, tensor parallelism, ZeRO and the text parallelism of
fine-tuning train over the ranks of a `torch.distributed.run` launch
(train.py, training/trainer.py).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelConfig:
    """Fusion-model hyperparameters (reference train.py:36-41, 80-83)."""

    text_input_dim: int = 384     # DeBERTa-v3-xsmall hidden size
    image_input_dim: int = 1024   # Swinv2-base hidden size
    embed_dim: int = 256
    num_heads: int = 8
    dropout: float = 0.1
    hidden_dim: int = 64
    num_classes: int = 3
    mlp_ratio: float = 4.0
    fused_attn: bool = False      # False -> explicit softmax path, True -> CUDA kernel
    factify: bool = False         # single 5-way head over concat of 4 pooled paths
    text_only: bool = False       # 3-layer head over pooled S_t_t only
    # Reference quirk (model.py:106,115): the "cross" attention inside the
    # multi-view block reuses the SAME modality's K/V, i.e. it is a second
    # self-attention. True replicates the trained function; False performs a
    # genuine cross-modal attention (text queries attend image K/V and vice
    # versa).
    parity_cross_kv: bool = True
    # Compute dtype for matmuls/attention. Params stay float32; layernorm and
    # softmax accumulate in float32 either way.
    compute_dtype: str = "bfloat16"
    # Megatron-style tensor parallelism over the mesh "model" axis
    # (parallel/tp.py). Trainer(tensor_parallel=True) sets this: the params
    # are then the rank's slices, and the forward needs the mesh.
    tensor_parallel: bool = False

    @property
    def head_dim(self) -> int:
        assert self.embed_dim % self.num_heads == 0
        return self.embed_dim // self.num_heads


@dataclass
class MeshConfig:
    """Device mesh layout (JAX names): data = DP over the ranks, model =
    the TP axis (core/mesh.py)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1       # ranks along the model axis
    tensor_parallel: bool = False  # run the train step TP-split (tp.py)
    zero1: bool = False           # shard AdamW moments over the data axis
    zero3: bool = False           # shard params AND moments over data


@dataclass
class DataConfig:
    train_data: str = "./data/preprocessed/train.csv"
    val_data: Optional[str] = None
    pre_embed: bool = False
    shuffle: bool = True


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)

    epochs: int = 50
    batch_size: int = 32
    lr: float = 1e-4
    weight_decay: float = 0.01  # torch AdamW default (reference train.py:356)
    seed: int = 42
    output_dir: str = "./results"
    save_every: int = 2000
    log_every: int = 100
    validate_every_epoch: bool = False
    save_best: bool = False
    best_metric: str = "avg_f1"
    wandb_project: str = "misinformation-detection"
    wandb_entity: Optional[str] = None
    resume_from: Optional[str] = None
    # Kept so that configs written for the JAX package's TrainConfig stay
    # valid, and ignored: there it scans this many steps inside one compiled
    # call, which a Python loop of eager steps has no use for; every batch
    # is one step either way, with the same numbers.
    steps_per_call: int = 1
    # >1 splits each step's batch into this many interleaved micro-batches
    # with accumulated grads and ONE optimizer update (trainer._accum_grads)
    accum_steps: int = 1
    # recompute each TRAINABLE encoder layer in the backward when
    # fine-tuning (torch.utils.checkpoint): the same gradients for about
    # one more forward, with only the layer boundaries kept across the
    # backward; no effect on the frozen and pre-embedded paths
    remat: bool = False
    # keep this many batches' host-to-device copies in flight ahead of the
    # step (training/loop.py prefetch_to_device); 0 = copy at use
    prefetch_depth: int = 2


def add_train_flags(p: argparse.ArgumentParser) -> None:
    """Reference-parity CLI flags (reference train.py:24-85), the JAX
    package's names, plus --device. --num_workers and --text_encoder are
    accepted so that the JAX package's command lines run unchanged, and
    read by nothing, as in the JAX package."""
    d = TrainConfig()
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--embed_dim", type=int, default=d.model.embed_dim)
    p.add_argument("--num_heads", type=int, default=d.model.num_heads)
    p.add_argument("--dropout", type=float, default=d.model.dropout)
    p.add_argument("--hidden_dim", type=int, default=d.model.hidden_dim)
    p.add_argument("--num_classes", type=int, default=d.model.num_classes)
    p.add_argument("--mlp_ratio", type=float, default=d.model.mlp_ratio)
    p.add_argument("--fused_attn", action="store_true")
    p.add_argument("--factify", action="store_true")
    p.add_argument("--text_only", action="store_true")
    p.add_argument("--train_data", type=str, default=d.data.train_data)
    p.add_argument("--val_data", type=str, default=None)
    p.add_argument("--text_encoder", type=str,
                   default="microsoft/deberta-v3-xsmall")
    p.add_argument("--output_dir", type=str, default=d.output_dir)
    p.add_argument("--save_every", type=int, default=d.save_every)
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--validate_every_epoch", action="store_true")
    p.add_argument("--save_best", action="store_true")
    p.add_argument("--best_metric", type=str, default=d.best_metric)
    p.add_argument("--pre_embed", action="store_true")
    p.add_argument("--text_input_dim", type=int, default=d.model.text_input_dim)
    p.add_argument("--image_input_dim", type=int,
                   default=d.model.image_input_dim)
    p.add_argument("--wandb_project", type=str, default=d.wandb_project)
    p.add_argument("--wandb_entity", type=str, default=None)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="ranks along the mesh model axis")
    p.add_argument("--tensor_parallel", action="store_true",
                   help="Megatron-style TP over the mesh model axis "
                        "(requires --model_parallel >= 2; parallel/tp.py)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard AdamW moments over the data axis")
    p.add_argument("--accum_steps", type=int, default=d.accum_steps,
                   help="micro-batches per step (gradient accumulation)")
    p.add_argument("--finetune_encoders", action="store_true",
                   help="on the raw path, train the text and image "
                        "encoders with the fusion model (end-to-end "
                        "fine-tuning)")
    p.add_argument("--text_parallelism", choices=["sp", "sp_ring", "pp"],
                   default=None,
                   help="with --finetune_encoders and --model_parallel>=2: "
                        "run the text-encoder fwd+bwd sequence- or "
                        "pipeline-parallel over the mesh model axis")
    p.add_argument("--zero3", action="store_true",
                   help="ZeRO-3: shard params AND moments over the data "
                        "axis (1/n a rank; gathered on use)")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="process-group backend under torch.distributed.run "
                        "(nccl on CUDA by default, gloo on the CPU; nccl "
                        "runs one rank a card)")
    p.add_argument("--compute_dtype", type=str, default=d.model.compute_dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true",
                   help="rematerialize trainable-encoder layers in the "
                        "backward when fine-tuning (same gradients, less "
                        "activation memory)")
    p.add_argument("--prefetch_depth", type=int, default=d.prefetch_depth,
                   help="keep this many batches' host-to-device copies in "
                        "flight ahead of the step (0 = off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda or cpu); cuda "
                        "raises where there is no card")


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    model = ModelConfig(
        text_input_dim=args.text_input_dim,
        image_input_dim=args.image_input_dim,
        embed_dim=args.embed_dim,
        num_heads=args.num_heads,
        dropout=args.dropout,
        hidden_dim=args.hidden_dim,
        num_classes=args.num_classes,
        mlp_ratio=args.mlp_ratio,
        fused_attn=args.fused_attn,
        factify=args.factify,
        text_only=args.text_only,
        compute_dtype=args.compute_dtype,
    )
    data = DataConfig(
        train_data=args.train_data,
        val_data=args.val_data,
        pre_embed=args.pre_embed,
    )
    mesh = MeshConfig(model_parallel=args.model_parallel,
                      tensor_parallel=args.tensor_parallel,
                      zero1=args.zero1, zero3=args.zero3)
    return TrainConfig(
        model=model, data=data, mesh=mesh,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed,
        output_dir=args.output_dir, save_every=args.save_every,
        log_every=args.log_every,
        validate_every_epoch=args.validate_every_epoch,
        save_best=args.save_best, best_metric=args.best_metric,
        wandb_project=args.wandb_project, wandb_entity=args.wandb_entity,
        resume_from=args.resume_from,
        accum_steps=args.accum_steps,
        remat=args.remat,
        prefetch_depth=args.prefetch_depth,
    )
