"""Parallelism toolkit over torch.distributed (counterpart of
mmd_tpu/parallel/__init__.py): the (data, model) mesh of ranks, sharded
retrieval, the sequence-, ring-, pipeline- and tensor-parallel text
encoders for serving (the first three also for fine-tuning, gradients
included), and the training state's specs and sharded AdamW (DP, ZeRO-1,
ZeRO-3, the fusion model's TP, text parallelism; training/trainer.py).
"""

from mmd_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, batch_sharding, corpus_sharding, local_mesh,
    make_mesh, shard_batch,
)
from mmd_tpu_torch.ops.topk import make_sharded_topk
from mmd_tpu_torch.parallel.launch import init_from_env, spawn
from mmd_tpu_torch.parallel.pp import pipeline_encode, pipeline_encode_deberta
from mmd_tpu_torch.parallel.sp import (
    sequence_parallel_encode, sequence_parallel_encode_deberta,
)
from mmd_tpu_torch.parallel.tp import (
    encoder_specs, shard_encoder, state_specs, tp_zero1_specs, zero1_specs,
    zero3_specs,
)
from mmd_tpu_torch.parallel.zero import ShardedAdamW

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "batch_sharding", "corpus_sharding",
    "local_mesh", "make_mesh", "shard_batch",
    "make_sharded_topk", "init_from_env", "spawn", "pipeline_encode",
    "pipeline_encode_deberta", "sequence_parallel_encode",
    "sequence_parallel_encode_deberta", "encoder_specs", "shard_encoder",
    "state_specs", "zero1_specs", "tp_zero1_specs", "zero3_specs",
    "ShardedAdamW",
]
