"""Where a fusion train step's time goes, on one NVIDIA GPU.

    python -m mmd_tpu_torch.profile_train [--compute_dtype {bfloat16,float32}]

Builds the train step that chip_smoke.py's train phases run (batch 256,
text 512 x 384, image 64 x 1024, ModelConfig(compute_dtype=<the flag,
bfloat16 by default>, fused_attn=True, dropout=0.1), AdamW, random weights
from seed 42, one synthetic learnable batch already on the card), warms it
up, then prints JSON lines:

  1. the card's name and power limit (nvidia-smi);
  2. host-clock milliseconds for each of 10 steps, each ending in
     torch.cuda.synchronize(), their median, and the peak device memory
     (torch.cuda.max_memory_allocated);
  3. a torch.profiler window (CPU and CUDA activities) over three steps:
     device busy time (the sum of kernel and copy times on the card), the
     window, the idle share, the launches, and device time by operation,
     the port's kernels named.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from mmd_tpu_torch import profiling as P
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
from mmd_tpu_torch.training.trainer import Trainer

BATCH = 256
STEPS = 10                   # timed steps on the host clock
# kernel symbol -> the port's kernel (the CUDA sources under ops/csrc/)
KERNELS = {"flash_fwd_kernel": "flash_attn_fwd",
           "rowdot_kernel": "flash_attn_bwd", "dkdv_kernel": "flash_attn_bwd",
           "dq_kernel": "flash_attn_bwd", "dropout_kernel": "dropout",
           "mlp_fwd_kernel": "mlp_fwd", "mlp_dx_kernel": "mlp_bwd",
           "mlp_dw_kernel": "mlp_bwd", "mlp_reduce_kernel": "mlp_bwd"}
# the AdamW update (torch's foreach kernels) and autograd's accumulation
TRAIN_GROUPS = (("multi_tensor_apply", "optimizer"),
                ("foreach", "optimizer"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compute_dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    dtype = p.parse_args(argv).compute_dtype
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = P.card()
    print(json.dumps({"card": card}), flush=True)

    cfg = TrainConfig(model=ModelConfig(compute_dtype=dtype,
                                        fused_attn=True, dropout=0.1),
                      batch_size=BATCH)
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init()
    batch = trainer.shard_batch(
        synthetic_preembed_batch(np.random.default_rng(0), BATCH))

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = P.timed(step, STEPS)
    print(json.dumps({
        "batch": BATCH, "steps": STEPS, "compute_dtype": dtype,
        "fused_attn": True, "dropout": 0.1,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card}), flush=True)

    summary = P.profile_window(step, 3, KERNELS, TRAIN_GROUPS + P.GROUPS)
    print(json.dumps({"profiled_steps": 3, **summary, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
