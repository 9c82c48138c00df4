"""optax.adamw(lr) with optax's defaults, as torch.optim.AdamW.

The JAX package's captioner trainer and FakeNet trainer build optax.adamw
with its defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on
every leaf (not torch.optim.AdamW's default 1e-2).
"""

from __future__ import annotations

import torch

# optax.adamw's defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def make_optimizer(params: torch.nn.Module, lr: float
                   ) -> torch.optim.AdamW:
    """optax.adamw(lr): decoupled weight decay 1e-4 on every leaf."""
    return torch.optim.AdamW(params.parameters(), lr=lr, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
