"""ArrayStore reader: fixed-shape columnar sample store on disk (the port's
copy of the read side of mmd_tpu/data/store.py).

Reads the stores the JAX package's writers make (`ArrayStoreWriter`,
`write_store`; the embed pipeline for --pre_embed): flat memory-mapped .npy
columns plus a JSON manifest.

Layout:  <dir>/meta.json
         <dir>/<column>.npy          (N, *shape) per column

The JAX reader gathers rows through an optional native extension; this one
gathers with numpy, the same rows in the same order. The writers come with
the pipelines slice.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


META_NAME = "meta.json"


class ArrayStore:
    """Read-side: lazy memmaps + batch iteration."""

    def __init__(self, directory: str | os.PathLike):
        self.dir = Path(directory)
        meta = json.loads((self.dir / META_NAME).read_text())
        self.count: int = meta["count"]
        self.column_specs = meta["columns"]
        self._cols: Dict[str, np.memmap] = {}

    def col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            self._cols[name] = np.lib.format.open_memmap(
                self.dir / f"{name}.npy", mode="r"
            )
        return self._cols[name][: self.count]

    def __len__(self) -> int:
        return self.count

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield contiguous-copy batches (host numpy). Fixed batch size keeps
        XLA shapes static; the ragged tail is dropped (drop_last) or padded
        by repeating the final sample with a `_pad_mask` column."""
        cols = list(self.column_specs)
        n = self.count
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                pad = np.full(batch_size - len(idx), idx[-1] if len(idx) else 0)
                mask = np.concatenate([np.ones(len(idx), bool),
                                       np.zeros(len(pad), bool)])
                idx = np.concatenate([idx, pad])
                out = {c: np.ascontiguousarray(self.col(c)[idx]) for c in cols}
                out["_pad_mask"] = mask
                yield out
                return
            sidx = np.sort(idx)  # sorted gather is much faster on memmaps
            inv = np.argsort(np.argsort(idx))
            yield {c: np.ascontiguousarray(self.col(c)[sidx][inv])
                   for c in cols}
