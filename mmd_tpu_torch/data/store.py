"""ArrayStore: fixed-shape columnar sample store on disk (the port's copy of
mmd_tpu/data/store.py).

Flat memory-mapped .npy columns plus a JSON manifest, in the JAX package's
format, so each package reads what the other writes (the embed pipeline's
stores for --pre_embed, the raw stores of pipelines/raw_store.py).

Layout:  <dir>/meta.json
         <dir>/<column>.npy          (N, *shape) per column

The JAX reader gathers rows through an optional native extension; this one
gathers with numpy, the same rows in the same order.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


META_NAME = "meta.json"


class ArrayStoreWriter:
    """Incremental writer with a known capacity; supports resume-by-count."""

    def __init__(self, directory: str | os.PathLike, capacity: int,
                 columns: Dict[str, tuple[tuple, np.dtype]]):
        """columns: {name: (shape_per_sample, dtype)}"""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.capacity = capacity
        self.columns = {
            k: (tuple(s), np.dtype(d)) for k, (s, d) in columns.items()
        }
        self._mm: Dict[str, np.memmap] = {}
        meta_path = self.dir / META_NAME
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            if meta["capacity"] != capacity or \
                    set(meta["columns"]) != set(self.columns):
                raise ValueError(f"existing store at {self.dir} is "
                                 f"incompatible")
            self.count = meta["count"]
        else:
            self.count = 0
            self._write_meta()
        for name, (shape, dtype) in self.columns.items():
            path = self.dir / f"{name}.npy"
            full = (capacity, *shape)
            if path.exists():
                self._mm[name] = np.lib.format.open_memmap(path, mode="r+")
                if self._mm[name].shape != full:
                    raise ValueError(f"column {name} of {self.dir} has shape "
                                     f"{self._mm[name].shape}, not {full}")
            else:
                self._mm[name] = np.lib.format.open_memmap(
                    path, mode="w+", dtype=dtype, shape=full)

    def _write_meta(self):
        meta = {
            "capacity": self.capacity,
            "count": self.count,
            "columns": {
                k: {"shape": list(s), "dtype": d.str}
                for k, (s, d) in self.columns.items()
            },
        }
        tmp = self.dir / (META_NAME + ".tmp")
        tmp.write_text(json.dumps(meta, indent=1))
        tmp.replace(self.dir / META_NAME)

    def append_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Append rows; the new count is committed by one atomic meta.json
        write after the rows."""
        n = len(next(iter(batch.values())))
        if self.count + n > self.capacity:
            raise ValueError("store capacity exceeded")
        for name, arr in batch.items():
            self._mm[name][self.count:self.count + n] = arr
        self.count += n
        self._write_meta()

    def finalize(self) -> None:
        for mm in self._mm.values():
            mm.flush()
        self._write_meta()


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
        columns: Optional[Sequence[str]] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield contiguous-copy batches (host numpy) of `columns` (all by
        default). Fixed batch size keeps shapes static; the ragged tail is
        dropped (drop_last) or padded by repeating the final sample with a
        `_pad_mask` column."""
        cols = list(columns or self.column_specs)
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


def write_store(directory, arrays: Dict[str, np.ndarray]) -> ArrayStore:
    """One-shot store creation from in-memory arrays."""
    n = len(next(iter(arrays.values())))
    w = ArrayStoreWriter(
        directory, n,
        {k: (tuple(v.shape[1:]), v.dtype) for k, v in arrays.items()},
    )
    w.append_batch(arrays)
    w.finalize()
    return ArrayStore(directory)
