"""Time the native host libraries against the Python and numpy paths they
replace, on this machine's CPUs, at the work sizes the port gives them and
at 1, 2, 4 and 8 threads, with the path the port's rule picks for each
(`rule`): bindings.py's per-thread constants and the store's
NATIVE_GATHER_MIN_BYTES are read off the table it prints.

  * WordPiece: 64-text batches of the serving traffic corpus
    (inference/traffic.py, the retrieval build's texts) at 512 tokens:
    2-4 words a text, ~60 and ~600 (beyond the window);
  * row gather: ArrayStore columns of the widths the port stores -- a
    pre-embedded text column (512, 384) float16, an image column
    (64, 1024) float16, token ids (512,) int32, a label -- at 8, 24, 64
    and 256 rows, against the store's numpy path (sorted rows, then the
    batch order). The store is written here first, so its pages are in
    the page cache: the reads are warm.

Each path runs `--reps` rounds after two warm-up rounds, the order of the
paths rotated every round; the medians and minima are host milliseconds.

Usage: python -m mmd_tpu_torch.native.measure [--reps 21] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import platform
import shutil
import subprocess
import time

import numpy as np

from mmd_tpu_torch.data.store import NATIVE_GATHER_MIN_BYTES, write_store
from mmd_tpu_torch.data.tokenizer import (
    SPECIALS, WordPieceTokenizer, train_wordpiece,
)
from mmd_tpu_torch.inference.traffic import corpus
from mmd_tpu_torch.native import bindings as B

THREADS = (1, 2, 4, 8)
TEXT_BATCHES = {"2-4 words": slice(0, 64), "~60 words": slice(512, 576),
                "~600 words": slice(960, 1024)}
STORE_ROWS = 512
COLUMNS = {"text_embeds": ((512, 384), np.float16),
           "image_embeds": ((64, 1024), np.float16),
           "input_ids": ((512,), np.int32), "label": ((), np.int32)}
BATCH_ROWS = (8, 24, 64, 256)


def interleaved(fns: dict, reps: int, warmup: int = 2) -> dict:
    """Median and least host ms of each of `fns` over `reps` rounds, the
    order rotated each round so that no path always runs first."""
    names = list(fns)
    for _ in range(warmup):
        for k in names:
            fns[k]()
    ms = {k: [] for k in names}
    for r in range(reps):
        for k in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            fns[k]()
            ms[k].append(1e3 * (time.perf_counter() - t0))
    return {k: {"median_ms": float(np.median(v)), "min_ms": float(min(v))}
            for k, v in ms.items()}


def _line(what: str, res: dict) -> str:
    return what + "  " + "  ".join(
        f"{k} {v['median_ms']:.3f} ({v['min_ms']:.3f})"
        for k, v in res.items())


def measure_wordpiece(reps: int) -> list[dict]:
    texts = corpus(np.random.default_rng(18), 1024)
    words = [w for w in train_wordpiece(texts, 30000) if w not in SPECIALS]
    tok = WordPieceTokenizer(["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + words
                             + ["[MASK]"])
    native = B.NativeTokenizer(tok.vocab)
    python = WordPieceTokenizer(tok.vocab)
    python._native = False
    rows = []
    for name, part in TEXT_BATCHES.items():
        batch = texts[part]
        payload = B._payload(batch)
        want = python.encode_batch(batch, max_length=512)
        fns = {"python": lambda: python.encode_batch(batch, max_length=512)}
        for t in THREADS:
            got = native._encode(payload, len(batch), 512, t)
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"native WordPiece differs ({name})")
            fns[f"native_{t}"] = (lambda t=t: native._encode(
                payload, len(batch), 512, t))
        res = interleaved(fns, reps)
        tokens = int(want[1].sum())
        rule = "native_%d" % B.threads_for(len(payload),
                                           B.TOKENIZER_BYTES_PER_THREAD)
        print(_line(f"wordpiece {name}: {len(payload)} B, {tokens} tokens, "
                    f"rule {rule}:", res), flush=True)
        rows.append({"batch": name, "texts": len(batch),
                     "bytes": len(payload), "tokens": tokens, "rule": rule,
                     **res})
    return rows


def measure_gather(reps: int) -> list[dict]:
    rng = np.random.default_rng(0)
    directory = B.BUILD_DIR / "measure_store"
    shutil.rmtree(directory, ignore_errors=True)
    arrays = {c: rng.integers(-2 ** 15, 2 ** 15, (STORE_ROWS, *shape))
              .astype(dtype) for c, (shape, dtype) in COLUMNS.items()}
    store = write_store(directory, arrays)
    del arrays
    lib = B._gather_lib()
    rows = []
    try:
        for col in COLUMNS:
            src = store.col(col)
            width = B.row_bytes(src)
            for n in BATCH_ROWS:
                idx = rng.permutation(STORE_ROWS)[:n]
                pos = np.argsort(idx, kind="stable")
                sidx, inv = idx[pos], np.argsort(pos)
                want = src[idx]
                fns = {"numpy": lambda: np.ascontiguousarray(
                    src[sidx][inv])}
                for t in THREADS:
                    if not np.array_equal(
                            B._gather(lib, src, sidx, pos, t), want):
                        raise AssertionError(f"native gather differs ({col})")
                    fns[f"native_{t}"] = (lambda t=t: B._gather(
                        lib, src, sidx, pos, t))
                res = interleaved(fns, reps)
                rule = ("native_%d" % B.threads_for(
                    n * width, B.GATHER_BYTES_PER_THREAD)
                    if n * width >= NATIVE_GATHER_MIN_BYTES else "numpy")
                print(_line(f"gather {col} x {n} rows ({n * width} B), rule "
                            f"{rule}:", res), flush=True)
                rows.append({"column": col, "rows": n, "row_bytes": width,
                             "bytes": n * width, "rule": rule, **res})
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return rows


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    for name in B.SOURCES:
        if B.load(name) is None:
            raise SystemExit(f"the native {name} library did not build: "
                             f"{B.build_errors.get(name)}")
    host = {"cpus": B.cpus(), "machine": platform.machine(),
            "processor": platform.processor(), "card": _card(),
            "cxx": B.find_cxx()}
    print(f"host: {json.dumps(host)}", flush=True)
    out = {"host": host, "reps": args.reps,
           "wordpiece": measure_wordpiece(args.reps),
           "gather": measure_gather(args.reps)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
