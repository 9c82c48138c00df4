"""Device-resident fused pipeline (counterpart of mmd_tpu/pipelines/fused.py):
each split is decoded and uploaded ONCE into capacity-padded "banks" on the
card, and captioning, the ResNet50 image corpus, training and eval then
read from the banks.

The staged pipelines (pipelines/embed.py, caption.py, ...) move each image
across the host-device link once per consuming stage and write the
(N, 512, 384) + (N, 64, 1024) embedding store to the host, which the train
loop streams back every epoch. Here

  * images are uploaded once, as uint8;
  * with `embed_images` the bank keeps the frozen image encoder's output
    (in bf16 smaller than the 256-px uint8 image it encodes), computed
    chunk by chunk at ingest, and the raw chunk feeds the caption and
    ResNet hooks before it is dropped;
  * the frozen text encoder runs inside each train and eval step
    (training/trainer.py::make_encoding_raw_step), over rows gathered on
    the card with `index_select`: a window of K steps uploads only its
    (K, B) row indices.

Ingest stages each chunk in host buffers that are refilled for the next
chunk. On the CPU a tensor made from such a buffer IS the buffer, so every
chunk is copied out of it; on the card the buffers are pinned and
double-buffered, and a set is refilled only after the event recorded
behind its last non-blocking copies has fired.

Single-device by design: the banks live in one card's memory.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import pandas as pd
import torch

from mmd_tpu_torch.data.labels import categories_to_label_array
from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.frozen import image_encode
from mmd_tpu_torch.ops.image_ops import (
    RESNET_TRANSFORM, TRAIN_TRANSFORM, load_images_parallel,
    normalize_on_device, resize_bilinear, resize_uint8,
)

BANK_COLS = ("claim_ids", "claim_mask", "doc_ids", "doc_mask",
             "claim_image", "doc_image", "labels")


@dataclasses.dataclass
class DeviceBank:
    """Capacity-padded device-resident sample bank for one split.

    `data[col]` are tensors with capacity >= n rows; rows past `n` are zero
    padding and never indexed. Token and label columns mirror
    pipelines/raw_store.py; image columns are TRAIN_TRANSFORM uint8, vis
    columns the frozen image encoder's output. `h2d_bytes` counts the bytes
    ingest copied from host to device."""

    data: dict
    n: int
    ids: np.ndarray                 # (n,) int64 sample ids
    claim_paths: list
    doc_paths: list
    skipped: int = 0
    h2d_bytes: int = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data.values())

    def free_images(self):
        """Drop the image tensors (the bulk of the device footprint)."""
        for col in ("claim_image", "doc_image"):
            self.data.pop(col, None)


def _bank_write(buf: torch.Tensor, chunk: torch.Tensor, start: int,
                non_blocking: bool = False) -> torch.Tensor:
    """In place: buf[start:start + len(chunk)] = chunk."""
    buf[start:start + chunk.shape[0]].copy_(chunk, non_blocking=non_blocking)
    return buf


def vis_embed_shape(enc, image_size: int, vis_dtype="bfloat16"):
    """(num_tokens, hidden) of the frozen image encoder's output at
    `image_size`, from its config (no device work)."""
    cfg = enc.vit_cfg
    if cfg.image_size != image_size:
        cfg = dataclasses.replace(cfg, image_size=image_size)
    return (cfg.num_tokens, cfg.hidden_size)


def _make_chunk_embed(enc, dtype, sub: int):
    """The frozen image encoder over one ingest chunk, `sub` images at a
    time, so peak activations stay at `sub` images whatever the chunk. The
    raw train step's image path exactly (TRAIN_TRANSFORM normalization in
    `dtype` on the device, then image_encode); banking the output in
    `dtype` changes nothing when it is the compute dtype, since the fusion
    model casts its inputs to that at entry."""
    dt = L.dtype_of(dtype)

    @torch.no_grad()
    def embed(vit_params, u8: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            image_encode(vit_params, enc.vit_cfg, normalize_on_device(
                u8[lo:lo + sub], TRAIN_TRANSFORM, dt)).to(dt)
            for lo in range(0, u8.shape[0], sub)])

    return embed


def bank_column_shapes(n_rows: int, chunk: int, max_length: int = 512,
                       image_size: int = 256, keep_images: bool = True,
                       vis: Optional[tuple] = None,
                       vis_dtype: str = "bfloat16") -> dict:
    """col -> (shape, dtype) of a bank's tensors, capacity-padded to
    n_rows + chunk. `vis=(tokens, hidden)` (vis_embed_shape) describes an
    embed bank instead of a raw-image bank."""
    cap = n_rows + chunk
    out = {
        "claim_ids": ((cap, max_length), torch.int32),
        "claim_mask": ((cap, max_length), torch.int32),
        "doc_ids": ((cap, max_length), torch.int32),
        "doc_mask": ((cap, max_length), torch.int32),
        "labels": ((cap, 4), torch.int32),
    }
    if vis is not None:
        out["claim_vis"] = ((cap, *vis), L.dtype_of(vis_dtype))
        out["doc_vis"] = ((cap, *vis), L.dtype_of(vis_dtype))
    elif keep_images:
        img = ((cap, image_size, image_size, 3), torch.uint8)
        out["claim_image"] = img
        out["doc_image"] = img
    return out


def _abspaths(rows, col: str, root: Path) -> list:
    out = []
    for p in rows[col]:
        if isinstance(p, str) and p:
            out.append(p if Path(p).is_absolute() else str(root / p))
        else:
            out.append(None)
    return out


def ingest_split(
    csv_path,
    enc,
    max_length: int = 512,
    image_size: int = 256,
    chunk: int = 256,
    io_workers: int = 8,
    sync_every: int = 8,
    keep_images: bool = True,
    embed_images: bool = False,
    vis_dtype: str = "bfloat16",
    on_chunk: Optional[Callable] = None,
    root: Optional[Path] = None,
    device: str | torch.device = "cuda",
) -> DeviceBank:
    """Stream one CSV into a DeviceBank on `device`.

    Host work (tokenize, PIL decode) of a chunk runs while the previous
    chunk's copies and device work are in flight; on the card the stream
    is synchronized every `sync_every` chunks to bound the queue.
    Skip-and-count as pipelines/raw_store.py: both images must decode.

    keep_images=False banks tokens and labels only: the images go to
    `on_chunk` and are dropped. embed_images=True banks the frozen image
    encoder's output (`claim_vis` / `doc_vis`, (n, tokens, hidden) in
    vis_dtype) in place of the images, which it implies are not kept.

    on_chunk(images, start_row, n_rows) is called after each chunk lands,
    with device uint8 tensors {"claim": (chunk, S, S, 3), "doc": ...}; rows
    past n_rows are zero."""
    device = resolve_device(device)
    df = pd.read_csv(csv_path)
    root = Path(root) if root else get_project_root()
    transform = (TRAIN_TRANSFORM if image_size == 256 else
                 dataclasses.replace(TRAIN_TRANSFORM, size=image_size))

    embed_fn = None
    vis = None
    if embed_images:
        keep_images = False
        vis = vis_embed_shape(enc, image_size, vis_dtype)
        sub = chunk
        while sub > 64 and sub % 2 == 0:
            sub //= 2
        enc.vit_params.to(device)
        embed_fn = _make_chunk_embed(enc, vis_dtype, sub)
    shapes = bank_column_shapes(len(df), chunk, max_length, image_size,
                                keep_images, vis, vis_dtype)
    data = {col: torch.zeros(shp, dtype=dt, device=device)
            for col, (shp, dt) in shapes.items()}

    # host staging: every non-vis column, and the images either way; on the
    # card pinned and double-buffered behind an event
    pinned = device.type == "cuda"
    staging_shapes = {col: (shp[1:], dt) for col, (shp, dt) in shapes.items()
                      if not col.endswith("_vis")}
    img = ((image_size, image_size, 3), torch.uint8)
    staging_shapes.setdefault("claim_image", img)
    staging_shapes.setdefault("doc_image", img)
    sets = []
    for _ in range(2 if pinned else 1):
        bufs = {col: torch.zeros((chunk, *shp), dtype=dt)
                for col, (shp, dt) in staging_shapes.items()}
        if pinned:
            bufs = {col: t.pin_memory() for col, t in bufs.items()}
        sets.append(bufs)
    events = [None] * len(sets)
    cur = 0
    staging = {col: t.numpy() for col, t in sets[cur].items()}
    staged = 0
    cursor = 0
    n_flushed = 0
    skipped = 0
    h2d = 0
    kept_ids: list = []
    kept_claim_paths: list = []
    kept_doc_paths: list = []

    def flush():
        nonlocal staged, cursor, n_flushed, h2d, cur, staging
        if staged == 0:
            return
        imgs = {}
        for col, host in sets[cur].items():
            h2d += host.numel() * host.element_size()
            if col in data:
                _bank_write(data[col], host, cursor, pinned)
                dev = data[col][cursor:cursor + chunk]
            else:
                # a copy, never the staging buffer itself
                dev = torch.empty(host.shape, dtype=host.dtype,
                                  device=device)
                dev.copy_(host, non_blocking=pinned)
            if col in ("claim_image", "doc_image"):
                imgs[col.split("_")[0]] = dev
        if pinned:
            events[cur] = torch.cuda.Event()
            events[cur].record(torch.cuda.current_stream(device))
        if embed_fn is not None:
            for kind, col in (("claim", "claim_vis"), ("doc", "doc_vis")):
                _bank_write(data[col], embed_fn(enc.vit_params, imgs[kind]),
                            cursor)
        if on_chunk is not None:
            on_chunk(imgs, cursor, staged)
        cursor += staged
        staged = 0
        n_flushed += 1
        if pinned and n_flushed % sync_every == 0:
            torch.cuda.current_stream(device).synchronize()
        # the next chunk fills the other set, once its last copies are done
        cur = (cur + 1) % len(sets)
        if events[cur] is not None:
            events[cur].synchronize()
        staging = {col: t.numpy() for col, t in sets[cur].items()}

    for lo in range(0, len(df), chunk):
        rows = df.iloc[lo:lo + chunk]
        texts_c = rows["claim"].fillna("").astype(str).tolist()
        texts_d = rows["evidence"].fillna("").astype(str).tolist()
        c_ids, c_mask, _ = enc.tokenizer.encode_batch(texts_c,
                                                      max_length=max_length)
        d_ids, d_mask, _ = enc.tokenizer.encode_batch(texts_d,
                                                      max_length=max_length)
        cpaths = _abspaths(rows, "claim_image", root)
        dpaths = _abspaths(rows, "evidence_image", root)
        c_img, c_ok = load_images_parallel(cpaths, transform, io_workers)
        d_img, d_ok = load_images_parallel(dpaths, transform, io_workers)
        valid = c_ok & d_ok
        skipped += int((~valid).sum())
        labels = categories_to_label_array(rows["category"].tolist())
        idx = np.nonzero(valid)[0]
        ids64 = rows["id"].to_numpy(np.int64)
        pos = 0
        while pos < len(idx):
            take = min(chunk - staged, len(idx) - pos)
            sel = idx[pos:pos + take]
            sl = slice(staged, staged + take)
            staging["claim_ids"][sl] = c_ids[sel]
            staging["claim_mask"][sl] = c_mask[sel]
            staging["doc_ids"][sl] = d_ids[sel]
            staging["doc_mask"][sl] = d_mask[sel]
            staging["labels"][sl] = labels[sel]
            staging["claim_image"][sl] = c_img[sel]
            staging["doc_image"][sl] = d_img[sel]
            kept_ids.extend(ids64[sel])
            kept_claim_paths.extend(cpaths[i] for i in sel)
            kept_doc_paths.extend(dpaths[i] for i in sel)
            staged += take
            pos += take
            if staged == chunk:
                flush()
    if staged:
        # zero the unused tail so padding rows stay inert
        for col in staging:
            staging[col][staged:] = 0
        flush()

    return DeviceBank(data=data, n=cursor,
                      ids=np.asarray(kept_ids, np.int64),
                      claim_paths=kept_claim_paths,
                      doc_paths=kept_doc_paths, skipped=skipped,
                      h2d_bytes=h2d)


# ---------------------------------------------------------------------------
# Captions from device-resident images
# ---------------------------------------------------------------------------


class BankCaptioner:
    """Caption generation over bank or ingest image chunks: each block is
    dispatched as it comes (the card's queue runs it while the host goes
    on), and its token tensor is kept until `collect` pulls them all."""

    def __init__(self, engine, batch: int = 64,
                 bank_image_size: Optional[int] = None):
        self.engine = engine
        self.batch = batch
        self._pending: list = []          # (kind, start, n, device tokens)
        cap_size = engine.cfg.vit.image_size
        if bank_image_size is not None and bank_image_size != cap_size:
            self._gen = lambda u8: engine.generate_uint8(
                resize_uint8(u8, cap_size))
        else:
            self._gen = engine.generate_uint8

    def on_chunk(self, imgs: dict, start: int, n: int):
        """Ingest hook: `batch`-row blocks of the chunk's first n rows, each
        as long as the chunk allows (a capacity-padded chunk that `batch`
        divides gives full blocks)."""
        b = self.batch
        for kind in ("claim", "doc"):
            arr = imgs[kind]
            for lo in range(0, n, b):
                hi = min(lo + b, n)
                toks = self._gen(arr[lo:lo + b])
                self._pending.append((kind, start + lo, hi - lo, toks))

    def dispatch_bank(self, bank: DeviceBank):
        """Caption a bank's resident images in `batch`-row blocks (views:
        no extra device memory, no host traffic). A block is always `batch`
        rows: one that would run past the bank's capacity starts earlier,
        as the JAX package's dynamic_slice moves it, and its captions land
        at the rows the block was asked for."""
        b = self.batch
        for kind, col in (("claim", "claim_image"), ("doc", "doc_image")):
            buf = bank.data[col]
            for lo in range(0, bank.n, b):
                start = max(0, min(lo, buf.shape[0] - b))
                toks = self._gen(buf[start:start + b])
                self._pending.append((kind, lo, min(b, bank.n - lo), toks))

    def collect(self, n_rows: int) -> tuple:
        """Pull and decode every pending caption -> (claim_caps, doc_caps):
        token tensors concatenated on the device in groups of 32, one copy
        to the host a group."""
        caps = {"claim": [""] * n_rows, "doc": [""] * n_rows}
        tok = self.engine.tokenizer
        group = 32
        for g0 in range(0, len(self._pending), group):
            entries = self._pending[g0:g0 + group]
            stacked = torch.cat([e[3] for e in entries]).cpu().numpy()
            row = 0
            for kind, start, n, toks_dev in entries:
                for j in range(n):
                    if start + j < n_rows:
                        caps[kind][start + j] = tok.decode(stacked[row + j])
                row += toks_dev.shape[0]
        self._pending.clear()
        return caps["claim"], caps["doc"]

    def pending_tensors(self) -> list:
        return [e[3] for e in self._pending]


def write_enriched_csv(df: pd.DataFrame, bank_ids: np.ndarray,
                       claim_caps, doc_caps, out_csv: Path):
    """Write {split}_enriched.csv with the reference's 4 columns
    (caption.py:34-47 semantics); rows skipped at ingest keep NA captions."""
    df = df.copy()
    for col in ("claim_image_caption", "evidence_image_caption",
                "claim_enriched", "evidence_enriched"):
        df[col] = pd.NA
    by_id = {int(i): k for k, i in enumerate(bank_ids)}
    cc_col = df.columns.get_loc("claim_image_caption")
    for ridx, rid in enumerate(df["id"]):
        k = by_id.get(int(rid))
        if k is None:
            continue
        cc, ec = claim_caps[k], doc_caps[k]
        df.iat[ridx, cc_col] = cc
        df.iat[ridx, cc_col + 1] = ec
        df.iat[ridx, cc_col + 2] = (f"{df.at[ridx, 'claim']}. {cc}"
                                    if cc else str(df.at[ridx, "claim"]))
        df.iat[ridx, cc_col + 3] = (f"{df.at[ridx, 'evidence']}. {ec}"
                                    if ec else str(df.at[ridx, "evidence"]))
    df.to_csv(out_csv, index=False)
    return out_csv


# ---------------------------------------------------------------------------
# Train / eval over banks
# ---------------------------------------------------------------------------


def make_bank_window(cfg, enc, steps_per_call: int):
    """window(state, data, idx) -> (state, aux): `steps_per_call` encoding
    raw train steps (training/trainer.py::make_encoding_raw_step, the frozen
    encoders of `enc` inside each), step i on the rows idx[i] gathered from
    the bank's tensors on their device. Each step draws the dropout
    generator the plain step would draw at that step. aux holds each
    step's loss, preds and labels, stacked."""
    from mmd_tpu_torch.training.trainer import make_encoding_raw_step

    raw = make_encoding_raw_step(cfg, enc)

    def window(state, data: dict, idx: torch.Tensor):
        if idx.shape[0] != steps_per_call:
            raise ValueError(f"a window takes {steps_per_call} steps of "
                             f"rows, not {idx.shape[0]}")
        out = {"loss": [], "preds": [], "labels": []}
        for i in range(steps_per_call):
            batch = {k: torch.index_select(v, 0, idx[i])
                     for k, v in data.items()}
            state, aux = raw(state, batch)
            for k in out:
                out[k].append(aux[k])
        return state, {k: torch.stack(v) for k, v in out.items()}

    return window


def train_from_bank(trainer, bank: DeviceBank, steps_per_call: int = 8,
                    log_every: int = 50, logger=None):
    """Epochs of shuffled windows over the bank (the JAX package's
    schedule: permutations from np.random.default_rng(cfg.seed), epochs
    cut to whole windows of b * k rows, the leftover rows shuffled into
    the next epoch). Saves the params to <output_dir>/final_model.pt and
    returns the state."""
    from mmd_tpu_torch.core.checkpoint import save_params

    cfg = trainer.cfg
    b, k = cfg.batch_size, steps_per_call
    if bank.n < b * k:
        # skip-and-count shrank the bank below the window the CSV's length
        # promised: shrink the window
        k = max(bank.n // max(b, 1), 1)
        b = min(b, bank.n)
        print(f"[fused-train] bank smaller than window, using k={k} b={b}")
    window = make_bank_window(cfg, trainer.encoders, k)
    state = trainer.init()
    device = bank.data["labels"].device
    rng = np.random.default_rng(cfg.seed)
    step = 0
    t0 = time.time()
    samples = 0
    for _ in range(cfg.epochs):
        perm = rng.permutation(bank.n)
        usable = (len(perm) // (b * k)) * b * k
        windows = perm[:usable].reshape(-1, k, b).astype(np.int64)
        for w in windows:
            state, aux = window(state, bank.data,
                                torch.from_numpy(w).to(device))
            step += k
            samples += b * k
            if step % log_every < k:
                loss = float(aux["loss"][-1])
                dt = time.time() - t0
                rate = samples / max(dt, 1e-9)
                if logger is not None:
                    logger.log({"train/total_loss": loss,
                                "train/samples_per_sec": rate}, step=step)
                print(f"[fused-train] step {step} loss {loss:.4f} "
                      f"{rate:.0f} samples/s")
                samples, t0 = 0, time.time()
    out_dir = Path(cfg.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_params(str(out_dir / "final_model.pt"), state.params)
    return state


def make_bank_predict(model_cfg, enc):
    """predict(fusion_params, batch) -> (B, P) int64 preds: a raw batch (or
    an embed bank's) through the frozen encoders of `enc` and the fusion
    forward, deterministic, argmax over classes."""
    from mmd_tpu_torch.models.fusion import fusion_forward
    from mmd_tpu_torch.training.trainer import _embed_raw

    dtype = L.dtype_of(model_cfg.compute_dtype)

    @torch.inference_mode()
    def predict(fusion_params, batch: dict) -> torch.Tensor:
        emb = _embed_raw(enc.text_params, enc.text_cfg, enc.vit_params,
                         enc.vit_cfg, batch, dtype)
        out = fusion_forward(fusion_params, model_cfg,
                             X_t=emb["claim_text_embeds"],
                             X_i=emb["claim_image_embeds"],
                             E_t=emb["doc_text_embeds"],
                             E_i=emb["doc_image_embeds"],
                             deterministic=True)
        if model_cfg.factify or model_cfg.text_only:
            return torch.argmax(out[0], -1)[:, None]
        (y_tt, y_ti), (y_it, y_ii) = out
        return torch.argmax(torch.stack([y_tt, y_ti, y_it, y_ii], 1), -1)

    return predict


def _encoders_on(enc, device: torch.device):
    enc.text_params.to(device)
    enc.vit_params.to(device)


def evaluate_from_bank(bank: DeviceBank, enc, model_cfg, fusion_params,
                       batch_size: int = 64, results_csv=None) -> dict:
    """Eval over a banked split: batches gather on the device (the row
    indices are the only upload), only (B, P) preds come back. The last
    window wraps modulo n and its wrapped rows are dropped."""
    from mmd_tpu_torch.pipelines.eval_models import (
        fusion_module, metrics_from_preds,
    )

    device = bank.data["labels"].device
    _encoders_on(enc, device)
    params = fusion_module(fusion_params, model_cfg, device)
    predict = make_bank_predict(model_cfg, enc)
    preds, labels = [], []
    b = min(batch_size, max(bank.n, 1))
    for lo in range(0, bank.n, b):
        idx = torch.from_numpy(np.arange(lo, lo + b) % bank.n).to(device)
        valid = min(b, bank.n - lo)
        batch = {k: torch.index_select(v, 0, idx)
                 for k, v in bank.data.items()}
        preds.append(predict(params, batch).cpu().numpy()[:valid])
        labels.append(batch["labels"].cpu().numpy()[:valid])
    return metrics_from_preds(np.concatenate(preds), np.concatenate(labels),
                              results_csv=results_csv)


def evaluate_streaming(csv_path, enc, model_cfg, fusion_params,
                       batch_size: int = 64, image_size: int = 256,
                       max_length: int = 512, io_workers: int = 8,
                       results_csv=None, root=None,
                       device: str | torch.device = "cuda") -> dict:
    """Eval that streams the test images batch by batch (never banked):
    tokenize and decode on the host, predict on `device`. The same per-path
    and unified metric rows as pipelines/eval_models.evaluate_store."""
    from mmd_tpu_torch.pipelines.eval_models import (
        fusion_module, metrics_from_preds,
    )

    device = resolve_device(device)
    df = pd.read_csv(csv_path)
    root = Path(root) if root else get_project_root()
    transform = (TRAIN_TRANSFORM if image_size == 256 else
                 dataclasses.replace(TRAIN_TRANSFORM, size=image_size))
    _encoders_on(enc, device)
    params = fusion_module(fusion_params, model_cfg, device)
    predict = make_bank_predict(model_cfg, enc)
    preds, labels = [], []
    for lo in range(0, len(df), batch_size):
        rows = df.iloc[lo:lo + batch_size]
        n = len(rows)
        pad = batch_size - n
        texts_c = rows["claim"].fillna("").astype(str).tolist() + [""] * pad
        texts_d = rows["evidence"].fillna("").astype(str).tolist() + [""] * pad
        c_ids, c_mask, _ = enc.tokenizer.encode_batch(texts_c,
                                                      max_length=max_length)
        d_ids, d_mask, _ = enc.tokenizer.encode_batch(texts_d,
                                                      max_length=max_length)
        c_img, c_ok = load_images_parallel(
            _abspaths(rows, "claim_image", root) + [None] * pad, transform,
            io_workers)
        d_img, d_ok = load_images_parallel(
            _abspaths(rows, "evidence_image", root) + [None] * pad, transform,
            io_workers)
        valid = (c_ok & d_ok)[:n]
        batch = {k: torch.from_numpy(v).to(device) for k, v in (
            ("claim_ids", c_ids), ("claim_mask", c_mask), ("doc_ids", d_ids),
            ("doc_mask", d_mask), ("claim_image", c_img),
            ("doc_image", d_img))}
        preds.append(predict(params, batch).cpu().numpy()[:n][valid])
        labels.append(categories_to_label_array(
            rows["category"].tolist())[valid])
    return metrics_from_preds(np.concatenate(preds), np.concatenate(labels),
                              results_csv=results_csv)


# ---------------------------------------------------------------------------
# The image retrieval corpus from the bank
# ---------------------------------------------------------------------------


def _load_resnet(tiny: bool, assets):
    """(params, cfg) of ResNet50 as pipelines/build_retrieval.py resolves
    it: converted torchvision weights (resnet50.pt) when the assets hold
    them, else the seeded init; RESNET_TEST when tiny."""
    from mmd_tpu_torch.core.checkpoint import load_params
    from mmd_tpu_torch.models.frozen import asset_path
    from mmd_tpu_torch.models.resnet import (
        RESNET_TEST, ResNetConfig, init_resnet,
    )

    cfg = RESNET_TEST if tiny else ResNetConfig()
    pt = None if tiny else asset_path(Path(assets), "resnet50")
    if pt is not None:
        return load_params(str(pt), init_resnet(
            torch.Generator().manual_seed(0), cfg)), cfg
    return init_resnet(torch.Generator().manual_seed(7), cfg), cfg


def _resnet_block(params, cfg, u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC bank images -> (B, feature_dim) f32 ResNet features:
    RESNET_TRANSFORM's normalization in fp32, the bilinear resize to its
    224 px, bf16 into the network (the JAX package's order)."""
    from mmd_tpu_torch.models.resnet import resnet_features

    mean = torch.tensor(RESNET_TRANSFORM.mean, dtype=torch.float32,
                        device=u8.device) * 255.0
    std = torch.tensor(RESNET_TRANSFORM.std, dtype=torch.float32,
                       device=u8.device) * 255.0
    x = resize_bilinear((u8.float() - mean) / std, RESNET_TRANSFORM.size)
    return resnet_features(params, x.to(torch.bfloat16), cfg)


def _write_corpus(params, cfg, features: np.ndarray, bank: DeviceBank,
                  root: Path):
    from mmd_tpu_torch.retrieval.image import ImageCorpus

    corpus = ImageCorpus(root / "data" / "retrieval" / "image_corpus",
                         resnet_params=params, cfg=cfg,
                         device=bank.data["labels"].device)
    corpus.write_feature_corpus(features, [str(p) for p in bank.doc_paths])
    return corpus


class BankResNetFeatures:
    """Ingest hook computing the image retrieval corpus's features from the
    streamed evidence-image chunks (an embed bank never holds the pixels):
    `_resnet_block` over `sub`-image blocks, the JAX package's
    im2im precompute. Features stay on the device until `write`."""

    def __init__(self, tiny: bool = False, sub: int = 64,
                 assets="assets/encoders"):
        self.params, self.cfg = _load_resnet(tiny, assets)
        self.sub = sub
        self._chunks: list = []

    @torch.no_grad()
    def _feat(self, u8: torch.Tensor) -> torch.Tensor:
        n = u8.shape[0]
        s = min(self.sub, n)
        while n % s:
            s -= 1
        self.params = self.params.to(u8.device)
        return torch.cat([_resnet_block(self.params, self.cfg, u8[lo:lo + s])
                          for lo in range(0, n, s)])

    def on_chunk(self, imgs: dict, start: int, n: int):
        self._chunks.append((start, n, self._feat(imgs["doc"])))

    def write(self, bank: DeviceBank, root: Path):
        """Assemble (bank.n, feature_dim) f16 and write the corpus."""
        if self._chunks:
            stacked = torch.cat([c[2] for c in self._chunks]).cpu().numpy(
                ).astype(np.float16)
            rows = []
            off = 0
            for _, n, f in self._chunks:
                rows.append(stacked[off:off + n])
                off += f.shape[0]
            features = np.concatenate(rows)[:bank.n]
        else:
            features = np.zeros((0, self.cfg.feature_dim), np.float16)
        self._chunks.clear()
        return _write_corpus(self.params, self.cfg, features, bank, root)


@torch.no_grad()
def build_image_corpus_from_bank(bank: DeviceBank, root: Path,
                                 tiny: bool = False, batch: int = 64,
                                 assets="assets/encoders"):
    """The ResNet feature corpus from the bank's resident evidence images
    (`_resnet_block`; the staged path decodes at 224 on the host, so the
    two agree up to the resize chain). Ids are the original evidence image
    paths, so demo lookups behave the same. A block is always `batch` rows:
    one that would run past the bank's capacity starts earlier, as the JAX
    package's dynamic_slice moves it."""
    params, cfg = _load_resnet(tiny, assets)
    buf = bank.data["doc_image"]
    params = params.to(buf.device)
    feats = []
    for lo in range(0, bank.n, batch):
        start = max(0, min(lo, buf.shape[0] - batch))
        feats.append(_resnet_block(params, cfg, buf[start:start + batch])
                     .cpu().numpy().astype(np.float16))
    features = (np.concatenate(feats)[:bank.n] if feats
                else np.zeros((0, cfg.feature_dim), np.float16))
    return _write_corpus(params, cfg, features, bank, root)
