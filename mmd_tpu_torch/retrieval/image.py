"""Image-to-image evidence retrieval (counterpart of
mmd_tpu/retrieval/image.py).

Re-architects the reference's pickle-dict corpus with its O(N) per-pair
cosine loop (reference im2im_retrieval.py:45-106) into an (N, 2048)
feature matrix on the card scored by ONE GEMM and a top-k (ops/topk.py).
Build walks a path list through host-parallel decode and batched ResNet
forwards; a file that fails to decode is skipped and counted.

Store layout: ArrayStore(features (N, D) f16) + ids.json (ordered paths),
the JAX package's, so either package reads what the other writes. The rows
are l2-normalized once, at load (the JAX package normalizes them on every
call; the rows are the same either way). With a mesh of ranks
(core/mesh.py), the rows shard over its "data" axis: each rank holds
1/data of them on its device and a query runs the local top-k, all-gather,
global re-top-k reduction (ops/topk.make_sharded_topk).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from mmd_tpu_torch.core.mesh import DATA_AXIS, corpus_sharding
from mmd_tpu_torch.data.store import ArrayStore, ArrayStoreWriter
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models.resnet import (
    RESNET_TEST, ResNetConfig, init_resnet, resnet_features,
)
from mmd_tpu_torch.ops.image_ops import (
    RESNET_TRANSFORM, load_images_parallel, normalize_on_device,
)
from mmd_tpu_torch.ops.topk import (
    dense_topk, dense_topk_int8, exact_score_dedup, l2_normalize,
    make_sharded_topk, quantize_rows_int8,
)


class ImageCorpus:
    def __init__(self, store_dir: str | Path, resnet_params=None,
                 cfg: ResNetConfig = ResNetConfig(), mesh=None,
                 int8: bool = False, device: str | torch.device = "cuda"):
        """With `mesh`, the corpus rows shard over its "data" axis (padded
        with zero rows to a multiple of the mesh's size) on the mesh's
        device, and queries run the local top-k -> all-gather -> re-top-k
        reduction (ops/topk.make_sharded_topk); every rank gets the same
        results. With `int8`, the corpus lives as per-row-quantized int8
        (+ f32 scales) and scoring runs the int8 GEMM
        (ops/topk.dense_topk_int8: half the memory and traffic; near-tie
        ordering can differ by the ~1/127 quantization step). int8 is
        single-device (exclusive with mesh). Without params, a seeded
        ResNet."""
        if int8 and mesh is not None:
            raise ValueError("int8 corpus scoring is single-device "
                             "(exclusive with mesh)")
        self.dir = Path(store_dir)
        self.cfg = cfg
        self.int8 = int8
        self.mesh = mesh
        self._n_rows = 0                   # the corpus's rows, padded
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        if resnet_params is None:
            resnet_params = init_resnet(torch.Generator().manual_seed(7), cfg)
        self.params = resnet_params.to(self.device)
        self._features = None
        self._scales = None
        self._ids: Optional[list] = None

    @torch.no_grad()
    def _encode(self, images_uint8: np.ndarray) -> torch.Tensor:
        """(B, S, S, 3) uint8 on the host -> (B, feature_dim) f32 on the
        card."""
        x = torch.from_numpy(images_uint8).to(self.device)
        return resnet_features(
            self.params, normalize_on_device(x, RESNET_TRANSFORM), self.cfg)

    # -- build -----------------------------------------------------------

    def create_feature_corpus(self, image_paths: Sequence[str],
                              batch_size: int = 64, io_workers: int = 16
                              ) -> int:
        """Embed every image; failed decodes are skipped and counted
        (reference skip-and-count semantics). Returns corpus size."""
        paths = list(image_paths)
        writer = ArrayStoreWriter(
            self.dir, capacity=len(paths),
            columns={"features": ((self.cfg.feature_dim,), np.float16)})
        kept: list[str] = []
        skipped = 0
        for lo in range(0, len(paths), batch_size):
            chunk = paths[lo:lo + batch_size]
            imgs, ok = load_images_parallel(chunk, RESNET_TRANSFORM,
                                            io_workers)
            skipped += int((~ok).sum())
            idx = np.nonzero(ok)[0]
            if len(idx):
                feats = self._encode(imgs[idx]).to(torch.float16).cpu()
                writer.append_batch({"features": feats.numpy()})
                kept.extend(chunk[i] for i in idx)
        writer.finalize()
        (self.dir / "ids.json").write_text(json.dumps(kept))
        print(f"[im2im] corpus built: {len(kept)} images, {skipped} skipped")
        return len(kept)

    def write_feature_corpus(self, features: np.ndarray, ids) -> int:
        """Persist precomputed features (same on-disk layout as
        create_feature_corpus)."""
        features = np.asarray(features, np.float16)
        writer = ArrayStoreWriter(
            self.dir, capacity=max(len(features), 1),
            columns={"features": ((self.cfg.feature_dim,), np.float16)})
        if len(features):
            writer.append_batch({"features": features})
        writer.finalize()
        (self.dir / "ids.json").write_text(json.dumps(list(map(str, ids))))
        print(f"[im2im] corpus written: {len(features)} precomputed features")
        return len(features)

    # -- query -----------------------------------------------------------

    def _load(self):
        if self._ids is None:
            store = ArrayStore(self.dir)
            feats = np.asarray(store.col("features"))
            if self.mesh is not None:
                # pad to the mesh's size with zero rows (they score 0 and
                # their indices are dropped), keep this rank's rows
                n_pad = -(-len(feats) // self.mesh.size) * self.mesh.size
                feats = np.concatenate([feats, np.zeros(
                    (n_pad - len(feats), feats.shape[1]), feats.dtype)])
                feats = feats[corpus_sharding(self.mesh, n_pad)]
                self._n_rows = n_pad
            feats = torch.from_numpy(np.array(feats)).to(self.device)
            if self.int8:
                self._features, self._scales = quantize_rows_int8(
                    l2_normalize(feats.float()))
            else:
                self._features = l2_normalize(feats.to(torch.bfloat16))
            self._ids = json.loads((self.dir / "ids.json").read_text())

    def __len__(self):
        self._load()
        return len(self._ids)

    def extract_features(self, image_path: str) -> Optional[np.ndarray]:
        imgs, ok = load_images_parallel([image_path], RESNET_TRANSFORM)
        if not ok[0]:
            return None
        return self._encode(imgs)[0].cpu().numpy()

    def retrieve_similar_images(self, query_path: str, top_k: int = 5,
                                dedup: bool = True):
        """-> list[(path, score)] like the reference API
        (im2im_retrieval.py:80-106), incl. exact-score dedup of duplicate
        corpus images."""
        q = self.extract_features(query_path)
        if q is None:
            return []
        return self.retrieve_by_features(q[None], top_k, dedup)[0]

    def retrieve_by_features(self, queries: np.ndarray, top_k: int = 5,
                             dedup: bool = True):
        """(Q, D) features -> one list[(path, score)] a query; with dedup,
        4 * top_k are fetched so that duplicates can be dropped."""
        self._load()
        n = len(self._ids)
        fetch = min(top_k * 4, n) if dedup else min(top_k, n)
        q = torch.as_tensor(np.asarray(queries), device=self.device)
        if self.int8:
            s, i = dense_topk_int8(q.float(), self._features, self._scales,
                                   fetch)
        elif self.mesh is not None:
            s, i = make_sharded_topk(self.mesh, DATA_AXIS, self._n_rows,
                                     fetch, normalize=False)(
                l2_normalize(q.to(torch.bfloat16)), self._features)
        else:
            s, i = dense_topk(l2_normalize(q.to(torch.bfloat16)),
                              self._features, fetch, normalize=False)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        s = np.where(i < n, s, -np.inf)        # a padded row of the mesh
        out = []
        for row_s, row_i in zip(s, i):
            if dedup:
                ds, di = exact_score_dedup(row_s, row_i, top_k)
            else:
                ds, di = row_s[:top_k].tolist(), row_i[:top_k].tolist()
            out.append([(self._ids[j], float(v)) for v, j in zip(ds, di)
                        if j < n and np.isfinite(v)])
        return out


def main(argv=None):
    """CLI parity with `python -m src.evidence.im2im_retrieval` (reference
    im2im_retrieval.py:145-167: build the corpus, run one demo query). Runs
    on the card unless --device cpu."""
    p = argparse.ArgumentParser()
    p.add_argument("--store", type=str, default="data/retrieval/image_corpus")
    p.add_argument("--build_dir", type=str, default=None,
                   help="directory of images to (re)build the corpus from")
    p.add_argument("--query", type=str, default=None)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="serve the corpus int8-quantized (half the memory, "
                        "int8 GEMM scoring; ops/topk.dense_topk_int8)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    corpus = ImageCorpus(args.store,
                         cfg=RESNET_TEST if args.tiny else ResNetConfig(),
                         int8=args.int8, device=args.device)
    if args.build_dir:
        paths = sorted(str(x) for x in Path(args.build_dir).glob("*.jpg"))
        corpus.create_feature_corpus(paths)
    if args.query:
        for path, score in corpus.retrieve_similar_images(args.query,
                                                          args.top_k):
            print(f"{score:.4f}  {path}")


if __name__ == "__main__":
    main()
