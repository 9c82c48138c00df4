"""Single-pair and batched inference (reference evaluate.py parity;
counterpart of mmd_tpu/inference/predictor.py).

MisinformationPredictor bundles the frozen encoders, the tokenizer and the
fusion params; `evaluate()` matches the reference contract (reference
evaluate.py:94-196): per-path labels with confidence + full probability
dicts, and None for the paths whose image failed to load.
`evaluate_batch()` classifies many (claim, evidence) pairs in fixed-size
batches; embeddings stay on the device between the encoders and the fusion
forward, and only the logits come back to the host.

With a mesh of ranks (core/mesh.py) and `text_parallelism`, the frozen text
encoder is served over the ranks (models/frozen.text_encode_parallel); the
image encoder and the fusion forward run whole on every rank, so every rank
computes the same labels.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from mmd_tpu_torch.core.checkpoint import read_params
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.frozen import (
    TEXT_PARALLELISM, FrozenEncoders, image_encode, load_or_init_frozen,
    text_encode, text_encode_parallel,
)
from mmd_tpu_torch.models.fusion import fusion_forward, init_fusion_params
from mmd_tpu_torch.ops.image_ops import (
    EVAL_TRANSFORM, load_images_parallel, normalize_on_device,
)

IDX_TO_LABEL = {0: "support", 1: "not_enough_information", 2: "refute"}
PATHS = ("text_text", "text_image", "image_text", "image_image")


def resolve_device(device: str | torch.device) -> torch.device:
    """A CUDA device that is not there raises; nothing moves to the CPU by
    itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           f"device")
    return dev


def read_fusion_checkpoint(path: str) -> dict:
    """The fusion params of a save_params file. A joint fine-tuning state
    ({fusion, text, vit}) and an orbax directory raise."""
    state = read_params(path)
    if state and all(k.split(".", 1)[0] in ("fusion", "text", "vit")
                     for k in state):
        raise ValueError(
            f"{path} is a joint fine-tuning state (fusion, text and vit "
            f"params); the predictor serves fusion params over frozen "
            f"encoders")
    return state


def _add(timings: Optional[dict], key: str, seconds: float) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + seconds


class MisinformationPredictor:
    def __init__(self, model_cfg: ModelConfig,
                 fusion_params: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint_path: Optional[str] = None,
                 encoders: Optional[FrozenEncoders] = None,
                 assets_dir: str = "assets/encoders",
                 max_length: int = 512, batch_size: int = 16,
                 device: str | torch.device = "cuda", mesh=None,
                 text_parallelism: Optional[str] = None):
        """fusion_params: a state dict of the port's fusion params (e.g.
        `bridge.fusion_from_jax(tree, cfg).state_dict()`); checkpoint_path:
        a save_params file of them (the trainer's best_model.pt, or one
        tools/orbax_to_torch.py wrote); neither gives the seeded init. The
        encoders are moved to `device`.

        text_parallelism: serve the frozen text encoder over `mesh` (whose
        device replaces `device`) -- "tp" (the Megatron split: each rank
        holds a copy of its slices, parallel/tp.shard_encoder), "pp" (GPipe
        stages: each rank holds a copy with its layers on its device,
        parallel/pp.shard_stages; the caller's encoders stay as they
        were), "sp" or
        "sp_ring" (sequence parallel). None: single-device serving, the
        reference's deployment shape (evaluate.py:12-33)."""
        if fusion_params is not None and checkpoint_path:
            raise ValueError("pass fusion_params or checkpoint_path, not both")
        if text_parallelism is not None and mesh is None:
            raise ValueError("text_parallelism requires a mesh")
        if text_parallelism not in (None, *TEXT_PARALLELISM):
            raise ValueError(f"unknown text parallelism mode: "
                             f"{text_parallelism!r}")
        if checkpoint_path:
            fusion_params = read_fusion_checkpoint(checkpoint_path)
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.cfg = model_cfg
        enc = encoders or load_or_init_frozen(assets_dir)
        self.max_length = max_length
        self.batch_size = batch_size
        self.mesh = mesh
        self.text_parallelism = text_parallelism
        text = enc.text_params.requires_grad_(False)
        if text_parallelism == "tp":
            from mmd_tpu_torch.parallel.tp import shard_encoder
            text = shard_encoder(text, mesh)
        elif text_parallelism == "pp":
            from mmd_tpu_torch.parallel.pp import shard_stages
            text = shard_stages(text, mesh)
        else:
            text.to(self.device)
        # a split tree is this predictor's own copy: the caller's encoders
        # can serve another predictor, split or whole
        self.enc = dataclasses.replace(enc, text_params=text)
        self.enc.vit_params.to(self.device).requires_grad_(False)
        params = init_fusion_params(torch.Generator().manual_seed(0),
                                    model_cfg)
        if fusion_params is not None:
            try:
                params.load_state_dict(fusion_params)
            except RuntimeError as e:
                raise ValueError(f"the fusion params do not fit {model_cfg}: "
                                 f"{e}") from e
        self.params = params.to(self.device).requires_grad_(False)
        self._vit_dtype = L.dtype_of(self.enc.vit_cfg.compute_dtype)

    def _img_transform(self):
        size = self.enc.vit_cfg.image_size
        t = EVAL_TRANSFORM
        return t if t.size == size else dataclasses.replace(t, size=size)

    def _text_encode(self, ids: torch.Tensor, mask: torch.Tensor):
        if self.text_parallelism is None:
            return text_encode(self.enc.text_params, self.enc.text_cfg, ids,
                               mask)
        return text_encode_parallel(self.enc.text_params, self.enc.text_cfg,
                                    ids, mask, mesh=self.mesh,
                                    mode=self.text_parallelism)

    def _padded(self, n: int) -> int:
        return -(-n // self.batch_size) * self.batch_size

    # ------------------------------------------------------------------

    def _encode_texts(self, texts: Sequence[str], timings=None):
        """-> device tensor (n, L, D), encoded in fixed batches."""
        n = len(texts)
        pad = list(map(str, texts)) + [""] * (self._padded(n) - n)
        out = []
        for lo in range(0, len(pad), self.batch_size):
            t0 = time.perf_counter()
            ids, mask, _ = self.enc.tokenizer.encode_batch(
                pad[lo:lo + self.batch_size], max_length=self.max_length)
            t1 = time.perf_counter()
            # torch.tensor copies: the device tensors never alias host
            # buffers the tokenizer may reuse
            ids_t = torch.tensor(ids, dtype=torch.long, device=self.device)
            mask_t = torch.tensor(mask, dtype=torch.int32, device=self.device)
            out.append(self._text_encode(ids_t, mask_t))
            _add(timings, "tokenize_s", t1 - t0)
            _add(timings, "dispatch_s", time.perf_counter() - t1)
        return torch.cat(out)[:n]

    def decode_images(self, paths: Sequence[Optional[str]], timings=None):
        """Host step: paths -> (uint8 (n, S, S, 3), ok (n,) bool); missing
        or unreadable images are zero-filled with ok False."""
        t0 = time.perf_counter()
        imgs, ok = load_images_parallel(list(paths), self._img_transform())
        _add(timings, "decode_s", time.perf_counter() - t0)
        return imgs, ok

    def encode_images(self, images_u8: np.ndarray, timings=None):
        """Device step: uint8 (n, S, S, 3) -> device tensor (n, T, D),
        normalized on the device and encoded in fixed batches."""
        n = len(images_u8)
        pad = self._padded(n) - n
        if pad:
            images_u8 = np.concatenate(
                [images_u8, np.zeros((pad, *images_u8.shape[1:]), np.uint8)])
        embs = []
        for lo in range(0, len(images_u8), self.batch_size):
            t0 = time.perf_counter()
            u8 = torch.tensor(images_u8[lo:lo + self.batch_size],
                              device=self.device)
            x = normalize_on_device(u8, self._img_transform(), self._vit_dtype)
            embs.append(image_encode(self.enc.vit_params, self.enc.vit_cfg, x))
            _add(timings, "dispatch_s", time.perf_counter() - t0)
        return torch.cat(embs)[:n]

    @staticmethod
    def _softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def _process_logits(self, logits_row) -> dict:
        probs = self._softmax(np.asarray(logits_row, np.float64))
        idx = int(probs.argmax())
        return {
            "label": IDX_TO_LABEL[idx],
            "confidence": float(probs[idx]),
            "probabilities": {IDX_TO_LABEL[i]: float(p)
                              for i, p in enumerate(probs)},
        }

    # ------------------------------------------------------------------

    def evaluate_batch(self, claim_texts, claim_image_paths,
                       evidence_texts, evidence_image_paths,
                       detailed: bool = False, timings=None) -> list:
        """Classify N pairs. Returns, per pair, {path: label-or-None} (or
        full detail dicts when detailed=True). `timings` (optional dict)
        accumulates per-stage seconds: tokenize/decode (host), dispatch
        (device work queued), d2h (logits copy, which waits for the
        device)."""
        x_u8, x_ok = self.decode_images(claim_image_paths, timings)
        e_u8, e_ok = self.decode_images(evidence_image_paths, timings)
        return self.evaluate_arrays(claim_texts, x_u8, x_ok, evidence_texts,
                                    e_u8, e_ok, detailed, timings)

    @torch.inference_mode()
    def evaluate_arrays(self, claim_texts, claim_images_u8, claim_ok,
                        evidence_texts, evidence_images_u8, evidence_ok,
                        detailed: bool = False, timings=None) -> list:
        """evaluate_batch after the host decode: images arrive as uint8
        (n, S, S, 3) batches with their ok flags."""
        x_t = self._encode_texts(claim_texts, timings)
        e_t = self._encode_texts(evidence_texts, timings)
        x_i = self.encode_images(claim_images_u8, timings)
        e_i = self.encode_images(evidence_images_u8, timings)
        t0 = time.perf_counter()
        (y_tt, y_ti), (y_it, y_ii) = fusion_forward(
            self.params, self.cfg, x_t, x_i, e_t, e_i, deterministic=True)
        t1 = time.perf_counter()
        logits = torch.stack([y_tt, y_ti, y_it, y_ii], dim=1).cpu().numpy()
        _add(timings, "dispatch_s", t1 - t0)
        _add(timings, "d2h_s", time.perf_counter() - t1)
        if timings is not None:
            timings["batches"] = timings.get("batches", 0) + 1
        results = []
        for j in range(len(x_t)):
            avail = (True, bool(evidence_ok[j]), bool(claim_ok[j]),
                     bool(claim_ok[j] and evidence_ok[j]))
            out = {}
            for i, path in enumerate(PATHS):
                if not avail[i]:
                    out[path] = None
                    continue
                detail = self._process_logits(logits[j, i])
                out[path] = detail if detailed else detail["label"]
            results.append(out)
        return results

    def evaluate(self, claim_text, claim_image_path, evidence_text,
                 evidence_image_path, detailed: bool = False
                 ) -> Optional[dict]:
        """Single pair (reference evaluate.py:94-196 contract)."""
        try:
            return self.evaluate_batch(
                [claim_text], [claim_image_path],
                [evidence_text], [evidence_image_path], detailed=detailed)[0]
        except Exception as e:  # graceful None like the reference :194-196
            print(f"[predictor] evaluation error: {e!r}")
            return None
