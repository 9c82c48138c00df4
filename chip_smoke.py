"""Smoke run of the PyTorch port's serving, training and fine-tuning paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:
  1. device   a CUDA device, its name and power limit (nvidia-smi), TF32 off
  2. build    nvcc builds the eleven kernel libraries from ops/csrc/, all at
              once
  3. kernels  each kernel against its plain PyTorch version on the card, at
              every geometry of the paths that run it, bf16 and fp32: max-abs
              error against its tolerance; kernel, plain and library times
              from CUDA events; the bound (the least time the card could
              take: bytes over 3.35 TB/s or operations over the card's peak
              for the timed dtype -- 989 TFLOP/s for bf16 on the tensor
              cores, 67 TFLOP/s for fp32, which has no tensor-core rate
              without TF32 (H100 SXM data sheet) -- whichever is larger),
              all beside the card's name
     * flash_attn_fwd        exact zeros for a row with no valid key, lse
     * layernorm             (residual +) LayerNorm, the 53 of a Swinv2 forward
     * swin_window_attn      Swinv2 window attention, the 24 of a forward,
                             fp32 and bf16, each call twice and bit for bit
     * deberta_attn_fwd      DeBERTa attention at the served (B 16, T 512)
                             and the fine-tuning (B 8, T 256) geometry,
                             fp32 and bf16: the uniform row of a row with
                             no valid key, each call twice and bit for
                             bit; its device us a call by torch.profiler
                             beside its CUDA-event us and its bound
     * dropout               elementwise dropout at each dropout geometry of
                             the train step: bit-identical to its plain
                             version, kept fraction within 4 sigma of 1 - rate
     * flash_attn_fwd        with attention dropout at the fusion model's
       (train)               four geometries, batch 256; rate 0 unchanged;
                             timed in fp32 and bf16 at rates 0.1 and 0
                             beside SDPA in the same dtype and rate
     * flash_attn_bwd        dq, dk, dv at the same geometries with and
                             without dropout, the masked text geometry
                             with a row with no valid key, and two ragged
                             geometries (T 100, S 130, masked, dh 64; T 77,
                             S 50, dh 32) at both rates with the forward;
                             every backward twice, bit-identical; timed in
                             fp32 and bf16 at rates 0.1 and 0 beside SDPA's
                             backward
     * mlp_masks, mlp_fwd,   the fused MLP at the bf16 train step's two MLP
       mlp_bwd               geometries, rate 0.1 and 0: the dumped masks
                             bit-identical to their plain version; y and
                             dx, dW1, db1, dW2, db2 against the plain
                             versions and against a float64 oracle built
                             from the dumped masks; y and the gradients
                             twice, bit-identical
     * deberta_attn_bwd      DeBERTa attention backward at B 8, T 256, D 384,
                             6 heads, a padded tail and a row with no valid
                             key: dq, dk, dv, dPK, dPQ, fp32 and bf16, each
                             call twice and bit for bit; its device us a
                             call by torch.profiler beside its CUDA-event
                             us and its bound
     * flash_attn_fwd        at the cross-encoder re-rank geometry of a
       (rerank)              text search (B 50, T = S 256, 12 heads of dh
                             32, padded key tails), bf16 and fp32, beside
                             SDPA
     * swin_attn_train_fwd,  Swinv2 window attention for fine-tuning,
       swin_attn_train_bwd   forward and backward (dq, dk, dv, dbias) at the
                             four Swinv2-base stage geometries, B 8, and
                             three at B 7 (one with head dim 64), fp32 and
                             bf16, the forward and the backward twice bit
                             for bit; per stage the forward's and SDPA's us
                             a call
  4. serve            full-width serving with the BERT-class text encoder
                      (512 tokens) and the ViT, ModelConfig(fused_attn=True),
                      bf16, batch 16: a ServingEngine answers requests from
                      several threads; 56 flash launches per batch
  5. serve_reference  the same with the reference's encoders,
                      load_or_init_frozen(reference_families=True):
                      DeBERTa-v3-xsmall and Swinv2-base; per batch exactly
                      24 / 48 / 106 / 8 launches of the DeBERTa, Swin, LayerNorm
                      and flash kernels
  In both serve phases image requests must keep their image paths,
  probabilities must be finite and sum to 1, and one fp32 batch through the
  kernel path must agree with the explicit path.
  6. serve_converted  a trained model served from files, as a user serves
                      one: DeBERTa-v3-xsmall (fp32, as converted) and
                      Swinv2-base assets with their sidecar configs (the
                      published configs through config_from_hf, weights
                      from seeds) written by convert_hf's writer, an
                      spm.json built from the traffic corpus, and a fusion
                      best_model.pt of seed 7, loaded through
                      MisinformationPredictor(checkpoint_path=...,
                      assets_dir=...); 32 requests at batch 16 with the
                      launches of serve_reference a batch; a batch from the
                      files bit-identical to the same modules, tokenizer
                      and params held in memory, and unlike the seeded
                      head's; set-up seconds and the unigram tokenizer's
                      seconds a batch beside the WordPiece tokenizer's
  7. train            python -m mmd_tpu_torch.train's main path (build, then
                      run_training) at full width, batch 256, float32,
                      fused_attn, dropout 0.1, on synthetic learnable batches:
                      8 steps and one validation pass; every loss finite,
                      exactly 8 / 8 / 32 launches of the flash forward,
                      backward and dropout kernels a step (and 8 flash
                      forwards a validation batch), params moved,
                      metrics.jsonl and checkpoints written; wall time a
                      step and peak device memory
  8. train_bf16       the same with the default compute dtype, bfloat16:
                      exactly 6 / 6 / 8 / 8 / 8 launches of the fused MLP
                      forward and backward, the flash forward and backward
                      and the dropout kernel a step, none of the mask oracle
  9. train_parity     one fp32 step at batch 16 and full width, dropout on,
                      one seed, through fused_attn=True and fused_attn=False:
                      loss within 1e-5 relative, every grad leaf within 1e-4
                      of its largest |value|
 10. train_parity_bf16  one bf16 step at batch 16 and full width, dropout
                      on, one seed, through the fused and the unfused MLP:
                      loss within 1e-3 relative, the gradient within 1e-1
                      in L2 norm; the fused step with a wrong seed must
                      fail the same check
 11. finetune_reference  8 steps of end-to-end fine-tuning of the reference
                      encoders (Trainer(finetune=True) on
                      load_or_init_frozen(reference_families=True):
                      DeBERTa-v3-xsmall and Swinv2-base with fused_train,
                      bf16) with the default fusion model, batch 8, 256
                      tokens, raw batches: finite losses, exactly 24 / 24 /
                      48 / 48 launches a step of the DeBERTa forward and
                      backward and the Swin fine-tuning forward and
                      backward, the fusion model's kernels, none of the
                      serving Swin kernel or the LayerNorm; wall time a
                      step and peak device memory
 12. finetune_parity  one fp32 step of the same at batch 2, dropout 0,
                      through the kernels and through both encoders'
                      explicit paths: loss within 1e-4 relative, each
                      tree's (fusion, text, vit) gradient within 1e-3 in
                      L2 norm
 13. train_raw        a synthetic Factify tree (64 train rows, 256 px) ->
                      preprocess_csv -> python -m mmd_tpu_torch.train's
                      main on the raw path, 2 epochs at batch 8, default
                      encoder families: frozen, then --finetune_encoders;
                      finite losses, metrics.jsonl, the launches a step
 14. retrieval        evidence retrieval at full width and Factify-2's
                      corpus sizes, seeded weights: 1,024 traffic texts
                      through TextCorpus.encode_corpus (MPNet
                      BI_ENCODER_BASE, batch 64, 512 tokens) and 256 JPEGs
                      plus a corrupt file through
                      ImageCorpus.create_feature_corpus (ResNet50; exactly
                      1 skipped); text_train / text_test / image_corpus
                      written at 35,000 / 7,500 / 41,256 rows (built rows
                      first, seeded rows after); 32 text searches
                      (SemanticSearch over both corpora, the MiniLM
                      cross-encoder re-ranking 50 pairs of 256 tokens:
                      exactly 6 #1 launches a search) and 32 image searches
                      (retrieve_similar_images: none), latency p50/p95 and
                      seconds by stage; a query's scoring us over each
                      corpus, bf16 and int8, beside its bound; checks (a)
                      bf16 top-k against float64, (b) int8 planted top-1
                      and recall@10 >= 0.9, (c) a duplicated row comes back
                      lower index first and dedup drops its twin, (d)
                      self-retrieval without re-rank, (e) the fp32 re-rank
                      through #1 against the explicit path, (f) the fp32
                      MPNet on the card against the CPU
The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record, with each kernel's launches in the counted runs of
the serve, serve_reference, serve_converted, train, train_bf16,
finetune_reference, train_raw and retrieval phases.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# -- tolerances ----------------------------------------------------------------
# kernel vs fp32 plain version on the same (bf16-rounded) inputs:
#   fp32: summation order, exp2f and rsqrtf only
#   bf16: the output is rounded to bf16 once -- the flash phase keeps its
#   fixed 2e-2 (|o| up to ~3); the other kernels allow one bf16 step at the
#   largest |output| of the call
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3          # fp32 statistics in both
# fp32 serving, kernel path vs explicit path, on class probabilities
PROB_TOL = 1e-3

# the card's published peaks (H100 SXM data sheet) for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12       # CUDA cores: fp32 has no tensor-core rate
                              # without TF32, which the port keeps off

BATCH = 16
TEXT = dict(name="text", t=512, s=512, d=384, h=6, masked=True)
VIT = dict(name="vit", t=64, s=64, d=1024, h=16, masked=False)
FUSION = [dict(name=f"fusion_{t}x{s}", t=t, s=s, d=256, h=8, masked=False)
          for t in (512, 64) for s in (512, 64)]
# flash launches per served batch of 16, by geometry: 12 layers x (claim,
# evidence) for each encoder; the fusion model's 2 self, 2 second-self and
# 4 evidence attentions at (text 512, image 64) lengths
PER_BATCH = {"text": 24, "vit": 24, "fusion_512x512": 3, "fusion_64x64": 3,
             "fusion_512x64": 1, "fusion_64x512": 1}
LAUNCHES_PER_BATCH = sum(PER_BATCH.values())          # 56
FUSION_PER_BATCH = 8

# Swinv2-base LayerNorms per served batch (two forwards): (rows, C,
# shortcut) -> launches. rows = 16 images x tokens of the stage.
LN_GEOMS = {(65536, 128, False): 2,     # patch-embedding norm
            (65536, 128, True): 8,      # stage 0: 2 blocks x 2 norms
            (16384, 256, True): 8,      # stage 1
            (4096, 512, True): 72,      # stage 2: 18 blocks
            (1024, 1024, True): 8,      # stage 3
            (16384, 256, False): 2,     # patch merges
            (4096, 512, False): 2,
            (1024, 1024, False): 4}     # last merge + final norm
# Swinv2-base window attentions per served batch: (nW, C, heads, bias
# windows) -> launches; unshifted blocks share one bias over the windows
SWIN_GEOMS = {(64, 128, 4, 1): 2, (64, 128, 4, 64): 2,
              (16, 256, 8, 1): 2, (16, 256, 8, 16): 2,
              (4, 512, 16, 1): 18, (4, 512, 16, 4): 18,
              (1, 1024, 32, 1): 4}
DEBERTA = dict(t=512, d=384, h=6, per_batch=24)
REFERENCE_PER_BATCH = {"deberta_attn_fwd": DEBERTA["per_batch"],
                       "swin_window_attn": sum(SWIN_GEOMS.values()),
                       "layernorm": sum(LN_GEOMS.values()),
                       "flash_attn_fwd": FUSION_PER_BATCH}
# serve_converted: the published configs (config.json) of
# microsoft/deberta-v3-xsmall and microsoft/swinv2-base-patch4-window8-256,
# the fields the port's config_from_hf reads; the weights come from seeds
DEBERTA_V3_XSMALL_HF = {
    "model_type": "deberta-v2", "vocab_size": 128100, "hidden_size": 384,
    "num_hidden_layers": 12, "num_attention_heads": 6,
    "intermediate_size": 1536, "hidden_act": "gelu",
    "max_position_embeddings": 512, "max_relative_positions": -1,
    "position_buckets": 256, "relative_attention": True,
    "position_biased_input": False, "pos_att_type": "p2c|c2p",
    "norm_rel_ebd": "layer_norm", "share_att_key": True,
    "layer_norm_eps": 1e-7, "type_vocab_size": 0}
SWINV2_BASE_HF = {
    "model_type": "swinv2", "image_size": 256, "patch_size": 4,
    "num_channels": 3, "embed_dim": 128, "depths": [2, 2, 18, 2],
    "num_heads": [4, 8, 16, 32], "window_size": 8, "mlp_ratio": 4.0,
    "qkv_bias": True, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
    "pretrained_window_sizes": [0, 0, 0, 0]}
CONVERTED_SEEDS = {"deberta": 1, "swinv2": 2, "spm": 3, "fusion": 7}
CONVERTED_REQUESTS = 32

# The fusion train step at batch 256, fp32, dropout 0.1.
TRAIN_B = 256
DROPOUT_RATE = 0.1
# Elementwise dropouts a step, (N, D) -> launches, forward and backward:
# text-query MLPs (claim second self-attention, text-text, text-image) at
# N = 256 x 512 and image-query MLPs at N = 256 x 64, each dropping after
# GELU (4 x 256 wide) and after fc2 (256 wide); the four classifier heads
# drop their (256, 64) hidden layer.
DROPOUT_GEOMS = {(131072, 1024): 6, (131072, 256): 6, (16384, 1024): 6,
                 (16384, 256): 6, (256, 64): 8}
# Flash forwards (and backwards) a step, by (T, S): two self-attentions
# and two second self-attentions, then the evidence paths text-text,
# text-image, image-text, image-image.
TRAIN_PER_STEP = {"fusion_512x512": 3, "fusion_64x64": 3,
                  "fusion_512x64": 1, "fusion_64x512": 1}
PER_STEP = {"flash_attn_fwd": sum(TRAIN_PER_STEP.values()),
            "flash_attn_bwd": sum(TRAIN_PER_STEP.values()),
            "dropout": sum(DROPOUT_GEOMS.values())}          # 8 / 8 / 32
TRAIN_STEPS = 8
# The bf16 train step: the six MLPs run the fused kernels (#3 forward, #4
# backward), so only the heads' (256, 64) dropouts stay elementwise.
# (N rows, D, F) -> MLP calls a step: the three text-query MLPs and the
# three image-query MLPs.
MLP_GEOMS = {(131072, 256, 1024): 3, (16384, 256, 1024): 3}
MLP_PER_STEP = sum(MLP_GEOMS.values())                     # 6
PER_STEP_BF16 = {"flash_attn_fwd": PER_STEP["flash_attn_fwd"],
                 "flash_attn_bwd": PER_STEP["flash_attn_bwd"],
                 "dropout": DROPOUT_GEOMS[(256, 64)],
                 "mlp_fwd": MLP_PER_STEP, "mlp_bwd": MLP_PER_STEP}   # 8/8/8/6/6
# kernels #3 and #4 against their plain versions on the same bf16 inputs,
# relative to each output's largest |value|: one bf16 rounding of the
# output, and of h, dyb and dab inside, after fp32 sums in another order
MLP_TOL = 2.0 ** -7
# against the float64 oracle built from #12's masks, which rounds nothing:
# the kernels' bf16 roundings of h, dyb, dab and the outputs (the bound
# benchmarks/validate_mlp_tpu.py holds the TPU kernels to); a wrong mask
# flips ~10% of the hidden entries with an O(1) effect
ORACLE_TOL = 2e-2
# train_parity: loss relative, grads relative to each leaf's largest |g|;
# a leaf whose true gradient is zero (the key projections' biases: softmax
# ignores a shift shared by all keys) holds fp32 noise, so no leaf is held
# to less than 1e-3 of the model's largest gradient
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_RTOL = 1e-4
PARITY_FLOOR = 1e-3
# train_parity_bf16, fused vs unfused MLP: the same masks, but the unfused
# path rounds to bf16 after fc1, after its bias, after GELU and after each
# dropout where the kernels round h and y once, so the two steps differ by
# bf16 roundings (2^-8 each) carried through the step. The loss averages
# them over 16 samples and 4 paths: within 1e-3 relative. The gradient as
# one vector (all leaves) within 1e-1 in L2 norm: the classifier heads
# carry most of its norm, and at batch 16 their gradients are sums of few
# terms, each moved by the roundings of the logits; a single leaf is no
# yardstick in bf16 (a head's can move by a fifth of itself). A wrong
# mask moves the gradient by about half its norm.
PARITY_BF16_LOSS_RTOL = 1e-3
PARITY_BF16_GRAD_RTOL = 1e-1

# The reference fine-tuning step: batch 8, 256 tokens (the JAX package's
# fine-tune benchmarks), DeBERTa-v3-xsmall (12 layers, D 384, 6 heads) on
# the claim and the document, Swinv2-base on both images.
FT_STEPS = 8
FT_DEBERTA = dict(b=8, t=256, d=384, h=6, per_step=24)
# Swinv2-base window attentions a fine-tuning step: (nW, C, heads) -> the
# blocks of the stage x 2 images
FT_SWIN_GEOMS = {(64, 128, 4): 4, (16, 256, 8): 4, (4, 512, 16): 36,
                 (1, 1024, 32): 4}
# (nW, C, heads) checked at B 7 (prime): stage 0 (one row a CTA), 512
# (window, head) pairs (one CTA walks all seven rows), head dim 64
FT_SWIN_CHECK_B7 = [(64, 128, 4), (64, 256, 8), (16, 256, 4)]
FT_PER_STEP = {"deberta_attn_fwd": 24, "deberta_attn_bwd": 24,
               "swin_attn_train_fwd": 48, "swin_attn_train_bwd": 48,
               "flash_attn_fwd": 8, "flash_attn_bwd": 8, "mlp_fwd": 6,
               "mlp_bwd": 6, "dropout": 8}
# finetune_parity, fp32 at batch 2, kernels vs explicit paths, set before
# the first run: the two differ by the order of fp32 sums through 12
# DeBERTa layers and 24 Swin blocks, forward and backward (and the Swin
# kernels' exp2 of log2-domain scores against exp of natural ones); a
# wrong gradient in #8, #9, #10 or #11 moves its tree by O(1)
FT_PARITY_LOSS_RTOL = 1e-4
FT_PARITY_GRAD_RTOL = 1e-3
# train_raw: the default families' launches a step, claim and document
# through 12 text layers and 12 ViT layers, then the fusion model's
RAW_FROZEN_PER_STEP = {"flash_attn_fwd": 56, "flash_attn_bwd": 8,
                       "mlp_fwd": 6, "mlp_bwd": 6, "dropout": 8}
RAW_FINETUNE_PER_STEP = {**RAW_FROZEN_PER_STEP, "flash_attn_bwd": 56}

# Evidence retrieval at Factify-2's corpus sizes (SURVEY.md:312-316): the
# MPNet bi-encoder (BI_ENCODER_BASE) and the ResNet50 features, rows by
# corpus; a text search re-ranks top_k 5 x recall 5 from both text corpora
# with the MiniLM cross-encoder (CROSS_ENCODER_MINI): 50 pairs of 256
# tokens, one #1 launch a layer
RETRIEVAL_ROWS = {"text_train": 35000, "text_test": 7500,
                  "image_corpus": 41256}
RETRIEVAL_TEXTS = 1024           # evidence texts encoded, batch 64, 512 tok
RETRIEVAL_TRAIN_TEXTS = 768      # of them in text_train, the rest in test
RETRIEVAL_IMAGES = 256           # JPEGs built into the image corpus
RETRIEVAL_SEARCHES = 32          # text searches, and image searches
RETRIEVAL_TOP_K, RETRIEVAL_RECALL = 5, 5
RERANK = dict(name="rerank_50x256", b=50, t=256, s=256, d=384, h=12)
RERANK_PER_SEARCH = 6            # the cross-encoder's 6 layers
# (c) a seeded image row and its later twin (row indices)
TWIN = (RETRIEVAL_IMAGES + 10, RETRIEVAL_IMAGES + 1000)
# (a) card top-k against float64 on the host over the same bf16 rows:
# fp32 sums of exact bf16 products over D 2048 err by ~1e-6; scores cast
# to bf16 on the way out would err by up to half a bf16 step at [0.5, 1),
# 2^-9 ~ 1.95e-3, which this limit refuses
TOPK_SCORE_TOL = 1e-4
# (a) the score gap past which the top-k' index sets must agree
TOPK_GAP_TOL = 2e-3
# (b) tests/test_topk.py's bar at full width
INT8_RECALL_MIN = 0.9
# (e) fp32 re-rank through #1 against the explicit path, relative to the
# largest |score|; (f) the fp32 bi-encoder on the card against the CPU,
# relative to the largest |embedding| (TF32 off: fp32 sums in another
# order through 12 layers)
RERANK_FP32_RTOL = 1e-3
MPNET_CARD_CPU_RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def _kernels():
    """kernel name -> (op module, its loader, its launch counter)."""
    from mmd_tpu_torch.ops import attention, deberta_attention, dropout, ln, \
        mlp, swin_attention
    return {"flash_attn_fwd": (attention, "load_kernel", "launches"),
            "layernorm": (ln, "load_kernel", "launches"),
            "swin_window_attn": (swin_attention, "load_kernel", "launches"),
            "deberta_attn_fwd": (deberta_attention, "load_kernel",
                                 "launches"),
            "dropout": (dropout, "load_kernel", "launches"),
            "flash_attn_bwd": (attention, "load_bwd_kernel", "bwd_launches"),
            "mlp_fwd": (mlp, "load_kernel", "launches"),
            "mlp_bwd": (mlp, "load_bwd_kernel", "bwd_launches"),
            "mlp_masks": (mlp, "load_masks_kernel", "mask_launches"),
            "deberta_attn_bwd": (deberta_attention, "load_bwd_kernel",
                                 "bwd_launches"),
            "swin_attn_train_fwd": (swin_attention, "load_train_kernel",
                                    "train_launches"),
            "swin_attn_train_bwd": (swin_attention, "load_train_bwd_kernel",
                                    "train_bwd_launches")}


def _reset_counts() -> None:
    for mod, _, counter in _kernels().values():
        setattr(mod, counter, 0)


def _counts() -> dict:
    return {name: getattr(mod, counter)
            for name, (mod, _, counter) in _kernels().items()}


def phase_build() -> None:
    from mmd_tpu_torch.ops import cuda_build
    kernels = _kernels()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:     # one nvcc per source
        list(ex.map(lambda k: getattr(k[0], k[1])(), kernels.values()))
    for name in kernels:
        secs = cuda_build.build_seconds.get(name)
        print(f"build: {name} nvcc "
              f"{'%.3f s' % secs if secs is not None else 'skipped: built'}",
              flush=True)
    print(f"build: all {len(kernels)} loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float,
              peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def _flash_bound_ms(q: torch.Tensor, k: torch.Tensor, h: int, mask,
                    peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """#1's forward over (B, T, D) q and (B, S, D) k, v under a (B, S) key
    mask: Q and O, the K and V rows of the valid keys, the fp32 lse and
    the mask moved once; 4 T D operations a valid key. A padded key adds
    nothing to the output, so it counts neither bytes nor operations."""
    b, t, d = q.shape
    keys = k.shape[0] * k.shape[1] if mask is None else int(
        mask.bool().sum())
    nbytes = q.element_size() * (2 * b * t * d + 2 * keys * d) + 4 * b * h * t
    if mask is not None:
        nbytes += mask.numel() * mask.element_size()
    return _bound_ms(nbytes, 4 * t * d * keys, peak_flops)


def _bf16_step(ref: torch.Tensor) -> float:
    top = ref.abs().max().item()
    return 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def _record(name, source, replaces, per_batch_rows, errs, note=None):
    """Sum per-geometry times over one served batch's launches."""
    ms = sum(n * r["ms"] for n, r in per_batch_rows)
    plain = sum(n * r["plain_ms"] for n, r in per_batch_rows)
    bound = sum(n * r["bound_ms"] for n, r in per_batch_rows)
    libs = [r["library_ms"] for _, r in per_batch_rows]
    # the resource behind most of the summed bound
    share = {"bytes": 0.0, "operations": 0.0}
    for n, r in per_batch_rows:
        share[r["bound_by"]] += n * r["bound_ms"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": max(share, key=share.get),
            "library_ms": None if None in libs else sum(
                n * r["library_ms"] for n, r in per_batch_rows),
            "library_note": note}


def _print_time(kernel, geom, row, card):
    lib = (f", library {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else "")
    print(f"time   {kernel} {geom}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms{lib}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})  [{card}]", flush=True)


def phase_flash(card: str) -> dict:
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, rows = [], []
    for g in [TEXT, VIT, *FUSION]:
        b, t, s, d, h = BATCH, g["t"], g["s"], g["d"], g["h"]
        q32 = torch.randn(b, t, d, device=dev, generator=gen)
        k32 = torch.randn(b, s, d, device=dev, generator=gen)
        v32 = torch.randn(b, s, d, device=dev, generator=gen)
        mask = lib_mask = None
        if g["masked"]:
            # valid lengths from 1 to S, and a last row with no valid key
            lengths = torch.linspace(1, s, b - 1, device=dev).round().long()
            mask = (torch.arange(s, device=dev)[None] < lengths[:, None])
            # SDPA gives NaN on a row with no valid key: time it on the
            # same lengths with the last row given one valid key
            lib_mask = torch.cat([mask, torch.arange(s, device=dev)[None] < 1])
            mask = torch.cat([mask, torch.zeros(1, s, dtype=torch.bool,
                                                device=dev)]).to(torch.int32)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            o, lse = A.flash_attention(q, k, v, h, mask)
            torch.cuda.synchronize()
            o_ref, lse_ref = A.flash_attention_plain(
                q.float(), k.float(), v.float(), h, mask)
            err = (o.float() - o_ref).abs().max().item()
            fin = torch.isfinite(lse_ref)
            lse_err = (lse[fin] - lse_ref[fin]).abs().max().item()
            ok = (err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                  and torch.equal(torch.isfinite(lse), fin))
            if mask is not None:
                ok = ok and bool((o[-1] == 0).all()) and bool(
                    torch.isneginf(lse[-1]).all())
            print(f"kernel flash_attn_fwd {g['name']:>14} {str(dtype):>14}: "
                  f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse "
                  f"err {lse_err:.3e}"
                  f"{', masked row zeros' if mask is not None else ''}"
                  f" -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{g['name']} {dtype}")
            errs.append(err)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                      for x in (q, k, v))
        am = None if lib_mask is None else lib_mask[:, None, None, :]
        row = {"ms": _time_ms(lambda: A.flash_attention(q, k, v, h, mask)),
               "plain_ms": _time_ms(
                   lambda: A.flash_attention_plain(q, k, v, h, mask)),
               "library_ms": _time_ms(lambda: sdpa(qh, kh, vh, attn_mask=am))}
        row["bound_ms"], row["bound_by"] = _flash_bound_ms(q, k, h, mask)
        _print_time("flash_attn_fwd", f"{g['name']} bf16 B={b} T={t} S={s} "
                    f"D={d} H={h}", row, card)
        rows.append((PER_BATCH[g["name"]], row))
    rec = _record("flash_attn_fwd", "mmd_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                  "mmd_tpu/ops/attention.py:430", rows, errs,
                  "torch.nn.functional.scaled_dot_product_attention with a "
                  "boolean key mask, (B, H, T, dh) views; the text geometry's "
                  "row with no valid key given one valid key (SDPA gives NaN "
                  "there)")
    print(f"kernel flash_attn_fwd per served batch of {BATCH} "
          f"({LAUNCHES_PER_BATCH} launches, serve phase): kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def phase_layernorm(card: str) -> dict:
    from mmd_tpu_torch.ops import ln as LN
    layer_norm = torch.nn.functional.layer_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, rows = [], []
    for (r, c, res), n in LN_GEOMS.items():
        p = torch.nn.LayerNorm(c).to(dev)
        with torch.no_grad():
            p.weight.normal_(generator=gen)
            p.bias.normal_(generator=gen)
        y32 = torch.randn(r, c, device=dev, generator=gen)
        x32 = torch.randn(r, c, device=dev, generator=gen) if res else None
        with torch.no_grad():
            for dtype in (torch.bfloat16, torch.float32):
                y = y32.to(dtype)
                x = None if x32 is None else x32.to(dtype)
                out = LN.fused_layernorm(p, y, 1e-5, x)
                torch.cuda.synchronize()
                ref = LN.fused_layernorm_plain(p, y.float(), 1e-5,
                                               None if x is None else x.float())
                err = (out.float() - ref).abs().max().item()
                tol = (KERNEL_TOL[dtype] if dtype == torch.float32
                       else _bf16_step(ref))
                print(f"kernel layernorm ({r}, {c}) shortcut={res} "
                      f"{str(dtype):>14}: max_abs_err {err:.3e} (tol "
                      f"{tol:.3e}) -> {'ok' if err <= tol else 'FAIL'}",
                      flush=True)
                if not err <= tol:
                    fail(f"layernorm kernel disagrees with its plain version "
                         f"at ({r}, {c}) {dtype}")
                errs.append(err)
            y = y32.to(torch.bfloat16)
            x = None if x32 is None else x32.to(torch.bfloat16)
            wb, bb = p.weight.to(torch.bfloat16), p.bias.to(torch.bfloat16)
            row = {"ms": _time_ms(lambda: LN.fused_layernorm(p, y, 1e-5, x)),
                   "plain_ms": _time_ms(
                       lambda: LN.fused_layernorm_plain(p, y, 1e-5, x)),
                   # the shortcut's add is not part of F.layer_norm's time
                   "library_ms": _time_ms(
                       lambda: layer_norm(y, (c,), wb, bb, 1e-5))}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            2 * r * c * (3 if res else 2) + 8 * c, 8 * r * c)
        _print_time("layernorm", f"({r}, {c}) shortcut={res} bf16", row,
                    card)
        rows.append((n, row))
    rec = _record("layernorm", "mmd_tpu_torch/ops/csrc/layernorm.cu",
                  "mmd_tpu/ops/ln.py:106", rows, errs,
                  "torch.nn.functional.layer_norm on the same bf16 input "
                  "(weights cast to bf16); the shortcut's add is excluded")
    print(f"kernel layernorm per served batch ({sum(LN_GEOMS.values())} "
          f"launches): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, F.layer_norm {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def phase_swin(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, rows = [], []
    n = 64
    for (nw, c, h, nwb), count in SWIN_GEOMS.items():
        q32, k32, v32 = (torch.randn(nw, BATCH, n, c, device=dev,
                                     generator=gen) for _ in range(3))
        # position bias in (0, 16) plus, for shifted windows, twice a
        # 0 / -100 region mask
        bias = 16 * torch.rand(1, h, n, n, device=dev, generator=gen)
        if nwb > 1:
            region = torch.rand(nwb, 1, n, n, device=dev, generator=gen) < 0.3
            bias = bias - 200.0 * region
        bias = bias.expand(nwb, h, n, n).contiguous()
        scale = torch.exp(torch.clamp(
            torch.rand(h, device=dev, generator=gen) * 5, max=math.log(100)))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            o = SA.swin_window_attention_infer(q, k, v, bias, scale, h)
            again = SA.swin_window_attention_infer(q, k, v, bias, scale, h)
            torch.cuda.synchronize()
            if not torch.equal(o, again):
                fail(f"swin kernel: two calls differ at nW={nw} C={c} {dtype}")
            ref = SA.swin_window_attention_infer_plain(
                q.float(), k.float(), v.float(), bias, scale, h)
            err = (o.float() - ref).abs().max().item()
            tol = (KERNEL_TOL[dtype] if dtype == torch.float32
                   else _bf16_step(ref))
            print(f"kernel swin_window_attn nW={nw} C={c} h={h} "
                  f"bias_windows={nwb} {str(dtype):>14}: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}) -> "
                  f"{'ok' if err <= tol else 'FAIL'}", flush=True)
            if not err <= tol:
                fail(f"swin kernel disagrees with its plain version at nW={nw}"
                     f" C={c} {dtype}")
            errs.append(err)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        row = {"ms": _time_ms(
            lambda: SA.swin_window_attention_infer(q, k, v, bias, scale, h)),
               "plain_ms": _time_ms(
            lambda: SA.swin_window_attention_infer_plain(q, k, v, bias, scale,
                                                         h)),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            2 * 4 * nw * BATCH * n * c + 4 * nwb * h * n * n + 4 * h,
            4 * nw * BATCH * n * n * c)
        _print_time("swin_window_attn", f"nW={nw} B={BATCH} n={n} C={c} h={h} "
                    f"bias_windows={nwb} bf16", row, card)
        rows.append((count, row))
    rec = _record("swin_window_attn",
                  "mmd_tpu_torch/ops/csrc/swin_window_attn.cu",
                  "mmd_tpu/ops/swin_attention.py:151", rows, errs,
                  "no single PyTorch call computes it: the per-head L2 "
                  "normalization of q and k is part of the function")
    print(f"kernel swin_window_attn per served batch "
          f"({sum(SWIN_GEOMS.values())} launches): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def _deberta_inputs(gen, b: int, t: int, d: int):
    """q, k, v, PK, PQ (fp32) and an int key mask with valid lengths from 1
    to T and a last row with no valid key."""
    dev = gen.device
    q32, k32, v32 = (torch.randn(b, t, d, device=dev, generator=gen)
                     for _ in range(3))
    pk32, pq32 = (torch.randn(2 * t, d, device=dev, generator=gen)
                  for _ in range(2))
    lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
    mask = torch.cat([torch.arange(t, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, t, dtype=torch.bool, device=dev)]).int()
    return [q32, k32, v32, pk32, pq32], mask


def phase_deberta(card: str) -> dict:
    """#10 at the served geometry (B 16, T 512) and the fine-tuning one (B 8,
    T 256), bf16 and fp32: against its plain version, the row with no valid
    key, two calls bit for bit; timed in bf16 at both, with its device time
    a call by torch.profiler."""
    from mmd_tpu_torch import profiling
    from mmd_tpu_torch.ops import deberta_attention as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    d, h = DEBERTA["d"], DEBERTA["h"]
    scale = 1.0 / math.sqrt(3.0 * d // h)
    errs, rows = [], {}
    for what, b, t in (("served", BATCH, DEBERTA["t"]),
                       ("finetune", FT_DEBERTA["b"], FT_DEBERTA["t"])):
        x32, mask = _deberta_inputs(gen, b, t, d)
        geom = f"B={b} T={t} D={d} H={h}"
        for dtype in (torch.bfloat16, torch.float32):
            args = [x.to(dtype) for x in x32]
            o = DA.deberta_attention(*args, mask, h, scale)
            again = DA.deberta_attention(*args, mask, h, scale)
            torch.cuda.synchronize()
            same = torch.equal(o, again)
            ref = DA.deberta_attention_plain(*[x.float() for x in args], mask,
                                             h, scale)
            err = (o.float() - ref).abs().max().item()
            tol = (KERNEL_TOL[dtype] if dtype == torch.float32
                   else _bf16_step(ref))
            uniform = args[2][-1].float().mean(0).expand(t, d)
            uerr = (o[-1].float() - uniform).abs().max().item()
            ok = err <= tol and uerr <= tol and same
            print(f"kernel deberta_attn_fwd {geom} {str(dtype):>14}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}), row with no valid "
                  f"key vs uniform mean of V {uerr:.3e}, two calls "
                  f"{'bit-identical' if same else 'DIFFER'} -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"deberta_attn_fwd disagrees with its plain version or "
                     f"with itself, {geom} {dtype}")
            errs.append(max(err, uerr))
        # timed with the mask as the encoder hands it over: bytes
        args = [x.to(torch.bfloat16) for x in x32]
        kmask = DA.key_bytes(mask)
        call = lambda: DA.deberta_attention(  # noqa: E731
            *args, kmask, h, scale)
        row = {"ms": _time_ms(call),
               "plain_ms": _time_ms(
                   lambda: DA.deberta_attention_plain(*args, kmask, h, scale),
                   5 if what == "served" else 20),
               "library_ms": None}
        # reads q, k, v and both tables, writes o (bf16) and reads the mask;
        # 8 B T^2 D operations (the TPU kernel's count)
        row["bound_ms"], row["bound_by"] = _bound_ms(
            2 * (4 * b * t * d + 2 * 2 * t * d) + b * t, 8 * b * t * t * d)
        _print_time("deberta_attn_fwd", f"{geom} bf16", row, card)
        # device time a call by torch.profiler, beside the CUDA-event time
        # (which also holds the host's time where that is the larger)
        calls = 50
        win = profiling.profile_window(call, calls, {})
        device_us = sum(v * 1e3 / calls for k, v in
                        win["device_ms_top"].items() if "deberta_attn" in k)
        print(f"time   deberta_attn_fwd {geom} bf16: device {device_us:.3f} "
              f"us a call by torch.profiler, CUDA events "
              f"{1e3 * row['ms']:.3f} us, bound {1e3 * row['bound_ms']:.3f} "
              f"us  [{card}]", flush=True)
        rows[what] = row
    rec = _record("deberta_attn_fwd",
                  "mmd_tpu_torch/ops/csrc/deberta_attn_fwd.cu",
                  "mmd_tpu/models/deberta.py:293",
                  [(DEBERTA["per_batch"], rows["served"])], errs,
                  "no single PyTorch call computes it: the c2p and p2c "
                  "terms gather from relative-position tables per (t, s)")
    step = {k: FT_DEBERTA["per_step"] * rows["finetune"][k]
            for k in ("ms", "plain_ms", "bound_ms")}
    print(f"kernel deberta_attn_fwd per served batch ({DEBERTA['per_batch']} "
          f"launches): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, bound {rec['bound_ms']:.4f} ms; per fine-tuning step "
          f"({FT_DEBERTA['per_step']} launches): kernel {step['ms']:.4f} ms, "
          f"plain {step['plain_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms"
          f"  [{card}]", flush=True)
    return rec


def phase_dropout(card: str) -> dict:
    """Elementwise dropout at every dropout geometry of the train step."""
    from mmd_tpu_torch.ops import dropout as D
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs, rows = [], []
    for (n, d), count in DROPOUT_GEOMS.items():
        x32 = torch.randn(n, d, device=dev, generator=gen)
        seed = 0x5EED0000 + n + d
        for dtype, bits in ((torch.bfloat16, torch.int16),
                            (torch.float32, torch.int32)):
            x = x32.to(dtype)
            y = D.dropout(x, DROPOUT_RATE, seed)
            torch.cuda.synchronize()
            ref = D.dropout_plain(x, DROPOUT_RATE, seed)
            same = torch.equal(y.view(bits), ref.view(bits))
            err = (y.float() - ref.float()).abs().max().item()
            kept = (D.keep_scale(seed, (n, d), DROPOUT_RATE, dev) != 0
                    ).double().mean().item()
            sigma = math.sqrt(DROPOUT_RATE * (1 - DROPOUT_RATE) / (n * d))
            ok = same and abs(kept - (1 - DROPOUT_RATE)) <= 4 * sigma
            print(f"kernel dropout ({n}, {d}) {str(dtype):>14}: "
                  f"bit-identical {same}, max_abs_err {err:.3e}, kept "
                  f"{kept:.6f} (1 - rate {1 - DROPOUT_RATE}, 4 sigma "
                  f"{4 * sigma:.2e}) -> {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"dropout kernel disagrees with its plain version at "
                     f"({n}, {d}) {dtype}")
            errs.append(err)
        x = x32                                # the train step's dtype
        row = {"ms": _time_ms(lambda: D.dropout(x, DROPOUT_RATE, 1)),
               "plain_ms": _time_ms(
                   lambda: D.dropout_plain(x, DROPOUT_RATE, 1), iters=3,
                   warmup=1),
               "library_ms": _time_ms(lambda: torch.nn.functional.dropout(
                   x, DROPOUT_RATE, training=True))}
        row["bound_ms"], row["bound_by"] = _bound_ms(2 * 4 * n * d, n * d,
                                                     PEAK_FP32_FLOPS)
        _print_time("dropout", f"({n}, {d}) fp32", row, card)
        rows.append((count, row))
    rec = _record("dropout", "mmd_tpu_torch/ops/csrc/dropout.cu",
                  "mmd_tpu/ops/dropout.py:59", rows, errs,
                  "torch.nn.functional.dropout(training=True) on the same "
                  "fp32 input (its own generator and mask)")
    print(f"kernel dropout per train step ({sum(DROPOUT_GEOMS.values())} "
          f"launches, fp32): kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, F.dropout {rec['library_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def _train_geoms():
    for g in FUSION:
        yield dict(g, b=TRAIN_B, per_step=TRAIN_PER_STEP[g["name"]])


def _step_record(rows, errs, what: str, library: str, card: str) -> dict:
    """One train step's sum over the geometries' rows (_record's sums)."""
    rec = _record("", "", "", rows, errs)
    step = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err")}
    step["launches_per_step"] = sum(n for n, _ in rows)
    step["library_note"] = library
    print(f"kernel {what} per train step ({step['launches_per_step']} "
          f"launches): kernel {step['ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, library {step['library_ms']:.4f} ms, "
          f"bound {step['bound_ms']:.4f} ms  [{card}]", flush=True)
    return step


# the train step's timed cases: (dtype, rate) -> key of the step record
TRAIN_TIMINGS = {(torch.float32, DROPOUT_RATE): "train_step",
                 (torch.bfloat16, DROPOUT_RATE): "train_step_bf16",
                 (torch.float32, 0.0): "train_step_rate0",
                 (torch.bfloat16, 0.0): "train_step_bf16_rate0"}


def _peak(dtype) -> float:
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def phase_flash_train(card: str) -> dict:
    """The flash forward with attention dropout at the train step's
    geometries, batch 256; rate 0 at the same inputs too. Timed in fp32 and
    bf16 at rates 0.1 and 0, each beside SDPA on the same inputs and
    rate."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = []
    rows = {key: [] for key in TRAIN_TIMINGS.values()}
    for g in _train_geoms():
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32 = (torch.randn(b, n, d, device=dev, generator=gen)
                         for n in (t, s, s))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            for rate in (DROPOUT_RATE, 0.0):
                o, lse = A.flash_attention(q, k, v, h, None, rate, 77)
                torch.cuda.synchronize()
                o_ref, lse_ref = A.flash_attention_plain(
                    q.float(), k.float(), v.float(), h, None, rate, 77)
                err = (o.float() - o_ref).abs().max().item()
                lse_err = (lse - lse_ref).abs().max().item()
                ok = err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                print(f"kernel flash_attn_fwd {g['name']:>14} B={b} "
                      f"{str(dtype):>14} rate {rate}: max_abs_err "
                      f"{err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse err "
                      f"{lse_err:.3e} -> {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash kernel with dropout {rate} disagrees with "
                         f"its plain version at {g['name']} {dtype}")
                errs.append(err)
                del o, lse, o_ref, lse_ref
                qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                              for x in (q, k, v))
                row = {"ms": _time_ms(lambda: A.flash_attention(
                           q, k, v, h, None, rate, 1), iters=10),
                       "plain_ms": _time_ms(lambda: A.flash_attention_plain(
                           q, k, v, h, None, rate, 1), iters=2, warmup=1),
                       "library_ms": _time_ms(lambda: sdpa(
                           qh, kh, vh, dropout_p=rate), iters=10)}
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    q.element_size() * (2 * b * t * d + 2 * b * s * d)
                    + 4 * b * h * t, 4 * b * t * s * d, _peak(dtype))
                _print_time("flash_attn_fwd", f"{g['name']} "
                            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                            f" dropout {rate} B={b} T={t} S={s} D={d} H={h}",
                            row, card)
                rows[TRAIN_TIMINGS[(dtype, rate)]].append((g["per_step"],
                                                           row))
        torch.cuda.empty_cache()
    return {key: _step_record(
                rows[key], errs, f"flash_attn_fwd {key}",
                f"torch.nn.functional.scaled_dot_product_attention(dropout_p"
                f"={rate}), {'bf16' if dtype == torch.bfloat16 else 'fp32'}, "
                f"(B, H, T, dh) views", card)
            for (dtype, rate), key in TRAIN_TIMINGS.items()}


def phase_flash_rerank(card: str) -> dict:
    """#1 at the cross-encoder re-rank geometry of a text search: 50 pairs
    (top_k 5 x recall 5 x 2 corpora), T = S = 256, 12 heads of dh 32,
    padded key tails; bf16 (the served dtype) and fp32, each against its
    plain version and timed beside SDPA."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    g = RERANK
    b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
    q32, k32, v32 = (torch.randn(b, n, d, device=dev, generator=gen)
                     for n in (t, s, s))
    lengths = torch.linspace(24, s, b, device=dev).round().long()
    mask = torch.arange(s, device=dev)[None] < lengths[:, None]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        o, lse = A.flash_attention(q, k, v, h, mask)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_attention_plain(q.float(), k.float(),
                                                 v.float(), h, mask)
        err = (o.float() - o_ref).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
        print(f"kernel flash_attn_fwd {g['name']:>14} {str(dtype):>14}: "
              f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse "
              f"err {lse_err:.3e}, key lengths 24-{s} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"flash kernel disagrees with its plain version at "
                 f"{g['name']} {dtype}")
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                      for x in (q, k, v))
        am = mask[:, None, None, :]
        row = {"ms": _time_ms(lambda: A.flash_attention(q, k, v, h, mask),
                              iters=50),
               "plain_ms": _time_ms(lambda: A.flash_attention_plain(
                   q, k, v, h, mask), iters=5),
               "library_ms": _time_ms(lambda: sdpa(qh, kh, vh, attn_mask=am),
                                      iters=50)}
        row["bound_ms"], row["bound_by"] = _flash_bound_ms(
            q, k, h, mask, _peak(dtype))
        # every key, padded tails included, as the kernel walks them
        row["bound_all_keys_ms"], _ = _flash_bound_ms(q, k, h, None,
                                                       _peak(dtype))
        _print_time("flash_attn_fwd", f"{g['name']} {name} B={b} T={t} "
                    f"S={s} D={d} H={h}, {int(mask.sum())} of {b * s} keys "
                    f"valid (bound over every key "
                    f"{row['bound_all_keys_ms']:.4f} ms)", row, card)
        out[f"rerank_{name}"] = {
            **row, "max_abs_err": err,
            "launches_per_search": RERANK_PER_SEARCH,
            "library_note": "torch.nn.functional.scaled_dot_product_attention"
                            " with a boolean key mask, (B, H, T, dh) views"}
    return out


def _bwd_tol(dtype) -> float:
    """Relative to the largest |reference gradient|: fp32 summation order;
    bf16 one rounding of the output."""
    return 1e-4 if dtype == torch.float32 else 2.0 ** -7


def _masked_lengths(b: int, s: int, dev) -> torch.Tensor:
    """(B, S) int mask: valid lengths from 1 to S, and a last row with no
    valid key."""
    lengths = torch.linspace(1, s, b - 1, device=dev).round().long()
    return torch.cat([torch.arange(s, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, s, dtype=torch.bool, device=dev)]).int()


def _check_flash(A, g, q32, k32, v32, do32, mask, rates, errs) -> None:
    """Forward and backward against their plain versions in bf16 and fp32
    at each rate; the backward twice, bit for bit the same."""
    b, h = q32.shape[0], g["h"]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
        for rate in rates:
            o, lse = A.flash_attention(q, k, v, h, mask, rate, 88)
            got = A.flash_attention_bwd(q, k, v, o, lse, do, h, mask,
                                        rate, 88)
            again = A.flash_attention_bwd(q, k, v, o, lse, do, h, mask,
                                          rate, 88)
            torch.cuda.synchronize()
            o_ref, lse_ref = A.flash_attention_plain(
                q.float(), k.float(), v.float(), h, mask, rate, 88)
            want = A.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), o.float(), lse,
                do.float(), h, mask, rate, 88)
            o_err = (o.float() - o_ref).abs().max().item()
            fin = torch.isfinite(lse_ref)
            lse_err = (lse[fin] - lse_ref[fin]).abs().max().item()
            tol = _bwd_tol(dtype)
            abs_errs = [(x.float() - w).abs().max().item()
                        for x, w in zip(got, want)]
            rel = [e / max(w.abs().max().item(), 1e-30)
                   for e, w in zip(abs_errs, want)]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = (o_err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                  and torch.equal(torch.isfinite(lse), fin)
                  and max(rel) <= tol and same)
            if mask is not None:
                ok = ok and bool((o[-1] == 0).all()) and bool(
                    (got[0][-1] == 0).all())
            print(f"kernel flash_attn_bwd {g['name']:>14} B={b} "
                  f"{str(dtype):>14} rate {rate}: o err {o_err:.3e}, lse "
                  f"err {lse_err:.3e}, max_abs_err dq/dk/dv "
                  f"{abs_errs[0]:.3e}/{abs_errs[1]:.3e}/{abs_errs[2]:.3e}, "
                  f"relative {max(rel):.3e} (tol {tol:.1e}), repeat "
                  f"{'bit-identical' if same else 'DIFFERS'}"
                  f"{', row with no valid key o = dq = 0' if mask is not None else ''}"
                  f" -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash forward/backward disagrees with its plain "
                     f"version, or repeats differ, at {g['name']} {dtype} "
                     f"rate {rate}")
            errs.append(max(abs_errs))
            del o, lse, got, again, want


# ragged geometries: S not a multiple of the 64-key tile (a padded text
# batch, dh 64; and T 77, S 50 at dh 32)
RAGGED = [dict(name="ragged_100x130", b=BATCH, t=100, s=130, d=128, h=2,
               masked=True),
          dict(name="ragged_77x50", b=BATCH, t=77, s=50, d=64, h=2,
               masked=False)]


def phase_flash_bwd(card: str) -> dict:
    """dq, dk, dv against flash_attention_bwd_plain: the train step's
    geometries at batch 256 with and without dropout, the masked text
    geometry (batch 16, a row with no valid key) at rate 0, and the two
    ragged geometries at both rates (forward checked too); every backward
    twice, bit-identical. Timed in fp32 and bf16 at rates 0.1 and 0."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs = []
    rows = {key: [] for key in TRAIN_TIMINGS.values()}
    text = dict(TEXT, b=BATCH, per_step=0)
    for g in [*_train_geoms(), text, *RAGGED]:
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32, do32 = (torch.randn(b, n, d, device=dev,
                                           generator=gen)
                               for n in (t, s, s, t))
        mask = _masked_lengths(b, s, dev) if g["masked"] else None
        rates = (0.0,) if g is text else (DROPOUT_RATE, 0.0)
        _check_flash(A, g, q32, k32, v32, do32, mask, rates, errs)
        if not g.get("per_step"):
            continue
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
            qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2).detach()
                          .requires_grad_() for x in (q, k, v))
            out = sdpa(qh, kh, vh)
            gout = torch.randn_like(out)
            lib_ms = _time_ms(lambda: torch.autograd.grad(
                out, (qh, kh, vh), gout, retain_graph=True), iters=5)
            for rate in (DROPOUT_RATE, 0.0):
                o, lse = A.flash_attention(q, k, v, h, None, rate, 1)
                row = {"ms": _time_ms(lambda: A.flash_attention_bwd(
                           q, k, v, o, lse, do, h, None, rate, 1), iters=5),
                       "plain_ms": _time_ms(
                           lambda: A.flash_attention_bwd_plain(
                               q, k, v, o, lse, do, h, None, rate, 1),
                           iters=2, warmup=1),
                       "library_ms": lib_ms}
                row["bound_ms"], row["bound_by"] = _bound_ms(
                    q.element_size() * (4 * b * t * d + 4 * b * s * d)
                    + 4 * b * h * t, 10 * b * t * s * d, _peak(dtype))
                _print_time("flash_attn_bwd", f"{g['name']} "
                            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
                            f" dropout {rate} B={b} T={t} S={s} D={d} H={h}",
                            row, card)
                rows[TRAIN_TIMINGS[(dtype, rate)]].append((g["per_step"],
                                                           row))
                del o, lse
            del out, gout, qh, kh, vh
        torch.cuda.empty_cache()
    steps = {key: _step_record(
                 rows[key], errs, f"flash_attn_bwd {key}",
                 f"the backward of torch.nn.functional.scaled_dot_product_"
                 f"attention at rate 0, "
                 f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} (forward "
                 f"excluded)", card)
             for (dtype, rate), key in TRAIN_TIMINGS.items()}
    rec = _record("flash_attn_bwd", "mmd_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                  "mmd_tpu/ops/attention.py:471", rows["train_step"], errs,
                  steps["train_step"]["library_note"])
    rec.update({k: v for k, v in steps.items() if k != "train_step"})
    return rec


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max-abs error relative to the largest |want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-30)).item()


def _mlp_oracle(x, w1, b1, w2, b2, dy, m1, m2):
    """y and (dx, dw1, db1, dw2, db2) of the fused MLP in float64 from the
    dumped masks m1, m2, rounding nothing (benchmarks/validate_mlp_tpu.py,
    step 3)."""
    x, w1, b1, w2, b2, dy, m1, m2 = (t.double() for t in
                                     (x, w1, b1, w2, b2, dy, m1, m2))
    c, k = math.sqrt(2.0 / math.pi), 0.044715
    a = x @ w1 + b1
    t = torch.tanh(c * (a + k * a * a * a))
    h = 0.5 * a * (1.0 + t) * m1
    y = (h @ w2 + b2) * m2
    dy0 = dy * m2
    da = (dy0 @ w2.T) * m1 * (0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * c
                              * (1.0 + 3.0 * k * a * a))
    return y, (da @ w1.T, x.T @ da, da.sum(0), h.T @ dy0, dy0.sum(0))


def phase_mlp(card: str) -> dict:
    """Kernels #12, #3 and #4 at the bf16 train step's MLP geometries, rate
    0.1 and 0: the masks bit-identical to their plain version, the forward
    and the backward against their plain versions and against the float64
    oracle of the dumped masks, the forward and the backward twice bit for
    bit; times per train step, and #4's device time a call split by
    launch."""
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import mlp as M
    fn = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    names = ("mlp_fwd", "mlp_bwd", "mlp_masks")
    errs = {k: [] for k in names}
    rows = {k: [] for k in names}
    for (n, d, f), count in MLP_GEOMS.items():
        x = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        w1 = (torch.randn(d, f, device=dev, generator=gen)
              / math.sqrt(d)).bfloat16()
        b1 = 0.1 * torch.randn(f, device=dev, generator=gen)
        w2 = (torch.randn(f, d, device=dev, generator=gen)
              / math.sqrt(f)).bfloat16()
        b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
        dy = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        for rate in (DROPOUT_RATE, 0.0):
            seeds = M.mask_seeds(rate, 0x5EED + n)
            m1, m2 = M.mlp_masks(n, d, f, seeds, rate, dev)
            torch.cuda.synchronize()
            p1, p2 = M.mlp_masks_plain(n, d, f, seeds, rate, dev)
            same = torch.equal(m1, p1) and torch.equal(m2, p2)
            del p1, p2
            kept = [(m != 0).double().mean().item() for m in (m1, m2)]
            sigma = [math.sqrt(rate * (1 - rate) / m.numel()) for m in (m1, m2)]
            kept_ok = all(abs(k - (1 - rate)) <= 4 * s
                          for k, s in zip(kept, sigma))
            y = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
            same_fwd = torch.equal(y, M.fused_mlp_fwd(x, w1, b1, w2, b2,
                                                      seeds, rate))
            got = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
            again = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
            torch.cuda.synchronize()
            same_bwd = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            want_y = M.fused_mlp_plain(x, w1, b1, w2, b2, seeds, rate)
            want = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, seeds, rate)
            rel = [_rel(y, want_y)] + [_rel(g, w) for g, w in zip(got, want)]
            fwd_abs = (y.float() - want_y).abs().max().item()
            bwd_abs = max((g.float() - w).abs().max().item()
                          for g, w in zip(got, want))
            del want_y, want
            y64, g64 = _mlp_oracle(x, w1, b1, w2, b2, dy, m1, m2)
            orc = [_rel(y, y64)] + [_rel(g, w) for g, w in zip(got, g64)]
            del y64, g64, m1, m2
            ok = (same and same_fwd and same_bwd and kept_ok
                  and max(rel) <= MLP_TOL and max(orc) <= ORACLE_TOL)
            print(f"kernel mlp N={n} D={d} F={f} bf16 rate {rate}: masks "
                  f"bit-identical {same}, forward twice bit-identical "
                  f"{same_fwd}, backward twice bit-identical "
                  f"{same_bwd}, kept {kept[0]:.6f} / {kept[1]:.6f} "
                  f"(4 sigma {4 * sigma[0]:.1e} / {4 * sigma[1]:.1e}); vs "
                  f"plain y/dx/dw1/db1/dw2/db2 relative "
                  f"{'/'.join('%.2e' % e for e in rel)} (tol {MLP_TOL:.1e}); "
                  f"vs float64 oracle of the masks "
                  f"{'/'.join('%.2e' % e for e in orc)} (tol "
                  f"{ORACLE_TOL:.0e}) -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"fused MLP kernels disagree at N={n} rate {rate}")
            errs["mlp_fwd"].append(fwd_abs)
            errs["mlp_bwd"].append(bwd_abs)
            errs["mlp_masks"].append(0.0)
            del y, got
        # times at the train step's rate; the composition is the unfused
        # bf16 MLP: two cuBLAS GEMMs with their bias, F.gelu and kernel #5
        seeds = M.mask_seeds(DROPOUT_RATE, 1)
        w1t, w2t, b1b, b2b = (w1.T.contiguous(), w2.T.contiguous(),
                              b1.bfloat16(), b2.bfloat16())

        def composition(x_, w1t_, b1b_, w2t_, b2b_):
            h = fn.gelu(fn.linear(x_, w1t_, b1b_), approximate="tanh")
            h = fn.linear(D.dropout(h, DROPOUT_RATE, seeds[0]), w2t_, b2b_)
            return D.dropout(h, DROPOUT_RATE, seeds[1])

        leaves = [t.detach().requires_grad_()
                  for t in (x, w1t, b1b, w2t, b2b)]
        out = composition(*leaves)
        fwd = {"ms": _time_ms(lambda: M.fused_mlp_fwd(
                   x, w1, b1, w2, b2, seeds, DROPOUT_RATE), iters=10),
               "plain_ms": _time_ms(lambda: M.fused_mlp_plain(
                   x, w1, b1, w2, b2, seeds, DROPOUT_RATE), iters=2,
                   warmup=1),
               "library_ms": _time_ms(lambda: composition(
                   x, w1t, b1b, w2t, b2b), iters=10)}
        fwd["bound_ms"], fwd["bound_by"] = _bound_ms(
            2 * 2 * n * d + 2 * 2 * d * f + 4 * (f + d), 4 * n * d * f)
        bwd = {"ms": _time_ms(lambda: M.fused_mlp_bwd(
                   x, w1, b1, w2, dy, seeds, DROPOUT_RATE), iters=5),
               "plain_ms": _time_ms(lambda: M.fused_mlp_bwd_plain(
                   x, w1, b1, w2, dy, seeds, DROPOUT_RATE), iters=2,
                   warmup=1),
               "library_ms": _time_ms(lambda: torch.autograd.grad(
                   out, leaves, dy, retain_graph=True), iters=5)}
        bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
            2 * 3 * n * d + 2 * 2 * d * f + 4 * f
            + 4 * (2 * d * f + f + d), 10 * n * d * f)
        # #4's device time a call, launch by launch (torch.profiler)
        from mmd_tpu_torch import profiling
        win = profiling.profile_window(lambda: M.fused_mlp_bwd(
            x, w1, b1, w2, dy, seeds, DROPOUT_RATE), 5, {})
        split = {re.search(r"mlp_\w+_kernel", k).group(0): v * 1e3 / 5
                 for k, v in win["device_ms_top"].items()
                 if re.search(r"mlp_\w+_kernel", k)}
        print(f"split  mlp_bwd N={n} D={d} F={f} bf16 dropout "
              f"{DROPOUT_RATE}: device "
              + ", ".join(f"{k} {us:.1f} us" for k, us in split.items())
              + f"; {sum(split.values()):.1f} us a call by torch.profiler, "
              f"{1e3 * bwd['ms']:.1f} us by CUDA events  [{card}]",
              flush=True)
        masks = {"ms": _time_ms(lambda: M.mlp_masks(
                     n, d, f, seeds, DROPOUT_RATE, dev), iters=10),
                 "plain_ms": _time_ms(lambda: M.mlp_masks_plain(
                     n, d, f, seeds, DROPOUT_RATE, dev), iters=2, warmup=1),
                 "library_ms": None}
        masks["bound_ms"], masks["bound_by"] = _bound_ms(4 * n * (f + d), 0)
        for name, row in zip(names, (fwd, bwd, masks)):
            _print_time(name, f"N={n} D={d} F={f} bf16 dropout "
                        f"{DROPOUT_RATE}", row, card)
            rows[name].append((count if name != "mlp_masks" else 1, row))
        del x, w1, w2, dy, w1t, w2t, leaves, out
        torch.cuda.empty_cache()
    composition = ("not one call: the unfused bf16 composition -- F.linear "
                   "(cuBLAS, bias in its epilogue), F.gelu(approximate="
                   "'tanh'), kernel #5, F.linear, kernel #5")
    recs = {
        "mlp_fwd": _record("mlp_fwd", "mmd_tpu_torch/ops/csrc/mlp_fwd.cu",
                           "mmd_tpu/ops/mlp.py:158", rows["mlp_fwd"],
                           errs["mlp_fwd"], composition),
        "mlp_bwd": _record("mlp_bwd", "mmd_tpu_torch/ops/csrc/mlp_bwd.cu",
                           "mmd_tpu/ops/mlp.py:179", rows["mlp_bwd"],
                           errs["mlp_bwd"], "the backward of " + composition
                           + " (forward excluded)"),
        "mlp_masks": _record("mlp_masks",
                             "mmd_tpu_torch/ops/csrc/mlp_masks.cu",
                             "benchmarks/validate_mlp_tpu.py:53",
                             rows["mlp_masks"], errs["mlp_masks"],
                             "none: no PyTorch call draws these masks; "
                             "times are one dump at each geometry")}
    for name in ("mlp_fwd", "mlp_bwd"):
        r = recs[name]
        print(f"kernel {name} per bf16 train step ({MLP_PER_STEP} launches):"
              f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"unfused composition {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms  [{card}]", flush=True)
    return recs


def _rel_tol(dtype, ref: torch.Tensor) -> float:
    """A gradient's tolerance against its fp32 plain version on the same
    inputs: fp32 sums in another order, 1e-4 of its largest |value|; bf16
    outputs one rounding, a bf16 step at the largest |value|."""
    if dtype == torch.float32:
        return 1e-4 * ref.abs().max().item()
    return _bf16_step(ref)


def _check_grads(kernel, what, got, want, dtypes) -> float:
    """Each named output against its plain version; returns the worst
    absolute error, fails past a tolerance."""
    worst = 0.0
    for (name, a), w, dtype in zip(got.items(), want, dtypes):
        err = (a.float() - w).abs().max().item()
        tol = _rel_tol(dtype, w)
        print(f"kernel {kernel} {what} {name:>5}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}) -> {'ok' if err <= tol else 'FAIL'}",
              flush=True)
        if not err <= tol:
            fail(f"{kernel} {name} disagrees with its plain version, {what}")
        worst = max(worst, err)
    return worst


def phase_deberta_bwd(card: str) -> dict:
    from mmd_tpu_torch.ops import deberta_attention as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d, h = (FT_DEBERTA[k] for k in "btdh")
    q32, k32, v32, do32 = (torch.randn(b, t, d, device=dev, generator=gen)
                           for _ in range(4))
    pk32, pq32 = (torch.randn(2 * t, d, device=dev, generator=gen)
                  for _ in range(2))
    # padded tails from 1 to T valid keys, and a row with no valid key
    lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
    mask = torch.cat([torch.arange(t, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, t, dtype=torch.bool, device=dev)]).int()
    scale = 1.0 / math.sqrt(3.0 * d // h)
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        args = [x.to(dtype) for x in (q32, k32, v32, pk32, pq32)]
        do = do32.to(dtype)
        got = DA.deberta_attention_bwd(*args, mask, do, h, scale)
        again = DA.deberta_attention_bwd(*args, mask, do, h, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            fail(f"deberta_attn_bwd: two calls differ, {dtype}")
        want = DA.deberta_attention_bwd_plain(*[x.float() for x in args],
                                              mask, do.float(), h, scale)
        errs.append(_check_grads(
            "deberta_attn_bwd", f"B={b} T={t} D={d} H={h} {dtype}",
            dict(zip(("dq", "dk", "dv", "dPK", "dPQ"), got)), want,
            (dtype,) * 3 + (torch.float32,) * 2))
    args = [x.to(torch.bfloat16) for x in (q32, k32, v32, pk32, pq32)]
    do = do32.to(torch.bfloat16)
    row = {"ms": _time_ms(lambda: DA.deberta_attention_bwd(
        *args, mask, do, h, scale)),
           "plain_ms": _time_ms(lambda: DA.deberta_attention_bwd_plain(
               *args, mask, do, h, scale)),
           "library_ms": None}
    # reads q, k, v, do and both tables, writes dq, dk, dv (bf16) and the
    # tables' fp32 gradients; 20 B T^2 D operations (the TPU kernel's count)
    row["bound_ms"], row["bound_by"] = _bound_ms(
        2 * (7 * b * t * d + 2 * 2 * t * d) + 4 * 2 * 2 * t * d + b * t,
        20 * b * t * t * d)
    _print_time("deberta_attn_bwd", f"B={b} T={t} D={d} H={h} bf16", row,
                card)
    # device time a call by torch.profiler, beside the CUDA-event time
    # (which also holds the host's time where that is the larger)
    from mmd_tpu_torch import profiling
    calls = 50
    win = profiling.profile_window(lambda: DA.deberta_attention_bwd(
        *args, mask, do, h, scale), calls, {})
    device_us = {k.split("(")[1].split("::")[-1].split("<")[0]:
                 v * 1e3 / calls for k, v in win["device_ms_top"].items()
                 if "deberta_bwd" in k}
    print(f"time   deberta_attn_bwd B={b} T={t} D={d} H={h} bf16: device "
          f"{sum(device_us.values()):.3f} us a call by torch.profiler "
          f"{json.dumps(device_us)}, CUDA events {1e3 * row['ms']:.3f} us, "
          f"bound {1e3 * row['bound_ms']:.3f} us  [{card}]", flush=True)
    rec = _record("deberta_attn_bwd",
                  "mmd_tpu_torch/ops/csrc/deberta_attn_bwd.cu",
                  "mmd_tpu/models/deberta.py:464",
                  [(FT_DEBERTA["per_step"], row)], errs,
                  "no single PyTorch call computes it: the c2p and p2c "
                  "terms gather from relative-position tables per (t, s)")
    print(f"kernel deberta_attn_bwd per fine-tuning step "
          f"({FT_DEBERTA['per_step']} launches): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def _swin_train_inputs(gen, nw: int, b: int, c: int, h: int):
    """q', k, v, do (fp32) and the log2-domain bias of one window attention
    of the fine-tuning path."""
    dev, n, dh, log2e = torch.device("cuda"), 64, c // h, 1.4426950408889634

    def unit(x):
        x = x.reshape(nw, b, n, h, dh)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(nw, b, n, c)

    # q' as the model makes it: normalized, times a logit scale of 10 and
    # log2(e); k normalized; the bias a position bias in (0, 16) plus twice
    # a -100 region mask in the shifted stages, log2 domain
    q32 = unit(torch.randn(nw, b, n, c, device=dev, generator=gen)
               ) * (10 * log2e)
    k32 = unit(torch.randn(nw, b, n, c, device=dev, generator=gen))
    v32, do32 = (torch.randn(nw, b, n, c, device=dev, generator=gen)
                 for _ in range(2))
    bias = 16 * torch.rand(nw, h, n, n, device=dev, generator=gen)
    if nw > 1:
        bias = bias - 200.0 * (torch.rand(nw, 1, n, n, device=dev,
                                          generator=gen) < 0.3)
    return q32, k32, v32, do32, (bias * log2e).contiguous()


def _check_swin_train(SA, gen, nw, b, c, h, errs):
    """#8 and #9 against their plain versions at one geometry, both dtypes,
    each twice and bit-identical; returns the fp32 inputs."""
    q32, k32, v32, do32, bias = _swin_train_inputs(gen, nw, b, c, h)
    what = f"nW={nw} B={b} C={c} h={h}"
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
        o = SA.swin_window_attention_fwd(q, k, v, bias, h)
        got = SA.swin_window_attention_bwd(q, k, v, bias, do, h)
        again = SA.swin_window_attention_fwd(q, k, v, bias, h)
        got_again = SA.swin_window_attention_bwd(q, k, v, bias, do, h)
        torch.cuda.synchronize()
        if not torch.equal(o, again):
            fail(f"swin_attn_train_fwd: two calls differ, {what} {dtype}")
        for name, a, a2 in zip(("dq", "dk", "dv", "dbias"), got, got_again):
            if not torch.equal(a, a2):
                fail(f"swin_attn_train_bwd: two calls differ in {name}, "
                     f"{what} {dtype}")
        ref = SA.swin_window_attention_plain(q.float(), k.float(),
                                             v.float(), bias, h)
        errs["fwd"].append(_check_grads(
            "swin_attn_train_fwd", f"{what} {dtype}", {"o": o}, [ref],
            (dtype,)))
        want = SA.swin_window_attention_bwd_plain(
            q.float(), k.float(), v.float(), bias, do.float(), h)
        errs["bwd"].append(_check_grads(
            "swin_attn_train_bwd", f"{what} {dtype}",
            dict(zip(("dq", "dk", "dv", "dbias"), got)), want,
            (dtype,) * 3 + (torch.float32,)))
    return q32, k32, v32, do32, bias


def phase_swin_train(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(8)
    b, n = FT_DEBERTA["b"], 64
    errs = {"fwd": [], "bwd": []}
    rows = {"fwd": [], "bwd": []}
    lib_note = None
    for nw, c, h in FT_SWIN_CHECK_B7:
        _check_swin_train(SA, gen, nw, 7, c, h, errs)
    for stage, ((nw, c, h), count) in enumerate(FT_SWIN_GEOMS.items()):
        dh = c // h
        what = f"nW={nw} B={b} C={c} h={h}"
        q32, k32, v32, do32, bias = _check_swin_train(SA, gen, nw, b, c, h,
                                                      errs)
        q, k, v, do = (x.to(torch.bfloat16) for x in (q32, k32, v32, do32))
        # the library call: SDPA on (nW B, h, n, dh), exp2(x) = exp(ln2 x),
        # the bias as an additive mask in the inputs' dtype
        ln2 = math.log(2.0)
        q4, k4, v4, do4 = (x.reshape(nw, b, n, h, dh).transpose(2, 3)
                           .reshape(nw * b, h, n, dh).contiguous()
                           for x in (q, k, v, do))
        m4 = (ln2 * bias)[:, None].expand(nw, b, h, n, n).reshape(
            nw * b, h, n, n).to(torch.bfloat16).contiguous()
        fwd = {"ms": _time_ms(lambda: SA.swin_window_attention_fwd(
            q, k, v, bias, h)),
               "plain_ms": _time_ms(lambda: SA.swin_window_attention_plain(
                   q, k, v, bias, h)),
               "library_ms": _time_ms(lambda: sdpa(q4, k4, v4, attn_mask=m4,
                                                   scale=ln2))}
        bwd = {"ms": _time_ms(lambda: SA.swin_window_attention_bwd(
            q, k, v, bias, do, h)),
               "plain_ms": _time_ms(lambda: SA.swin_window_attention_bwd_plain(
                   q, k, v, bias, do, h))}
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4, m4)]
        try:
            o4 = sdpa(*leaves[:3], attn_mask=leaves[3], scale=ln2)
            bwd["library_ms"] = _time_ms(lambda: torch.autograd.grad(
                o4, leaves, do4, retain_graph=True))
        except RuntimeError as e:           # no backend gives dmask
            bwd["library_ms"] = None
            lib_note = f"SDPA's backward with a mask gradient: {e}"[:200]
        elems = nw * b * n * c
        fwd["bound_ms"], fwd["bound_by"] = _bound_ms(
            2 * 4 * elems + 4 * nw * h * n * n, 4 * nw * b * n * n * c)
        bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
            2 * 7 * elems + 2 * 4 * nw * h * n * n, 10 * nw * b * n * n * c)
        for kind, row in (("fwd", fwd), ("bwd", bwd)):
            _print_time(f"swin_attn_train_{kind}", f"{what} n={n} bf16", row,
                        card)
            rows[kind].append((count, row))
        print(f"time   swin_attn_train_fwd stage {stage} ({what}, bf16, "
              f"{count} a step): kernel {1e3 * fwd['ms']:.3f} us a call, "
              f"SDPA {1e3 * fwd['library_ms']:.3f} us, bound "
              f"{1e3 * fwd['bound_ms']:.3f} us  [{card}]", flush=True)
    recs = {}
    for kind, line in (("fwd", 211), ("bwd", 314)):
        name = f"swin_attn_train_{kind}"
        recs[name] = _record(
            name, "mmd_tpu_torch/ops/csrc/swin_window_attn_train.cu",
            f"mmd_tpu/ops/swin_attention.py:{line}", rows[kind],
            errs[kind],
            None if kind == "fwd" or lib_note is None else lib_note)
        print(f"kernel {name} per fine-tuning step "
              f"({sum(FT_SWIN_GEOMS.values())} launches): kernel "
              f"{recs[name]['ms']:.4f} ms, plain {recs[name]['plain_ms']:.4f} "
              f"ms, library {recs[name]['library_ms']}, bound "
              f"{recs[name]['bound_ms']:.4f} ms  [{card}]", flush=True)
    return recs


def _check_result(res: dict, claim_img: bool, ev_img: bool) -> None:
    want_present = {"text_text": True, "text_image": ev_img,
                    "image_text": claim_img,
                    "image_image": claim_img and ev_img}
    for path, present in want_present.items():
        if (res[path] is not None) != present:
            fail(f"path {path} came back {'empty' if present else 'filled'} "
                 f"for a request {'with' if present else 'without'} its image")
        if res[path] is None:
            continue
        probs = list(res[path]["probabilities"].values())
        if res[path]["label"] not in ("support", "not_enough_information",
                                      "refute"):
            fail(f"invalid label {res[path]['label']!r}")
        if not all(math.isfinite(p) for p in probs) or abs(sum(probs) - 1) > 1e-5:
            fail(f"probabilities {probs} are not a distribution")


def _fp32(cfg, fused: bool):
    """cfg in float32 with every kernel switch it has set to `fused`."""
    kw = {f: fused for f in ("fused_attn", "fused_ln")
          if f in {x.name for x in dataclasses.fields(cfg)}}
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _describe(phase: str, pred, setup: str) -> None:
    tc, vc, cfg = pred.enc.text_cfg, pred.enc.vit_cfg, pred.cfg
    print(f"{phase}: encoders {type(tc).__name__} {tc.num_layers}x"
          f"{tc.hidden_size} (vocab {tc.vocab_size}, {tc.compute_dtype}), "
          f"{type(vc).__name__} {vc.num_tokens}x{vc.hidden_size} tokens at "
          f"{vc.image_size} px ({vc.compute_dtype}); tokenizer "
          f"{type(pred.enc.tokenizer).__name__} (vocab "
          f"{pred.enc.tokenizer.vocab_size}); fusion {cfg.embed_dim}/"
          f"{cfg.num_heads} heads, {cfg.compute_dtype}; set-up {setup}",
          flush=True)


def _requests(texts: list[str], images: list[str], n_req: int) -> list:
    reqs = []
    for i in range(n_req):
        ci = images[i % len(images)] if i % 2 == 0 else None
        ei = images[(i * 5) % len(images)] if i % 3 != 2 else None
        reqs.append((texts[i % len(texts)], ci,
                     texts[(i * 7 + 3) % len(texts)], ei))
    return reqs


def _batch_of(reqs: list) -> tuple:
    """The first BATCH requests as evaluate_batch's four lists."""
    return tuple([r[k] for r in reqs[:BATCH]] for k in range(4))


def _drive(phase: str, card: str, pred, texts: list[str],
           images: list[str], want_per_batch: dict, n_req: int
           ) -> tuple[dict, list, float]:
    """Drive a ServingEngine at full width from several threads. Returns
    the kernel launches of the counted run by kernel, the requests, and the
    tokenizer's seconds a served batch (claims and evidence)."""
    from mmd_tpu_torch.inference.server import ServingEngine

    # warm-up batch (allocator, cuBLAS handles) outside the counted run
    pred.evaluate_batch(texts[:BATCH], (images + [None] * BATCH)[:BATCH],
                        texts[BATCH:2 * BATCH], [None] * BATCH)
    torch.cuda.synchronize()

    n_threads = 6
    reqs = _requests(texts, images, n_req)
    results: dict[int, dict] = {}
    errors: list[BaseException] = []
    lock = threading.Lock()

    _reset_counts()                       # count the main path's run only
    eng = ServingEngine(pred, max_batch=BATCH, max_wait_ms=20.0)

    def client(idx: list[int]) -> None:
        futs = [(i, eng.submit(*reqs[i], detailed=True)) for i in idx]
        for i, f in futs:
            try:
                r = f.result(timeout=600)
            except BaseException as e:  # reported below, never dropped
                with lock:
                    errors.append(e)
                continue
            with lock:
                results[i] = r

    threads = [threading.Thread(target=client,
                                args=(list(range(j, n_req, n_threads)),))
               for j in range(n_threads)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
    finally:
        eng.close()
    torch.cuda.synchronize()
    launches = _counts()
    st = eng.stats()
    if errors:
        fail(f"{phase}: {len(errors)} requests failed: {errors[0]!r}")
    if any(th.is_alive() for th in threads) or len(results) != n_req:
        fail(f"{phase}: {n_req - len(results)} requests never resolved")
    for i, (_, ci, _, ei) in enumerate(reqs):
        _check_result(results[i], ci is not None, ei is not None)
    want = {name: want_per_batch.get(name, 0) * st["batches"]
            for name in launches}
    print(f"{phase}: {st['served']} requests in {st['batches']} batches "
          f"(mean fill {st['mean_batch_fill']:.2f}), latency p50 "
          f"{st['latency_p50_ms']:.2f} ms, p95 {st['latency_p95_ms']:.2f} "
          f"ms, kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})  [{card}]", flush=True)
    tokenize_s = st["stages_s"].get("tokenize_s", 0.0) / st["batches"]
    print(f"{phase}: stage seconds {json.dumps(st['stages_s'])}; tokenize "
          f"{tokenize_s:.4f} s a batch ({type(pred.enc.tokenizer).__name__}"
          f", claims and evidence, {BATCH} each)  [{card}]", flush=True)
    if launches != want:
        fail(f"{phase}: launches {launches} for {st['batches']} batches; the "
             f"path should launch {want}")
    return launches, reqs, tokenize_s


def serve(phase: str, card: str, tmp: Path, texts: list[str],
          images: list[str], want_per_batch: dict, n_req: int,
          reference_families: bool) -> tuple[dict, float]:
    """Seeded encoders served through a ServingEngine; returns the kernel
    launches of the counted run by kernel and the tokenizer's seconds a
    batch."""
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models.frozen import load_or_init_frozen

    t0 = time.perf_counter()
    enc = load_or_init_frozen(tmp / f"assets_{phase}", vocab_texts=texts,
                              vocab_size=30000, seed=0,
                              reference_families=reference_families)
    cfg = ModelConfig(fused_attn=True)
    pred = MisinformationPredictor(cfg, encoders=enc, max_length=512,
                                   batch_size=BATCH, device="cuda")
    _describe(phase, pred, f"{time.perf_counter() - t0:.1f} s")
    launches, reqs, tokenize_s = _drive(phase, card, pred, texts, images,
                                        want_per_batch, n_req)

    # one fp32 batch through the kernel path and the explicit path, same
    # params: the served probabilities must agree
    def fp32_predictor(fused: bool):
        e = dataclasses.replace(enc, text_cfg=_fp32(enc.text_cfg, fused),
                                vit_cfg=_fp32(enc.vit_cfg, fused))
        return MisinformationPredictor(
            _fp32(cfg, fused), fusion_params=pred.params.state_dict(),
            encoders=e, max_length=512, batch_size=BATCH, device="cuda")

    batch = _batch_of(reqs)
    got = fp32_predictor(True).evaluate_batch(*batch, detailed=True)
    ref = fp32_predictor(False).evaluate_batch(*batch, detailed=True)
    diff = max(abs(g[p]["probabilities"][c] - r[p]["probabilities"][c])
               for g, r in zip(got, ref) for p in g if g[p] is not None
               for c in g[p]["probabilities"])
    print(f"{phase}: fp32 kernel path vs explicit path, max probability "
          f"difference {diff:.3e} (tol {PROB_TOL:.0e})", flush=True)
    if not diff <= PROB_TOL:
        fail(f"{phase}: the kernel path disagrees with the explicit path")
    return launches, tokenize_s


def _spm_pieces(texts: list[str]) -> list:
    """A DeBERTa-convention unigram vocabulary from the corpus, built as
    tests/test_spm.py builds its vocabularies: [PAD], [CLS], [SEP], [UNK]
    at 0-3, then the metaspace, every character, and the corpus's words,
    every other one with the metaspace in front, at seeded scores."""
    from mmd_tpu_torch.data.spm import CONTROL, METASPACE, NORMAL, UNKNOWN

    rng = np.random.default_rng(CONVERTED_SEEDS["spm"])
    words = sorted({w for t in texts for w in t.split()})
    chars = sorted({c for t in texts for c in t if not c.isspace()})
    pieces = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL),
              ("[SEP]", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN)]
    for tok in ([METASPACE] + chars + [METASPACE + w for w in words[::2]]
                + words[1::2]):
        pieces.append((tok, float(-1.0 - 12.0 * rng.random()), NORMAL))
    return pieces


def phase_serve_converted(card: str, tmp: Path, texts: list[str],
                          images: list[str], wordpiece_s: float) -> dict:
    """Serve a trained model from files: converted DeBERTa-v3-xsmall and
    Swinv2-base assets and an spm.json, written through convert_hf's
    writer, and a fusion best_model.pt, all from seeds; returns the kernel
    launches of the counted run by kernel."""
    from mmd_tpu_torch.convert_hf import write_asset
    from mmd_tpu_torch.core.checkpoint import save_params
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.data.spm import UnigramTokenizer
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models import deberta as D
    from mmd_tpu_torch.models import swin as SW
    from mmd_tpu_torch.models.frozen import FrozenEncoders
    from mmd_tpu_torch.models.fusion import init_fusion_params

    phase = "serve_converted"
    t0 = time.perf_counter()
    assets, run = tmp / "assets_converted", tmp / "run_converted"
    assets.mkdir()
    text_cfg = D.config_from_hf(DEBERTA_V3_XSMALL_HF)
    image_cfg = SW.config_from_hf(SWINV2_BASE_HF)
    text = D.init_deberta(
        torch.Generator().manual_seed(CONVERTED_SEEDS["deberta"]), text_cfg)
    image = SW.init_swin(
        torch.Generator().manual_seed(CONVERTED_SEEDS["swinv2"]), image_cfg)
    write_asset(assets, "deberta", text, text_cfg)
    write_asset(assets, "swinv2", image, image_cfg)
    tokenizer = UnigramTokenizer(_spm_pieces(texts))
    tokenizer.save(assets / "spm.json")
    cfg = ModelConfig(fused_attn=True)
    fusion = init_fusion_params(
        torch.Generator().manual_seed(CONVERTED_SEEDS["fusion"]), cfg)
    save_params(str(run / "best_model.pt"), fusion)
    t1 = time.perf_counter()
    pred = MisinformationPredictor(
        cfg, checkpoint_path=str(run / "best_model.pt"),
        assets_dir=str(assets), max_length=512, batch_size=BATCH,
        device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if (pred.enc.text_cfg != text_cfg or pred.enc.vit_cfg != image_cfg
            or not isinstance(pred.enc.tokenizer, UnigramTokenizer)):
        fail(f"{phase}: the assets resolved to {pred.enc.text_cfg}, "
             f"{pred.enc.vit_cfg}, {type(pred.enc.tokenizer).__name__}")
    _describe(phase, pred, f"{t2 - t0:.3f} s (write {t1 - t0:.3f} s, load "
                           f"{t2 - t1:.3f} s)  [{card}]")
    launches, reqs, tokenize_s = _drive(phase, card, pred, texts, images,
                                        REFERENCE_PER_BATCH,
                                        CONVERTED_REQUESTS)
    print(f"{phase}: tokenize {tokenize_s:.4f} s a batch (UnigramTokenizer, "
          f"pure Python) against {wordpiece_s:.4f} s (WordPieceTokenizer, "
          f"serve_reference)  [{card}]", flush=True)

    # the same batch through a predictor built in memory from the same
    # modules, tokenizer and fusion params: bit-identical probabilities;
    # the seeded head (seed 0) must give others
    batch = _batch_of(reqs)
    mem = MisinformationPredictor(
        cfg, fusion_params=fusion.state_dict(),
        encoders=FrozenEncoders(tokenizer, text_cfg, text, image_cfg, image),
        max_length=512, batch_size=BATCH, device="cuda")
    seeded = MisinformationPredictor(cfg, encoders=pred.enc, max_length=512,
                                     batch_size=BATCH, device="cuda")
    got, want, other = (p.evaluate_batch(*batch, detailed=True)
                        for p in (pred, mem, seeded))

    def probs(results):
        return [[None if r[p] is None else list(r[p]["probabilities"].values())
                 for p in r] for r in results]

    same = probs(got) == probs(want)
    moved = probs(got) != probs(other)
    print(f"{phase}: {BATCH} pairs from files vs in memory, bit-identical "
          f"probabilities: {same}; the loaded head moved them from the "
          f"seeded head's: {moved}", flush=True)
    if not same:
        fail(f"{phase}: the predictor built from files disagrees with the "
             f"one built in memory")
    if not moved:
        fail(f"{phase}: best_model.pt did not change the served output")
    print(f"{phase}: phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_train(card: str, tmp: Path, phase: str, per_step: dict,
                dtype_args: list) -> dict:
    """python -m mmd_tpu_torch.train's main path at full width, with
    `dtype_args` (none: the default bf16): returns the kernel launches of
    the counted run, which must be `per_step` a step."""
    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.training.loop import run_training

    out = tmp / phase
    argv = ["--device", "cuda", "--synthetic_samples",
            str(TRAIN_STEPS * TRAIN_B), "--batch_size", str(TRAIN_B),
            "--epochs", "1", *dtype_args, "--fused_attn",
            "--dropout", str(DROPOUT_RATE), "--log_every", "1",
            "--save_every", "4", "--validate_every_epoch",
            "--output_dir", str(out)]
    t0 = time.perf_counter()
    args = TR.parse_args(argv)
    cfg, trainer, train_batches, val_batches = TR.build(args)
    n_val = len(list(val_batches()))
    m = cfg.model
    print(f"{phase}: fusion {m.embed_dim} wide, {m.num_heads} heads, hidden "
          f"{m.hidden_dim}, text {m.text_input_dim} x 512, image "
          f"{m.image_input_dim} x 64, batch {cfg.batch_size}, "
          f"{m.compute_dtype}, fused_attn={m.fused_attn}, dropout "
          f"{m.dropout}; {TRAIN_STEPS} steps, {n_val} validation batches; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                       # count the main path's run only
    t0 = time.perf_counter()
    state = run_training(trainer, train_batches, val_batches)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    want["flash_attn_fwd"] += FUSION_PER_BATCH * n_val
    print(f"{phase}: {state.step} steps + {n_val} validation batches in "
          f"{run_s:.2f} s, kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})  [{card}]", flush=True)
    if launches != want:
        fail(f"{phase}: launches {launches}; the path should launch {want}")

    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/total_loss"] for r in recs if "train/total_loss" in r]
    val = [r for r in recs if "val/loss" in r]
    print(f"{phase}: loss by step {json.dumps(losses)}; validation loss "
          f"{val[0]['val/loss'] if val else None}, avg_f1 "
          f"{val[0].get('val/avg_f1') if val else None}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{phase}: losses {losses}")
    if len(val) != 1 or not math.isfinite(val[0]["val/loss"]):
        fail(f"{phase}: validation records {val}")
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    want_ckpts = sorted({f"step_{i}.pt" for i in range(4, TRAIN_STEPS + 1, 4)}
                        | {f"step_{TRAIN_STEPS}.pt"})
    if ckpts != want_ckpts:
        fail(f"{phase}: checkpoints {ckpts}, want {want_ckpts}")
    init = trainer.init().params.state_dict()
    moved = [k for k, x in state.params.state_dict().items()
             if not torch.equal(x, init[k])]
    if len(moved) < len(init) // 2:
        fail(f"{phase}: only {len(moved)} of {len(init)} params moved")

    batch = trainer.shard_batch(next(iter(train_batches(0))))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"{phase}: wall per step after torch.cuda.synchronize() "
          f"{json.dumps([round(x, 3) for x in times])} ms; "
          f"{len(moved)} of {len(init)} params moved; checkpoints {ckpts}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{card}]", flush=True)
    return launches


def phase_train_parity(card: str) -> None:
    """One fp32 step with dropout on, fused and explicit attention, one
    seed: the same masks, so the same step."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    batch = synthetic_preembed_batch(np.random.default_rng(1), BATCH)
    out = {}
    for fused in (True, False):
        cfg = TrainConfig(model=ModelConfig(compute_dtype="float32",
                                            fused_attn=fused,
                                            dropout=DROPOUT_RATE),
                          batch_size=BATCH)
        tr = Trainer(cfg, device="cuda")
        state = tr.init()
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        out[fused] = (float(aux["loss"]),
                      {n: p.grad.detach().clone()
                       for n, p in state.params.named_parameters()})
        del tr, state
    (lf, gf), (le, ge) = out[True], out[False]
    loss_rel = abs(lf - le) / abs(le)
    worst, where = _grad_gap(gf, ge)
    ok = loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL
    print(f"train_parity: batch {BATCH}, fp32, dropout {DROPOUT_RATE}: loss "
          f"fused {lf:.7f} explicit {le:.7f}, relative {loss_rel:.3e} (tol "
          f"{PARITY_LOSS_RTOL:.0e}); worst grad leaf {where} at "
          f"{worst:.3e} of its scale (tol {PARITY_GRAD_RTOL:.0e}) -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail("train_parity: the kernel path and the explicit path disagree")


def _grad_gap(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max-abs gap relative to its largest |want|, no leaf
    held to less than PARITY_FLOOR of the model's largest gradient."""
    top = max(w.abs().max().item() for w in want.values())
    worst, where = 0.0, None
    for n, w in want.items():
        scale = max(w.abs().max().item(), PARITY_FLOOR * top)
        r = (got[n] - w).abs().max().item() / scale
        if r > worst:
            worst, where = r, n
    return worst, where


def phase_train_parity_bf16(card: str) -> None:
    """One bf16 step with dropout on at batch 16 and full width, through the
    fused MLP kernels and through the unfused MLP, one seed: the same
    masks, so the same step up to bf16 rounding. The fused path with a
    wrong step seed must then fail the same check."""
    from unittest import mock

    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.models import layers as L
    from mmd_tpu_torch.ops import mlp as M
    from mmd_tpu_torch.training.trainer import Trainer

    batch = synthetic_preembed_batch(np.random.default_rng(1), BATCH)
    cfg = TrainConfig(model=ModelConfig(fused_attn=True,
                                        dropout=DROPOUT_RATE),
                      batch_size=BATCH)

    def step(fused: bool, seed_shift: int = 0, dtype: str = "bfloat16"):
        tr = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype)), device="cuda")
        state = tr.init()
        state.seed += seed_shift
        was = (M.launches, M.bwd_launches)
        with mock.patch.object(L, "needs_fused_mlp",
                               L.needs_fused_mlp if fused
                               else lambda *a: False):
            state, aux = tr.train_step(state, tr.shard_batch(batch))
        torch.cuda.synchronize()
        launched = (M.launches - was[0], M.bwd_launches - was[1])
        want = (MLP_PER_STEP,) * 2 if fused and dtype == "bfloat16" \
            else (0, 0)
        if launched != want:
            fail(f"train_parity_bf16: the {'fused' if fused else 'unfused'}"
                 f" step launched {launched} MLP kernels, want {want}")
        return float(aux["loss"]), {n: p.grad.detach().float().clone()
                                    for n, p in
                                    state.params.named_parameters()}

    def l2_gap(got: dict, want: dict) -> float:
        """|got - want| / |want| over all leaves as one vector."""
        return math.sqrt(
            sum((got[n] - w).double().square().sum().item()
                for n, w in want.items())
            / sum(w.double().square().sum().item() for w in want.values()))

    le, ge = step(False)
    # the fp32 step on the same masks, to show the size of bf16's rounding
    l32, g32 = step(False, dtype="float32")
    results = {}
    for name, shift in (("fused", 0), ("fused, wrong seed", 1)):
        lf, gf = step(True, shift)
        loss_rel = abs(lf - le) / abs(le)
        grad_rel = l2_gap(gf, ge)
        worst, where = _grad_gap(gf, ge)
        if not shift:
            print(f"train_parity_bf16: against the fp32 step ({l32:.7f}): "
                  f"gradient L2 gap {l2_gap(gf, g32):.3e} fused, "
                  f"{l2_gap(ge, g32):.3e} unfused", flush=True)
        ok = (loss_rel <= PARITY_BF16_LOSS_RTOL
              and grad_rel <= PARITY_BF16_GRAD_RTOL)
        results[name] = ok
        print(f"train_parity_bf16: batch {BATCH}, bf16, dropout "
              f"{DROPOUT_RATE}: loss {name} {lf:.7f} unfused {le:.7f}, "
              f"relative {loss_rel:.3e} (tol {PARITY_BF16_LOSS_RTOL:.0e}); "
              f"gradient L2 gap {grad_rel:.3e} of its norm (tol "
              f"{PARITY_BF16_GRAD_RTOL:.0e}); worst leaf {where} at "
              f"{worst:.3e} of its scale -> {'ok' if ok else 'FAIL'}  "
              f"[{card}]", flush=True)
    if not results["fused"]:
        fail("train_parity_bf16: the fused and the unfused MLP disagree")
    if results["fused, wrong seed"]:
        fail("train_parity_bf16: a wrong seed passed the check, which "
             "therefore shows nothing")


def phase_finetune_reference(card: str, tmp: Path) -> dict:
    """FT_STEPS steps of the reference fine-tuning configuration through
    Trainer(finetune=True): returns the kernel launches of the run, which
    must be FT_PER_STEP a step."""
    from mmd_tpu_torch.profile_train import (FT_BATCH, FT_SEQ, raw_batch,
                                             reference_encoders,
                                             reference_finetune)

    t0 = time.perf_counter()
    enc = reference_encoders(tmp / "ft_assets")
    trainer = reference_finetune(enc)
    state = trainer.init()
    tc, vc, m = enc.text_cfg, enc.vit_cfg, trainer.cfg.model
    print(f"finetune_reference: DeBERTa-v3-xsmall ({tc.num_layers} layers, "
          f"D {tc.hidden_size}, {tc.num_heads} heads, {tc.compute_dtype}, "
          f"fused_train={tc.fused_train}) + Swinv2-base (depths {vc.depths}, "
          f"C {vc.embed_dim}..{vc.hidden_size}, window {vc.window_size}, "
          f"{vc.compute_dtype}, fused_train={vc.fused_train}); fusion "
          f"{m.embed_dim} wide, {m.compute_dtype}, dropout {m.dropout}; "
          f"batch {FT_BATCH}, {FT_SEQ} tokens, {vc.image_size} px; "
          f"{sum(p.numel() for p in state.params.parameters())} params; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    batches = [raw_batch(rng, FT_BATCH, FT_SEQ, tc.vocab_size, vc.image_size)
               for _ in range(FT_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                       # count the main path's run only
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, aux = trainer.train_step(state, trainer.shard_batch(batch))
        losses.append(float(aux["loss"]))  # synchronizes
        times.append(1e3 * (time.perf_counter() - t0))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update({k: v * FT_STEPS for k, v in FT_PER_STEP.items()})
    print(f"finetune_reference: {state.step} steps, kernel launches "
          f"{json.dumps(launches)} (want {json.dumps(want)})  [{card}]",
          flush=True)
    if launches != want:
        fail(f"finetune_reference: launches {launches}; the path should "
             f"launch {want}")
    print(f"finetune_reference: loss by step {json.dumps(losses)}; wall per "
          f"step {json.dumps([round(x, 3) for x in times])} ms (median "
          f"{sorted(times)[len(times) // 2]:.3f}); peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)  "
          f"[{card}]", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"finetune_reference: losses {losses}")
    return launches


def phase_finetune_parity(card: str, tmp: Path) -> None:
    """One fp32 step at batch 2, dropout 0, of the reference fine-tuning
    configuration through the kernels and through both encoders' explicit
    paths: the same step up to the order of fp32 sums."""
    from mmd_tpu_torch.profile_train import (FT_SEQ, raw_batch,
                                             reference_encoders,
                                             reference_finetune)

    enc = reference_encoders(tmp / "parity_assets")
    batch = raw_batch(np.random.default_rng(6), 2, FT_SEQ,
                      enc.text_cfg.vocab_size, enc.vit_cfg.image_size)
    out = {}
    for kernels in (True, False):
        fp32 = dict(compute_dtype="float32", fused_attn=kernels)
        variant = dataclasses.replace(
            enc, text_cfg=dataclasses.replace(enc.text_cfg, **fp32),
            vit_cfg=dataclasses.replace(enc.vit_cfg, **fp32))
        trainer = reference_finetune(variant, batch_size=2,
                                     compute_dtype="float32", dropout=0.0)
        state = trainer.init()
        was = _counts()
        state, aux = trainer.train_step(state, trainer.shard_batch(batch))
        torch.cuda.synchronize()
        ran = {k: v - was[k] for k, v in _counts().items()
               if k.startswith(("deberta", "swin")) and v != was[k]}
        print(f"finetune_parity: {'kernels' if kernels else 'explicit'} "
              f"path launched {json.dumps(ran)}", flush=True)
        if bool(ran) != kernels or (kernels and len(ran) != 4):
            fail(f"finetune_parity: the {'kernel' if kernels else 'explicit'}"
                 f" path launched {ran}")
        out[kernels] = (float(aux["loss"]), {
            tree: [p.grad.detach().double().clone()
                   for p in state.params[tree].parameters()]
            for tree in ("fusion", "text", "vit")})
        del trainer, state
    (lk, gk), (le, ge) = out[True], out[False]
    loss_rel = abs(lk - le) / abs(le)
    gaps = {tree: math.sqrt(
        sum((a - w).square().sum().item() for a, w in zip(gk[tree], ge[tree]))
        / sum(w.square().sum().item() for w in ge[tree])) for tree in gk}
    ok = (loss_rel <= FT_PARITY_LOSS_RTOL
          and max(gaps.values()) <= FT_PARITY_GRAD_RTOL)
    print(f"finetune_parity: batch 2, fp32, dropout 0: loss kernels "
          f"{lk:.7f} explicit {le:.7f}, relative {loss_rel:.3e} (tol "
          f"{FT_PARITY_LOSS_RTOL:.0e}); gradient L2 gap by tree "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})} "
          f"(tol {FT_PARITY_GRAD_RTOL:.0e}) -> {'ok' if ok else 'FAIL'}  "
          f"[{card}]", flush=True)
    if not ok:
        fail("finetune_parity: the kernel path and the explicit path "
             "disagree")


def phase_train_raw(card: str, tmp: Path) -> dict:
    """The raw path of python -m mmd_tpu_torch.train on a synthetic Factify
    tree, frozen and then --finetune_encoders, with the default encoder
    families: returns the kernel launches of both runs."""
    import os

    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv

    root = tmp / "factify"
    t0 = time.perf_counter()
    synthetic_factify_tree(root, n_train=64, n_test=8, image_size=256)
    csv = preprocess_csv("train", root)
    print(f"train_raw: tree and preprocessed csv in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cwd = os.getcwd()
    os.environ["MMD_TPU_ROOT"] = str(root)
    os.chdir(root)                   # the encoders' assets land in the tree
    total = {}
    try:
        for name, extra, per_step in (
                ("frozen", [], RAW_FROZEN_PER_STEP),
                ("finetune", ["--finetune_encoders"], RAW_FINETUNE_PER_STEP)):
            out = root / f"run_{name}"
            argv = ["--device", "cuda", "--train_data", str(csv),
                    "--batch_size", "8", "--epochs", "2", "--fused_attn",
                    "--log_every", "1", "--output_dir", str(out), *extra]
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            state = TR.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _counts()
            want = {k: 0 for k in launches}
            want.update({k: v * state.step for k, v in per_step.items()})
            recs = [json.loads(x) for x in
                    (out / "metrics.jsonl").read_text().splitlines()]
            losses = [r["train/total_loss"] for r in recs
                      if "train/total_loss" in r]
            print(f"train_raw {name}: {state.step} steps in {run_s:.1f} s "
                  f"(raw store, encoders and checkpoint included); loss by "
                  f"step {json.dumps(losses)}; launches "
                  f"{json.dumps(launches)} (want {json.dumps(want)})  "
                  f"[{card}]", flush=True)
            if launches != want:
                fail(f"train_raw {name}: launches {launches}, want {want}")
            if len(losses) != state.step or state.step < 2 or not all(
                    map(math.isfinite, losses)):
                fail(f"train_raw {name}: losses {losses}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    finally:
        os.chdir(cwd)
        del os.environ["MMD_TPU_ROOT"]
    return total


class _StageClock:
    """Exclusive host seconds by stage of wrapped bound methods: a call
    made inside another wrapped call counts for its own stage only.
    `sync` methods end in torch.cuda.synchronize(), so a stage that only
    enqueues work is charged for it."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._stack: list[float] = []

    def wrap(self, obj, name: str, stage: str, sync: bool = False) -> None:
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            finally:
                spent = time.perf_counter() - t0
                inner = self._stack.pop()
                self.seconds[stage] = (self.seconds.get(stage, 0.0) + spent
                                       - inner)
                if self._stack:
                    self._stack[-1] += spent
            return out

        setattr(obj, name, timed)


def _mpnet_tokenizer(texts: list[str]):
    """A WordPiece vocabulary of the traffic corpus laid out as convert_hf
    lays out MPNet's: [CLS] [PAD] [SEP] [UNK] at ids 0-3 (MPNet's <s>
    <pad> </s> <unk>) and [MASK] last, so that the pad id is
    BI_ENCODER_BASE's pad_token_id, 1."""
    from mmd_tpu_torch.data.tokenizer import (
        SPECIALS, WordPieceTokenizer, train_wordpiece,
    )
    words = [w for w in train_wordpiece(texts, 30000) if w not in SPECIALS]
    return WordPieceTokenizer(["[CLS]", "[PAD]", "[SEP]", "[UNK]"] + words
                              + ["[MASK]"])


def _write_jpegs(d: Path, rng: np.random.Generator, n: int) -> list[str]:
    """n distinct smooth 256-px JPEGs (three sinusoids of seeded
    frequency and phase a picture) under d."""
    from PIL import Image
    d.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    paths = []
    for i in range(n):
        f = rng.uniform(0.5, 6.0, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([np.sin(2 * np.pi * (a * xx + b * yy) + p)
                        for (a, b), p in zip(f, ph)], -1)
        paths.append(str(d / f"{i}_evidence.jpg"))
        Image.fromarray(((img * 0.5 + 0.5) * 255).astype(np.uint8)).save(
            paths[-1], quality=90)
    return paths


def _write_rows(d: Path, rows: np.ndarray, ids: list[str]) -> None:
    """A text corpus store (TextCorpus.encode_corpus's layout)."""
    from mmd_tpu_torch.data.store import ArrayStoreWriter
    w = ArrayStoreWriter(d, capacity=len(rows),
                         columns={"embeddings": ((rows.shape[1],),
                                                 np.float16)})
    w.append_batch({"embeddings": rows.astype(np.float16)})
    w.finalize()
    (d / "ids.json").write_text(json.dumps(ids))


def _seeded_rows(rng: np.random.Generator, like: np.ndarray, n: int
                 ) -> np.ndarray:
    """n Gaussian rows at the encoded rows' per-dimension scale."""
    scale = like.astype(np.float32).std(axis=0) + 1e-3
    return (rng.standard_normal((n, like.shape[1])) * scale).astype(
        np.float32)


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def _score_us(fn, iters: int = 50) -> float:
    return 1e3 * _time_ms(fn, iters=iters, warmup=5)


def phase_retrieval(card: str, tmp: Path) -> dict:
    """Evidence retrieval at full width and Factify-2's corpus sizes, as a
    user runs it: build (TextCorpus.encode_corpus with the MPNet
    bi-encoder, ImageCorpus.create_feature_corpus with ResNet50, a corrupt
    file skipped), the three corpora written at their full row counts,
    then 32 text searches (SemanticSearch: both corpora, the MiniLM
    re-rank through #1) and 32 image searches (retrieve_similar_images);
    checks (a)-(f). Returns the kernel launches of build and serve."""
    from mmd_tpu_torch.inference.traffic import corpus as traffic_corpus
    from mmd_tpu_torch.models import text_encoder as te
    from mmd_tpu_torch.models.resnet import ResNetConfig, init_resnet
    from mmd_tpu_torch.ops import topk as T
    from mmd_tpu_torch.retrieval.image import ImageCorpus
    from mmd_tpu_torch.retrieval.text import SemanticSearch, TextCorpus

    phase = "retrieval"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    texts = traffic_corpus(rng, RETRIEVAL_TEXTS)
    tok = _mpnet_tokenizer(texts)
    bi_cfg, cross_cfg = te.BI_ENCODER_BASE, te.CROSS_ENCODER_MINI
    bi = te.init_text_encoder(torch.Generator().manual_seed(11), bi_cfg)
    cross = te.init_cross_encoder(torch.Generator().manual_seed(12),
                                  cross_cfg, pooler=True)
    rcfg = ResNetConfig()
    resnet = init_resnet(torch.Generator().manual_seed(7), rcfg)
    root = tmp / phase
    print(f"{phase}: bi-encoder MPNet {bi_cfg.num_layers}x"
          f"{bi_cfg.hidden_size}, {bi_cfg.num_heads} heads, relative "
          f"bias {bi_cfg.relative_bias_buckets} buckets, "
          f"{bi_cfg.compute_dtype}; cross-encoder {cross_cfg.num_layers}x"
          f"{cross_cfg.hidden_size}, {cross_cfg.num_heads} heads (dh "
          f"{cross_cfg.head_dim}), {cross_cfg.compute_dtype}; ResNet50 "
          f"{rcfg.feature_dim}-d; tokenizer {tok.vocab_size} "
          f"pieces (pad id {tok.pad_id})", flush=True)

    torch.cuda.synchronize()
    _reset_counts()                       # count the main path's run only
    # -- build ---------------------------------------------------------------
    enc = TextCorpus(root / "encoded", tok, cfg=bi_cfg, params=bi,
                     device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_enc = enc.encode_corpus(texts, [f"enc_{i}" for i in range(len(texts))],
                              batch_size=64)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    paths = _write_jpegs(root / "images", rng, RETRIEVAL_IMAGES)
    corrupt = root / "images" / "corrupt_evidence.jpg"
    corrupt.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    img_build = ImageCorpus(root / "image_build", resnet_params=resnet,
                            cfg=rcfg, device="cuda")
    t0 = time.perf_counter()
    n_img = img_build.create_feature_corpus(
        paths[:RETRIEVAL_IMAGES // 2] + [str(corrupt)]
        + paths[RETRIEVAL_IMAGES // 2:], batch_size=64)
    torch.cuda.synchronize()
    img_s = time.perf_counter() - t0
    print(f"{phase}: build: {n_enc} texts encoded in {enc_s:.3f} s "
          f"({n_enc / enc_s:.1f} rows/s, batch 64, 512 tokens, peak "
          f"{enc_peak:.3f} GiB); {n_img} of {RETRIEVAL_IMAGES + 1} images in "
          f"{img_s:.3f} s ({n_img / img_s:.1f} images/s, batch 64), "
          f"{RETRIEVAL_IMAGES + 1 - n_img} skipped  [{card}]", flush=True)
    if n_enc != RETRIEVAL_TEXTS or n_img != RETRIEVAL_IMAGES:
        fail(f"{phase}: built {n_enc} texts and {n_img} images; want "
             f"{RETRIEVAL_TEXTS} and {RETRIEVAL_IMAGES} (exactly 1 skipped)")

    # the corpora at their full row counts: built rows first, then seeded
    from mmd_tpu_torch.data.store import ArrayStore
    emb = ArrayStore(enc.dir).col("embeddings")
    feats = ArrayStore(img_build.dir).col("features")
    split = RETRIEVAL_TRAIN_TEXTS
    built = {"text_train": (emb[:split], [f"train_{i}" for i in range(split)]),
             "text_test": (emb[split:], [f"test_{i}" for i in
                                         range(RETRIEVAL_TEXTS - split)]),
             "image_corpus": (feats, json.loads(
                 (img_build.dir / "ids.json").read_text()))}
    lookup = {}
    for name, (rows, ids) in built.items():
        n = RETRIEVAL_ROWS[name]
        prefix = name.split("_")[-1]
        extra = _seeded_rows(rng, rows, n - len(rows))
        all_ids = ids + [f"{prefix}_seeded_{i}" for i in range(len(ids), n)]
        all_rows = np.concatenate([rows.astype(np.float32), extra])
        if name == "image_corpus":
            # (c): a later twin of a seeded row
            all_rows[TWIN[1]] = all_rows[TWIN[0]]
            all_ids[TWIN[1]] = "twin"
            ImageCorpus(root / name, resnet_params=resnet, cfg=rcfg,
                        device="cuda").write_feature_corpus(all_rows, all_ids)
        else:
            _write_rows(root / name, all_rows, all_ids)
            lookup.update({i: texts[(j + (0 if name == "text_train" else
                                          split)) % len(texts)]
                           for j, i in enumerate(all_ids)})

    # -- serve ---------------------------------------------------------------
    train = TextCorpus(root / "text_train", tok, cfg=bi_cfg, params=bi,
                       device="cuda")
    test = TextCorpus(root / "text_test", tok, cfg=bi_cfg, params=bi,
                      device="cuda")
    images = ImageCorpus(root / "image_corpus", resnet_params=resnet,
                         cfg=rcfg, device="cuda")
    search = SemanticSearch(train, [train, test],
                            cross_encoder_params=cross, cross_cfg=cross_cfg,
                            evidence_lookup=lookup)
    t0 = time.perf_counter()
    for c in (train, test):
        c.load()
    images._load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sizes = {"text_train": train._emb, "text_test": test._emb,
             "image_corpus": images._features}
    print(f"{phase}: corpora loaded in {load_s:.3f} s: " + ", ".join(
        f"{k} {tuple(v.shape)} {v.numel() * v.element_size() / 1e6:.3f} MB "
        f"bf16" for k, v in sizes.items()) + f"  [{card}]", flush=True)

    clock = _StageClock()
    clock.wrap(tok, "encode_batch", "tokenize")
    clock.wrap(train, "encode_texts", "encode")
    for c in (train, test):
        clock.wrap(c, "topk", "score", sync=True)
    clock.wrap(search, "_cross_scores", "rerank")
    queries = ([texts[i] for i in range(0, RETRIEVAL_TEXTS, 64)]
               + traffic_corpus(rng, RETRIEVAL_SEARCHES // 2))
    from mmd_tpu_torch.ops import attention as A
    text_lat, text_res = [], []
    search.search(queries[0], RETRIEVAL_TOP_K, RETRIEVAL_RECALL)  # warm-up
    clock.seconds.clear()
    warm_launches = A.launches
    for q in queries:
        before = A.launches
        t0 = time.perf_counter()
        text_res.append(search.search(q, RETRIEVAL_TOP_K, RETRIEVAL_RECALL))
        text_lat.append(time.perf_counter() - t0)
        if A.launches - before != RERANK_PER_SEARCH:
            fail(f"{phase}: a text search launched #1 "
                 f"{A.launches - before} times; want {RERANK_PER_SEARCH}")
    stages = {k: v / len(queries) for k, v in clock.seconds.items()}
    stages["dedup"] = float(np.mean(text_lat)) - sum(stages.values())
    built_rows = images._features[:RETRIEVAL_IMAGES].float()
    gram = built_rows @ built_rows.T
    built_cos = (gram.sum() - gram.trace()).item() / (
        RETRIEVAL_IMAGES * (RETRIEVAL_IMAGES - 1))
    img_clock = _StageClock()
    img_clock.wrap(images, "extract_features", "extract", sync=True)
    img_clock.wrap(images, "retrieve_by_features", "score_dedup")
    image_queries = paths[:RETRIEVAL_SEARCHES]
    images.retrieve_similar_images(image_queries[0])              # warm-up
    img_clock.seconds.clear()
    img_lat, img_res = [], []
    for p in image_queries:
        before = A.launches
        t0 = time.perf_counter()
        img_res.append(images.retrieve_similar_images(p, RETRIEVAL_TOP_K))
        img_lat.append(time.perf_counter() - t0)
        if A.launches != before:
            fail(f"{phase}: an image search launched #1")
    torch.cuda.synchronize()
    launches = _counts()
    want = {k: 0 for k in launches}
    want["flash_attn_fwd"] = RERANK_PER_SEARCH * (len(queries) + 1)
    print(f"{phase}: {len(queries)} text searches (top_k "
          f"{RETRIEVAL_TOP_K}, recall {RETRIEVAL_RECALL} from 2 corpora, "
          f"{RETRIEVAL_TOP_K * RETRIEVAL_RECALL * 2} pairs re-ranked): "
          f"latency p50 {_pct(text_lat, 50):.3f} ms, p95 "
          f"{_pct(text_lat, 95):.3f} ms; seconds a search by stage "
          f"{json.dumps({k: round(v, 6) for k, v in stages.items()})}  "
          f"[{card}]", flush=True)
    img_stages = {k: v / len(image_queries)
                  for k, v in img_clock.seconds.items()}
    print(f"{phase}: {len(image_queries)} image searches (top_k "
          f"{RETRIEVAL_TOP_K}, fetch {4 * RETRIEVAL_TOP_K}): latency p50 "
          f"{_pct(img_lat, 50):.3f} ms, p95 {_pct(img_lat, 95):.3f} ms; "
          f"seconds a search by stage "
          f"{json.dumps({k: round(v, 6) for k, v in img_stages.items()})}; "
          f"own image at rank 1 in "
          f"{sum(r[0][0] == p for r, p in zip(img_res, image_queries))} of "
          f"{len(image_queries)} (seeded ResNet50: two built images at "
          f"cosine {built_cos:.5f} on average)  [{card}]", flush=True)
    print(f"{phase}: kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)}; {RERANK_PER_SEARCH} a text search with the "
          f"warm-up, 0 an image search)  [{card}]", flush=True)
    if launches != want:
        fail(f"{phase}: launches {launches}, want {want}")
    # exact-score dedup may return fewer than top_k, never none
    if not all(r and all(math.isfinite(v) for _, v in r)
               for r in text_res + img_res):
        fail(f"{phase}: a search returned no result or a non-finite score")

    # scoring a query (Q 1) on the card beside its bound: the corpus read
    # once, bf16 (2 bytes a value) or int8 (1, and a 4-byte scale a row)
    q_text = train.encode_texts(queries[:1])
    q_img = images.extract_features(image_queries[0])[None]
    int8_text = {n: TextCorpus(root / n, tok, cfg=bi_cfg, params=bi,
                               int8=True, device="cuda")
                 for n in ("text_train", "text_test")}
    int8_images = ImageCorpus(root / "image_corpus", resnet_params=resnet,
                              cfg=rcfg, int8=True, device="cuda")
    for c in int8_text.values():
        c.load()
    int8_images._load()
    qi = torch.as_tensor(q_img, device="cuda")
    fetch = 4 * RETRIEVAL_TOP_K
    for name, bf16_fn, int8_fn, n, d in (
            ("text_train", lambda: train.topk(q_text, 25),
             lambda: int8_text["text_train"].topk(q_text, 25),
             RETRIEVAL_ROWS["text_train"], bi_cfg.hidden_size),
            ("text_test", lambda: test.topk(q_text, 25),
             lambda: int8_text["text_test"].topk(q_text, 25),
             RETRIEVAL_ROWS["text_test"], bi_cfg.hidden_size),
            ("image_corpus",
             lambda: T.dense_topk(T.l2_normalize(qi.to(torch.bfloat16)),
                                  images._features, fetch, normalize=False),
             lambda: T.dense_topk_int8(qi, int8_images._features,
                                       int8_images._scales, fetch),
             RETRIEVAL_ROWS["image_corpus"], rcfg.feature_dim)):
        row = {"bf16_us": _score_us(bf16_fn),
               "bf16_bound_us": 1e6 * n * d * 2 / PEAK_BYTES_PER_S,
               "int8_us": _score_us(int8_fn),
               "int8_bound_us": 1e6 * (n * d + 4 * n) / PEAK_BYTES_PER_S,
               "bf16_mb": n * d * 2 / 1e6, "int8_mb": (n * d + 4 * n) / 1e6}
        print(f"{phase}: scoring a query over {name} ({n} x {d}): bf16 "
              f"{row['bf16_us']:.3f} us (bound {row['bf16_bound_us']:.3f} "
              f"us, bytes; {row['bf16_mb']:.3f} MB on the card), int8 "
              f"{row['int8_us']:.3f} us (bound {row['int8_bound_us']:.3f} "
              f"us; {row['int8_mb']:.3f} MB)  [{card}]", flush=True)

    # -- checks ----------------------------------------------------------------
    # (a) bf16 top-k on the card against float64 top-k on the host over
    # the same bf16 rows, 64 queries at N 41,256
    rows = images._features
    picks = rng.integers(0, rows.shape[0], 64)
    qa = T.l2_normalize((rows[picks].float() + 0.05 * torch.randn(
        64, rows.shape[1], device="cuda")).to(torch.bfloat16))
    k = fetch
    s_card, i_card = T.dense_topk(qa, rows, k, normalize=False)
    s64 = qa.double().cpu().numpy() @ rows.double().cpu().numpy().T
    order = np.argsort(-s64, axis=1, kind="stable")[:, :k + 1]
    s_host = np.take_along_axis(s64, order, axis=1)
    score_err = float(np.abs(s_card.double().cpu().numpy()
                             - s_host[:, :k]).max())
    # for every k' <= k whose k'-th / (k'+1)-th gap exceeds the tolerance,
    # the top-k' index sets must agree
    card_i = i_card.cpu().numpy()
    gaps = s_host[:, :k] - s_host[:, 1:k + 1]
    checked = np.argwhere(gaps > TOPK_GAP_TOL)
    sets_ok = all(set(card_i[r, :kk + 1]) == set(order[r, :kk + 1])
                  for r, kk in checked)
    print(f"{phase}: (a) bf16 top-{k} of 64 queries at N "
          f"{rows.shape[0]}: max score error against float64 "
          f"{score_err:.3e} (tol {TOPK_SCORE_TOL:.0e}); top-k' index sets "
          f"equal for the {len(checked)} (query, k' <= {k}) pairs whose "
          f"k'/k'+1 gap exceeds {TOPK_GAP_TOL:.0e}: {sets_ok}  [{card}]",
          flush=True)
    if not (score_err <= TOPK_SCORE_TOL and sets_ok and len(checked)):
        fail(f"{phase}: (a) the card's top-k disagrees with float64")

    # (b) the --int8 path: planted top-1 of 16 noisy copies of corpus rows,
    # recall@10 against the bf16 path
    planted = rng.integers(0, RETRIEVAL_ROWS["image_corpus"], 16)
    fq = ArrayStore(images.dir).col("features")[planted].astype(np.float32)
    fq = fq + 0.01 * fq.std() * rng.standard_normal(fq.shape).astype(
        np.float32)
    r8 = int8_images.retrieve_by_features(fq, top_k=10, dedup=False)
    rb = images.retrieve_by_features(fq, top_k=10, dedup=False)
    ids = images._ids
    top1 = sum(r[0][0] == ids[j] for r, j in zip(r8, planted))
    recall = float(np.mean([len({a for a, _ in x} & {a for a, _ in y}) / 10
                            for x, y in zip(r8, rb)]))
    print(f"{phase}: (b) int8: planted top-1 {top1} of 16, recall@10 "
          f"against bf16 {recall:.4f} (min {INT8_RECALL_MIN})  [{card}]",
          flush=True)
    if top1 != 16 or recall < INT8_RECALL_MIN:
        fail(f"{phase}: (b) the int8 path misses")

    # (c) ties: the twin comes back after its row, with the same score,
    # and dedup drops it -- bf16 and int8
    first = TWIN[0]
    row = ArrayStore(images.dir).col("features")[first:first + 1].astype(
        np.float32)
    for corpus, what in ((images, "bf16"), (int8_images, "int8")):
        raw = corpus.retrieve_by_features(row, top_k=2, dedup=False)[0]
        dd = corpus.retrieve_by_features(row, top_k=5)[0]
        ok = ([p for p, _ in raw] == [ids[first], "twin"]
              and raw[0][1] == raw[1][1] and dd[0][0] == ids[first]
              and "twin" not in [p for p, _ in dd])
        print(f"{phase}: (c) {what} ties: {[p for p, _ in raw]} scores "
              f"{[v for _, v in raw]}, deduplicated top-5 keeps "
              f"{dd[0][0]} and drops the twin: {ok}  [{card}]", flush=True)
        if not ok:
            fail(f"{phase}: (c) the {what} tie order or dedup is wrong")

    # (d) self-retrieval without re-rank
    plain = SemanticSearch(train, [train, test])
    picked = [0, 5, split + 3, split + 100]
    got = [plain.search(texts[i], top_k=1)[0][0] for i in picked]
    want_ids = [f"train_{i}" if i < split else f"test_{i - split}"
                for i in picked]
    print(f"{phase}: (d) self-retrieval without re-rank: {got} (want "
          f"{want_ids})  [{card}]", flush=True)
    if got != want_ids:
        fail(f"{phase}: (d) an encoded evidence text did not retrieve itself")

    # (e) the fp32 re-rank through #1 against the explicit path, on one
    # search's 50 candidate pairs
    q_e = train.encode_texts(queries[1:2])
    cands = []
    for c in (train, test):
        _, idx = c.topk(q_e, RETRIEVAL_TOP_K * RETRIEVAL_RECALL)
        cands += [c.load()[1][j] for j in idx[0].tolist()]
    ids_e, mask_e, types_e = tok.encode_batch(
        [queries[1]] * len(cands), pairs=[lookup[c] for c in cands],
        max_length=RERANK["t"])
    args = [torch.from_numpy(x).to("cuda", torch.int64)
            for x in (ids_e, mask_e, types_e)]
    with torch.no_grad():
        before = A.launches
        fused = te.cross_encoder_score(cross, _fp32(cross_cfg, True), *args)
        fused_launches = A.launches - before
        explicit = te.cross_encoder_score(cross, _fp32(cross_cfg, False),
                                          *args)
    e_err = (fused - explicit).abs().max().item()
    e_tol = RERANK_FP32_RTOL * explicit.abs().max().item()
    print(f"{phase}: (e) fp32 re-rank of {len(cands)} pairs through #1 "
          f"({fused_launches} launches) against the explicit path: max "
          f"difference {e_err:.3e} (tol {e_tol:.3e})  [{card}]", flush=True)
    if not (e_err <= e_tol and fused_launches == RERANK_PER_SEARCH):
        fail(f"{phase}: (e) the fp32 re-rank disagrees with the explicit "
             f"path")

    # (f) the fp32 bi-encoder on the card against the same module on the
    # CPU: 8 texts with padding, 128 tokens
    cfg32 = _fp32(bi_cfg, False)
    ids_f, mask_f, _ = tok.encode_batch(texts[::RETRIEVAL_TEXTS // 8],
                                        max_length=128)
    outs = []
    for dev, params in (("cuda", bi), ("cpu", copy.deepcopy(bi).cpu())):
        with torch.no_grad():
            ids_t = torch.from_numpy(ids_f).to(dev, torch.int64)
            mask_t = torch.from_numpy(mask_f).to(dev)
            outs.append(te.mean_pool(te.encode(params, cfg32, ids_t, mask_t),
                                     mask_t).cpu())
    f_err = (outs[0] - outs[1]).abs().max().item()
    f_tol = MPNET_CARD_CPU_RTOL * outs[1].abs().max().item()
    print(f"{phase}: (f) fp32 MPNet on the card against the CPU, 8 texts "
          f"({int(mask_f.sum(1).min())}-{int(mask_f.sum(1).max())} of 128 "
          f"tokens): max difference {f_err:.3e} (tol {f_tol:.3e})  "
          f"[{card}]", flush=True)
    if not f_err <= f_tol:
        fail(f"{phase}: (f) MPNet on the card disagrees with the CPU")
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches


def main() -> None:
    dev = phase_device()
    phase_build()
    recs = {"flash_attn_fwd": phase_flash(dev["card"]),
            "layernorm": phase_layernorm(dev["card"]),
            "swin_window_attn": phase_swin(dev["card"]),
            "deberta_attn_fwd": phase_deberta(dev["card"]),
            "dropout": phase_dropout(dev["card"]),
            "flash_attn_bwd": phase_flash_bwd(dev["card"])}
    recs["flash_attn_fwd"].update(phase_flash_train(dev["card"]))
    recs["flash_attn_fwd"].update(phase_flash_rerank(dev["card"]))
    recs.update(phase_mlp(dev["card"]))
    recs["deberta_attn_bwd"] = phase_deberta_bwd(dev["card"])
    recs.update(phase_swin_train(dev["card"]))
    from mmd_tpu_torch.inference.traffic import corpus, write_images
    rng = np.random.default_rng(0)
    texts = corpus(rng, 64)
    with tempfile.TemporaryDirectory(prefix="mmd_chip_smoke_") as tmp:
        tmp = Path(tmp)
        images = write_images(tmp, rng, 12)
        served, _ = serve("serve", dev["card"], tmp, texts, images,
                          {"flash_attn_fwd": LAUNCHES_PER_BATCH}, 48, False)
        served_reference, wordpiece_s = serve(
            "serve_reference", dev["card"], tmp, texts, images,
            REFERENCE_PER_BATCH, 48, True)
        by_phase = {
            "serve": served,
            "serve_reference": served_reference,
            "serve_converted": phase_serve_converted(
                dev["card"], tmp, texts, images, wordpiece_s),
            "train": phase_train(dev["card"], tmp, "train", PER_STEP,
                                 ["--compute_dtype", "float32"]),
            "train_bf16": phase_train(dev["card"], tmp, "train_bf16",
                                      PER_STEP_BF16, []),
            "finetune_reference": phase_finetune_reference(dev["card"], tmp),
            "train_raw": phase_train_raw(dev["card"], tmp)}
        by_phase["retrieval"] = phase_retrieval(dev["card"], tmp)
        phase_train_parity(dev["card"])
        phase_train_parity_bf16(dev["card"])
        phase_finetune_parity(dev["card"], tmp)
    kernels = []
    for name, rec in recs.items():
        counts = {ph: launches[name] for ph, launches in by_phase.items()}
        kernels.append({**rec, "launches": sum(counts.values()),
                        "launches_by_phase": counts})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
