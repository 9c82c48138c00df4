"""Smoke run of the PyTorch port's serving, training and fine-tuning paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:
  1. device   a CUDA device, its name and power limit (nvidia-smi), TF32 off
  2. build    nvcc builds the twelve kernels from ops/csrc/ (the flash
              forward and backward one library a head dim: 24) and
              the host's C++ compiler the three native libraries from
              native/ (WordPiece, unigram, row gather), all at once
  3. kernels  each kernel against its plain PyTorch version on the card, at
              every geometry of the paths that run it, bf16 and fp32: max-abs
              error against its tolerance; kernel, plain and library times
              from CUDA events; the bound (the least time the card could
              take: bytes over 3.35 TB/s or operations over the card's peak
              for the timed dtype -- 989 TFLOP/s for bf16 on the tensor
              cores, 67 TFLOP/s for fp32, which has no tensor-core rate
              without TF32 (H100 SXM data sheet) -- whichever is larger),
              all beside the card's name
     * flash_attn_fwd        exact zeros for a row with no valid key, lse;
                             a served batch of the embed-384 model (dh 96)
                             and dh 48 masked, held only
     * layernorm             (residual +) LayerNorm, the 53 of a Swinv2 forward
     * swin_window_attn      Swinv2 window attention, the 24 of a forward,
                             fp32 and bf16, each call twice and bit for bit;
                             at 16 x 16 windows (n 256) the window-16
                             checkpoint's stages 0-2 at a served batch, at
                             24 x 24 (n 576) the window-24 checkpoint's
                             (held at B 2, timed at B 16) and one stage of
                             32 x 32 windows (n 1024, held at B 2)
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
       (train)               four geometries, batch 256, at dh 32 (D 256, 8
                             heads) and dh 96 (D 384, 4 heads); rate 0
                             unchanged; timed in fp32 and bf16 at rates 0.1
                             and 0 beside SDPA in the same dtype and rate
     * flash_attn_bwd        dq, dk, dv at the same geometries with and
                             without dropout, the masked text geometry
                             with a row with no valid key, and two ragged
                             geometries (T 100, S 130, masked, dh 64; T 77,
                             S 50, dh 32) at both rates with the forward;
                             the head-dim-128 instantiations at FakeNet's
                             four geometries (B 24) and two padded ones
                             with a row with no valid key, both rates, the
                             bf16 backward against the bf16 mirror; the
                             wider head dims 96 and 112 at the train
                             step's four geometries (B 256, 4 heads) and
                             masked at B 16, both rates, against the bf16
                             mirror too; every backward twice,
                             bit-identical; timed in fp32 and bf16 at
                             rates 0.1 and 0 beside SDPA's backward (dh 96
                             as the embed-384 step)
     * mlp_masks, mlp_fwd,   the fused MLP at the bf16 train step's two MLP
       mlp_bwd               geometries at D 256, 384 and 512 (F = 4 D; the
                             two-launch path above D 256), rate 0.1 and
                             0: the dumped masks
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
                             for bit, the bf16 backward against its mirror
                             (P and dS as hi + lo); per stage the forward's
                             and SDPA's us a call; the same at n 256 (B 8),
                             n 576 (held at B 2, timed at B 8) and n 1024
                             (held at B 2)
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
                      4 steps and one validation pass; every loss
                      finite, exactly 8 / 8 / 32 launches of the flash
                      forward, backward and dropout kernels a step (and 8 flash
                      forwards a validation batch), params moved,
                      metrics.jsonl and checkpoints written; wall time a
                      step and peak device memory
  8. train_bf16       the same with the default compute dtype, bfloat16:
                      exactly 6 / 6 / 8 / 8 / 8 launches of the fused MLP
                      forward and backward, the flash forward and backward
                      and the dropout kernel a step, none of the mask oracle
     train_wide       the same at the fusion CLI's wider widths,
                      --embed_dim 384 and 512 --num_heads 4 (head dims 96
                      and 128, the MLPs at D 384 / F 1536 and D 512 / F
                      2048, the wide MLP path): the same launches a step,
                      no call of the explicit attention, a falling loss;
                      then each run's best_model.pt served through
                      MisinformationPredictor(checkpoint_path=...) and a
                      ServingEngine, 32 requests at batch 16: 56 #1
                      launches a batch, 8 of them at the fusion model's
                      head dim
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
     swin_window16    a Swinv2 window-16 checkpoint served and fine-tuned
                      from converted assets: DeBERTa-v3-xsmall (fp32, as
                      converted) and the published config of
                      microsoft/swinv2-base-patch4-window16-256, seeded,
                      written by convert_hf's writer with an spm.json;
                      2 batches of 16 through MisinformationPredictor
                      (serve_reference's launches a batch, 44 of #7 at
                      n 256 and 4 at n 64), then 2 bf16 steps of
                      Trainer(finetune=True) with fused_train at batch 8
                      and 256 tokens (finetune_reference's launches a
                      step, 44 each of #8 and #9 at n 256 and 4 at n 64);
                      no window attention on the explicit path; every
                      geometry held in situ (#9 in bf16 against its
                      mirror)
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
 15. caption          the reference's captioner at BLIP-base's published
                      widths (Salesforce/blip-image-captioning-base: ViT-B/16
                      at 384 px, 577 tokens; a 12-layer cross-attending
                      decoder, vocabulary 30,524), fp32, seeded weights:
                      written in HF's layout (config.json, model.safetensors,
                      vocab.txt with [DEC]), converted by python -m
                      mmd_tpu_torch.convert_hf --blip, then python -m
                      mmd_tpu_torch.pipelines.caption over 32 rows (64
                      images, one path missing: 2 batches of 32, 64 steps)
                      and again after cutting 16 rows (the resume); checks
                      (a) the captions equal those of the same params in
                      memory, (b) the kernel path against the explicit
                      path, teacher-forced logits within 1e-3 of the largest
                      |logit| and equal tokens before any near tie, (c) a
                      second decode bit for bit, (d) exactly 780 #1
                      launches a batch and no other kernel; images/s, a
                      batch's seconds by stage, peak memory, device time by
                      group over 16 decode steps (torch.profiler), and #1
                      alone at the decode (T 1, S 577) and ViT (T = S =
                      577) geometries beside its plain version and SDPA
 16. train_captioner  python -m mmd_tpu_torch.pipelines.train_captioner with
                      the default CaptionerConfig() (ViT 1024 x 12 at 64
                      tokens, decoder 384 x 6, bf16) over 128 pairs, batch
                      32, 2 epochs: finite losses, 18 / 18 launches of #1 /
                      #2 a step, the median step time, peak memory and a
                      step's device time by group (torch.profiler); #1
                      and #2 at its two geometries beside SDPA; the caption
                      pipeline with the captioner.pt it wrote (204 #1
                      launches a batch), eval_prompting --llm captioner on 8
                      rows (none) and the LVLM scorer with an image (18) and
                      without (none); one step of the kernel path against
                      the explicit path: fp32 loss within 1e-5, gradients
                      within 1e-4, the bf16 loss within 1e-3
 17. run_all          python -m mmd_tpu_torch.pipelines.run_all's default
                      path in process (--synthetic 64 --image_size 256
                      --epochs 2 --batch_size 32) at full width, seeded:
                      the BERT-class text encoder (384 x 12, 512 tokens),
                      ViTConfig(), CaptionerConfig(), MPNet and ResNet50
                      retrieval, the default ModelConfig in bf16; seconds by
                      stage, embed rows/s, peak memory; checks (a) every
                      stage of the JAX run_all timed, (b) each store holds
                      exactly the rows with both images, its csv_cursor the
                      CSV's length, (c) a second embed appends nothing,
                      (d) a store rewound to its first batch and resumed is
                      bit-identical, (e) one batch re-encoded in fp32
                      through the explicit path within 5e-2 relative L2,
                      (f) eval.csv's four paths and unified, finite, (g)
                      fp32 eval logits through the kernels within 1e-3 of
                      the explicit path's and the same predictions outside
                      near ties, (h) the demo's verdict with 3 text and 3
                      image evidences, (i) its HTML report, (j) the
                      streamlit page (a recording stand-in) over
                      demo/app.build_pipeline from the files renders the
                      in-memory pipeline's verdict, (k) dataset_stats,
                      eval_models' CLI (the run's metrics exactly),
                      eval_text, eval_factify and render_html's main, (l)
                      the launches stage by stage: 48 #1 an embed batch,
                      204 a caption batch, the train_bf16 step's, 8 an eval
                      batch, serve's 56 in the demo's classify batch; and
                      in situ: every launch of the run recorded with its
                      geometry, the first inputs at each geometry held
                      against the kernel's plain version (at its phase's
                      tolerance) and timed beside its plain version, its
                      bound and, where one call computes it, PyTorch's
 18. run_all_reference  the same with --reference_encoders --synthetic 32
                      --epochs 1 (DeBERTa-v3-xsmall and Swinv2-base):
                      checks (a)-(d), (f)-(i) and (l), 24 / 48 / 106 of #10
                      / #7 / #6 an embed batch, serve_reference's launches
                      in the classify batch, and the kernels in situ
 19. run_all_fused    python -m mmd_tpu_torch.pipelines.run_all --fused in
                      process with the README's flagship flags
                      (--reference_encoders --synthetic 256 --epochs 2
                      --train_batch 64 --steps_per_call 8 --chunk 256,
                      256-px images): DeBERTa-v3-xsmall, Swinv2-base,
                      CaptionerConfig(), MPNet, ResNet50, the default
                      ModelConfig in bf16, seeded; seconds by stage, ingest
                      rows/s, the banks' bytes, peak memory, ingest's
                      host-to-device bytes; checks (a) every stage of the
                      JAX _run_fused timed, (b) each bank's rows and
                      skipped rows make the CSV's, its ids, tokens and
                      labels the raw store's bit for bit, (c) the vis
                      columns against the fp32 explicit encoder over the
                      same images within 5e-2 relative L2, (d) a window of
                      K bank steps against K plain steps on host-gathered
                      batches bit for bit, (e) evaluate_from_bank over a
                      raw-image bank equals evaluate_streaming, (f) the
                      ingest hooks' captions equal dispatch_bank's and
                      every banked row is enriched, (g) the hook's image
                      corpus against build_image_corpus_from_bank within
                      2e-2, ids the evidence paths, (h) finite metrics and
                      a verdict, (i) the launches stage by stage (each
                      stage's own thread) against the counts the banks,
                      chunks and steps predict; every kernel in situ
 20. run_all_fused_default  the same with the default encoders (BERT-class
                      text encoder, ViTConfig()) at --synthetic 64
                      --epochs 1
 21. fakenet          python -m mmd_tpu_torch.baselines.fakenet_train in
                      process at its CLI's full width (text 384, image
                      1024, hidden 256 over 2 heads: head dim 128; bf16,
                      batch 24, dropout 0.1) over a synthetic store of
                      240 rows (text 512 x 384, image 64 x 1024 a side,
                      five categories), 2 epochs; checks (a) exactly 12 #1,
                      12 #2 and 48 #5 launches a step and 12 #1 a
                      prediction batch, all at dh 128, (b) every launch's
                      geometry held in situ, (c) one fp32 step through
                      the kernels within 1e-4 of the explicit path in loss
                      and logits, (d) two predictions bit for bit, (e) the
                      answer CSV in the JAX CLI's columns; the median step
                      time, peak memory, a step's idle share
                      (torch.profiler), the fp32 #2 beside SDPA's backward
 22. serve_parallel   multi-device serving: a spawned world of 4 ranks (gloo
                      sharing the card, nccl with a card a rank) serves 16
                      requests at max_length 512 through
                      MisinformationPredictor(mesh=, text_parallelism=)
                      under sp over 2 and 4 ranks, sp_ring over 2, pp over
                      2 and 4 stages and tp over 2, on the (2, 2) and
                      (1, 4) meshes, for the default and the reference
                      encoder families (seeded as serve and
                      serve_reference seed them); rank 0 holds each run
                      against the single-device predictor: the claims'
                      text embeddings within 3e-2 relative L2 and the
                      labels equal outside near ties (the smallest
                      single-device logit margin printed); each rank's
                      #1 / #10 launches against the count the run
                      predicts, its text parameters on the card (PP and
                      TP hold their slice) and the bytes its collectives
                      staged through the host; #1 and #10 held in situ,
                      one rank at a time
 23. retrieval_sharded  in the same world, ImageCorpus(mesh=) over the
                      retrieval phase's 41,256-row image corpus, sharded
                      over (2, 2) and (4, 1): 32 queries (a duplicated row
                      among them) give the single-device corpus's paths
                      on every rank
 24. the CLI          python -m torch.distributed.run --nproc_per_node 2
                      -m mmd_tpu_torch.evaluate --text_parallelism sp
                      --dist_backend gloo prints, from rank 0 alone, the
                      labels of python -m mmd_tpu_torch.evaluate; on a
                      machine with one card, --dist_backend nccl must
                      refuse (one rank a card); both started beside 22
 25. train_parallel   multi-device training: a spawned world of 4 gloo ranks
                      sharing the card trains the default train geometry
                      (batch 256, text 512 x 384, image 64 x 1024, the
                      default fusion model, fused_attn) through
                      Trainer(mesh=, tensor_parallel=, zero1=, zero3=):
                      DP, ZeRO-1 and ZeRO-3 on (4, 1), TP and TP + ZeRO-1
                      on (2, 2), TP on (1, 4); in each, 2 fp32 steps at
                      dropout 0 held against the single-device step on the
                      card (losses within 1e-5 relative, the update the
                      gathered params took within 0.2 lr a step of the
                      single-device update, a limit that a run skipping
                      its last step must break)
                      and 1 bf16 step at dropout 0.1: each rank's launches
                      the single-device step's (#1 / #2 / #5 / #3 / #4 8 /
                      8 / 8 / 6 / 6 a step on its rows, heads and hidden
                      slice), the bytes its collectives staged through the
                      host, its params + moments bytes, rank 0's step
                      seconds; #1-#5 held in situ on every rank (timed on
                      rank 0)
 26. the train CLI    python -m torch.distributed.run --nproc_per_node 2
                      -m mmd_tpu_torch.train --model_parallel 2
                      --tensor_parallel --zero1 --dist_backend gloo over
                      512 synthetic rows (2 steps; started beside 25):
                      metrics.jsonl and one checkpoint from rank 0 alone;
                      the checkpoint (the single-device state) resumed on
                      one device for one step
 27. finetune_parallel  fine-tuning under text parallelism: a spawned world
                      of 4 gloo ranks sharing the card fine-tunes, batch 8
                      and 256 tokens, the reference families (DeBERTa-v3-
                      xsmall + Swinv2-base, fused_train, seeded as
                      finetune_reference) under pp on (2, 2) with ZeRO-3,
                      sp on (2, 2) and sp_ring on (1, 4), and the default
                      families (the BERT-class encoder at D 384, 12 layers,
                      6 heads + the ViT) under sp on (1, 4) (#1 / #2 at
                      Tq 64 against Tk 256) and pp on (2, 2) with remat,
                      through Trainer(finetune=True, text_parallelism=);
                      in each, 2 fp32 steps at dropout 0 against the
                      single-device fine-tuning step on the card (losses
                      within 1e-5 relative, the gathered params' update
                      within 0.2 lr a step, a limit the single-device run
                      one step short must break) and 1 bf16 step at
                      dropout 0.1: each rank's launches of #1 / #2 / #3 /
                      #4 / #5 / #8 / #9 / #10 / #11 against the count the
                      run predicts, the bytes its collectives staged
                      through the host, its params + moments bytes, rank
                      0's step seconds; #1, #2, #8, #9, #10 and #11 held in
                      situ at the ranks' geometries (timed on rank 0)
 28. the fine-tuning  python -m torch.distributed.run --nproc_per_node 2
     CLI              -m mmd_tpu_torch.train --finetune_encoders
                      --model_parallel 2 --text_parallelism pp
                      --dist_backend gloo on train_raw's raw store (one
                      epoch, started beside 27): metrics.jsonl and one
                      checkpoint from rank 0 alone; the checkpoint resumed
                      on one device for one step
 29. run_all_parallel  python -m mmd_tpu_torch.pipelines.run_all over a
                      spawned world of 2 gloo ranks sharing the card, first
                      in fp32 at dropout 0 on a copy of run_all's stores,
                      against the single-device run_all on another copy,
                      run beside the world (losses within 1e-5 relative,
                      params within 0.2 lr a step but the attention key
                      biases, whose exact gradient is 0, within 2; the
                      single-device run one step short must break the
                      limit); then as it is on a copy of run_all's raw
                      tree (80 rows, 256-px images, the default encoders,
                      bf16, train batch 24: 12 a rank), the counted run:
                      rank 0 alone runs the stages that write the tree,
                      every rank trains its rows, rank 0 alone evaluates
                      and verifies; each rank's launches by stage against
                      the count predicted (rank 0 run_all's, rank 1 the
                      train stage's), #1-#5 held in situ at the ranks'
                      train geometries (timed on rank 0), rank 0's stage
                      seconds, the bytes staged through the host; --fused
                      over the 2 ranks must raise before writing
 30. the run_all CLI  python -m torch.distributed.run --nproc_per_node 2
                      -m mmd_tpu_torch.pipelines.run_all --dist_backend
                      gloo on another copy (started beside 29): eval.csv,
                      the timings and the reports from rank 0 alone; over
                      nccl the launch must refuse two ranks on one card
                      and leave its root absent
The serve_converted, retrieval and run_all phases also hold the native
libraries: each ran in the phase's counted run (unigram, WordPiece, row
gather) and gives the Python path's output bit for bit on the phase's own
inputs (retrieval: its shortest and longest build batch; run_all: a train
batch's columns of at least NATIVE_GATHER_MIN_BYTES, against the store's
numpy path), timed beside it in turns.
The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record, with each kernel's launches in the counted runs of
the serve, serve_reference, serve_converted, train, train_bf16,
finetune_reference, train_raw, swin_window16, retrieval, caption, train_captioner,
run_all, run_all_reference, run_all_fused, run_all_fused_default,
fakenet, serve_parallel (summed over its ranks), retrieval_sharded,
train_parallel (summed over its ranks), train_parallel_cli (the resumed
step), finetune_parallel (summed over its ranks), finetune_parallel_cli
(the resumed step) and run_all_parallel (summed over its ranks) phases.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
PEAK_FP32_FLOPS = 67e12       # CUDA cores (the elementwise dropout)
# #1 and #2 run fp32 as 3xTF32 on the tensor cores: three TF32 products
# (495 TFLOP/s) for each fp32 product, so fp32 work at a third of that
PEAK_3XTF32_FLOPS = 495e12 / 3

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
# Swinv2-base at 16 x 16 windows (microsoft/swinv2-base-patch4-window16-256:
# res 64, 32, 16, 8, windows 16, 16, 16, 8) and at 24 x 24
# (microsoft/swinv2-base-patch4-window12to24-192to384-22kto1k-ft at 384 px:
# res 96, 48, 24, 12, windows 24, 24, 24, 12): the window attentions of
# stages 0-2 a served batch, n 256 and n 576, by (nW, C, heads, bias
# windows) -- one table for both; stage 3 takes n 64 (window 16's
# (1, 1024, 32, 1), 4 a batch) or, at 12 x 12, the explicit path
SWIN_BLOCKED_GEOMS = {(16, 128, 4, 1): 2, (16, 128, 4, 16): 2,
                      (4, 256, 8, 1): 2, (4, 256, 8, 4): 2,
                      (1, 512, 16, 1): 36}
SWIN_BLOCKED_TOKENS = {"window16": 256, "window24": 576}
# a stage of 32 x 32 windows (n 1024), held only; n 576 and 1024 are held
# at this batch (and n 576 timed at the path's)
SWIN_N1024 = (4, 128, 4, 4)
SWIN_HELD_B = 2
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
# swin_window16: the published config of
# microsoft/swinv2-base-patch4-window16-256, Swinv2-base with 16 x 16
# windows; 2 served batches of 16, then 2 bf16 fine-tuning steps; #7's
# launches a served batch and #8's and #9's a step by tokens a window
# (stages 0-2: 2 + 2 + 18 blocks at n 256, stage 3: 2 at n 64, two images)
SWINV2_BASE_W16_HF = {**SWINV2_BASE_HF, "window_size": 16}
W16_REQUESTS = 32
W16_FT_STEPS = 2
W16_BY_TOKENS = {256: 44, 64: 4}

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
TRAIN_STEPS = 4
# The bf16 train step: the six MLPs run the fused kernels (#3 forward, #4
# backward), so only the heads' (256, 64) dropouts stay elementwise.
# (N rows, D, F) -> MLP calls a step: the three text-query MLPs and the
# three image-query MLPs.
MLP_GEOMS = {(131072, 256, 1024): 3, (16384, 256, 1024): 3}
MLP_PER_STEP = sum(MLP_GEOMS.values())                     # 6
# The fusion CLI's wider widths, --embed_dim 384 | 512 --num_heads 4: #1 and
# #2 at head dims 96 / 128, the MLPs at D 384 / F 1536 and D 512 / F 2048,
# the same launches a step as (d). #1/#2 are held at dh 96 (timed: the
# embed-384 step) and dh 112 at the step's geometries, masked at B 16 too,
# and #1 at dh 96 and 48 at a served batch's; #3/#4/#12 at both widths.
WIDE_EMBEDS = (384, 512)
WIDE_HEADS = 4
WIDE_MLP_GEOMS = {e: {(131072, e, 4 * e): 3, (16384, e, 4 * e): 3}
                  for e in WIDE_EMBEDS}
WIDE_TRAIN = [dict(name=f"dh96_{t}x{s}", t=t, s=s, d=96 * WIDE_HEADS,
                   h=WIDE_HEADS, masked=False, b=TRAIN_B,
                   per_step=TRAIN_PER_STEP[f"fusion_{t}x{s}"],
                   suffix="_embed384") for t in (512, 64) for s in (512, 64)]
WIDE_BWD = [*WIDE_TRAIN,
            *(dict(g, name=g["name"].replace("dh96", "dh112"), d=112 * 4,
                   per_step=0) for g in WIDE_TRAIN),
            dict(name="dh96_masked_512x512", b=BATCH, t=512, s=512, d=384,
                 h=4, masked=True),
            dict(name="dh112_ragged_100x130", b=BATCH, t=100, s=130, d=448,
                 h=4, masked=True)]
WIDE_SERVE = [*(dict(name=f"dh96_{t}x{s}", t=t, s=s, d=384, h=4,
                     masked=False) for t in (512, 64) for s in (512, 64)),
              dict(name="dh48_masked_512x64", t=512, s=64, d=192, h=4,
                   masked=True)]
# train_wide: the fusion model's #1 launches a served batch, and its head
# dim at each width
WIDE_SERVE_REQUESTS = 32          # 2 batches of 16
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
# the window attentions of stages 0-2 a fine-tuning step at 16 x 16 (n 256)
# and 24 x 24 (n 576) windows: (nW, C, heads) -> blocks x 2 images
FT_SWIN_BLOCKED_GEOMS = {(16, 128, 4): 4, (4, 256, 8): 4, (1, 512, 16): 36}
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

# The captioner. `caption`: the published config of
# Salesforce/blip-image-captioning-base (ViT-B/16 at 384 px, 577 tokens
# with CLS; a 12-layer 768-wide cross-attending BERT decoder, vocabulary
# 30,524 with [DEC] and [ENC]), fp32 as blip_config sets it, captions of
# 64 tokens, batches of 32 (pipelines/caption.py): 12 #1 launches in the
# ViT and one a decoder layer a step
BLIP_VISION = dict(model_type="blip_vision_model", image_size=384,
                   patch_size=16, hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072,
                   layer_norm_eps=1e-5, hidden_act="gelu")
BLIP_TEXT = dict(model_type="blip_text_model", vocab_size=30524,
                 hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, layer_norm_eps=1e-12,
                 hidden_act="gelu", encoder_hidden_size=768)
CAPTION_B = 32
CAPTION_STEPS = 64
CAPTION_ROWS = 32                # 64 images (one path missing): 2 batches
CAPTION_PER_BATCH = 12 + CAPTION_STEPS * 12                  # 780
PROFILE_STEPS = 16               # decode steps under torch.profiler
# (b) kernel path against the explicit path, teacher-forced logits
# relative to the largest |logit|: the fp32 kernel (3xTF32 products, an
# online softmax) and the explicit fp32 path differ by ~1e-6 an
# attention; 1e-3 leaves room for 12 layers and the head. Tokens must
# agree wherever the explicit path's top-2 gap exceeds it.
CAPTION_LOGIT_RTOL = 1e-3
# `train_captioner`: the default CaptionerConfig() (ViT 1024 x 12 at 64
# tokens, decoder 384 x 6, bf16), 128 pairs, batch 32, 2 epochs
TRAIN_CAP_PAIRS = 128
TRAIN_CAP_B = 32
TRAIN_CAP_EPOCHS = 2
TRAIN_CAP_STEPS = TRAIN_CAP_EPOCHS * TRAIN_CAP_PAIRS // TRAIN_CAP_B   # 8
TRAIN_CAP_PER_STEP = {"flash_attn_fwd": 18, "flash_attn_bwd": 18}
DEFAULT_CAPTION_PER_BATCH = 12 + 32 * 6                      # 204
LVLM_PER_IMAGE_SCORE = 18


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


def _build_jobs() -> list:
    """(library, loader) for every kernel library: the flash kernels build
    one library a head dim (ops/attention.py), the others one each."""
    from mmd_tpu_torch.ops import attention as A
    jobs = []
    for name, (mod, loader, _) in _kernels().items():
        if mod is A:
            kernel = "flash_attn_fwd" if loader == "load_kernel" \
                else "flash_attn_bwd"
            jobs += [(A.library_name(kernel, dh),
                      functools.partial(getattr(A, loader), dh))
                     for dh in A._HEAD_DIMS]
        else:
            jobs.append((name, getattr(mod, loader)))
    return jobs


def phase_build() -> None:
    """nvcc builds each kernel library and the host's C++ compiler each
    native library (mmd_tpu_torch/native/), all at once."""
    from mmd_tpu_torch.native import bindings as NB
    from mmd_tpu_torch.ops import cuda_build
    kernels = _kernels()
    t0 = time.perf_counter()
    native_s = {}

    def build_native(name):
        t = time.perf_counter()
        lib = NB.load(name)
        native_s[name] = time.perf_counter() - t
        return lib

    jobs = _build_jobs()
    with ThreadPoolExecutor(len(jobs) + len(NB.SOURCES)) as ex:
        native = ex.map(build_native, NB.SOURCES)     # one compiler a source
        list(ex.map(lambda job: job[1](), jobs))
        native = dict(zip(NB.SOURCES, native))
    for library, _ in jobs:
        secs = cuda_build.build_seconds.get(library)
        print(f"build: {library} nvcc "
              f"{'%.3f s' % secs if secs is not None else 'skipped: built'}",
              flush=True)
    for name, lib in native.items():
        print(f"build: native {NB.SOURCES[name]} {NB.find_cxx()} "
              f"{native_s[name]:.3f} s -> "
              f"{'loaded' if lib is not None else 'FAILED'}", flush=True)
        if lib is None:
            fail(f"the native library {NB.SOURCES[name]} did not build: "
                 f"{NB.build_errors.get(name)}")
    print(f"build: all {len(kernels)} kernels ({len(jobs)} libraries: the "
          f"flash kernels one a head dim) and {len(native)} native "
          f"libraries loaded in {time.perf_counter() - t0:.3f} s",
          flush=True)


def _reset_native() -> None:
    from mmd_tpu_torch.native import bindings as NB
    for key in NB.calls:
        NB.calls[key] = 0


def _check_native(phase: str, card: str, key: str, what: str, native,
                  python) -> None:
    """The native binding `key` ran in the phase's counted run, and on the
    phase's own inputs `native()` gives `python()`'s arrays bit for bit;
    both timed on the host clock, in turns (native/measure.py)."""
    from mmd_tpu_torch.native import bindings as NB
    from mmd_tpu_torch.native.measure import interleaved
    calls = NB.calls[key]
    got, want = native(), python()
    same = len(got) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(got, want))
    ms = interleaved({"native": native, "python": python}, 5, warmup=1)
    native_ms, python_ms = (ms[k]["median_ms"] for k in ("native", "python"))
    print(f"{phase}: native {key} ran {calls} times in the counted run; on "
          f"{what}: native {native_ms:.3f} ms against the Python path "
          f"{python_ms:.3f} ms (host clock, median), output "
          f"{'bit-identical' if same else 'DIFFERS'} -> "
          f"{'ok' if calls > 0 and same else 'FAIL'}  [{card}]", flush=True)
    if calls <= 0:
        fail(f"{phase}: the native {key} binding never ran")
    if not same:
        fail(f"{phase}: the native {key} output differs from the Python "
             f"path's")


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
    for g in WIDE_SERVE:                  # the wider head dims, held only
        b, t, s, d, h = BATCH, g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32 = (torch.randn(b, n, d, device=dev, generator=gen)
                         for n in (t, s, s))
        mask = _masked_lengths(b, s, dev) if g["masked"] else None
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
                ok = ok and bool((o[-1] == 0).all())
            print(f"kernel flash_attn_fwd {g['name']:>18} {str(dtype):>14}: "
                  f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse "
                  f"err {lse_err:.3e} -> {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{g['name']} {dtype}")
            errs.append(err)
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


def _swin_serving_inputs(gen, n: int, nw: int, b: int, c: int, h: int,
                         nwb: int):
    """Raw q, k, v (fp32), the natural-log bias and the clamped logit scale
    of one serving window attention."""
    dev = torch.device("cuda")
    q32, k32, v32 = (torch.randn(nw, b, n, c, device=dev, generator=gen)
                     for _ in range(3))
    # position bias in (0, 16) plus, for shifted windows, twice a 0 / -100
    # region mask
    bias = 16 * torch.rand(1, h, n, n, device=dev, generator=gen)
    if nwb > 1:
        region = torch.rand(nwb, 1, n, n, device=dev, generator=gen) < 0.3
        bias = bias - 200.0 * region
    bias = bias.expand(nwb, h, n, n).contiguous()
    scale = torch.exp(torch.clamp(
        torch.rand(h, device=dev, generator=gen) * 5, max=math.log(100)))
    return q32, k32, v32, bias, scale


def _hold_swin(SA, inputs, h: int, errs: list) -> None:
    """#7 against its plain version on `inputs`, both dtypes, each call
    twice and bit for bit."""
    q32, k32, v32, bias, scale = inputs
    nw, b, n, c = q32.shape
    nwb = bias.shape[0]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        o = SA.swin_window_attention_infer(q, k, v, bias, scale, h)
        again = SA.swin_window_attention_infer(q, k, v, bias, scale, h)
        torch.cuda.synchronize()
        if not torch.equal(o, again):
            fail(f"swin kernel: two calls differ at nW={nw} n={n} C={c} "
                 f"{dtype}")
        ref = SA.swin_window_attention_infer_plain(
            q.float(), k.float(), v.float(), bias, scale, h)
        err = (o.float() - ref).abs().max().item()
        tol = (KERNEL_TOL[dtype] if dtype == torch.float32
               else _bf16_step(ref))
        print(f"kernel swin_window_attn nW={nw} B={b} n={n} C={c} h={h} "
              f"bias_windows={nwb} {str(dtype):>14}: max_abs_err "
              f"{err:.3e} (tol {tol:.3e}) -> "
              f"{'ok' if err <= tol else 'FAIL'}", flush=True)
        if not err <= tol:
            fail(f"swin kernel disagrees with its plain version at nW={nw}"
                 f" n={n} C={c} {dtype}")
        errs.append(err)


def _time_swin(SA, inputs, h: int, card: str) -> dict:
    """#7's bf16 row on `inputs`: kernel, plain and bound."""
    q32, k32, v32, bias, scale = inputs
    nw, b, n, c = q32.shape
    nwb = bias.shape[0]
    q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
    row = {"ms": _time_ms(
        lambda: SA.swin_window_attention_infer(q, k, v, bias, scale, h)),
           "plain_ms": _time_ms(
        lambda: SA.swin_window_attention_infer_plain(q, k, v, bias, scale,
                                                     h)),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = _bound_ms(
        2 * 4 * nw * b * n * c + 4 * nwb * h * n * n + 4 * h,
        4 * nw * b * n * n * c)
    _print_time("swin_window_attn", f"nW={nw} B={b} n={n} C={c} h={h} "
                f"bias_windows={nwb} bf16", row, card)
    return row


def _sub_record(rec: dict, calls: int, n: int) -> dict:
    """The timing fields of a _record, for a path's share of a kernel:
    `calls_timed` is the weight of the timing sum (the path's table of
    calls a batch or step), not a count; the launches this run made at n
    come from the swin_window16 phase (_set_blocked_launches)."""
    return {**{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "calls_timed": calls, "tokens": n}


def _set_blocked_launches(recs: dict, by_n: dict) -> None:
    """Each window16_* / window24_* row's launches at its n, as the
    swin_window16 phase counted them (by_n: kernel -> tokens -> launches)."""
    for name, counts in by_n.items():
        for key, row in recs[name].items():
            if isinstance(row, dict) and key.startswith("window"):
                row["launches_in_phase"] = counts.get(row["tokens"], 0)
                row["phase"] = "swin_window16"


def phase_swin(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs, rows = [], []
    for (nw, c, h, nwb), count in SWIN_GEOMS.items():
        inputs = _swin_serving_inputs(gen, 64, nw, BATCH, c, h, nwb)
        _hold_swin(SA, inputs, h, errs)
        rows.append((count, _time_swin(SA, inputs, h, card)))
    # 16 x 16 and 24 x 24 windows (the blocked kernel): n 256 held and
    # timed at a served batch; n 576 held at SWIN_HELD_B, timed at a
    # served batch; a stage of 32 x 32 windows held
    blocked = {}
    for label, n in SWIN_BLOCKED_TOKENS.items():
        blocked[label] = []
        for (nw, c, h, nwb), count in SWIN_BLOCKED_GEOMS.items():
            inputs = _swin_serving_inputs(gen, n, nw, BATCH, c, h, nwb)
            if n == 256:
                _hold_swin(SA, inputs, h, errs)
            else:
                _hold_swin(SA, _swin_serving_inputs(gen, n, nw, SWIN_HELD_B,
                                                    c, h, nwb), h, errs)
            blocked[label].append((count, _time_swin(SA, inputs, h, card)))
            del inputs
    nw, c, h, nwb = SWIN_N1024
    _hold_swin(SA, _swin_serving_inputs(gen, 1024, nw, SWIN_HELD_B, c, h,
                                        nwb), h, errs)
    note = ("no single PyTorch call computes it: the per-head L2 "
            "normalization of q and k is part of the function")
    rec = _record("swin_window_attn",
                  "mmd_tpu_torch/ops/csrc/swin_window_attn.cu",
                  "mmd_tpu/ops/swin_attention.py:151", rows, errs, note)
    print(f"kernel swin_window_attn per served batch "
          f"({sum(SWIN_GEOMS.values())} launches): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    for label, n in SWIN_BLOCKED_TOKENS.items():
        sub = _record("swin_window_attn", "", "", blocked[label], errs)
        calls = sum(SWIN_BLOCKED_GEOMS.values())
        rec[f"{label}_served_batch"] = _sub_record(sub, calls, n)
        print(f"kernel swin_window_attn {label} (n {n}), stages 0-2 of a "
              f"served batch ({calls} calls): kernel {sub['ms']:.4f} "
              f"ms, plain {sub['plain_ms']:.4f} ms, bound "
              f"{sub['bound_ms']:.4f} ms ({sub['bound_by']})  [{card}]",
              flush=True)
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
    """#1's and #2's rate of operations in `dtype`."""
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_3XTF32_FLOPS


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
    rows = {key + sfx: [] for key in TRAIN_TIMINGS.values()
            for sfx in ("", "_embed384")}
    for g in [*_train_geoms(), *WIDE_TRAIN]:
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
                rows[TRAIN_TIMINGS[(dtype, rate)] + g.get("suffix", "")
                     ].append((g["per_step"], row))
        torch.cuda.empty_cache()
    return {key + sfx: _step_record(
                rows[key + sfx], errs, f"flash_attn_fwd {key + sfx}",
                f"torch.nn.functional.scaled_dot_product_attention(dropout_p"
                f"={rate}), {'bf16' if dtype == torch.bfloat16 else 'fp32'}, "
                f"(B, H, T, dh) views", card)
            for (dtype, rate), key in TRAIN_TIMINGS.items()
            for sfx in ("", "_embed384")}


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


def _check_flash(A, g, q32, k32, v32, do32, mask, rates, errs,
                 mirror: bool = False) -> None:
    """Forward and backward against their plain versions in bf16 and fp32
    at each rate; the backward twice, bit for bit the same. With `mirror`
    the bf16 backward is held against _flash_bwd_bf16_mirror (the plain
    version with the kernel's two bf16 roundings) instead."""
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
            if mirror and dtype == torch.bfloat16:
                want = _flash_bwd_bf16_mirror(q, k, v, o, lse, do, h, mask,
                                              rate, 88)
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
                  f"dh {q.shape[2] // h} {str(dtype):>14} rate {rate}"
                  f"{' (bf16 mirror)' if mirror and dtype == torch.bfloat16 else ''}"
                  f": o err {o_err:.3e}, lse "
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


# head dim 128 (FakeNet: D 256 over 2 heads): its four geometries at its
# batch of 24, then ragged, padded ones with a row with no valid key, at 2
# and 4 heads; the bf16 backward held against the bf16 mirror
DH128 = [*(dict(name=f"dh128_{t}x{s}", b=24, t=t, s=s, d=256, h=2,
                masked=False) for t, s in ((512, 512), (64, 64), (512, 64),
                                           (64, 512))),
         dict(name="dh128_ragged_100x130", b=BATCH, t=100, s=130, d=256, h=2,
              masked=True),
         dict(name="dh128_masked_512x77", b=BATCH, t=512, s=77, d=512, h=4,
              masked=True)]


def phase_flash_bwd(card: str) -> dict:
    """dq, dk, dv against flash_attention_bwd_plain: the train step's
    geometries at batch 256 with and without dropout, the masked text
    geometry (batch 16, a row with no valid key) at rate 0, and the two
    ragged geometries at both rates (forward checked too); every backward
    twice, bit-identical. Timed in fp32 and bf16 at rates 0.1 and 0. Then
    the head-dim-128 instantiations at DH128's geometries, both rates, the
    bf16 backward against the bf16 mirror."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs = []
    rows = {key + sfx: [] for key in TRAIN_TIMINGS.values()
            for sfx in ("", "_embed384")}
    text = dict(TEXT, b=BATCH, per_step=0)
    for g in [*_train_geoms(), text, *RAGGED, *DH128, *WIDE_BWD]:
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32, do32 = (torch.randn(b, n, d, device=dev,
                                           generator=gen)
                               for n in (t, s, s, t))
        mask = _masked_lengths(b, s, dev) if g["masked"] else None
        rates = (0.0,) if g is text else (DROPOUT_RATE, 0.0)
        _check_flash(A, g, q32, k32, v32, do32, mask, rates, errs,
                     mirror=g in DH128 or g in WIDE_BWD)
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
                rows[TRAIN_TIMINGS[(dtype, rate)] + g.get("suffix", "")
                     ].append((g["per_step"], row))
                del o, lse
            del out, gout, qh, kh, vh
        torch.cuda.empty_cache()
    steps = {key + sfx: _step_record(
                 rows[key + sfx], errs, f"flash_attn_bwd {key + sfx}",
                 f"the backward of torch.nn.functional.scaled_dot_product_"
                 f"attention at rate 0, "
                 f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} (forward "
                 f"excluded)", card)
             for (dtype, rate), key in TRAIN_TIMINGS.items()
             for sfx in ("", "_embed384")}
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
    0.1 and 0, at D 256 and at the wider widths (D 384 / F 1536, D 512 / F
    2048: the two-launch forward and the streamed backward): the masks
    bit-identical to their plain version, the forward and the backward
    against their plain versions and against the float64 oracle of the
    dumped masks, the forward and the backward twice bit for bit; times per
    train step, and #4's device time a call split by launch."""
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import mlp as M
    fn = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    names = ("mlp_fwd", "mlp_bwd", "mlp_masks")
    errs = {k: [] for k in names}
    groups = {"": MLP_GEOMS, **{f"_embed{e}": WIDE_MLP_GEOMS[e]
                                for e in WIDE_EMBEDS}}
    rows = {k: {sfx: [] for sfx in groups} for k in names}
    geoms = [(sfx, geom, count) for sfx, g in groups.items()
             for geom, count in g.items()]
    for sfx, (n, d, f), count in geoms:
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
            rows[name][sfx].append((count if name != "mlp_masks" else 1,
                                    row))
        del x, w1, w2, dy, w1t, w2t, leaves, out
        torch.cuda.empty_cache()
    composition = ("not one call: the unfused bf16 composition -- F.linear "
                   "(cuBLAS, bias in its epilogue), F.gelu(approximate="
                   "'tanh'), kernel #5, F.linear, kernel #5")
    sources = {
        "mlp_fwd": ("mmd_tpu_torch/ops/csrc/mlp_fwd.cu",
                    "mmd_tpu/ops/mlp.py:158", composition),
        "mlp_bwd": ("mmd_tpu_torch/ops/csrc/mlp_bwd.cu",
                    "mmd_tpu/ops/mlp.py:179",
                    "the backward of " + composition + " (forward excluded)"),
        "mlp_masks": ("mmd_tpu_torch/ops/csrc/mlp_masks.cu",
                      "benchmarks/validate_mlp_tpu.py:53",
                      "none: no PyTorch call draws these masks; times are "
                      "one dump at each geometry")}
    recs = {name: _record(name, *sources[name][:2], rows[name][""],
                          errs[name], sources[name][2]) for name in names}
    for name in names:                    # the wider widths' steps
        for sfx in groups:
            if sfx:
                step = _record(name, *sources[name][:2], rows[name][sfx],
                               errs[name], sources[name][2])
                recs[name]["train_step" + sfx] = {
                    k: step[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}
    for name in ("mlp_fwd", "mlp_bwd"):
        for sfx in groups:
            r = recs[name] if not sfx else recs[name]["train_step" + sfx]
            print(f"kernel {name} per bf16 train step{sfx} ({MLP_PER_STEP} "
                  f"launches): kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, unfused composition "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms  "
                  f"[{card}]", flush=True)
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


def _swin_train_inputs(gen, nw: int, b: int, c: int, h: int, n: int = 64):
    """q', k, v, do (fp32) and the log2-domain bias of one window attention
    of the fine-tuning path."""
    dev, dh, log2e = torch.device("cuda"), c // h, 1.4426950408889634

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


def _check_swin_train(SA, gen, nw, b, c, h, errs, n: int = 64):
    """#8 and #9 against their plain versions at one geometry, both dtypes,
    each twice and bit-identical, the bf16 backward against its mirror (P
    and dS as hi + lo, `split_weights`); returns the fp32 inputs."""
    q32, k32, v32, do32, bias = _swin_train_inputs(gen, nw, b, c, h, n)
    what = f"nW={nw} B={b} n={n} C={c} h={h}"
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
            q.float(), k.float(), v.float(), bias, do.float(), h,
            split_weights=dtype == torch.bfloat16)
        errs["bwd"].append(_check_grads(
            "swin_attn_train_bwd", f"{what} {dtype}",
            dict(zip(("dq", "dk", "dv", "dbias"), got)), want,
            (dtype,) * 3 + (torch.float32,)))
    return q32, k32, v32, do32, bias


def _time_swin_train(SA, inputs, h: int, card: str, what: str):
    """#8's and #9's bf16 rows on `inputs`, beside SDPA (forward, and its
    backward with the mask's gradient where a backend gives one); returns
    (forward row, backward row, the library note or None)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q32, k32, v32, do32, bias = inputs
    nw, b, n, c = q32.shape
    dh = c // h
    q, k, v, do = (x.to(torch.bfloat16) for x in (q32, k32, v32, do32))
    # the library call: SDPA on (nW B, h, n, dh), exp2(x) = exp(ln2 x), the
    # bias as an additive mask in the inputs' dtype
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
    note = None
    try:
        o4 = sdpa(*leaves[:3], attn_mask=leaves[3], scale=ln2)
        bwd["library_ms"] = _time_ms(lambda: torch.autograd.grad(
            o4, leaves, do4, retain_graph=True))
    except RuntimeError as e:           # no backend gives dmask
        bwd["library_ms"] = None
        note = f"SDPA's backward with a mask gradient: {e}"[:200]
    elems = nw * b * n * c
    fwd["bound_ms"], fwd["bound_by"] = _bound_ms(
        2 * 4 * elems + 4 * nw * h * n * n, 4 * nw * b * n * n * c)
    bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
        2 * 7 * elems + 2 * 4 * nw * h * n * n, 10 * nw * b * n * n * c)
    for kind, row in (("fwd", fwd), ("bwd", bwd)):
        _print_time(f"swin_attn_train_{kind}", f"{what} n={n} bf16", row,
                    card)
    return fwd, bwd, note


def phase_swin_train(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    gen = torch.Generator(device="cuda").manual_seed(8)
    b = FT_DEBERTA["b"]
    errs = {"fwd": [], "bwd": []}
    rows = {"fwd": [], "bwd": []}
    lib_note = None
    for nw, c, h in FT_SWIN_CHECK_B7:
        _check_swin_train(SA, gen, nw, 7, c, h, errs)
    for stage, ((nw, c, h), count) in enumerate(FT_SWIN_GEOMS.items()):
        what = f"nW={nw} B={b} C={c} h={h}"
        inputs = _check_swin_train(SA, gen, nw, b, c, h, errs)
        fwd, bwd, note = _time_swin_train(SA, inputs, h, card, what)
        lib_note = lib_note or note
        for kind, row in (("fwd", fwd), ("bwd", bwd)):
            rows[kind].append((count, row))
        print(f"time   swin_attn_train_fwd stage {stage} ({what}, bf16, "
              f"{count} a step): kernel {1e3 * fwd['ms']:.3f} us a call, "
              f"SDPA {1e3 * fwd['library_ms']:.3f} us, bound "
              f"{1e3 * fwd['bound_ms']:.3f} us  [{card}]", flush=True)
    # 16 x 16 and 24 x 24 windows (the blocked kernels): n 256 held and
    # timed at the step's batch; n 576 held at SWIN_HELD_B, timed at the
    # step's batch; a stage of 32 x 32 windows held
    blocked = {}
    for label, n in SWIN_BLOCKED_TOKENS.items():
        blocked[label] = {"fwd": [], "bwd": []}
        for (nw, c, h), count in FT_SWIN_BLOCKED_GEOMS.items():
            what = f"nW={nw} B={b} C={c} h={h}"
            if n == 256:
                inputs = _check_swin_train(SA, gen, nw, b, c, h, errs, n)
            else:
                _check_swin_train(SA, gen, nw, SWIN_HELD_B, c, h, errs, n)
                inputs = _swin_train_inputs(gen, nw, b, c, h, n)
            fwd, bwd, note = _time_swin_train(SA, inputs, h, card, what)
            lib_note = lib_note or note
            del inputs
            for kind, row in (("fwd", fwd), ("bwd", bwd)):
                blocked[label][kind].append((count, row))
    nw, c, h, _ = SWIN_N1024
    _check_swin_train(SA, gen, nw, SWIN_HELD_B, c, h, errs, 1024)
    recs = {}
    for kind, line in (("fwd", 211), ("bwd", 314)):
        name = f"swin_attn_train_{kind}"
        note = None if kind == "fwd" or lib_note is None else lib_note
        recs[name] = _record(
            name, "mmd_tpu_torch/ops/csrc/swin_window_attn_train.cu",
            f"mmd_tpu/ops/swin_attention.py:{line}", rows[kind],
            errs[kind], note)
        print(f"kernel {name} per fine-tuning step "
              f"({sum(FT_SWIN_GEOMS.values())} launches): kernel "
              f"{recs[name]['ms']:.4f} ms, plain {recs[name]['plain_ms']:.4f} "
              f"ms, library {recs[name]['library_ms']}, bound "
              f"{recs[name]['bound_ms']:.4f} ms  [{card}]", flush=True)
        for label, n in SWIN_BLOCKED_TOKENS.items():
            sub = _record(name, "", "", blocked[label][kind], errs[kind])
            calls = sum(FT_SWIN_BLOCKED_GEOMS.values())
            recs[name][f"{label}_step"] = _sub_record(sub, calls, n)
            print(f"kernel {name} {label} (n {n}), stages 0-2 of a "
                  f"fine-tuning step ({calls} calls): kernel "
                  f"{sub['ms']:.4f} ms, plain {sub['plain_ms']:.4f} ms, "
                  f"library {sub['library_ms']}, bound {sub['bound_ms']:.4f}"
                  f" ms ({sub['bound_by']})  [{card}]", flush=True)
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
    _reset_native()
    launches, reqs, tokenize_s = _drive(phase, card, pred, texts, images,
                                        REFERENCE_PER_BATCH,
                                        CONVERTED_REQUESTS)
    print(f"{phase}: tokenize {tokenize_s:.4f} s a batch (UnigramTokenizer, "
          f"native Viterbi) against {wordpiece_s:.4f} s (WordPieceTokenizer, "
          f"serve_reference)  [{card}]", flush=True)
    python_spm = UnigramTokenizer(_spm_pieces(texts))
    python_spm._native = None                 # the Python Viterbi
    _check_native(phase, card, "spm", f"the phase's {len(texts)} texts at "
                  f"512 tokens", lambda: pred.enc.tokenizer.encode_batch(
                      texts, max_length=512),
                  lambda: python_spm.encode_batch(texts, max_length=512))

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


# The synthetic batches of phase_train's runs. Every run draws the same
# ones (one seed, one batch size, one count), so the first run's draws are
# kept and the runs after it get copies of them in draw order: the same
# data, without drawing 134 M normals a batch again.
_SYNTHETIC: list = []


def _synthetic_draws(real):
    """A stand-in for data.synthetic.synthetic_preembed_batch (`real`)
    within one train build: the k-th call gives a copy of the k-th batch
    the runs have drawn, drawing it with `real` at its first call."""
    calls = iter(range(1 << 30))

    def draw(rng, batch_size: int = 32):
        i = next(calls)
        if i == len(_SYNTHETIC):
            _SYNTHETIC.append(real(rng, batch_size))
        batch = _SYNTHETIC[i]
        if batch["labels"].shape[0] != batch_size:
            fail(f"a train run drew batch {i} at size {batch_size}, the "
                 f"first run at {batch['labels'].shape[0]}")
        return {k: v.copy() for k, v in batch.items()}

    return draw


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
            "--save_every", "2", "--validate_every_epoch",
            "--output_dir", str(out)]
    t0 = time.perf_counter()
    args = TR.parse_args(argv)
    from unittest import mock

    from mmd_tpu_torch.data import synthetic as SD
    with mock.patch.object(SD, "synthetic_preembed_batch",
                           _synthetic_draws(SD.synthetic_preembed_batch)):
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
    want_ckpts = sorted({f"step_{i}.pt" for i in range(2, TRAIN_STEPS + 1, 2)}
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


def phase_train_wide(card: str, tmp: Path, texts: list[str],
                     images: list[str]) -> dict:
    """phase_train's main path at the fusion CLI's wider widths, bf16,
    dropout 0.1, batch 256: `--embed_dim 384 | 512 --num_heads 4` (head
    dims 96 / 128, F 1536 / 2048), exactly the launches of (d) a step and
    no call of the explicit attention; the losses finite and falling (the
    last half of the steps' mean below the first half's). Then the saved
    best_model.pt served through MisinformationPredictor(ModelConfig(
    embed_dim=..., num_heads=4), checkpoint_path=...) and a ServingEngine
    over the serve phase's encoders, batch 16: 56 #1 launches a batch, of
    which the fusion model's 8 at its head dim. Returns each run's
    launches by phase."""
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models.frozen import load_or_init_frozen
    from mmd_tpu_torch.ops import attention as A

    explicit, flash = A.explicit_attention, A._flash_attention_cuda
    explicit_calls, by_dh = [0], {}

    def counted_explicit(*a, **k):
        explicit_calls[0] += 1
        return explicit(*a, **k)

    def counted_flash(q, k, v, num_heads, *a):
        dh = q.shape[-1] // num_heads
        by_dh[dh] = by_dh.get(dh, 0) + 1
        return flash(q, k, v, num_heads, *a)

    by_phase = {}
    enc = load_or_init_frozen(tmp / "assets_serve", vocab_texts=texts,
                              vocab_size=30000, seed=0)
    for embed in WIDE_EMBEDS:
        phase, dh = f"train_wide_{embed}", embed // WIDE_HEADS
        A.explicit_attention = counted_explicit
        try:
            t0 = time.perf_counter()
            by_phase[phase] = phase_train(
                card, tmp, phase, PER_STEP_BF16,
                ["--embed_dim", str(embed), "--num_heads", str(WIDE_HEADS),
                 "--save_best"])
            train_s = time.perf_counter() - t0
            recs = [json.loads(x) for x in (tmp / phase / "metrics.jsonl")
                    .read_text().splitlines()]
            losses = [r["train/total_loss"] for r in recs
                      if "train/total_loss" in r]
            half = len(losses) // 2
            first, last = np.mean(losses[:half]), np.mean(losses[-half:])
            print(f"{phase}: explicit attention calls {explicit_calls[0]} "
                  f"(want 0); mean loss of the first / last {half} steps "
                  f"{first:.4f} / {last:.4f}; phase {train_s:.1f} s  "
                  f"[{card}]", flush=True)
            if explicit_calls[0]:
                fail(f"{phase}: the explicit attention path ran")
            if not last < first:
                fail(f"{phase}: the loss did not fall: {losses}")

            serve_phase = f"serve_wide_{embed}"
            t0 = time.perf_counter()
            pred = MisinformationPredictor(
                ModelConfig(embed_dim=embed, num_heads=WIDE_HEADS,
                            fused_attn=True),
                checkpoint_path=str(tmp / phase / "best_model.pt"),
                encoders=enc, max_length=512, batch_size=BATCH,
                device="cuda")
            _describe(serve_phase, pred, f"{time.perf_counter() - t0:.1f} s")
            by_dh.clear()
            A._flash_attention_cuda = counted_flash
            launches, _, _ = _drive(serve_phase, card, pred, texts, images,
                                    {"flash_attn_fwd": LAUNCHES_PER_BATCH},
                                    WIDE_SERVE_REQUESTS)
        finally:
            A.explicit_attention = explicit
            A._flash_attention_cuda = flash
        # _drive's warm-up batch ran before its counted run
        batches = launches["flash_attn_fwd"] // LAUNCHES_PER_BATCH + 1
        print(f"{serve_phase}: #1 launches by head dim {json.dumps(by_dh)} "
              f"over {batches} batches with the warm-up (want "
              f"{FUSION_PER_BATCH} a batch at dh {dh}); explicit attention "
              f"calls {explicit_calls[0]}  [{card}]", flush=True)
        if by_dh.get(dh) != FUSION_PER_BATCH * batches or explicit_calls[0]:
            fail(f"{serve_phase}: the fusion model's #1 launches "
                 f"{by_dh.get(dh)}, want {FUSION_PER_BATCH * batches}")
        by_phase[serve_phase] = launches
        del pred
        torch.cuda.empty_cache()
    _SYNTHETIC.clear()                    # the last of phase_train's runs
    return by_phase


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


class _ExplicitSwin:
    """Counts the Swin window attentions that take the explicit path
    (models/swin.py::_cosine_window_attention) while active."""

    def __enter__(self):
        from mmd_tpu_torch.models import swin as SW
        self.calls, self._orig = 0, SW._cosine_window_attention

        def counted(*args, **kw):
            self.calls += 1
            return self._orig(*args, **kw)

        SW._cosine_window_attention = counted
        return self

    def __exit__(self, *exc):
        from mmd_tpu_torch.models import swin as SW
        SW._cosine_window_attention = self._orig


def _by_tokens(calls: dict) -> dict:
    """An _InSitu record's launches summed by tokens a window (the third
    dim of the first tensor argument)."""
    out: dict[int, int] = {}
    for key, rec in calls.items():
        n = key[0][0][2]
        out[n] = out.get(n, 0) + rec["n"]
    return out


def phase_swin_window16(card: str, tmp: Path, texts: list[str],
                        images: list[str]) -> tuple[dict, dict]:
    """A Swinv2 window-16 checkpoint (SWINV2_BASE_W16_HF, seeded) and
    DeBERTa-v3-xsmall served from converted assets, then fine-tuned: #7 at
    n 256 and 64 a served batch, #8 and #9 a step, no window attention on
    the explicit path; every geometry held in situ. Returns the kernel
    launches of both counted runs, the in-situ rows and the Swin kernels'
    launches by tokens a window (kernel -> n -> launches)."""
    from mmd_tpu_torch.convert_hf import write_asset
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.data.spm import UnigramTokenizer
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models import deberta as D
    from mmd_tpu_torch.models import swin as SW
    from mmd_tpu_torch.profile_train import (FT_BATCH, FT_SEQ, raw_batch,
                                             reference_encoders,
                                             reference_finetune)

    phase = "swin_window16"
    t0 = time.perf_counter()
    assets = tmp / "assets_window16"
    assets.mkdir()
    text_cfg = D.config_from_hf(DEBERTA_V3_XSMALL_HF)
    image_cfg = SW.config_from_hf(SWINV2_BASE_W16_HF)
    write_asset(assets, "deberta", D.init_deberta(
        torch.Generator().manual_seed(CONVERTED_SEEDS["deberta"]), text_cfg),
        text_cfg)
    write_asset(assets, "swinv2", SW.init_swin(
        torch.Generator().manual_seed(CONVERTED_SEEDS["swinv2"]), image_cfg),
        image_cfg)
    UnigramTokenizer(_spm_pieces(texts)).save(assets / "spm.json")
    cfg = ModelConfig(fused_attn=True)
    pred = MisinformationPredictor(cfg, assets_dir=str(assets),
                                   max_length=512, batch_size=BATCH,
                                   device="cuda")
    vc = pred.enc.vit_cfg
    if vc != image_cfg or vc.window_size != 16:
        fail(f"{phase}: the assets resolved to {vc}")
    _describe(phase, pred, f"{time.perf_counter() - t0:.3f} s  [{card}]")
    stages = [(vc.stage_res(i), vc.stage_window_shift(i, 0)[0])
              for i in range(vc.num_stages)]
    print(f"{phase}: Swinv2 window {vc.window_size}, stages (res, window) "
          f"{stages}", flush=True)
    reqs = _requests(texts, images, W16_REQUESTS)
    batches = [tuple([r[k] for r in reqs[j:j + BATCH]] for k in range(4))
               for j in range(0, W16_REQUESTS, BATCH)]
    pred.evaluate_batch(*batches[0])          # warm-up, outside the count
    torch.cuda.synchronize()

    # (a) served batches: #7 at n 256 and 64, the reference's other kernels
    _reset_counts()
    t1 = time.perf_counter()
    with _ExplicitSwin() as explicit, \
            _InSitu(only=("swin_window_attn",)) as in_situ:
        results = [r for batch in batches
                   for r in pred.evaluate_batch(*batch, detailed=True)]
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    served = _counts()
    for r, (_, ci, _, ei) in zip(results, reqs):
        _check_result(r, ci is not None, ei is not None)
    by_n = _by_tokens(in_situ.calls["swin_window_attn"])
    counted_by_n = {"swin_window_attn": by_n}
    want = {k: REFERENCE_PER_BATCH.get(k, 0) * len(batches) for k in served}
    want_n = {n: c * len(batches) for n, c in W16_BY_TOKENS.items()}
    print(f"{phase}: {len(results)} requests in {len(batches)} batches of "
          f"{BATCH}, {serve_s:.3f} s; launches {json.dumps(served)} (want "
          f"{json.dumps(want)}); #7 by tokens a window {json.dumps(by_n)} "
          f"(want {json.dumps(want_n)}); explicit-path window attentions "
          f"{explicit.calls}  [{card}]", flush=True)
    if served != want or by_n != want_n or explicit.calls:
        fail(f"{phase}: served launches {served}, #7 by tokens {by_n}, "
             f"{explicit.calls} explicit window attentions")
    rows = in_situ.hold(phase, card)

    # (b) fine-tuning steps: #8 and #9 at n 256 and 64, bf16
    enc = reference_encoders(assets)
    enc.text_cfg = dataclasses.replace(enc.text_cfg, compute_dtype="bfloat16")
    trainer = reference_finetune(enc)
    state = trainer.init()
    tc, vc = enc.text_cfg, enc.vit_cfg
    if vc.window_size != 16 or not vc.fused_train:
        fail(f"{phase}: fine-tuning resolved {vc}")
    rng = np.random.default_rng(9)
    steps = [raw_batch(rng, FT_BATCH, FT_SEQ, tc.vocab_size, vc.image_size)
             for _ in range(W16_FT_STEPS)]
    torch.cuda.synchronize()
    _reset_counts()
    losses, times = [], []
    train = ("swin_attn_train_fwd", "swin_attn_train_bwd")
    with _ExplicitSwin() as explicit, _InSitu(only=train) as in_situ:
        for batch in steps:
            t1 = time.perf_counter()
            state, aux = trainer.train_step(state, trainer.shard_batch(batch))
            losses.append(float(aux["loss"]))    # synchronizes
            times.append(1e3 * (time.perf_counter() - t1))
    tuned = _counts()
    want = {k: FT_PER_STEP.get(k, 0) * W16_FT_STEPS for k in tuned}
    by_n = {k: _by_tokens(in_situ.calls[k]) for k in train}
    counted_by_n.update(by_n)
    want_n = {n: c * W16_FT_STEPS for n, c in W16_BY_TOKENS.items()}
    print(f"{phase}: {W16_FT_STEPS} bf16 fine-tuning steps at batch "
          f"{FT_BATCH}, {FT_SEQ} tokens: loss {json.dumps(losses)}, wall "
          f"{json.dumps([round(x, 3) for x in times])} ms; launches "
          f"{json.dumps(tuned)} (want {json.dumps(want)}); by tokens a "
          f"window {json.dumps(by_n)} (want {json.dumps(want_n)} each); "
          f"explicit-path window attentions {explicit.calls}  [{card}]",
          flush=True)
    if (tuned != want or any(v != want_n for v in by_n.values())
            or explicit.calls or not all(map(math.isfinite, losses))):
        fail(f"{phase}: fine-tuning launches {tuned}, by tokens {by_n}, "
             f"{explicit.calls} explicit window attentions, losses {losses}")
    for name, got in in_situ.hold(phase, card).items():
        rows[name] = got
    del trainer, state, pred
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return {k: served[k] + tuned[k] for k in served}, rows, counted_by_n


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
    _reset_native()
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
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    python_tok = WordPieceTokenizer(tok.vocab)
    python_tok._native = False                # the Python encoder
    for part, words in ((slice(0, 64), "2-4"), (slice(-64, None),
                                                "~600")):
        _check_native(phase, card, "tokenizer", f"the build's batch of 64 "
                      f"texts of {words} words at 512 tokens",
                      lambda: tok.encode_batch(texts[part], max_length=512),
                      lambda: python_tok.encode_batch(texts[part],
                                                      max_length=512))
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches


# -- the captioner -------------------------------------------------------------

def _write_safetensors(path: Path, tensors: dict) -> None:
    """A .safetensors file (HF's layout: a little-endian u64 header size, a
    JSON header of dtype, shape and byte offsets, then the buffers), fp32
    tensors only; the card's machine has no safetensors package."""
    header, bufs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        bufs.append(b)
        off += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in bufs:
            f.write(b)


def _blip_state_dict(seed: int) -> dict:
    """Seeded BLIP-base weights under HF BlipForConditionalGeneration's
    names (normal(0, 0.02) matrices and embeddings, as HF initializes
    them; small random biases; LayerNorms at scale 1 + noise). The head's
    output projection is left out, as save_pretrained leaves it out (tied
    to the word embeddings)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {}

    def put(name, *shape, std=0.02, mean=0.0):
        sd[name] = (mean + std * torch.randn(*shape, device=dev,
                                             generator=gen)).cpu()

    def lin(name, o, i):
        put(f"{name}.weight", o, i)
        put(f"{name}.bias", o, std=0.01)

    def ln(name, d):
        put(f"{name}.weight", d, std=0.05, mean=1.0)
        put(f"{name}.bias", d, std=0.02)

    v, t = BLIP_VISION, BLIP_TEXT
    d, p = v["hidden_size"], v["patch_size"]
    n_pos = (v["image_size"] // p) ** 2 + 1
    put("vision_model.embeddings.class_embedding", 1, 1, d)
    put("vision_model.embeddings.position_embedding", 1, n_pos, d)
    put("vision_model.embeddings.patch_embedding.weight", d, 3, p, p)
    put("vision_model.embeddings.patch_embedding.bias", d, std=0.01)
    for i in range(v["num_hidden_layers"]):
        pre = f"vision_model.encoder.layers.{i}"
        lin(f"{pre}.self_attn.qkv", 3 * d, d)
        lin(f"{pre}.self_attn.projection", d, d)
        ln(f"{pre}.layer_norm1", d)
        lin(f"{pre}.mlp.fc1", v["intermediate_size"], d)
        lin(f"{pre}.mlp.fc2", d, v["intermediate_size"])
        ln(f"{pre}.layer_norm2", d)
    ln("vision_model.post_layernorm", d)
    h, e = t["hidden_size"], t["encoder_hidden_size"]
    emb = "text_decoder.bert.embeddings"
    put(f"{emb}.word_embeddings.weight", t["vocab_size"], h)
    put(f"{emb}.position_embeddings.weight", t["max_position_embeddings"], h)
    ln(f"{emb}.LayerNorm", h)
    for i in range(t["num_hidden_layers"]):
        pre = f"text_decoder.bert.encoder.layer.{i}"
        for att, kv_in in (("attention", h), ("crossattention", e)):
            lin(f"{pre}.{att}.self.query", h, h)
            lin(f"{pre}.{att}.self.key", h, kv_in)
            lin(f"{pre}.{att}.self.value", h, kv_in)
            lin(f"{pre}.{att}.output.dense", h, h)
            ln(f"{pre}.{att}.output.LayerNorm", h)
        lin(f"{pre}.intermediate.dense", t["intermediate_size"], h)
        lin(f"{pre}.output.dense", h, t["intermediate_size"])
        ln(f"{pre}.output.LayerNorm", h)
    lin("text_decoder.cls.predictions.transform.dense", h, h)
    ln("text_decoder.cls.predictions.transform.LayerNorm", h)
    put("text_decoder.cls.predictions.bias", t["vocab_size"], std=0.01)
    return sd


def _blip_vocab() -> list[str]:
    """bert-base-uncased's layout ([PAD] 0, [UNK] 100, [CLS] 101, [SEP]
    102, [MASK] 103), filler words up to 30,522, then BLIP's [DEC] and
    [ENC]."""
    n = BLIP_TEXT["vocab_size"] - 2
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"w{i}" for i in range(n - len(vocab))]
    return vocab + ["[DEC]", "[ENC]"]


class _ViTLaunches:
    """Splits a counted run's #1 and #2 launches between the ViT and the
    decoder: patches vit.vit_forward to read the counts around each call
    and, through a hook on its output, when the backward reaches the ViT
    (the decoder's backward is done by then; the ViT's starts after)."""

    def __init__(self):
        self.fwd = 0            # #1 launches inside vit_forward
        self.decoder_bwd = 0    # #2 launches before the ViT's backward

    def __enter__(self):
        from mmd_tpu_torch.models import vit as V
        self._V, self._orig = V, V.vit_forward

        def counted(*args, **kwargs):
            before = _counts()
            out = self._orig(*args, **kwargs)
            self.fwd += _counts()["flash_attn_fwd"] - before["flash_attn_fwd"]
            if out.requires_grad:
                def reached(_grad):
                    self.decoder_bwd += (_counts()["flash_attn_bwd"]
                                         - before["flash_attn_bwd"])
                out.register_hook(reached)
            return out

        V.vit_forward = counted
        return self

    def __exit__(self, *exc):
        self._V.vit_forward = self._orig


def _time_flash_caption(card: str) -> dict:
    """#1 alone at BLIP-base's decode geometry (B 32, T 1, S 577, 12 heads
    of dh 64) and its ViT geometry (T = S = 577), fp32, beside its plain
    version and SDPA."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    b, s, d, h = CAPTION_B, 577, 768, 12
    out = {}
    for name, t in (("caption_decode", 1), ("caption_vit", 577)):
        q, k, v = (torch.randn(b, n, d, device=dev, generator=gen)
                   for n in (t, s, s))
        o, lse = A.flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_attention_plain(q, k, v, h)
        err = (o - o_ref).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = err <= KERNEL_TOL[torch.float32] and lse_err <= LSE_TOL
        print(f"kernel flash_attn_fwd {name:>14}  torch.float32: max_abs_err "
              f"{err:.3e} (tol {KERNEL_TOL[torch.float32]:.0e}), lse err "
              f"{lse_err:.3e} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"flash kernel disagrees with its plain version at {name}")
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                      for x in (q, k, v))
        row = {"ms": _time_ms(lambda: A.flash_attention(q, k, v, h),
                              iters=50),
               "plain_ms": _time_ms(lambda: A.flash_attention_plain(
                   q, k, v, h), iters=10),
               "library_ms": _time_ms(lambda: sdpa(qh, kh, vh), iters=50)}
        row["bound_ms"], row["bound_by"] = _flash_bound_ms(
            q, k, h, None, _peak(torch.float32))
        _print_time("flash_attn_fwd", f"{name} fp32 B={b} T={t} S={s} D={d} "
                    f"H={h}", row, card)
        out[name] = {**row, "max_abs_err": err,
                     "library_note": "torch.nn.functional.scaled_dot_product"
                                     "_attention, (B, H, T, dh) views"}
    return out


def _captions_by_path(csv: Path) -> dict:
    import pandas as pd
    df = pd.read_csv(csv)
    caps = {}
    for col, cap in (("claim_image", "claim_image_caption"),
                     ("evidence_image", "evidence_image_caption")):
        for p, c in zip(df[col], df[cap]):
            caps[p] = "" if isinstance(c, float) else c
    return caps


def phase_caption(card: str, tmp: Path) -> tuple[dict, dict]:
    """BLIP-base from files, as a user captions with it: seeded weights in
    HF's layout -> python -m mmd_tpu_torch.convert_hf --blip -> python -m
    mmd_tpu_torch.pipelines.caption over 32 preprocessed rows (64 images,
    one path missing: 2 batches of 32), then again after cutting the last
    16 rows (the resume). Checks (a) the captions from the files equal
    those of the same params held in memory, (b) the kernel path against
    the explicit path, teacher-forced, (c) a second decode bit for bit,
    (d) 780 #1 launches a batch and no other kernel. Returns the counted
    launches and #1's timings at the captioner's geometries."""
    import pandas as pd

    from mmd_tpu_torch import convert_hf
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmd_tpu_torch.models import captioner as C
    from mmd_tpu_torch.models import vit as V
    from mmd_tpu_torch.ops.image_ops import (
        load_images_parallel, normalize_on_device,
    )
    from mmd_tpu_torch.pipelines import caption as CP

    phase = "caption"
    t_phase = time.perf_counter()
    hf_dir, assets, root = tmp / "blip_hf", tmp / "blip_assets", tmp / "cap"
    hf_dir.mkdir()
    sd = _blip_state_dict(19)
    (hf_dir / "config.json").write_text(json.dumps({
        "model_type": "blip",
        "architectures": ["BlipForConditionalGeneration"],
        "text_config": BLIP_TEXT, "vision_config": BLIP_VISION}))
    _write_safetensors(hf_dir / "model.safetensors", sd)
    vocab = _blip_vocab()
    (hf_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    t_write = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    convert_hf.main(["--blip", str(hf_dir), "--out", str(assets)])
    t_convert = time.perf_counter() - t0
    print(f"{phase}: HF directory written in {t_write:.1f} s "
          f"({(hf_dir / 'model.safetensors').stat().st_size / 2 ** 20:.0f} "
          f"MiB), converted in {t_convert:.1f} s", flush=True)

    rng = np.random.default_rng(19)
    paths = _write_jpegs(root / "images", rng, 2 * CAPTION_ROWS - 1)
    paths.insert(CAPTION_ROWS + 3, str(root / "images" / "missing.jpg"))
    rel = [str(Path(p).relative_to(root)) for p in paths]
    from mmd_tpu_torch.inference.traffic import corpus
    texts = corpus(rng, 2 * CAPTION_ROWS)
    pre = root / "data" / "preprocessed"
    pre.mkdir(parents=True)
    pd.DataFrame({"claim": texts[:CAPTION_ROWS],
                  "evidence": texts[CAPTION_ROWS:],
                  "claim_image": rel[:CAPTION_ROWS],
                  "evidence_image": rel[CAPTION_ROWS:],
                  "category": ["Support_Multimodal"] * CAPTION_ROWS}).to_csv(
        pre / "train.csv", index=False)
    out_csv = pre / "train_enriched.csv"
    argv = ["--datasets", "train", "--root", str(root), "--assets",
            str(assets), "--device", "cuda"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    in_vit = _ViTLaunches()
    t0 = time.perf_counter()
    with in_vit:
        CP.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want["flash_attn_fwd"] = 2 * CAPTION_PER_BATCH
    print(f"{phase}: python -m mmd_tpu_torch.pipelines.caption, "
          f"{CAPTION_ROWS} rows ({2 * CAPTION_ROWS} images, 1 missing, 2 "
          f"batches of {CAPTION_B}, {CAPTION_STEPS} steps) in {run_s:.2f} s "
          f"with loading the assets: {2 * CAPTION_ROWS / run_s:.2f} images/s; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB; launches "
          f"{json.dumps(launches)} (want {json.dumps(want)})  [{card}]",
          flush=True)
    if launches != want:
        fail(f"{phase}: (d) launches {launches}, want {want}")
    first = pd.read_csv(out_csv)
    caps = _captions_by_path(out_csv)
    if caps[rel[CAPTION_ROWS + 3]] != "" or sum(
            1 for c in caps.values() if c) != 2 * CAPTION_ROWS - 1:
        fail(f"{phase}: want a caption for every image but the missing one")

    # the resume: cut the last 16 rows, run again, the same file back
    cut = first.copy()
    cut.loc[CAPTION_ROWS // 2:, ["claim_image_caption",
                                 "evidence_image_caption", "claim_enriched",
                                 "evidence_enriched"]] = np.nan
    cut.to_csv(out_csv, index=False)
    _reset_counts()
    with in_vit:
        CP.main(argv)
    torch.cuda.synchronize()
    resumed = _counts()
    for k, n in resumed.items():
        launches[k] += n
    again = pd.read_csv(out_csv)
    same = again.equals(first)
    print(f"{phase}: resumed at row {CAPTION_ROWS // 2}: launches "
          f"{resumed['flash_attn_fwd']} of #1 (want {CAPTION_PER_BATCH}); "
          f"the file {'equals' if same else 'DIFFERS from'} the first run's",
          flush=True)
    if resumed["flash_attn_fwd"] != CAPTION_PER_BATCH or not same:
        fail(f"{phase}: the resume did not finish the file as the first run")
    # (d) by stage over the 3 batches: the ViT's one a layer, the decode
    # loop's one a layer a step
    split = {"caption_vit": in_vit.fwd,
             "caption_decode": launches["flash_attn_fwd"] - in_vit.fwd}
    want_split = {"caption_vit": 3 * BLIP_VISION["num_hidden_layers"],
                  "caption_decode": 3 * CAPTION_STEPS
                  * BLIP_TEXT["num_hidden_layers"]}
    print(f"{phase}: (d) #1 launches over the 3 batches, counted inside the "
          f"ViT and the rest: {json.dumps(split)} (want "
          f"{json.dumps(want_split)})", flush=True)
    if split != want_split:
        fail(f"{phase}: (d) #1 launches by stage {split}")

    # (a) the same params held in memory, through the pipeline's engine
    tok = WordPieceTokenizer(vocab)
    cfg = C.blip_config(BLIP_VISION, BLIP_TEXT)
    params = C.load_hf_blip_state_dict(sd, cfg).to("cuda")
    engine = CP.CaptionEngine(tok, cfg=cfg, params=params,
                              batch_size=CAPTION_B, device="cuda")
    mem = engine.caption_paths([str(p) for p in paths])
    diff = [p for p, c in zip(rel, mem) if caps[p] != c]
    print(f"{phase}: (a) captions from the files against the params in "
          f"memory: {len(paths) - len(diff)} of {len(paths)} identical; "
          f"e.g. {mem[0][:60]!r}", flush=True)
    if diff:
        fail(f"{phase}: (a) {len(diff)} captions differ, e.g. {diff[:3]}")

    # one batch by stage: decode on the host, the ViT, the decode loop
    batch = [str(p) for p in paths[:CAPTION_B]]
    stages = {"image_decode": [], "vit": [], "decode_loop": []}
    for _ in range(3):
        t0 = time.perf_counter()
        u8, _ = load_images_parallel(batch, engine.transform)
        t1 = time.perf_counter()
        with torch.no_grad():
            x = normalize_on_device(torch.from_numpy(u8).to("cuda"),
                                    engine.transform, torch.float32)
            enc = V.vit_forward(params["vit"], cfg.vit, x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            toks, _ = C.decode(params, cfg, enc, engine.bos_id, tok.sep_id,
                               tok.pad_id)
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(dt)
    by_stage = {k: float(np.median(v)) for k, v in stages.items()}
    total = sum(by_stage.values())
    print(f"{phase}: a batch of {CAPTION_B} by stage (median of 3, host "
          f"clock, each ending in a synchronize): "
          f"{json.dumps({k: round(v, 4) for k, v in by_stage.items()})} s; "
          f"{CAPTION_B / total:.2f} images/s  [{card}]", flush=True)

    # (b) the kernel path against the explicit path on that batch
    explicit = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, fused_attn=False),
        decoder=dataclasses.replace(cfg.decoder, fused_attn=False))
    with torch.no_grad():
        enc_e = V.vit_forward(params["vit"], explicit.vit, x)
        tok_e, _ = C.decode(params, explicit, enc_e, engine.bos_id,
                            tok.sep_id, tok.pad_id)
        _, logit_e = C.decode(params, explicit, enc_e, engine.bos_id,
                              tok.sep_id, tok.pad_id, forced=tok_e)
        _, logit_k = C.decode(params, cfg, enc, engine.bos_id, tok.sep_id,
                              tok.pad_id, forced=tok_e)
    scale = logit_e.abs().max().item()
    err = (logit_k - logit_e).abs().max().item()
    tol = CAPTION_LOGIT_RTOL * scale
    top2 = logit_e.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    # tokens must agree up to the first step whose gap is within tol
    decisive = torch.cumprod((gap > tol).long(), dim=1).bool()
    agree = bool(((toks == tok_e) | ~decisive).all())
    print(f"{phase}: (b) kernel path against the explicit path, "
          f"teacher-forced over {CAPTION_B} x {CAPTION_STEPS} steps: logits "
          f"max difference {err:.3e} (tol {tol:.3e}: {CAPTION_LOGIT_RTOL:.0e}"
          f" of the largest |logit| {scale:.3f}); tokens "
          f"{'equal' if agree else 'DIFFER'} at the "
          f"{int(decisive.sum())} steps before a near tie (of "
          f"{decisive.numel()}; {int((toks == tok_e).sum())} equal in all)",
          flush=True)
    if not (err <= tol and agree):
        fail(f"{phase}: (b) the kernel path and the explicit path disagree")

    # (c) a second decode, bit for bit
    with torch.no_grad():
        toks2, _ = C.decode(params, cfg, enc, engine.bos_id, tok.sep_id,
                            tok.pad_id)
        _, logit_k2 = C.decode(params, cfg, enc, engine.bos_id, tok.sep_id,
                               tok.pad_id, forced=tok_e)
    rep = torch.equal(toks2, toks) and torch.equal(logit_k2, logit_k)
    print(f"{phase}: (c) a second decode {'bit-identical' if rep else 'DIFFERS'}",
          flush=True)
    if not rep:
        fail(f"{phase}: (c) the decode is not repeatable")
    # where a decode loop spends the card's time: its first
    # PROFILE_STEPS steps (the steps are alike; reducing a whole loop's
    # ~33,000 device events takes torch.profiler ~25 s)
    from mmd_tpu_torch import profiling as PR
    from mmd_tpu_torch.profile_train import KERNELS
    prof = PR.profile_window(lambda: C.decode(
        params, cfg, enc, engine.bos_id, tok.sep_id, tok.pad_id,
        PROFILE_STEPS), 1, KERNELS)
    print(f"{phase}: torch.profiler over a decode loop of {PROFILE_STEPS} "
          f"steps (B {CAPTION_B}): window {prof['window_ms']:.1f} ms, device "
          f"busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_events']} device events; "
          f"device ms by group "
          f"{json.dumps({k: round(v, 2) for k, v in prof['device_ms_by_group'].items()})}"
          f"  [{card}]", flush=True)
    timings = _time_flash_caption(card)
    for name, n in split.items():
        timings[name]["launches_in_phase"] = n
    del params, engine, sd, logit_e, logit_k, logit_k2
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, timings


# the default captioner's geometries of #1 (and of #2 where it trains),
# bf16, dh 64: the ViT's self-attention (T = S = 64, 16 heads) and a
# 32-token caption's cross-attention over its 64 tokens (6 heads) in a
# training step of 32; a decode step's cross-attention (T 1) in a caption
# batch of 32; and the LVLM scorer's one image and its 64-token prompt
TRAIN_CAP_GEOMS = [
    dict(name="train_captioner_vit", b=32, t=64, s=64, d=1024, h=16,
         bwd=True),
    dict(name="train_captioner_cross", b=32, t=32, s=64, d=384, h=6,
         bwd=True),
    dict(name="train_captioner_decode", b=32, t=1, s=64, d=384, h=6,
         bwd=False),
    dict(name="lvlm_vit", b=1, t=64, s=64, d=1024, h=16, bwd=False),
    dict(name="lvlm_cross", b=1, t=64, s=64, d=384, h=6, bwd=False)]
# what train_captioner must launch at each, counted by _ViTLaunches: 8
# steps (forward and backward), one caption batch of 32 steps, one LVLM
# score with an image
TRAIN_CAP_SPLIT = {
    "flash_attn_fwd": {"train_captioner_vit": 8 * 12 + 12,
                       "train_captioner_cross": 8 * 6,
                       "train_captioner_decode": 32 * 6,
                       "lvlm_vit": 12, "lvlm_cross": 6},
    "flash_attn_bwd": {"train_captioner_vit": 8 * 12,
                       "train_captioner_cross": 8 * 6}}


def _time_flash_train_captioner(card: str) -> dict:
    """#1 (and #2 where it trains) at the default captioner's geometries
    in bf16, each against its plain version on the same inputs, timed
    beside SDPA (and its backward)."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {"flash_attn_fwd": {}, "flash_attn_bwd": {}}
    tol = KERNEL_TOL[torch.bfloat16]
    for g in TRAIN_CAP_GEOMS:
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q, k, v, do = (torch.randn(b, n, d, device=dev, generator=gen)
                       .to(torch.bfloat16) for n in (t, s, s, t))
        o, lse = A.flash_attention(q, k, v, h)
        grads = A.flash_attention_bwd(q, k, v, o, lse, do, h) if g[
            "bwd"] else None
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_attention_plain(q.float(), k.float(),
                                                 v.float(), h)
        f_err = (o.float() - o_ref).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = f_err <= tol and lse_err <= LSE_TOL
        what = (f"forward max_abs_err {f_err:.3e} (tol {tol:.0e}), lse err "
                f"{lse_err:.3e}")
        if grads is not None:
            want = A.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                h)
            b_err = max((x.float() - w).abs().max().item()
                        / max(w.abs().max().item(), 1e-30)
                        for x, w in zip(grads, want))
            ok = ok and b_err <= _bwd_tol(torch.bfloat16)
            what += (f", backward {b_err:.3e} of each gradient's scale (tol "
                     f"{_bwd_tol(torch.bfloat16):.0e})")
            del want
        print(f"kernel flash_attn_fwd{'/bwd' if grads is not None else ''} "
              f"{g['name']}  torch.bfloat16: {what} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"flash kernels disagree with their plain versions at "
                 f"{g['name']}")
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2).detach()
                      .requires_grad_(g["bwd"]) for x in (q, k, v))
        fwd = {"ms": _time_ms(lambda: A.flash_attention(q, k, v, h),
                              iters=50),
               "plain_ms": _time_ms(lambda: A.flash_attention_plain(
                   q, k, v, h), iters=10),
               "library_ms": _time_ms(lambda: sdpa(qh, kh, vh), iters=50)}
        fwd["bound_ms"], fwd["bound_by"] = _flash_bound_ms(q, k, h, None)
        geom = f"{g['name']} bf16 B={b} T={t} S={s} D={d} H={h}"
        _print_time("flash_attn_fwd", geom, fwd, card)
        out["flash_attn_fwd"][g["name"]] = {
            **fwd, "max_abs_err": f_err,
            "library_note": "torch.nn.functional.scaled_dot_product_"
                            "attention, (B, H, T, dh) views"}
        if grads is not None:
            lib = sdpa(qh, kh, vh)
            gout = torch.randn_like(lib)
            bwd = {"ms": _time_ms(lambda: A.flash_attention_bwd(
                       q, k, v, o, lse, do, h), iters=50),
                   "plain_ms": _time_ms(lambda: A.flash_attention_bwd_plain(
                       q, k, v, o, lse, do, h), iters=10),
                   "library_ms": _time_ms(lambda: torch.autograd.grad(
                       lib, (qh, kh, vh), gout, retain_graph=True),
                       iters=50)}
            bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
                q.element_size() * (4 * b * t * d + 4 * b * s * d)
                + 4 * b * h * t, 10 * b * t * s * d)
            _print_time("flash_attn_bwd", geom, bwd, card)
            out["flash_attn_bwd"][g["name"]] = {
                **bwd, "max_rel_err": b_err,
                "library_note": "the backward of torch.nn.functional.scaled_"
                                "dot_product_attention (forward excluded)"}
            del lib, gout
        del o, lse, grads, qh, kh, vh
    return out


def _caption_pairs(d: Path, rng: np.random.Generator, n: int) -> Path:
    """n (image, caption) pairs: JPEGs and seeded captions of 4-12 words."""
    import pandas as pd
    words = ["a", "photo", "of", "the", "river", "city", "crowd", "near",
             "bridge", "man", "woman", "sign", "with", "red", "blue",
             "flag", "street", "at", "night", "during", "protest", "market"]
    paths = _write_jpegs(d / "images", rng, n)
    caps = [" ".join(rng.choice(words, rng.integers(4, 13)))
            for _ in range(n)]
    csv = d / "pairs.csv"
    pd.DataFrame({"claim_image": paths, "claim_image_caption": caps}
                 ).to_csv(csv, index=False)
    return csv


def phase_train_captioner(card: str, tmp: Path) -> dict:
    """python -m mmd_tpu_torch.pipelines.train_captioner with the default
    CaptionerConfig() (bf16) over 128 pairs, batch 32, 2 epochs; then the
    caption pipeline with the captioner.pt it wrote, eval_prompting --llm
    captioner on 8 rows and the LVLM scorer with and without an image.
    Checks: finite losses, the launches of each, and one fp32 step and
    one bf16 loss of the kernel path against the explicit path. Returns
    the counted launches and #1's and #2's split of them by geometry."""
    import pandas as pd

    from mmd_tpu_torch.baselines import eval_prompting as EP
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmd_tpu_torch.inference.traffic import corpus
    from mmd_tpu_torch.models import captioner as C
    from mmd_tpu_torch.models import layers as L
    from mmd_tpu_torch.ops.image_ops import (
        load_images_parallel, normalize_on_device,
    )
    from mmd_tpu_torch.pipelines import caption as CP
    from mmd_tpu_torch.pipelines import train_captioner as TRC

    phase = "train_captioner"
    t_phase = time.perf_counter()
    d = tmp / "train_cap"
    rng = np.random.default_rng(20)
    csv = _caption_pairs(d, rng, TRAIN_CAP_PAIRS)
    assets = d / "assets"
    step_s = []
    plain_step = TRC.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = plain_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return loss

    TRC.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    in_train, in_cap, in_lvlm = _ViTLaunches(), _ViTLaunches(), _ViTLaunches()
    try:
        with in_train:
            losses = TRC.main(["--csv", str(csv), "--assets", str(assets),
                               "--epochs", str(TRAIN_CAP_EPOCHS),
                               "--batch_size", str(TRAIN_CAP_B),
                               "--max_len", "32", "--device", "cuda"])
    finally:
        TRC.train_step = plain_step
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want.update({k: v * TRAIN_CAP_STEPS for k, v in TRAIN_CAP_PER_STEP.items()})
    cfg_d = json.loads((assets / "captioner_config.json").read_text())
    print(f"{phase}: ViT {cfg_d['vit']['hidden_size']} x "
          f"{cfg_d['vit']['num_layers']} ({cfg_d['vit']['image_size']} px / "
          f"{cfg_d['vit']['patch_size']}), decoder "
          f"{cfg_d['decoder']['hidden_size']} x "
          f"{cfg_d['decoder']['num_layers']}, vocabulary "
          f"{cfg_d['decoder']['vocab_size']}, "
          f"{cfg_d['decoder']['compute_dtype']}; {len(losses)} steps, loss "
          f"by step {json.dumps([round(x, 4) for x in losses])}; step wall "
          f"median {1e3 * float(np.median(step_s)):.3f} ms "
          f"({json.dumps([round(1e3 * x, 3) for x in step_s])} ms, each "
          f"ending in a synchronize); peak device memory "
          f"{peak / 2 ** 30:.3f} GiB; launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})  [{card}]", flush=True)
    if len(losses) != TRAIN_CAP_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{phase}: losses {losses}")
    if launches != want:
        fail(f"{phase}: launches {launches}, want {want}")

    # caption with the trained captioner.pt, through the pipeline
    root = d / "root"
    pre = root / "data" / "preprocessed"
    pre.mkdir(parents=True)
    pairs = pd.read_csv(csv)
    texts = corpus(rng, 32)
    pd.DataFrame({"claim": texts[:16], "evidence": texts[16:],
                  "claim_image": pairs["claim_image"][:16].tolist(),
                  "evidence_image": pairs["claim_image"][16:32].tolist(),
                  "category": ["Refute"] * 8 + ["Support_Text"] * 8}
                 ).to_csv(pre / "test.csv", index=False)
    _reset_counts()
    with in_cap:
        CP.main(["--datasets", "test", "--root", str(root), "--assets",
                 str(assets), "--device", "cuda"])
    torch.cuda.synchronize()
    cap_launches = _counts()
    enriched = pd.read_csv(pre / "test_enriched.csv")
    n_caps = int((enriched["claim_image_caption"].fillna("") != "").sum()
                 + (enriched["evidence_image_caption"].fillna("") != ""
                    ).sum())
    print(f"{phase}: the caption pipeline with the trained captioner.pt: 32 "
          f"images, {n_caps} non-empty captions, e.g. "
          f"{enriched['claim_image_caption'][0]!r}; #1 launches "
          f"{cap_launches['flash_attn_fwd']} (want "
          f"{DEFAULT_CAPTION_PER_BATCH})", flush=True)
    if cap_launches != {**{k: 0 for k in cap_launches},
                        "flash_attn_fwd": DEFAULT_CAPTION_PER_BATCH}:
        fail(f"{phase}: the caption batch launched {cap_launches}")

    # what the 8-step captioner emits first, over the same 32 images
    tok = WordPieceTokenizer.load(assets / "tokenizer.json")
    _, cfg_t, params_t = C.load_captioner_assets(assets, "cuda")
    eng = CP.CaptionEngine(tok, cfg=cfg_t, params=params_t, device="cuda")
    u8, _ = load_images_parallel(pairs["claim_image"][:32].tolist(),
                                 eng.transform)
    firsts = eng.generate_uint8(u8)[:, 0].cpu().tolist()
    top = max(set(firsts), key=firsts.count)
    print(f"{phase}: its first token: {tok.vocab[top]!r} in "
          f"{firsts.count(top)} of 32 images (an empty caption when it is "
          f"[SEP])", flush=True)
    del eng, params_t

    # eval_prompting --llm captioner on 8 rows, then the LVLM scorer
    _reset_counts()
    report = EP.main(["--csv", str(pre / "test.csv"), "--llm", "captioner",
                      "--limit", "8", "--assets", str(assets),
                      "--results_json", str(d / "prompting.json"),
                      "--device", "cuda"])
    torch.cuda.synchronize()
    llm_launches = _counts()
    score = EP.make_lvlm_scorer(str(assets), device="cuda")
    prompt = "Claim: the river flooded the city. Evidence: a photo. Answer:"
    _reset_counts()
    p_text = score(prompt)
    text_launches = _counts()["flash_attn_fwd"]
    _reset_counts()
    with in_lvlm:
        p_image = score(prompt, image_path=pairs["claim_image"][0])
    image_launches = _counts()
    print(f"{phase}: eval_prompting --llm captioner, 8 rows: accuracy "
          f"{report['accuracy']:.3f}, launches {sum(llm_launches.values())} "
          f"(the decoder runs text-only: explicit causal attention); LVLM "
          f"P(yes) {p_text:.4f} without the image ({text_launches} #1 "
          f"launches), {p_image:.4f} with it "
          f"({image_launches['flash_attn_fwd']}, want "
          f"{LVLM_PER_IMAGE_SCORE})", flush=True)
    if (sum(llm_launches.values()) or text_launches
            or image_launches != {**{k: 0 for k in image_launches},
                                  "flash_attn_fwd": LVLM_PER_IMAGE_SCORE}
            or not (0.0 <= p_text <= 1.0 and 0.0 <= p_image <= 1.0)
            or p_text == p_image):
        fail(f"{phase}: the prompting baselines' launches or scores")
    # the launches by geometry: inside the ViT, and the rest
    split = {"flash_attn_fwd": {
        "train_captioner_vit": in_train.fwd + in_cap.fwd,
        "train_captioner_cross": launches["flash_attn_fwd"] - in_train.fwd,
        "train_captioner_decode": cap_launches["flash_attn_fwd"] - in_cap.fwd,
        "lvlm_vit": in_lvlm.fwd,
        "lvlm_cross": image_launches["flash_attn_fwd"] - in_lvlm.fwd},
        "flash_attn_bwd": {
        "train_captioner_vit": (launches["flash_attn_bwd"]
                                - in_train.decoder_bwd),
        "train_captioner_cross": in_train.decoder_bwd}}
    print(f"{phase}: launches by geometry, counted inside the ViT and the "
          f"rest: {json.dumps(split)} (want {json.dumps(TRAIN_CAP_SPLIT)})",
          flush=True)
    if split != TRAIN_CAP_SPLIT:
        fail(f"{phase}: launches by geometry {split}")
    for k in launches:
        launches[k] += (cap_launches[k] + llm_launches[k]
                        + image_launches[k])

    # one step of the kernel path against the explicit path: fp32 loss and
    # gradients, then the bf16 loss
    base = C.config_from_dict(cfg_d)
    rows = pairs.iloc[:TRAIN_CAP_B]
    tr = CP.image_transform(base)
    u8, ok = load_images_parallel(rows["claim_image"].tolist(), tr)
    ids, mask, _ = tok.encode_batch(rows["claim_image_caption"].tolist(),
                                    max_length=base.max_caption_len)
    ids_t = torch.from_numpy(ids).to("cuda", torch.int64)
    mask_t = torch.from_numpy(mask * ok[:, None].astype(np.int32)).to("cuda")
    u8_t = torch.from_numpy(u8).to("cuda")
    params = C.init_captioner(torch.Generator().manual_seed(0), base).cuda()
    res = {}
    for dtype in ("float32", "bfloat16"):
        for fused in (True, False):
            cfg = dataclasses.replace(
                base, vit=dataclasses.replace(base.vit, compute_dtype=dtype,
                                              fused_attn=fused),
                decoder=dataclasses.replace(base.decoder,
                                            compute_dtype=dtype,
                                            fused_attn=fused))
            params.zero_grad(set_to_none=True)
            x = normalize_on_device(u8_t, tr, L.dtype_of(dtype))
            loss = C.caption_loss(params, cfg, x, ids_t, mask_t)
            loss.backward()
            res[dtype, fused] = (loss.item(), {
                n: p.grad.detach().clone()
                for n, p in params.named_parameters()})
    (lf, gf), (le, ge) = res["float32", True], res["float32", False]
    loss_rel = abs(lf - le) / abs(le)
    worst, where = _grad_gap(gf, ge)
    lb, lbe = res["bfloat16", True][0], res["bfloat16", False][0]
    bf16_rel = abs(lb - lbe) / abs(lbe)
    ok = (loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL
          and bf16_rel <= PARITY_BF16_LOSS_RTOL)
    print(f"{phase}: one step, batch {TRAIN_CAP_B}, kernels against the "
          f"explicit path: fp32 loss {lf:.7f} / {le:.7f}, relative "
          f"{loss_rel:.3e} (tol {PARITY_LOSS_RTOL:.0e}); worst grad leaf "
          f"{where} at {worst:.3e} of its scale (tol "
          f"{PARITY_GRAD_RTOL:.0e}); bf16 loss {lb:.6f} / {lbe:.6f}, "
          f"relative {bf16_rel:.3e} (tol {PARITY_BF16_LOSS_RTOL:.0e}) -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the kernel path and the explicit path disagree")

    # where a bf16 training step spends the card's time
    from mmd_tpu_torch import profiling as PR
    from mmd_tpu_torch.profile_train import KERNELS, TRAIN_GROUPS
    opt = TRC.make_optimizer(params, 3e-4)

    def step():
        return TRC.train_step(params, opt, base, tr, u8_t, ids_t, mask_t)

    for _ in range(2):
        step()
    prof = PR.profile_window(step, 1, KERNELS, TRAIN_GROUPS + PR.GROUPS)
    print(f"{phase}: torch.profiler over a bf16 step: window "
          f"{prof['window_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_events']} device events; "
          f"device ms by group "
          f"{json.dumps({k: round(v, 2) for k, v in prof['device_ms_by_group'].items()})}"
          f"  [{card}]", flush=True)
    del params, res, opt
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, split


# run_all / run_all_reference: python -m mmd_tpu_torch.pipelines.run_all's
# default path, in process, at full width (seeded weights): the BERT-class
# text encoder (384 x 12, 512 tokens) and ViTConfig(), or with
# --reference_encoders DeBERTa-v3-xsmall and Swinv2-base; CaptionerConfig();
# MPNet and ResNet50 retrieval; the default ModelConfig in bf16. 256-px
# images, batch 32 (embed, caption); the train batch is run_all's own,
# half the train store at most.
RUN_ALL_ARGS = ["--image_size", "256", "--batch_size", "32"]
RUN_ALL = {"run_all": ["--synthetic", "64", "--epochs", "2"],
           "run_all_reference": ["--reference_encoders", "--synthetic", "32",
                                 "--epochs", "1"]}
RUN_ALL_B = 32
RUN_ALL_STAGES = ("synthesize", "preprocess", "assets", "caption", "embed",
                  "retrieval_build", "train", "eval", "demo_verify")
# an embed batch runs the frozen encoders of a served batch, not its
# fusion model: serve's 56 #1 less 8, serve_reference's less its 8 #1
EMBED_PER_BATCH = {"flash_attn_fwd": LAUNCHES_PER_BATCH - FUSION_PER_BATCH}
EMBED_PER_BATCH_REFERENCE = {k: v for k, v in REFERENCE_PER_BATCH.items()
                             if k != "flash_attn_fwd"}
# (e) the stored float16 rows (bf16 through the kernels) against one batch
# re-encoded in fp32 through the explicit path, relative L2 norm of each
# column's difference: bf16 roundings through 12 layers come to ~1e-2; a
# wrong kernel or a row out of place to ~1
REENCODE_REL_L2 = 5e-2
# (g) the fusion model's fp32 logits over the test store, kernels against
# the explicit path, relative to the largest |logit|; the predictions
# must agree wherever the explicit path's top-two gap exceeds it
EVAL_LOGIT_RTOL = 1e-3
LABELS = ("support", "not_enough_information", "refute")


class _StageLaunches:
    """Kernel launches by stage of a pipeline timed by core/profiling.py's
    Stages: Stages.stage is patched to read the counters around every
    logged stage (a stage's unlogged inner timers count in it)."""

    def __init__(self, counts=None):
        """counts() -> the counters to read (all launches by default; the
        fused run reads the launches of the stage's own thread)."""
        self.by_stage: dict[str, dict] = {}
        self._read = counts or _counts

    def __enter__(self):
        import contextlib

        from mmd_tpu_torch.core import profiling
        self._orig = orig = profiling.Stages.stage
        by_stage, read = self.by_stage, self._read

        @contextlib.contextmanager
        def stage(stages, name, log=True):
            before = read()
            with orig(stages, name, log):
                yield
            if log:
                acc = by_stage.setdefault(name, {k: 0 for k in before})
                for k, v in read().items():
                    acc[k] += v - before[k]

        profiling.Stages.stage = stage
        return self

    def __exit__(self, *exc):
        from mmd_tpu_torch.core import profiling
        profiling.Stages.stage = self._orig


class _RecordingSt:
    """A streamlit stand-in for demo/app.render_app: records every call;
    the text area answers `text`, nothing is uploaded, the button is
    pressed."""

    def __init__(self, text: str):
        self.calls: list[tuple] = []
        self._text = text

    def _ctx(self, *call):
        import contextlib
        self.calls.append(call)
        return contextlib.nullcontext(self)

    def __getattr__(self, kind):              # title, write, subheader, ...
        return lambda *a, **k: self.calls.append(
            (kind, " ".join(map(str, a))))

    def text_area(self, label, value="", **k):
        self.calls.append(("text_area", label))
        return self._text if label.startswith("Enter text") else value

    def file_uploader(self, *a, **k):
        return None

    def slider(self, label, lo, hi, default, **k):
        return default

    def button(self, label, **k):
        return True

    def container(self):
        return self._ctx("container")

    def spinner(self, label):
        return self._ctx("spinner", label)

    def columns(self, n):
        return [self._ctx("column") for _ in range(n)]

    def tabs(self, labels):
        return [self._ctx("tab", label) for label in labels]

    def progress(self, v):
        self.calls.append(("progress", v))
        return self


def _f32(args) -> list:
    """The arguments with every bf16 tensor widened to fp32."""
    return [a.float() if isinstance(a, torch.Tensor)
            and a.dtype == torch.bfloat16 else a for a in args]


def _ln_params(weight, bias):
    from types import SimpleNamespace
    return SimpleNamespace(weight=weight, bias=bias)


def _in_situ_kernels() -> dict:
    """kernel -> (op module, the private function that launches it, the
    public wrapper and the plain version, both called with the private
    function's arguments, and the positions of its seed arguments)."""
    from mmd_tpu_torch.ops import attention as A
    from mmd_tpu_torch.ops import deberta_attention as DA
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import ln as LN
    from mmd_tpu_torch.ops import mlp as M
    from mmd_tpu_torch.ops import swin_attention as SA
    return {
        "flash_attn_fwd": (A, "_flash_attention_cuda",
                           lambda a: A.flash_attention(*a),
                           lambda a: A.flash_attention_plain(*_f32(a)), (6,)),
        "flash_attn_bwd": (A, "_flash_attention_bwd_cuda",
                           lambda a: A.flash_attention_bwd(*a),
                           lambda a: A.flash_attention_bwd_plain(*_f32(a)),
                           (9,)),
        "mlp_fwd": (M, "_mlp_fwd_cuda", lambda a: M.fused_mlp_fwd(*a),
                    lambda a: M.fused_mlp_plain(*a), (5,)),
        "mlp_bwd": (M, "_mlp_bwd_cuda", lambda a: M.fused_mlp_bwd(*a),
                    lambda a: M.fused_mlp_bwd_plain(*a), (5,)),
        "dropout": (D, "_dropout_cuda", lambda a: D.dropout(*a),
                    lambda a: D.dropout_plain(*a), (2,)),
        "layernorm": (LN, "_layernorm_cuda",
                      lambda a: LN.fused_layernorm(_ln_params(a[0], a[1]),
                                                   a[2], a[3], a[4]),
                      lambda a: LN.fused_layernorm_plain(
                          _ln_params(a[0], a[1]), *_f32(a[2:3]), a[3],
                          *_f32(a[4:5])), ()),
        "swin_window_attn": (SA, "_swin_attention_cuda",
                             lambda a: SA.swin_window_attention_infer(*a),
                             lambda a: SA.swin_window_attention_infer_plain(
                                 *_f32(a)), ()),
        "deberta_attn_fwd": (DA, "_deberta_attention_cuda",
                             lambda a: DA.deberta_attention_fwd(*a),
                             lambda a: DA.deberta_attention_plain(*_f32(a)),
                             ()),
        "deberta_attn_bwd": (DA, "_deberta_attention_bwd_cuda",
                             lambda a: DA.deberta_attention_bwd(*a),
                             lambda a: DA.deberta_attention_bwd_plain(
                                 *_f32(a)), ()),
        "swin_attn_train_fwd": (SA, "_swin_train_fwd_cuda",
                                lambda a: SA.swin_window_attention_fwd(*a),
                                lambda a: SA.swin_window_attention_plain(
                                    *_f32(a)), ()),
        "swin_attn_train_bwd": (SA, "_swin_train_bwd_cuda",
                                lambda a: SA.swin_window_attention_bwd(*a),
                                lambda a: SA.swin_window_attention_bwd_plain(
                                    *_f32(a)), ())}


# the kernels _InSitu records unless told otherwise: the serving and the
# fusion model's training kernels (the fine-tuning backwards only where a
# phase names them)
IN_SITU_DEFAULT = ("flash_attn_fwd", "flash_attn_bwd", "mlp_fwd", "mlp_bwd",
                   "dropout", "layernorm", "swin_window_attn",
                   "deberta_attn_fwd")


def _geom_key(args, seeds) -> tuple:
    """A launch's geometry: each tensor's shape and dtype (None kept), every
    other argument but the seeds."""
    out = []
    for i, a in enumerate(args):
        if i in seeds:
            continue
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype).replace("torch.", "")))
        else:
            out.append(a if a is None or isinstance(a, (int, float, str))
                       else repr(a))
    return tuple(out)


def _owner_thread() -> int:
    """The thread a launch is made for: autograd runs a backward on a
    device thread of its own (not started by `threading`) for the thread
    that called backward(), and only the main thread trains."""
    if isinstance(threading.current_thread(), threading._DummyThread):
        return threading.main_thread().ident
    return threading.get_ident()


class _InSitu:
    """The kernels of a counted run held at the geometries the run gives
    them: while active, each kernel's launching function records every
    launch's geometry with its count, and a copy of the inputs of the
    first launch at each; `hold` then calls each kernel's wrapper on those
    inputs against its plain version (at the tolerances of the kernel
    phases) and times kernel, plain version and, where one PyTorch call
    computes the same function, that call."""

    def __init__(self, only=IN_SITU_DEFAULT):
        """only: the names of the kernels to record."""
        self.kernels = {k: v for k, v in _in_situ_kernels().items()
                        if k in only}
        self.calls: dict[str, dict] = {k: {} for k in self.kernels}
        # launches by thread and kernel; records and counts are updated
        # under a lock (the fused run launches from two threads)
        self.by_thread: dict[int, dict] = {}
        self._lock = threading.Lock()

    def thread_counts(self) -> dict:
        """The calling thread's launches so far, every kernel of _kernels
        (those not held in situ stay 0)."""
        with self._lock:
            mine = dict(self.by_thread.get(_owner_thread(), {}))
        return {k: mine.get(k, 0) for k in _kernels()}

    def __enter__(self):
        self._orig = {}
        for name, (mod, fn_name, _, _, seeds) in self.kernels.items():
            orig = self._orig[name] = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(name, orig, seeds))
        return self

    def __exit__(self, *exc):
        for name, (mod, fn_name, _, _, _) in self.kernels.items():
            setattr(mod, fn_name, self._orig[name])

    def _wrap(self, name, orig, seeds):
        calls = self.calls[name]

        def launch(*args):
            key = _geom_key(args, seeds)
            with self._lock:
                rec = calls.get(key)
                if rec is None:
                    rec = calls[key] = {"n": 0, "args": [
                        a.detach().clone() if isinstance(a, torch.Tensor)
                        else (list(a) if isinstance(a, tuple) else a)
                        for a in args]}
            out = orig(*args)
            with self._lock:
                rec["n"] += 1
                mine = self.by_thread.setdefault(_owner_thread(), {})
                mine[name] = mine.get(name, 0) + 1
            return out
        return launch

    def launches(self) -> dict:
        return {k: sum(r["n"] for r in c.values())
                for k, c in self.calls.items()}

    def hold(self, phase: str, card: str, timed: bool = True) -> dict:
        """kernel -> {geometry: its row}, every geometry held and, when
        `timed`, timed (else only held, and no rows)."""
        out = {}
        with torch.no_grad():
            for name, calls in self.calls.items():
                for i, (key, rec) in enumerate(calls.items()):
                    geom = f"{phase}_{i}"
                    row = self._hold_one(name, rec["args"], timed)
                    described = _describe_geom(name, rec["args"])
                    rec["args"] = None           # free the copy
                    if not timed:
                        continue
                    row["launches_in_phase"] = rec["n"]
                    row["geometry"] = described
                    _print_time(name, f"{geom} {row['geometry']} (x"
                                f"{rec['n']})", row, card)
                    out.setdefault(name, {})[geom] = row
        torch.cuda.empty_cache()
        return out

    def _hold_one(self, name, args, timed: bool = True) -> dict:
        _, _, kernel, plain, _ = self.kernels[name]
        got = kernel(args)
        torch.cuda.synchronize()
        want = plain(args)
        err, tol, ok = _in_situ_err(name, args, got, want)
        fp32 = ""
        if name == "flash_attn_bwd" and args[0].dtype == torch.bfloat16:
            fp32 = (", against the fp32 plain version " + "/".join(
                "%.3e" % _rel(x, w) for x, w in zip(got, want))
                + " (dq/dk/dv)")
        print(f"kernel {name} {_describe_geom(name, args)} in situ: error "
              f"{err:.3e} (tol {tol:.3e}){fp32} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version at "
                 f"{_describe_geom(name, args)}, in situ")
        del got, want
        if not timed:
            return {}
        row = {"ms": _time_ms(lambda: kernel(args), iters=20),
               "plain_ms": _time_ms(lambda: plain(args), iters=3, warmup=1),
               "library_ms": None, "max_abs_err": err}
        lib = _in_situ_library(name, args)
        if lib is not None:
            row["library_ms"] = _time_ms(lib, iters=20)
        row["bound_ms"], row["bound_by"] = _in_situ_bound(name, args)
        return row


def _describe_geom(name, a) -> str:
    dt = "bf16" if a[0].dtype == torch.bfloat16 else str(a[0].dtype)[6:]
    if name == "flash_attn_fwd":
        return (f"B={a[0].shape[0]} T={a[0].shape[1]} S={a[1].shape[1]} "
                f"D={a[0].shape[2]} H={a[3]} {dt}"
                f"{' masked' if a[4] is not None else ''}"
                f"{f' dropout {a[5]}' if a[5] else ''}")
    if name == "flash_attn_bwd":
        return (f"B={a[0].shape[0]} T={a[0].shape[1]} S={a[1].shape[1]} "
                f"D={a[0].shape[2]} H={a[6]} {dt}"
                f"{' masked' if a[7] is not None else ''}"
                f"{f' dropout {a[8]}' if a[8] else ''}")
    if name in ("mlp_fwd", "mlp_bwd"):
        return (f"N={a[0].shape[0]} D={a[0].shape[1]} F={a[1].shape[1]} {dt}"
                f" dropout {a[6]}")
    if name == "dropout":
        return f"{tuple(a[0].shape)} {dt} rate {a[1]}"
    if name == "layernorm":
        return (f"({a[2].numel() // a[2].shape[-1]}, {a[2].shape[-1]}) "
                f"shortcut={a[4] is not None} "
                f"{'bf16' if a[2].dtype == torch.bfloat16 else 'float32'}")
    if name == "swin_window_attn":
        nw, b, n, c = a[0].shape
        return (f"nW={nw} B={b} n={n} C={c} h={a[5]} bias_windows="
                f"{a[3].shape[0]} {dt}")
    if name.startswith("swin_attn_train"):
        nw, b, n, c = a[0].shape
        return f"nW={nw} B={b} n={n} C={c} h={a[-1]} {dt}"
    b, t, d = a[0].shape
    h = a[7] if name == "deberta_attn_bwd" else a[6]
    return (f"B={b} T={t} D={d} H={h} {dt}"
            f"{' masked' if a[5] is not None else ''}")


def _flash_bwd_bf16_mirror(q, k, v, o, lse, do, h, mask, rate, seed):
    """flash_attention_bwd_plain with #2's two roundings in bf16: p keep
    scale to bf16 before dv, and ds to bf16 before dq and dk
    (flash_attn_bwd.cu, where the TPU kernel rounds them); fp32 otherwise.
    Where a head's keys share a large common part (a text's padded tail),
    dq = ds k cancels it exactly only with ds unrounded, so the fp32
    plain version is no yardstick there."""
    from mmd_tpu_torch.ops import attention as A
    qh, kh, vh, oh, doh = (A._split_heads(x, h).float()
                           for x in (q, k, v, o, do))
    sm_scale = 1.0 / math.sqrt(qh.shape[-1])
    live = torch.isfinite(lse)[..., None]
    if mask is not None:
        live = live & (mask != 0)[:, None, None, :]
    shift = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(live, torch.exp((qh @ kh.transpose(-1, -2)) * sm_scale
                                    - shift[..., None]),
                    torch.zeros((), device=q.device))
    ks = A._keep_scale(p.shape, rate, seed, p.device) if rate > 0 else None
    pd = (p if ks is None else p * ks).to(torch.bfloat16).float()
    dp = doh @ vh.transpose(-1, -2)
    if ks is not None:
        dp = dp * ks
    ds = (p * (dp - (doh * oh).sum(-1, keepdim=True))).to(
        torch.bfloat16).float()
    return (A._merge_heads((ds @ kh) * sm_scale),
            A._merge_heads((ds.transpose(-1, -2) @ qh) * sm_scale),
            A._merge_heads(pd.transpose(-1, -2) @ doh))


def _in_situ_err(name, a, got, want) -> tuple[float, float, bool]:
    """(error, tolerance, within it) of a kernel's output against its plain
    version's, by the rule of the kernel's own phase."""
    dtype = (a[2] if name == "layernorm" else a[0]).dtype
    if name == "flash_attn_fwd":
        # the flash phase's limits, widened to one bf16 step at the largest
        # |o| and to LSE_TOL of the largest |lse| where the run's
        # activations are larger than its unit Gaussians
        (o, lse), (o_ref, lse_ref) = got, want
        fin = torch.isfinite(lse_ref)
        err = (o.float() - o_ref).abs().max().item()
        tol = KERNEL_TOL[dtype]
        if dtype == torch.bfloat16:
            tol = max(tol, _bf16_step(o_ref))
        lse_err, lse_tol = 0.0, LSE_TOL
        if fin.any():
            lse_err = (lse[fin] - lse_ref[fin]).abs().max().item()
            lse_tol *= max(1.0, lse_ref[fin].abs().max().item())
        ok = (lse_err <= lse_tol and torch.equal(torch.isfinite(lse), fin))
        return err, tol, ok and err <= tol
    if name == "flash_attn_bwd":
        # bf16: against the plain version with the kernel's roundings
        ref = (_flash_bwd_bf16_mirror(*a) if dtype == torch.bfloat16
               else want)
        err = max((x.float() - w).abs().max().item()
                  / max(w.abs().max().item(), 1e-30)
                  for x, w in zip(got, ref))
        return err, _bwd_tol(dtype), err <= _bwd_tol(dtype)
    if name in ("mlp_fwd", "mlp_bwd"):
        pairs = [(got, want)] if name == "mlp_fwd" else list(zip(got, want))
        err = max(_rel(g, w) for g, w in pairs)
        return err, MLP_TOL, err <= MLP_TOL
    if name == "dropout":
        same = torch.equal(got, want)
        return (got.float() - want.float()).abs().max().item(), 0.0, same
    if name in ("deberta_attn_bwd", "swin_attn_train_bwd"):
        # the backward phases' rule (_check_grads): each output within
        # _rel_tol of its plain version, the tables' and dbias in fp32;
        # the error is the worst share of its tolerance, times the
        # tolerance of the output where it was largest. #9 in bf16 against
        # its mirror, P and dS as the kernel feeds them (hi + lo)
        if name == "swin_attn_train_bwd" and dtype == torch.bfloat16:
            from mmd_tpu_torch.ops import swin_attention as SA
            want = SA.swin_window_attention_bwd_plain(*_f32(a),
                                                      split_weights=True)
        outs = (dtype,) * 3 + (torch.float32,) * (len(want) - 3)
        worst, worst_tol = 0.0, 1.0
        for x, w, dt in zip(got, want, outs):
            e, t = (x.float() - w).abs().max().item(), _rel_tol(dt, w)
            if e / max(t, 1e-30) >= worst / max(worst_tol, 1e-30):
                worst, worst_tol = e, t
        return worst, worst_tol, worst <= worst_tol
    if name == "swin_attn_train_fwd":
        tol = _rel_tol(dtype, want)
        err = (got.float() - want.float()).abs().max().item()
        return err, tol, err <= tol
    tol = (KERNEL_TOL[dtype] if dtype == torch.float32
           else _bf16_step(want))
    err = (got.float() - want.float()).abs().max().item()
    return err, tol, err <= tol


def _in_situ_library(name, a):
    """One PyTorch call computing the same function on the same inputs, or
    None where there is none (#3, #4: no single call; #7, #10: see the
    kernel table)."""
    fn = torch.nn.functional
    if name in ("flash_attn_fwd", "flash_attn_bwd"):
        h = a[3] if name == "flash_attn_fwd" else a[6]
        mask = a[4] if name == "flash_attn_fwd" else a[7]
        rate = a[5] if name == "flash_attn_fwd" else a[8]
        b, d = a[0].shape[0], a[0].shape[2]
        views = [x.view(b, -1, h, d // h).transpose(1, 2)
                 for x in (a[0], a[1], a[2])]
        am = None if mask is None else (mask != 0)[:, None, None, :]
        if name == "flash_attn_fwd":
            return lambda: fn.scaled_dot_product_attention(
                *views, attn_mask=am, dropout_p=rate)
        leaves = [v.detach().requires_grad_() for v in views]
        with torch.enable_grad():
            out = fn.scaled_dot_product_attention(*leaves, attn_mask=am,
                                                  dropout_p=rate)
        g = torch.randn_like(out)
        return lambda: torch.autograd.grad(out, leaves, g,
                                           retain_graph=True)
    if name == "dropout":
        return lambda: fn.dropout(a[0], a[1], training=True)
    if name == "layernorm":
        y = a[2]
        wb, bb = a[0].to(y.dtype), a[1].to(y.dtype)
        return lambda: fn.layer_norm(y, (y.shape[-1],), wb, bb, a[3])
    if name.startswith("swin_attn_train"):
        # SDPA on (nW B, h, n, dh), exp2(x) = exp(ln2 x), the log2-domain
        # bias an additive mask in the inputs' dtype (phase_swin_train)
        q, k, v, bias, h = a[0], a[1], a[2], a[3], a[-1]
        nw, b, n, c = q.shape
        ln2 = math.log(2.0)
        q4, k4, v4 = (x.reshape(nw, b, n, h, c // h).transpose(2, 3)
                      .reshape(nw * b, h, n, c // h).contiguous()
                      for x in (q, k, v))
        m4 = (ln2 * bias)[:, None].expand(nw, b, h, n, n).reshape(
            nw * b, h, n, n).to(q.dtype).contiguous()
        if name == "swin_attn_train_fwd":
            return lambda: fn.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m4, scale=ln2)
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4, m4)]
        try:
            with torch.enable_grad():
                o4 = fn.scaled_dot_product_attention(
                    *leaves[:3], attn_mask=leaves[3], scale=ln2)
            g = torch.randn_like(o4)
            torch.autograd.grad(o4, leaves, g, retain_graph=True)
        except RuntimeError:                # no backend gives dmask
            return None
        return lambda: torch.autograd.grad(o4, leaves, g, retain_graph=True)
    return None


def _in_situ_bound(name, a) -> tuple[float, str]:
    """The least time of the call on these inputs: bytes moved once over
    the memory rate, operations over the peak for their dtype."""
    e = a[2 if name == "layernorm" else 0].element_size()
    bf16 = e == 2
    if name in ("flash_attn_fwd", "flash_attn_bwd"):
        q, k = a[0], a[1]
        h = a[3] if name == "flash_attn_fwd" else a[6]
        mask = a[4] if name == "flash_attn_fwd" else a[7]
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_3XTF32_FLOPS
        if name == "flash_attn_fwd":
            return _flash_bound_ms(q, k, h, mask, peak)
        b, t, d = q.shape
        keys = k.shape[0] * k.shape[1] if mask is None else int(
            (mask != 0).sum())
        nbytes = e * (4 * b * t * d + 4 * keys * d) + 4 * b * h * t
        return _bound_ms(nbytes, 10 * t * d * keys, peak)
    if name in ("mlp_fwd", "mlp_bwd"):
        n, d = a[0].shape
        f = a[1].shape[1]
        if name == "mlp_fwd":
            return _bound_ms(2 * 2 * n * d + 2 * 2 * d * f + 4 * (f + d),
                             4 * n * d * f)
        return _bound_ms(2 * 3 * n * d + 2 * 2 * d * f + 4 * f
                         + 4 * (2 * d * f + f + d), 10 * n * d * f)
    if name == "dropout":
        return _bound_ms(2 * e * a[0].numel(), a[0].numel(), PEAK_FP32_FLOPS)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    if name.startswith("swin_attn_train"):
        # phase_swin_train's counts: q, k, v, o (and do, dq, dk, dv) in the
        # inputs' dtype, the fp32 bias (and dbias)
        nw, b, n, c = a[0].shape
        h, elems = a[-1], nw * b * n * c
        if name == "swin_attn_train_fwd":
            return _bound_ms(e * 4 * elems + 4 * nw * h * n * n,
                             4 * nw * b * n * n * c, peak)
        return _bound_ms(e * 7 * elems + 8 * nw * h * n * n,
                         10 * nw * b * n * n * c, peak)
    if name == "deberta_attn_bwd":
        # phase_deberta_bwd's counts: q, k, v, do and both tables read, dq,
        # dk, dv written, the tables' fp32 gradients; 20 B T^2 D operations
        b, t, d = a[0].shape
        return _bound_ms(e * (7 * b * t * d + 2 * 2 * t * d)
                         + 4 * 2 * 2 * t * d + b * t, 20 * b * t * t * d,
                         peak)
    if name == "layernorm":
        c = a[2].shape[-1]
        r = a[2].numel() // c
        return _bound_ms(e * r * c * (3 if a[4] is not None else 2) + 8 * c,
                         8 * r * c, peak)
    if name == "swin_window_attn":
        nw, b, n, c = a[0].shape
        nwb, h = a[3].shape[0], a[5]
        return _bound_ms(e * 4 * nw * b * n * c + 4 * nwb * h * n * n + 4 * h,
                         4 * nw * b * n * n * c, peak)
    b, t, d = a[0].shape
    return _bound_ms(e * (4 * b * t * d + 2 * 2 * t * d) + b * t,
                     8 * b * t * t * d, peak)


def _caption_generates(n_rows: int, batch: int) -> int:
    """generate() calls of pipelines/caption.process_csv over n_rows rows:
    each loop of `batch` rows captions its claim and evidence paths in
    batches of `batch`."""
    return sum(-(-2 * min(batch, n_rows - lo) // batch)
               for lo in range(0, n_rows, batch))


def _add(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _run_all_want(reference: bool, n_rows: dict, n_test_store: int,
                  steps: int, bs: int, demo_image: bool) -> dict:
    """The kernel launches each stage of run_all's default path must make."""
    per_embed = EMBED_PER_BATCH_REFERENCE if reference else EMBED_PER_BATCH
    per_classify = (REFERENCE_PER_BATCH if reference
                    else {"flash_attn_fwd": LAUNCHES_PER_BATCH})
    gens = sum(_caption_generates(n, RUN_ALL_B) for n in n_rows.values())
    batches = sum(-(-n // RUN_ALL_B) for n in n_rows.values())
    return {
        "caption": {"flash_attn_fwd": DEFAULT_CAPTION_PER_BATCH * gens},
        "embed": {k: v * batches for k, v in per_embed.items()},
        "train": {k: v * steps for k, v in PER_STEP_BF16.items()},
        "eval": {"flash_attn_fwd": FUSION_PER_BATCH * -(-n_test_store // bs)},
        "demo_verify": _add(per_classify, {
            "flash_attn_fwd": DEFAULT_CAPTION_PER_BATCH * int(demo_image)})}


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    g, w = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def phase_run_all(card: str, tmp: Path, phase: str) -> tuple[dict, dict]:
    """python -m mmd_tpu_torch.pipelines.run_all's default path in process,
    every kernel held in situ at each geometry the run gave it, then
    checks (a)-(l) (run_all_reference: (a)-(d), (f)-(i), (l)). Returns the
    kernel launches of the counted run and the in-situ rows by kernel."""
    import os
    import shutil

    import pandas as pd

    from mmd_tpu_torch.core.checkpoint import save_params
    from mmd_tpu_torch.demo import app as DA
    from mmd_tpu_torch.demo import render_html as RH
    from mmd_tpu_torch.pipelines import (
        dataset_stats, embed, eval_factify, eval_models, eval_text, run_all,
    )

    reference = phase == "run_all_reference"
    root = tmp / phase
    timings = root / "timings.json"
    argv = [*RUN_ALL[phase], *RUN_ALL_ARGS, "--root", str(root),
            "--timings_json", str(timings)]
    print(f"{phase}: run_all.main({json.dumps(argv)})", flush=True)
    old_root = os.environ.get("MMD_TPU_ROOT")
    t_phase = time.perf_counter()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                   # count the main path's run only
        _reset_native()
        t0 = time.perf_counter()
        with _StageLaunches() as stage_launches, _InSitu() as in_situ:
            out = run_all.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _counts()
        # the train stage's batches: the columns of at least
        # NATIVE_GATHER_MIN_BYTES a batch gathered by the native row gather,
        # held against the store's numpy path on one shuffled batch
        from mmd_tpu_torch.data.store import NATIVE_GATHER_MIN_BYTES
        from mmd_tpu_torch.native import bindings as NB
        train_store = out["train_store"]
        idx = np.random.default_rng(0).permutation(
            len(train_store))[:out["batch_size"]]
        pos = np.argsort(idx, kind="stable")
        sidx, inv = idx[pos], np.argsort(pos)
        wide = [train_store.col(c) for c in train_store.columns
                if len(idx) * NB.row_bytes(train_store.col(c))
                >= NATIVE_GATHER_MIN_BYTES]
        _check_native(phase, card, "gather", f"one train batch of "
                      f"{len(idx)} rows, its {len(wide)} of "
                      f"{len(train_store.columns)} columns of "
                      f"{sum(len(idx) * NB.row_bytes(c) for c in wide)} B",
                      lambda: [NB.gather_rows(c, sidx, pos) for c in wide],
                      lambda: [np.ascontiguousarray(c[sidx][inv])
                               for c in wide])
        peak = torch.cuda.max_memory_allocated()
        by_stage = stage_launches.by_stage
        # every kernel of the run at each geometry it was given, against
        # its plain version
        recorded = in_situ.launches()
        if any(launches[k] != n for k, n in recorded.items()):
            fail(f"{phase}: the in-situ record {recorded} misses launches "
                 f"of {launches}")
        times = in_situ.hold(phase, card)

        # (a) every stage of the JAX package's run_all, timed
        doc = json.loads(timings.read_text())
        secs = doc["stages_sec"]
        missing = [s for s in RUN_ALL_STAGES if s not in secs]
        if missing:
            fail(f"{phase}: (a) no timing for stages {missing}")
        pre = root / "data" / "preprocessed"
        dfs = {s: pd.read_csv(pre / f"{s}.csv") for s in ("train", "test")}
        n_rows = {s: len(df) for s, df in dfs.items()}
        print(f"{phase}: {doc['text_encoder']} / {doc['image_encoder']}, "
              f"rows {json.dumps(n_rows)}, stores {doc['n_train_rows']} / "
              f"{doc['n_test_rows']}, train batch {out['batch_size']}, "
              f"{out['state'].step} steps; seconds by stage "
              f"{json.dumps(secs)}; wall {run_s:.1f} s (without synthesize "
              f"{doc['wall_sec_excl_synthesize']} s); embed "
              f"{sum(n_rows.values()) / secs['embed']:.1f} rows/s; peak "
              f"device memory {peak / 2 ** 30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated)  [{card}]", flush=True)

        # (b) each store holds exactly the rows with both images
        for split, df in dfs.items():
            store = out[f"{split}_store"]
            both = (df["claim_image"].notna()
                    & df["evidence_image"].notna()).to_numpy()
            meta = json.loads((store.dir / "meta.json").read_text())
            if (len(store) != both.sum() or not np.array_equal(
                    store.col("id"), df["id"].to_numpy()[both])
                    or meta["extra"].get("csv_cursor") != len(df)):
                fail(f"{phase}: (b) {split} store: {len(store)} rows, "
                     f"{both.sum()} with both images; cursor "
                     f"{meta['extra']}, {len(df)} rows")
            print(f"{phase}: (b) {split}: {len(store)} rows stored, "
                  f"{len(df) - len(store)} skipped, csv_cursor "
                  f"{meta['extra']['csv_cursor']}", flush=True)

        # (c) a second embed over the finished store appends nothing
        enc, train_store = out["enc"], out["train_store"]
        train_csv = str(pre / "train.csv")
        _reset_counts()
        again = embed.embed_csv(train_csv, enc, batch_size=RUN_ALL_B,
                                device="cuda")
        if len(again) != len(train_store) or any(_counts().values()):
            fail(f"{phase}: (c) the finished store took rows or launches: "
                 f"{len(again)} rows, {_counts()}")

        # (d) rewound to its first batch and resumed: bit for bit
        resumed = root / "resumed.store"
        shutil.copytree(train_store.dir, resumed)
        meta = json.loads((resumed / "meta.json").read_text())
        meta["count"] = int(np.isin(train_store.col("id"),
                                    dfs["train"]["id"][:RUN_ALL_B]).sum())
        meta["extra"] = {"csv_cursor": RUN_ALL_B}
        (resumed / "meta.json").write_text(json.dumps(meta))
        got = embed.embed_csv(train_csv, enc, batch_size=RUN_ALL_B,
                              store_path=str(resumed), device="cuda")
        for col in train_store.columns:
            if not np.array_equal(got.col(col), train_store.col(col)):
                fail(f"{phase}: (d) the resumed store's {col} differs")
        print(f"{phase}: (c) the finished store took no rows and no "
              f"launches; (d) rewound to {meta['count']} rows and resumed: "
              f"every column bit for bit", flush=True)

        # (e) one batch in fp32 through the explicit path
        if not reference:
            head = root / "head.csv"
            dfs["train"].head(RUN_ALL_B).to_csv(head, index=False)
            enc32 = dataclasses.replace(
                enc, text_cfg=_fp32(enc.text_cfg, False),
                vit_cfg=_fp32(enc.vit_cfg, False))
            _reset_counts()
            ref = embed.embed_csv(str(head), enc32, batch_size=RUN_ALL_B,
                                  store_path=str(root / "head.store"),
                                  device="cuda")
            if any(_counts().values()):
                fail(f"{phase}: (e) the explicit path launched {_counts()}")
            errs = {c: _rel_l2(train_store.col(c)[:len(ref)], ref.col(c))
                    for c in train_store.columns
                    if c.endswith("_embeds")}
            print(f"{phase}: (e) {len(ref)} rows re-encoded in fp32 through "
                  f"the explicit path: relative L2 {json.dumps(errs)} (tol "
                  f"{REENCODE_REL_L2})", flush=True)
            if not np.array_equal(ref.col("id"),
                                  train_store.col("id")[:len(ref)]) or \
                    not max(errs.values()) <= REENCODE_REL_L2:
                fail(f"{phase}: (e) the stored rows disagree with the "
                     f"explicit fp32 path")

        # (f) the results CSV: four paths and unified, all finite
        ev = pd.read_csv(root / "results" / "eval.csv")
        vals = ev.drop(columns=["timestamp", "path"]).to_numpy(float)
        if list(ev["path"]) != ["text_text", "text_image", "image_text",
                                "image_image", "unified"] or \
                not np.isfinite(vals).all():
            fail(f"{phase}: (f) eval.csv {ev.to_dict('list')}")

        # (g) eval through the kernels against the explicit path, fp32
        model, params, test_store = out["model"], out["state"].params, \
            out["test_store"]
        bs = out["batch_size"]
        lk, _ = eval_models.store_logits(test_store, _fp32(model, True),
                                         params, bs, device="cuda")
        lx, _ = eval_models.store_logits(test_store, _fp32(model, False),
                                         params, bs, device="cuda")
        scale = float(np.abs(lx).max())
        gap = np.diff(np.sort(lx, -1)[..., -2:], axis=-1)[..., 0]
        decided = gap > EVAL_LOGIT_RTOL * scale
        diff = float(np.abs(lk - lx).max()) / scale
        same = np.array_equal(lk.argmax(-1)[decided], lx.argmax(-1)[decided])
        print(f"{phase}: (f) eval.csv {json.dumps(out['metrics'])}; (g) "
              f"fp32 logits, kernels vs explicit path: {diff:.3e} of the "
              f"largest |logit| (tol {EVAL_LOGIT_RTOL}), predictions equal "
              f"at {int(decided.sum())} of {decided.size} outside near "
              f"ties: {same}", flush=True)
        if not (diff <= EVAL_LOGIT_RTOL and same):
            fail(f"{phase}: (g) the eval predictions disagree")

        # (h) the demo's verdict and evidences; (i) its report
        result = out["result"]
        img = dfs["test"]["claim_image"][0]
        demo_image = isinstance(img, str)
        srcs = [e.source for e in result.evidences]
        top_k = 3
        if result.final_classification not in LABELS or \
                srcs.count("text") != top_k or \
                srcs.count("image") != top_k * int(demo_image):
            fail(f"{phase}: (h) verdict {result.final_classification!r}, "
                 f"evidence sources {srcs}")
        html = RH.render_html(result, root / "report.html").read_text()
        verdict = RH.CATEGORY_MAPPING[result.final_classification]
        if f"Classification Result: <b>{verdict}</b>" not in html:
            fail(f"{phase}: (i) the report lacks the verdict {verdict}")
        print(f"{phase}: (h) verdict {result.final_classification} from "
              f"{len(srcs)} evidences ({srcs.count('image')} by image), "
              f"caption {result.caption[:60]!r}; (i) report "
              f"{len(html)} bytes", flush=True)

        # (j) the streamlit page over build_pipeline, from the files
        if not reference:
            ckpt = root / "results" / "best_model.pt"
            save_params(str(ckpt), params)
            DA.build_pipeline.cache_clear()
            t0 = time.perf_counter()
            pipe = DA.build_pipeline(str(root), checkpoint=str(ckpt),
                                     assets=str(root / "assets" / "encoders"),
                                     device="cuda")
            claim = str(dfs["test"]["claim"][0])
            st = _RecordingSt(claim)
            DA.render_app(st, pipeline_factory=lambda: pipe)
            want = out["pipeline"].verify(claim, None, top_k=5,
                                          top_k_image=5)
            line = ("write", "**Classification Result:** "
                    + DA.CATEGORY_MAPPING[want.final_classification])
            if line not in st.calls:
                fail(f"{phase}: (j) the page did not render the in-memory "
                     f"pipeline's verdict {want.final_classification}")
            print(f"{phase}: (j) render_app over build_pipeline (set-up and "
                  f"page {time.perf_counter() - t0:.1f} s, {len(st.calls)} "
                  f"calls) renders {want.final_classification}, the "
                  f"in-memory pipeline's verdict on the text-only claim",
                  flush=True)
            DA.build_pipeline.cache_clear()
            del pipe

            # (k) the other entry points over the tree and its test store
            stats = dataset_stats.main(["--splits", "train", "test"])
            if [s["rows"] for s in stats] != list(n_rows.values()):
                fail(f"{phase}: (k) dataset_stats {stats}")
            store_args = [
                "--store", str(test_store.dir), "--batch_size", str(bs),
                "--device", "cuda", "--text_input_dim",
                str(model.text_input_dim), "--image_input_dim",
                str(model.image_input_dim), "--embed_dim",
                str(model.embed_dim), "--num_heads", str(model.num_heads),
                "--hidden_dim", str(model.hidden_dim)]
            cli = eval_models.main(store_args + [
                "--checkpoint", str(ckpt), "--results_csv",
                str(root / "results" / "eval_cli.csv")])
            if cli != out["metrics"]:
                fail(f"{phase}: (k) eval_models' CLI {cli} against "
                     f"{out['metrics']}")
            m_text = eval_text.main(store_args + [
                "--results_csv", str(root / "results" / "eval_text.csv")])
            m_fact = eval_factify.main(store_args + [
                "--confusion_png", str(root / "cm.png")])
            cm = [p for p in (root / "cm.png", root / "cm.png.txt")
                  if p.exists()]
            if not (all(map(math.isfinite, m_text.values()))
                    and all(map(math.isfinite, m_fact.values())) and cm):
                fail(f"{phase}: (k) eval_text {m_text}, eval_factify "
                     f"{m_fact}, confusion {cm}")
            demo = RH.main(["--device", "cuda", "--root",
                            str(root / "demo_html"), "--out",
                            str(root / "demo.html"), "--n", "8"])
            if RH.CATEGORY_MAPPING[demo.final_classification] not in (
                    root / "demo.html").read_text():
                fail(f"{phase}: (k) render_html's main lacks its verdict")
            print(f"{phase}: (k) dataset_stats rows "
                  f"{[s['rows'] for s in stats]}; eval_models' CLI equals "
                  f"the run's metrics; eval_text accuracy "
                  f"{m_text['accuracy']:.4f}, eval_factify accuracy "
                  f"{m_fact['accuracy']:.4f}, confusion {cm[0].name}; "
                  f"render_html's main: {demo.final_classification}",
                  flush=True)

        # (l) the launches, stage by stage
        want = _run_all_want(reference, n_rows, len(test_store),
                             out["state"].step, bs, demo_image)
        bad = {}
        for name in set(by_stage) | set(want):
            w = {k: want.get(name, {}).get(k, 0) for k in launches}
            got = by_stage.get(name, {k: 0 for k in launches})
            if got != w:
                bad[name] = (got, w)
        total = _add(*by_stage.values())
        print(f"{phase}: (l) launches by stage "
              f"{json.dumps({s: {k: v for k, v in c.items() if v} for s, c in by_stage.items()})}; "
              f"total {json.dumps(launches)}  [{card}]", flush=True)
        if bad or {k: total.get(k, 0) for k in launches} != launches:
            fail(f"{phase}: (l) launches by stage (got, want): {bad}")
    finally:
        if old_root is None:
            os.environ.pop("MMD_TPU_ROOT", None)
        else:
            os.environ["MMD_TPU_ROOT"] = old_root
    del out
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, times


# run_all_fused / run_all_fused_default: python -m
# mmd_tpu_torch.pipelines.run_all --fused in process at full width (seeded
# weights), 256-px images: the README's flagship flags with DeBERTa-v3-xsmall
# and Swinv2-base, then the default encoders (the BERT-class text encoder
# and ViTConfig()); CaptionerConfig() in blocks of 64, MPNet, ResNet50, the
# default ModelConfig in bf16. Depth cut to 256 / 64 synthetic train rows
# (Factify-2: 35,000).
RUN_ALL_FUSED_ARGS = ["--fused", "--image_size", "256", "--train_batch", "64",
                      "--steps_per_call", "8", "--chunk", "256"]
RUN_ALL_FUSED = {
    "run_all_fused": ["--reference_encoders", "--synthetic", "256",
                      "--epochs", "2"],
    "run_all_fused_default": ["--synthetic", "64", "--epochs", "1"]}
FUSED_STAGES = ("synthesize", "preprocess", "assets", "ingest",
                "ingest_test_overlap", "caption", "retrieval_build", "train",
                "caption_test", "retrieval_build_test", "eval", "demo_verify")
# the launches of one image and one text forward of each family (False:
# ViT / BERT-class, True: Swinv2 / DeBERTa): half a served batch's
IMAGE_FORWARD = {False: {"flash_attn_fwd": PER_BATCH["vit"] // 2},
                 True: {"swin_window_attn": sum(SWIN_GEOMS.values()) // 2,
                        "layernorm": sum(LN_GEOMS.values()) // 2}}
TEXT_FORWARD = {False: {"flash_attn_fwd": PER_BATCH["text"] // 2},
                True: {"deberta_attn_fwd": DEBERTA["per_batch"] // 2}}
# (g) the ingest hook's ResNet50 features against
# build_image_corpus_from_bank's over the same images, the stored float16
# rows, relative to the largest |feature| (the same bf16 network on the
# same blocks of 64: a row out of place moves by ~1e-1)
CORPUS_TOL = 2e-2


def _scaled(d: dict, k: int) -> dict:
    return {name: v * k for name, v in d.items()}


def _ingest_want(reference: bool, n: int, chunk: int, sub: int,
                 cap_b: int) -> dict:
    """Launches of fused.ingest_split over n kept rows with embed_images
    and the caption hook: every flushed chunk embeds its whole capacity in
    blocks of `sub`, two images a row; the hook captions each chunk's rows
    in blocks of cap_b, claim and evidence."""
    flushes = -(-n // chunk)
    gens = sum(2 * -(-min(chunk, n - f * chunk) // cap_b)
               for f in range(flushes))
    return _add(_scaled(IMAGE_FORWARD[reference],
                        flushes * 2 * (chunk // sub)),
                {"flash_attn_fwd": DEFAULT_CAPTION_PER_BATCH * gens})


def _fused_want(reference: bool, out: dict, demo_image: bool) -> dict:
    """The kernel launches each stage of run_all --fused must make, from the
    run's banks, chunk, train steps and batch."""
    chunk, cap_b = out["chunk"], out["cap_batch"]
    sub = chunk
    while sub > 64 and sub % 2 == 0:
        sub //= 2
    text2 = _scaled(TEXT_FORWARD[reference], 2)
    n_test = out["test_bank"].n
    eval_b = min(out["batch_size"], max(n_test, 1))
    per_classify = (REFERENCE_PER_BATCH if reference
                    else {"flash_attn_fwd": LAUNCHES_PER_BATCH})
    return {
        "ingest": _ingest_want(reference, out["train_bank"].n, chunk, sub,
                               cap_b),
        "ingest_test_overlap": _ingest_want(reference, n_test, chunk, sub,
                                            cap_b),
        "train": _scaled(_add(PER_STEP_BF16, text2), out["state"].step),
        "eval": _scaled(_add(text2, {"flash_attn_fwd": FUSION_PER_BATCH}),
                        -(-n_test // eval_b)),
        "demo_verify": _add(per_classify, {
            "flash_attn_fwd": DEFAULT_CAPTION_PER_BATCH * int(demo_image)})}


def _bank_captions(csv: Path, ids) -> tuple[list, list]:
    """The (claim, evidence) captions an enriched CSV holds for the bank's
    rows, in bank order ("" for an empty caption)."""
    import pandas as pd
    df = pd.read_csv(csv).set_index("id").loc[list(map(int, ids))]
    if df[["claim_enriched", "evidence_enriched"]].isna().any().any():
        fail(f"(f) a banked row of {csv.name} is not enriched")
    return tuple(df[c].fillna("").astype(str).tolist()
                 for c in ("claim_image_caption", "evidence_image_caption"))


def phase_run_all_fused(card: str, tmp: Path, phase: str
                        ) -> tuple[dict, dict]:
    """python -m mmd_tpu_torch.pipelines.run_all --fused in process, every
    kernel held in situ at each geometry the run gave it, then checks
    (a)-(i). Returns the kernel launches of the counted run and the in-situ
    rows by kernel."""
    import os

    import pandas as pd

    from mmd_tpu_torch.core.config import TrainConfig
    from mmd_tpu_torch.data.store import ArrayStore
    from mmd_tpu_torch.models.frozen import image_encode
    from mmd_tpu_torch.ops.image_ops import (
        TRAIN_TRANSFORM, normalize_on_device,
    )
    from mmd_tpu_torch.pipelines import fused as F
    from mmd_tpu_torch.pipelines import run_all
    from mmd_tpu_torch.pipelines.raw_store import build_raw_store
    from mmd_tpu_torch.training.trainer import Trainer

    reference = phase == "run_all_fused"
    root = tmp / phase
    timings = root / "timings.json"
    argv = [*RUN_ALL_FUSED[phase], *RUN_ALL_FUSED_ARGS, "--root", str(root),
            "--timings_json", str(timings)]
    print(f"{phase}: run_all.main({json.dumps(argv)})", flush=True)
    old_root = os.environ.get("MMD_TPU_ROOT")
    t_phase = time.perf_counter()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()                   # count the main path's run only
        t0 = time.perf_counter()
        with _InSitu() as in_situ, \
                _StageLaunches(in_situ.thread_counts) as stage_launches:
            out = run_all.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        by_stage = stage_launches.by_stage
        recorded = in_situ.launches()
        if any(launches[k] != n for k, n in recorded.items()):
            fail(f"{phase}: the in-situ record {recorded} misses launches "
                 f"of {launches}")
        times = in_situ.hold(phase, card)

        # (a) every stage of the JAX package's _run_fused, timed
        doc = json.loads(timings.read_text())
        secs = doc["stages_sec"]
        missing = [s for s in FUSED_STAGES if s not in secs]
        if missing:
            fail(f"{phase}: (a) no timing for stages {missing}")
        pre = root / "data" / "preprocessed"
        csvs = {s: pre / f"{s}.csv" for s in ("train", "test")}
        banks = {"train": out["train_bank"], "test": out["test_bank"]}
        rows = {s: b.n + b.skipped for s, b in banks.items()}
        enc, model, bs = out["enc"], out["model"], out["batch_size"]
        vc = enc.vit_cfg
        emb_row = 2 * 2 * (banks["train"].data["claim_ids"].shape[1]
                           * enc.text_cfg.hidden_size
                           + vc.num_tokens * vc.hidden_size)
        print(f"{phase}: {doc['text_encoder']} / {doc['image_encoder']}, "
              f"rows {json.dumps(rows)}, banked {doc['n_train_rows']} / "
              f"{doc['n_test_rows']}, chunk {out['chunk']}, train batch "
              f"{bs}, {out['state'].step} steps; seconds by stage "
              f"{json.dumps(secs)}; wall {run_s:.1f} s (without synthesize "
              f"{doc['wall_sec_excl_synthesize']} s); ingest "
              f"{rows['train'] / secs['ingest']:.1f} rows/s (train), "
              f"{rows['test'] / secs['ingest_test_overlap']:.1f} (test, "
              f"overlapped); banks {banks['train'].nbytes} / "
              f"{banks['test'].nbytes} bytes; peak device memory "
              f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated) "
              f" [{card}]", flush=True)
        print(f"{phase}: host-to-device bytes: ingest's staging copies "
              f"{banks['train'].h2d_bytes} + {banks['test'].h2d_bytes} "
              f"(counted); run_all's default, staged path at these rows "
              f"uploads "
              f"the train store's fp16 embeddings every epoch, "
              f"{doc['args']['epochs']} x {banks['train'].n} x {emb_row} = "
              f"{doc['args']['epochs'] * banks['train'].n * emb_row} bytes "
              f"(arithmetic; its caption, embed and corpus uploads "
              f"besides)", flush=True)

        # (b) each bank against the raw store of the same CSV
        stores = {}
        for split, bank in banks.items():
            store = stores[split] = build_raw_store(
                str(csvs[split]), enc.tokenizer, image_size=256,
                batch_size=64)
            if bank.n + bank.skipped != len(pd.read_csv(csvs[split])) or \
                    not np.array_equal(bank.ids, store.col("id")):
                fail(f"{phase}: (b) {split} bank: {bank.n} rows + "
                     f"{bank.skipped} skipped, store {len(store)}")
            for col in ("claim_ids", "claim_mask", "doc_ids", "doc_mask",
                        "labels"):
                if not np.array_equal(bank.data[col][:bank.n].cpu().numpy(),
                                      store.col(col)):
                    fail(f"{phase}: (b) the {split} bank's {col} differs "
                         f"from the raw store's")
        print(f"{phase}: (b) both banks' ids, tokens and labels equal the "
              f"raw store's bit for bit", flush=True)

        # (c) the vis columns against the frozen encoder in fp32 through
        # its explicit path, over the same images
        vcfg32 = _fp32(vc, False)
        errs = {}
        _reset_counts()
        with torch.no_grad():
            for kind in ("claim", "doc"):
                u8 = torch.from_numpy(np.array(
                    stores["train"].col(f"{kind}_image")[:64])).cuda()
                ref = image_encode(enc.vit_params, vcfg32,
                                   normalize_on_device(u8, TRAIN_TRANSFORM,
                                                       torch.float32))
                got = banks["train"].data[f"{kind}_vis"][:len(u8)]
                errs[kind] = _rel_l2(got.float().cpu().numpy(),
                                     ref.cpu().numpy())
        print(f"{phase}: (c) {len(u8)} rows' vis columns against the "
              f"explicit fp32 encoder: relative L2 {json.dumps(errs)} (tol "
              f"{REENCODE_REL_L2})", flush=True)
        if any(_counts().values()) or max(errs.values()) > REENCODE_REL_L2:
            fail(f"{phase}: (c) the vis columns disagree ({_counts()})")

        # (d) one window of K bank steps against K plain raw steps on
        # batches gathered on the host: bit for bit
        bank = banks["train"]
        b = min(bs, bank.n)
        k = max(1, min(out["steps_per_call"], bank.n // b))
        cfg = TrainConfig(model=model, batch_size=b, epochs=1, lr=1e-3,
                          output_dir=str(root / "window"), save_every=0)
        trainer = Trainer(cfg, device="cuda", encoders=enc)
        idx = np.random.default_rng(1).permutation(bank.n)[:k * b].reshape(
            k, b)
        sw, aux = F.make_bank_window(cfg, enc, k)(
            trainer.init(), bank.data, torch.from_numpy(idx).cuda())
        host = {c: t.cpu() for c, t in bank.data.items()}
        state = trainer.init()
        for i in range(k):
            state, a = trainer.train_step(state, {
                c: v[torch.from_numpy(idx[i])].cuda()
                for c, v in host.items()})
            if not torch.equal(aux["loss"][i], a["loss"]):
                fail(f"{phase}: (d) step {i}: window loss "
                     f"{aux['loss'][i].item()} against {a['loss'].item()}")
        same = all(torch.equal(p, q) for p, q in zip(
            sw.params.parameters(), state.params.parameters()))
        print(f"{phase}: (d) a window of {k} steps at batch {b} against "
              f"{k} plain steps on host-gathered batches: losses "
              f"{aux['loss'].tolist()} equal, params bit for bit: {same}",
              flush=True)
        if not same:
            fail(f"{phase}: (d) the window's params differ")
        del sw, state, trainer, host

        # (e) eval over a raw-image test bank against the streaming eval,
        # both at one batch size
        raw_test = F.ingest_split(csvs["test"], enc, image_size=256,
                                  chunk=out["chunk"], root=root,
                                  device="cuda")
        params = out["state"].params
        eb = min(bs, raw_test.n)
        m_bank = F.evaluate_from_bank(raw_test, enc, model, params,
                                      batch_size=eb)
        m_stream = F.evaluate_streaming(csvs["test"], enc, model, params,
                                        batch_size=eb, image_size=256,
                                        root=root, device="cuda")
        print(f"{phase}: (e) evaluate_from_bank over a raw-image bank "
              f"{json.dumps(m_bank)}; evaluate_streaming equal: "
              f"{m_bank == m_stream}", flush=True)
        if m_bank != m_stream:
            fail(f"{phase}: (e) streaming eval {m_stream}")

        # (f) the hook's captions against dispatch_bank's over raw-image
        # banks; (g) the hook's corpus against build_image_corpus_from_bank
        raw_train = F.ingest_split(csvs["train"], enc, image_size=256,
                                   chunk=out["chunk"], root=root,
                                   device="cuda")
        n_caps = 0
        for split, raw in (("train", raw_train), ("test", raw_test)):
            capt = F.BankCaptioner(out["engine"], batch=out["cap_batch"],
                                   bank_image_size=256)
            capt.dispatch_bank(raw)
            want = capt.collect(raw.n)
            got = _bank_captions(pre / f"{split}_enriched.csv", raw.ids)
            if got != tuple(want):
                fail(f"{phase}: (f) the {split} hook's captions differ from "
                     f"dispatch_bank's")
            n_caps += 2 * raw.n
        corpus_dir = root / "data" / "retrieval" / "image_corpus"
        hook = ArrayStore(corpus_dir).col("features").astype(np.float32)
        ids = json.loads((corpus_dir / "ids.json").read_text())
        ref = F.build_image_corpus_from_bank(raw_train, root / "bank_corpus",
                                             tiny=doc["args"]["tiny"],
                                             batch=64)
        want = ArrayStore(ref.dir).col("features").astype(np.float32)
        gap = float(np.abs(hook - want).max() / np.abs(want).max())
        print(f"{phase}: (f) {n_caps} captions of the ingest hooks equal "
              f"dispatch_bank's, every banked row enriched; (g) the hook "
              f"corpus ({hook.shape}) against build_image_corpus_from_bank: "
              f"{gap:.3e} of the largest feature (tol {CORPUS_TOL}), ids the "
              f"evidence paths", flush=True)
        if gap > CORPUS_TOL or ids != [str(p) for p in bank.doc_paths] or \
                not all(Path(p).is_file() for p in ids):
            fail(f"{phase}: (g) the hook corpus disagrees")
        del raw_train, raw_test, ref

        # (h) finite metrics, a verdict
        ev = pd.read_csv(root / "results" / "eval.csv")
        vals = ev.drop(columns=["timestamp", "path"]).to_numpy(float)
        result = out["result"]
        if not np.isfinite(vals).all() or \
                result.final_classification not in LABELS:
            fail(f"{phase}: (h) eval.csv {ev.to_dict('list')}, verdict "
                 f"{result.final_classification!r}")
        print(f"{phase}: (h) eval {json.dumps(out['metrics'])}; verdict "
              f"{result.final_classification} from {len(result.evidences)} "
              f"evidences", flush=True)

        # (i) the launches, stage by stage and thread by thread
        img = pd.read_csv(csvs["test"])["claim_image"][0]
        want = _fused_want(reference, out, isinstance(img, str))
        bad = {}
        for name in set(by_stage) | set(want):
            w = {k_: want.get(name, {}).get(k_, 0) for k_ in launches}
            got = by_stage.get(name, {k_: 0 for k_ in launches})
            if got != w:
                bad[name] = (got, w)
        total = _add(*by_stage.values())
        print(f"{phase}: (i) launches by stage "
              f"{json.dumps({s: {k_: v for k_, v in c.items() if v} for s, c in by_stage.items()})}; "
              f"total {json.dumps(launches)}  [{card}]", flush=True)
        if bad or {k_: total.get(k_, 0) for k_ in launches} != launches:
            fail(f"{phase}: (i) launches by stage (got, want): {bad}")
    finally:
        if old_root is None:
            os.environ.pop("MMD_TPU_ROOT", None)
        else:
            os.environ["MMD_TPU_ROOT"] = old_root
    del out
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, times


# fakenet: python -m mmd_tpu_torch.baselines.fakenet_train at its CLI's
# full width (text_dim 384, image_dim 1024, hidden 256 over 2 heads: head
# dim 128; bf16, batch 24, dropout 0.1) over a synthetic pre-embedded store
# of 240 rows, five categories, text (512, 384) and image (64, 1024) per
# side; depth cut to 2 epochs (the CLI's default is 15). A training step
# runs #1 with dropout 12 times at (T, S) = FAKENET_GEOMS, #2 12 times, and
# #5 24 times forward and 24 backward; a prediction batch runs #1 12 times.
FAKENET_ROWS = 240
FAKENET_B = 24
FAKENET_EPOCHS = 2
FAKENET_T, FAKENET_S = 512, 64
FAKENET_GEOMS = {(512, 512): 2, (64, 64): 2, (512, 64): 4, (64, 512): 4}
FAKENET_PER_STEP = {"flash_attn_fwd": 12, "flash_attn_bwd": 12,
                    "dropout": 48}
FAKENET_PER_PREDICT = {"flash_attn_fwd": 12}
FAKENET_WARMUP_STEPS = 2         # steps left out of the median step time
# (c) one fp32 step through the kernels against the explicit path, same
# params and seed, batch 8: loss and the step's logits within 1e-4
# relative (3xTF32 against fp32 sums in another order, 12 post-LN blocks),
# and each gradient leaf as train_parity holds it
FAKENET_PARITY_B = 8
FAKENET_PARITY_RTOL = 1e-4


def _fakenet_store(path: Path, rng: np.random.Generator) -> None:
    """The CLI's store: fp16 token embeddings per side and (N, 4) per-path
    labels of the five categories, written in chunks."""
    from mmd_tpu_torch.data import labels as lb
    from mmd_tpu_torch.data.store import ArrayStoreWriter
    shapes = {"claim_text_embeds": (FAKENET_T, 384),
              "doc_text_embeds": (FAKENET_T, 384),
              "claim_image_embeds": (FAKENET_S, 1024),
              "doc_image_embeds": (FAKENET_S, 1024)}
    w = ArrayStoreWriter(path, FAKENET_ROWS, {
        **{k: (v, np.float16) for k, v in shapes.items()},
        "labels": ((4,), np.int32)})
    cats = rng.permutation(np.arange(FAKENET_ROWS) % 5)
    for lo in range(0, FAKENET_ROWS, 60):
        n = min(60, FAKENET_ROWS - lo)
        chunk = {k: rng.standard_normal((n, *v), dtype=np.float32).astype(
            np.float16) for k, v in shapes.items()}
        # plant the category in the claim text, so that training learns
        chunk["claim_text_embeds"] += (
            (cats[lo:lo + n] - 2)[:, None, None] * 0.5).astype(np.float16)
        chunk["labels"] = lb.LABEL_TABLE[cats[lo:lo + n]].astype(np.int32)
        w.append_batch(chunk)
    w.finalize()


class _FakeNetSteps:
    """Wraps fakenet_train.make_fakenet_train_step while active: every
    step ends in a device sync and records its host milliseconds and its
    kernel launches."""

    def __enter__(self):
        from mmd_tpu_torch.baselines import fakenet_train as FT
        self.steps: list[tuple[float, dict]] = []
        self._orig = orig = FT.make_fakenet_train_step

        def make(*args, **kwargs):
            step = orig(*args, **kwargs)

            def timed(batch, seed):
                torch.cuda.synchronize()
                before = _counts()
                t0 = time.perf_counter()
                out = step(batch, seed)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                after = _counts()
                self.steps.append((ms, {k: after[k] - before[k]
                                        for k in after}))
                return out
            return timed
        FT.make_fakenet_train_step = make
        return self

    def __exit__(self, *exc):
        from mmd_tpu_torch.baselines import fakenet_train as FT
        FT.make_fakenet_train_step = self._orig


def _fakenet_parity(card: str, cfg, batch: dict) -> None:
    """(c) one fp32 training step (forward with dropout, cross-entropy,
    backward) through #1/#2 and through the explicit path: the same params
    and seed."""
    from mmd_tpu_torch.baselines import fakenet as FN
    from mmd_tpu_torch.baselines import fakenet_train as FT
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params = FN.init_fakenet(torch.Generator().manual_seed(22), cfg32)
    inputs = FT._inputs(batch, "cuda")
    labels = torch.as_tensor(batch["category"]).to("cuda")
    orig = FN.multi_head_attention
    res = {}
    for fused in (True, False):
        p = copy.deepcopy(params).to("cuda")
        if not fused:
            FN.multi_head_attention = lambda *a, **k: orig(
                *a, **{**k, "fused": False})
        try:
            _reset_counts()
            logits, _ = FN.fakenet_forward(p, cfg32, *inputs, seed=77,
                                           deterministic=False)
            loss = FT.cross_entropy(logits, labels)
            loss.backward()
            torch.cuda.synchronize()
            counts = _counts()
        finally:
            FN.multi_head_attention = orig
        res[fused] = (loss.item(), logits.detach(), counts, {
            n: q.grad.detach().clone() for n, q in p.named_parameters()})
    (lf, zf, cf, gf), (le, ze, ce, ge) = res[True], res[False]
    loss_rel = abs(lf - le) / abs(le)
    logit_rel = ((zf - ze).abs().max() / ze.abs().max()).item()
    worst, where = _grad_gap(gf, ge)
    ran = (cf["flash_attn_fwd"], cf["flash_attn_bwd"],
           ce["flash_attn_fwd"], ce["flash_attn_bwd"])
    ok = (loss_rel <= FAKENET_PARITY_RTOL and logit_rel <= FAKENET_PARITY_RTOL
          and worst <= PARITY_GRAD_RTOL and ran == (12, 12, 0, 0))
    print(f"fakenet: (c) one fp32 step, batch {FAKENET_PARITY_B}, dropout "
          f"{cfg.dropout}, kernels (#1/#2 launches {ran[0]}/{ran[1]}) against "
          f"the explicit path ({ran[2]}/{ran[3]}): loss {lf:.7f} / {le:.7f}, "
          f"relative {loss_rel:.3e}; logits {logit_rel:.3e} of the largest "
          f"(tol {FAKENET_PARITY_RTOL:.0e}); worst grad leaf {where} at "
          f"{worst:.3e} of its scale (tol {PARITY_GRAD_RTOL:.0e}) -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail("fakenet: (c) the kernel path and the explicit path disagree")


def phase_fakenet(card: str, tmp: Path) -> tuple[dict, dict]:
    """python -m mmd_tpu_torch.baselines.fakenet_train at full width on the
    card, every kernel held in situ at each geometry the run gave it, then
    checks (a)-(e). Returns the kernel launches of the counted run and the
    in-situ rows by kernel."""
    import csv

    from mmd_tpu_torch import profiling as PR
    from mmd_tpu_torch.baselines import fakenet_train as FT
    from mmd_tpu_torch.data import labels as lb
    from mmd_tpu_torch.data.store import ArrayStore
    from mmd_tpu_torch.ops import attention as A
    from mmd_tpu_torch.training.optim import make_optimizer
    from mmd_tpu_torch.profile_train import KERNELS, TRAIN_GROUPS

    phase = "fakenet"
    t_phase = time.perf_counter()
    root = tmp / phase
    t0 = time.perf_counter()
    _fakenet_store(root / "store", np.random.default_rng(22))
    write_s = time.perf_counter() - t0
    answer = root / "answer_fakenet.csv"
    argv = ["--store", str(root / "store"), "--epochs", str(FAKENET_EPOCHS),
            "--batch_size", str(FAKENET_B), "--answer_csv", str(answer),
            "--device", "cuda"]
    print(f"{phase}: store of {FAKENET_ROWS} rows written in {write_s:.2f} "
          f"s; fakenet_train.main({json.dumps(argv)})", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                       # count the main path's run only
    t0 = time.perf_counter()
    with _FakeNetSteps() as steps, _InSitu() as in_situ:
        out = FT.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    recorded = in_situ.launches()
    if any(launches[k] != n for k, n in recorded.items()):
        fail(f"{phase}: the in-situ record {recorded} misses launches of "
             f"{launches}")

    # (a) launches: each step exactly FAKENET_PER_STEP, all at dh 128
    n_steps = FAKENET_EPOCHS * (FAKENET_ROWS // FAKENET_B)
    want_step = {k: FAKENET_PER_STEP.get(k, 0) for k in launches}
    bad = [i for i, (_, c) in enumerate(steps.steps) if c != want_step]
    n_pred = FAKENET_ROWS // FAKENET_B
    want = {k: n_steps * FAKENET_PER_STEP.get(k, 0)
            + n_pred * FAKENET_PER_PREDICT.get(k, 0) for k in launches}
    if not steps.steps:
        fail(f"{phase}: no training step ran")
    # a geometry key: (q, k, v[, o, lse, do]) as (shape, dtype), the heads
    heads = {"flash_attn_fwd": 3, "flash_attn_bwd": 6}
    flash = [(key[0][0], key[1][0], key[heads[name]]) for name in heads
             for key in in_situ.calls[name]]
    dh = {q[2] // h for q, _, h in flash}
    geoms = {(q[1], k[1]) for q, k, _ in flash}
    print(f"{phase}: (a) {len(steps.steps)} steps; launches a step "
          f"{json.dumps({k: v for k, v in steps.steps[0][1].items() if v})}"
          f" (want {json.dumps(FAKENET_PER_STEP)}); the run's "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; #1/#2 "
          f"head dims {sorted(dh)}, (T, S) {sorted(geoms)}  [{card}]",
          flush=True)
    if (len(steps.steps) != n_steps or bad or launches != want
            or dh != {128} or geoms != set(FAKENET_GEOMS)):
        fail(f"{phase}: (a) launches: steps {len(steps.steps)} of "
             f"{n_steps}, steps off {bad}, run {launches} against {want}, "
             f"head dims {dh}, geometries {geoms}")
    ms = [m for m, _ in steps.steps[FAKENET_WARMUP_STEPS:]]
    print(f"{phase}: step time median {float(np.median(ms)):.3f} ms over "
          f"{len(ms)} steps after {FAKENET_WARMUP_STEPS} (each ending in "
          f"torch.cuda.synchronize(), host clock; min {min(ms):.3f}, max "
          f"{max(ms):.3f}); fakenet_train.main {run_s:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)"
          f"; history {json.dumps(out['history'])}; weighted F1 on the "
          f"store {out['weighted_f1']:.4f}  [{card}]", flush=True)

    # (b) every launch's geometry held against its plain version, timed
    # beside it, SDPA (F.dropout for #5) and the bound
    times = in_situ.hold(phase, card)

    # (d) two predictions, bit for bit, and the run's own
    def eval_batches():
        for b in ArrayStore(root / "store").batches(FAKENET_B,
                                                    columns=FT.COLUMNS):
            b = dict(b)
            cat = lb.paths_to_category_idx(b["labels"])
            b["category"] = np.where(cat >= 0, cat, 2).astype(np.int32)
            b["add_feature"] = np.zeros((len(cat), 32), np.float32)
            yield b

    cfg = FT.FakeNetConfig(text_dim=384, image_dim=1024, hidden_dim=256,
                           head=2)
    preds = [FT.predict_fakenet(out["params"], cfg, eval_batches(),
                                return_probs=True) for _ in range(2)]
    same = all(np.array_equal(p[0], out["y_pred"])
               and np.array_equal(p[2], out["probs"]) for p in preds)
    print(f"{phase}: (d) two predictions of {len(preds[0][0])} rows and the "
          f"run's own: bit-identical {same}", flush=True)
    if not same:
        fail(f"{phase}: (d) predictions differ between calls")

    # (e) the answer CSV in the JAX CLI's columns
    with open(answer) as f:
        rows = list(csv.reader(f))
    header = ["idx", "pred"] + [f"p{i}" for i in range(cfg.num_classes)]
    ok = (rows[0] == header and len(rows) == 1 + FAKENET_ROWS and all(
        abs(sum(float(x) for x in r[2:]) - 1.0) < 1e-4 for r in rows[1:]))
    print(f"{phase}: (e) {answer.name}: columns {rows[0]}, {len(rows) - 1} "
          f"rows -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{phase}: (e) the answer CSV is not the JAX CLI's")

    # (c) fp32 kernels against the explicit path
    batch = next(eval_batches())
    batch = {k: v[:FAKENET_PARITY_B] for k, v in batch.items()}
    _fakenet_parity(card, cfg, batch)

    # where a bf16 step spends the card's time; fp32 #2 beside SDPA's
    # backward
    params = copy.deepcopy(out["params"])
    opt = make_optimizer(params, 5e-5)
    step = FT.make_fakenet_train_step(cfg, params, opt, lambda i: 5e-5)
    full = next(eval_batches())
    for _ in range(2):
        step(full, 1)
    prof = PR.profile_window(lambda: step(full, 1), 3, KERNELS,
                             TRAIN_GROUPS + PR.GROUPS)
    print(f"{phase}: torch.profiler over 3 bf16 steps: window "
          f"{prof['window_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}, {prof['device_events']} device events;"
          f" device ms by group "
          f"{json.dumps({k: round(v, 3) for k, v in prof['device_ms_by_group'].items()})}"
          f"  [{card}]", flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(23)
    for (t, s) in FAKENET_GEOMS:
        q, k, v, do = (torch.randn(FAKENET_B, n, 256, device="cuda",
                                   generator=gen) for n in (t, s, s, t))
        o, lse = A.flash_attention(q, k, v, 2, None, DROPOUT_RATE, 3)
        leaves = [x.view(FAKENET_B, -1, 2, 128).transpose(1, 2).detach()
                  .requires_grad_() for x in (q, k, v)]
        lib = sdpa(*leaves, dropout_p=DROPOUT_RATE)
        g = torch.randn_like(lib)
        kern = _time_ms(lambda: A.flash_attention_bwd(
            q, k, v, o, lse, do, 2, None, DROPOUT_RATE, 3), iters=10)
        lib_ms = _time_ms(lambda: torch.autograd.grad(
            lib, leaves, g, retain_graph=True), iters=10)
        bound, by = _in_situ_bound("flash_attn_bwd", (
            q, k, v, o, lse, do, 2, None, DROPOUT_RATE, 3))
        print(f"time   flash_attn_bwd fakenet fp32 B={FAKENET_B} T={t} S={s} "
              f"D=256 H=2 dropout {DROPOUT_RATE}: kernel {kern:.4f} ms, SDPA "
              f"backward {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})  "
              f"[{card}]", flush=True)
        del q, k, v, do, o, lse, leaves, lib, g
    del out, params, opt, preds
    torch.cuda.empty_cache()
    print(f"{phase}: phase wall {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, times



# -- multi-device serving ----------------------------------------------------
SERVE_PARALLEL_WORLD = 4
# (text_parallelism, model_parallel) over the 4 ranks: sp over 2 and 4
# ranks, ring attention over 2, GPipe over 2 and 4 stages (M = pp
# microbatches, the JAX predictor's default), the Megatron split over 2
SERVE_PARALLEL_RUNS = (("sp", 2), ("sp", 4), ("sp_ring", 2), ("pp", 2),
                       ("pp", 4), ("tp", 2))
# family -> load_or_init_frozen(reference_families=...)
SERVE_PARALLEL_FAMILIES = {"default": False, "reference": True}
SERVE_PARALLEL_KERNELS = ("flash_attn_fwd", "deberta_attn_fwd")
# text encodes a served run: the claims once alone, then claims and
# evidence in evaluate_batch; 12 layers each, so 36 attention launches a
# rank on every split (PP: L/pp layers x pp microbatches)
SERVE_PARALLEL_TEXT = 3 * 12
# the parallel text embeddings against the single-device predictor's, L2
# relative, both bf16, a limit for each (family, mode). SP over the
# default family and PP over both run the single-device kernels on the
# same rows (0 on the card), so they are held near exact. The ring's
# online softmax, TP's bf16-rounded partial products summed in fp32, and
# DeBERTa's SP attention (the explicit path against #10) may move a
# layer's output by a bf16 rounding (2^-8 relative) that the next layers
# carry on (5.3e-3 to 1.31e-2 on the card)
SERVE_PARALLEL_EMB_EXACT_TOL = 1e-4
SERVE_PARALLEL_EMB_BF16_TOL = 3e-2
SERVE_PARALLEL_EMB_TOL = {
    ("default", "sp"): SERVE_PARALLEL_EMB_EXACT_TOL,
    ("default", "pp"): SERVE_PARALLEL_EMB_EXACT_TOL,
    ("reference", "pp"): SERVE_PARALLEL_EMB_EXACT_TOL,
    ("default", "sp_ring"): SERVE_PARALLEL_EMB_BF16_TOL,
    ("default", "tp"): SERVE_PARALLEL_EMB_BF16_TOL,
    ("reference", "sp"): SERVE_PARALLEL_EMB_BF16_TOL,
    ("reference", "sp_ring"): SERVE_PARALLEL_EMB_BF16_TOL,
    ("reference", "tp"): SERVE_PARALLEL_EMB_BF16_TOL,
}
# a served label may differ from the single-device one only where the
# single-device logits of its two best classes lie closer than this
SERVE_PARALLEL_MARGIN = 0.05
SHARDED_QUERIES = 32
SHARDED_TOP_K = 5
SHARDED_SCORE_TOL = 1e-3         # bf16 rows, fp32 products, other GEMMs
CLI_TIMEOUT_S = 600


def _serve_parallel_want(family: str, mode: str) -> dict:
    """The launches a rank makes in one served run."""
    text = SERVE_PARALLEL_TEXT
    if family == "default":
        # ring attention runs the online softmax, not #1
        return {"flash_attn_fwd": LAUNCHES_PER_BATCH - PER_BATCH["text"]
                + (0 if mode == "sp_ring" else text)}
    # DeBERTa's SP and ring attention take the explicit path, as in JAX
    return {**REFERENCE_PER_BATCH,
            "deberta_attn_fwd": 0 if mode in ("sp", "sp_ring") else text}


def _param_bytes(module) -> int:
    """Bytes of a module's parameters on the card."""
    return sum(p.numel() * p.element_size() for p in module.parameters()
               if p.device.type == "cuda")


def _labels(results) -> list:
    return [{p: (r[p] or {}).get("label") for p in r} for r in results]


def _margins(results) -> dict:
    """(request, path) -> the logit margin of its two most probable
    classes, log p1 - log p2."""
    out = {}
    for j, r in enumerate(results):
        for path, d in r.items():
            if d is not None:
                p = sorted(d["probabilities"].values(), reverse=True)
                out[j, path] = math.log(p[0]) - math.log(max(p[1], 1e-30))
    return out


def _serve_parallel_rank(rank: int, world: int, dev, job: dict) -> dict:
    """One rank of serve_parallel and retrieval_sharded: the predictor
    over each (text_parallelism, mesh) of SERVE_PARALLEL_RUNS for both
    encoder families, rank 0 also serving single-device; #1 and #10 held
    in situ, one rank at a time; then the image corpus sharded over the
    (2, 2) and (4, 1) meshes. Returns counts, results and rows."""
    import torch.distributed as dist

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.core.mesh import make_mesh
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models.frozen import load_or_init_frozen
    from mmd_tpu_torch.parallel import collectives as C
    from mmd_tpu_torch.retrieval.image import ImageCorpus

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {mp: make_mesh(mp, device=dev) for mp in (2, 4, 1)}
    cfg = ModelConfig(fused_attn=True)
    batch = job["batch"]
    in_situ = _InSitu(only=SERVE_PARALLEL_KERNELS)
    out = {"launches": {k: 0 for k in _kernels()}, "runs": []}

    def serve(pred):
        with torch.inference_mode():
            emb = pred._encode_texts(batch[0]).float().cpu().numpy()
        return emb, pred.evaluate_batch(*batch, detailed=True)

    for family, reference in SERVE_PARALLEL_FAMILIES.items():
        enc = load_or_init_frozen(job["assets"][family], seed=0,
                                  reference_families=reference)

        def predictor(**kw):
            # one FrozenEncoders for every run: tp and pp split a copy
            return MisinformationPredictor(cfg, encoders=enc,
                                           max_length=512,
                                           batch_size=BATCH, **kw)

        if rank == 0:
            pred = predictor(device=dev)
            want_emb, want = serve(pred)
            out[family] = {"bytes": _param_bytes(pred.enc.text_params),
                           "labels": _labels(want),
                           "margins": _margins(want)}
            del pred
        for mode, mp in SERVE_PARALLEL_RUNS:
            pred = predictor(mesh=meshes[mp], text_parallelism=mode)
            dist.barrier()
            torch.cuda.synchronize()
            C.staged_bytes = 0
            _reset_counts()                   # count the served run only
            t0 = time.perf_counter()
            with in_situ:
                emb, got = serve(pred)
            torch.cuda.synchronize()
            run = {"family": family, "mode": mode, "mp": mp,
                   "launches": _counts(), "secs": time.perf_counter() - t0,
                   "text_bytes": _param_bytes(pred.enc.text_params),
                   "staged": C.staged_bytes, "labels": _labels(got)}
            for k, n in run["launches"].items():
                out["launches"][k] += n
            if rank == 0:
                run["emb_err"] = _rel_l2(emb, want_emb)
            out["runs"].append(run)
            del pred
        del enc
        torch.cuda.empty_cache()
    # #1 and #10 at each geometry the runs gave them, one rank at a time,
    # so that no two ranks' timings overlap on the card
    out["in_situ"] = in_situ.launches()
    for r in range(world):
        if r == rank:
            out["rows"] = in_situ.hold(f"serve_parallel_r{rank}",
                                       job["card"])
        dist.barrier()

    # retrieval_sharded: the retrieval phase's image corpus, its rows over
    # the data axis (retrieval by features reads the store only: no ResNet)
    _reset_counts()
    if rank == 0:
        out["single"] = ImageCorpus(
            job["store"], resnet_params=torch.nn.Module(),
            device=dev).retrieve_by_features(job["queries"],
                                             top_k=SHARDED_TOP_K)
    for mp in (2, 1):
        corpus = ImageCorpus(job["store"], resnet_params=torch.nn.Module(),
                             mesh=meshes[mp])
        corpus._load()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = corpus.retrieve_by_features(job["queries"],
                                          top_k=SHARDED_TOP_K)
        out["sharded", mp] = (got, time.perf_counter() - t0,
                              tuple(corpus._features.shape))
        del corpus
    out["retrieval_launches"] = _counts()
    torch.cuda.empty_cache()
    return out


def _start_clis(tmp: Path, texts: list[str], images: list[str]) -> dict:
    """python -m mmd_tpu_torch.evaluate alone and over 2 gloo ranks of a
    torch.distributed.run launch (--text_parallelism sp), and, on a machine
    with one card, over 2 nccl ranks, which must refuse; all started at
    once, in the background."""
    root = Path(__file__).resolve().parent
    args = ["--claim_text", texts[0], "--evidence_text", texts[1],
            "--claim_image", images[0], "--evidence_image", images[1],
            "--assets", str(tmp / "assets_serve"), "--detailed"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mmd_tpu_torch.evaluate", *args,
           "--text_parallelism", "sp"]
    cmds = {"single": [sys.executable, "-m", "mmd_tpu_torch.evaluate",
                       *args],
            "torchrun_gloo": run + ["--dist_backend", "gloo"]}
    if torch.cuda.device_count() < 2:
        cmds["torchrun_nccl"] = run + ["--dist_backend", "nccl"]
    return {k: subprocess.Popen(c, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k, c in cmds.items()}


def _cli_result(stdout: str) -> tuple[dict, str]:
    """(the JSON result, the final label) of evaluate's printout."""
    lines = stdout.splitlines()
    start = lines.index("{")
    end = next(i for i, ln in enumerate(lines) if ln.startswith("final:"))
    return (json.loads("\n".join(lines[start:end])),
            lines[end].split(":", 1)[1].strip())


def _check_clis(procs: dict, card: str, deadline: float) -> None:
    phase = "serve_parallel_cli"
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        fail(f"{phase}: a CLI ran past {CLI_TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for k in ("single", "torchrun_gloo"):
        if procs[k].returncode != 0:
            fail(f"{phase}: {k} exited {procs[k].returncode}: "
                 f"{outs[k][1][-3000:]}")
    single, s_final = _cli_result(outs["single"][0])
    par, p_final = _cli_result(outs["torchrun_gloo"][0])
    labels = [(r or {}).get("label") for r in single.values()]
    par_labels = [(r or {}).get("label") for r in par.values()]
    diff = max((abs(single[p]["probabilities"][c]
                    - par[p]["probabilities"][c])
                for p in single if single[p] is not None
                for c in single[p]["probabilities"]), default=0.0)
    printed = outs["torchrun_gloo"][0].count("final:")
    ok = labels == par_labels and s_final == p_final and printed == 1
    print(f"{phase}: python -m mmd_tpu_torch.evaluate alone: labels "
          f"{labels}, final {s_final}; python -m torch.distributed.run "
          f"--nproc_per_node 2 ... --text_parallelism sp --dist_backend "
          f"gloo: labels {par_labels}, final {p_final}, printed by "
          f"{printed} rank(s); largest probability difference {diff:.3e} "
          f"-> {'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the torchrun CLI does not print the single-device "
             f"CLI's labels once")
    if "torchrun_nccl" in procs:
        rc, err = procs["torchrun_nccl"].returncode, outs["torchrun_nccl"][1]
        refused = rc != 0 and "one rank a card" in err
        print(f"{phase}: --dist_backend nccl, 2 ranks on "
              f"{torch.cuda.device_count()} card: exit {rc}, "
              f"{'raised: nccl runs one rank a card' if refused else 'ran'}"
              f" -> {'ok' if refused else 'FAIL'}", flush=True)
        if not refused:
            fail(f"{phase}: nccl with two ranks on one card did not refuse: "
                 f"exit {rc}, {err[-2000:]}")


def _check_serve_parallel(outs: list, card: str) -> None:
    phase = "serve_parallel"
    for i, run in enumerate(outs[0]["runs"]):
        fam, mode, mp = run["family"], run["mode"], run["mp"]
        tol = SERVE_PARALLEL_EMB_TOL[fam, mode]
        ranks = [o["runs"][i] for o in outs]
        ref = outs[0][fam]
        want = _serve_parallel_want(fam, mode)
        want = {k: want.get(k, 0) for k in run["launches"]}
        flips = [(j, p) for o in ranks for j, (g, w) in enumerate(
            zip(o["labels"], ref["labels"])) for p in g if g[p] != w[p]]
        hard = [f for f in flips if ref["margins"][f]
                >= SERVE_PARALLEL_MARGIN]
        print(f"{phase}: {fam} {mode} over (data, model) "
              f"({SERVE_PARALLEL_WORLD // mp}, {mp}): embeddings rel L2 "
              f"{run['emb_err']:.3e} (limit {tol:.0e}); "
              f"labels off the single-device predictor's {len(flips)} of "
              f"{len(ref['margins']) * len(ranks)}, smallest single-device "
              f"logit margin {min(ref['margins'].values()):.4f}; #1 / #10 a "
              f"rank {[(o['launches']['flash_attn_fwd'], o['launches']['deberta_attn_fwd']) for o in ranks]}"
              f" (want {want['flash_attn_fwd']} / "
              f"{want['deberta_attn_fwd']}); text params on the card a "
              f"rank {[o['text_bytes'] for o in ranks]} B (single device "
              f"{ref['bytes']}); staged through the host "
              f"{[o['staged'] for o in ranks]} B; {run['secs']:.3f} s a "
              f"batch (rank 0, host clock)  [{card}]", flush=True)
        if not run["emb_err"] <= tol:
            fail(f"{phase}: {fam} {mode} over {mp}: the embeddings are "
                 f"{run['emb_err']:.3e} from the single-device predictor's "
                 f"(limit {tol:.0e})")
        if hard:
            fail(f"{phase}: {fam} {mode} over {mp}: labels {hard} differ "
                 f"from the single-device predictor's outside near ties")
        if any(o["launches"] != want for o in ranks):
            fail(f"{phase}: {fam} {mode} over {mp}: launches "
                 f"{[o['launches'] for o in ranks]}, want {want} a rank")
    for o in outs:
        counted = {k: o["launches"][k] for k in SERVE_PARALLEL_KERNELS}
        if o["in_situ"] != counted:
            fail(f"{phase}: the in-situ record {o['in_situ']} misses "
                 f"launches of {counted}")


def _check_retrieval_sharded(outs: list, card: str) -> None:
    phase = "retrieval_sharded"
    want = outs[0]["single"]
    for mp in (2, 1):
        worst, same = 0.0, True
        for o in outs:
            got, secs, shape = o["sharded", mp]
            same &= [[p for p, _ in r] for r in got] == [
                [p for p, _ in r] for r in want]
            worst = max([worst] + [abs(a - b) for g, w in zip(got, want)
                                   for (_, a), (_, b) in zip(g, w)])
        print(f"{phase}: ImageCorpus(mesh=) over (data, model) "
              f"({SERVE_PARALLEL_WORLD // mp}, {mp}): a rank holds "
              f"{outs[0]['sharded', mp][2]} bf16 rows; {SHARDED_QUERIES} "
              f"queries top-{SHARDED_TOP_K}: paths as the single-device "
              f"corpus's on every rank {same}, largest score difference "
              f"{worst:.2e} (tol {SHARDED_SCORE_TOL:.0e}); "
              f"{1e3 * outs[0]['sharded', mp][1]:.3f} ms for the "
              f"{SHARDED_QUERIES} (rank 0, host clock)  [{card}]",
              flush=True)
        if not (same and worst <= SHARDED_SCORE_TOL):
            fail(f"{phase}: the sharded corpus over {mp} disagrees with "
                 f"the single-device corpus")


def phase_serve_parallel(card: str, tmp: Path, texts: list[str],
                         images: list[str]) -> tuple[dict, dict, dict]:
    """Multi-device serving on the card: a spawned world of 4 ranks (gloo
    on one card, sharing it; nccl with a card a rank) serves 16 requests
    at max_length 512 through MisinformationPredictor(mesh=,
    text_parallelism=) in each of SERVE_PARALLEL_RUNS, for the default
    and the reference encoder families, seeded as the serve phases seed
    them; each run held against the single-device predictor, with its
    launches, the text parameters each rank holds on the card and the
    bytes staged through the host; #1 and #10 in situ. Then
    retrieval_sharded, and the torchrun CLI beside the single-device CLI.
    Returns the launches of serve_parallel and of retrieval_sharded, and
    the in-situ rows."""
    from mmd_tpu_torch.data.store import ArrayStore
    from mmd_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    procs = _start_clis(tmp, texts, images)
    deadline = time.monotonic() + CLI_TIMEOUT_S
    store = tmp / "retrieval" / "image_corpus"
    feats = np.asarray(ArrayStore(store).col("features"), np.float32)
    rng = np.random.default_rng(23)
    # the twin row and seeded rows (the built ResNet rows lie nearly
    # parallel, so their order among themselves is a near tie)
    picks = np.concatenate([[TWIN[0]], rng.integers(
        RETRIEVAL_IMAGES, len(feats), SHARDED_QUERIES - 1)])
    queries = (feats[picks] + rng.normal(0, 0.01, (len(picks),
                                                   feats.shape[1]))
               ).astype(np.float32)
    backend = ("nccl" if torch.cuda.device_count() >= SERVE_PARALLEL_WORLD
               else "gloo")
    job = {"card": card, "batch": _batch_of(_requests(texts, images, BATCH)),
           "queries": queries, "store": str(store),
           "assets": {"default": str(tmp / "assets_serve"),
                      "reference": str(tmp / "assets_serve_reference")}}
    print(f"serve_parallel: a world of {SERVE_PARALLEL_WORLD} ranks over "
          f"{backend} on {torch.cuda.device_count()} card(s); runs "
          f"{SERVE_PARALLEL_RUNS} for the default and the reference "
          f"families, {BATCH} requests at max_length 512; the CLIs "
          f"started beside it", flush=True)
    t0 = time.perf_counter()
    try:
        outs = spawn(_serve_parallel_rank, SERVE_PARALLEL_WORLD, backend,
                     "cuda", args=(job,), timeout_s=900)
    except Exception as e:  # a rank that failed fails the phase
        for p in procs.values():
            p.kill()
        fail(f"serve_parallel: a rank failed: {e!r}")
    world_s = time.perf_counter() - t0
    _check_serve_parallel(outs, card)
    _check_retrieval_sharded(outs, card)
    _check_clis(procs, card, deadline)
    rows = {}
    for o in outs:
        for name, r in o["rows"].items():
            rows.setdefault(name, {}).update(r)
    launches = {k: sum(o["launches"][k] for o in outs) for k in _kernels()}
    retrieval = {k: sum(o["retrieval_launches"][k] for o in outs)
                 for k in _kernels()}
    print(f"serve_parallel: the world {world_s:.1f} s, the phase with the "
          f"CLIs {time.perf_counter() - t_phase:.1f} s; launches summed over "
          f"the ranks {json.dumps({k: v for k, v in launches.items() if v})}"
          f"  [{card}]", flush=True)
    return launches, retrieval, rows


TRAIN_PARALLEL_WORLD = 4
# (run, model_parallel, Trainer flags) over the 4 ranks: DP, ZeRO-1 and
# ZeRO-3 on (4, 1), TP and TP + ZeRO-1 on (2, 2), TP on (1, 4)
TRAIN_PARALLEL_RUNS = (("dp", 1, {}), ("zero1", 1, {"zero1": True}),
                       ("zero3", 1, {"zero3": True}),
                       ("tp", 2, {"tensor_parallel": True}),
                       ("tp_zero1", 2, {"tensor_parallel": True,
                                        "zero1": True}),
                       ("tp_1x4", 4, {"tensor_parallel": True}))
TRAIN_PARALLEL_STEPS = 2
# the bf16 runs of train_parallel and finetune_parallel take one step of
# their batches: it gives a step's launches and every geometry held in
# situ (the fp32 runs take two, which the params check needs)
PARALLEL_BF16_STEPS = 1
TRAIN_PARALLEL_KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "mlp_fwd",
                          "mlp_bwd", "dropout")
# a rank's launches a step: the bf16 step's at dropout 0.1 (every split
# keeps the kernels on the rank's rows, heads and hidden slice), and the
# fp32 step's at dropout 0, #1 and #2 alone
TRAIN_PARALLEL_FP32_STEP = {"flash_attn_fwd": PER_STEP["flash_attn_fwd"],
                            "flash_attn_bwd": PER_STEP["flash_attn_bwd"]}
# fp32 at dropout 0 against the single-device step on the card: the loss
# within 1e-5 relative (the mean over ranks, the partial products summed
# in another order); the gathered params, that is the update p - p0 they
# took, within a fifth of one lr a step of the single-device update. A
# param AdamW moves by ~lr a step, so a rank that drops or misapplies one
# step's update (the last one, say) lies ~lr away, 2.5 times the limit
# at 2 steps: the check reads that planted fault on the single-device
# params after one step and fails if it could not see it.
TRAIN_PARALLEL_LOSS_RTOL = PARITY_LOSS_RTOL
TRAIN_PARALLEL_UPDATE_ATOL_LR = 0.2
TRAIN_CLI_TIMEOUT_S = 600
TRAIN_CLI_ARGS = ["--synthetic_samples", str(2 * TRAIN_B), "--batch_size",
                  str(TRAIN_B), "--epochs", "1", "--log_every", "1",
                  "--save_every", "0", "--fused_attn"]
TRAIN_CLI_MESH = ["--model_parallel", "2", "--tensor_parallel", "--zero1",
                  "--dist_backend", "gloo"]


def _train_parallel_cfg(dtype: str, dropout: float):
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    return TrainConfig(model=ModelConfig(fused_attn=True, compute_dtype=dtype,
                                         dropout=dropout),
                       batch_size=TRAIN_B)


def _train_parallel_batches() -> list:
    """The phase's batches, the same on every rank (and in the parent)."""
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    rng = np.random.default_rng(24)
    return [synthetic_preembed_batch(rng, TRAIN_B)
            for _ in range(TRAIN_PARALLEL_STEPS)]


def _train_parallel_rank(rank: int, world: int, dev, job: dict) -> dict:
    """One rank of train_parallel: each run of TRAIN_PARALLEL_RUNS in fp32
    at dropout 0 (rank 0 keeps the losses and the gathered params) and in
    bf16 at dropout 0.1 (the launches, the bytes staged through the host
    and the state bytes of the rank; the step seconds on rank 0), #1-#5
    held in situ at every geometry the bf16 runs gave them: ranks 1-3
    together, then rank 0 alone, timed."""
    import torch.distributed as dist

    from mmd_tpu_torch.core.mesh import make_mesh
    from mmd_tpu_torch.parallel import collectives as C
    from mmd_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {mp: make_mesh(mp, device=dev) for mp in (1, 2, 4)}
    batches = _train_parallel_batches()
    in_situ = _InSitu(only=TRAIN_PARALLEL_KERNELS)
    out = {"launches": {k: 0 for k in _kernels()}, "runs": []}
    for name, mp, flags in TRAIN_PARALLEL_RUNS:
        run = {"name": name, "mp": mp}
        for dtype, rate in (("float32", 0.0), ("bfloat16", DROPOUT_RATE)):
            cfg = _train_parallel_cfg(dtype, rate)
            trainer = Trainer(cfg, mesh=meshes[mp], **flags)
            state = trainer.init(seed=0)
            rows = [trainer.shard_batch(b) for b in batches]
            if dtype == "bfloat16":
                rows = rows[:PARALLEL_BF16_STEPS]
            dist.barrier()
            torch.cuda.synchronize()
            C.staged_bytes = 0
            _reset_counts()                  # count the runs only
            losses, secs = [], []
            with in_situ if dtype == "bfloat16" else contextlib.nullcontext():
                for b in rows:
                    t0 = time.perf_counter()
                    state, aux = trainer.train_step(state, b)
                    losses.append(float(aux["loss"]))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            launches = _counts()
            for k, n in launches.items():
                out["launches"][k] += n
            run[dtype] = {"losses": losses, "secs": secs,
                          "launches": launches, "staged": C.staged_bytes,
                          "state_bytes": state.optimizer.state_bytes()}
            if dtype == "float32":
                whole = trainer.whole_params(state)
                if rank == 0:
                    run["params"] = {k: v.detach().cpu() for k, v in
                                     whole.state_dict().items()}
                del whole
            del trainer, state, rows
            torch.cuda.empty_cache()
        out["runs"].append(run)
    out["in_situ"] = in_situ.launches()
    # ranks 1-3 hold their geometries together, untimed; then rank 0 holds
    # and times its own alone on the card
    if rank != 0:
        out["rows"] = in_situ.hold(f"train_parallel_r{rank}", job["card"],
                                   timed=False)
    dist.barrier()
    if rank == 0:
        out["rows"] = in_situ.hold("train_parallel_r0", job["card"])
    dist.barrier()
    return out


def _check_train_parallel(outs: list, job: dict, card: str) -> None:
    phase = "train_parallel"
    want_l, want_p, lr = job["losses"], job["params"], job["lr"]
    atol = TRAIN_PARALLEL_UPDATE_ATOL_LR * TRAIN_PARALLEL_STEPS * lr

    def worst_of(got: dict) -> tuple[float, str]:
        """The largest |got - want| of any param over the limit, and its
        leaf: p0 cancels, so this is the update's gap."""
        worst, worst_at = 0.0, None
        for k, w in want_p.items():
            ratio = ((got[k] - w).abs() / atol).max().item()
            if ratio > worst:
                worst, worst_at = ratio, k
        return worst, worst_at

    fault, fault_at = worst_of(job["params_but_last"])
    print(f"{phase}: the params check reads a run that skipped the last "
          f"step at {fault:.3f} of its limit ({fault_at}; limit "
          f"{TRAIN_PARALLEL_UPDATE_ATOL_LR} lr a step, lr {lr})  [{card}]",
          flush=True)
    if not fault > 1.0:
        fail(f"{phase}: the params check cannot see a skipped step "
             f"({fault:.3f} of its limit)")
    bf16_want = {k: 0 for k in _kernels()}
    bf16_want.update({k: v * PARALLEL_BF16_STEPS
                      for k, v in PER_STEP_BF16.items()})
    fp32_want = {k: 0 for k in _kernels()}
    fp32_want.update({k: v * TRAIN_PARALLEL_STEPS
                      for k, v in TRAIN_PARALLEL_FP32_STEP.items()})
    for i, run in enumerate(outs[0]["runs"]):
        ranks = [o["runs"][i] for o in outs]
        name, mp = run["name"], run["mp"]
        f32, b16 = run["float32"], run["bfloat16"]
        loss_err = max(abs(g - w) / abs(w)
                       for r in ranks for g, w in zip(r["float32"]["losses"],
                                                      want_l))
        worst, worst_at = worst_of(run["params"])
        finite = all(math.isfinite(x) for r in ranks
                     for x in r["bfloat16"]["losses"])
        print(f"{phase}: {name} over (data, model) "
              f"({TRAIN_PARALLEL_WORLD // mp}, {mp}): fp32 losses "
              f"{[round(x, 6) for x in f32['losses']]} (single device "
              f"{[round(x, 6) for x in want_l]}, worst rel {loss_err:.2e}, "
              f"limit {TRAIN_PARALLEL_LOSS_RTOL:.0e}), params at "
              f"{worst:.3f} of their limit (worst {worst_at}); bf16 losses "
              f"{[round(x, 6) for x in b16['losses']]}; launches a rank "
              f"fp32 {[sum(r['float32']['launches'].values()) for r in ranks]}"
              f", bf16 {[{k: v for k, v in r['bfloat16']['launches'].items() if v} for r in ranks][0]}"
              f"; staged through the host a rank (bf16 run) "
              f"{[r['bfloat16']['staged'] for r in ranks]} B; state bytes a "
              f"rank (params + moments) "
              f"{[r['bfloat16']['state_bytes'] for r in ranks]} (single "
              f"device {job['state_bytes']}); rank 0's bf16 step "
              f"{[round(x, 3) for x in b16['secs']]} s, fp32 step "
              f"{[round(x, 3) for x in f32['secs']]} s (host clock)  "
              f"[{card}]", flush=True)
        if not loss_err <= TRAIN_PARALLEL_LOSS_RTOL:
            fail(f"{phase}: {name}: the fp32 losses are {loss_err:.2e} from "
                 f"the single-device step's")
        if worst > 1.0:
            fail(f"{phase}: {name}: the fp32 params after "
                 f"{TRAIN_PARALLEL_STEPS} steps lie {worst:.3f} times their "
                 f"limit from the single-device params ({worst_at})")
        if not finite:
            fail(f"{phase}: {name}: a bf16 loss is not finite")
        for r in ranks:
            if r["float32"]["launches"] != fp32_want:
                fail(f"{phase}: {name}: fp32 launches "
                     f"{r['float32']['launches']}, want {fp32_want}")
            if r["bfloat16"]["launches"] != bf16_want:
                fail(f"{phase}: {name}: bf16 launches "
                     f"{r['bfloat16']['launches']}, want {bf16_want}")
    for o in outs:
        counted = {k: sum(r["bfloat16"]["launches"][k] for r in o["runs"])
                   for k in TRAIN_PARALLEL_KERNELS}
        if o["in_situ"] != counted:
            fail(f"{phase}: the in-situ record {o['in_situ']} misses "
                 f"launches of {counted}")


def _start_train_cli(tmp: Path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    mmd_tpu_torch.train over TP + ZeRO-1 on (1, 2), in the background."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mmd_tpu_torch.train",
           *TRAIN_CLI_ARGS, *TRAIN_CLI_MESH, "--output_dir",
           str(tmp / "train_cli")]
    return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _check_train_cli(proc, tmp: Path, card: str, deadline: float) -> dict:
    """The torchrun CLI's run, then its checkpoint resumed on one device
    for one step (python -m mmd_tpu_torch.train's build and run_training,
    in process). Returns the resumed run's launches."""
    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.training.loop import run_training

    phase = "train_parallel_cli"
    try:
        stdout, stderr = proc.communicate(
            timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        fail(f"{phase}: the torchrun train CLI ran past "
             f"{TRAIN_CLI_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"{phase}: the torchrun train CLI exited {proc.returncode}: "
             f"{stderr[-3000:]}")
    out = tmp / "train_cli"
    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/total_loss"] for r in recs]
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    done = stdout.count("[train] done at step")
    ok = (len(losses) == 2 and all(map(math.isfinite, losses))
          and ckpts == ["step_2.pt"] and done == 1)
    print(f"{phase}: python -m torch.distributed.run --nproc_per_node 2 -m "
          f"mmd_tpu_torch.train {' '.join(TRAIN_CLI_MESH)}: losses "
          f"{losses}, checkpoints {ckpts}, 'done' printed by {done} rank(s) "
          f"-> {'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the torchrun train CLI's run is not the expected "
             f"one: {stdout[-2000:]}")
    args = TR.parse_args(["--device", "cuda", *TRAIN_CLI_ARGS[:1], str(TRAIN_B),
                          *TRAIN_CLI_ARGS[2:], "--resume_from",
                          str(out / "checkpoints"), "--output_dir",
                          str(tmp / "train_cli_resumed")])
    cfg, trainer, train_batches, _ = TR.build(args)
    saved = torch.load(out / "checkpoints" / "step_2.pt", map_location="cpu",
                       weights_only=True)
    _reset_counts()
    state = run_training(trainer, train_batches)
    torch.cuda.synchronize()
    launches = _counts()
    want = {k: 0 for k in launches}
    want.update(PER_STEP_BF16)
    recs = [json.loads(x) for x in (tmp / "train_cli_resumed" /
                                    "metrics.jsonl").read_text().splitlines()]
    moved = sum(not torch.equal(v.cpu(), saved["params"][k])
                for k, v in state.params.state_dict().items())
    ok = (state.step == 3 and [r["step"] for r in recs] == [3]
          and math.isfinite(recs[0]["train/total_loss"])
          and launches == want and moved > len(saved["params"]) // 2)
    print(f"{phase}: its checkpoint resumed on one device for one step: at "
          f"step {state.step}, loss {recs[0]['train/total_loss']:.6f}, "
          f"{moved} of {len(saved['params'])} params moved, launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the resumed run is not one more step of the saved "
             f"one (launches want {want})")
    return launches


def phase_train_parallel(card: str, tmp: Path) -> tuple[dict, dict, dict]:
    """Multi-device training on the card: a spawned world of 4 gloo ranks
    sharing it runs the default train geometry (batch 256, text 512 x 384,
    image 64 x 1024, the default fusion model with fused_attn) through
    Trainer(mesh=, tensor_parallel=, zero1=, zero3=) in each run of
    TRAIN_PARALLEL_RUNS: fp32 at dropout 0 against the single-device step
    on the card, and bf16 at dropout 0.1 with #1-#5 in situ on every rank;
    beside it the torchrun train CLI over TP + ZeRO-1, whose checkpoint
    then resumes on one device. Returns the world's launches (summed over
    its ranks), the resumed run's, and the in-situ rows."""
    from mmd_tpu_torch.parallel.launch import spawn
    from mmd_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    proc = _start_train_cli(tmp)
    deadline = time.monotonic() + TRAIN_CLI_TIMEOUT_S
    cfg = _train_parallel_cfg("float32", 0.0)
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init(seed=0)
    losses, params = [], []
    for b in _train_parallel_batches():
        state, aux = trainer.train_step(state, trainer.shard_batch(b))
        losses.append(float(aux["loss"]))
        params.append({k: v.detach().cpu()
                       for k, v in state.params.state_dict().items()})
    job = {"card": card, "losses": losses, "lr": cfg.lr,
           "params": params[-1], "params_but_last": params[-2],
           "state_bytes": sum(p.numel() * p.element_size()
                              for p in state.params.parameters()) * 3}
    del trainer, state
    torch.cuda.empty_cache()
    print(f"train_parallel: a world of {TRAIN_PARALLEL_WORLD} gloo ranks "
          f"sharing the card; runs {[r[:2] for r in TRAIN_PARALLEL_RUNS]} "
          f"(name, model_parallel), {TRAIN_PARALLEL_STEPS} steps each in "
          f"fp32 at dropout 0 and {PARALLEL_BF16_STEPS} in bf16 at dropout "
          f"{DROPOUT_RATE}, batch "
          f"{TRAIN_B}; the torchrun train CLI started beside it", flush=True)
    t0 = time.perf_counter()
    try:
        outs = spawn(_train_parallel_rank, TRAIN_PARALLEL_WORLD, "gloo",
                     "cuda", args=(job,), timeout_s=900)
    except Exception as e:  # a rank that failed fails the phase
        proc.kill()
        fail(f"train_parallel: a rank failed: {e!r}")
    world_s = time.perf_counter() - t0
    _check_train_parallel(outs, job, card)
    resumed = _check_train_cli(proc, tmp, card, deadline)
    rows = {}
    for o in outs:
        for name, r in o["rows"].items():
            rows.setdefault(name, {}).update(r)
    launches = {k: sum(o["launches"][k] for o in outs) for k in _kernels()}
    print(f"train_parallel: the world {world_s:.1f} s, the phase with the "
          f"CLI {time.perf_counter() - t_phase:.1f} s; launches summed over "
          f"the ranks {json.dumps({k: v for k, v in launches.items() if v})}"
          f"  [{card}]", flush=True)
    return launches, resumed, rows


FINETUNE_PARALLEL_WORLD = 4
# (run, encoder families, text_parallelism, model axis, Trainer flags,
# remat) over the 4 ranks at FT_BATCH and FT_SEQ
FINETUNE_PARALLEL_RUNS = (
    ("reference_pp_zero3", "reference", "pp", 2, {"zero3": True}, False),
    ("reference_sp", "reference", "sp", 2, {}, False),
    ("reference_sp_ring_1x4", "reference", "sp_ring", 4, {}, False),
    ("default_sp_1x4", "default", "sp", 4, {}, False),
    ("default_pp_remat", "default", "pp", 2, {}, True))
FINETUNE_PARALLEL_STEPS = 2
FINETUNE_PARALLEL_KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "mlp_fwd",
                             "mlp_bwd", "dropout", "deberta_attn_fwd",
                             "deberta_attn_bwd", "swin_attn_train_fwd",
                             "swin_attn_train_bwd")
FINETUNE_PARALLEL_HELD = ("flash_attn_fwd", "flash_attn_bwd",
                          "deberta_attn_fwd", "deberta_attn_bwd",
                          "swin_attn_train_fwd", "swin_attn_train_bwd")
# the default families' text encoder: the BERT-class stack at
# TEXT_ENCODER_XSMALL's width (12 layers, D 384, 6 heads of 64), 24 of
# its launches and 24 of the ViT's a step
FT_TEXT_PER_STEP, FT_VIT_PER_STEP = 24, 24
# The fp32 params check is train_parallel's: the update within 0.2 lr a
# step of the single-device update. Where a gradient is within ~100 times
# Adam's eps (1e-8), Adam's step lr g / (|g| + eps) turns its last digits
# into up to ~lr a step: a key bias (zero in exact arithmetic: softmax
# ignores a constant a query row) holds fp32 noise of ~1e-9, and elements
# of the deep Swin and ViT weights cancel to ~1e-8 as well, so no split of
# the sums reproduces their steps. Those elements are held instead to
# FT_NOISE_ATOL_LR lr a step: two runs' Adam steps (at most lr and ~1.42
# lr apart at steps 1 and 2) can take them no further apart. Above it
# eps / |g| < 1% and a step is its gradient's sign and scale. One step in
# the noise is enough, so an element counts as noise where its smallest
# gradient over the steps is below FT_NOISE_GRAD.
FT_NOISE_GRAD = 1e-6
FT_NOISE_ATOL_LR = 2.5


def _finetune_parallel_want(family: str, mode: str, remat: bool,
                            dtype: str) -> dict:
    """A rank's launches a step. Every split keeps the single-device
    step's counts on the rank's rows: a stage runs half the layers on two
    microbatches, a sequence block attends with every layer. DeBERTa's SP
    and ring take the explicit path (as in the JAX package), so #10 / #11
    run under pp alone; remat runs each encoder layer's forward again in
    the backward. fp32 at dropout 0 runs no #3 / #4 / #5."""
    if family == "reference":
        want = dict(FT_PER_STEP)
        if mode != "pp":
            want["deberta_attn_fwd"] = want["deberta_attn_bwd"] = 0
    else:
        want = dict(RAW_FINETUNE_PER_STEP)
        if remat:
            want["flash_attn_fwd"] += FT_TEXT_PER_STEP + FT_VIT_PER_STEP
    steps = FINETUNE_PARALLEL_STEPS
    if dtype == "float32":
        want.update(mlp_fwd=0, mlp_bwd=0, dropout=0)
    else:
        steps = PARALLEL_BF16_STEPS
    out = {k: 0 for k in _kernels()}
    out.update({k: v * steps for k, v in want.items()})
    return out


def _finetune_parallel_encoders(family: str, tmp: Path):
    """The phase's encoders, seeded as finetune_reference (reference) and
    train_raw (default) seed theirs."""
    from mmd_tpu_torch.inference.traffic import corpus
    from mmd_tpu_torch.models.frozen import load_or_init_frozen
    from mmd_tpu_torch.profile_train import reference_encoders
    if family == "reference":
        return reference_encoders(tmp / "ft_assets")
    return load_or_init_frozen(tmp / "ftp_default_assets",
                               vocab_texts=corpus(np.random.default_rng(0),
                                                  64))


def _in_dtype(enc, dtype: str):
    """The encoders (the same params) with both configs in `dtype`."""
    return dataclasses.replace(
        enc, text_cfg=dataclasses.replace(enc.text_cfg, compute_dtype=dtype),
        vit_cfg=dataclasses.replace(enc.vit_cfg, compute_dtype=dtype))


def _finetune_parallel_cfg(enc, dtype: str, dropout: float, remat: bool):
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.profile_train import FT_BATCH
    model = ModelConfig(text_input_dim=enc.text_cfg.hidden_size,
                        image_input_dim=enc.vit_cfg.hidden_size,
                        fused_attn=True, compute_dtype=dtype,
                        dropout=dropout)
    return TrainConfig(model=model, batch_size=FT_BATCH, remat=remat)


def _finetune_parallel_batches(enc) -> list:
    """The phase's raw batches, the same on every rank (and in the
    parent)."""
    from mmd_tpu_torch.profile_train import FT_BATCH, FT_SEQ, raw_batch
    rng = np.random.default_rng(25)
    return [raw_batch(rng, FT_BATCH, FT_SEQ, enc.text_cfg.vocab_size,
                      enc.vit_cfg.image_size)
            for _ in range(FINETUNE_PARALLEL_STEPS)]


def _worst_update(got, want: dict, grad_min: dict, atol: float,
                  noise_atol: float) -> tuple[float, str, float, int]:
    """The largest |got - want| of any param element over `atol` (over
    `noise_atol` where its smallest single-device gradient `grad_min` is
    below FT_NOISE_GRAD), its leaf, that element's smallest gradient, and
    the count of elements over their limit (p0 cancels: the gap of the
    update)."""
    worst, worst_at, worst_g, over = 0.0, None, 0.0, 0
    for k, p in got.items():
        g = grad_min[k].to(p.device).float()
        gap = (p.float() - want[k].to(p.device)).abs()
        gap = torch.where(g < FT_NOISE_GRAD, gap / noise_atol, gap / atol)
        over += int((gap > 1.0).sum())
        i = int(gap.argmax())
        if gap.view(-1)[i].item() > worst:
            worst, worst_at = gap.view(-1)[i].item(), k
            worst_g = g.view(-1)[i].item()
    return worst, worst_at, worst_g, over


def _finetune_parallel_rank(rank: int, world: int, dev, job: dict) -> dict:
    """One rank of finetune_parallel: each run of FINETUNE_PARALLEL_RUNS in
    fp32 at dropout 0 (rank 0 holds the gathered params against the
    single-device run's) and in bf16 at dropout 0.1 (launches, bytes staged
    through the host, state bytes; step seconds on rank 0), the kernels of
    FINETUNE_PARALLEL_HELD recorded in situ in the bf16 runs and held:
    ranks 1-3 together, then rank 0 alone, timed."""
    import torch.distributed as dist

    from mmd_tpu_torch.core.mesh import make_mesh
    from mmd_tpu_torch.parallel import collectives as C
    from mmd_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(job["tmp"])
    meshes = {mp: make_mesh(mp, device=dev) for mp in (2, 4)}
    in_situ = _InSitu(only=FINETUNE_PARALLEL_HELD)
    out = {"launches": {k: 0 for k in _kernels()}, "runs": []}
    encoders = {f: _finetune_parallel_encoders(f, tmp)
                for f in ("reference", "default")}
    for name, family, mode, mp, flags, remat in FINETUNE_PARALLEL_RUNS:
        run = {"name": name, "mp": mp}
        for dtype, rate in (("float32", 0.0), ("bfloat16", DROPOUT_RATE)):
            enc = _in_dtype(encoders[family], dtype)
            cfg = _finetune_parallel_cfg(enc, dtype, rate, remat)
            trainer = Trainer(cfg, mesh=meshes[mp], encoders=enc,
                              finetune=True, text_parallelism=mode, **flags)
            state = trainer.init(seed=0)
            rows = [trainer.shard_batch(b)
                    for b in _finetune_parallel_batches(enc)]
            if dtype == "bfloat16":
                rows = rows[:PARALLEL_BF16_STEPS]
            del enc
            dist.barrier()
            torch.cuda.synchronize()
            C.staged_bytes = 0
            _reset_counts()                  # count the runs only
            losses, secs = [], []
            with in_situ if dtype == "bfloat16" else contextlib.nullcontext():
                for b in rows:
                    t0 = time.perf_counter()
                    state, aux = trainer.train_step(state, b)
                    losses.append(float(aux["loss"]))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
            launches = _counts()
            for k, n in launches.items():
                out["launches"][k] += n
            run[dtype] = {"losses": losses, "secs": secs,
                          "launches": launches, "staged": C.staged_bytes,
                          "state_bytes": state.optimizer.state_bytes()}
            if dtype == "float32":
                whole = trainer.whole_params(state)
                if rank == 0:
                    want = torch.load(job["params"][family], mmap=True,
                                      weights_only=True)
                    run["worst"] = _worst_update(
                        {k: v.detach() for k, v in
                         whole.state_dict().items()},
                        want["params"], want["grad_min"], job["atol"],
                        job["noise_atol"])
                    del want
                del whole
            del trainer, state, rows
            torch.cuda.empty_cache()
        out["runs"].append(run)
    out["in_situ"] = in_situ.launches()
    if rank != 0:
        out["rows"] = in_situ.hold(f"finetune_parallel_r{rank}", job["card"],
                                   timed=False)
    dist.barrier()
    if rank == 0:
        out["rows"] = in_situ.hold("finetune_parallel_r0", job["card"])
    dist.barrier()
    return out


def _check_finetune_parallel(outs: list, job: dict, card: str) -> None:
    phase = "finetune_parallel"
    faults = []                 # every run reported first, then failed
    for family, (fault, fault_at, _, fault_n) in job["fault"].items():
        print(f"{phase}: the params check reads the {family} families' "
              f"single-device run one step short at {fault:.3f} of its "
              f"limit ({fault_at}, {fault_n} elements over it; limit "
              f"{TRAIN_PARALLEL_UPDATE_ATOL_LR} lr "
              f"a step, lr {job['lr']}; the {job['noise_share'][family]:.4%}"
              f" of the elements whose gradient stays below "
              f"{FT_NOISE_GRAD:g} held to {FT_NOISE_ATOL_LR} lr a step)  "
              f"[{card}]", flush=True)
        if not fault > 1.0:
            faults.append(f"the params check cannot see a skipped step "
                 f"({family}: {fault:.3f} of its limit)")
    for i, (name, family, mode, mp, flags, remat) in enumerate(
            FINETUNE_PARALLEL_RUNS):
        ranks = [o["runs"][i] for o in outs]
        run = outs[0]["runs"][i]
        f32, b16 = run["float32"], run["bfloat16"]
        want_l = job["losses"][family]
        loss_err = max(abs(g - w) / abs(w)
                       for r in ranks for g, w in zip(r["float32"]["losses"],
                                                      want_l))
        worst, worst_at, worst_g, over = run["worst"]
        finite = all(math.isfinite(x) for r in ranks
                     for x in r["bfloat16"]["losses"])
        print(f"{phase}: {name} ({mode} over (data, model) "
              f"({FINETUNE_PARALLEL_WORLD // mp}, {mp}), {flags or 'DP'}"
              f"{', remat' if remat else ''}): fp32 losses "
              f"{[round(x, 6) for x in f32['losses']]} (single device "
              f"{[round(x, 6) for x in want_l]}, worst rel {loss_err:.2e}, "
              f"limit {TRAIN_PARALLEL_LOSS_RTOL:.0e}), params at "
              f"{worst:.3f} of their limit (worst {worst_at}, its smallest "
              f"single-device gradient {worst_g:.3e}; {over} elements over "
              f"it); bf16 losses "
              f"{[round(x, 6) for x in b16['losses']]}; launches a rank "
              f"bf16 {[{k: v for k, v in r['bfloat16']['launches'].items() if v} for r in ranks][0]}"
              f"; staged through the host a rank (bf16 run) "
              f"{[r['bfloat16']['staged'] for r in ranks]} B; state bytes a "
              f"rank (params + moments) "
              f"{[r['bfloat16']['state_bytes'] for r in ranks]} (single "
              f"device {job['state_bytes'][family]}); rank 0's bf16 step "
              f"{[round(x, 3) for x in b16['secs']]} s, fp32 step "
              f"{[round(x, 3) for x in f32['secs']]} s (host clock)  "
              f"[{card}]", flush=True)
        if not loss_err <= TRAIN_PARALLEL_LOSS_RTOL:
            faults.append(f"{name}: the fp32 losses are {loss_err:.2e} from "
                 f"the single-device step's")
        if worst > 1.0:
            faults.append(f"{name}: the fp32 params after "
                 f"{FINETUNE_PARALLEL_STEPS} steps lie {worst:.3f} times "
                 f"their limit from the single-device params ({worst_at})")
        if not finite:
            faults.append(f"{name}: a bf16 loss is not finite")
        for dtype in ("float32", "bfloat16"):
            want = _finetune_parallel_want(family, mode, remat, dtype)
            for r in ranks:
                if r[dtype]["launches"] != want:
                    faults.append(f"{name}: {dtype} launches "
                                  f"{r[dtype]['launches']}, want {want}")
    for o in outs:
        counted = {k: sum(r["bfloat16"]["launches"][k] for r in o["runs"])
                   for k in FINETUNE_PARALLEL_HELD}
        if o["in_situ"] != counted:
            faults.append(f"the in-situ record {o['in_situ']} misses "
                          f"launches of {counted}")
    if faults:
        fail(f"{phase}: " + "; ".join(faults))


FT_CLI_ARGS = ["--batch_size", "8", "--epochs", "1", "--log_every", "1",
               "--save_every", "0", "--fused_attn", "--finetune_encoders"]
FT_CLI_MESH = ["--model_parallel", "2", "--text_parallelism", "pp",
               "--dist_backend", "gloo"]


def _start_finetune_cli(tmp: Path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    mmd_tpu_torch.train --finetune_encoders --model_parallel 2
    --text_parallelism pp on train_raw's tree, in the background."""
    import os
    root = tmp / "factify"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "mmd_tpu_torch.train",
           "--train_data", str(root / "data" / "preprocessed" / "train.csv"),
           *FT_CLI_ARGS, *FT_CLI_MESH, "--output_dir", str(tmp / "ft_cli")]
    env = {**os.environ, "MMD_TPU_ROOT": str(root),
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).resolve().parent),
                os.environ.get("PYTHONPATH", "")])}
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _check_finetune_cli(proc, tmp: Path, card: str, deadline: float
                        ) -> dict:
    """The torchrun fine-tuning CLI's run, then its checkpoint resumed on
    one device for one step (python -m mmd_tpu_torch.train's build and
    run_training, in process). Returns the resumed step's launches."""
    import itertools
    import os

    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.training.loop import run_training

    phase = "finetune_parallel_cli"
    try:
        stdout, stderr = proc.communicate(
            timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        fail(f"{phase}: the torchrun fine-tuning CLI ran past "
             f"{TRAIN_CLI_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"{phase}: the torchrun fine-tuning CLI exited "
             f"{proc.returncode}: {stderr[-3000:]}")
    out = tmp / "ft_cli"
    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/total_loss"] for r in recs]
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    done = stdout.count("[train] done at step")
    steps = len(losses)
    ok = (steps >= 2 and all(map(math.isfinite, losses))
          and ckpts == [f"step_{steps}.pt"] and done == 1
          and sorted(p.name for p in out.iterdir()) == [
              "checkpoints", "metrics.jsonl"])
    print(f"{phase}: python -m torch.distributed.run --nproc_per_node 2 -m "
          f"mmd_tpu_torch.train {' '.join(FT_CLI_ARGS + FT_CLI_MESH)}: "
          f"losses {losses}, checkpoints {ckpts}, 'done' printed by {done} "
          f"rank(s) -> {'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the torchrun fine-tuning CLI's run is not the "
             f"expected one: {stdout[-2000:]}")
    root = tmp / "factify"
    cwd = os.getcwd()
    os.environ["MMD_TPU_ROOT"] = str(root)
    os.chdir(root)
    try:
        args = TR.parse_args([
            "--device", "cuda", "--train_data",
            str(root / "data" / "preprocessed" / "train.csv"), *FT_CLI_ARGS,
            "--resume_from", str(out / "checkpoints"), "--output_dir",
            str(tmp / "ft_cli_resumed")])
        cfg, trainer, train_batches, _ = TR.build(args)
        saved = torch.load(out / "checkpoints" / f"step_{steps}.pt",
                           map_location="cpu", weights_only=True)
        _reset_counts()
        state = run_training(
            trainer, lambda epoch: itertools.islice(train_batches(epoch), 1))
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        del os.environ["MMD_TPU_ROOT"]
    launches = _counts()
    want = {k: 0 for k in launches}
    want.update(RAW_FINETUNE_PER_STEP)
    recs = [json.loads(x) for x in (tmp / "ft_cli_resumed" /
                                    "metrics.jsonl").read_text().splitlines()]
    moved = sum(not torch.equal(v.cpu(), saved["params"][k])
                for k, v in state.params.state_dict().items())
    ok = (state.step == steps + 1 and [r["step"] for r in recs] == [steps + 1]
          and math.isfinite(recs[0]["train/total_loss"])
          and launches == want and moved > len(saved["params"]) // 2)
    print(f"{phase}: its checkpoint resumed on one device for one step: at "
          f"step {state.step}, loss {recs[0]['train/total_loss']:.6f}, "
          f"{moved} of {len(saved['params'])} params moved, launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the resumed run is not one more step of the saved "
             f"one (launches want {want})")
    return launches


def phase_finetune_parallel(card: str, tmp: Path) -> tuple[dict, dict, dict]:
    """Fine-tuning under text parallelism on the card: a spawned world of 4
    gloo ranks sharing it runs each run of FINETUNE_PARALLEL_RUNS through
    Trainer(finetune=True, text_parallelism=): fp32 at dropout 0 against
    the single-device fine-tuning step on the card, bf16 at dropout 0.1
    with the fine-tuning kernels in situ on every rank; beside it the
    torchrun fine-tuning CLI under pp, whose checkpoint then resumes on
    one device. Returns the world's launches (summed over its ranks), the
    resumed step's, and the in-situ rows."""
    from mmd_tpu_torch.parallel.launch import spawn
    from mmd_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    proc = _start_finetune_cli(tmp)
    deadline = time.monotonic() + TRAIN_CLI_TIMEOUT_S
    job = {"card": card, "tmp": str(tmp), "params": {}, "noise_share": {},
           "losses": {}, "fault": {}, "state_bytes": {}}
    for family in ("reference", "default"):
        enc = _in_dtype(_finetune_parallel_encoders(family, tmp), "float32")
        cfg = _finetune_parallel_cfg(enc, "float32", 0.0, False)
        trainer = Trainer(cfg, device="cuda", encoders=enc, finetune=True)
        state = trainer.init(seed=0)
        losses, params, grad_min = [], [], {}
        for b in _finetune_parallel_batches(enc):
            state, aux = trainer.train_step(state, trainer.shard_batch(b))
            losses.append(float(aux["loss"]))
            params.append({k: v.detach().to("cpu", copy=True) for k, v in
                           state.params.state_dict().items()})
            for k, v in state.params.named_parameters():
                g = v.grad.abs()
                grad_min[k] = g if k not in grad_min else torch.minimum(
                    grad_min[k], g)
        grad_min = {k: g.to("cpu", torch.bfloat16)
                    for k, g in grad_min.items()}
        job["lr"] = cfg.lr
        job["atol"] = (TRAIN_PARALLEL_UPDATE_ATOL_LR * FINETUNE_PARALLEL_STEPS
                       * cfg.lr)
        job["noise_atol"] = FT_NOISE_ATOL_LR * FINETUNE_PARALLEL_STEPS * cfg.lr
        path = tmp / f"ftp_single_{family}.pt"
        torch.save({"params": params[-1], "grad_min": grad_min}, path)
        job["params"][family], job["losses"][family] = str(path), losses
        job["noise_share"][family] = (
            sum(int((g < FT_NOISE_GRAD).sum()) for g in grad_min.values())
            / sum(g.numel() for g in grad_min.values()))
        job["fault"][family] = _worst_update(
            params[-2], params[-1], grad_min, job["atol"], job["noise_atol"])
        job["state_bytes"][family] = sum(
            p.numel() * p.element_size()
            for p in state.params.parameters()) * 3
        del trainer, state, params, enc
        torch.cuda.empty_cache()
    print(f"finetune_parallel: a world of {FINETUNE_PARALLEL_WORLD} gloo "
          f"ranks sharing the card; runs "
          f"{[r[:4] for r in FINETUNE_PARALLEL_RUNS]} (name, families, "
          f"text_parallelism, model axis), {FINETUNE_PARALLEL_STEPS} steps "
          f"each in fp32 at dropout 0 and {PARALLEL_BF16_STEPS} in bf16 at "
          f"dropout {DROPOUT_RATE}; the torchrun fine-tuning CLI started "
          f"beside it; "
          f"the single-device references in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        outs = spawn(_finetune_parallel_rank, FINETUNE_PARALLEL_WORLD, "gloo",
                     "cuda", args=(job,), timeout_s=900)
    except Exception as e:  # a rank that failed fails the phase
        proc.kill()
        fail(f"finetune_parallel: a rank failed: {e!r}")
    world_s = time.perf_counter() - t0
    _check_finetune_parallel(outs, job, card)
    resumed = _check_finetune_cli(proc, tmp, card, deadline)
    rows = {}
    for o in outs:
        for name, r in o["rows"].items():
            rows.setdefault(name, {}).update(r)
    launches = {k: sum(o["launches"][k] for o in outs) for k in _kernels()}
    print(f"finetune_parallel: the world {world_s:.1f} s, the phase with the "
          f"CLI {time.perf_counter() - t_phase:.1f} s; launches summed over "
          f"the ranks {json.dumps({k: v for k, v in launches.items() if v})}"
          f"  [{card}]", flush=True)
    return launches, resumed, rows


# run_all_parallel: python -m mmd_tpu_torch.pipelines.run_all over a
# spawned world of 2 gloo ranks sharing the card (rank 0 writes the tree,
# every rank trains its rows), on copies of the run_all phase's synthetic
# tree ((j): 80 rows, 256-px images, the default encoders, bf16, fused
# attention, --batch_size 32): the train batch of 24 gives each rank 12.
RUN_ALL_PARALLEL_WORLD = 2
RUN_ALL_PARALLEL_ARGS = [*RUN_ALL["run_all"], *RUN_ALL_ARGS, "--reuse_tree"]
RUN_ALL_PARALLEL_KERNELS = TRAIN_PARALLEL_KERNELS
RUN_ALL_CLI_TIMEOUT_S = 600
# fp32 at dropout 0 against the single-device run: train_parallel's limits
# (losses 1e-5 relative, the params 0.2 lr a step), but for the attention
# key biases. Softmax ignores a bias that every key shares, so their exact
# gradient is 0, and AdamW turns each run's rounding noise into steps of
# up to lr: they are held to the most two such walks can part, 2 lr a
# step (tests/test_torch_fused.py holds them the same way).
KEY_BIASES = ("representation.text_WK.bias", "representation.image_WK.bias",
              "cross_attn.text_evidence_key.bias",
              "cross_attn.image_evidence_key.bias")
KEY_BIAS_ATOL_LR = 2.0


def _raw_tree(src: Path, dst: Path) -> Path:
    """dst holding src's raw Factify tree (the CSVs and the images)."""
    import shutil
    shutil.copytree(src / "data" / "raw", dst / "data" / "raw")
    return dst


def _processed_tree(src: Path, dst: Path) -> Path:
    """dst holding what src's stages wrote up to the embed stage: the raw
    tree, the preprocessed and enriched CSVs and the stores (which run_all
    --reuse_tree resumes at their ends) and the encoders' assets; the
    retrieval build, which writes its corpora anew, runs again."""
    import shutil
    for d in ("data/raw", "data/preprocessed", "assets"):
        shutil.copytree(src / d, dst / d)
    return dst


@contextlib.contextmanager
def _exact_configs(save_every: int = 0):
    """run_all's fusion model in fp32 at dropout 0, logging every step
    (and checkpointing every save_every): ModelConfig and TrainConfig made
    with those fields, whatever run_all passes."""
    from mmd_tpu_torch.core import config as CF
    model, train = CF.ModelConfig, CF.TrainConfig
    CF.ModelConfig = lambda *a, **kw: model(
        *a, **{**kw, "dropout": 0.0, "compute_dtype": "float32"})
    CF.TrainConfig = lambda *a, **kw: train(
        *a, **{**kw, "log_every": 1, "save_every": save_every})
    try:
        yield
    finally:
        CF.ModelConfig, CF.TrainConfig = model, train


class _InStage:
    """`ctx` (an _InSitu) held open during the named stage of every
    core/profiling.Stages while active."""

    def __init__(self, name: str, ctx):
        self.name, self.ctx = name, ctx

    def __enter__(self):
        from mmd_tpu_torch.core import profiling
        self._orig = orig = profiling.Stages.stage
        name, ctx = self.name, self.ctx

        @contextlib.contextmanager
        def stage(stages, stage_name, log=True):
            with orig(stages, stage_name, log), (
                    ctx if stage_name == name else contextlib.nullcontext()):
                yield

        profiling.Stages.stage = stage
        return self

    def __exit__(self, *exc):
        from mmd_tpu_torch.core import profiling
        profiling.Stages.stage = self._orig


def _run_all_parallel_rank(rank: int, world: int, dev, job: dict) -> dict:
    """One rank of run_all_parallel: run_all.main in fp32 at dropout 0 on
    a copy of the run_all phase's stores (the gathered params kept; the
    ranks' first run, which also takes each new process's first-use
    costs), then as it is on a copy of its raw tree (bf16, dropout 0.1;
    the counted run: launches by stage, #1-#5 recorded in situ in the
    train stage, the bytes staged through the host), then with --fused,
    which must raise; #1-#5 held in situ, rank 1 first, then rank 0
    alone, timed."""
    import torch.distributed as dist

    from mmd_tpu_torch.parallel import collectives as C
    from mmd_tpu_torch.pipelines import run_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with _exact_configs():
        out = run_all.main([*RUN_ALL_PARALLEL_ARGS, "--root",
                            job["exact_root"]])
    got = {"params": {k: v.detach().cpu() for k, v in
                      out["params"].state_dict().items()},
           "exact_s": time.perf_counter() - t0}
    del out
    torch.cuda.empty_cache()

    root = Path(job["root"])
    in_situ = _InSitu(only=RUN_ALL_PARALLEL_KERNELS)
    dist.barrier()
    torch.cuda.synchronize()
    C.staged_bytes = 0
    _reset_counts()                        # count the main path's run only
    t0 = time.perf_counter()
    with _StageLaunches() as stage_launches, _InStage("train", in_situ):
        out = run_all.main([*RUN_ALL_PARALLEL_ARGS, "--root", str(root),
                            "--timings_json", str(root / "timings.json")])
    torch.cuda.synchronize()
    got.update({"launches": _counts(), "by_stage": stage_launches.by_stage,
                "staged": C.staged_bytes, "run_s": time.perf_counter() - t0,
                "in_situ": in_situ.launches(), "step": out["state"].step,
                "batch_size": out["batch_size"],
                "finite": all(bool(torch.isfinite(p).all())
                              for p in out["params"].parameters())})
    if rank == 0:
        got["n_test_store"] = len(out["test_store"])
    del out
    torch.cuda.empty_cache()
    try:
        run_all.main(["--fused", *RUN_ALL_PARALLEL_ARGS, "--root",
                      job["fused_root"]])
        got["fused"] = None
    except ValueError as e:
        got["fused"] = str(e)
    if rank != 0:
        got["rows"] = in_situ.hold(f"run_all_parallel_r{rank}", job["card"],
                                   timed=False)
    dist.barrier()
    if rank == 0:
        got["rows"] = in_situ.hold("run_all_parallel_r0", job["card"])
    dist.barrier()
    return got


def _start_run_all_clis(base: Path, src: Path) -> dict:
    """python -m torch.distributed.run --nproc_per_node 2 -m
    mmd_tpu_torch.pipelines.run_all in the background: over gloo on a copy
    of src's raw tree, and over nccl, which must refuse two ranks on one
    card, at a root that must stay absent."""
    repo = Path(__file__).resolve().parent
    procs = {}
    for backend in ("gloo", "nccl"):
        root = base / f"cli_{backend}"
        if backend == "gloo":
            _raw_tree(src, root)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(RUN_ALL_PARALLEL_WORLD), "-m",
               "mmd_tpu_torch.pipelines.run_all", *RUN_ALL_PARALLEL_ARGS,
               "--root", str(root), "--timings_json",
               str(root / "timings.json"), "--dist_backend", backend]
        procs[backend] = (root, subprocess.Popen(
            cmd, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _check_run_all_clis(procs: dict, card: str, deadline: float) -> None:
    import pandas as pd

    phase = "run_all_parallel_cli"
    outs = {}
    for backend, (root, proc) in procs.items():
        try:
            outs[backend] = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            fail(f"{phase}: the torchrun run_all CLI over {backend} ran "
                 f"past {RUN_ALL_CLI_TIMEOUT_S} s")
    root, proc = procs["gloo"]
    stdout, stderr = outs["gloo"]
    if proc.returncode != 0:
        fail(f"{phase}: the torchrun run_all CLI over gloo exited "
             f"{proc.returncode}: {stderr[-3000:]}")
    ev = pd.read_csv(root / "results" / "eval.csv")
    doc = json.loads((root / "timings.json").read_text())
    printed = {k: stdout.count(k) for k in (
        "[run_all] eval:", "[run_all] timings ->", "[stage] caption:",
        "[stage] embed:", "[stage] train:")}
    ok = (len(ev) == 5 and printed == {
        "[run_all] eval:": 1, "[run_all] timings ->": 1,
        "[stage] caption:": 1, "[stage] embed:": 1,
        "[stage] train:": RUN_ALL_PARALLEL_WORLD})
    print(f"{phase}: python -m torch.distributed.run --nproc_per_node "
          f"{RUN_ALL_PARALLEL_WORLD} -m mmd_tpu_torch.pipelines.run_all "
          f"--dist_backend gloo: eval.csv {len(ev)} rows, timings of "
          f"{doc['n_train_rows']} / {doc['n_test_rows']} rows, stages "
          f"{json.dumps(doc['stages_sec'])}; printed {json.dumps(printed)} "
          f"(rank 0 alone writes and reports; every rank trains) -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail(f"{phase}: the gloo launch's tree or output is not one "
             f"writer's: {stdout[-2000:]}")
    root, proc = procs["nccl"]
    said = "nccl runs one rank a card"
    refused = (proc.returncode != 0 and said in "".join(outs["nccl"])
               and not root.exists())
    print(f"{phase}: --dist_backend nccl with {RUN_ALL_PARALLEL_WORLD} ranks "
          f"on the one card exited {proc.returncode}, said {said!r}: "
          f"{said in ''.join(outs['nccl'])}, its root left absent: "
          f"{not root.exists()} -> {'ok' if refused else 'FAIL'}  [{card}]",
          flush=True)
    if not refused:
        fail(f"{phase}: the nccl launch did not refuse: "
             f"{''.join(outs['nccl'])[-2000:]}")


def _check_run_all_parallel(outs: list, single: dict, base: Path,
                            card: str) -> None:
    import pandas as pd

    phase = "run_all_parallel"
    world = base / "world"
    dfs = {s: pd.read_csv(world / "data" / "preprocessed" / f"{s}.csv")
           for s in ("train", "test")}
    r0 = outs[0]
    steps, bs = r0["step"], r0["batch_size"]
    train = {k: v * steps for k, v in PER_STEP_BF16.items()}
    demo_image = isinstance(dfs["test"]["claim_image"][0], str)
    wants = [_run_all_want(False, {s: len(df) for s, df in dfs.items()},
                           r0["n_test_store"], steps, bs, demo_image),
             {"train": train}]
    doc = json.loads((world / "timings.json").read_text())
    print(f"{phase}: {RUN_ALL_PARALLEL_WORLD} gloo ranks sharing the card, "
          f"train batch {bs} ({bs // RUN_ALL_PARALLEL_WORLD} a rank), "
          f"{steps} steps; rank 0's seconds by stage "
          f"{json.dumps(doc['stages_sec'])}, run_all.main "
          f"{[round(o['run_s'], 1) for o in outs]} s by rank (host clock); "
          f"staged through the host {[o['staged'] for o in outs]} B by "
          f"rank  [{card}]", flush=True)
    for rank, (o, want) in enumerate(zip(outs, wants)):
        if o["step"] != steps or o["batch_size"] != bs or not o["finite"]:
            fail(f"{phase}: rank {rank} took {o['step']} steps of "
                 f"{o['batch_size']}, finite params {o['finite']}")
        bad = {}
        for name in set(o["by_stage"]) | set(want):
            w = {k: want.get(name, {}).get(k, 0) for k in o["launches"]}
            g = o["by_stage"].get(name, {k: 0 for k in o["launches"]})
            if g != w:
                bad[name] = (g, w)
        total = _add(*o["by_stage"].values())
        held = {k: o["by_stage"].get("train", {}).get(k, 0)
                for k in RUN_ALL_PARALLEL_KERNELS}
        shown = {s: {k: v for k, v in c.items() if v}
                 for s, c in o["by_stage"].items() if any(c.values())}
        print(f"{phase}: rank {rank} launches by stage "
              f"{json.dumps(shown)} (predicted {json.dumps(want)}) -> "
              f"{'ok' if not bad else 'FAIL'}  [{card}]", flush=True)
        if bad or {k: total.get(k, 0) for k in o["launches"]} \
                != o["launches"]:
            fail(f"{phase}: rank {rank}'s launches by stage (got, want): "
                 f"{bad}")
        if o["in_situ"] != held:
            fail(f"{phase}: rank {rank}'s in-situ record {o['in_situ']} "
                 f"misses the train stage's launches {held}")
        if not (o["fused"] and "pipelines/fused.py" in o["fused"]):
            fail(f"{phase}: rank {rank}: --fused over "
                 f"{RUN_ALL_PARALLEL_WORLD} ranks did not refuse: "
                 f"{o['fused']!r}")
    if (base / "fused").exists():
        fail(f"{phase}: --fused over {RUN_ALL_PARALLEL_WORLD} ranks wrote "
             f"{sorted(str(p) for p in (base / 'fused').rglob('*'))}")

    # fp32 at dropout 0 against the single-device run
    def losses(root: Path) -> list:
        return [json.loads(x)["train/total_loss"] for x in
                (root / "results" / "metrics.jsonl").read_text()
                .splitlines()]

    got_l, want_l = losses(base / "world_exact"), losses(single["root"])
    lr = single["lr"]
    atol = {k: (KEY_BIAS_ATOL_LR if k in KEY_BIASES
                else TRAIN_PARALLEL_UPDATE_ATOL_LR) * steps * lr
            for k in single["params"]}

    def worst_of(got: dict, want: dict, keys) -> tuple[float, str]:
        """The largest |got - want| of the keys' params over their limit,
        and its leaf."""
        worst, worst_at = 0.0, None
        for k in keys:
            ratio = ((got[k] - want[k]).abs() / atol[k]).max().item()
            if ratio > worst:
                worst, worst_at = ratio, k
        return worst, worst_at

    rest = [k for k in single["params"] if k not in KEY_BIASES]
    fault, fault_at = worst_of(single["params_but_last"], single["params"],
                               rest)
    loss_err = (max(abs(g - w) / abs(w) for g, w in zip(got_l, want_l))
                if len(got_l) == len(want_l) == steps else math.inf)
    worst = [worst_of(o["params"], single["params"], rest) for o in outs]
    keys = [worst_of(o["params"], single["params"], KEY_BIASES)
            for o in outs]
    same = all(torch.equal(outs[0]["params"][k], o["params"][k])
               for o in outs for k in outs[0]["params"])
    print(f"{phase}: fp32 at dropout 0 against the single-device run: "
          f"losses {[round(x, 6) for x in got_l]} (single device "
          f"{[round(x, 6) for x in want_l]}, worst rel {loss_err:.2e}, "
          f"limit {TRAIN_PARALLEL_LOSS_RTOL:.0e}); params at "
          f"{[round(w, 3) for w, _ in worst]} of their limit by rank (worst "
          f"{worst[0][1]}; limit {TRAIN_PARALLEL_UPDATE_ATOL_LR} lr a step), "
          f"the key biases at {[round(w, 3) for w, _ in keys]} of theirs "
          f"({KEY_BIAS_ATOL_LR} lr a step); the ranks' params equal: "
          f"{same}; the single-device run one step short reads "
          f"{fault:.3f} ({fault_at}); --fused refused on both ranks: "
          f"{outs[0]['fused'][:80]!r}  [{card}]", flush=True)
    if not fault > 1.0:
        fail(f"{phase}: the params check cannot see a skipped step "
             f"({fault:.3f} of its limit)")
    if not loss_err <= TRAIN_PARALLEL_LOSS_RTOL:
        fail(f"{phase}: the fp32 losses are {loss_err:.2e} from the "
             f"single-device run's")
    if max(w for w, _ in worst + keys) > 1.0 or not same:
        fail(f"{phase}: the fp32 params lie {worst} ({keys} for the key "
             f"biases) times their limit from the single-device params, or "
             f"the ranks differ ({same})")


def phase_run_all_parallel(card: str, tmp: Path) -> tuple[dict, dict]:
    """run_all over the ranks of a launch on the card: a spawned world of 2
    gloo ranks sharing it runs run_all.main in fp32 at dropout 0 on a copy
    of the run_all phase's stores, against the single-device run_all on
    another copy (run beside the world in this process), then as it is on
    a copy of the run_all phase's raw tree (the counted run, bf16 at
    dropout 0.1: each rank's launches by stage against the count
    predicted, #1-#5 in situ at the ranks' train geometries on both ranks,
    rank 0's stage seconds, the bytes staged through the host), then with
    --fused, which must refuse; beside it the torchrun CLI over gloo (rank
    0 alone writes) and over nccl (which must refuse two ranks on one
    card). Returns the counted run's launches summed over the ranks, and
    the in-situ rows."""
    import os

    from mmd_tpu_torch.parallel.launch import spawn
    from mmd_tpu_torch.pipelines import run_all

    phase = "run_all_parallel"
    t_phase = time.perf_counter()
    src, base = tmp / "run_all", tmp / phase
    procs = _start_run_all_clis(base, src)
    deadline = time.monotonic() + RUN_ALL_CLI_TIMEOUT_S
    job = {"card": card, "root": str(_raw_tree(src, base / "world")),
           "exact_root": str(_processed_tree(src, base / "world_exact")),
           "fused_root": str(base / "fused")}
    single_root = _processed_tree(src, base / "single")
    print(f"{phase}: a world of {RUN_ALL_PARALLEL_WORLD} gloo ranks sharing "
          f"the card runs run_all.main({json.dumps(RUN_ALL_PARALLEL_ARGS)}) "
          f"in fp32 at dropout 0 on a copy of the run_all phase's stores "
          f"(the single-device run beside it), then as it is on a copy of "
          f"its raw tree, then with --fused; the torchrun CLI over gloo and "
          f"over nccl started beside it", flush=True)
    world: dict = {}

    def run_world():
        t0 = time.perf_counter()
        try:
            world["outs"] = spawn(_run_all_parallel_rank,
                                  RUN_ALL_PARALLEL_WORLD, "gloo", "cuda",
                                  args=(job,), timeout_s=900)
        except Exception as e:  # re-raised below
            world["error"] = e
        world["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run_world, name="run_all_parallel")
    thread.start()
    # the single-device run in fp32 at dropout 0, a checkpoint a step
    old_root = os.environ.get("MMD_TPU_ROOT")
    t0 = time.perf_counter()
    try:
        with _exact_configs(save_every=1):
            out = run_all.main([*RUN_ALL_PARALLEL_ARGS, "--root",
                                str(single_root)])
        single_s = time.perf_counter() - t0
    finally:
        if old_root is None:
            os.environ.pop("MMD_TPU_ROOT", None)
        else:
            os.environ["MMD_TPU_ROOT"] = old_root
        thread.join()
    if "error" in world:
        for _, proc in procs.values():
            proc.kill()
        fail(f"{phase}: a rank failed: {world['error']!r}")
    steps = out["state"].step
    ckpt = torch.load(single_root / "results" / "checkpoints" /
                      f"step_{steps - 1}.pt", map_location="cpu",
                      weights_only=True)
    single = {"root": single_root, "lr": 1e-3,
              "params_but_last": ckpt["params"],
              "params": {k: v.detach().cpu() for k, v in
                         out["params"].state_dict().items()}}
    del out
    torch.cuda.empty_cache()
    outs = world["outs"]
    _check_run_all_parallel(outs, single, base, card)
    _check_run_all_clis(procs, card, deadline)
    rows = {}
    for o in outs:
        for name, r in o["rows"].items():
            rows.setdefault(name, {}).update(r)
    launches = {k: sum(o["launches"][k] for o in outs) for k in _kernels()}
    print(f"{phase}: the world {world['s']:.1f} s (its fp32 run "
          f"{[round(o['exact_s'], 1) for o in outs]} s by rank), the "
          f"single-device run beside it {single_s:.1f} s, the phase with the "
          f"CLIs {time.perf_counter() - t_phase:.1f} s; launches summed over "
          f"the ranks {json.dumps({k: v for k, v in launches.items() if v})}"
          f"  [{card}]", flush=True)
    return launches, rows


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
            **phase_train_wide(dev["card"], tmp, texts, images),
            "finetune_reference": phase_finetune_reference(dev["card"], tmp),
            "train_raw": phase_train_raw(dev["card"], tmp)}
        by_phase["swin_window16"], in_situ, by_n = phase_swin_window16(
            dev["card"], tmp, texts, images)
        _set_blocked_launches(recs, by_n)
        for name, rows in in_situ.items():
            recs[name].update(rows)
        by_phase["retrieval"] = phase_retrieval(dev["card"], tmp)
        by_phase["caption"], caption_times = phase_caption(dev["card"], tmp)
        recs["flash_attn_fwd"].update(caption_times)
        train_cap_times = _time_flash_train_captioner(dev["card"])
        by_phase["train_captioner"], split = phase_train_captioner(
            dev["card"], tmp)
        for name, times in train_cap_times.items():
            for geom, row in times.items():
                row["launches_in_phase"] = split[name][geom]
            recs[name].update(times)
        for phase in RUN_ALL:
            by_phase[phase], in_situ = phase_run_all(dev["card"], tmp, phase)
            for name, rows in in_situ.items():
                recs[name].update(rows)
        for phase in RUN_ALL_FUSED:
            by_phase[phase], in_situ = phase_run_all_fused(dev["card"], tmp,
                                                           phase)
            for name, rows in in_situ.items():
                recs[name].update(rows)
        by_phase["fakenet"], in_situ = phase_fakenet(dev["card"], tmp)
        for name, rows in in_situ.items():
            recs[name].update(rows)
        (by_phase["serve_parallel"], by_phase["retrieval_sharded"],
         in_situ) = phase_serve_parallel(dev["card"], tmp, texts, images)
        for name, rows in in_situ.items():
            recs[name].update(rows)
        (by_phase["train_parallel"], by_phase["train_parallel_cli"],
         in_situ) = phase_train_parallel(dev["card"], tmp)
        for name, rows in in_situ.items():
            recs[name].update(rows)
        (by_phase["finetune_parallel"], by_phase["finetune_parallel_cli"],
         in_situ) = phase_finetune_parallel(dev["card"], tmp)
        for name, rows in in_situ.items():
            recs[name].update(rows)
        by_phase["run_all_parallel"], in_situ = phase_run_all_parallel(
            dev["card"], tmp)
        for name, rows in in_situ.items():
            recs[name].update(rows)
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
