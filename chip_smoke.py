#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (f5tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
1. Build every kernel from f5tts_tpu_torch/csrc with nvcc (set-up time).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with seeded inputs: max-abs error over live rows against
   a stated tolerance, median time from CUDA-graph replays, the bound, the
   plain version's time and, for attention, F.scaled_dot_product_attention's
   time as a yardstick (the port never calls it; for the lse modes of K3,
   K5 and K7, PyTorch's memory-efficient attention with
   compute_log_sumexp=True). K1 at every shape the main paths give it:
   [2, 1024 / 4096 / 256, 1024] and [2, 1024 / 4096, 768]. K3's lse mode
   (the training forward) at K3's shapes: its output equal to K3's, its lse
   within 1e-3 of the plain version's on live q tiles and exactly -1e30
   past them.
   The attention backward K4 (b = 2, h = 16, lengths [n, 777], n = 1024,
   3072, 4096) from K3's saved output and lse: dQKV rel-L2 and max-abs over
   live rows against both plain versions (the from-lse one it computes, then
   the recompute one of the JAX function), dead rows exactly 0, SDPA's
   backward (fwd+bwd minus fwd on the same pre-roped inputs) as the
   yardstick. K5's lse mode as K3's, every row. K5, the
   key-masked flat attention (joint n = 1152, 3200, 4352: audio + text rows,
   dead keys mid-sequence, SDPA with a boolean mask as yardstick; and, with
   its lse mode, joint 1124, no multiple of 64, and 1152 with four
   consecutive all-dead key tiles mid-row); K6,
   RMSNorm ([2, 1024, 1024], [2, 1024, 768], and qk-norm's per-head rows
   [2, 16, 4096, 64], also read in place as the head view of q in a fused
   qkv projection, and [2, 16, 256, 64]; F.rms_norm as yardstick); K7, head-layout
   attention (n = 1024, 4224, lengths [n, 777]: every row of a live q tile,
   the rows past the length inside the last one included, against the plain
   version, dead q tiles exactly 0; SDPA as yardstick). K7's lse
   mode (the same inputs: the output as K7's, the lse within 1e-3 on live q
   tiles and exactly -1e30 on dead ones); K8, the key-masked flat backward
   from K5's saved output and lse (K5's joint shapes and masks and joint
   1124, dO on every row: dQKV rel-L2 and max-abs against both plain
   versions as K4's, dead keys' dk/dv exactly 0); K9, the head-layout
   backward from K7's saved output and lse (b = 2, h = 16, n = 1024, 4224,
   lengths [n, 777], dO zero on rows >= length; and n = 1024 with dO on
   every row, rows past the length inside the last live q tile included:
   dq/dk/dv as K4's over all rows, exactly 0 on dead tiles and keys). Each backward is timed beside SDPA's backward on the same inputs.
   K10, the generic grouped conv1d + bias ([2, 1024, 768] and [2, 4096, 768]
   at 16 groups of 48, k = 31; [2, 1024, 384] at 16 groups of 24, k = 4:
   max-abs in f32 against its plain version, F.conv1d(groups=16) through
   cuDNN as the yardstick); K11, the key-masked head-layout attention (b = 2,
   h = 16, joint n = 1152, 4352 with K5's masks, every row; SDPA with a
   boolean mask as the yardstick).
3. The main path: InferencePipeline.infer at F5TTS_v1_Base + Vocos, random
   weights from a seed (the zero-initialised AdaLN, norm_out and proj_out
   weights randomised), three requests and the first again, 16 NFE, CFG 2,
   sway -1. Every wav must be finite and non-silent. The pipeline replays
   one CUDA graph a bucket: each capture must record the attention /
   AdaLN-norm / conv-position kernels 22*16 / 45*16 / 2*16 times (one
   generate), its eager warm-up launch as many, and a request in a captured
   bucket add 0 to the host counter. The same holds in phases 7, 8, 13 and
   14.
4. The same weights cut to depth 2: cfm_sample (y0 given, 4 NFE, n = 1024)
   and Vocos on the card in bf16 (the kernels) against the CPU in f32 (the
   plain versions); the mel's rel-L2 over generated frames must be <= 3e-2.
5. The training path: Trainer.train at F5TTS_v1_Base (bf16 compute, f32
   params and AdamW/EMA state) on seeded in-memory datasets, 4 updates at
   b = 16, n = 1024 (lens in [512, 1024]) and 2 at b = 4, n = 3072. Loss and
   grad norm finite, every parameter leaf changed, the EMA on its cadence
   (every 2 updates: a copy at update 2, a decay at update 4), and each update
   launches K3's lse mode / K4 / K1 / K2 exactly 22 / 22 / 45 / 1 times.
6. One training step at depth 2 (b = 4, n = 512), the same draws, on the card
   in bf16 (the kernels) against the CPU in f32 (the plain versions): loss
   within 2e-2 relative, each gradient leaf's rel-L2 <= 1e-1.
7. InferencePipeline.infer at E2TTS_Base (UNetT) + Vocos, random weights
   from a seed, 16 NFE: one request in the 1023-frame bucket (1024 rows with
   the time token; K3 / K6 / K2 launched 384 / 784 / 32 times a generate)
   and one at the 4096-frame cap (4224 rows: K7 384 times, K3 none).
8. InferencePipeline.infer at MMDiT_Base + Vocos (the zero-initialised AdaLN
   and proj_out randomised), 16 NFE: one request in the 1024 bucket (joint
   1152 rows) and one at the cap (joint 4352 rows); K5 / K1 / K2 launched
   352 / 1408 / 32 times a generate.
9. Phase 4 for the two new backbones at depth 2: mel rel-L2 <= 3e-2.
10. Trainer.train at E2TTS_Base (UNetT), as phase 5: 3 updates at b = 16,
    n = 1024 (1152 rows: K3's lse mode / K4 / K6 / K2 24 / 24 / 49 / 1 an
    update) and 2
    at b = 4, n = 4096, the cap (4224 rows, past the flat gate: K7's lse mode
    / K9 / K6 / K2 24 / 24 / 49 / 1).
11. Trainer.train at MMDiT_Base: 3 updates at b = 16, n = 1024 and 2 at
    b = 4, n = 3072, text of ceil(frames / 6) ids (joint <= 1536 rows and in
    (1536, 4096]: K5's lse mode / K8 / K1 / K2 22 / 22 / 88 / 1 an update).
12. Phase 6 for the UNetT (n = 1023 frames, 1024 rows, once on the flat gate
    and once past it, FLAT_ATTN_MAX_N lowered) and the MMDiT (n = 512).
13. InferencePipeline.infer at the dim-768 presets + Vocos, full width and
    depth, 16 NFE: F5TTS_v1_Small (the 1024 bucket and the 4096 cap; K3 /
    K1 / K10 18*16 / 37*16 / 4*16 a generate, K2 none) and E2TTS_Small (1024
    rows: K3 / K6 / K10 20*16 / 41*16 / 4*16; the cap, 4224 rows: K7 in
    K3's place); then one request at F5TTS_Base (RoPE on the first head
    only: K3 / K1 / K2 352 / 720 / 32).
14. InferencePipeline.infer at MMDiT_Base with qk_norm="rms_norm" (the
    zero-initialised leaves and the four RMSNorm weights randomised), the
    1024 bucket and the cap: K11 / K6 / K1 / K2 22*16 / 4*22*16 / 1408 / 32
    a generate, K5 none.
15. Phase 4 at depth 2 for F5TTS_v1_Small, E2TTS_Small, MMDiT_Base with
    qk-norm, and the F5TTS_v1_Base DiT and E2TTS_Base UNetT with qk-norm
    (K7 at every n): mel rel-L2 <= 3e-2, the card run's launches exact.
16. The graphed generate (`InferencePipeline.fused_generate`) against the
    eager cfm_sample + Vocos on the same prepared request and seed, for
    F5TTS_v1_Base, E2TTS_Base, MMDiT_Base and MMDiT_Base with qk-norm at
    the 1024 bucket and the cap: bit-equal, or mel rel-L2 <= 1e-3 and wav
    max-abs <= 1e-3; the capture's counts as phase 3 asks; the eager and
    graphed walls (medians of 3 requests, in turns), the capture time and
    the memory each graph's pool holds; then one
    `f5tts_tpu_torch.eval.rtf_bench` line for F5TTS_v1_Base at 1024.

17. int8 W8A8 and the pinyin tokenizer: K12 (the per-row int8 quantize,
    rows as they lie) and K13 (the int32 dequant + bias) bit-equal to their
    plain versions at the int8 paths' shapes (an all-zero row in each, odd
    m, the MMDiT's text rows read in place), timed as in phase 2; K12's
    fused modes: K1Q and K6Q (the row engine's quantize stage) bit-equal to
    the card's K1 -> K12 and K6 -> K12 chains at [2, 1024 / 4096, 1024],
    [2, 1024, 768] and [2, 256, 1024] (codes within 1 and scales within a
    bf16 ulp of the row max / 127 against their plain versions), the GELU
    mode against F.gelu + K12 at d = 2048 and 4096 (bit-equal, or codes
    within 1 at <= 0.1% of the entries and scales within 2 f32 ulp, the
    count printed), every all-zero row exactly scale 1 and codes 0, each
    mode's time beside its bound and the chain it replaces;
    `torch._int_mm` at a DiT block's shapes with both weight layouts beside
    the bf16 product; then F5TTS_v1_Base through InferencePipeline.infer in
    bf16 and with quantization="int8" (both with the default pinyin
    tokenizer and the Emilia vocab) at the 1024 bucket and the cap,
    graphed: a generate launches K1Q 44*16, K1 16 (the final norm), the
    plain K12 and the GELU mode 22*16 each, the int8 product and K13 88*16
    each, beside K3 / K2's 352 / 32; walls (medians of 3 in turns) and
    device time of a replay for both; one Chinese + English request whose
    graph's ids must equal convert_char_to_pinyin + list_str_to_idx called
    directly; the depth-2 DiT with int8 on the card against the CPU's int8
    in f32 (mel rel-L2 <= 3e-2) and against the card's bf16 (<= 2x phase
    4's rel-L2); the graphed int8 generate against the eager one as phase
    16 (F5TTS_v1_Base at the 1024 bucket and the cap); an int8 `rtf_bench`
    line and bench.py's; E2TTS_Base int8 at the 1024 bucket (K6Q 48*16, K6
    16, the plain K12 and the GELU mode 24*16, the product and K13 96*16)
    and MMDiT_Base (K1Q 87*16, K1 16, the plain K12 and the GELU mode
    43*16, the product and K13 173*16), and both graphed against eager at
    the cap.
18. The sampler's options, speech editing and BigVGAN: F5TTS_v1_Base at
    the 1024 bucket, cfm_sample(method="midpoint") over 8 steps eagerly (16
    passes: K3 / K1 / K2 352 / 720 / 32, the prompt rows equal cond
    exactly); at depth 2 card bf16 against CPU f32 (mel rel-L2 <= 3e-2,
    launches exact) for the midpoint, an edit_mask with two regenerated
    spans inside the prompt (kept frames exact), no_ref_audio and a
    duplicate_test_start restart at t_inter 0.1; edit_speech on an 8 s
    reference with two spans and new lengths at 32 NFE (K3 / K1 / K2 704 /
    1440 / 64), then its cond and mask through cfm_sample directly (kept
    frames exactly the spliced original, regenerated ones finite and not
    all zero); the full-size BigVGAN (v2 24 kHz 100-band, f32, TF32 off)
    card against CPU on a 128-frame mel (wav rel-L2 <= 1e-3), its decode
    time at 1024 and 4096 frames beside Vocos'; InferencePipeline.infer at
    F5TTS_v1_Base with the bigvgan mel + BigVGAN at the 1024 bucket (phase
    3's checks), its graphed generate against the eager one (phase 16's)
    and a replay's device ms, and ref_mel's len // 256 frames.
19. The last arch flags, the reference-key importer, activation
    checkpointing, bf16 state and the training configurations that had not
    run on the card. (a) F5TTS_v1_Base with long_skip_connection and
    text_embedding_average_upsampling through InferencePipeline.infer at
    the 1024 bucket and the cap (phase 3's checks, 352 / 720 / 32 a
    generate), its graphed generate against the eager one (phase 16's), two
    requests of 800 and 1000 frames in the captured 1024 bucket, each
    graphed generate equal to the eager one on its own inputs and its text
    spread over its own duration, and depth 2 card bf16 against CPU f32
    (mel rel-L2 <= 3e-2). (b) A reference-layout state dict of
    F5TTS_v1_Base with qk-norm and the long skip ("ema_model." keys, the
    mel_spec / rotary_embed keys a checkpoint carries), written as
    safetensors, read through the audited importer (no unread weight key),
    loaded onto the card by utils_infer.load_checkpoint (the arch from
    model_config_from_dict on a dict, as a YAML gives it), exported back by
    to_reference_keys bit for bit, then one request through infer (K7 /
    K6 / K1 / K2 352 / 704 / 720 / 32); the load time. (c) Activation
    checkpointing at F5TTS_v1_Base, 37 x 1024 frames (lens in [512,
    1024]), 2 updates without it and under each remat_policy from the same
    weights, data and draws: peak allocated memory and ms an update, loss
    and grad norm within 1e-3 of the run without checkpointing, K3-lse /
    K4 / K1 / K2 per update 22 / 22 / 45 / 1 without, 44 / 22 / 89 / 1 under
    "nothing" and "dots", 22 / 22 / 89 / 1 under "attn_out" and "attn";
    one update at 64 x 1024 under "nothing"; E2TTS_Base (K3-lse / K4 / K6
    / K2 48 / 24 / 97 / 1) and MMDiT_Base (K5-lse / K8 / K1 / K2 43 / 22 /
    172 / 1: the context_pre_only last block is not checkpointed) under
    "nothing", 2 updates at 16 x 1024; bf16_state at 16 x 1024: mu, nu
    and the EMA stored in bf16 (their bytes), finite updates. (d) 3
    updates at 16 x 1024 of F5TTS_v1_Small (K3-lse / K4 / K1 / K10 18 / 18
    / 37 / 2; K10's backward is the plain VJP), the F5TTS_v1_Base DiT with
    qk-norm (K7-lse / K9 / K6 / K1 / K2 22 / 22 / 44 / 45 / 1; and one
    update at 4 x 4096), E2TTS_Base with qk-norm (K7-lse / K9 / K6 / K2 24
    / 24 / 97 / 1), MMDiT_Base with qk-norm (K11 / K6 / K1 / K2 22 / 88 /
    88 / 1, the plain VJP backward; its peak) and the DiT with
    fuse_qkv=False (K7-lse / K9 / K1 / K2 22 / 22 / 45 / 1), each with its
    peak and ms; then phase 6's depth-2 check for each of the five.
20. Batched serving at F5TTS_v1_Base + Vocos, bf16, the pinyin tokenizer
    and the Emilia vocab, full width and depth: (a) `serve.warmup` over the
    512 / 1024 buckets and b = 1, 2, 4, each capture recording one
    generate's launches (K3 / K1 / K2 352 / 720 / 32) whatever b is, each
    key's capture seconds and pool, their sum and memory_reserved; (b) 3
    requests with different reference lengths (padded to 4) through
    `generate_batch`, graphed against the eager serve body on the same
    static inputs (bit-equal, else int16 max-abs <= 1e-3 * 32767 over live
    samples); (c) each row against the same request alone at b = 1 in the
    same n, wav and text buckets (wav rel-L2 <= 3e-2); (d)
    `eval/serve_bench.py`'s main in-process (16 requests, concurrency 4, a
    1 ms window, 4 streams): zero errors, no cold shape after its warm-up,
    RTF, latency, occupancy and TTFB printed with its JSON line; (e) a
    fine_autowarm capture while a DynamicBatcher serves 4 clients: no
    error, each served wav bit-equal to the same request afterwards; (f)
    one b = 2 batch at E2TTS_Base and MMDiT_Base cut to depth 2, graphed
    against eager with exact launches.
21. Training from data on disk at F5TTS_v1_Base, bf16, the pinyin
    tokenizer, full width and depth: (a) 24 seeded clips of 2-11 s (half
    at 16 kHz, so the resampler runs) through a `CustomDataset` over a
    list of dicts (no arrow on the card): each mel as long as its audio;
    one 16 x 1024 update's host data work (mel, resample, collate,
    tokenize) from 24 kHz wavs, 16 kHz wavs and preprocessed mels, beside
    the step alone (printed, no gate); (b) `finetune_cli` from a
    reference-key safetensors with the Emilia vocab grown by 8 tokens (the
    new embedding rows exactly 0), 2 updates of 16 x 1024 through
    `Trainer` (K3-lse / K4 / K1 / K2 22 / 22 / 45 / 1 each, a finite loss
    and grad norm) with log_samples and Vocos: the milestone sample at
    update 2 launches K3 / K1 / K2 704 / 1440 / 64 (32 NFE) and writes both
    wavs (finite, non-silent), its wall; the milestone checkpoint restores
    bit for bit; the update with its data and the step alone, the peak;
    `train_cli.train` on a config dict, one update; (c) `finetune_cli
    --lora` (rank 8, alpha 16) from the same base, 3 updates (22 / 22 / 45
    / 1 each): every base tensor bit-unchanged, every adapter moved, the
    adapter pickle round-trips bit for bit, ms and peak beside (b)'s; then
    `merge_for_serving` (and its int8 tree) and one `InferencePipeline.infer`
    request at the 1024 bucket in bf16 (352 / 720 / 32) and in int8
    (phase 17's counts); (d) the LoRA loss and adapter gradients at depth
    2, card bf16 against CPU f32 on the same weights, adapters and draws
    (loss within 2e-2 relative, each gradient's rel-L2 <= 1e-1).
22. Multi-GPU at F5TTS_v1_Base (`parallel/`): (a) the attention kernels
    at the heads a rank runs under tensor parallelism (K3, K3-lse, K4 at 8
    and 4 heads; K5, K5-lse, K8, K11, K7, K7-lse, K9 at 8), b = 2, n = 1024,
    against their plain versions at phase 2's gates, timed beside h = 16;
    (b) one process, an NCCL group of world 1: the plain Trainer, then
    `Trainer(mesh=make_mesh(1, 1))` replicated and with zero1, four 16 x
    1024 updates each (22 / 22 / 45 / 1 an update; loss, params and EMA
    after update 2 within 1e-5 of the plain Trainer's; ms, peak, the
    profiler's NCCL and copy ms); (c) two processes on the card over gloo
    (its all_reduce takes CUDA tensors; checked first): a TP-2 CFG-packed
    forward and 16-NFE generate at the 1024 bucket (rel-L2 <= 3e-2 against
    one process; 352 / 720 / 32 a rank), a TP-2 int8 forward (rel-L2 <=
    3e-2 against the one-process int8 forward; K12 2 a block, none in its
    GELU mode), TP-2 and DP-2 first updates at the peak lr on 8 x 1024
    (loss and grad norm within 1e-3, TP gradients rel-L2 <= 3e-2; the
    params: AdamW's first step from the rank's own gradient within 1e-6 x
    (1 + |p|), moved by the one-process update's mean |dp| ~ lr within 2%,
    the update's rel-L2 from the one-process update <= 0.25). gloo's times
    are no measure of NCCL.
23. Evaluation at F5TTS_v1_Base + Vocos, bf16, pinyin, full width and
    depth: (a) eight seeded 24 kHz prompts of 2-5 s and a Seed-TTS
    meta.lst in a temp directory, `get_inference_prompt(infer_batch_size=4)`
    (one 4-row batch, each row its own prompt and total length in one
    bucket, and four single rows), `generate_batches` at 32 NFE a batch at
    a time: K3 / K1 / K2 704 / 1440 / 64 a batch exactly, every wav finite
    and not silent, walls and RTF, the b = 1 and b = 4 batches again under
    the profiler (device-busy share of the traced wall); a row of the
    4-row batch against the same row sampled alone with the same noise
    (mel rel-L2 <= 3e-2 over its generated frames, max-abs printed);
    (d) a two-style, three-segment text through `synthesize_multistyle`
    over the pipeline's `infer` (16 NFE, graphed: 352 / 720 / 32 a chunk,
    each replay counted with its capture's counts; the output as long as
    its segments together); (b) the port's WavLM-large + ECAPA-TDNN in f32
    with numpy-seeded weights: a 3 s clip's embedding on the card against
    the CPU (rel-L2 <= 1e-3), ms an embedding at 3 and 10 s and the peak,
    the weights written as a UniSpeech checkpoint and scored by `run_sim`
    on the card over (a)'s wavs against their prompts (the loader's frac
    1.0; the first score within 1e-4 of the written module's on the CPU);
    (c) UTMOS22-strong in f32 with numpy-seeded weights: a 5 s clip's MOS
    on the card against the CPU (|dMOS| <= 1e-3), ms an utterance, then
    `eval_utmos` over (a)'s wavs from a checkpoint written there.

Prints the `kernels` JSON line (launches: what the card ran on the
inference and training paths of phases 3, 5, 7, 8, 10, 11, 13, 14, 17, 18,
19, 20, 21, 22 (b) and 23, each graph replay counted with its capture's counts), the card's name
and power limit,
and as the last line
{"ok": true, "device": {...}}. Needs a CUDA device and the repo's
f5tts_tpu_torch package beside this file; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, data sheet
BF16_FLOPS_PER_S = 989e12    # dense bf16 tensor cores, data sheet
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores

# max-abs error over live rows
TOL = {"adaln_norm": 2e-2, "conv_pos_embedding": 3e-2, "fused_qkv_rope_attention": 2e-2,
       "fused_qkv_rope_attention_lse": 2e-2, "fused_qkv_rope_attention_bias": 2e-2,
       "fused_qkv_rope_attention_bias_lse": 2e-2, "rms_norm": 2e-2, "flash_attention": 2e-2,
       "flash_attention_lse": 2e-2, "grouped_conv1d": 3e-2, "masked_flash_attention": 2e-2}
LSE_TOL = 1e-3  # the lse modes of K3, K5 and K7: |lse - plain| on live q tiles
# K4's dQKV over live rows: rel-L2, and max-abs against the largest entry of
# the plain version's dQKV (whose scale grows with n)
BWD_REL_L2_TOL = 1e-2
BWD_MAX_ABS_REL_TOL = 2e-2
REPLACES = {
    "adaln_norm": "f5tts_tpu/ops/adaln_norm.py:48",
    "conv_pos_embedding": "f5tts_tpu/ops/grouped_conv.py:168",
    "fused_qkv_rope_attention": "f5tts_tpu/ops/attention.py:567 (+ :659 stream twin)",
    "fused_qkv_rope_attention_lse": "f5tts_tpu/ops/attention.py:567 (+ :659), with the row lse "
                                    "that :886 / :970 recompute",
    "fused_qkv_rope_attention_bwd": "f5tts_tpu/ops/attention.py:886 (+ :970 long twin)",
    "fused_qkv_rope_attention_bias": "f5tts_tpu/ops/attention.py:1240 (+ :1307 stream twin)",
    "fused_qkv_rope_attention_bias_lse": "f5tts_tpu/ops/attention.py:1240 (+ :1307), with the "
                                         "row lse that :1503 recomputes",
    "rms_norm": "f5tts_tpu/ops/adaln_norm.py:97",
    "flash_attention": "f5tts_tpu/ops/attention.py:123 (+ :50 loop twin)",
    "flash_attention_lse": "f5tts_tpu/ops/attention.py:193 return_lse (lse_ref of :123 / :50)",
    "fused_qkv_rope_attention_bias_bwd": "f5tts_tpu/ops/attention.py:1503 (+ bias row of :970)",
    "flash_attention_bwd": "f5tts_tpu/ops/attention.py:357 (+ :249 / :300 split pair)",
    "grouped_conv1d": "f5tts_tpu/ops/grouped_conv.py:27",
    "masked_flash_attention": "f5tts_tpu/ops/attention.py:1653",
    "quantize_rows": "f5tts_tpu/ops/quant.py:42 quantize_rows (plain XLA, no Pallas body)",
    "dequant_bias": "f5tts_tpu/ops/quant.py:96 int8_linear_pre's dequant (plain XLA, no "
                    "Pallas body)",
    "adaln_norm_quant": "f5tts_tpu/ops/adaln_norm.py:48 _adaln_norm_kernel, then "
                        "f5tts_tpu/ops/quant.py:42 quantize_rows (XLA fuses its max-reduce "
                        "into the chain before it)",
    "rms_norm_quant": "f5tts_tpu/ops/adaln_norm.py:97 _rms_norm_kernel, then "
                      "f5tts_tpu/ops/quant.py:42 quantize_rows",
    "gelu_quantize_rows": "f5tts_tpu/models/modules.py:190 gelu_tanh, then "
                          "f5tts_tpu/ops/quant.py:42 quantize_rows (plain XLA, no Pallas body)",
}
SOURCES = {
    "adaln_norm": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "conv_pos_embedding": "f5tts_tpu_torch/csrc/grouped_conv.cu",
    "fused_qkv_rope_attention": "f5tts_tpu_torch/csrc/attention.cu",
    "fused_qkv_rope_attention_lse": "f5tts_tpu_torch/csrc/attention.cu",
    "fused_qkv_rope_attention_bwd": "f5tts_tpu_torch/csrc/attention_bwd.cu",
    "fused_qkv_rope_attention_bias": "f5tts_tpu_torch/csrc/attention.cu",
    "fused_qkv_rope_attention_bias_lse": "f5tts_tpu_torch/csrc/attention.cu",
    "rms_norm": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "flash_attention": "f5tts_tpu_torch/csrc/attention.cu",
    "flash_attention_lse": "f5tts_tpu_torch/csrc/attention.cu",
    "fused_qkv_rope_attention_bias_bwd": "f5tts_tpu_torch/csrc/attention_bwd.cu",
    "flash_attention_bwd": "f5tts_tpu_torch/csrc/attention_bwd.cu",
    "grouped_conv1d": "f5tts_tpu_torch/csrc/grouped_conv.cu",
    "masked_flash_attention": "f5tts_tpu_torch/csrc/attention.cu",
    "quantize_rows": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "dequant_bias": "f5tts_tpu_torch/csrc/quant.cu",
    "adaln_norm_quant": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "rms_norm_quant": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "gelu_quantize_rows": "f5tts_tpu_torch/csrc/adaln_norm.cu",
}
NFE = 16
# phases 5, 10 and 11: (batch, frames, updates, launches an update)
# (under grad K3 and K5 run their lse modes)
_DIT_PER_UPDATE = {"fused_qkv_rope_attention_lse": 22, "fused_qkv_rope_attention_bwd": 22,
                   "adaln_norm": 45, "conv_pos_embedding": 1}
DIT_TRAIN_CELLS = ((16, 1024, 4, _DIT_PER_UPDATE), (4, 3072, 2, _DIT_PER_UPDATE))
UNETT_TRAIN_CELLS = (
    (16, 1024, 3, {"fused_qkv_rope_attention_lse": 24, "fused_qkv_rope_attention_bwd": 24,
                   "rms_norm": 49, "conv_pos_embedding": 1}),
    (4, 4096, 2, {"flash_attention_lse": 24, "flash_attention_bwd": 24, "rms_norm": 49,
                  "conv_pos_embedding": 1}))
_MMDIT_PER_UPDATE = {"fused_qkv_rope_attention_bias_lse": 22,
                     "fused_qkv_rope_attention_bias_bwd": 22,
                     "adaln_norm": 88, "conv_pos_embedding": 1}
MMDIT_TRAIN_CELLS = ((16, 1024, 3, _MMDIT_PER_UPDATE), (4, 3072, 2, _MMDIT_PER_UPDATE))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, iters: int = 15) -> float:
    """Median device time of one fn() call by CUDA-graph replay
    (`f5tts_tpu_torch.scripts.common.time_ms`)."""
    from f5tts_tpu_torch.scripts.common import time_ms as graph_time_ms

    return graph_time_ms(fn, reps, iters)


def wall_ms(fn, iters: int = 20) -> float:
    """Median time of one eager fn() call from CUDA events, host launch
    overhead included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def live_err(a, b, lengths) -> float:
    """Max |a - b| over rows < lengths[b] of [b, n, c] tensors."""
    import torch

    n = a.shape[1]
    live = torch.arange(n, device=a.device)[None, :] < lengths.to(a.device)[:, None]
    diff = (a.float() - b.float()).abs()
    return float(diff[live].max())


def merge_rows(out_row, row):
    """The first shape's row with the largest error over all shapes."""
    if out_row is None:
        return row
    out_row["max_abs_err"] = max(out_row["max_abs_err"], row["max_abs_err"])
    return out_row


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build() -> None:
    import torch
    from f5tts_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    try:
        import triton  # the port does not use it; recorded for later slices

        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    cutlass = Path("/usr/local/cutlass/include")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"triton {triton_version}, CUTLASS headers {cutlass if cutlass.is_dir() else 'absent'}")
    log(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    from f5tts_tpu_torch.scripts.common import gpu_name_and_limit

    log(f"gpu: {gpu_name_and_limit()}")
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    log(f"phase 1 build: {len([k for k in built if '.' not in k])} kernel libraries "
        f"in {time.perf_counter() - t0:.1f} s (set-up)")
    for key, text in built.items():
        if key.endswith(".ptxas"):
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {key[:-6]}: {line.strip()}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# K1's shapes on the main paths (b = 2: CFG packs cond and uncond): the 1024
# bucket's rows (the row of the kernels line), the cap's, the MMDiT text
# stream at 256 ids, and F5TTS_v1_Small's (dim 768) at the 1024 bucket and
# the cap; (n, d, seed), each shape but the first from its own seed, so the
# later checks' draws stay as they were
K1_SHAPES = ((1024, 1024, None), (4096, 1024, 1), (256, 1024, 2), (1024, 768, 3), (4096, 768, 4))


def check_adaln(rng, dev) -> dict:
    """K1 at every shape the main paths launch it at (`K1_SHAPES`)."""
    import torch
    from f5tts_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_ref

    out_row = None
    for n, d, seed in K1_SHAPES:
        b = 2
        draw = rng if seed is None else np.random.default_rng(seed)
        x = torch.from_numpy(draw.standard_normal((b, n, d)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        mods = torch.from_numpy((0.05 * draw.standard_normal((b, 6 * d))).astype(np.float32))
        mods = mods.to(dev, torch.bfloat16)
        shift, scale = mods[:, :d], mods[:, d:2 * d]       # strided views, as in a block
        out = adaln_norm(x, scale, shift)
        ref = adaln_norm_ref(x.float(), scale.float(), shift.float())
        torch.cuda.synchronize()
        err = live_err(out, ref, torch.full((b,), n))
        nbytes = 2 * b * n * d * 2 + 2 * b * d * 2
        bound = max(nbytes / HBM_BYTES_PER_S, 8 * b * n * d / F32_FLOPS_PER_S) * 1e3
        ms = time_ms(lambda: adaln_norm(x, scale, shift))
        wall = wall_ms(lambda: adaln_norm(x, scale, shift))
        plain = time_ms(lambda: adaln_norm_ref(x, scale, shift), reps=2)
        log(f"  adaln_norm [{b},{n},{d}] bf16: max_abs_err {err:.3e} (tol {TOL['adaln_norm']}), "
            f"{ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms (bytes), "
            f"plain {plain:.4f} ms, {ms / bound:.2f}x the bound")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                       "bound_ms": bound, "bound_by": "bytes", "library_ms": None})
    return out_row


def check_conv_pos(rng, dev) -> dict:
    import torch
    from f5tts_tpu_torch.ops.grouped_conv import conv_pos_embedding, conv_pos_embedding_ref

    b, c, k, groups = 1, 1024, 31, 16
    bound_w = 1.0 / math.sqrt(64 * k)
    w1, w2 = (torch.from_numpy(rng.uniform(-bound_w, bound_w, (k, 64, c)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.uniform(-bound_w, bound_w, (c,)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    out_row = None
    for n, length in ((1024, 1024), (1024, 777), (4096, 3001)):
        x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(dev, torch.bfloat16)
        lengths = torch.tensor([length], dtype=torch.int32, device=dev)
        out = conv_pos_embedding(x, w1, b1, w2, b2, lengths, groups)
        ref = conv_pos_embedding_ref(x.float(), w1.float(), b1.float(), w2.float(), b2.float(),
                                     lengths, groups)
        torch.cuda.synchronize()
        err = live_err(out, ref, lengths)
        dead = float(out[0, length:].abs().max()) if length < n else 0.0
        flops = 2 * 2 * length * c * k * 64
        nbytes = 2 * b * n * c * 2 + 2 * (k * 64 * c + c) * 2
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: conv_pos_embedding(x, w1, b1, w2, b2, lengths, groups))
        wall = wall_ms(lambda: conv_pos_embedding(x, w1, b1, w2, b2, lengths, groups))
        plain = time_ms(lambda: conv_pos_embedding_ref(x, w1, b1, w2, b2, lengths, groups), reps=2)
        log(f"  conv_pos_embedding [1,{n},1024] length {length}: max_abs_err {err:.3e} "
            f"(tol {TOL['conv_pos_embedding']}), dead rows max {dead:.1e}, {ms:.4f} ms "
            f"(eager call {wall:.4f} ms), "
            f"bound {bound:.4f} ms (operations), plain {plain:.4f} ms")
        if dead != 0.0:
            raise AssertionError("conv_pos_embedding: rows >= length are not zero")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": None})
    return out_row


def check_attention(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import fused_qkv_rope_attention, fused_qkv_rope_attention_ref
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for n in (1024, 3200, 4096):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * hd)).astype(np.float32)).to(dev, torch.bfloat16)
        cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n).to(dev), n, h, dtype=torch.bfloat16)
        out = fused_qkv_rope_attention(qkv, cos, sin, lengths, h)
        ref = fused_qkv_rope_attention_ref(qkv.float(), cos.float(), sin.float(), lengths, h)
        torch.cuda.synchronize()
        err = live_err(out, ref, lengths)
        dead = float(out[1, 777:].abs().max())
        sq = sum(int(v) ** 2 for v in lengths.tolist())
        flops = 4 * h * d * sq
        nbytes = (b * n * 3 * hd + 2 * n * hd + b * n * hd) * 2
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: fused_qkv_rope_attention(qkv, cos, sin, lengths, h))
        wall = wall_ms(lambda: fused_qkv_rope_attention(qkv, cos, sin, lengths, h))
        plain = time_ms(lambda: fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, h), reps=1, iters=5)
        # yardstick: SDPA on pre-roped [b, h, n, d] with the same key mask
        qh, kh, vh = flat_to_heads(qkv, cos, sin, h)
        kmask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=kmask))
        log(f"  fused_qkv_rope_attention b=2 h=16 d=64 n={n} lengths [{n}, 777]: max_abs_err "
            f"{err:.3e} (tol {TOL['fused_qkv_rope_attention']}), dead rows max {dead:.1e}, "
            f"{ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms (operations), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms")
        if dead != 0.0:
            raise AssertionError("fused_qkv_rope_attention: rows >= length are not zero")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


def flat_to_heads(qkv, cos, sin, heads: int) -> tuple:
    """Pre-roped [b, h, n, d] q, k, v of a flat qkv (the yardsticks' inputs)."""
    from f5tts_tpu_torch.ops.rope import apply_rotary_flat_tables

    b, n, hd3 = qkv.shape
    q, k, v = qkv.split(hd3 // 3, dim=-1)
    return tuple(t.reshape(b, n, heads, -1).transpose(1, 2).contiguous() for t in
                 (apply_rotary_flat_tables(q, cos, sin), apply_rotary_flat_tables(k, cos, sin), v))


def sdpa_bwd_ms(qh, kh, vh, dout, kmask) -> tuple[float, float]:
    """(backward, forward) ms of F.scaled_dot_product_attention on [b, h, n, d]
    under the [b, n] key mask, the backward as (fwd + bwd) - fwd; dout is
    flat [b, n, h*d] or [b, h, n, d]."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (t.detach().requires_grad_() for t in (qh, kh, vh))
    gh = dout if dout.dim() == 4 else dout.reshape(qh.shape[0], qh.shape[2], qh.shape[1],
                                                   -1).transpose(1, 2).contiguous()
    mask4 = kmask[:, None, None, :]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4)
        return torch.autograd.grad(o, (qh, kh, vh), gh)

    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4))
    return time_ms(fwd_bwd) - fwd, fwd


def sdpa_lse_ms(qh, kh, vh, kmask) -> float:
    """ms of one call of PyTorch's memory-efficient attention that also
    returns the row log-sum-exp (`compute_log_sumexp=True`) on pre-roped [b,
    h, n, d], the [b, n] key mask as an additive 0 / -1e30 bias (its batch
    stride padded to 16 elements, as SDPA pads it): the library time of an
    lse mode."""
    import torch
    from f5tts_tpu_torch.ops.attention import NEG_INF

    b, h, n, _ = qh.shape
    bias = torch.full((b, 1, 1, -(-n // 16) * 16), NEG_INF, dtype=qh.dtype, device=qh.device)
    bias[..., :n] = torch.where(kmask, 0.0, NEG_INF)[:, None, None, :]
    bias = bias[..., :n].expand(b, h, n, n)
    fn = torch.ops.aten._scaled_dot_product_efficient_attention
    return time_ms(lambda: fn(qh, kh, vh, bias, True))


def bwd_errors(got, want) -> tuple[float, float, float]:
    """(rel-L2, max-abs error, largest entry of want) of a backward."""
    a, w = got.float(), want.float()
    return float((a - w).norm() / w.norm()), float((a - w).abs().max()), float(w.abs().max())


def check_bwd_tol(name: str, rel: float, err: float, top: float) -> None:
    if not (rel <= BWD_REL_L2_TOL and err <= BWD_MAX_ABS_REL_TOL * top):
        raise AssertionError(f"{name}: rel-L2 {rel}, max_abs_err {err} against largest entry {top}")


def flat_lse_row(name: str, n: int, live_rows, out, lse, ref, ref_lse, tile_end: int,
                 timed, plain, lib: float, flops: float, nbytes: int, what: str) -> dict:
    """Check and time a flat lse mode (K3's or K5's): the output equal to the
    mode without lse, the lse within LSE_TOL of the plain version's on rows of
    live q tiles and -1e30 past them (`tile_end` of batch row 1)."""
    import torch
    from f5tts_tpu_torch.ops.attention import NEG_INF

    err = float((out.float() - ref.float()).abs()[live_rows].max())
    lse_err = max(float((lse[0] - ref_lse[0]).abs().max()),
                  float((lse[1, :, :tile_end] - ref_lse[1, :, :tile_end]).abs().max()))
    dead_ok = bool((lse[1, :, tile_end:] == NEG_INF).all())
    bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(timed)
    plain_ms = time_ms(plain, reps=1, iters=5)
    torch.cuda.synchronize()
    log(f"  {name} b=2 h=16 d=64 {what}: max_abs_err {err:.3e} (tol {TOL[name]}), lse max err "
        f"{lse_err:.3e} (tol {LSE_TOL}), dead tiles -1e30: {dead_ok}, {ms:.4f} ms, bound "
        f"{bound:.4f} ms (operations), plain {plain_ms:.4f} ms, sdpa efficient with lse {lib:.4f} ms")
    if not (dead_ok and lse_err <= LSE_TOL):
        raise AssertionError(f"{name} at n={n}: lse err {lse_err}, dead tiles {dead_ok}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": lib}


def check_attention_lse(rng, dev) -> dict:
    """K3's lse mode (the training forward) at K3's shapes: its output equal
    to K3's, its lse against the plain version's on the same bf16 inputs."""
    import torch
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention,
                                               fused_qkv_rope_attention_fwd,
                                               fused_qkv_rope_attention_ref)
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for n in (1024, 3200, 4096):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * hd)).astype(np.float32)).to(dev, torch.bfloat16)
        cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n).to(dev), n, h, dtype=torch.bfloat16)
        out, lse = fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, h, return_lse=True)
        ref, ref_lse = fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, h, return_lse=True)
        if not torch.equal(out, fused_qkv_rope_attention(qkv, cos, sin, lengths, h)):
            raise AssertionError("fused_qkv_rope_attention_lse: output differs from K3's")
        live = torch.arange(n, device=dev)[None, :] < lengths[:, None]
        lib = sdpa_lse_ms(*flat_to_heads(qkv, cos, sin, h), live)
        sq = sum(int(v) ** 2 for v in lengths.tolist())
        nbytes = (b * n * 3 * hd + 2 * n * hd + b * n * hd) * 2 + b * h * n * 4
        out_row = merge_rows(out_row, flat_lse_row(
            "fused_qkv_rope_attention_lse", n, live, out, lse, ref, ref_lse, -(-777 // 64) * 64,
            lambda: fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, h, return_lse=True),
            lambda: fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, h, return_lse=True),
            lib, 4 * h * d * sq, nbytes, f"n={n} lengths [{n}, 777]"))
    return out_row


def bwd_inputs(rng, dev, b: int, n: int, hd: int):
    import torch

    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
                 for shape in ((b, n, 3 * hd), (b, n, hd)))


def check_flat_bwd(name: str, got, wants, live_rows, dead: float, timed, plain, lib: float,
                   lib_fwd: float, flops: float, nbytes: int, what: str) -> dict:
    """A flat backward (K4 or K8) against both plain versions: the from-lse
    one (its function) and the recompute one (the JAX function); `dead` is the
    largest entry that must be exactly 0."""
    import torch

    errs = []
    for label, want in wants:
        rel, err, top = bwd_errors(got[live_rows], want[live_rows])
        log(f"  {name} {what} vs the {label} plain version: rel-L2 {rel:.3e} (tol "
            f"{BWD_REL_L2_TOL}), max_abs_err {err:.3e} (tol {BWD_MAX_ABS_REL_TOL} x largest entry "
            f"{top:.3e})")
        check_bwd_tol(f"{name} {what} ({label})", rel, err, top)
        errs.append(err)
    bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    ms = time_ms(timed)
    plain_ms = time_ms(plain, reps=1, iters=3)
    torch.cuda.synchronize()
    log(f"  {name} {what}: dead entries max {dead:.1e}, {ms:.4f} ms, bound {bound:.4f} ms "
        f"(operations), plain (from lse) {plain_ms:.4f} ms, sdpa bwd {lib:.4f} ms (fwd "
        f"{lib_fwd:.4f} ms)")
    if dead != 0.0:
        raise AssertionError(f"{name} {what}: dead rows or keys are not 0")
    return {"max_abs_err": errs[0], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": lib}


def check_attention_bwd(rng, dev) -> dict:
    """K4 from K3's saved output and lse (its lse mode), dO on every row."""
    import torch
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention_bwd,
                                               fused_qkv_rope_attention_bwd_from_lse_ref,
                                               fused_qkv_rope_attention_bwd_ref,
                                               fused_qkv_rope_attention_fwd)
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for n in (1024, 3072, 4096):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        qkv, dout = bwd_inputs(rng, dev, b, n, hd)
        cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n).to(dev), n, h, dtype=torch.bfloat16)
        out, lse = fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, h, return_lse=True)
        args = (qkv, cos, sin, lengths, out, lse, dout, h)
        got = fused_qkv_rope_attention_bwd(*args)
        wants = (("from-lse", fused_qkv_rope_attention_bwd_from_lse_ref(*args)),
                 ("recompute", fused_qkv_rope_attention_bwd_ref(qkv, cos, sin, lengths, dout, h)))
        kmask = torch.arange(n, device=dev)[None, :] < lengths[:, None]
        sq = sum(int(v) ** 2 for v in lengths.tolist())
        nbytes = (2 * b * n * 3 * hd + 2 * b * n * hd + 2 * n * hd) * 2 + b * h * n * 4
        # yardstick: SDPA's backward on pre-roped [b, h, n, d], the same key mask
        lib, lib_fwd = sdpa_bwd_ms(*flat_to_heads(qkv, cos, sin, h), dout, kmask)
        out_row = merge_rows(out_row, check_flat_bwd(
            "fused_qkv_rope_attention_bwd", got, wants, kmask, float(got[1, 777:].abs().max()),
            lambda: fused_qkv_rope_attention_bwd(*args),
            lambda: fused_qkv_rope_attention_bwd_from_lse_ref(*args), lib, lib_fwd,
            10 * h * d * sq, nbytes, f"b=2 h=16 d=64 n={n} lengths [{n}, 777]"))
    return out_row


def check_attention_bias(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention_bias,
                                               fused_qkv_rope_attention_bias_ref)

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for na, nt, gap in JOINT_CASES + JOINT_EDGE_CASES:  # joint 1152, 3200, 4352, 1124, 1152
        n = na + nt
        qkv, cos, sin, kmask = joint_case(rng, dev, na, nt, gap)
        out = fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, h)
        ref = fused_qkv_rope_attention_bias_ref(qkv.float(), cos.float(), sin.float(), kmask, h)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs()[kmask].max())
        dead = float((out.float() - ref.float()).abs()[~kmask].max())
        live_keys = [int(v) for v in kmask.sum(dim=1).tolist()]
        flops = 4 * h * d * n * sum(live_keys)
        nbytes = (b * n * 3 * hd + 2 * n * hd + b * n * hd) * 2 + b * n
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, h))
        wall = wall_ms(lambda: fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, h))
        plain = time_ms(lambda: fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, h),
                        reps=1, iters=5)
        qh, kh, vh = flat_to_heads(qkv, cos, sin, h)
        mask4 = kmask[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4))
        log(f"  fused_qkv_rope_attention_bias b=2 h=16 d=64 joint n={n} ({na} audio + {nt} text"
            f"{gap_text(gap)}), live keys {live_keys}: max_abs_err over live rows {err:.3e} (tol "
            f"{TOL['fused_qkv_rope_attention_bias']}), dead rows {dead:.3e}, {ms:.4f} ms (eager "
            f"call {wall:.4f} ms), bound {bound:.4f} ms (operations), plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms")
        if not dead <= TOL["fused_qkv_rope_attention_bias"]:
            raise AssertionError(f"fused_qkv_rope_attention_bias: dead rows differ by {dead}")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


# K6's phase-2 shapes: the UNetT's pre-norm rows, the dim-768 presets' rows,
# and qk-norm's per-head rows (b = 2 with CFG, 16 heads of 64) of the audio
# stream at the 4096 cap and of the text stream, where most of K6's launches
# land (1408 a generate at the qk-norm MMDiT), with the bf16 weight the
# inference params hold; the audio rows also as the model hands them to K6,
# the head view of q inside the fused [2, 4096, 3 * 1024] projection
RMS_SHAPES = (((2, 1024, 1024), False), ((2, 1024, 768), False), ((2, 16, 4096, 64), False),
              ((2, 16, 4096, 64), True), ((2, 16, 256, 64), False))


def check_rms_norm(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.adaln_norm import rms_norm, rms_norm_ref

    out_row = None
    for shape, view in RMS_SHAPES:
        d = shape[-1]
        if view:
            b, h, n, _ = shape
            proj = torch.from_numpy((2 * rng.standard_normal((b, n, 3 * h * d))).astype(np.float32))
            x = proj.to(dev, torch.bfloat16)[..., :h * d].view(b, n, h, d).transpose(1, 2)
        else:
            x = torch.from_numpy((2 * rng.standard_normal(shape)).astype(np.float32)).to(dev, torch.bfloat16)
        w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(dev, torch.bfloat16)
        out = rms_norm(x, w, 1e-8)
        ref = rms_norm_ref(x.float(), w.float(), 1e-8)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        nbytes = 2 * x.numel() * 2 + d * 2
        bound = max(nbytes / HBM_BYTES_PER_S, 4 * x.numel() / F32_FLOPS_PER_S) * 1e3
        ms = time_ms(lambda: rms_norm(x, w, 1e-8))
        wall = wall_ms(lambda: rms_norm(x, w, 1e-8))
        plain = time_ms(lambda: rms_norm_ref(x, w, 1e-8), reps=2)
        lib = time_ms(lambda: F.rms_norm(x, (d,), w, 1e-8))
        what = f"{list(shape)}{' (head view of q in a fused qkv projection)' if view else ''}"
        log(f"  rms_norm {what} bf16, bf16 weight, eps 1e-8: max_abs_err {err:.3e} (tol "
            f"{TOL['rms_norm']}), {ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms "
            f"(bytes), plain {plain:.4f} ms, F.rms_norm {lib:.4f} ms")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "bytes", "library_ms": lib})
    return out_row


def check_flash(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import flash_attention, flash_attention_fwd_ref

    b, h, d = 2, 16, 64
    out_row = None
    tile_end = -(-777 // 64) * 64
    for n in (1024, 4224):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, lengths)
        ref = flash_attention_fwd_ref(q.float(), k.float(), v.float(), lengths)
        torch.cuda.synchronize()
        # every row of a live q tile: the rows past the length inside the last
        # one are computed over the live keys (K9 reads them)
        err = max(float((out[i, :, :end].float() - ref[i, :, :end]).abs().max())
                  for i, end in enumerate((n, tile_end)))
        dead = float(out[1, :, tile_end:].abs().max())
        sq = sum(int(x) ** 2 for x in lengths.tolist())
        flops = 4 * h * d * sq
        nbytes = 4 * b * h * n * d * 2
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: flash_attention(q, k, v, lengths))
        wall = wall_ms(lambda: flash_attention(q, k, v, lengths))
        plain = time_ms(lambda: flash_attention_fwd_ref(q, k, v, lengths), reps=1, iters=5)
        kmask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=kmask))
        log(f"  flash_attention b=2 h=16 d=64 n={n} lengths [{n}, 777]: max_abs_err {err:.3e} "
            f"over live q tiles (tol {TOL['flash_attention']}), dead q tiles max {dead:.1e}, "
            f"{ms:.4f} ms (eager call "
            f"{wall:.4f} ms), bound {bound:.4f} ms (operations), plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms")
        if dead != 0.0:
            raise AssertionError("flash_attention: q tiles past the length are not zero")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


def check_flash_lse(rng, dev) -> dict:
    """K7's lse mode: the output as K7's, the lse on live q tiles within
    LSE_TOL of the plain version's, exactly -1e30 on the tiles past the length."""
    import torch
    from f5tts_tpu_torch.ops.attention import NEG_INF, flash_attention_fwd, flash_attention_fwd_ref

    b, h, d = 2, 16, 64
    out_row = None
    for n in (1024, 4224):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
        ref, ref_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(), lengths,
                                               return_lse=True)
        torch.cuda.synchronize()
        tile_end = -(-777 // 64) * 64
        err = max(float((out[i, :, :end].float() - ref[i, :, :end]).abs().max())
                  for i, end in enumerate((n, tile_end)))
        lse_err = max(float((lse[0] - ref_lse[0]).abs().max()),
                      float((lse[1, :, :tile_end] - ref_lse[1, :, :tile_end]).abs().max()))
        dead_ok = bool((lse[1, :, tile_end:] == NEG_INF).all()) and not out[1, :, tile_end:].any()
        sq = sum(int(x) ** 2 for x in lengths.tolist())
        flops = 4 * h * d * sq
        nbytes = 4 * b * h * n * d * 2 + b * h * n * 4
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, lengths, return_lse=True))
        plain = time_ms(lambda: flash_attention_fwd_ref(q, k, v, lengths, return_lse=True),
                        reps=1, iters=5)
        lib = sdpa_lse_ms(q, k, v, torch.arange(n, device=dev)[None, :] < lengths[:, None])
        log(f"  flash_attention_lse b=2 h=16 d=64 n={n} lengths [{n}, 777]: max_abs_err {err:.3e} "
            f"over live q tiles (tol {TOL['flash_attention_lse']}), lse max err {lse_err:.3e} (tol "
            f"{LSE_TOL}) on live "
            f"tiles, dead tiles -1e30 and 0: {dead_ok}, {ms:.4f} ms, bound {bound:.4f} ms "
            f"(operations), plain {plain:.4f} ms, sdpa efficient with lse {lib:.4f} ms")
        if not (dead_ok and lse_err <= LSE_TOL):
            raise AssertionError(f"flash_attention_lse at n={n}: lse err {lse_err}, dead tiles "
                                 f"{dead_ok}")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


# K5 / K8's phase-2 shapes: (audio rows, text rows, a dead run of row 1's audio)
JOINT_CASES = ((1024, 128, None), (3072, 128, None), (4096, 256, None))
# and K5's edge cases: a joint n that is no multiple of 64 (1024 + 100), and
# four consecutive all-dead key tiles in the middle of row 1
JOINT_EDGE_CASES = ((1024, 100, None), (1024, 128, (192, 448)))


def joint_case(rng, dev, na: int, nt: int, gap=None, h: int = 16):
    """K5's / K8's phase-2 inputs at joint n = na + nt: qkv, the joint rope
    tables and the key mask (row 0: audio live to 777 of 1024, 3/4 of longer
    buckets, text 100 live; row 1: all audio live but the keys of `gap`, text
    120: dead keys mid-sequence); `h` heads of 64."""
    import torch
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, d = 2, 64
    n = na + nt
    kmask = torch.zeros(b, n, dtype=torch.bool, device=dev)
    kmask[0, :777 if na == 1024 else 3 * na // 4] = True
    kmask[0, na:na + 100] = True
    kmask[1, :na] = True
    kmask[1, na:na + 120] = True
    if gap is not None:
        kmask[1, gap[0]:gap[1]] = False
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)).to(dev, torch.bfloat16)
    ang = rope_freqs_interleaved(d, na).to(dev)
    ca, sa = rope_flat_tables(ang, na, h, dtype=torch.bfloat16)
    ct, st = rope_flat_tables(ang, nt, h, dtype=torch.bfloat16)
    return qkv, torch.cat([ca, ct]).contiguous(), torch.cat([sa, st]).contiguous(), kmask


def gap_text(gap) -> str:
    return "" if gap is None else f", row 1's keys {gap[0]}..{gap[1] - 1} dead"


def check_attention_bias_lse(rng, dev) -> dict:
    """K5's lse mode at K5's joint shapes and masks: its output equal to K5's,
    its lse (every row) against the plain version's on the same inputs."""
    import torch
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention_bias,
                                               fused_qkv_rope_attention_bias_fwd,
                                               fused_qkv_rope_attention_bias_ref)

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for na, nt, gap in JOINT_CASES + JOINT_EDGE_CASES:  # joint 1152, 3200, 4352, 1124, 1152
        n = na + nt
        qkv, cos, sin, kmask = joint_case(rng, dev, na, nt, gap)
        out, lse = fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, h, return_lse=True)
        ref, ref_lse = fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, h, return_lse=True)
        if not torch.equal(out, fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, h)):
            raise AssertionError("fused_qkv_rope_attention_bias_lse: output differs from K5's")
        lib = sdpa_lse_ms(*flat_to_heads(qkv, cos, sin, h), kmask)
        live_keys = [int(v) for v in kmask.sum(dim=1).tolist()]
        nbytes = (b * n * 3 * hd + 2 * n * hd + b * n * hd) * 2 + b * n + b * h * n * 4
        out_row = merge_rows(out_row, flat_lse_row(
            "fused_qkv_rope_attention_bias_lse", n, kmask, out, lse, ref, ref_lse, n,
            lambda: fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, h, return_lse=True),
            lambda: fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, h, return_lse=True),
            lib, 4 * h * d * n * sum(live_keys), nbytes,
            f"joint n={n} ({na} audio + {nt} text{gap_text(gap)}), live keys {live_keys}"))
    return out_row


def check_attention_bias_bwd(rng, dev) -> dict:
    """K8 from K5's saved output and lse (its lse mode) on K5's joint shapes
    and masks, dO on every row."""
    import torch
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention_bias_bwd,
                                               fused_qkv_rope_attention_bias_bwd_from_lse_ref,
                                               fused_qkv_rope_attention_bias_bwd_ref,
                                               fused_qkv_rope_attention_bias_fwd)

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for na, nt, gap in JOINT_CASES + JOINT_EDGE_CASES[:1]:  # joint 1152, 3200, 4352, 1124
        n = na + nt
        qkv, cos, sin, kmask = joint_case(rng, dev, na, nt, gap)
        dout = bwd_inputs(rng, dev, b, n, hd)[1]
        out, lse = fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, h, return_lse=True)
        args = (qkv, cos, sin, kmask, out, lse, dout, h)
        got = fused_qkv_rope_attention_bias_bwd(*args)
        wants = (("from-lse", fused_qkv_rope_attention_bias_bwd_from_lse_ref(*args)),
                 ("recompute", fused_qkv_rope_attention_bias_bwd_ref(qkv, cos, sin, kmask, dout, h)))
        live_keys = [int(v) for v in kmask.sum(dim=1).tolist()]
        nbytes = (2 * b * n * 3 * hd + 2 * b * n * hd + 2 * n * hd) * 2 + b * n + b * h * n * 4
        lib, lib_fwd = sdpa_bwd_ms(*flat_to_heads(qkv, cos, sin, h), dout, kmask)
        every_row = torch.ones_like(kmask)
        out_row = merge_rows(out_row, check_flat_bwd(
            "fused_qkv_rope_attention_bias_bwd", got, wants, every_row,
            float(got[:, :, hd:][~kmask].abs().max()),
            lambda: fused_qkv_rope_attention_bias_bwd(*args),
            lambda: fused_qkv_rope_attention_bias_bwd_from_lse_ref(*args), lib, lib_fwd,
            10 * h * d * n * sum(live_keys), nbytes,
            f"b=2 h=16 d=64 joint n={n} ({na} audio + {nt} text), live keys {live_keys}"))
    return out_row


def check_flash_bwd(rng, dev) -> dict:
    """K9 from K7's saved output and lse at n = 1024 and 4224, dO zero on rows
    >= length; and at n = 1024 with dO nonzero on every row, so rows 777..831
    of batch row 1 (past the length, inside the last live q tile) carry a
    gradient. All rows compared; dq of the dead q tiles and dk, dv of the dead
    keys exactly 0."""
    import torch
    from f5tts_tpu_torch.ops.attention import (flash_attention_bwd, flash_attention_bwd_ref,
                                               flash_attention_fwd)

    b, h, d = 2, 16, 64
    out_row = None
    for n, row_masked in ((1024, True), (4224, True), (1024, False)):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                         .to(dev, torch.bfloat16) for _ in range(4))
        live = torch.arange(n, device=dev)[None, :] < lengths[:, None]
        if row_masked:
            dout = dout * live[:, None, :, None]
        o, lse = flash_attention_fwd(q, k, v, lengths, return_lse=True)
        got = flash_attention_bwd(q, k, v, lengths, o, lse, dout)
        want = flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout)
        torch.cuda.synchronize()
        stats = [bwd_errors(g, w) for g, w in zip(got, want)]
        rel, err = max(x[0] for x in stats), max(x[1] for x in stats)
        top = min(x[2] for x in stats)
        # dq: rows of the q tiles past the length; dk, dv: keys past it
        tile_end = -(-777 // 64) * 64
        dead = max(float(got[0][1, :, 777 if row_masked else tile_end:].abs().max()),
                   *(float(g[1, :, 777:].abs().max()) for g in got[1:]))
        tile_rows = [-(-ln // 64) * 64 for ln in lengths.tolist()]  # rows of live q tiles
        pairs = sum(min(r, n) * ln for r, ln in zip(tile_rows, lengths.tolist()))
        flops = 10 * h * d * pairs
        nbytes = 8 * b * h * n * d * 2 + b * h * n * 4
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, lengths, o, lse, dout))
        plain = time_ms(lambda: flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout),
                        reps=1, iters=3)
        lib, lib_fwd = sdpa_bwd_ms(q, k, v, dout, live)
        log(f"  flash_attention_bwd b=2 h=16 d=64 n={n} lengths [{n}, 777], dO "
            f"{'zero past the length' if row_masked else 'on every row'}: dq/dk/dv rel-L2 "
            f"max {rel:.3e} (tol {BWD_REL_L2_TOL}), max_abs_err {err:.3e} (tol "
            f"{BWD_MAX_ABS_REL_TOL} x smallest largest entry {top:.3e}), dead rows/keys max "
            f"{dead:.1e}, {ms:.4f} ms, bound {bound:.4f} ms (operations), plain {plain:.4f} ms, "
            f"sdpa bwd {lib:.4f} ms (fwd {lib_fwd:.4f} ms)")
        if dead != 0.0:
            raise AssertionError("flash_attention_bwd: dead tiles or keys are not 0")
        for name, (r, e, t) in zip(("dq", "dk", "dv"), stats):
            check_bwd_tol(f"flash_attention_bwd {name} at n={n} (dO row-masked: {row_masked})",
                          r, e, t)
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


def check_grouped_conv(rng, dev) -> dict:
    """K10 at the dim-768 presets' conv (16 groups of 48, k = 31) and at 16
    groups of 24 with an even k (the zero-padded lanes, asymmetric padding)."""
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.grouped_conv import grouped_conv1d, grouped_conv1d_ref

    out_row = None
    for b, n, c, k in ((2, 1024, 768, 31), (2, 4096, 768, 31), (2, 1024, 384, 4)):
        groups = 16
        width = c // groups
        x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32)).to(dev, torch.bfloat16)
        bound_w = 1.0 / math.sqrt(width * k)
        w = torch.from_numpy(rng.uniform(-bound_w, bound_w, (k, width, c)).astype(np.float32))
        w = w.to(dev, torch.bfloat16)
        bias = torch.from_numpy(rng.uniform(-bound_w, bound_w, (c,)).astype(np.float32))
        bias = bias.to(dev, torch.bfloat16)
        out = grouped_conv1d(x, w, bias, groups)
        ref = grouped_conv1d_ref(x.float(), w.float(), bias.float(), groups)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        flops = 2 * b * n * k * width * c
        nbytes = (2 * b * n * c + k * width * c + c) * 2
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: grouped_conv1d(x, w, bias, groups))
        wall = wall_ms(lambda: grouped_conv1d(x, w, bias, groups))
        plain = time_ms(lambda: grouped_conv1d_ref(x, w, bias, groups), reps=2)
        # yardstick: cuDNN's grouped conv on the [b, c, n] layout it takes
        xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        lib = time_ms(lambda: F.conv1d(xt, wt, bias, padding="same", groups=groups))
        log(f"  grouped_conv1d [{b},{n},{c}] {groups} groups of {width}, k {k}: max_abs_err "
            f"{err:.3e} (tol {TOL['grouped_conv1d']}), {ms:.4f} ms (eager call {wall:.4f} ms), "
            f"bound {bound:.4f} ms (operations), plain {plain:.4f} ms, F.conv1d {lib:.4f} ms")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


def check_masked_flash(rng, dev) -> dict:
    """K11 at the MMDiT phases' joint lengths with K5's masks, every row."""
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import masked_flash_attention, mha_reference_masked

    b, h, d = 2, 16, 64
    out_row = None
    for na, nt in ((1024, 128), (4096, 256)):  # joint 1152, 4352
        n = na + nt
        kmask = torch.zeros(b, n, dtype=torch.bool, device=dev)
        kmask[0, :777 if na == 1024 else 3 * na // 4] = True
        kmask[0, na:na + 100] = True
        kmask[1, :na] = True
        kmask[1, na:na + 120] = True
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        out = masked_flash_attention(q, k, v, kmask)
        ref = mha_reference_masked(q.float(), k.float(), v.float(), kmask)
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        live_keys = [int(x) for x in kmask.sum(dim=1).tolist()]
        flops = 4 * h * d * n * sum(live_keys)
        nbytes = 4 * b * h * n * d * 2 + b * n
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: masked_flash_attention(q, k, v, kmask))
        wall = wall_ms(lambda: masked_flash_attention(q, k, v, kmask))
        plain = time_ms(lambda: mha_reference_masked(q, k, v, kmask), reps=1, iters=5)
        mask4 = kmask[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4))
        log(f"  masked_flash_attention b=2 h=16 d=64 joint n={n} ({na} audio + {nt} text), live "
            f"keys {live_keys}: max_abs_err over every row {err:.3e} (tol "
            f"{TOL['masked_flash_attention']}), {ms:.4f} ms (eager call {wall:.4f} ms), bound "
            f"{bound:.4f} ms (operations), plain {plain:.4f} ms, sdpa {lib:.4f} ms")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "operations",
                                        "library_ms": lib})
    return out_row


def phase_kernels(dev) -> dict:
    import torch

    rng = np.random.default_rng(0)
    rows = {"adaln_norm": check_adaln(rng, dev),
            "conv_pos_embedding": check_conv_pos(rng, dev),
            "fused_qkv_rope_attention": check_attention(rng, dev),
            "fused_qkv_rope_attention_lse": check_attention_lse(rng, dev),
            "fused_qkv_rope_attention_bwd": check_attention_bwd(rng, dev),
            "fused_qkv_rope_attention_bias": check_attention_bias(rng, dev),
            "fused_qkv_rope_attention_bias_lse": check_attention_bias_lse(rng, dev),
            "rms_norm": check_rms_norm(rng, dev),
            "flash_attention": check_flash(rng, dev),
            "flash_attention_lse": check_flash_lse(rng, dev),
            "fused_qkv_rope_attention_bias_bwd": check_attention_bias_bwd(rng, dev),
            "flash_attention_bwd": check_flash_bwd(rng, dev),
            "grouped_conv1d": check_grouped_conv(rng, dev),
            "masked_flash_attention": check_masked_flash(rng, dev)}
    torch.cuda.synchronize()
    for name, tol in TOL.items():
        if not rows[name]["max_abs_err"] <= tol:
            raise AssertionError(f"{name}: max_abs_err {rows[name]['max_abs_err']} > {tol}")
    return rows


# ---------------------------------------------------------------------------
# phases 3, 4, 7, 8 and 9
# ---------------------------------------------------------------------------

def make_pipeline(dev, backbone: str, arch, params, vocos_params, **kw):
    """An InferencePipeline on the card with Vocos; `kw` overrides the char
    tokenizer (with `scripts.common.VOCAB`), the vocoder and any other
    field."""
    import torch
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.scripts.common import VOCAB
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    kw = {"vocab_char_map": VOCAB, "tokenizer": "char", **kw}
    vocoder = kw.pop("vocoder", None) or Vocos(vocos_params, VocosConfig(), device=dev)
    return InferencePipeline(params, BACKBONES[backbone].statics_cls(arch), vocoder,
                             sampling=SamplingConfig(nfe_steps=NFE), dtype=torch.bfloat16,
                             device=dev, backbone=backbone, **kw)


# the int8 path's launches, once each per quantized projection
QUANT_KERNELS = ("int8_mm", "dequant_bias")


def step_launches(backbone: str, arch, flat: bool = True, int8: bool = False) -> dict:
    """The kernel launches of one ODE step at a dim-1024 preset; `flat`
    False for the UNetT past the flat gate (the 4224-row cap: K7 in K3's
    place). A step: the DiT's K3 a block, K1 two a block and the final
    norm; the UNetT's K6 two a block and the final norm; the MMDiT's K1 four
    a block, three in the context_pre_only last block and the final norm,
    with qk-norm K11 in K5's place and K6 on q and k of both streams (four a
    block); K2 once for cond and once for uncond. With `int8`, the int8
    product and K13 once each per quantized projection: four a DiT or UNetT
    block (to_qkv, to_out, ff.in, ff.out), eight an MMDiT block (both
    streams' twins) and five in its last block (no to_out_c, no ff_c); every
    norm of a block hands its projections codes (K1Q / K6Q in K1's / K6's
    place, the final norm stays K1 / K6), ff.out's input comes from K12's
    GELU mode and to_out's (and to_out_c's) from the plain K12."""
    if backbone == "DiT":
        step = {"fused_qkv_rope_attention": arch.depth, "adaln_norm": 2 * arch.depth + 1}
    elif backbone == "UNetT":
        attn = "fused_qkv_rope_attention" if flat else "flash_attention"
        step = {attn: arch.depth, "rms_norm": 2 * arch.depth + 1}
    else:
        step = {"adaln_norm": 4 * (arch.depth - 1) + 3 + 1}
        if arch.qk_norm:
            step.update(masked_flash_attention=arch.depth, rms_norm=4 * arch.depth)
        else:
            step["fused_qkv_rope_attention_bias"] = arch.depth
    step["conv_pos_embedding"] = 2
    if int8:
        mmdit = backbone == "MMDiT"
        step.update({name: 8 * (arch.depth - 1) + 5 if mmdit else 4 * arch.depth
                     for name in QUANT_KERNELS})
        norm = "rms_norm" if backbone == "UNetT" else "adaln_norm"
        block_norms = 4 * (arch.depth - 1) + 3 if mmdit else 2 * arch.depth
        step[norm] -= block_norms
        step[norm + "_quant"] = block_norms
        # ff.out's input (the GELU mode) and to_out's (the plain K12), each
        # stream's
        step["gelu_quantize_rows"] = step["quantize_rows"] = (
            2 * arch.depth - 1 if mmdit else arch.depth)
    return step


def generate_launches(backbone: str, arch, flat: bool = True, int8: bool = False) -> dict:
    """The kernel launches of one NFE-step generate (`step_launches`)."""
    return {k: v * NFE for k, v in step_launches(backbone, arch, flat, int8).items()}


def ran_launches(pipe, host: dict, replays_before: dict) -> dict:
    """The launches the card ran since `replays_before` ({key: replays}):
    the host counter's (eager calls, a capture's warm-up) and each graph
    replay's, the counts its capture recorded."""
    ran = dict(host)
    for key, entry in pipe.graphs.items():
        for name, c in entry.counts.items():
            ran[name] = ran.get(name, 0) + c * (entry.replays - replays_before.get(key, 0))
    return ran


def run_requests(pipe, cases, gpu: str) -> dict:
    """Each case (text, total frames or None to estimate them, the launches
    one generate must make) through pipe.infer, every count set to 0 just
    before the request and read just after. The pipeline replays one CUDA
    graph a key: a request that needs a new one makes one eager warm-up
    generate (its launches on the host counter) and records one generate's
    launches on the new graph; a request in a captured key adds 0 to the
    host counter. Returns the summed launches the card ran."""
    import torch
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REF_TEXT, synthetic_ref_wav

    ref = synthetic_ref_wav()
    total: dict[str, int] = {}
    for i, (text, frames, expect) in enumerate(cases):
        fix = None if frames is None else (frames + 0.5) * pipe.hop / pipe.sr
        before = {key: entry.replays for key, entry in pipe.graphs.items()}
        torch.cuda.synchronize()
        _build.reset_launches()  # every count to 0 just before the request
        t0 = time.perf_counter()
        wave, sr, mel = pipe.infer(ref, 24000, REF_TEXT, text, seed=i, nfe_step=NFE,
                                   cfg_strength=2.0, sway_sampling_coef=-1.0, fix_duration=fix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host = _build.launches()
        new = [(key, entry) for key, entry in pipe.graphs.items() if key not in before]
        secs = len(wave) / sr
        rms = float(np.sqrt(np.mean(np.square(wave)))) if wave.size else 0.0
        captured = "; ".join(f"captured {key} in {entry.capture_s:.2f} s, pool "
                             f"{entry.pool_bytes / 2**20:.1f} MiB, launches {entry.counts}"
                             for key, entry in new) or "graph replayed"
        log(f"  request {i}: {secs:.3f} s of audio ({mel.shape[1]} frames), wall {wall:.4f} s, "
            f"RTF {wall / max(secs, 1e-9):.5f}, rms {rms:.4f}; host launches {host}; "
            f"{captured} [{gpu}]")
        if not (wave.size and np.isfinite(wave).all() and np.isfinite(mel).all() and rms > 1e-4):
            raise AssertionError(f"request {i}: wav is empty, non-finite or silent")
        for key, entry in new:
            if entry.counts != expect:
                raise AssertionError(f"request {i}: the capture of {key} recorded launches "
                                     f"{entry.counts}, expected {expect} for one {NFE}-NFE "
                                     "generate")
        if host != ({k: v * len(new) for k, v in expect.items()} if new else {}):
            raise AssertionError(f"request {i}: host launches {host}, expected one warm-up "
                                 f"generate a new capture ({len(new)}) and 0 for a replay")
        for name, c in ran_launches(pipe, host, before).items():
            total[name] = total.get(name, 0) + c
    return total


def phase_main_path(dev, arch, params, vocos_params, gpu: str) -> dict:
    from f5tts_tpu_torch.scripts.common import REQUESTS

    expect = generate_launches("DiT", arch)
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params)
    # the first request again: a replay of its captured graph, 0 host launches
    return run_requests(pipe, [(text, None, expect) for text in REQUESTS + REQUESTS[:1]], gpu)


def phase_unett(dev, arch, params, vocos_params, gpu: str) -> dict:
    """E2TTS_Base: 1013 frames + the time token fill the 1024-row bucket (K3);
    the 4096-frame cap is 4097 rows padded to 4224, past the flat gate (K7)."""
    from f5tts_tpu_torch.scripts.common import REQUESTS

    pipe = make_pipeline(dev, "UNetT", arch, params, vocos_params)
    return run_requests(pipe, [(REQUESTS[0], 1013, generate_launches("UNetT", arch)),
                               (REQUESTS[1], 4096, generate_launches("UNetT", arch, False))],
                        gpu)


def phase_mmdit(dev, arch, params, vocos_params, gpu: str) -> dict:
    """MMDiT_Base: the 1024 bucket with a short text (joint 1024 + 128 rows)
    and the cap with a long one (joint 4096 + 256)."""
    from f5tts_tpu_torch.scripts.common import REQUESTS

    expect = generate_launches("MMDiT", arch)
    pipe = make_pipeline(dev, "MMDiT", arch, params, vocos_params)
    return run_requests(pipe, [(REQUESTS[2], 1014, expect), (REQUESTS[1], 4096, expect)], gpu)


def phase_small(dev, arch, params, vocos_params, gpu: str, backbone: str) -> dict:
    """A dim-768 preset: the conv position module is two K10 launches an
    input embedding (cond and uncond: 4 a step), K2 none. The DiT: K3 a
    block, K1 two a block and the final norm; the UNetT: K3 (K7 at the cap's
    4224 rows) a block, K6 two a block and the final norm."""
    from f5tts_tpu_torch.scripts.common import REQUESTS

    per_step = {"grouped_conv1d": 4}
    if backbone == "DiT":
        short = dict(per_step, fused_qkv_rope_attention=arch.depth, adaln_norm=2 * arch.depth + 1)
        cases = ((REQUESTS[0], 1014, short), (REQUESTS[1], 4086, short))
    else:
        per_step["rms_norm"] = 2 * arch.depth + 1
        cases = ((REQUESTS[0], 1013, dict(per_step, fused_qkv_rope_attention=arch.depth)),
                 (REQUESTS[1], 4096, dict(per_step, flash_attention=arch.depth)))
    pipe = make_pipeline(dev, backbone, arch, params, vocos_params)
    return run_requests(pipe, [(text, frames, {k: v * NFE for k, v in expect.items()})
                               for text, frames, expect in cases], gpu)


def phase_mmdit_qk_norm(dev, arch, params, vocos_params, gpu: str) -> dict:
    """MMDiT_Base with qk-norm: the head layout in every block, K11 for the
    joint attention (K5 none), K6 on q and k of both streams (four a block),
    K1 and K2 as in phase 8."""
    from f5tts_tpu_torch.scripts.common import REQUESTS

    expect = generate_launches("MMDiT", arch)
    pipe = make_pipeline(dev, "MMDiT", arch, params, vocos_params)
    return run_requests(pipe, [(REQUESTS[2], 1014, expect), (REQUESTS[1], 4096, expect)], gpu)


def cut_to_depth_2(backbone: str, params: dict) -> dict:
    if backbone == "UNetT":
        return dict(params, first_half=params["first_half"][:1],
                    second_half=params["second_half"][:1])
    if backbone == "MMDiT":  # one block and the context_pre_only last block
        return dict(params, blocks=params["blocks"][:1])
    return dict(params, blocks=params["blocks"][:2])


def phase_card_vs_cpu(dev, arch, params, vocos_params, backbone: str = "DiT",
                      expect=None, quantization: str = "none", option=None) -> tuple:
    """`expect`: the launches of one backbone pass of the card's depth-2
    sampler. With `quantization="int8"` each side quantizes its cast params,
    as the pipeline does (the CPU's int8 path in f32: the plain versions).
    `option` one of SAMPLER_OPTIONS: "midpoint" (two passes a step),
    "edit_mask" (two regenerated spans inside the prompt), "no_ref_audio",
    "restart" (`duplicate_test_start` from the reference mel at t_inter
    0.1: 3 of 4 steps). Returns (the mel rel-L2, the card's mel over the
    generated frames)."""
    import torch
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.ops.mel import MelFrontend
    from f5tts_tpu_torch.ops.quant import quantize_dit_params
    from f5tts_tpu_torch.scripts.common import synthetic_ref_wav
    from f5tts_tpu_torch.utils import make_time_grid
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    bdef = cfm.BACKBONES[backbone]
    arch2 = dataclasses.replace(arch, depth=2)
    p2 = fuse_backbone_qkv(cut_to_depth_2(backbone, params))
    n, prompt, total, nfe = 1024, 254, 1000, 4
    rng = np.random.default_rng(3)
    ref_mel = MelFrontend(device="cpu").frames_to_mel_bnd(torch.from_numpy(synthetic_ref_wav())[None])
    cond = torch.zeros(1, n, 100)
    cond[:, :prompt] = ref_mel[:, :prompt]
    text = torch.from_numpy(rng.integers(1, 2545, (1, 128)).astype(np.int32))
    lens = torch.tensor([prompt], dtype=torch.int32)
    dur = torch.tensor([total], dtype=torch.int32)
    y0 = torch.from_numpy(rng.standard_normal((1, n, 100)).astype(np.float32))
    y0[:, total:] = 0
    grid = make_time_grid(nfe, sway_sampling_coef=-1.0)
    kw, keep = {}, torch.arange(n)[None, :] < prompt
    if option == "midpoint":
        kw["method"] = "midpoint"
    elif option == "edit_mask":
        edit = torch.ones(1, n, dtype=torch.bool)
        edit[:, 40:90] = edit[:, 150:200] = False
        kw["edit_mask"], keep = edit, keep & edit
    elif option == "no_ref_audio":
        kw["no_ref_audio"] = True
    elif option == "restart":
        y0, grid, _ = cfm.duplicate_test_start(ref_mel, n, prompt, dur, nfe, 0.1, -1.0, noise=y0)
    passes = (grid.shape[0] - 1) * (2 if option == "midpoint" else 1)

    mels, waves = {}, {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        pw = tree_cast(p2, dtype, where)
        if quantization == "int8":
            pw = quantize_dit_params(pw)
        statics = bdef.statics_cls(arch2, where)
        t0 = time.perf_counter()
        _build.reset_launches()
        mel = cfm.cfm_sample(pw, statics, cond.to(where), text.to(where), lens.to(where),
                             dur.to(where), grid.to(where), y0=y0.to(where), cfg_strength=2.0,
                             dtype=dtype, backbone=bdef,
                             **{k: v.to(where) if torch.is_tensor(v) else v
                                for k, v in kw.items()})
        if where.type == "cuda" and expect is not None:
            torch.cuda.synchronize()
            if _build.launches() != {k: v * passes for k, v in expect.items()}:
                raise AssertionError(f"{backbone} depth-2 sampler launches {_build.launches()}, "
                                     f"expected {expect} a pass, {passes} passes")
        wav = Vocos(vocos_params, VocosConfig(), device=where)(mel.transpose(1, 2))
        mels[where.type], waves[where.type] = mel.float().cpu(), wav.float().cpu()
        log(f"  {backbone} {where.type} {str(dtype)[6:]}{' int8' if quantization == 'int8' else ''}"
            f"{' ' + option if option else ''}: depth 2, {passes} passes, n {n}: "
            f"{time.perf_counter() - t0:.2f} s")
    if option == "edit_mask":  # the regenerated frames: the holes and prompt..total
        regen = ~keep[0] & (torch.arange(n) < total)
        a, b = mels["cuda"][:, regen], mels["cpu"][:, regen]
        if not (torch.equal(mels["cuda"][:, keep[0]], cond[:, keep[0]])
                and torch.equal(mels["cpu"][:, keep[0]], cond[:, keep[0]])):
            raise AssertionError("edit_mask: a kept frame is not the cond frame")
    else:
        a, b = mels["cuda"][:, prompt:total], mels["cpu"][:, prompt:total]
    rel = float((a - b).norm() / b.norm())
    wa, wb = waves["cuda"], waves["cpu"]
    wrel = float((wa - wb).norm() / wb.norm())
    what = "int8 " if quantization == "int8" else ""
    log(f"  {backbone}{' ' + option if option else ''} card {what}bf16 vs cpu {what}f32: mel "
        f"rel-L2 {rel:.4e} (tol 3e-2), wav rel-L2 {wrel:.4e}")
    if not (np.isfinite(rel) and rel <= 3e-2):
        raise AssertionError(f"{backbone} {option or ''} card vs cpu mel rel-L2 {rel} > 3e-2")
    return rel, a


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

# (preset, backbone, arch overrides, total frames: the 1024 bucket and the cap)
GRAPH_CASES = (("F5TTS_v1_Base", "DiT", {}, (1014, 4086)),
               ("E2TTS_Base", "UNetT", {}, (1013, 4096)),
               ("MMDiT_Base", "MMDiT", {}, (1014, 4086)),
               ("MMDiT_Base", "MMDiT", {"qk_norm": "rms_norm"}, (1014, 4086)))
WALL_REPS = 3
GRAPH_MEL_REL_TOL = 1e-3   # graphed against eager, where not bit-equal
GRAPH_WAV_ABS_TOL = 1e-3


def compare_graph_eager(pipe, expect: dict, frames: int, gpu: str) -> dict:
    """One bucket of `pipe`: the graphed generate (`fused_generate`, its
    capture at the first request) against the eager cfm_sample + Vocos on
    the same prepared request, seeds 0..WALL_REPS-1 in turns (eager,
    graphed), each wall from the request's preparation (ref mel, ids, noise)
    to a device sync; the capture's counts and the host counter of the
    replays checked."""
    import torch
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REF_TEXT, REQUESTS, synthetic_ref_wav

    ref = synthetic_ref_wav()
    fix = (frames + 0.5) * pipe.hop / pipe.sr

    def prepare(seed: int) -> dict:
        return pipe.prepare_chunk(ref, REF_TEXT + " ", REQUESTS[1], seed=seed, nfe_step=NFE,
                                  cfg_strength=2.0, sway_sampling_coef=-1.0, fix_duration=fix)

    def eager(seed: int):
        req = prepare(seed)
        mel = cfm.cfm_sample(pipe.params, pipe.statics, req["cond"], req["text"], req["lens"],
                             req["duration"], req["t_grid"].to(pipe.device), y0=req["y0"],
                             cfg_strength=req["cfg_strength"], dtype=pipe.dtype,
                             backbone=pipe.bdef)
        return req, mel, pipe.vocoder(mel.transpose(1, 2))

    def graphed(seed: int):
        req = prepare(seed)
        return (req, *pipe.fused_generate(**{k: v for k, v in req.items()
                                              if k not in ("ref_frames", "total")}))

    def timed(fn, seed: int):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    timed(eager, 100)  # the eager path's warm-up at this shape
    captured = set(pipe.graphs)
    _build.reset_launches()
    first_wall, (req, _, _) = timed(graphed, 101)  # warm-up + capture + one replay
    key = (*req["cond"].shape[:2], req["text"].shape[1], NFE)
    entry = pipe.graphs[key]
    if key in captured:
        raise AssertionError(f"{key}: captured before this phase")
    if entry.counts != expect or _build.launches() != expect:
        raise AssertionError(f"{key}: capture recorded {entry.counts}, warm-up launched "
                             f"{_build.launches()}, expected {expect} each")
    walls = {"eager": [], "graphed": []}
    worst = {"mel_rel_l2": 0.0, "wav_max_abs": 0.0}
    equal = True
    for seed in range(WALL_REPS):
        t_e, (req, mel_e, wav_e) = timed(eager, seed)
        _build.reset_launches()
        t_g, (_, mel_g, wav_g) = timed(graphed, seed)
        if _build.launches():
            raise AssertionError(f"{key}: a replay added {_build.launches()} to the host counter")
        walls["eager"].append(t_e)
        walls["graphed"].append(t_g)
        if not (torch.equal(mel_e, mel_g) and torch.equal(wav_e, wav_g)):
            equal = False
            worst["mel_rel_l2"] = max(worst["mel_rel_l2"],
                                      float((mel_g - mel_e).norm() / mel_e.norm()))
            worst["wav_max_abs"] = max(worst["wav_max_abs"], float((wav_g - wav_e).abs().max()))
        if not (torch.isfinite(mel_g).all() and torch.isfinite(wav_g).all()):
            raise AssertionError(f"{key}: the graphed generate is not finite")
    audio_s = (req["total"] - req["ref_frames"]) * pipe.hop / pipe.sr
    eager_s, graph_s = statistics.median(walls["eager"]), statistics.median(walls["graphed"])
    row = {"key": list(key), "frames": req["total"], "audio_s": audio_s,
           "eager_wall_s": eager_s, "graphed_wall_s": graph_s, "eager_rtf": eager_s / audio_s,
           "graphed_rtf": graph_s / audio_s, "walls_s": walls, "first_request_s": first_wall,
           "capture_s": entry.capture_s, "graph_pool_mib": entry.pool_bytes / 2**20,
           "bit_equal": equal, **worst}
    log(f"  {pipe.backbone} {key}: {'bit-equal' if equal else 'differs: ' + str(worst)}; "
        f"wall eager {eager_s:.4f} s / graphed {graph_s:.4f} s (medians of {WALL_REPS}), RTF "
        f"{row['eager_rtf']:.5f} / {row['graphed_rtf']:.5f}, capture {entry.capture_s:.2f} s "
        f"(first request {first_wall:.2f} s), graph pool {row['graph_pool_mib']:.1f} MiB [{gpu}]")
    if not equal and not (worst["mel_rel_l2"] <= GRAPH_MEL_REL_TOL
                          and worst["wav_max_abs"] <= GRAPH_WAV_ABS_TOL):
        raise AssertionError(f"{key}: graphed against eager {worst}, tolerances mel rel-L2 "
                             f"{GRAPH_MEL_REL_TOL}, wav max-abs {GRAPH_WAV_ABS_TOL}")
    return row


def phase_graphs(dev, gpu: str) -> list[dict]:
    import torch
    from f5tts_tpu_torch.scripts.common import base_models

    rows = []
    for model, backbone, over, frames in GRAPH_CASES:
        arch, params, vocos_params = base_models(model=model, **over)
        pipe = make_pipeline(dev, backbone, arch, params, vocos_params)
        del params
        for total in frames:
            flat = backbone != "UNetT" or total < 2048
            row = compare_graph_eager(pipe, generate_launches(backbone, arch, flat), total, gpu)
            rows.append({"model": model, "qk_norm": arch.qk_norm, **row})
        del pipe
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 17
# ---------------------------------------------------------------------------

# K12's inputs on the int8 paths, [b, n, k]: to_qkv / to_out / ff.in at the
# 1024 bucket and the cap (k 1024), ff.out at ff_mult 2 (k 2048) and the
# UNetT's (ff_mult 4, k 4096); 37 rows (odd). Each has an all-zero row.
K12_SHAPES = ((2, 1024, 1024), (2, 4096, 1024), (2, 1024, 2048), (2, 4096, 2048),
              (2, 1024, 4096), (2, 4096, 4096), (1, 37, 1024))
# K13's outputs, [m, n]: the DiT projections' (to_qkv 3072, to_out and
# ff.out 1024, ff.in 2048) at the 1024 bucket (m 2048) and the cap (8192),
# the UNetT's ff.in (4096), the MMDiT text stream (2 x 256 rows), odd m
K13_SHAPES = ((2048, 3072), (2048, 1024), (2048, 2048), (8192, 3072), (8192, 1024),
              (8192, 2048), (2048, 4096), (512, 3072), (37, 1024))
# the int8 products of a DiT-1024 block, (m, k, n)
INT8_MM_SHAPES = ((2048, 1024, 3072), (2048, 1024, 1024), (2048, 1024, 2048), (2048, 2048, 1024))
PINYIN_TEXT = "我们今天一起去银行，然后在公园里散步。The weather was fine, 不是吗?"


def check_quant_rows_case(x, what: str) -> dict:
    """K12 on x against its plain version: bit-equal codes and scales, every
    all-zero row at scale 1 and codes 0; timed as phase 2 times a kernel."""
    import torch
    from f5tts_tpu_torch.ops.quant import quantize_rows, quantize_rows_ref

    codes, scale = quantize_rows(x)
    ref_c, ref_s = quantize_rows_ref(x)
    torch.cuda.synchronize()
    err = max(float((codes.int() - ref_c.int()).abs().max()), float((scale - ref_s).abs().max()))
    zero = (x == 0).all(dim=-1)
    if not (torch.equal(codes, ref_c) and torch.equal(scale, ref_s)):
        raise AssertionError(f"quantize_rows {what}: not bit-equal to its plain version ({err})")
    if not (bool(zero.any()) and bool((codes[zero] == 0).all()) and bool((scale[zero] == 1).all())):
        raise AssertionError(f"quantize_rows {what}: an all-zero row is not scale 1, codes 0")
    elems, rows = x.numel(), x.numel() // x.shape[-1]
    bound = max((3 * elems + 4 * rows) / HBM_BYTES_PER_S, 4 * elems / F32_FLOPS_PER_S) * 1e3
    ms = time_ms(lambda: quantize_rows(x))
    wall = wall_ms(lambda: quantize_rows(x))
    plain = time_ms(lambda: quantize_rows_ref(x), reps=2)
    log(f"  quantize_rows {what}: bit-equal, {ms:.4f} ms (eager call {wall:.4f} ms), bound "
        f"{bound:.4f} ms (bytes), plain {plain:.4f} ms, {ms / bound:.2f}x the bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def check_quant_rows(rng, dev) -> dict:
    """K12 at `K12_SHAPES` and on the MMDiT's text rows, read in place from
    a joint [2, 1024 + 256, 1024] attention output (strided rows)."""
    import torch

    out_row = None
    for b, n, k in K12_SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, n, k)).astype(np.float32)).to(dev, torch.bfloat16)
        x[0, n // 2] = 0
        out_row = merge_rows(out_row, check_quant_rows_case(x, f"[{b},{n},{k}] bf16"))
    o = torch.from_numpy(rng.standard_normal((2, 1280, 1024)).astype(np.float32)).to(dev, torch.bfloat16)
    o[1, 1100] = 0
    return merge_rows(out_row, check_quant_rows_case(
        o[:, 1024:], "[2,256,1024] bf16, the text rows of a joint [2,1280,1024] output in place"))


# K1Q / K6Q's inputs, [b, n, d]: the DiT / UNetT / MMDiT audio rows at the
# 1024 bucket and the cap, F5TTS_v1_Small's width, the MMDiT text stream
FUSED_NORM_SHAPES = ((2, 1024, 1024), (2, 4096, 1024), (2, 1024, 768), (2, 256, 1024))
# the GELU mode's, ff.out's input at ff_mult 2 (DiT, MMDiT) and 4 (UNetT)
GELU_SHAPES = ((2, 1024, 2048), (2, 4096, 2048), (2, 1024, 4096), (2, 4096, 4096))
# the GELU mode against F.gelu + K12 where not bit-equal (the card's tanhf
# may round apart from PyTorch's build): codes within 1 at no more than
# this share of the entries, scales within 2 f32 ulp
GELU_MOVED_SHARE = 1e-3
GELU_SCALE_ULPS = 2


def quant_against(codes, scale, want_c, want_s) -> tuple[int, int, float]:
    """(codes that differ, the largest code difference, the largest scale
    difference in ulps of the wanted scale)."""
    import torch

    dc = (codes.int() - want_c.int()).abs()
    ulps = ((scale - want_s).abs() / (torch.nextafter(want_s, want_s + 1) - want_s)).max()
    return int((dc > 0).sum()), int(dc.max()), float(ulps)


def time_quant_mode(name: str, what: str, fn, chain, plain, nbytes: int, extra: str) -> dict:
    """A K12 mode's time beside its bound, the two-launch chain it replaces
    and its plain version; logged, and returned as a kernels-line row."""
    ms = time_ms(fn)
    chain_ms = time_ms(chain)
    plain_ms = time_ms(plain, reps=2)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {name} {what}: {extra}, {ms:.4f} ms, bound {bound:.4f} ms (bytes), "
        f"{ms / bound:.2f}x the bound; the chain it replaces {chain_ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None}


def check_fused_norms(rng, dev) -> tuple[dict, dict]:
    """K1Q and K6Q at `FUSED_NORM_SHAPES`: bit-equal to the two-kernel chain
    on the card (K1 -> K12, K6 -> K12); against their plain versions (the
    f32 norm rounded to bf16: K1 / K6 sit within half a bf16 ulp of it)
    codes within 1 and scales within one bf16 ulp of the row's max / 127;
    an all-zero row (a zero x row, in K1Q's a batch whose shift is 0)
    exactly scale 1 and codes 0. Returns their kernels-line rows (the
    largest code difference from the plain version as max_abs_err)."""
    import torch
    from f5tts_tpu_torch.ops.adaln_norm import (adaln_norm, adaln_norm_quant,
                                                 adaln_norm_quant_ref, rms_norm, rms_norm_quant,
                                                 rms_norm_quant_ref)
    from f5tts_tpu_torch.ops.quant import quantize_rows

    out = {"adaln_norm_quant": None, "rms_norm_quant": None}
    for b, n, d in FUSED_NORM_SHAPES:
        x = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        x[0, n // 2] = 0
        mods = torch.from_numpy((0.05 * rng.standard_normal((b, 6 * d))).astype(np.float32))
        mods = mods.to(dev, torch.bfloat16)
        mods[0, :d] = 0  # batch 0's shift: its zero x row comes out all zero
        shift, scale = mods[:, :d], mods[:, d:2 * d]
        w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(
            dev, torch.bfloat16)
        cases = (("adaln_norm_quant", lambda: adaln_norm_quant(x, scale, shift),
                  lambda: quantize_rows(adaln_norm(x, scale, shift)),
                  lambda: adaln_norm_quant_ref(x, scale, shift), 4 * b * d),
                 ("rms_norm_quant", lambda: rms_norm_quant(x, w, 1e-8),
                  lambda: quantize_rows(rms_norm(x, w, 1e-8)),
                  lambda: rms_norm_quant_ref(x, w, 1e-8), 2 * d))
        for name, fn, chain, plain, operand_bytes in cases:
            (codes, sc), (cc, cs), (pc, ps) = fn(), chain(), plain()
            torch.cuda.synchronize()
            what = f"[{b},{n},{d}] bf16"
            if not (torch.equal(codes, cc) and torch.equal(sc, cs)):
                raise AssertionError(f"{name} {what}: not bit-equal to the chain on the card "
                                     f"{quant_against(codes, sc, cc, cs)}")
            moved, worst, _ = quant_against(codes, sc, pc, ps)
            rel = float(((sc - ps).abs() / ps).max())
            if worst > 1 or rel > 2.0 ** -7:
                raise AssertionError(f"{name} {what}: against its plain version codes within "
                                     f"{worst}, scales within {rel:.3e} relative (tol 1, 2^-7)")
            if not (bool((codes[0, n // 2] == 0).all()) and float(sc[0, n // 2]) == 1.0):
                raise AssertionError(f"{name} {what}: the all-zero row is not scale 1, codes 0")
            row = time_quant_mode(
                name, what, fn, chain, plain, 3 * b * n * d + operand_bytes + 4 * b * n,
                f"bit-equal to the chain; against the plain version {moved} codes moved (at "
                f"most {worst}), scales within {rel:.2e} relative")
            out[name] = merge_rows(out[name], {"max_abs_err": float(worst), **row})
    return out["adaln_norm_quant"], out["rms_norm_quant"]


def check_gelu_quant(rng, dev) -> dict:
    """K12's GELU mode at `GELU_SHAPES` against `F.gelu(x, "tanh")` + K12 on
    the card: bit-equal, or codes within 1 at no more than
    GELU_MOVED_SHARE of the entries and scales within GELU_SCALE_ULPS f32
    ulp (the count printed); an all-zero row scale 1, codes 0. Its plain
    version (F.gelu + the plain quantize) is that chain's arithmetic."""
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.quant import (gelu_quantize_rows, gelu_quantize_rows_ref,
                                           quantize_rows)

    out_row = None
    for b, n, d in GELU_SHAPES:
        x = torch.from_numpy((2 * rng.standard_normal((b, n, d))).astype(np.float32)).to(
            dev, torch.bfloat16)
        x[1, n // 3] = 0
        fn = lambda: gelu_quantize_rows(x)  # noqa: E731
        chain = lambda: quantize_rows(F.gelu(x, approximate="tanh"))  # noqa: E731
        (codes, sc), (cc, cs), (pc, ps) = fn(), chain(), gelu_quantize_rows_ref(x)
        torch.cuda.synchronize()
        what = f"[{b},{n},{d}] bf16"
        moved, worst, ulps = quant_against(codes, sc, cc, cs)
        if worst > 1 or moved > GELU_MOVED_SHARE * codes.numel() or ulps > GELU_SCALE_ULPS:
            raise AssertionError(f"gelu_quantize_rows {what}: against F.gelu + K12 {moved} codes "
                                 f"moved (at most {worst}), scales within {ulps} ulp")
        if not (bool((codes[1, n // 3] == 0).all()) and float(sc[1, n // 3]) == 1.0):
            raise AssertionError(f"gelu_quantize_rows {what}: the all-zero row is not scale 1, "
                                 "codes 0")
        p_moved, p_worst, p_ulps = quant_against(codes, sc, pc, ps)
        if p_worst > 1 or p_moved > GELU_MOVED_SHARE * codes.numel() or p_ulps > GELU_SCALE_ULPS:
            raise AssertionError(f"gelu_quantize_rows {what}: against its plain version "
                                 f"{p_moved} codes moved (at most {p_worst}), scales within "
                                 f"{p_ulps} ulp")
        equal = "bit-equal to F.gelu + K12" if moved == 0 and ulps == 0 else (
            f"against F.gelu + K12 {moved} of {codes.numel()} codes moved by 1, scales within "
            f"{ulps:.0f} ulp")
        row = time_quant_mode("gelu_quantize_rows", what, fn, chain,
                              lambda: gelu_quantize_rows_ref(x), 3 * b * n * d + 4 * b * n, equal)
        out_row = merge_rows(out_row, {"max_abs_err": float(p_worst), **row})
    return out_row


def check_dequant(dev) -> dict:
    """K13 at `K13_SHAPES`, with and without a bias: bit-equal (as int16
    views) to its plain version."""
    import torch
    from f5tts_tpu_torch.ops.quant import dequant_bias, dequant_bias_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    out_row = None
    for m, n in K13_SHAPES:
        acc = torch.randint(-2**20, 2**20, (m, n), dtype=torch.int32, device=dev, generator=gen)
        xs = torch.rand(m, device=dev, generator=gen) * 3e-2 + 1e-3
        ws = torch.rand((1, n), device=dev, generator=gen) * 1e-3 + 1e-4
        bias = torch.randn(n, device=dev, generator=gen).to(torch.bfloat16)
        err = 0.0
        for b in (bias, None):
            y = dequant_bias(acc, xs, ws, b, torch.bfloat16)
            ref = dequant_bias_ref(acc, xs, ws, b, torch.bfloat16)
            torch.cuda.synchronize()
            err = max(err, float((y.float() - ref.float()).abs().max()))
            if not torch.equal(y.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"dequant_bias [{m},{n}] (bias {b is not None}): not "
                                     f"bit-equal to its plain version ({err})")
        bound = max((6 * m * n + 4 * m + 6 * n) / HBM_BYTES_PER_S,
                    3 * m * n / F32_FLOPS_PER_S) * 1e3
        ms = time_ms(lambda: dequant_bias(acc, xs, ws, bias, torch.bfloat16))
        wall = wall_ms(lambda: dequant_bias(acc, xs, ws, bias, torch.bfloat16))
        plain = time_ms(lambda: dequant_bias_ref(acc, xs, ws, bias, torch.bfloat16), reps=2)
        log(f"  dequant_bias [{m},{n}] int32 -> bf16 (+ bf16 bias; and without): bit-equal, "
            f"{ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms (bytes), plain "
            f"{plain:.4f} ms, {ms / bound:.2f}x the bound")
        out_row = merge_rows(out_row, {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": bound, "bound_by": "bytes",
                                        "library_ms": None})
    return out_row


def time_int8_products(dev, gpu: str) -> list[dict]:
    """`torch._int_mm` at a DiT-1024 block's shapes with the weight as
    [n, k] passed as `.t()` (the layout `quantize_dit_params` stores) and as
    [k, n], beside the bf16 product of the same shape; both int8 layouts
    exact and equal."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(31)
    rows = []
    for m, k, n in INT8_MM_SHAPES:
        xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen)
        w_kn = w.t().contiguous()
        xb, wb = xq.to(torch.bfloat16), w_kn.to(torch.bfloat16)
        exact = (xq.double() @ w_kn.double()).to(torch.int32)
        if not (torch.equal(torch._int_mm(xq, w.t()), exact)
                and torch.equal(torch._int_mm(xq, w_kn), exact)):
            raise AssertionError(f"torch._int_mm [{m},{k}]x[{k},{n}] is not exact")
        row = {"m": m, "k": k, "n": n, "int8_nk_t_ms": time_ms(lambda: torch._int_mm(xq, w.t())),
               "int8_kn_ms": time_ms(lambda: torch._int_mm(xq, w_kn)),
               "bf16_ms": time_ms(lambda: xb @ wb)}
        rows.append(row)
        log(f"  int8 product [{m},{k}]x[{k},{n}]: w [n,k].t() {row['int8_nk_t_ms']:.4f} ms, "
            f"w [k,n] {row['int8_kn_ms']:.4f} ms; bf16 {row['bf16_ms']:.4f} ms [{gpu}]")
    return rows


def replay_ms(entry, reps: int = 5) -> float:
    """Median device time of one replay of a pipeline's graph (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        entry.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def int8_against_bf16(pipes: dict, cases, gpu: str) -> list[dict]:
    """Each (text, frames) case through both pipelines ({"none": bf16,
    "int8": int8}, their graphs captured): graphed walls of WALL_REPS
    requests in turns (medians) and the device time of one replay of each
    pipeline's graph."""
    import torch
    from f5tts_tpu_torch.scripts.common import REF_TEXT, synthetic_ref_wav

    ref = synthetic_ref_wav()
    rows = []
    for text, frames in cases:
        walls = {q: [] for q in pipes}
        used = {}
        for seed in range(WALL_REPS):
            for q, pipe in pipes.items():
                before = {key: e.replays for key, e in pipe.graphs.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                wave, sr, _ = pipe.infer(ref, 24000, REF_TEXT, text, seed=seed, nfe_step=NFE,
                                         cfg_strength=2.0, sway_sampling_coef=-1.0,
                                         fix_duration=(frames + 0.5) * pipe.hop / pipe.sr)
                torch.cuda.synchronize()
                walls[q].append(time.perf_counter() - t0)
                (used[q],) = [e for key, e in pipe.graphs.items()
                              if e.replays > before.get(key, 0)]
        audio_s = len(wave) / sr
        row = {"frames": frames, "audio_s": audio_s}
        for q in pipes:
            wall = statistics.median(walls[q])
            row[q] = {"wall_s": wall, "walls_s": walls[q], "rtf": wall / audio_s,
                      "device_ms": replay_ms(used[q])}
        rows.append(row)
        log(f"  DiT {frames} frames ({audio_s:.3f} s of audio): graphed wall bf16 "
            f"{row['none']['wall_s']:.4f} s / int8 {row['int8']['wall_s']:.4f} s (medians of "
            f"{WALL_REPS}, in turns), RTF {row['none']['rtf']:.5f} / {row['int8']['rtf']:.5f}, "
            f"device ms a replay {row['none']['device_ms']:.2f} / {row['int8']['device_ms']:.2f}"
            f" [{gpu}]")
    return rows


def pinyin_request(pipe, vocab: dict, expect: dict, gpu: str) -> dict:
    """One Chinese + English request through `pipe` (the pinyin tokenizer):
    the ids its graph was fed must equal convert_char_to_pinyin +
    list_str_to_idx of the same chunk called here."""
    from f5tts_tpu_torch.infer.pipeline import chunk_text, max_chars_for_ref
    from f5tts_tpu_torch.scripts.common import REF_TEXT, synthetic_ref_wav
    from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin, segmenter_name
    from f5tts_tpu_torch.text.vocab import list_str_to_idx

    ref_text = REF_TEXT + " "  # `infer`'s completion of a reference ending in "."
    ref_secs = len(synthetic_ref_wav()) / 24000
    chunks = chunk_text(PINYIN_TEXT, max(max_chars_for_ref(ref_text, ref_secs,
                                                           pipe.sampling.speed), 16))
    if len(chunks) != 1:
        raise AssertionError(f"the pinyin request splits into {len(chunks)} chunks")
    want = list_str_to_idx(convert_char_to_pinyin([ref_text + chunks[0]]), vocab)
    before = {key: e.replays for key, e in pipe.graphs.items()}
    ran = run_requests(pipe, [(PINYIN_TEXT, None, expect)], gpu)
    (entry,) = [e for key, e in pipe.graphs.items() if e.replays > before.get(key, 0)]
    got = entry.inputs["text"].cpu().numpy()
    want = np.pad(want, ((0, 0), (0, got.shape[1] - want.shape[1])), constant_values=-1)
    tokens = int((want != -1).sum())
    log(f"  pinyin request: {tokens} tokens ({segmenter_name()} segmenter); the graph's ids "
        f"{'equal' if np.array_equal(got, want) else 'DIFFER from'} convert_char_to_pinyin + "
        "list_str_to_idx called here")
    if not np.array_equal(got, want):
        raise AssertionError("the pinyin request's ids differ from the direct conversion")
    return ran


def phase_int8(dev, gpu: str, bf16_drift: tuple) -> tuple[dict, dict]:
    """F5TTS_v1_Base int8 against bf16 (both with the pinyin tokenizer and
    the Emilia vocab, the pipeline's default) at the 1024 bucket and the
    cap, one pinyin request, the depth-2 gates, the graphed int8 generate
    against the eager one (F5TTS_v1_Base at the 1024 bucket and the cap,
    E2TTS_Base and MMDiT_Base at the cap), E2TTS_Base and MMDiT_Base int8
    at the 1024 bucket. Returns (the launches the card ran, the
    numbers)."""
    import torch
    from f5tts_tpu_torch.eval.rtf_bench import bench_line, bench_sampler
    from f5tts_tpu_torch.scripts.common import REQUESTS, base_models
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab

    vocab = load_vocab(EMILIA_VOCAB)
    launches: dict[str, int] = {}

    def add(ran):
        for name, c in ran.items():
            launches[name] = launches.get(name, 0) + c

    arch, params, vocos_params = base_models()
    pipes = {q: make_pipeline(dev, "DiT", arch, params, vocos_params, vocab_char_map=vocab,
                              tokenizer="pinyin", quantization=q) for q in ("none", "int8")}
    cases = ((REQUESTS[0], 1014), (REQUESTS[1], 4086))
    for q, pipe in pipes.items():
        expect = generate_launches("DiT", arch, int8=q == "int8")
        add(run_requests(pipe, [(text, frames, expect) for text, frames in cases], gpu))
    out = {"dit": int8_against_bf16(pipes, cases, gpu)}
    add(pinyin_request(pipes["int8"], vocab, generate_launches("DiT", arch, int8=True), gpu))
    del pipes
    torch.cuda.empty_cache()

    step = step_launches("DiT", dataclasses.replace(arch, depth=2), int8=True)
    rel_i8, mel_i8 = phase_card_vs_cpu(dev, arch, params, vocos_params, "DiT", step, "int8")
    rel_bf, mel_bf = bf16_drift
    drift = float((mel_i8 - mel_bf).norm() / mel_bf.norm())
    log(f"  DiT depth 2: card int8 against card bf16 mel rel-L2 {drift:.4e} (tol 2 x the card "
        f"bf16 against cpu f32 {rel_bf:.4e}: {2 * rel_bf:.4e}); card int8 against cpu f32 int8 "
        f"{rel_i8:.4e}")
    if not drift <= 2 * rel_bf:
        raise AssertionError(f"card int8 against card bf16 rel-L2 {drift} > 2 x {rel_bf}")
    out["depth2"] = {"int8_vs_bf16": drift, "bf16_vs_f32": rel_bf, "int8_vs_cpu_int8": rel_i8}
    log("  the graphed int8 generate against the eager one, F5TTS_v1_Base:")
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params, quantization="int8")
    out["graphs"] = [compare_graph_eager(pipe, generate_launches("DiT", arch, int8=True), frames,
                                         gpu) for frames in (1014, 4086)]
    del pipe, params
    torch.cuda.empty_cache()

    stats = bench_sampler("F5TTS_v1_Base", device=dev, quantization="int8")
    log(f"  rtf_bench int8: {json.dumps(stats)}")
    log(f"  bench line int8: {json.dumps(bench_line(stats))}")

    for model, backbone, frames, cap in (("E2TTS_Base", "UNetT", 1013, 4096),
                                         ("MMDiT_Base", "MMDiT", 1014, 4086)):
        arch_b, params_b, vocos_b = base_models(model=model)
        pipe = make_pipeline(dev, backbone, arch_b, params_b, vocos_b, quantization="int8")
        log(f"  {model} int8:")
        add(run_requests(pipe, [(REQUESTS[0], frames,
                                 generate_launches(backbone, arch_b, int8=True))], gpu))
        # the cap (E2TTS: 4224 rows, past the flat gate), graphed against eager
        out["graphs"].append(compare_graph_eager(
            pipe, generate_launches(backbone, arch_b, backbone != "UNetT", int8=True), cap, gpu))
        del pipe, params_b
        torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 18
# ---------------------------------------------------------------------------

SAMPLER_OPTIONS = ("midpoint", "edit_mask", "no_ref_audio", "restart")
MIDPOINT_STEPS = 8          # 16 backbone passes, a 16-NFE Euler generate's launches
EDIT_SECONDS = 8.0          # the reference to edit
EDIT_SPANS = ((1.0, 1.8), (4.0, 5.2))
EDIT_FIX = (1.2, 0.8)       # the spans' new lengths, s
EDIT_NFE = 32               # the pipeline's default
BIGVGAN_CHECK_FRAMES = 128  # card against the CPU
BIGVGAN_TIME_FRAMES = (1024, 4096)
BIGVGAN_FLOP_A_FRAME = 1.75e9  # the AMP convolutions of the six stages, from the config
BIGVGAN_REL_TOL = 1e-3


def midpoint_full_width(pipe, arch, gpu: str) -> dict:
    """F5TTS_v1_Base at the 1024 bucket: cfm_sample(method="midpoint") over
    MIDPOINT_STEPS steps, eagerly, the counts set to 0 just before and read
    just after; the prompt rows equal cond exactly."""
    import torch
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REF_TEXT, REQUESTS, synthetic_ref_wav

    req = pipe.prepare_chunk(synthetic_ref_wav(), REF_TEXT + " ", REQUESTS[0], seed=0,
                             nfe_step=MIDPOINT_STEPS, cfg_strength=2.0,
                             sway_sampling_coef=-1.0, fix_duration=1014.5 * pipe.hop / pipe.sr)
    expect = generate_launches("DiT", arch)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    mel = cfm.cfm_sample(pipe.params, pipe.statics, req["cond"], req["text"], req["lens"],
                         req["duration"], req["t_grid"], y0=req["y0"], cfg_strength=2.0,
                         dtype=pipe.dtype, backbone=pipe.bdef, method="midpoint")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = _build.launches()
    p = req["ref_frames"]
    log(f"  midpoint, {MIDPOINT_STEPS} steps at {tuple(req['cond'].shape[:2])}: eager wall "
        f"{wall:.4f} s, launches {ran} [{gpu}]")
    if ran != expect:
        raise AssertionError(f"midpoint launches {ran}, expected {expect}")
    if not (torch.isfinite(mel).all() and torch.equal(mel[0, :p], req["cond"][0, :p])):
        raise AssertionError("midpoint: the mel is not finite or a prompt row is not cond")
    return ran


def speech_edit_full_width(pipe, arch, gpu: str) -> dict:
    """`edit_speech` on an EDIT_SECONDS reference, two spans with new
    lengths, EDIT_NFE NFE (the counts set to 0 just before and read just
    after); then its cond and mask through cfm_sample directly: every kept
    frame the spliced original exactly, the regenerated ones finite and
    not all zero."""
    import torch
    from f5tts_tpu_torch.infer.speech_edit import edit_speech, prepare_edit
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REQUESTS, synthetic_ref_wav

    ref = synthetic_ref_wav(EDIT_SECONDS)
    args = (pipe, ref, 24000, REQUESTS[0], EDIT_SPANS, EDIT_FIX)
    expect = {k: v * EDIT_NFE // NFE for k, v in generate_launches("DiT", arch).items()}
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    wave, sr = edit_speech(*args, seed=0, nfe_step=EDIT_NFE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = _build.launches()
    req = prepare_edit(*args, seed=0, nfe_step=EDIT_NFE)
    total = req.pop("total")
    req.pop("rms")
    log(f"  edit_speech: {len(ref) / 24000:.2f} s in, {len(wave) / sr:.3f} s out ({total} frames, "
        f"bucket {req['cond'].shape[1]}), wall {wall:.4f} s, launches {ran} [{gpu}]")
    if ran != expect:
        raise AssertionError(f"edit_speech launches {ran}, expected {expect}")
    if not (np.isfinite(wave).all() and len(wave) == (total - 1) * pipe.hop):
        raise AssertionError("edit_speech: the wav is not finite or not total frames long")
    mel = cfm.cfm_sample(pipe.params, pipe.statics, dtype=pipe.dtype, backbone=pipe.bdef, **req)
    kept = req["edit_mask"][0, :total]
    got, cond = mel[0, :total], req["cond"][0, :total]
    regen = got[~kept]
    log(f"  edit cond through cfm_sample: {int(kept.sum())} kept frames, {int((~kept).sum())} "
        f"regenerated, max |regenerated| {float(regen.abs().max()):.3f}")
    if not torch.equal(got[kept], cond[kept]):
        raise AssertionError("speech edit: a kept frame differs from the spliced original")
    if not (torch.isfinite(regen).all() and regen.abs().max() > 0):
        raise AssertionError("speech edit: the regenerated frames are not finite or all zero")
    return ran


def bigvgan_decode(dev, big_params, vocos_params, gpu: str) -> list[dict]:
    """The full-size BigVGAN (f32, TF32 off): card against the CPU on a
    BIGVGAN_CHECK_FRAMES mel (rel-L2), then its decode time (CUDA-graph
    replays) at BIGVGAN_TIME_FRAMES beside Vocos' on the same mel."""
    import torch
    from f5tts_tpu_torch.vocoder.bigvgan import BigVGAN
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    card = BigVGAN(big_params, device=dev)
    rng = np.random.default_rng(18)
    mel = torch.from_numpy((rng.standard_normal((1, 100, BIGVGAN_CHECK_FRAMES)) * 2.0
                            - 4.0).astype(np.float32))
    t0 = time.perf_counter()
    want = BigVGAN(big_params, device="cpu")(mel)
    cpu_s = time.perf_counter() - t0
    got = card(mel.to(dev)).cpu()
    rel = float((got - want).norm() / want.norm())
    log(f"  BigVGAN {BIGVGAN_CHECK_FRAMES} frames, card f32 against cpu f32: wav rel-L2 "
        f"{rel:.3e} (tol {BIGVGAN_REL_TOL}), max-abs {float((got - want).abs().max()):.3e}, "
        f"|wav| max {float(want.abs().max()):.3f}; cpu {cpu_s:.2f} s")
    if not (np.isfinite(rel) and rel <= BIGVGAN_REL_TOL and got.shape == (1, 256 * mel.shape[2])):
        raise AssertionError(f"BigVGAN card against cpu rel-L2 {rel} > {BIGVGAN_REL_TOL}")
    vocos = Vocos(vocos_params, VocosConfig(), device=dev)
    rows = []
    for frames in BIGVGAN_TIME_FRAMES:
        m = torch.from_numpy((rng.standard_normal((1, 100, frames)) * 2.0 - 4.0)
                             .astype(np.float32)).to(dev)
        big_ms = time_ms(lambda: card(m), reps=1, iters=3)
        vocos_ms = time_ms(lambda: vocos(m), reps=3, iters=5)
        tflops = BIGVGAN_FLOP_A_FRAME * frames / (big_ms * 1e-3) / 1e12
        rows.append({"frames": frames, "bigvgan_ms": big_ms, "vocos_ms": vocos_ms,
                     "bigvgan_tflop_s": tflops})
        log(f"  decode {frames} frames ({frames * 256 / 24000:.2f} s): BigVGAN {big_ms:.2f} ms "
            f"(~{tflops:.1f} TFLOP/s of the {BIGVGAN_FLOP_A_FRAME:.2e} FLOP a frame estimate), "
            f"Vocos {vocos_ms:.3f} ms [{gpu}]")
    del card, vocos
    torch.cuda.empty_cache()
    return rows


def bigvgan_pipeline(dev, arch, params, big_params, gpu: str) -> tuple[dict, dict]:
    """F5TTS_v1_Base with the bigvgan mel and BigVGAN in the graph: one
    request through `infer` at the 1024 bucket (run_requests' checks),
    the graphed generate against the eager body (phase 16's), a replay's
    device ms, `ref_mel`'s len // 256 frames. Returns (launches, numbers)."""
    import torch
    from f5tts_tpu_torch.config import MelConfig
    from f5tts_tpu_torch.scripts.common import REQUESTS, synthetic_ref_wav
    from f5tts_tpu_torch.vocoder.bigvgan import BigVGAN

    pipe = make_pipeline(dev, "DiT", arch, params, None,
                         vocoder=BigVGAN(big_params, device=dev),
                         mel_cfg=MelConfig(mel_spec_type="bigvgan"))
    ref = synthetic_ref_wav()
    frames = pipe.ref_mel(ref).shape[0]
    if frames != len(ref) // 256:
        raise AssertionError(f"bigvgan ref_mel: {frames} frames, expected {len(ref) // 256}")
    expect = generate_launches("DiT", arch)
    ran = run_requests(pipe, [(REQUESTS[0], 1014, expect)], gpu)
    row = compare_graph_eager(pipe, expect, 1014, gpu)
    entry = pipe.graphs[tuple(row["key"])]
    row["replay_device_ms"] = replay_ms(entry)
    log(f"  BigVGAN pipeline: a replay {row['replay_device_ms']:.2f} ms on the card, ref_mel "
        f"{frames} frames for {len(ref)} samples [{gpu}]")
    del pipe
    torch.cuda.empty_cache()
    return ran, row


def phase_sampler_options(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 18: the midpoint ODE, edit_mask, no_ref_audio and the restart
    at full width and at depth 2 against the CPU, speech editing, and the
    BigVGAN vocoder with its mel. Returns (the launches the card ran on
    these paths, the numbers)."""
    import torch
    from f5tts_tpu_torch.scripts.common import base_models

    launches: dict[str, int] = {}

    def add(ran):
        for name, c in ran.items():
            launches[name] = launches.get(name, 0) + c

    arch, params, vocos_params = base_models()
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params)
    add(midpoint_full_width(pipe, arch, gpu))
    for option in SAMPLER_OPTIONS:
        phase_card_vs_cpu(dev, arch, params, vocos_params, "DiT",
                          step_launches("DiT", dataclasses.replace(arch, depth=2)),
                          option=option)
    add(speech_edit_full_width(pipe, arch, gpu))
    del pipe
    torch.cuda.empty_cache()
    _, _, big_params = base_models(vocoder="bigvgan")
    out = {"decode": bigvgan_decode(dev, big_params, vocos_params, gpu)}
    ran, out["pipeline"] = bigvgan_pipeline(dev, arch, params, big_params, gpu)
    add(ran)
    return launches, out


# ---------------------------------------------------------------------------
# phase 19
# ---------------------------------------------------------------------------

ARCH_FLAGS = {"long_skip_connection": True, "text_embedding_average_upsampling": True}
UPSAMPLE_TOTALS = (800, 1000)    # two requests in the 1024 bucket
REMAT_BATCH = (37, 1024)         # the reference's 38,400-frame batch in whole rows
REMAT_POLICIES = ("nothing", "attn_out", "attn", "dots")
REMAT_REL_TOL = 1e-3             # loss and grad norm against the run without checkpointing


def dit_update_launches(depth: int, policy=None) -> dict:
    """The launches of one F5TTS_v1_Base-like training update: K3's lse mode
    and K4 a block, K1 two a block and the final norm, K2 once; under
    checkpointing every block's two norms again, and the attention forward
    again where the policy keeps no attention output."""
    lse = depth * (2 if policy in ("nothing", "dots") else 1)
    norms = 2 * depth + 1 + (2 * depth if policy else 0)
    return {"fused_qkv_rope_attention_lse": lse, "fused_qkv_rope_attention_bwd": depth,
            "adaln_norm": norms, "conv_pos_embedding": 1}


def train_batch(b: int, n: int, model: str, seed: int = 19) -> tuple:
    """(mel [b, n, 100], text ids, lens) on the host: lens in [n/2, n], the
    first n; text as `common.synthetic_text_ids` draws it for `model`."""
    import torch
    from f5tts_tpu_torch.scripts.common import synthetic_text_ids

    rng = np.random.default_rng(seed)
    lens = rng.integers(n // 2, n + 1, b).astype(np.int32)
    lens[0] = n
    mel = (rng.standard_normal((b, n, 100)) * 0.3).astype(np.float32)
    text = synthetic_text_ids(rng, lens, model)
    return tuple(torch.from_numpy(a) for a in (mel, text, lens))


def train_updates(dev, backbone: str, arch, params, batch, updates: int, expect: dict,
                  label: str, gpu: str, fuse_qkv: bool = True, state_dtype=None) -> dict:
    """`updates` TrainStep updates (loss, backward, clip + AdamW + EMA) from
    a fresh state of `params` on the card, the counts set to 0 just before
    each update and read just after (each must be `expect`). Returns the
    run's numbers: ms of the last update, peak allocated memory (the state
    included), the state's bytes, losses, grad norms, summed launches."""
    import torch
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    bdef = BACKBONES[backbone]
    mel, text, lens = (t.to(dev) for t in batch)
    state = init_train_state(params, dev, moment_dtype=state_dtype, ema_dtype=state_dtype)
    state_bytes = {name: sum(t.numel() * t.element_size() for t in tree_leaves(getattr(state, name)))
                   for name in ("params", "mu", "nu", "ema")}
    step = make_train_step(bdef.statics_cls(arch, dev), make_optimizer(7.5e-5, 1000, 10000),
                           ema_update_every=1, ema_update_after_step=0, backbone=bdef,
                           fuse_qkv=fuse_qkv)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    rows, total = [], {}
    for u in range(updates):
        gen = torch.Generator(device=dev).manual_seed(u)
        torch.cuda.synchronize(dev)
        _build.reset_launches()  # every count to 0 just before the update
        t0 = time.perf_counter()
        state, metrics = step(state, mel, text, lens, generator=gen)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        ran = _build.launches()
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"]), wall))
        if ran != expect:
            raise AssertionError(f"{label}: update {u + 1} launched {ran}, expected {expect}")
        for k, c in ran.items():
            total[k] = total.get(k, 0) + c
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    bad = [leaf for name in ("params", "mu", "nu", "ema") for leaf in tree_leaves(getattr(state, name))
           if not bool(torch.isfinite(leaf).all())]
    del state, step
    torch.cuda.empty_cache()
    b, n = mel.shape[:2]
    out = {"label": label, "batch": b, "frames": n, "ms_per_update": rows[-1][2],
           "walls_ms": [r[2] for r in rows], "peak_gb": peak,
           "state_gb": sum(state_bytes.values()) / 1e9,
           "state_bytes": state_bytes, "losses": [r[0] for r in rows],
           "grad_norms": [r[1] for r in rows], "launches_per_update": expect, "ran": total}
    log(f"  {label} b={b} n={n}: {out['ms_per_update']:.1f} ms the last of {updates} updates "
        f"({', '.join(f'{w:.1f}' for w in out['walls_ms'])}), peak {peak:.2f} GB allocated, "
        f"state {out['state_gb']:.3f} GB, losses {out['losses']}, grad norms "
        f"{out['grad_norms']}, launches an update {expect} [{gpu}]")
    if bad or not all(np.isfinite(r[0]) and np.isfinite(r[1]) for r in rows):
        raise AssertionError(f"{label}: a non-finite loss, grad norm or state leaf")
    return out


def upsample_two_lengths(pipe, gpu: str) -> None:
    """Two requests in one captured bucket with durations UPSAMPLE_TOTALS:
    each graphed generate equals the eager one on its inputs (bit-equal, or
    phase 16's tolerances), 0 host launches; the text each graph read is
    spread over that request's own duration."""
    import torch
    from f5tts_tpu_torch.models import cfm, dit
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REF_TEXT, REQUESTS, synthetic_ref_wav

    ref = synthetic_ref_wav()
    keys = set()
    for i, total in enumerate(UPSAMPLE_TOTALS):
        req = pipe.prepare_chunk(ref, REF_TEXT + " ", REQUESTS[1], seed=i, nfe_step=NFE,
                                 cfg_strength=2.0, sway_sampling_coef=-1.0,
                                 fix_duration=(total + 0.5) * pipe.hop / pipe.sr)
        req.pop("ref_frames")
        if req.pop("total") != total:
            raise AssertionError(f"upsampling check: the request is not {total} frames")
        key = (*req["cond"].shape[:2], req["text"].shape[1], NFE)
        if key not in pipe.graphs:
            raise AssertionError(f"upsampling check: {key} was not captured before")
        keys.add(key)
        mel_e = cfm.cfm_sample(pipe.params, pipe.statics, req["cond"], req["text"], req["lens"],
                               req["duration"], req["t_grid"].to(pipe.device), y0=req["y0"],
                               cfg_strength=2.0, dtype=pipe.dtype, backbone=pipe.bdef)
        wav_e = pipe.vocoder(mel_e.transpose(1, 2))
        _build.reset_launches()
        mel_g, wav_g = pipe.fused_generate(**req)
        torch.cuda.synchronize()
        if _build.launches():
            raise AssertionError(f"upsampling check: a replay launched {_build.launches()}")
        rel = float((mel_g - mel_e).norm() / mel_e.norm())
        wmax = float((wav_g - wav_e).abs().max())
        emb = dit.text_embedding(pipe.params["text_embed"], pipe.statics, req["text"],
                                 key[1], lengths=req["duration"], dtype=pipe.dtype)
        live = int(emb[0].abs().amax(dim=-1).gt(0).sum())
        log(f"  upsampled request of {total} frames in bucket {key}: graphed vs eager mel "
            f"rel-L2 {rel:.3e}, wav max-abs {wmax:.3e}; its text covers {live} frames [{gpu}]")
        if not (rel <= GRAPH_MEL_REL_TOL and wmax <= GRAPH_WAV_ABS_TOL and live == total):
            raise AssertionError(f"upsampling check at {total} frames: graphed against eager "
                                 f"{rel} / {wmax}, text over {live} frames")
    if len(keys) != 1:
        raise AssertionError(f"upsampling check: the two requests took keys {keys}")


def phase19_inference_flags(dev, gpu: str) -> tuple[dict, dict]:
    """(a) F5TTS_v1_Base with the long skip and average upsampling through
    the pipeline, graphed against eager, two lengths in one bucket, depth 2
    card against CPU."""
    import torch
    from f5tts_tpu_torch.scripts.common import REQUESTS, base_models

    arch, params, vocos_params = base_models(**ARCH_FLAGS)
    expect = generate_launches("DiT", arch)
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params)
    ran = run_requests(pipe, [(REQUESTS[0], 1014, expect), (REQUESTS[1], 4086, expect)], gpu)
    del pipe
    torch.cuda.empty_cache()
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params)
    row = compare_graph_eager(pipe, expect, 1014, gpu)
    upsample_two_lengths(pipe, gpu)
    del pipe
    torch.cuda.empty_cache()
    rel, _ = phase_card_vs_cpu(dev, arch, params, vocos_params, "DiT",
                               step_launches("DiT", dataclasses.replace(arch, depth=2)))
    return ran, {"graph": row, "depth2_mel_rel_l2": rel}


def reference_state_dict(params, extra_seed: int = 19) -> dict:
    """The DiT params in the reference's key layout under "ema_model."
    (`train.checkpoint.to_reference_keys`), numpy f32, with keys a reference
    checkpoint carries that the importer ignores."""
    from f5tts_tpu_torch.train.checkpoint import to_reference_keys

    rng = np.random.default_rng(extra_seed)
    sd = to_reference_keys(params, prefix="ema_model.")
    sd["ema_model.mel_spec.mel_stft.mel_scale.fb"] = rng.standard_normal((513, 100)).astype(
        np.float32)
    sd["ema_model.transformer.rotary_embed.freqs"] = rng.standard_normal((32,)).astype(np.float32)
    return sd


def phase19_importer(dev, gpu: str) -> tuple[dict, dict]:
    """(b) A reference-layout checkpoint of F5TTS_v1_Base with qk-norm and
    the long skip, written as safetensors, read back through the audited
    importer onto the card, exported again bit for bit, and one request."""
    import shutil
    import tempfile

    import torch
    from f5tts_tpu_torch.compat import convert_backbone_state_dict_audited, load_torch_checkpoint
    from f5tts_tpu_torch.config import model_config_from_dict
    from f5tts_tpu_torch.infer.utils_infer import load_checkpoint
    from f5tts_tpu_torch.scripts.common import REQUESTS, base_models
    from f5tts_tpu_torch.train.checkpoint import to_reference_keys, write_safetensors_f32

    cfg = model_config_from_dict({"model": {"name": "F5TTS_v1_Base", "backbone": "DiT", "arch": {
        "dim": 1024, "depth": 22, "heads": 16, "ff_mult": 2, "text_dim": 512,
        "text_mask_padding": True, "qk_norm": "rms_norm", "conv_layers": 4, "pe_attn_head": None,
        "long_skip_connection": True, "checkpoint_activations": False}}})
    arch = dataclasses.replace(cfg.arch, text_num_embeds=2545)
    _, params, vocos_params = base_models(qk_norm="rms_norm", long_skip_connection=True)
    sd = reference_state_dict(params)
    del params
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        path = str(Path(tmp) / "model.safetensors")
        t0 = time.perf_counter()
        write_safetensors_f32(sd, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, unread = convert_backbone_state_dict_audited(load_torch_checkpoint(path), arch)
        audit_s = time.perf_counter() - t0
        if unread:
            raise AssertionError(f"importer audit: unread weight keys {unread[:8]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_checkpoint(arch, path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size_gb = Path(path).stat().st_size / 1e9
    finally:
        shutil.rmtree(tmp)
    back = to_reference_keys(loaded, prefix="ema_model.")
    want = {k: v for k, v in sd.items() if "mel_spec." not in k and "rotary_embed" not in k}
    if sorted(back) != sorted(want):
        raise AssertionError(f"export: keys differ {sorted(set(back) ^ set(want))[:8]}")
    differ = [k for k in want if not np.array_equal(back[k], want[k])]
    n_norm = sum(1 for k in back if k.endswith(("q_norm.weight", "k_norm.weight")))
    skip = any(k.endswith("long_skip_connection.weight") for k in back)
    log(f"  reference checkpoint: {len(sd)} keys, {size_gb:.3f} GB written in {write_s:.2f} s; "
        f"read + audited conversion {audit_s:.2f} s (0 unread weight keys); load_checkpoint onto "
        f"the card {load_s:.2f} s; export back: {len(back)} tensors ({n_norm} qk-norm weights, "
        f"long skip {skip}), {len(differ)} differ [{gpu}]")
    if n_norm != 44 or not skip:
        raise AssertionError(f"export: {n_norm} qk-norm weights, long skip {skip}")
    if differ:
        raise AssertionError(f"export: {len(differ)} tensors differ, e.g. {differ[:4]}")
    expect = {"flash_attention": 22 * NFE, "rms_norm": 44 * NFE, "adaln_norm": 45 * NFE,
              "conv_pos_embedding": 2 * NFE}
    pipe = make_pipeline(dev, "DiT", arch, loaded, vocos_params)
    del loaded
    ran = run_requests(pipe, [(REQUESTS[0], 1014, expect)], gpu)
    del pipe
    torch.cuda.empty_cache()
    return ran, {"keys": len(sd), "file_gb": size_gb, "write_s": write_s,
                 "read_audit_s": audit_s, "load_checkpoint_s": load_s}


def phase19_checkpointing(dev, gpu: str) -> tuple[dict, dict]:
    """(c) F5TTS_v1_Base at REMAT_BATCH without checkpointing and under each
    policy (2 updates each, the same weights, data and draws), b = 64 x 1024
    under "nothing", E2TTS_Base and MMDiT_Base under "nothing", and
    bf16_state."""
    import torch
    from f5tts_tpu_torch.scripts.common import base_models

    ran: dict[str, int] = {}
    out: dict = {"dit": []}

    def add(row):
        for k, c in row.pop("ran").items():
            ran[k] = ran.get(k, 0) + c
        return row

    arch, params, _ = base_models()
    batch = train_batch(*REMAT_BATCH, "F5TTS_v1_Base")
    base = add(train_updates(dev, "DiT", arch, params, batch, 2, dit_update_launches(arch.depth),
                             "DiT, no checkpointing", gpu))
    out["dit"].append(base)
    for policy in REMAT_POLICIES:
        arch_p = dataclasses.replace(arch, checkpoint_activations=True, remat_policy=policy)
        row = add(train_updates(dev, "DiT", arch_p, params, batch, 2,
                                dit_update_launches(arch.depth, policy),
                                f"DiT, checkpointing '{policy}'", gpu))
        worst = max(abs(a - b) / abs(b) for a, b in zip(row["losses"] + row["grad_norms"],
                                                        base["losses"] + base["grad_norms"]))
        row["rel_to_plain"] = worst
        log(f"  '{policy}': loss and grad norm within {worst:.3e} of the run without "
            f"checkpointing (tol {REMAT_REL_TOL}); peak {row['peak_gb']:.2f} against "
            f"{base['peak_gb']:.2f} GB, {row['ms_per_update']:.1f} against "
            f"{base['ms_per_update']:.1f} ms an update")
        if not worst <= REMAT_REL_TOL:
            raise AssertionError(f"checkpointing '{policy}': loss / grad norm off by {worst}")
        out["dit"].append(row)
    arch_n = dataclasses.replace(arch, checkpoint_activations=True, remat_policy="nothing")
    out["dit_64x1024"] = add(train_updates(dev, "DiT", arch_n, params,
                                           train_batch(64, 1024, "F5TTS_v1_Base"), 1,
                                           dit_update_launches(arch.depth, "nothing"),
                                           "DiT, checkpointing 'nothing'", gpu))
    out["bf16_state"] = add(train_updates(dev, "DiT", arch, params,
                                          train_batch(16, 1024, "F5TTS_v1_Base"), 2,
                                          dit_update_launches(arch.depth), "DiT, bf16_state",
                                          gpu, state_dtype=torch.bfloat16))
    sb = out["bf16_state"]["state_bytes"]
    n_params = sb["params"] // 4
    log(f"  bf16_state: params {sb['params'] / 1e9:.3f} GB f32, mu / nu / EMA "
        f"{sb['mu'] / 1e9:.3f} / {sb['nu'] / 1e9:.3f} / {sb['ema'] / 1e9:.3f} GB in bf16 "
        f"({n_params} parameters; f32 state {16 * n_params / 1e9:.3f} GB, saved "
        f"{(16 * n_params - sum(sb.values())) / 1e9:.3f} GB)")
    if not sb["mu"] == sb["nu"] == sb["ema"] == 2 * n_params:
        raise AssertionError(f"bf16_state: state bytes {sb}")
    del params
    torch.cuda.empty_cache()
    for model, backbone, expect in (
            ("E2TTS_Base", "UNetT", {"fused_qkv_rope_attention_lse": 48,
                                     "fused_qkv_rope_attention_bwd": 24, "rms_norm": 97,
                                     "conv_pos_embedding": 1}),
            ("MMDiT_Base", "MMDiT", {"fused_qkv_rope_attention_bias_lse": 43,
                                     "fused_qkv_rope_attention_bias_bwd": 22, "adaln_norm": 172,
                                     "conv_pos_embedding": 1})):
        arch_b, params_b, _ = base_models(model=model, checkpoint_activations=True,
                                          remat_policy="nothing")
        out[model] = add(train_updates(dev, backbone, arch_b, params_b, train_batch(16, 1024, model),
                                       2, expect, f"{model}, checkpointing 'nothing'", gpu))
        del params_b
        torch.cuda.empty_cache()
    return ran, out


# (label, preset, arch overrides, fuse_qkv, launches an update, the depth-2
# check's frames and launches)
NEW_TRAIN_CONFIGS = (
    ("F5TTS_v1_Small", "F5TTS_v1_Small", {}, True,
     {"fused_qkv_rope_attention_lse": 18, "fused_qkv_rope_attention_bwd": 18, "adaln_norm": 37,
      "grouped_conv1d": 2},
     (512, {"fused_qkv_rope_attention_lse": 2, "fused_qkv_rope_attention_bwd": 2,
            "adaln_norm": 5, "grouped_conv1d": 2})),
    ("F5TTS_v1_Base qk-norm", "F5TTS_v1_Base", {"qk_norm": "rms_norm"}, True,
     {"flash_attention_lse": 22, "flash_attention_bwd": 22, "rms_norm": 44, "adaln_norm": 45,
      "conv_pos_embedding": 1},
     (512, {"flash_attention_lse": 2, "flash_attention_bwd": 2, "rms_norm": 4,
            "adaln_norm": 5, "conv_pos_embedding": 1})),
    ("E2TTS_Base qk-norm", "E2TTS_Base", {"qk_norm": "rms_norm"}, True,
     {"flash_attention_lse": 24, "flash_attention_bwd": 24, "rms_norm": 97,
      "conv_pos_embedding": 1},
     (1023, {"flash_attention_lse": 2, "flash_attention_bwd": 2, "rms_norm": 9,
             "conv_pos_embedding": 1})),
    ("MMDiT_Base qk-norm", "MMDiT_Base", {"qk_norm": "rms_norm"}, True,
     {"masked_flash_attention": 22, "rms_norm": 88, "adaln_norm": 88, "conv_pos_embedding": 1},
     (512, {"masked_flash_attention": 2, "rms_norm": 8, "adaln_norm": 8,
            "conv_pos_embedding": 1})),
    ("F5TTS_v1_Base fuse_qkv=False", "F5TTS_v1_Base", {}, False,
     {"flash_attention_lse": 22, "flash_attention_bwd": 22, "adaln_norm": 45,
      "conv_pos_embedding": 1},
     (512, {"flash_attention_lse": 2, "flash_attention_bwd": 2, "adaln_norm": 5,
            "conv_pos_embedding": 1})),
)


def phase19_new_training(dev, gpu: str) -> tuple[dict, list]:
    """(d) Training of the Small preset, the qk-norm DiT / UNetT / MMDiT and
    the unfused-QKV DiT: 3 updates at 16 x 1024 (and the qk-norm DiT at
    4 x 4096), then each at depth 2 card bf16 against CPU f32 (phase 6)."""
    import torch
    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.scripts.common import base_models

    ran: dict[str, int] = {}
    rows = []
    for label, model, over, fuse, expect, (n2, expect2) in NEW_TRAIN_CONFIGS:
        backbone = PRESETS[model].backbone
        arch, params, _ = base_models(model=model, **over)
        cells = [(16, 1024, 3)] + ([(4, 4096, 1)] if label == "F5TTS_v1_Base qk-norm" else [])
        for b, n, updates in cells:
            row = train_updates(dev, backbone, arch, params, train_batch(b, n, model), updates,
                                expect, label, gpu, fuse_qkv=fuse)
            for k, c in row.pop("ran").items():
                ran[k] = ran.get(k, 0) + c
            rows.append(row)
        del params
        torch.cuda.empty_cache()
        arch2, params2, _ = base_models(model=model, depth=2, **over)
        phase_train_card_vs_cpu(dev, arch2, params2, backbone, n2, expect2, fuse_qkv=fuse)
    return ran, rows


def phase_arch_flags(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 19. Returns (the launches the card ran on these paths, the numbers)."""
    import torch

    launches: dict[str, int] = {}
    out = {}
    for part, fn in (("inference_flags", phase19_inference_flags),
                     ("importer", phase19_importer),
                     ("checkpointing", phase19_checkpointing),
                     ("new_training", phase19_new_training)):
        t0 = time.perf_counter()
        ran, out[part] = fn(dev, gpu)
        for k, c in ran.items():
            launches[k] = launches.get(k, 0) + c
        log(f"  phase 19 {part}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phases 5, 6, 10, 11 and 12
# ---------------------------------------------------------------------------

def _train_dataset(rng, b: int, n: int, frames_per_char: int = 4):
    """b rows of mel with lens in [n/2, n] (the longest exactly n) and char
    text of ceil(frames / frames_per_char) characters."""
    from f5tts_tpu_torch.scripts.common import VOCAB
    from f5tts_tpu_torch.train.dataset import InMemoryDataset

    lens = rng.integers(n // 2, n + 1, b)
    lens[0] = n
    chars = np.array(list(VOCAB))
    mels = [rng.standard_normal((int(t), 100)).astype(np.float32) for t in lens]
    texts = ["".join(rng.choice(chars, size=-(-int(t) // frames_per_char))) for t in lens]
    return InMemoryDataset(mels, texts), int(lens.sum())


def phase_train(dev, arch, params, gpu: str, backbone: str = "DiT", cells=DIT_TRAIN_CELLS,
                frames_per_char: int = 4) -> dict:
    """Trainer.train on each (batch, frames, updates, launches an update)
    cell; returns the summed launches."""
    import shutil
    import tempfile

    import torch
    from f5tts_tpu_torch.config import TrainConfig
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import VOCAB
    from f5tts_tpu_torch.train.step import ema_alpha
    from f5tts_tpu_torch.train.trainer import Trainer

    bdef = BACKBONES[backbone]
    rng = np.random.default_rng(11)
    total: dict[str, int] = {}
    base = tree_leaves(params)
    for b, n, updates, per_update in cells:
        data, live = _train_dataset(rng, b, n, frames_per_char)
        save_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        # one batch of all b rows an epoch; the EMA copies at update 2 and
        # decays at update 4 (every 2, after 2)
        cfg = TrainConfig(batch_size_per_device=b * n, max_samples=b, epochs=updates + 1,
                          num_warmup_updates=2, ema_update_every=2, ema_update_after_step=2,
                          save_dir=save_dir, save_per_updates=10 ** 9, last_per_updates=10 ** 9,
                          logger=None)
        trainer = Trainer(params, bdef.statics_cls(arch), cfg, backbone=bdef,
                          vocab_char_map=VOCAB, tokenizer="char", device=dev)
        leaf = lambda tree: tree["proj_out"]["b"].detach().float().cpu().clone()  # noqa: E731
        emas, ps, rows = [leaf(trainer.state.ema)], [leaf(trainer.state.params)], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t_last = [time.perf_counter()]

        def on_update(update, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            counts = _build.launches()
            _build.reset_launches()
            rows.append({"update": update, "wall_ms": (now - t_last[0]) * 1e3,
                         "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                         "launches": counts})
            emas.append(leaf(trainer.state.ema))
            ps.append(leaf(trainer.state.params))
            t_last[0] = time.perf_counter()

        _build.reset_launches()  # every count to 0 just before the training run
        trainer.train(data, max_updates=updates, on_update=on_update)
        ckpt_s = time.perf_counter() - t_last[0]  # the heartbeat written at the end
        ckpt_gb = sum(f.stat().st_size for f in Path(save_dir).rglob("*.pt")) / 1e9
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        steady = [r["wall_ms"] for r in rows[1:]] or [rows[0]["wall_ms"]]
        ms = statistics.median(steady)
        for r in rows:
            log(f"  {backbone} b={b} n={n} update {r['update']}: loss {r['loss']:.5f}, grad norm "
                f"{r['grad_norm']:.4f}, wall {r['wall_ms']:.1f} ms, launches {r['launches']}")
        log(f"  {backbone} b={b} n={n} ({live} live frames): {ms:.1f} ms/step (median of updates "
            f"2..), {b * n / ms * 1e3:.0f} frames/s padded, {live / ms * 1e3:.0f} live, peak "
            f"{peak:.2f} GB allocated, heartbeat checkpoint {ckpt_gb:.2f} GB in {ckpt_s:.1f} s "
            f"[{gpu}]")
        for r in rows:
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"{backbone} b={b} n={n} update {r['update']}: non-finite "
                                     f"loss or grad norm")
            if r["launches"] != per_update:
                raise AssertionError(f"{backbone} b={b} n={n} update {r['update']}: launches "
                                     f"{r['launches']}, expected {per_update}")
            for k, c in r["launches"].items():
                total[k] = total.get(k, 0) + c
        unchanged = [i for i, (a, p0) in enumerate(zip(tree_leaves(trainer.state.params), base))
                     if torch.equal(a.cpu(), p0)]
        if unchanged:
            raise AssertionError(f"{backbone} b={b} n={n}: {len(unchanged)} parameter leaves "
                                 f"did not change")
        for u in range(1, updates + 1):
            alpha = ema_alpha(u, cfg.ema_decay, cfg.ema_update_every, cfg.ema_update_after_step)
            want = emas[u - 1] * float(alpha) + ps[u] * float(np.float32(1.0) - alpha)
            if not torch.allclose(emas[u], want, rtol=1e-6, atol=1e-7):
                raise AssertionError(f"{backbone} b={b} n={n}: the EMA is off its cadence at "
                                     f"update {u}")
        del trainer
        shutil.rmtree(save_dir)
        torch.cuda.empty_cache()
    return total


def phase_train_card_vs_cpu(dev, arch, params, backbone: str = "DiT", n: int = 512,
                            expect=None, flat_max=None, fuse_qkv: bool = True) -> None:
    """One depth-2 grad step, the same draws, on the card in bf16 (the
    kernels, `expect` launches) and the CPU in f32 (the plain versions).
    `flat_max` lowers modules.FLAT_ATTN_MAX_N for the run (the head-layout
    gate of the UNetT at n rows); `fuse_qkv` False trains the unfused
    projections."""
    import torch
    from f5tts_tpu_torch.models import modules
    from f5tts_tpu_torch.models.cfm import BACKBONES, make_draws
    from f5tts_tpu_torch.models.modules import tree_cast, tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train.step import make_optimizer, make_train_step

    bdef = BACKBONES[backbone]
    arch2 = dataclasses.replace(arch, depth=2)
    p2 = cut_to_depth_2(backbone, params)
    expect = expect or {"fused_qkv_rope_attention_lse": 2, "fused_qkv_rope_attention_bwd": 2,
                        "adaln_norm": 5, "conv_pos_embedding": 1}
    b = 4
    rng = np.random.default_rng(12)
    mel = torch.from_numpy(rng.standard_normal((b, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(1, 96, (b, 128)).astype(np.int32))
    lens = torch.tensor([n, n * 25 // 32, n * 19 // 32, n * 7 // 8], dtype=torch.int32)
    draws = make_draws(torch.Generator().manual_seed(5), b, n, 100)
    gate = modules.FLAT_ATTN_MAX_N
    if flat_max is not None:
        modules.FLAT_ATTN_MAX_N = flat_max
    out = {}
    try:
        for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
            step = make_train_step(bdef.statics_cls(arch2, where), make_optimizer(7.5e-5, 10, 100),
                                   dtype=dtype, backbone=bdef, fuse_qkv=fuse_qkv)
            _build.reset_launches()
            t0 = time.perf_counter()
            loss, grads = step.grad_step(tree_cast(p2, torch.float32, where), mel.to(where),
                                         text.to(where), lens.to(where), draws=draws)
            out[where.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)])
            log(f"  {backbone} {where.type} {str(dtype)[6:]}: depth 2, b {b}, n {n}: loss "
                f"{float(loss):.6f}, {time.perf_counter() - t0:.2f} s, launches {_build.launches()}")
            if where.type == "cuda" and _build.launches() != expect:
                raise AssertionError(f"{backbone} depth-2 training step launches "
                                     f"{_build.launches()}, expected {expect}")
    finally:
        modules.FLAT_ATTN_MAX_N = gate
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    rels = [float((a - w).norm() / w.norm()) for a, w in zip(ga, gb) if float(w.norm()) > 0]
    loss_rel = abs(la - lb) / abs(lb)
    log(f"  {backbone} card bf16 vs cpu f32: loss rel {loss_rel:.3e} (tol 2e-2), gradient rel-L2 "
        f"over {len(rels)} leaves: median {statistics.median(rels):.3e}, max {max(rels):.3e} "
        f"(tol 1e-1)")
    if not (loss_rel <= 2e-2 and max(rels) <= 1e-1):
        raise AssertionError(f"{backbone} training step: card bf16 and cpu f32 disagree")


# ---------------------------------------------------------------------------
# phase 20
# ---------------------------------------------------------------------------

SERVE_WARM_BUCKETS = (512, 1024)
SERVE_WARM_BATCHES = (1, 2, 4)
SERVE_GRAPH_TOL = 1e-3 * 32767   # graphed against eager, int16 max-abs where not bit-equal
SERVE_ROW_REL_TOL = 3e-2         # a batch row against the same request alone, wav rel-L2
# three texts whose ids (with REF_TEXT) share one 64-id bucket, three
# references in one 128-frame wav bucket, totals in the 1024 bucket
SERVE_TEXTS = (
    "I have been here for billions of years, and I will be here long after you are gone.",
    "Every morning the light returns, and the birds begin again. The day is long and bright.",
    "The river keeps its course through the valley, carrying the snow down to the sea.",
)
SERVE_REF_SECS = (2.0, 2.3, 2.6)
SERVE_TOTALS = (900, 950, 1000)


def serve_requests(ref) -> list[dict]:
    from f5tts_tpu_torch.scripts.common import REF_TEXT

    return [{"ref_wav": ref[:int(secs * 24000)], "ref_text": REF_TEXT + " ", "gen_text": text,
             "fix_duration": (total + 0.5) * 256 / 24000}
            for secs, text, total in zip(SERVE_REF_SECS, SERVE_TEXTS, SERVE_TOTALS)]


def serve_ran(pipe, host: dict, before: dict) -> dict:
    """The launches of the serve path since `before` ({key: replays} of
    `pipe.serve_graphs`): the host counter's and each replay's counts."""
    ran = dict(host)
    for key, entry in pipe.serve_graphs.items():
        for name, c in entry.counts.items():
            ran[name] = ran.get(name, 0) + c * (entry.replays - before.get(key, 0))
    return ran


def check_captures(pipe, expect: dict, what: str) -> None:
    for key, entry in pipe.serve_graphs.items():
        if entry.counts != expect:
            raise AssertionError(f"{what}: the capture of {key} recorded {entry.counts}, "
                                 f"expected {expect}")


def serve_graphed_vs_eager(pipe, pending, expect: dict, gpu: str, what: str) -> tuple:
    """Finalize `pending` and compare its live samples with the eager serve
    body on the same static inputs (the replay's key, before any other
    batch): bit-equal or int16 max-abs <= SERVE_GRAPH_TOL."""
    import torch

    meta = pending[1]
    waves = pipe.finalize_batch(pending)
    key = (*meta[4], pipe.sampling.nfe_steps)
    entry = pipe.serve_graphs[key]
    if entry.counts != expect:
        raise AssertionError(f"{what} {key}: capture counts {entry.counts}, expected {expect}")
    eager = pipe._serve_body(entry.inputs)[1].cpu().numpy()
    torch.cuda.synchronize()
    worst, equal = 0.0, True
    for i, w in enumerate(waves):
        lo, hi = meta[0][i] * pipe.hop, min(int(meta[1][i]), meta[2]) * pipe.hop
        got = np.round(w * 32767).astype(np.int32)
        want = eager[i, lo:hi].astype(np.int32)
        if got.shape != want.shape or not np.isfinite(w).all():
            raise AssertionError(f"{what}: row {i} has {got.shape} samples, eager {want.shape}")
        d = float(np.abs(got - want).max()) if got.size else 0.0
        equal &= d == 0.0
        worst = max(worst, d)
    log(f"  {what} {key}: graphed against the eager serve body "
        f"{'bit-equal' if equal else f'int16 max-abs {worst:.0f}'} over {len(waves)} rows "
        f"(tol {SERVE_GRAPH_TOL:.1f}); capture {entry.capture_s:.2f} s, pool "
        f"{entry.pool_bytes / 2**20:.1f} MiB [{gpu}]")
    if worst > SERVE_GRAPH_TOL:
        raise AssertionError(f"{what}: graphed against eager int16 max-abs {worst}")
    return waves, {"key": list(key), "bit_equal": equal, "int16_max_abs": worst}


def serve_warmup(pipe, gpu: str) -> dict:
    """(a) `serve.warmup` over SERVE_WARM_BUCKETS x SERVE_WARM_BATCHES: each
    key's capture seconds and pool, their sum and memory_reserved."""
    import torch
    from f5tts_tpu_torch.infer import serve

    t0 = time.perf_counter()
    rows = serve.warmup(pipe, list(SERVE_WARM_BUCKETS), list(SERVE_WARM_BATCHES))
    wall = time.perf_counter() - t0
    for row in rows:
        log(f"  warm-up key {row['key']}: {row['seconds']:.2f} s, capture "
            f"{row['capture_s']:.2f} s, pool {row['pool_bytes'] / 2**20:.1f} MiB [{gpu}]")
    pools = sum(r["pool_bytes"] for r in rows)
    log(f"  warm-up: {len(rows)} keys in {wall:.2f} s, pools {pools / 2**20:.1f} MiB, "
        f"memory_reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB [{gpu}]")
    if len(rows) != len(SERVE_WARM_BUCKETS) * len(SERVE_WARM_BATCHES) or \
            any("key" not in r for r in rows):
        raise AssertionError(f"warm-up: {rows}")
    return {"keys": rows, "wall_s": wall, "pools_mib": pools / 2**20}


def serve_rows_alone(pipe, reqs, batch_waves, gpu: str) -> list[dict]:
    """(c) Each row of the batch against the same request through
    generate_batch at b = 1, in the same n, wav and text buckets: wav rel-L2
    over the row's live samples <= SERVE_ROW_REL_TOL."""
    out = []
    # rows do not leak into each other: row 0 beside other requests equals
    # row 0 beside copies of itself in the same key, bit for bit
    beside_itself = pipe.generate_batch([reqs[0]] * len(reqs))[0]
    if not np.array_equal(beside_itself, batch_waves[0]):
        raise AssertionError("row 0 differs beside other requests and beside itself")
    log(f"  row 0 beside the other requests = row 0 beside copies of itself, bit for bit [{gpu}]")
    for i, (req, row) in enumerate(zip(reqs, batch_waves)):
        handle, meta = pipe.generate_batch_async([req])
        alone = pipe.finalize_batch((handle, meta))[0]
        if alone.shape != row.shape:
            raise AssertionError(f"row {i}: {row.shape} samples in the batch, {alone.shape} alone")
        rel = float(np.linalg.norm(row - alone) / max(np.linalg.norm(alone), 1e-12))
        equal = bool(np.array_equal(row, alone))
        log(f"  row {i} against the request alone (key {meta[4]}): wav rel-L2 {rel:.3e}"
            f"{' (bit-equal)' if equal else ''} (tol {SERVE_ROW_REL_TOL}) [{gpu}]")
        if not rel <= SERVE_ROW_REL_TOL:
            raise AssertionError(f"row {i}: rel-L2 {rel} against the request alone")
        out.append({"row": i, "wav_rel_l2": rel, "bit_equal": equal, "key": list(meta[4])})
    return out


def serve_bench_in_process(pipe, gpu: str) -> dict:
    """(d) eval/serve_bench.py's main on this pipeline: 16 requests at
    concurrency 4, a 1 ms window, 4 streams; zero errors and no cold shape
    after its warm-up."""
    import contextlib
    import io

    from f5tts_tpu_torch.eval import serve_bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = serve_bench.main(["--requests", "16", "--concurrency", "4", "--window_ms", "1",
                                 "--stream", "4"], pipe=pipe)
    extra = line["extra"]
    stats = extra["server_stats"]
    log(f"  serve_bench: RTF {line['value']}, latency p50 {extra['latency_p50_ms']} ms / p99 "
        f"{extra['latency_p99_ms']} ms, occupancy {stats['batch_occupancy']}, execute p50 "
        f"{stats['exec_p50_ms']} ms, queue delay p50 {stats['queue_delay_p50_ms']} ms; "
        f"TTFB p50 {extra['ttfb_p50_ms']} ms / p90 {extra['ttfb_p90_ms']} ms on the fine "
        f"first-chunk bucket, stream cold shapes "
        f"{extra['stream_server_stats']['cold_shape_events']} [{gpu}]")
    log(f"  serve_bench line: {json.dumps(line)}")
    if extra["errors"] or extra["requests"] != 16 or stats["error_count"]:
        raise AssertionError(f"serve_bench: {extra['errors']} errors, {extra['requests']} served")
    if stats["cold_shape_events"]:
        raise AssertionError(f"serve_bench: cold shapes after its warm-up "
                             f"{stats['cold_shape_events']}")
    if extra["stream_requests"] != 4 or extra["stream_server_stats"]["error_count"]:
        raise AssertionError("serve_bench: a stream failed")
    return line


def serve_capture_while_serving(pipe, ref, gpu: str) -> dict:
    """(e) A fine_autowarm capture runs in the background while a
    DynamicBatcher serves 12 requests from 4 clients in warm keys; no error,
    and each served wav bit-equal to the same request served afterwards."""
    import threading

    from f5tts_tpu_torch.infer.serve import DynamicBatcher

    reqs = serve_requests(ref)
    fine = dict(reqs[0], fix_duration=(600 + 0.5) * 256 / 24000, fine_bucket=True)
    pipe.generate_batch([dict(fine, fine_bucket=False)])  # its coarse key (768), warm
    pipe.fine_autowarm = True
    batcher = DynamicBatcher(pipe, max_batch_size=1, max_queue_delay_s=0.001)
    served, errors = {}, []
    before = {key: e.replays for key, e in pipe.serve_graphs.items()}

    def client(j):
        for k in range(3):
            i = (j + k) % 3
            try:
                served[(j, k)] = (i, batcher.submit(reqs[i], timeout=300))
            except Exception as e:  # noqa: BLE001 - counted as a failure below
                errors.append(f"{type(e).__name__}: {e}")

    try:
        coarse = batcher.submit(fine, timeout=300)  # the gate is shut: coarse, warm starts
        threads = [threading.Thread(target=client, args=(j,)) for j in range(4)]
        for t in threads:
            t.start()
        replays_during = 0
        while pipe._fine_warms_inflight:
            time.sleep(0.005)
            replays_during = sum(e.replays - before.get(k, 0)
                                 for k, e in list(pipe.serve_graphs.items()))
        for t in threads:
            t.join(600)
    finally:
        batcher.close()
        pipe.fine_autowarm = False
    fine_keys = [k for k in pipe.serve_graphs if k[3] == 640]
    if errors or len(served) != 12 or not fine_keys:
        raise AssertionError(f"capture during serving: errors {errors}, {len(served)} served, "
                             f"fine keys {fine_keys}")
    again = [pipe.generate_batch([r])[0] for r in reqs]
    unequal = [jk for jk, (i, w) in served.items() if not np.array_equal(w, again[i])]
    coarse_again = pipe.generate_batch([dict(fine, fine_bucket=False)])[0]
    if unequal or not np.array_equal(coarse, coarse_again):
        raise AssertionError(f"capture during serving: served wavs differ afterwards: {unequal}")
    entry = pipe.serve_graphs[fine_keys[0]]
    log(f"  capture during serving: fine key {fine_keys[0]} captured in {entry.capture_s:.2f} s "
        f"while the batcher served (replays by then {replays_during}); 12 + 1 served, each "
        f"bit-equal to the same request afterwards [{gpu}]")
    return {"fine_key": list(fine_keys[0]), "capture_s": entry.capture_s,
            "replays_while_capturing": replays_during}


def serve_other_backbones(dev, ref, gpu: str) -> tuple[dict, list]:
    """(f) One b = 2 serve batch at E2TTS_Base and MMDiT_Base cut to depth 2:
    graphed against the eager body, exact launches."""
    import torch
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import base_models

    launches, rows = {}, []
    for model, backbone in (("E2TTS_Base", "UNetT"), ("MMDiT_Base", "MMDiT")):
        arch, params, vocos_params = base_models(model=model, depth=2)
        pipe = make_pipeline(dev, backbone, arch, params, vocos_params)
        expect = generate_launches(backbone, arch)
        torch.cuda.synchronize()
        _build.reset_launches()
        pending = pipe.generate_batch_async(serve_requests(ref)[:2])
        _, row = serve_graphed_vs_eager(pipe, pending, expect, gpu, f"{model} depth 2")
        torch.cuda.synchronize()
        host = _build.launches()
        if host != {k: 2 * v for k, v in expect.items()}:  # the warm-up and the eager body
            raise AssertionError(f"{model}: host launches {host}, expected twice {expect}")
        for name, c in serve_ran(pipe, host, {}).items():
            launches[name] = launches.get(name, 0) + c
        rows.append({"model": model, **row})
        del pipe, params
        torch.cuda.empty_cache()
    return launches, rows


def phase_serving(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 20: batched serving at F5TTS_v1_Base + Vocos, bf16, pinyin."""
    import torch
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import base_models, synthetic_ref_wav
    from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, list_str_to_idx, load_vocab

    t_phase = time.perf_counter()
    vocab = load_vocab(EMILIA_VOCAB)
    arch, params, vocos_params = base_models()
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params, vocab_char_map=vocab,
                         tokenizer="pinyin")
    del params
    expect = generate_launches("DiT", arch)
    ref = synthetic_ref_wav(seconds=3.0)
    reqs = serve_requests(ref)
    texts = [r["ref_text"] + r["gen_text"] for r in reqs]
    if len({pipe.tokenize([t]).shape[1] for t in texts}) != 1:
        raise AssertionError("SERVE_TEXTS fall in different text buckets")
    ids = pipe.tokenize(texts[:1])
    want = list_str_to_idx(convert_char_to_pinyin(texts[:1]), vocab)
    if not np.array_equal(ids[:, :want.shape[1]], want):
        raise AssertionError("the serve path's ids differ from convert_char_to_pinyin's")
    torch.cuda.synchronize()
    _build.reset_launches()  # every count to 0 just before the serving path

    out = {"warmup": serve_warmup(pipe, gpu)}
    log("  (b) a batch of 3 (padded to 4) graphed against the eager serve body:")
    pending = pipe.generate_batch_async(reqs)
    waves, out["graphed_vs_eager"] = serve_graphed_vs_eager(pipe, pending, expect, gpu,
                                                            "F5TTS_v1_Base b=4")
    log("  (c) each row against the same request alone:")
    out["rows_alone"] = serve_rows_alone(pipe, reqs, waves, gpu)
    log("  (d) eval/serve_bench.py in-process:")
    out["serve_bench"] = serve_bench_in_process(pipe, gpu)
    log("  (e) a fine_autowarm capture while the batcher serves:")
    out["capture_while_serving"] = serve_capture_while_serving(pipe, ref, gpu)
    torch.cuda.synchronize()
    launches = serve_ran(pipe, _build.launches(), {})
    check_captures(pipe, expect, "phase 20")
    pools = {str(k): e.pool_bytes / 2**20 for k, e in pipe.serve_graphs.items()}
    log(f"  {len(pools)} serve graphs, pools MiB {json.dumps(pools)}, sum "
        f"{sum(pools.values()):.1f} MiB, memory_reserved "
        f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB; launches {launches} [{gpu}]")
    out["pools_mib"] = pools
    del pipe
    torch.cuda.empty_cache()
    log("  (f) E2TTS_Base and MMDiT_Base at depth 2, one b = 2 batch each:")
    more, out["other_backbones"] = serve_other_backbones(dev, ref, gpu)
    for name, c in more.items():
        launches[name] = launches.get(name, 0) + c
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 20: {out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 21
# ---------------------------------------------------------------------------

DATA_CLIPS = 24                 # (a): 2-11 s, half at 24 kHz, half at 16 kHz
BATCH_ROWS, BATCH_FRAMES = 16, 1024
CLIP_SAMPLES = (BATCH_FRAMES - 1) * 256   # 10.912 s at 24 kHz: 1024 frames
SAMPLE_LAUNCHES = {"fused_qkv_rope_attention": 22 * 32, "adaln_norm": 45 * 32,
                   "conv_pos_embedding": 2 * 32}   # a 32-NFE milestone sample
NEW_TOKENS = 8                  # (b): the vocab grown past Emilia's


def voiced_clip(samples: int, sr: int, seed: int) -> np.ndarray:
    """A seeded voiced-like clip: harmonics of a wobbling pitch and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    f0 = 120.0 + 10.0 * seed % 60 + 20.0 * np.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 8))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t) ** 2)
    return (0.1 * wav / np.abs(wav).max() + 0.003 * rng.standard_normal(samples)).astype(
        np.float32)


def pinyin_tokens(seconds: float, seed: int) -> list:
    """A prepared dataset's text: a pinyin token list, ~12 tokens a second."""
    from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin

    base = convert_char_to_pinyin(["今天天气很好，我们一起去公园散步。The weather is nice today, "
                                   "so we walk in the park."])[0]
    n = max(int(seconds * 12), 4)
    return [base[(seed + i) % len(base)] for i in range(n)]


def data_timing(rows_by_source: dict, root: str, device_ms: float, gpu: str) -> dict:
    """(a) One update's host data work (mel, resample, collate, tokenize)
    for the same 16-row batch from each source, the warm time of two,
    against the device step of (b)."""
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
    from f5tts_tpu_torch.train.dataset import CustomDataset, collate
    from f5tts_tpu_torch.train.trainer import tokenize

    vocab = load_vocab(EMILIA_VOCAB)
    out = {}
    for source, rows in rows_by_source.items():
        ds = CustomDataset(rows, preprocessed_mel=source == "preprocessed_mel", audio_root=root)
        walls, batch = [], None
        for _ in range(2):
            t0 = time.perf_counter()
            batch = collate([ds[i] for i in range(len(rows))])
            ids = tokenize(batch["text"], "pinyin", vocab)
            walls.append((time.perf_counter() - t0) * 1e3)
        if batch["mel"].shape != (BATCH_ROWS, BATCH_FRAMES, 100) or ids.shape[0] != BATCH_ROWS \
                or not np.isfinite(batch["mel"]).all():
            raise AssertionError(f"(a) {source}: batch {batch['mel'].shape}, ids {ids.shape}")
        out[source] = {"host_ms": walls[-1], "host_ms_first": walls[0],
                       "host_over_device": walls[-1] / device_ms}
        log(f"  (a) host data of one {BATCH_ROWS} x {BATCH_FRAMES} update from {source}: "
            f"{walls[-1]:.1f} ms (first {walls[0]:.1f}), {walls[-1] / device_ms:.2f}x the "
            f"device step's {device_ms:.1f} ms [{gpu}]")
    return out


def phase21_data(tmp: Path, gpu: str) -> tuple:
    """(a) 24 clips of 2-11 s, half at 16 kHz, through a CustomDataset over
    a list of dicts; the three 16-row sources of the timed batch."""
    from f5tts_tpu_torch.infer import audio_io
    from f5tts_tpu_torch.train.dataset import CustomDataset, DynamicBatchSampler, NumpyMel

    rng = np.random.default_rng(21)
    secs = rng.permutation(np.linspace(2.0, 11.0, DATA_CLIPS))
    rows = []
    for i, sec in enumerate(secs):
        sr = 24000 if i % 2 == 0 else 16000
        wav = voiced_clip(int(sec * sr), sr, i)
        audio_io.write_wav(str(tmp / f"clip{i}.wav"), wav, sr)
        rows.append({"audio_path": f"clip{i}.wav", "text": pinyin_tokens(sec, i),
                     "duration": len(wav) / sr})
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], audio_root=str(tmp))
    t0 = time.perf_counter()
    for i, row in enumerate(rows):
        s = ds[i]
        samples = int(round(row["duration"] * 24000))
        if s.mel.shape != (samples // 256 + 1, 100) or not np.isfinite(s.mel).all():
            raise AssertionError(f"(a) clip {i}: mel {s.mel.shape}, expected "
                                 f"{(samples // 256 + 1, 100)}")
        if (abs(ds.get_frame_len(i) - row["duration"] * 93.75) > 1e-6
                or ds.get_text(i) != row["text"]):
            raise AssertionError(f"(a) clip {i}: frame length or text")
    read_s = time.perf_counter() - t0
    batches = DynamicBatchSampler([ds.get_frame_len(i) for i in range(len(ds))], 4096,
                                  random_seed=666).batches
    log(f"  (a) {DATA_CLIPS} clips of {secs.min():.1f}-{secs.max():.1f} s (half at 16 kHz) "
        f"through a CustomDataset over a list of dicts: every mel as long as its audio, read "
        f"and converted in {read_s:.2f} s; {len(batches)} batches at 4096 frames [{gpu}]")
    # the timed batch: 16 clips of 1024 frames at 24 kHz, the same at 16 kHz,
    # and their mels preprocessed; the 24 kHz clips twice over are (b)'s data
    sources = {"wav_24k": [], "wav_16k": [], "preprocessed_mel": []}
    mel_fn = NumpyMel()
    for i in range(BATCH_ROWS):
        wav = voiced_clip(CLIP_SAMPLES, 24000, 100 + i)
        audio_io.write_wav(str(tmp / f"long{i}_24k.wav"), wav, 24000)
        audio_io.write_wav(str(tmp / f"long{i}_16k.wav"),
                           audio_io.resample(wav, 24000, 16000), 16000)
        text = pinyin_tokens(CLIP_SAMPLES / 24000, i)
        for source, path in (("wav_24k", f"long{i}_24k.wav"), ("wav_16k", f"long{i}_16k.wav")):
            sources[source].append({"audio_path": path, "text": text,
                                    "duration": CLIP_SAMPLES / 24000})
        sources["preprocessed_mel"].append({"mel_spec": mel_fn(audio_io.read_wav(
            str(tmp / f"long{i}_24k.wav"))[0]), "text": text, "duration": CLIP_SAMPLES / 24000})
    return {"clips": DATA_CLIPS, "read_s": read_s, "batches_4096": len(batches)}, sources


def phase21_finetune(dev, tmp: Path, vocab_dir: Path, ckpt: str, rows: list, vocos,
                     gpu: str) -> tuple:
    """(b) The finetune path from a reference safetensors with the vocab
    grown by NEW_TOKENS, 2 updates through Trainer with log_samples and the
    milestone at update 2; the milestone checkpoint restored."""
    import torch
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train import finetune_cli
    from f5tts_tpu_torch.train.checkpoint import CheckpointManager
    from f5tts_tpu_torch.train.dataset import CustomDataset

    save = tmp / "full"
    args = finetune_cli.parse_args([
        "--exp_name", "F5TTS_v1_Base", "--pretrain", ckpt, "--dataset_name", "smoke",
        "--data_root", str(vocab_dir), "--batch_size_per_gpu", str(BATCH_ROWS * BATCH_FRAMES),
        "--max_samples", str(BATCH_ROWS), "--max_updates", "2", "--save_per_updates", "2",
        "--num_warmup_updates", "2", "--logger", "none", "--save_dir", str(save)])
    t0 = time.perf_counter()
    vocab, vocab_size, _, arch, _, params = finetune_cli.setup(args)
    setup_s = time.perf_counter() - t0
    emb = params["text_embed"]["embed"]["w"]
    if vocab_size != 2545 + NEW_TOKENS or emb.shape[0] != vocab_size + 1 or emb[2546:].any():
        raise AssertionError(f"(b) vocab {vocab_size}, embedding {tuple(emb.shape)}: the "
                             f"{NEW_TOKENS} new rows must be exactly 0")
    ds = CustomDataset(rows, audio_root=str(tmp))
    updates, marks = [], {}

    def on_update(update, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        updates.append({"update": update, "wall_ms": (now - marks.get("t", t_train)) * 1e3,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]), "launches": _build.launches()})
        _build.reset_launches()
        marks["t"] = time.perf_counter()

    def sample_fn(ema, update):
        torch.cuda.synchronize()
        _build.reset_launches()  # the milestone sample's counts alone
        marks["sample"] = time.perf_counter()

    def vocoder(mel):
        wav = vocos(mel)
        torch.cuda.synchronize()
        marks["vocoded"] = time.perf_counter()
        return wav

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    _build.reset_launches()  # every count to 0 just before the finetune path
    t_train = time.perf_counter()
    out = finetune_cli.finetune(args, params, ds, vocab, device=dev, vocoder=vocoder,
                                log_samples=True, sample_fn=sample_fn, on_update=on_update)
    torch.cuda.synchronize()
    sample_ran = _build.launches()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 - before_gb
    trainer = out["trainer"]
    sample_s = marks["vocoded"] - marks["sample"]
    for r in updates:
        log(f"  (b) update {r['update']}: loss {r['loss']:.5f}, grad norm {r['grad_norm']:.4f}, "
            f"wall {r['wall_ms']:.1f} ms, launches {r['launches']}")
        if r["launches"] != _DIT_PER_UPDATE:
            raise AssertionError(f"(b) update {r['update']}: launches {r['launches']}, expected "
                                 f"{_DIT_PER_UPDATE}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError("(b) a non-finite loss or grad norm")
    if sample_ran != SAMPLE_LAUNCHES:
        raise AssertionError(f"(b) milestone sample launched {sample_ran}, expected "
                             f"{SAMPLE_LAUNCHES}")
    from f5tts_tpu_torch.infer import audio_io

    rms = {}
    for kind in ("gen", "ref"):
        wav, sr = audio_io.read_wav(str(save / "samples" / f"update_2_{kind}.wav"))
        rms[kind] = float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0
        if sr != 24000 or not (wav.size and np.isfinite(wav).all() and rms[kind] > 1e-4):
            raise AssertionError(f"(b) update_2_{kind}.wav is empty, non-finite or silent")
    t0 = time.perf_counter()
    restored = CheckpointManager(str(save)).restore(step=2, device=dev)
    restore_s = time.perf_counter() - t0
    differ = [name for name in ("params", "mu", "nu", "ema")
              if not all(torch.equal(a, b) for a, b in zip(
                  tree_leaves(getattr(restored, name)),
                  tree_leaves(getattr(trainer.state, name))))]
    if restored.step != 2 or differ:
        raise AssertionError(f"(b) the milestone checkpoint restores step {restored.step}, "
                             f"differs in {differ}")
    del restored
    step_ms = step_alone_ms(
        lambda mel, text, lens, gen: trainer.step_fn(trainer.state, mel, text, lens,
                                                     generator=gen),
        rows, str(tmp), dev, "(b)")
    ms = updates[-1]["wall_ms"]
    ref_frames = trainer._last_sample[0].shape[0]
    del out, trainer
    torch.cuda.empty_cache()
    log(f"  (b) F5TTS_v1_Base finetune from the reference safetensors (vocab {vocab_size}, "
        f"setup {setup_s:.2f} s): {ms:.1f} ms the second update with its data read on the fly, "
        f"{step_ms:.1f} ms the step alone, peak {peak:.2f} GB allocated above what was before; "
        f"the milestone sample (32 NFE, twice a {ref_frames}-frame reference) {sample_s:.2f} s, "
        f"launches {sample_ran}, wav rms gen {rms['gen']:.4f} / ref "
        f"{rms['ref']:.4f}; milestone checkpoint restored bit for bit in {restore_s:.2f} s "
        f"[{gpu}]")
    total = {}
    for r in updates:
        for k, c in r["launches"].items():
            total[k] = total.get(k, 0) + c
    for k, c in sample_ran.items():
        total[k] = total.get(k, 0) + c
    row = {"ms_per_update": ms, "step_ms": step_ms, "walls_ms": [r["wall_ms"] for r in updates],
           "peak_gb": peak,
           "sample_s": sample_s, "restore_s": restore_s, "setup_s": setup_s,
           "losses": [r["loss"] for r in updates]}
    return total, row, vocab, arch, params


def step_alone_ms(step, rows: list, root: str, dev, what: str) -> float:
    """The update without its data: `step(mel, text, lens, generator)` twice
    on one pre-collated 16-row batch, each launching one update's kernels;
    the wall of the second (its host launches included)."""
    import torch
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
    from f5tts_tpu_torch.train.dataset import CustomDataset, collate
    from f5tts_tpu_torch.train.trainer import tokenize

    ds = CustomDataset(rows[:BATCH_ROWS], audio_root=root)
    batch = collate([ds[i] for i in range(BATCH_ROWS)])
    mel, text, lens = (torch.from_numpy(a).to(dev) for a in (
        batch["mel"], tokenize(batch["text"], "pinyin", load_vocab(EMILIA_VOCAB)),
        batch["mel_lengths"]))
    walls = []
    for i in range(2):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        step(mel, text, lens, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if _build.launches() != _DIT_PER_UPDATE:
            raise AssertionError(f"{what}: a step alone launched {_build.launches()}")
    log(f"  {what} the step alone on one pre-collated {BATCH_ROWS} x {BATCH_FRAMES} batch "
        f"{walls[1]:.1f} ms (first {walls[0]:.1f})")
    return walls[1]


def phase21_train_cli(dev, tmp: Path, vocab_dir: Path, arch, params, rows: list,
                      gpu: str) -> tuple:
    """train_cli.train on a config dict in the reference YAML layout (no
    PyYAML on the card) for `arch`: one update."""
    import torch
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train import train_cli
    from f5tts_tpu_torch.train.dataset import CustomDataset

    keys = ("dim", "depth", "heads", "ff_mult", "text_dim", "text_mask_padding", "conv_layers",
            "pe_attn_head")
    raw = {"model": {"name": "F5TTS_v1_Base", "tokenizer": "pinyin", "backbone": "DiT",
                     "arch": {k: getattr(arch, k) for k in keys}},
           "datasets": {"name": "smoke", "batch_size_per_gpu": BATCH_ROWS * BATCH_FRAMES,
                        "max_samples": BATCH_ROWS},
           "optim": {"num_warmup_updates": 2},
           "ckpts": {"logger": None, "save_dir": str(tmp / "cli"), "save_per_updates": 10 ** 9,
                     "last_per_updates": 10 ** 9}}
    ran = []

    def on_update(update, metrics):
        torch.cuda.synchronize()
        ran.append((_build.launches(), float(metrics["loss"])))

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer, _ = train_cli.train(raw, CustomDataset(rows, audio_root=str(tmp)), max_updates=1,
                                 data_root=str(vocab_dir), device=dev, params=params,
                                 on_update=on_update)
    wall = time.perf_counter() - t0
    (counts, loss), = ran
    log(f"  train_cli.train: 1 update, loss {loss:.5f}, launches {counts}, {wall:.2f} s with the "
        f"state's set-up and its heartbeat checkpoint [{gpu}]")
    if counts != _DIT_PER_UPDATE or not np.isfinite(loss) or trainer.state.step != 1:
        raise AssertionError(f"train_cli.train: launches {counts}, loss {loss}")
    del trainer
    torch.cuda.empty_cache()
    return counts, {"wall_s": wall, "loss": loss}


def phase21_lora(dev, tmp: Path, vocab_dir: Path, ckpt: str, rows: list, params, vocab, arch,
                 vocos_params, gpu: str) -> tuple:
    """(c) rank 8, alpha 16, 3 updates through the LoRA step from the same
    base; the merged weights served in bf16 and int8."""
    import torch
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REQUESTS
    from f5tts_tpu_torch.train import finetune_cli
    from f5tts_tpu_torch.train.dataset import CustomDataset
    from f5tts_tpu_torch.train.lora import LoRAConfig, init_lora, load_lora, merge_for_serving

    save = tmp / "lora"
    args = finetune_cli.parse_args([
        "--exp_name", "F5TTS_v1_Base", "--pretrain", ckpt, "--dataset_name", "smoke",
        "--data_root", str(vocab_dir), "--batch_size_per_gpu", str(BATCH_ROWS * BATCH_FRAMES),
        "--max_samples", str(BATCH_ROWS), "--max_updates", "3", "--save_per_updates", "3",
        "--lora", "--lora_rank", "8", "--lora_alpha", "16", "--logger", "none",
        "--save_dir", str(save)])
    updates, marks = [], {}

    def on_update(update, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        updates.append({"update": update, "wall_ms": (now - marks.get("t", t_train)) * 1e3,
                        "loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]), "launches": _build.launches()})
        _build.reset_launches()
        marks["t"] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    _build.reset_launches()  # every count to 0 just before the LoRA path
    t_train = time.perf_counter()
    out = finetune_cli.finetune(args, params, CustomDataset(rows, audio_root=str(tmp)), vocab,
                                device=dev, on_update=on_update)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 - before_gb
    lora, step = out["lora"], out["step"]
    total = {}
    for r in updates:
        log(f"  (c) LoRA update {r['update']}: loss {r['loss']:.5f}, grad norm "
            f"{r['grad_norm']:.4f}, wall {r['wall_ms']:.1f} ms, launches {r['launches']}")
        if r["launches"] != _DIT_PER_UPDATE or not np.isfinite(r["loss"]):
            raise AssertionError(f"(c) LoRA update {r['update']}: launches {r['launches']}, "
                                 f"loss {r['loss']}")
        for k, c in r["launches"].items():
            total[k] = total.get(k, 0) + c
    init = init_lora(torch.Generator(device=dev).manual_seed(1), step.base, LoRAConfig(8, 16.0))
    still = [f"{g}.{n}.{k}" for g, sub in lora.items() for n, ab in sub.items() for k in ab
             if torch.equal(ab[k], init[g][n][k])]
    if still:
        raise AssertionError(f"(c) adapters that did not change: {still}")
    base_changed = [i for i, (a, b) in enumerate(zip(tree_leaves(step.base),
                                                     tree_leaves(params)))
                    if not torch.equal(a, b.to(dev))]
    if base_changed:
        raise AssertionError(f"(c) {len(base_changed)} base tensors changed under LoRA")
    back = load_lora(str(save / "lora_3.pkl"), device=dev)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(lora))):
        raise AssertionError("(c) the adapter pickle does not round-trip bit for bit")
    opt = out["opt_state"]
    step_ms = step_alone_ms(lambda mel, text, lens, gen: step(lora, opt, mel, text, lens,
                                                              generator=gen),
                            rows, str(tmp), dev, "(c)")
    n_adapter = sum(t.numel() for t in tree_leaves(lora))
    ms = statistics.median(r["wall_ms"] for r in updates[1:])
    log(f"  (c) LoRA rank 8, alpha 16: {n_adapter} adapter parameters, {ms:.1f} ms an update "
        f"with its data (median of updates 2-3), {step_ms:.1f} ms the step alone, peak "
        f"{peak:.2f} GB allocated above what was before; base bit-unchanged, every "
        f"adapter moved, lora_3.pkl round-trips bit for bit [{gpu}]")
    t0 = time.perf_counter()
    merged = merge_for_serving(step.base, lora, LoRAConfig(8, 16.0))
    q = merge_for_serving(step.base, lora, LoRAConfig(8, 16.0), quantization="int8")
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    if not all("w_i8" in blk[g][n] for blk in q["blocks"]
               for g, n in (("attn", "to_qkv"), ("attn", "to_out"), ("ff", "in"), ("ff", "out"))):
        raise AssertionError("(c) merge_for_serving(int8) left a projection unquantized")
    del q, out, step
    served = {}
    for quant in ("none", "int8"):
        pipe = make_pipeline(dev, "DiT", arch, merged, vocos_params, vocab_char_map=vocab,
                             tokenizer="pinyin", quantization=quant)
        expect = generate_launches("DiT", arch, int8=quant == "int8")
        log(f"  (c) the merged weights served, quantization {quant}:")
        for k, c in run_requests(pipe, [(REQUESTS[0], 1014, expect)], gpu).items():
            total[k] = total.get(k, 0) + c
            served[k] = served.get(k, 0) + c
        del pipe
        torch.cuda.empty_cache()
    return total, {"ms_per_update": ms, "step_ms": step_ms,
                   "walls_ms": [r["wall_ms"] for r in updates],
                   "peak_gb": peak, "adapter_params": n_adapter, "merge_s": merge_s,
                   "losses": [r["loss"] for r in updates]}, lora


def phase21_depth2(dev, arch, params) -> None:
    """(d) LoRA loss and adapter gradients at depth 2, card bf16 against CPU
    f32 on the same weights, adapters and draws (phase 6's tolerances)."""
    import torch
    from f5tts_tpu_torch.models.cfm import make_draws
    from f5tts_tpu_torch.models.dit import DiTStatics
    from f5tts_tpu_torch.models.modules import tree_cast, tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train.lora import AdamWHParams, LoRAConfig, init_lora, make_lora_train_step

    arch2 = dataclasses.replace(arch, depth=2)
    p2 = cut_to_depth_2("DiT", params)
    cfg = LoRAConfig(8, 16.0)
    gen = torch.Generator().manual_seed(3)
    lora = init_lora(gen, p2, cfg)
    for sub in lora.values():  # a random b, so that a has a gradient too
        for ab in sub.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.02
    b, n = 4, 512
    rng = np.random.default_rng(12)
    mel = torch.from_numpy(rng.standard_normal((b, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(1, 2545, (b, 128)).astype(np.int32))
    lens = torch.tensor([n, n * 25 // 32, n * 19 // 32, n * 7 // 8], dtype=torch.int32)
    draws = make_draws(torch.Generator().manual_seed(5), b, n, 100)
    expect = {"fused_qkv_rope_attention_lse": 2, "fused_qkv_rope_attention_bwd": 2,
              "adaln_norm": 5, "conv_pos_embedding": 1}
    out = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        step = make_lora_train_step(tree_cast(p2, torch.float32, where), DiTStatics(arch2, where),
                                    AdamWHParams(1e-5), cfg, dtype=dtype)
        _build.reset_launches()
        loss, grads = step.loss_and_grads(tree_cast(lora, torch.float32, where), mel.to(where),
                                          text.to(where), lens.to(where), draws=draws)
        out[where.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)])
        if where.type == "cuda" and _build.launches() != expect:
            raise AssertionError(f"(d) depth-2 LoRA step launches {_build.launches()}, "
                                 f"expected {expect}")
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    rels = [float((x - w).norm() / w.norm()) for x, w in zip(ga, gb)]
    loss_rel = abs(la - lb) / abs(lb)
    log(f"  (d) LoRA depth 2, card bf16 vs cpu f32: loss {la:.6f} / {lb:.6f}, rel {loss_rel:.3e} "
        f"(tol 2e-2); adapter gradient rel-L2 over {len(rels)} leaves: median "
        f"{statistics.median(rels):.3e}, max {max(rels):.3e} (tol 1e-1)")
    if not (loss_rel <= 2e-2 and max(rels) <= 1e-1):
        raise AssertionError("(d) LoRA step: card bf16 and cpu f32 disagree")
    return {"loss_rel": loss_rel, "grad_rel_max": max(rels)}


def phase_training_data(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 21: training from data on disk at F5TTS_v1_Base, bf16, pinyin."""
    import shutil
    import tempfile

    import torch
    from f5tts_tpu_torch.scripts.common import base_models
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB
    from f5tts_tpu_torch.train.checkpoint import write_safetensors_f32
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    launches, out = {}, {}
    try:
        out["data"], sources = phase21_data(tmp, gpu)
        vocab_dir = tmp / "data"
        (vocab_dir / "smoke_pinyin").mkdir(parents=True)
        with open(EMILIA_VOCAB, encoding="utf-8") as f:
            lines = f.read()
        (vocab_dir / "smoke_pinyin" / "vocab.txt").write_text(
            lines + "".join(f"newtok{i}\n" for i in range(NEW_TOKENS)), encoding="utf-8")
        arch, params, vocos_params = base_models()
        ckpt = str(tmp / "F5TTS_v1_Base.safetensors")
        t0 = time.perf_counter()
        write_safetensors_f32(reference_state_dict(params), ckpt)
        log(f"  reference safetensors of F5TTS_v1_Base: {Path(ckpt).stat().st_size / 1e9:.3f} GB "
            f"in {time.perf_counter() - t0:.2f} s")
        del params
        rows = sources["wav_24k"] * 2   # two 16-row batches of 1024 frames
        vocos = Vocos(vocos_params, VocosConfig(), device=dev)
        ran, out["finetune"], vocab, arch_v, params = phase21_finetune(
            dev, tmp, vocab_dir, ckpt, rows, vocos, gpu)
        for k, c in ran.items():
            launches[k] = launches.get(k, 0) + c
        torch.cuda.empty_cache()
        out["data"]["timing"] = data_timing(sources, str(tmp), out["finetune"]["step_ms"], gpu)
        ran, out["train_cli"] = phase21_train_cli(dev, tmp, vocab_dir, arch, params, rows, gpu)
        for k, c in ran.items():
            launches[k] = launches.get(k, 0) + c
        ran, out["lora"], _ = phase21_lora(dev, tmp, vocab_dir, ckpt, rows, params, vocab,
                                           arch_v, vocos_params, gpu)
        for k, c in ran.items():
            launches[k] = launches.get(k, 0) + c
        out["depth2"] = phase21_depth2(dev, arch_v, params)
    finally:
        shutil.rmtree(tmp)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 21: {out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# phase 22
# ---------------------------------------------------------------------------

TP_HEADS = (8, 4)  # the Base presets' 16 heads a rank at TP 2 and TP 4
# (c): the one-process update's batch (a rank's rows x 2), the 1024 bucket
TWO_PROC_BATCH, TWO_PROC_FRAMES = 8, 1024
# (c)'s peak lr, reached at the first update (no warm-up): Adam's first
# step moves each weight by about lr
TWO_PROC_LR = 7.5e-5
CARD_GATE = 3e-2  # card-vs-card bf16 rel-L2 (phase 20's batch row against alone)
# (c)'s update: the applied step against AdamW's first step recomputed from
# the rank's own gradient, |gap| / (1 + |p|) (f32 rounding of the same
# arithmetic); its rel-L2 from the one-process update (a first Adam step is
# about lr sign(g): it flips where g is within the bf16 gradients' noise of
# 0; an update not applied, or not gathered on half the weights, reads 1 or
# 0.7)
ADAM_GAP = 1e-6
UPDATE_GATE = 0.25


def _tp_kernel_row(rows, name: str, h: int, ms: float, err: float, extra: str = "") -> dict:
    base = rows[name]["ms"]
    log(f"  {name} b=2 h={h} d=64: max_abs_err {err:.3e}{extra}, {ms:.4f} ms against "
        f"{base:.4f} ms at h=16 ({ms / base:.2f} x)")
    return {"name": name, "heads": h, "ms": ms, "ms_h16": base, "max_abs_err": err}


def phase22_kernels(rng, dev, rows) -> list:
    """(a) The attention kernels at the heads a rank runs under tensor
    parallelism (h = 8; K3, K3-lse, K4 also h = 4), b = 2, n = 1024 with
    lengths [1024, 777] (K5 / K8 / K11: joint 1024 + 128 with K5's masks),
    against their plain versions at phase 2's gates, each timed beside
    phase 2's h = 16 time at n = 1024."""
    import torch
    from f5tts_tpu_torch.ops import attention as at
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, d, n = 2, 64, 1024
    lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
    live = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    tile_end = -(-777 // 64) * 64
    out = []

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    def lse_gap(lse, ref_lse, end):
        return max(float((lse[0] - ref_lse[0]).abs().max()),
                   float((lse[1, :, :end] - ref_lse[1, :, :end]).abs().max()))

    def check(ok: bool, what: str):
        if not ok:
            raise AssertionError(f"phase 22 (a): {what}")

    for h in TP_HEADS:
        qkv, dout = randn(b, n, 3 * h * d), randn(b, n, h * d)
        cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n).to(dev), n, h,
                                    dtype=torch.bfloat16)
        o = at.fused_qkv_rope_attention(qkv, cos, sin, lengths, h)
        err = live_err(o, at.fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, h), lengths)
        check(err <= TOL["fused_qkv_rope_attention"] and not o[1, 777:].any(), f"K3 h={h}")
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention", h, time_ms(
            lambda: at.fused_qkv_rope_attention(qkv, cos, sin, lengths, h)), err))
        o2, lse = at.fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, h, return_lse=True)
        _, ref_lse = at.fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, h, return_lse=True)
        gap = lse_gap(lse, ref_lse, tile_end)
        check(torch.equal(o2, o) and gap <= LSE_TOL
              and bool((lse[1, :, tile_end:] == at.NEG_INF).all()), f"K3-lse h={h}")
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention_lse", h, time_ms(
            lambda: at.fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, h, return_lse=True)),
            err, f", lse {gap:.3e}"))
        args = (qkv, cos, sin, lengths, o2, lse, dout, h)
        got = at.fused_qkv_rope_attention_bwd(*args)
        want = at.fused_qkv_rope_attention_bwd_from_lse_ref(*args)
        rel, err, top = bwd_errors(got[live], want[live])
        check_bwd_tol(f"phase 22 K4 h={h}", rel, err, top)
        check(not got[1, 777:].any(), f"K4 h={h}: dead rows")
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention_bwd", h, time_ms(
            lambda: at.fused_qkv_rope_attention_bwd(*args)), err, f", rel-L2 {rel:.3e}"))
        if h != 8:
            continue
        # K5, its lse mode and K8 on the MMDiT's joint 1024 + 128
        jq, jc, js, kmask = joint_case(rng, dev, 1024, 128, None, h)
        jdout = randn(b, jq.shape[1], h * d)
        o = at.fused_qkv_rope_attention_bias(jq, jc, js, kmask, h)
        ref, ref_lse = at.fused_qkv_rope_attention_bias_ref(jq, jc, js, kmask, h, return_lse=True)
        err = float((o.float() - ref.float()).abs()[kmask].max())
        check(err <= TOL["fused_qkv_rope_attention_bias"], "K5 h=8")
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention_bias", h, time_ms(
            lambda: at.fused_qkv_rope_attention_bias(jq, jc, js, kmask, h)), err))
        o2, lse = at.fused_qkv_rope_attention_bias_fwd(jq, jc, js, kmask, h, return_lse=True)
        gap = float((lse - ref_lse).abs().max())
        check(torch.equal(o2, o) and gap <= LSE_TOL, "K5-lse h=8")
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention_bias_lse", h, time_ms(
            lambda: at.fused_qkv_rope_attention_bias_fwd(jq, jc, js, kmask, h, return_lse=True)),
            err, f", lse {gap:.3e}"))
        args = (jq, jc, js, kmask, o2, lse, jdout, h)
        got = at.fused_qkv_rope_attention_bias_bwd(*args)
        rel, err, top = bwd_errors(got, at.fused_qkv_rope_attention_bias_bwd_from_lse_ref(*args))
        check_bwd_tol("phase 22 K8 h=8", rel, err, top)
        out.append(_tp_kernel_row(rows, "fused_qkv_rope_attention_bias_bwd", h, time_ms(
            lambda: at.fused_qkv_rope_attention_bias_bwd(*args)), err, f", rel-L2 {rel:.3e}"))
        # K11 on the same joint mask, head layout
        mq, mk, mv = (randn(b, h, jq.shape[1], d) for _ in range(3))
        o = at.masked_flash_attention(mq, mk, mv, kmask)
        err = float((o.float() - at.mha_reference_masked(mq, mk, mv, kmask).float()).abs().max())
        check(err <= TOL["masked_flash_attention"], "K11 h=8")
        out.append(_tp_kernel_row(rows, "masked_flash_attention", h, time_ms(
            lambda: at.masked_flash_attention(mq, mk, mv, kmask)), err))
        # K7, its lse mode and K9: head layout, the UNetT's past the flat gate
        q, k, v, hdout = (randn(b, h, n, d) for _ in range(4))
        hdout = hdout * live[:, None, :, None]
        o = at.flash_attention(q, k, v, lengths)
        ref, ref_lse = at.flash_attention_fwd_ref(q, k, v, lengths, return_lse=True)
        err = max(float((o[i, :, :end].float() - ref[i, :, :end].float()).abs().max())
                  for i, end in enumerate((n, tile_end)))
        check(err <= TOL["flash_attention"] and not o[1, :, tile_end:].any(), "K7 h=8")
        out.append(_tp_kernel_row(rows, "flash_attention", h, time_ms(
            lambda: at.flash_attention(q, k, v, lengths)), err))
        o2, lse = at.flash_attention_fwd(q, k, v, lengths, return_lse=True)
        gap = lse_gap(lse, ref_lse, tile_end)
        check(torch.equal(o2, o) and gap <= LSE_TOL
              and bool((lse[1, :, tile_end:] == at.NEG_INF).all()), "K7-lse h=8")
        out.append(_tp_kernel_row(rows, "flash_attention_lse", h, time_ms(
            lambda: at.flash_attention_fwd(q, k, v, lengths, return_lse=True)), err,
            f", lse {gap:.3e}"))
        got = at.flash_attention_bwd(q, k, v, lengths, o2, lse, hdout)
        want = at.flash_attention_bwd_ref(q, k, v, lengths, o2, lse, hdout)
        stats = [bwd_errors(g, w) for g, w in zip(got, want)]
        for grad, (rel, err, top) in zip(("dq", "dk", "dv"), stats):
            check_bwd_tol(f"phase 22 K9 {grad} h=8", rel, err, top)
        out.append(_tp_kernel_row(rows, "flash_attention_bwd", h, time_ms(
            lambda: at.flash_attention_bwd(q, k, v, lengths, o2, lse, hdout)),
            max(s[1] for s in stats), f", rel-L2 {max(s[0] for s in stats):.3e}"))
    return out


def _device_ms(prof, match) -> float:
    """Device ms of the profiled events whose name `match` accepts."""
    total = 0.0
    for e in prof.key_averages():
        if match(e.key):
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    return total / 1e3


def phase22_nccl_trainer(dev, gpu: str) -> tuple[dict, dict]:
    """(b) One process, an NCCL group of world 1 (a FileStore): the plain
    Trainer, then Trainer(mesh=make_mesh(1, 1)) and with zero1, each four
    F5TTS_v1_Base 16 x 1024 updates: the launches of every update, loss /
    params / EMA after update 2 against the plain Trainer's, ms an update
    (median of updates 2 and 3), peak memory over the updates and over the
    run (its closing checkpoint included), and from the profiler the device
    ms of update 4 (NCCL kernels, copies, all)."""
    import gc
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from f5tts_tpu_torch.config import TrainConfig
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.dit import DiTStatics
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.parallel.mesh import make_mesh
    from f5tts_tpu_torch.scripts.common import VOCAB, base_models
    from f5tts_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    total: dict[str, int] = {}
    result = {}
    try:
        mesh = make_mesh(1, 1)
        arch, params, _ = base_models()
        data, _ = _train_dataset(np.random.default_rng(22), 16, 1024)
        expect = dit_update_launches(arch.depth)
        stash = {}
        for name, kw in (("plain", {}), ("mesh", {"mesh": mesh}),
                         ("mesh_zero1", {"mesh": mesh, "zero1": True})):
            cfg = TrainConfig(batch_size_per_device=16 * 1024, max_samples=16, epochs=4,
                              num_warmup_updates=2, ema_update_every=1, ema_update_after_step=0,
                              save_dir=os.path.join(tmp, name), save_per_updates=10 ** 9,
                              last_per_updates=10 ** 9, logger=None)
            trainer = Trainer(params, DiTStatics(arch), cfg, vocab_char_map=VOCAB,
                              tokenizer="char", device=dev, **kw)
            prof = profile(activities=[ProfilerActivity.CUDA])
            rec = {"walls_ms": [], "losses": []}
            t_last = [0.0]

            def on_update(update, metrics):
                torch.cuda.synchronize(dev)
                rec["walls_ms"].append((time.perf_counter() - t_last[0]) * 1e3)
                rec["losses"].append(float(metrics["loss"]))
                ran = _build.launches()
                if ran != expect:
                    raise AssertionError(f"phase 22 (b) {name} update {update}: launched {ran}, "
                                         f"expected {expect}")
                for k, c in ran.items():
                    total[k] = total.get(k, 0) + c
                if update == 2:  # the plain Trainer's params and EMA, kept on the host
                    trees = {"params": trainer.state.params, "ema": trainer.ema_params()}
                    if name == "plain":
                        stash.update({k: [t.to("cpu", copy=True) for t in m.tree_leaves(v)]
                                      for k, v in trees.items()})
                        stash["loss"] = rec["losses"][-1]
                    else:
                        for k, v in trees.items():
                            pairs = [(a.cpu(), b) for a, b in zip(m.tree_leaves(v), stash[k])]
                            rec[f"{k}_bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
                            rec[f"{k}_max_abs"] = max(float((a - b).abs().max()) for a, b in pairs)
                        rec["loss_equal"] = rec["losses"][-1] == stash["loss"]
                    del trees
                elif update == 4:
                    rec["peak_updates_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
                    prof.stop()
                if update == 3:
                    prof.start()
                _build.reset_launches()
                t_last[0] = time.perf_counter()

            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            rec["allocated_at_start_gb"] = torch.cuda.memory_allocated(dev) / 1e9
            _build.reset_launches()  # every count to 0 just before the run
            t_last[0] = time.perf_counter()
            trainer.train(data, max_updates=4, on_update=on_update)
            rec["ms_update"] = statistics.median(rec["walls_ms"][1:3])
            rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            rec["nccl_ms"] = _device_ms(prof, lambda k: "nccl" in k.lower())
            rec["memcpy_ms"] = _device_ms(prof, lambda k: "memcpy" in k.lower())
            rec["device_ms_update_4"] = _device_ms(prof, lambda k: True)
            if name != "plain":
                st = trainer.state
                rec["state_gb"] = sum(t.numel() * t.element_size() for t in
                                      m.tree_leaves([st.params, st.mu, st.nu, st.ema])) / 1e9
                del st  # the next variant's memory must not hold this one's state
                if not (rec["loss_equal"] and rec["params_max_abs"] <= 1e-5
                        and rec["ema_max_abs"] <= 1e-5):
                    raise AssertionError(f"phase 22 (b) {name}: not the plain Trainer's result "
                                         f"{rec}")
            log(f"  (b) {name}: {rec['ms_update']:.1f} ms an update (walls "
                f"{', '.join(f'{w:.1f}' for w in rec['walls_ms'])}), peak "
                f"{rec['peak_updates_gb']:.2f} GB over the updates, {rec['peak_gb']:.2f} GB with "
                f"the checkpoint, {json.dumps({k: v for k, v in rec.items() if k != 'walls_ms'})} "
                f"[{gpu}]")
            result[name] = rec
            del trainer, prof
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return total, result


def _two_proc_inputs(dev, arch):
    """(c)'s inputs from seed 22: the generate's (cond, text, lens,
    duration, y0, t_grid) at the 1024 bucket and the update's 8 x 1024 batch."""
    import torch
    from f5tts_tpu_torch.utils import make_time_grid

    rng = np.random.default_rng(22)
    gen = {"cond": (rng.standard_normal((1, 1024, 100)) * 0.3).astype(np.float32),
           "text": rng.integers(1, 2545, (1, 200)).astype(np.int32),
           "lens": np.asarray([300], np.int32), "duration": np.asarray([1000], np.int32),
           "y0": rng.standard_normal((1, 1024, 100)).astype(np.float32)}
    gen = {k: torch.from_numpy(v).to(dev) for k, v in gen.items()}
    gen["cond"][:, 300:] = 0
    gen["t_grid"] = make_time_grid(NFE, sway_sampling_coef=-1.0)
    batch = tuple(t.to(dev) for t in train_batch(TWO_PROC_BATCH, TWO_PROC_FRAMES,
                                                 "F5TTS_v1_Base", seed=22))
    return gen, batch


def _two_proc_step(arch, dev, mesh=None):
    import torch
    from f5tts_tpu_torch.models.dit import DiTStatics
    from f5tts_tpu_torch.train.step import make_optimizer, make_train_step

    return make_train_step(DiTStatics(arch, dev, tp=None if mesh is None else mesh.tp),
                           make_optimizer(TWO_PROC_LR, 0, 10), ema_update_every=1,
                           ema_update_after_step=0, dtype=torch.bfloat16, mesh=mesh)


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def tp_int8_step_launches(arch) -> dict:
    """A TP rank's launches of one int8 DiT step (`step_launches(int8=True)`)
    but for the row-parallel projections: ff.out takes bf16 rows under tp,
    so to_out and ff.out both quantize their slices with the plain K12
    (`ops.quant.int8_linear_partial_tp`), and K12's GELU mode runs none."""
    step = step_launches("DiT", arch, int8=True)
    step["quantize_rows"] += step.pop("gelu_quantize_rows")
    return step


def adam_first_gap(p0, p1, g, gnorm: float, hp) -> float:
    """max |p1 - p1'| / (1 + |p0|) over leaves, p1' the first AdamW step
    from p0 on the gradient g clipped by gnorm, as `train.step` computes it:
    mu / bc1 = g', nu / bc2 = g'^2, p1' = p0 - lr (g' / (|g'| + eps) + wd p0)."""
    scale = 1.0 if gnorm < hp.max_grad_norm else hp.max_grad_norm / gnorm
    gap = 0.0
    for a, b, d in zip(p0, p1, g):
        gs = d.float() * scale
        want = a - hp.learning_rate * (gs / (gs.abs() + hp.eps) + hp.weight_decay * a)
        gap = max(gap, float(((b - want).abs() / (1.0 + a.abs())).max()))
    return gap


def mean_move(p0, p1, lr: float) -> float:
    """mean |p1 - p0| / lr over the leaves' elements: how far an update
    moved the weights."""
    return (sum(float((b - a).abs().sum()) for a, b in zip(p0, p1))
            / sum(b.numel() for b in p1) / lr)


def update_rel(p0, p1, ref1) -> float:
    """||p1 - ref1|| / ||ref1 - p0|| over the leaves: an update's rel-L2
    from the one-process update (ref1 the one-process params after it)."""
    num = sum(float((b - r).norm()) ** 2 for b, r in zip(p1, ref1))
    return (num / sum(float((r - a).norm()) ** 2 for a, r in zip(p0, ref1))) ** 0.5


def phase22_child(rank: int, tmp: str) -> None:
    """(c) One of two processes on the one card, a gloo group: a TP-2
    forward and 16-NFE generate, a TP-2 int8 forward, a TP-2 update and a
    DP-2 update, each against the one-process results in `tmp`; writes
    child<rank>.json."""
    import torch
    import torch.distributed as dist

    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.dit import DiTStatics, dit_forward
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.ops.quant import quantize_dit_params
    from f5tts_tpu_torch.parallel.collectives import all_reduce_flat
    from f5tts_tpu_torch.parallel.mesh import (batch_sharding, dit_param_specs, make_mesh,
                                               shard_params, shard_train_state, shard_tree)
    from f5tts_tpu_torch.scripts.common import base_models
    from f5tts_tpu_torch.train.step import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store"), 2),
                            rank=rank, world_size=2)
    res = {"rank": rank}
    probe = torch.full((4,), float(rank + 1), device=dev)
    try:  # the capability this part rests on: gloo's all_reduce of CUDA tensors
        dist.all_reduce(probe)
        res["gloo_cuda_all_reduce"] = probe.tolist() == [3.0] * 4
    except RuntimeError as e:
        res["gloo_cuda_all_reduce"] = False
        res["gloo_error"] = str(e)[:500]
    if not res["gloo_cuda_all_reduce"]:
        (Path(tmp) / f"child{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()
        return
    ref = torch.load(Path(tmp) / "ref.pt", map_location=dev, weights_only=True)
    arch, params, _ = base_models()
    gen, batch = _two_proc_inputs(dev, arch)
    tp, dp = make_mesh(1, 2), make_mesh(2, 1)

    # TP-2: the CFG-packed forward and a 16-NFE generate at the 1024 bucket
    fused = shard_params(m.fuse_backbone_qkv(m.tree_cast(params, torch.bfloat16, dev)), tp)
    statics = DiTStatics(arch, dev, tp=tp.tp)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = dit_forward(fused, statics, gen["y0"], gen["cond"], gen["text"],
                          torch.tensor([0.3], device=dev), lengths=gen["duration"],
                          cfg_infer=True, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    res["tp_forward_s"] = time.perf_counter() - t0
    res["tp_forward_launches"] = _build.launches()
    live = int(gen["duration"][0])
    res["tp_forward_rel"] = _rel_l2(fwd[:, :live], ref["forward"][:, :live])
    # int8 under TP: this rank's shards quantized (row leaves' scales over
    # the whole contraction axis), the row-parallel products' slices
    # quantized at the whole row's scale
    q_fused = quantize_dit_params(fused, tp=tp.tp)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = dit_forward(q_fused, statics, gen["y0"], gen["cond"], gen["text"],
                          torch.tensor([0.3], device=dev), lengths=gen["duration"],
                          cfg_infer=True, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    res["tp_int8_forward_s"] = time.perf_counter() - t0
    res["tp_int8_forward_launches"] = _build.launches()
    res["tp_int8_forward_rel"] = _rel_l2(fwd[:, :live], ref["forward_int8"][:, :live])
    del q_fused
    _build.reset_launches()
    t0 = time.perf_counter()
    mel = cfm.cfm_sample(fused, statics, gen["cond"], gen["text"], gen["lens"], gen["duration"],
                         gen["t_grid"], y0=gen["y0"], dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    res["tp_generate_s"] = time.perf_counter() - t0
    res["tp_generate_launches"] = _build.launches()
    res["tp_mel_rel"] = _rel_l2(mel[:, 300:live], ref["mel"][:, 300:live])
    del fused, statics
    torch.cuda.empty_cache()

    # TP-2 and DP-2 updates on the 8 x 1024 batch (DP: 4 rows a rank)
    mel8, text8, lens8 = batch
    specs = dit_param_specs(params)
    for name, mesh in (("tp", tp), ("dp", dp)):
        step = _two_proc_step(arch, dev, mesh)
        state = shard_train_state(init_train_state(params, dev), mesh, zero1=False)
        rows = batch_sharding(mesh, TWO_PROC_BATCH)
        torch.cuda.synchronize(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, grads = step.grad_step(state.params, mel8[rows], text8[rows], lens8[rows],
                                     generator=torch.Generator(device=dev).manual_seed(0))
        if name == "tp":  # this rank's gradient shards against the one-process gradients
            want = m.tree_leaves(shard_tree(ref["grads"], specs, mesh))
            got = m.tree_leaves(grads)
            num = sum(float((a.float() - b.float()).norm()) ** 2 for a, b in zip(got, want))
            res["tp_grads_rel"] = (num / sum(float(b.float().norm()) ** 2 for b in want)) ** 0.5
        torch.cuda.synchronize(dev)
        t_grad = time.perf_counter() - t0
        launches = _build.launches()
        # outside the timed update: the initial params, and the gradient
        # the update applies (this rank's shard of it; over "data" summed)
        p0 = [t.clone() for t in m.tree_leaves(state.params)]
        g = [t.float() for t in m.tree_leaves(grads)]
        if name == "dp":
            flat = all_reduce_flat(torch.cat([t.reshape(-1) for t in g]), mesh.data_group)
            g = list(flat.split([t.numel() for t in g]))
            g = [a.view(t.shape) for a, t in zip(g, p0)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = step.apply_step(state, loss, grads)
        torch.cuda.synchronize(dev)
        res[f"{name}_update_s"] = t_grad + time.perf_counter() - t0
        res[f"{name}_update_launches"] = launches
        res[f"{name}_loss_rel"] = abs(float(metrics["loss"]) / ref["loss"] - 1.0)
        res[f"{name}_grad_norm_rel"] = abs(float(metrics["grad_norm"]) / ref["grad_norm"] - 1.0)
        p1 = m.tree_leaves(state.params)
        res[f"{name}_adam_gap"] = adam_first_gap(p0, p1, g, float(metrics["grad_norm"]),
                                                 step.hp)
        del g
        want = [t.to(dev) for t in m.tree_leaves(
            shard_tree(ref["params"], specs, mesh) if name == "tp" else ref["params"])]
        res[f"{name}_moved"] = mean_move(p0, p1, TWO_PROC_LR)
        res[f"{name}_update_rel"] = update_rel(p0, p1, want)
        del step, state, grads, p0, want
        torch.cuda.empty_cache()
    (Path(tmp) / f"child{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase22_two_processes(dev, gpu: str) -> dict:
    """(c) The one-process references (the bf16 and int8 forwards and the
    generate at the 1024 bucket, one update on 8 x 1024), then two processes
    on the one card over gloo (`phase22_child`) held to them: forwards and
    mel rel-L2 <= CARD_GATE, TP gradients rel-L2 <= CARD_GATE, loss and
    grad norm rel <= 1e-3; the update applied as AdamW's first step on the
    rank's gradient (ADAM_GAP), moving the weights as far as the
    one-process update (which moves them by about lr) and within
    UPDATE_GATE of it. gloo stages through the host: its times are no
    measure of NCCL."""
    import os
    import shutil
    import tempfile

    import torch
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.models.dit import DiTStatics, dit_forward
    from f5tts_tpu_torch.ops.quant import quantize_dit_params
    from f5tts_tpu_torch.scripts.common import base_models
    from f5tts_tpu_torch.train.step import init_train_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    procs = []
    try:
        arch, params, _ = base_models()
        gen, (mel8, text8, lens8) = _two_proc_inputs(dev, arch)
        fused = m.fuse_backbone_qkv(m.tree_cast(params, torch.bfloat16, dev))
        statics = DiTStatics(arch, dev)
        with torch.no_grad():
            fwd = dit_forward(fused, statics, gen["y0"], gen["cond"], gen["text"],
                              torch.tensor([0.3], device=dev), lengths=gen["duration"],
                              cfg_infer=True, dtype=torch.bfloat16)
        mel = cfm.cfm_sample(fused, statics, gen["cond"], gen["text"], gen["lens"],
                             gen["duration"], gen["t_grid"], y0=gen["y0"], dtype=torch.bfloat16)
        with torch.no_grad():
            fwd_i8 = dit_forward(quantize_dit_params(fused), statics, gen["y0"], gen["cond"],
                                 gen["text"], torch.tensor([0.3], device=dev),
                                 lengths=gen["duration"], cfg_infer=True, dtype=torch.bfloat16)
        del fused
        step = _two_proc_step(arch, dev)
        state = init_train_state(params, dev)
        p0 = [t.clone() for t in m.tree_leaves(state.params)]
        loss, grads = step.grad_step(state.params, mel8, text8, lens8,
                                     generator=torch.Generator(device=dev).manual_seed(0))
        grads_cpu = m.tree_map(lambda t: t.detach().to("cpu", copy=True), grads)
        state, metrics = step.apply_step(state, loss, grads)
        ref_moved = mean_move(p0, m.tree_leaves(state.params), TWO_PROC_LR)
        del p0
        torch.save({"forward": fwd.cpu(), "forward_int8": fwd_i8.cpu(), "mel": mel.cpu(),
                    "grads": grads_cpu,
                    "params": m.tree_map(lambda t: t.cpu(), state.params),
                    "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])},
                   os.path.join(tmp, "ref.pt"))
        del state, step, grads, grads_cpu
        torch.cuda.empty_cache()
        repo = str(Path(__file__).resolve().parent)
        for rank in range(2):
            log_file = open(os.path.join(tmp, f"child{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", f"import sys; sys.path.insert(0, {repo!r}); import "
                 f"chip_smoke; chip_smoke.phase22_child({rank}, {tmp!r})"],
                cwd=repo, stdout=log_file, stderr=subprocess.STDOUT), log_file))
        for p, log_file in procs:
            p.wait(timeout=400)
            log_file.close()
        for rank, (p, _) in enumerate(procs):
            if p.returncode != 0:
                tail = Path(tmp, f"child{rank}.log").read_text()[-4000:]
                raise AssertionError(f"phase 22 (c) rank {rank} exited {p.returncode}:\n{tail}")
        res = [json.loads(Path(tmp, f"child{r}.json").read_text()) for r in range(2)]
        if not all(r["gloo_cuda_all_reduce"] for r in res):
            log(f"  (c) gloo's all_reduce does not take CUDA tensors here: {res} [{gpu}]")
            return {"gloo_cuda_all_reduce": False, "ranks": res}
        one = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "moved": ref_moved}
        if not 0.5 <= ref_moved <= 1.05:
            raise AssertionError(f"phase 22 (c): the one-process update moved the weights by "
                                 f"{ref_moved} x lr on average, not about lr")
        expect = {"tp_forward_launches": step_launches("DiT", arch),
                  "tp_int8_forward_launches": tp_int8_step_launches(arch),
                  "tp_generate_launches": generate_launches("DiT", arch),
                  "tp_update_launches": dit_update_launches(arch.depth),
                  "dp_update_launches": dit_update_launches(arch.depth)}
        for r in res:
            log(f"  (c) rank {r['rank']} (gloo, staged through the host): {json.dumps(r)}")
            wrong = {k: r[k] for k, v in expect.items() if r[k] != v}
            if wrong:
                raise AssertionError(f"phase 22 (c) rank {r['rank']}: launches {wrong}, "
                                     f"expected {expect}")
            bad = [k for k in ("tp_forward_rel", "tp_int8_forward_rel", "tp_mel_rel",
                               "tp_grads_rel") if r[k] > CARD_GATE]
            bad += [k for k in ("tp_loss_rel", "dp_loss_rel", "tp_grad_norm_rel",
                                "dp_grad_norm_rel") if r[k] > 1e-3]
            bad += [k for k in ("tp_adam_gap", "dp_adam_gap") if r[k] > ADAM_GAP]
            bad += [k for k in ("tp_moved", "dp_moved") if abs(r[k] / ref_moved - 1.0) > 0.02]
            bad += [k for k in ("tp_update_rel", "dp_update_rel") if r[k] > UPDATE_GATE]
            if bad:
                raise AssertionError(f"phase 22 (c) rank {r['rank']}: {bad} off the gates")
        return {"gloo_cuda_all_reduce": True, "one_process": one, "ranks": res}
    finally:
        for p, log_file in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_multi_gpu(dev, gpu: str, rows: dict) -> tuple[dict, dict]:
    """Phase 22: (a) the kernels at the TP head counts, (b) the Trainer over
    an NCCL mesh of world 1, (c) TP-2 / DP-2 as two processes on the card."""
    import torch

    t0 = time.perf_counter()
    out = {"kernels": phase22_kernels(np.random.default_rng(22), dev, rows)}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ran, out["trainer"] = phase22_nccl_trainer(dev, gpu)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out["two_processes"] = phase22_two_processes(dev, gpu)
    t3 = time.perf_counter()
    out["seconds"] = t3 - t0
    out["seconds_abc"] = [t1 - t0, t2 - t1, t3 - t2]
    return ran, out


# ---------------------------------------------------------------------------
# phase 23
# ---------------------------------------------------------------------------

EVAL_NFE = 32                   # eval_infer_batch's default, the evaluation protocol's
EVAL_BATCH = 4                  # get_inference_prompt's infer_batch_size
EVAL_REF_TEXT = "Some call me nature, others call me mother nature."
# (seconds, prompt text, target text), 24 kHz prompts of 2-5 s: rows 0-3
# fall into one duration bucket of get_inference_prompt (totals 612-627
# frames: a 4-row batch, each row its own prompt and total length), the
# others into buckets of their own (b = 1)
EVAL_PROMPTS = (
    (3.04, EVAL_REF_TEXT, "Every morning the light returns, and the birds begin again."),
    (3.06, EVAL_REF_TEXT, "Every evening the light retreats, and the birds fall silent."),
    (3.08, EVAL_REF_TEXT, "The river keeps its course through the valley to the sea."),
    (3.10, EVAL_REF_TEXT, "I have been here for billions of years, and I will stay on."),
    (2.0, "A short prompt.", "The forests grow slowly on either bank of the river."),
    (2.5, EVAL_REF_TEXT, "Hello there."),
    (4.2, "我们今天一起去银行，然后在公园里散步。", "天气很好，不是吗？我们明天再来。"),
    (5.0, EVAL_REF_TEXT, ("I have been here for billions of years, and I will be here long "
                          "after you are gone.")),
)
EVAL_ROW = 1                    # the batch row sampled again alone
SIM_SECONDS = (3.0, 10.0)       # an embedding's time at 16 kHz
SIM_REL_TOL = 1e-3              # card against the CPU, f32 (BigVGAN's gate, phase 18)
SIM_RUN_TOL = 1e-4              # run_sim's score against the module it was written from
UTMOS_SECONDS = 5.0
UTMOS_ABS_TOL = 1e-3            # |MOS card - MOS CPU|, f32
MULTISTYLE_TEXT = ("{Regular} The river keeps its course through the valley. {Whisper} and "
                   "the forests grow slowly on either bank. {Regular} Every morning the light "
                   "returns.")
MULTISTYLE_NFE = 16


def eval_prompt_set(root: Path) -> str:
    """EVAL_PROMPTS' wavs and a Seed-TTS meta.lst ("utt|prompt text|prompt
    wav|target text") under `root`; returns the list's path."""
    from f5tts_tpu_torch.infer import audio_io

    lines = []
    for i, (secs, prompt, target) in enumerate(EVAL_PROMPTS):
        audio_io.write_wav(str(root / f"prompt{i}.wav"),
                           voiced_clip(int(secs * 24000), 24000, 230 + i), 24000)
        lines.append(f"utt{i}|{prompt}|prompt{i}.wav|{target}")
    (root / "meta.lst").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(root / "meta.lst")


def eval_sample_rows(pipe, vocab: dict, batch: dict, rows) -> tuple:
    """`rows` of `batch` through generate_batches' sampler call
    (`sample_batch`: the rows' bucket, cond, ids and the seed-0 noise):
    (mel [len(rows), n, d], n)."""
    from f5tts_tpu_torch.eval.eval_infer_batch import sample_batch

    idx = list(rows)
    sub = {k: [v[i] for i in idx] if isinstance(v, list) else v[idx] for k, v in batch.items()}
    return sample_batch(pipe.params, pipe.statics, vocab, sub, EVAL_NFE, dtype=pipe.dtype,
                        bucket_size=pipe.bucket_size, max_duration=pipe.sampling.max_duration,
                        backbone=pipe.bdef, device=pipe.device)


def phase23_generation(pipe, vocab: dict, meta: str, out_dir: str, gpu: str) -> tuple:
    """(a) get_inference_prompt(infer_batch_size=4) and generate_batches at
    32 NFE, a batch at a time, every count set to 0 just before a batch and
    read just after: K3 / K1 / K2 704 / 1440 / 64 a batch; each wav finite
    and not silent; walls and RTF a batch; the b = 4 batch and a b = 1
    batch again under the profiler (device-busy share of the traced wall);
    row EVAL_ROW of the 4-row batch against the same row sampled alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from f5tts_tpu_torch.eval.eval_infer_batch import generate_batches
    from f5tts_tpu_torch.eval.utils_eval import (get_inference_prompt,
                                                 get_seedtts_testset_metainfo)
    from f5tts_tpu_torch.infer import audio_io
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import device_time_by_class

    t0 = time.perf_counter()
    batches = get_inference_prompt(get_seedtts_testset_metainfo(meta),
                                   infer_batch_size=EVAL_BATCH)
    prep_s = time.perf_counter() - t0
    sizes = sorted(len(b["utts"]) for b in batches)
    if sizes != [1] * (len(EVAL_PROMPTS) - EVAL_BATCH) + [EVAL_BATCH]:
        raise AssertionError(f"EVAL_PROMPTS gave batches of {sizes}, expected one of "
                             f"{EVAL_BATCH} and singles")
    expect = {k: v * EVAL_NFE // NFE for k, v in generate_launches("DiT", pipe.statics.arch).items()}

    def run(batch):
        return generate_batches(pipe.params, pipe.statics, pipe.vocoder, vocab, [batch], out_dir,
                                nfe_step=EVAL_NFE, seed=0, dtype=pipe.dtype,
                                bucket_size=pipe.bucket_size,
                                max_duration=pipe.sampling.max_duration, backbone=pipe.bdef,
                                device=pipe.device)

    ran, rows = {}, []
    for batch in batches:
        torch.cuda.synchronize()
        _build.reset_launches()  # every count to 0 just before the batch
        t1 = time.perf_counter()
        stats = run(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = _build.launches()
        if got != expect:
            raise AssertionError(f"generate_batches b={len(batch['utts'])}: launches {got}, "
                                 f"expected {expect} ({EVAL_NFE} NFE)")
        for name, c in got.items():
            ran[name] = ran.get(name, 0) + c
        for utt in batch["utts"]:
            wav, sr = audio_io.read_wav(str(Path(out_dir) / f"{utt}.wav"))
            rms = float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0
            if not (sr == 24000 and wav.size and np.isfinite(wav).all() and rms > 1e-4):
                raise AssertionError(f"{utt}.wav is empty, non-finite or silent")
        row = {"b": len(batch["utts"]), "totals": batch["total_mel_lens"].tolist(),
               "wall_s": wall, "audio_s": stats["audio_seconds"],
               "rtf": wall / stats["audio_seconds"]}
        rows.append(row)
        log(f"  generate_batches b={row['b']}, totals {row['totals']}: wall {wall:.4f} s, "
            f"{row['audio_s']:.3f} s of audio, RTF {row['rtf']:.5f}, launches {got} [{gpu}]")

    four = next(b for b in batches if len(b["utts"]) == EVAL_BATCH)
    one = next(b for b in batches if len(b["utts"]) == 1)
    traced = {}
    for batch in (one, four):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        busy = device_time_by_class(prof, ())["device_busy_ms"]
        traced[f"b{len(batch['utts'])}"] = {"traced_wall_s": wall, "device_busy_ms": busy,
                                            "busy_share": busy / (wall * 1e3)}
        log(f"  traced b={len(batch['utts'])}: wall {wall:.4f} s, device busy {busy:.1f} ms, "
            f"share {busy / (wall * 1e3):.3f} [{gpu}]")

    mel4, n4 = eval_sample_rows(pipe, vocab, four, range(EVAL_BATCH))
    mel1, n1 = eval_sample_rows(pipe, vocab, four, [EVAL_ROW])
    if n1 != n4:
        raise AssertionError(f"row {EVAL_ROW} alone lands in bucket {n1}, the batch in {n4}")
    ref, tot = int(four["ref_mel_lens"][EVAL_ROW]), int(four["total_mel_lens"][EVAL_ROW])
    a, b = mel4[EVAL_ROW, ref:tot].float(), mel1[0, ref:tot].float()
    rel = float((a - b).norm() / b.norm().clamp_min(1e-12))
    max_abs = float((a - b).abs().max())
    log(f"  row {EVAL_ROW} of the 4-row batch against it alone (n {n4}, frames {ref}:{tot}): mel "
        f"rel-L2 {rel:.3e}, max-abs {max_abs:.3e}{' (bit-equal)' if max_abs == 0 else ''} "
        f"(rel-L2 tol {CARD_GATE}) [{gpu}]")
    if not rel <= CARD_GATE:
        raise AssertionError(f"batch row {EVAL_ROW} against it alone: mel rel-L2 {rel}")
    return ran, {"prompt_prep_s": prep_s, "batches": rows, "traced": traced,
                 "row_alone": {"rel_l2": rel, "max_abs": max_abs, "n": n4}}


def phase23_sim(dev, pairs: list, tmp: Path, gpu: str) -> dict:
    """(b) WavLM-large + ECAPA-TDNN, f32, numpy-seeded weights: a 3 s clip's
    embedding on the card against the same weights on the CPU (rel-L2 <=
    SIM_REL_TOL); ms an embedding at 3 and 10 s and the peak; the weights
    written as a UniSpeech checkpoint and scored by run_sim on the card
    over (a)'s wavs against their prompts (the loader's frac 1.0)."""
    import copy
    import torch
    from f5tts_tpu_torch.eval import ecapa_tdnn
    from f5tts_tpu_torch.eval.utils_eval import run_sim
    from f5tts_tpu_torch.scripts.common import seeded_state_dict

    t0 = time.perf_counter()
    cpu_model = ecapa_tdnn.ECAPA_TDNN_SMALL()
    cpu_model.load_state_dict(seeded_state_dict(cpu_model, 23))
    cpu_model.eval()
    card = copy.deepcopy(cpu_model).to(dev)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in cpu_model.parameters())
    clip = torch.from_numpy(voiced_clip(int(SIM_SECONDS[0] * 16000), 16000, 231))[None]
    with torch.no_grad():
        want = cpu_model(clip)
        got = card(clip.to(dev)).cpu()
    rel = float((got - want).norm() / want.norm())
    log(f"  SIM model: {n_params / 1e6:.1f} M f32 parameters, built and drawn in {build_s:.1f} s; "
        f"{SIM_SECONDS[0]:.0f} s clip card vs cpu embedding rel-L2 {rel:.3e} (tol {SIM_REL_TOL}) "
        f"[{gpu}]")
    if not rel <= SIM_REL_TOL:
        raise AssertionError(f"SIM embedding card vs cpu rel-L2 {rel}")
    ms = {}
    for secs in SIM_SECONDS:
        wav = torch.from_numpy(voiced_clip(int(secs * 16000), 16000, 232)).to(dev)[None]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms[f"{secs:.0f}s"] = wall_ms(lambda: card(wav), iters=5)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  SIM embedding at {secs:.0f} s ({wav.shape[1]} samples): {ms[f'{secs:.0f}s']:.2f} "
            f"ms, peak {peak:.2f} GB allocated [{gpu}]")
    del card
    torch.cuda.empty_cache()

    ckpt = tmp / "wavlm_large_finetune.pth"
    torch.save({"model": ecapa_tdnn.to_reference_state_dict(cpu_model)}, ckpt)
    loads = []
    real_load = ecapa_tdnn.load_reference_checkpoint

    def spy(model, path, **kw):
        loads.append(real_load(model, path, **kw))
        return loads[-1]

    ecapa_tdnn.load_reference_checkpoint = spy
    try:
        t0 = time.perf_counter()
        results = run_sim(pairs, str(ckpt), device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        ecapa_tdnn.load_reference_checkpoint = real_load
    stats = loads[0]
    sims = [r["sim"] for r in results]
    log(f"  run_sim on the card: checkpoint {ckpt.stat().st_size / 1e9:.2f} GB, loader consumed "
        f"{stats['consumed']}/{stats['total']} (frac {stats['frac']}), {len(sims)} pairs in "
        f"{run_s:.1f} s, sims {[round(s, 4) for s in sims]} [{gpu}]")
    if stats["frac"] != 1.0 or len(sims) != len(pairs) or not np.isfinite(sims).all():
        raise AssertionError(f"run_sim: frac {stats['frac']}, sims {sims}")
    # the first pair scored by the module the checkpoint was written from
    from f5tts_tpu_torch.infer import audio_io

    with torch.no_grad():
        embs = []
        for p in pairs[0]:
            wav, sr = audio_io.read_wav(p)
            e = cpu_model(torch.from_numpy(audio_io.resample(wav, sr, 16000))[None])
            embs.append(torch.nn.functional.normalize(e, dim=-1))
    direct = float((embs[0] * embs[1]).sum())
    if not abs(direct - sims[0]) <= SIM_RUN_TOL:
        raise AssertionError(f"run_sim {sims[0]} against the written module's {direct} (cpu)")
    ckpt.unlink()
    return {"params_m": n_params / 1e6, "card_vs_cpu_rel_l2": rel, "embedding_ms": ms,
            "peak_gb": peak, "frac": stats["frac"], "sims": sims, "run_sim_s": run_s,
            "cpu_sim_gap": abs(direct - sims[0])}


def phase23_utmos(dev, out_dir: str, tmp: Path, gpu: str) -> dict:
    """(c) UTMOS22-strong, f32, numpy-seeded weights: one clip's MOS on the
    card against the CPU (|dMOS| <= UTMOS_ABS_TOL), ms a 5 s utterance, then
    eval_utmos over (a)'s wavs from a checkpoint written here."""
    import copy
    import torch
    from f5tts_tpu_torch.eval.eval_utmos import eval_utmos
    from f5tts_tpu_torch.eval.utmos22 import UTMOS22Strong
    from f5tts_tpu_torch.scripts.common import seeded_state_dict

    cpu_model = UTMOS22Strong().eval()
    cpu_model.load_state_dict(seeded_state_dict(cpu_model, 24))
    card = copy.deepcopy(cpu_model).to(dev)
    wave = torch.from_numpy(voiced_clip(int(UTMOS_SECONDS * 16000), 16000, 233))[None]
    want = float(cpu_model(wave, 16000)[0])
    got = float(card(wave.to(dev), 16000)[0])
    wave_d = wave.to(dev)
    ms = wall_ms(lambda: card(wave_d, 16000), iters=5)
    log(f"  UTMOS {UTMOS_SECONDS:.0f} s clip: MOS card {got:.6f}, cpu {want:.6f}, |d| "
        f"{abs(got - want):.2e} (tol {UTMOS_ABS_TOL}); {ms:.2f} ms an utterance [{gpu}]")
    if not abs(got - want) <= UTMOS_ABS_TOL:
        raise AssertionError(f"UTMOS card {got} vs cpu {want}")
    ckpt = tmp / "utmos22_strong.pt"
    torch.save(cpu_model.state_dict(), ckpt)
    del card
    t0 = time.perf_counter()
    res = eval_utmos(out_dir, device=dev, ckpt=str(ckpt))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = (Path(out_dir) / "_utmos_results.jsonl").read_text().strip().splitlines()
    log(f"  eval_utmos over {res['n']} wavs on the card in {secs:.1f} s: mean "
        f"{res['utmos_mean']:.4f} [{gpu}]")
    if res["n"] != len(EVAL_PROMPTS) or len(lines) != res["n"] + 1 or not math.isfinite(
            res["utmos_mean"]):
        raise AssertionError(f"eval_utmos: {res}, {len(lines)} lines")
    ckpt.unlink()
    return {"card_vs_cpu_abs": abs(got - want), "ms_5s": ms, "eval_utmos": res,
            "eval_utmos_s": secs}


def phase23_multistyle(pipe, prompt_dir: Path, gpu: str) -> tuple[dict, dict]:
    """(d) A two-style, three-segment text through synthesize_multistyle with
    the pipeline's infer (graphed, 16 NFE): the counts set to 0 just before
    and read just after, each graph replay counted with its capture's counts
    (352 / 720 / 32 a chunk) and each new capture's eager warm-up on the
    host counter; the output as long as its segments together."""
    import torch
    from f5tts_tpu_torch.infer import audio_io
    from f5tts_tpu_torch.infer.multistyle import collect_speech_types, synthesize_multistyle
    from f5tts_tpu_torch.ops import _build

    expect = generate_launches("DiT", pipe.statics.arch)
    pieces = []

    def infer_fn(audio, ref_text, text, seed, speed):
        wav, sr = audio_io.read_wav(audio)
        wave, out_sr, _ = pipe.infer(wav, sr, ref_text, text, seed=seed, speed=speed,
                                     nfe_step=MULTISTYLE_NFE)
        pieces.append(len(wave))
        return out_sr, wave, ref_text, seed

    types = collect_speech_types(["Regular", "Whisper"],
                                 [str(prompt_dir / "prompt0.wav"), str(prompt_dir / "prompt5.wav")],
                                 [EVAL_PROMPTS[0][1], EVAL_PROMPTS[5][1]])
    before = {key: entry.replays for key, entry in pipe.graphs.items()}
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = synthesize_multistyle(MULTISTYLE_TEXT, types, infer_fn, rng=np.random.default_rng(23))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = _build.launches()
    new = [key for key in pipe.graphs if key not in before]
    chunks = sum(e.replays - before.get(k, 0) for k, e in pipe.graphs.items())
    ran = ran_launches(pipe, host, before)
    for key in new:
        if pipe.graphs[key].counts != expect:
            raise AssertionError(f"multistyle: the capture of {key} recorded "
                                 f"{pipe.graphs[key].counts}, expected {expect}")
    want_ran = {k: v * (chunks + len(new)) for k, v in expect.items()}
    log(f"  multistyle: {len(pieces)} segments, {chunks} chunks ({len(new)} new captures), "
        f"{len(res.wave) / res.sample_rate:.3f} s of audio in {wall:.3f} s, launches {ran} "
        f"(host {host}), warnings {res.warnings} [{gpu}]")
    if ran != want_ran or host != {k: v * len(new) for k, v in expect.items()}:
        raise AssertionError(f"multistyle launches {ran} (host {host}), expected {want_ran}")
    if not (len(pieces) == 3 and chunks >= 3 and not res.warnings
            and len(res.wave) == sum(pieces) and np.isfinite(res.wave).all()):
        raise AssertionError(f"multistyle: {len(pieces)} segments, {len(res.wave)} samples "
                             f"against {sum(pieces)}, warnings {res.warnings}")
    return ran, {"segments": len(pieces), "chunks": chunks, "wall_s": wall,
                 "audio_s": len(res.wave) / res.sample_rate}


def phase_evaluation(dev, gpu: str) -> tuple[dict, dict]:
    """Phase 23: test-set generation at F5TTS_v1_Base (bf16, pinyin, Vocos),
    SIM (WavLM-large + ECAPA-TDNN) and UTMOS22 at full size, multistyle."""
    import tempfile
    import torch
    from f5tts_tpu_torch.scripts.common import base_models
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab

    t_phase = time.perf_counter()
    vocab = load_vocab(EMILIA_VOCAB)
    arch, params, vocos_params = base_models()
    pipe = make_pipeline(dev, "DiT", arch, params, vocos_params, vocab_char_map=vocab,
                         tokenizer="pinyin")
    del params
    out = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        (tmp / "prompts").mkdir()
        meta = eval_prompt_set(tmp / "prompts")
        out_dir = str(tmp / "gen")
        log("  (a) get_inference_prompt + generate_batches, 32 NFE:")
        t0 = time.perf_counter()
        ran, out["generation"] = phase23_generation(pipe, vocab, meta, out_dir, gpu)
        out["generation"]["seconds"] = time.perf_counter() - t0
        log("  (d) multistyle through the pipeline's infer:")
        t0 = time.perf_counter()
        more, out["multistyle"] = phase23_multistyle(pipe, tmp / "prompts", gpu)
        out["multistyle"]["seconds"] = time.perf_counter() - t0
        for name, c in more.items():
            ran[name] = ran.get(name, 0) + c
        del pipe
        torch.cuda.empty_cache()
        pairs = [(str(tmp / "gen" / f"utt{i}.wav"), str(tmp / "prompts" / f"prompt{i}.wav"))
                 for i in range(len(EVAL_PROMPTS))]
        log("  (b) SIM: WavLM-large + ECAPA-TDNN, f32:")
        t0 = time.perf_counter()
        out["sim"] = phase23_sim(dev, pairs, tmp, gpu)
        out["sim"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        log("  (c) UTMOS22-strong, f32:")
        t0 = time.perf_counter()
        out["utmos"] = phase23_utmos(dev, out_dir, tmp, gpu)
        out["utmos"]["seconds"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 23: {out['phase_s']:.1f} s")
    return ran, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "f5tts_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: f5tts_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from f5tts_tpu_torch.scripts.common import REQUESTS, base_models, gpu_name_and_limit

    gpu = gpu_name_and_limit()

    log("phase 1: build")
    phase_build()

    log("phase 2: kernels against their plain versions")
    rows = phase_kernels(dev)

    arch, params, vocos_params = base_models()
    log("phase 3: main path, InferencePipeline.infer at F5TTS_v1_Base + Vocos, bf16")
    launches = phase_main_path(dev, arch, params, vocos_params, gpu)

    log("phase 4: card bf16 against cpu f32, depth 2")
    bf16_drift = phase_card_vs_cpu(dev, arch, params, vocos_params)
    torch.cuda.synchronize()

    log("phase 5: training path, Trainer.train at F5TTS_v1_Base, bf16 compute, f32 state")
    for name, count in phase_train(dev, arch, params, gpu).items():
        launches[name] = launches.get(name, 0) + count

    log("phase 6: training step, card bf16 against cpu f32, depth 2")
    phase_train_card_vs_cpu(dev, arch, params)
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()

    new = {}
    for phase, model, backbone, run in ((7, "E2TTS_Base", "UNetT", phase_unett),
                                        (8, "MMDiT_Base", "MMDiT", phase_mmdit)):
        new[backbone] = base_models(model=model)
        log(f"phase {phase}: InferencePipeline.infer at {model} ({backbone}) + Vocos, bf16")
        for name, count in run(dev, *new[backbone], gpu).items():
            launches[name] = launches.get(name, 0) + count
        torch.cuda.empty_cache()

    log("phase 9: card bf16 against cpu f32, depth 2, UNetT and MMDiT")
    for backbone, (arch_b, params_b, vocos_b) in new.items():
        phase_card_vs_cpu(dev, arch_b, params_b, vocos_b, backbone)
    torch.cuda.synchronize()

    from f5tts_tpu_torch.scripts.common import MMDIT_FRAMES_PER_ID

    for phase, model, backbone, cells, per_char in (
            (10, "E2TTS_Base", "UNetT", UNETT_TRAIN_CELLS, 4),
            (11, "MMDiT_Base", "MMDiT", MMDIT_TRAIN_CELLS, MMDIT_FRAMES_PER_ID)):
        log(f"phase {phase}: training path, Trainer.train at {model} ({backbone}), bf16 compute, "
            f"f32 state")
        arch_b, params_b, _ = new[backbone]
        for name, count in phase_train(dev, arch_b, params_b, gpu, backbone, cells,
                                       per_char).items():
            launches[name] = launches.get(name, 0) + count

    log("phase 12: training step, card bf16 against cpu f32, depth 2, UNetT and MMDiT")
    arch_u, params_u, _ = new["UNetT"]
    rest = {"rms_norm": 5, "conv_pos_embedding": 1}
    phase_train_card_vs_cpu(dev, arch_u, params_u, "UNetT", 1023, dict(
        rest, fused_qkv_rope_attention_lse=2, fused_qkv_rope_attention_bwd=2))
    phase_train_card_vs_cpu(dev, arch_u, params_u, "UNetT", 1023, dict(
        rest, flash_attention_lse=2, flash_attention_bwd=2), flat_max=512)
    arch_m, params_m, _ = new["MMDiT"]
    phase_train_card_vs_cpu(dev, arch_m, params_m, "MMDiT", 512, {
        "fused_qkv_rope_attention_bias_lse": 2, "fused_qkv_rope_attention_bias_bwd": 2,
        "adaln_norm": 8, "conv_pos_embedding": 1})
    torch.cuda.synchronize()

    del new
    torch.cuda.empty_cache()

    small = {}
    for model, backbone in (("F5TTS_v1_Small", "DiT"), ("E2TTS_Small", "UNetT")):
        small[model] = base_models(model=model)
        log(f"phase 13: InferencePipeline.infer at {model} ({backbone}, dim 768) + Vocos, bf16")
        for name, count in phase_small(dev, *small[model], gpu, backbone).items():
            launches[name] = launches.get(name, 0) + count
        torch.cuda.empty_cache()
    log("phase 13: InferencePipeline.infer at F5TTS_Base (RoPE on the first head) + Vocos, bf16")
    arch_b, params_b, vocos_b = base_models(model="F5TTS_Base")
    pipe = make_pipeline(dev, "DiT", arch_b, params_b, vocos_b)
    expect = generate_launches("DiT", arch_b)
    for name, count in run_requests(pipe, [(REQUESTS[0], 1014, expect)], gpu).items():
        launches[name] = launches.get(name, 0) + count
    del pipe, params_b
    torch.cuda.empty_cache()

    log("phase 14: InferencePipeline.infer at MMDiT_Base with qk_norm='rms_norm' + Vocos, bf16")
    mmdit_qk = base_models(model="MMDiT_Base", qk_norm="rms_norm")
    for name, count in phase_mmdit_qk_norm(dev, *mmdit_qk, gpu).items():
        launches[name] = launches.get(name, 0) + count
    torch.cuda.empty_cache()

    log("phase 15: card bf16 against cpu f32, depth 2: the dim-768 presets and qk-norm")
    per_step_768 = {"DiT": {"fused_qkv_rope_attention": 2, "adaln_norm": 5, "grouped_conv1d": 4},
                    "UNetT": {"fused_qkv_rope_attention": 2, "rms_norm": 5, "grouped_conv1d": 4}}
    for model, backbone in (("F5TTS_v1_Small", "DiT"), ("E2TTS_Small", "UNetT")):
        phase_card_vs_cpu(dev, *small[model], backbone, per_step_768[backbone])
    arch_q, params_q, vocos_q = mmdit_qk
    phase_card_vs_cpu(dev, arch_q, params_q, vocos_q, "MMDiT", {
        "masked_flash_attention": 2, "rms_norm": 8, "adaln_norm": 8, "conv_pos_embedding": 2})
    del mmdit_qk, params_q
    for model, backbone, rest in (("F5TTS_v1_Base", "DiT", {"adaln_norm": 5, "rms_norm": 4}),
                                  ("E2TTS_Base", "UNetT", {"rms_norm": 9})):
        arch_q, params_q, vocos_q = base_models(model=model, qk_norm="rms_norm", depth=2)
        phase_card_vs_cpu(dev, arch_q, params_q, vocos_q, backbone, dict(
            rest, flash_attention=2, conv_pos_embedding=2))
    torch.cuda.synchronize()
    del small, arch_q, params_q, vocos_q
    torch.cuda.empty_cache()

    log("phase 16: the graphed generate against the eager cfm_sample + Vocos, the 1024 bucket "
        "and the cap: DiT, E2TTS, MMDiT, MMDiT qk-norm")
    graph_rows = phase_graphs(dev, gpu)
    from f5tts_tpu_torch.eval.rtf_bench import bench_sampler

    log(f"  rtf_bench: {json.dumps(bench_sampler('F5TTS_v1_Base', device=dev))}")
    log(f"  graphs: {json.dumps(graph_rows)}")

    log("phase 17: int8 W8A8 (K12, the int8 product, K13) and the pinyin tokenizer")
    rng17 = np.random.default_rng(17)
    rows["quantize_rows"] = check_quant_rows(rng17, dev)
    rows["adaln_norm_quant"], rows["rms_norm_quant"] = check_fused_norms(rng17, dev)
    rows["gelu_quantize_rows"] = check_gelu_quant(rng17, dev)
    rows["dequant_bias"] = check_dequant(dev)
    int8_mm_rows = time_int8_products(dev, gpu)
    ran, int8_rows = phase_int8(dev, gpu, bf16_drift)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  int8: {json.dumps({'products': int8_mm_rows, **int8_rows})}")
    torch.cuda.empty_cache()

    log("phase 18: the sampler's options (midpoint, edit_mask, no_ref_audio, restart), speech "
        "editing, BigVGAN with the bigvgan mel")
    ran, option_rows = phase_sampler_options(dev, gpu)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 18: {json.dumps(option_rows)}")
    torch.cuda.empty_cache()

    log("phase 19: the long skip and average upsampling, the reference-key importer, "
        "activation checkpointing, bf16 state, training of the Small, qk-norm and unfused "
        "configurations")
    ran, flag_rows = phase_arch_flags(dev, gpu)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 19: {json.dumps(flag_rows)}")
    torch.cuda.empty_cache()

    log("phase 20: batched serving, F5TTS_v1_Base + Vocos, bf16: the serve graph a key, "
        "DynamicBatcher, HTTP, serve_bench")
    ran, serve_rows = phase_serving(dev, gpu)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 20: {json.dumps(serve_rows)}")
    torch.cuda.empty_cache()

    log("phase 21: training from data on disk, F5TTS_v1_Base, bf16, pinyin: CustomDataset, "
        "finetune_cli (full with milestone samples, LoRA), train_cli")
    ran, data_rows = phase_training_data(dev, gpu)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 21: {json.dumps(data_rows)}")
    torch.cuda.empty_cache()

    log("phase 22: multi-GPU at F5TTS_v1_Base: the kernels at 8 / 4 heads, the Trainer over "
        "an NCCL mesh of world 1 (replicated, ZeRO-1), TP-2 / DP-2 as two processes over gloo")
    ran, multi_rows = phase_multi_gpu(dev, gpu, rows)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 22 ({multi_rows['seconds']:.1f} s): {json.dumps(multi_rows)}")
    torch.cuda.empty_cache()

    log("phase 23: evaluation at F5TTS_v1_Base: test-set generation (get_inference_prompt, "
        "generate_batches at 32 NFE), SIM and UTMOS22 at full size, multistyle")
    ran, eval_rows = phase_evaluation(dev, gpu)
    for name, count in ran.items():
        launches[name] = launches.get(name, 0) + count
    log(f"  phase 23: {json.dumps(eval_rows)}")
    torch.cuda.empty_cache()

    idle = [name for name in rows if not launches.get(name)]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")
    kernels = []
    for name, row in rows.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches.get(name, 0), **row})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
