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

Prints the `kernels` JSON line (launches: what the card ran on the
inference and training paths of phases 3, 5, 7, 8, 10, 11, 13, 14, 17, 18
and 19, each graph replay counted with its capture's counts), the card's name
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


def joint_case(rng, dev, na: int, nt: int, gap=None):
    """K5's / K8's phase-2 inputs at joint n = na + nt: qkv, the joint rope
    tables and the key mask (row 0: audio live to 777 of 1024, 3/4 of longer
    buckets, text 100 live; row 1: all audio live but the keys of `gap`, text
    120: dead keys mid-sequence)."""
    import torch
    from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved

    b, h, d = 2, 16, 64
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
                          vocab_char_map=VOCAB, device=dev)
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
