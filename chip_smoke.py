#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (f5tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
1. Build every kernel from f5tts_tpu_torch/csrc with nvcc (set-up time).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with seeded inputs: max-abs error over live rows against
   a stated tolerance, median time from CUDA-graph replays, the bound, the
   plain version's time and, for attention, F.scaled_dot_product_attention's
   time as a yardstick (the port never calls it). The attention backward K4
   (b = 2, h = 16, lengths [n, 777], n = 1024, 3072, 4096): dQKV rel-L2 and
   max-abs over live rows, dead rows exactly 0, SDPA's backward (fwd+bwd
   minus fwd on the same pre-roped inputs) as the yardstick.
3. The main path: InferencePipeline.infer at F5TTS_v1_Base + Vocos, random
   weights from a seed (the zero-initialised AdaLN, norm_out and proj_out
   weights randomised), three requests, 16 NFE, CFG 2, sway -1. Every wav
   must be finite and non-silent, and each 16-NFE generate must launch the
   attention / AdaLN-norm / conv-position kernels 22*16 / 45*16 / 2*16 times.
4. The same weights cut to depth 2: cfm_sample (y0 given, 4 NFE, n = 1024)
   and Vocos on the card in bf16 (the kernels) against the CPU in f32 (the
   plain versions); the mel's rel-L2 over generated frames must be <= 3e-2.
5. The training path: Trainer.train at F5TTS_v1_Base (bf16 compute, f32
   params and AdamW/EMA state) on seeded in-memory datasets, 4 updates at
   b = 16, n = 1024 (lens in [512, 1024]) and 2 at b = 4, n = 3072. Loss and
   grad norm finite, every parameter leaf changed, the EMA on its cadence
   (every 2 updates: a copy at update 2, a decay at update 4), and each update
   launches K3 / K4 / K1 / K2 exactly 22 / 22 / 45 / 1 times.
6. One training step at depth 2 (b = 4, n = 512), the same draws, on the card
   in bf16 (the kernels) against the CPU in f32 (the plain versions): loss
   within 2e-2 relative, each gradient leaf's rel-L2 <= 1e-1.

Prints the `kernels` JSON line (launches: the inference and training paths
of phases 3 and 5), the card's name and power limit, and as the last line
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
TOL = {"adaln_norm": 2e-2, "conv_pos_embedding": 3e-2, "fused_qkv_rope_attention": 2e-2}
# K4's dQKV over live rows: rel-L2, and max-abs against the largest entry of
# the plain version's dQKV (whose scale grows with n)
BWD_REL_L2_TOL = 1e-2
BWD_MAX_ABS_REL_TOL = 2e-2
REPLACES = {
    "adaln_norm": "f5tts_tpu/ops/adaln_norm.py:48",
    "conv_pos_embedding": "f5tts_tpu/ops/grouped_conv.py:168",
    "fused_qkv_rope_attention": "f5tts_tpu/ops/attention.py:567 (+ :659 stream twin)",
    "fused_qkv_rope_attention_bwd": "f5tts_tpu/ops/attention.py:886 (+ :970 long twin)",
}
SOURCES = {
    "adaln_norm": "f5tts_tpu_torch/csrc/adaln_norm.cu",
    "conv_pos_embedding": "f5tts_tpu_torch/csrc/grouped_conv.cu",
    "fused_qkv_rope_attention": "f5tts_tpu_torch/csrc/attention.cu",
    "fused_qkv_rope_attention_bwd": "f5tts_tpu_torch/csrc/attention_bwd.cu",
}
NFE = 16
TRAIN_CELLS = ((16, 1024, 4), (4, 3072, 2))  # (batch, frames, updates)
PER_UPDATE = {"fused_qkv_rope_attention": 22, "fused_qkv_rope_attention_bwd": 22,
              "adaln_norm": 45, "conv_pos_embedding": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, iters: int = 15) -> float:
    """Median device time of one fn() call: fn is captured `reps` times in one
    CUDA graph, and each replay is timed with CUDA events (no host launch
    overhead inside the window)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


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

def check_adaln(rng, dev) -> dict:
    import torch
    from f5tts_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_ref

    b, n, d = 2, 1024, 1024
    x = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).to(dev, torch.bfloat16)
    mods = torch.from_numpy((0.05 * rng.standard_normal((b, 6 * d))).astype(np.float32))
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
    log(f"  adaln_norm [2,1024,1024] bf16: max_abs_err {err:.3e} (tol {TOL['adaln_norm']}), "
        f"{ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms (bytes), plain {plain:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


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
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": "operations", "library_ms": None}
        if out_row is None:
            out_row = row
        out_row["max_abs_err"] = max(out_row["max_abs_err"], err)
    return out_row


def check_attention(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import fused_qkv_rope_attention, fused_qkv_rope_attention_ref
    from f5tts_tpu_torch.ops.rope import apply_rotary_flat_tables, rope_flat_tables, rope_freqs_interleaved

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
        q, k, v = qkv.split(hd, dim=-1)
        qh, kh, vh = (t.reshape(b, n, h, d).transpose(1, 2).contiguous() for t in
                      (apply_rotary_flat_tables(q, cos, sin), apply_rotary_flat_tables(k, cos, sin), v))
        kmask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=kmask))
        log(f"  fused_qkv_rope_attention b=2 h=16 d=64 n={n} lengths [{n}, 777]: max_abs_err "
            f"{err:.3e} (tol {TOL['fused_qkv_rope_attention']}), dead rows max {dead:.1e}, "
            f"{ms:.4f} ms (eager call {wall:.4f} ms), bound {bound:.4f} ms (operations), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms")
        if dead != 0.0:
            raise AssertionError("fused_qkv_rope_attention: rows >= length are not zero")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": "operations", "library_ms": lib}
        if out_row is None:
            out_row = row
        out_row["max_abs_err"] = max(out_row["max_abs_err"], err)
    return out_row


def check_attention_bwd(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F
    from f5tts_tpu_torch.ops.attention import (fused_qkv_rope_attention_bwd,
                                               fused_qkv_rope_attention_bwd_ref)
    from f5tts_tpu_torch.ops.rope import apply_rotary_flat_tables, rope_flat_tables, rope_freqs_interleaved

    b, h, d = 2, 16, 64
    hd = h * d
    out_row = None
    for n in (1024, 3072, 4096):
        lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * hd)).astype(np.float32)).to(dev, torch.bfloat16)
        dout = torch.from_numpy(rng.standard_normal((b, n, hd)).astype(np.float32)).to(dev, torch.bfloat16)
        cos, sin = rope_flat_tables(rope_freqs_interleaved(d, n).to(dev), n, h, dtype=torch.bfloat16)
        got = fused_qkv_rope_attention_bwd(qkv, cos, sin, lengths, dout, h)
        want = fused_qkv_rope_attention_bwd_ref(qkv, cos, sin, lengths, dout, h)
        torch.cuda.synchronize()
        live = torch.arange(n, device=dev)[None, :] < lengths[:, None]
        a, w = got.float()[live], want.float()[live]
        rel = float((a - w).norm() / w.norm())
        err, top = float((a - w).abs().max()), float(w.abs().max())
        dead = float(got[1, 777:].abs().max())
        sq = sum(int(v) ** 2 for v in lengths.tolist())
        flops = 10 * h * d * sq
        nbytes = (2 * b * n * 3 * hd + b * n * hd + 2 * n * hd) * 2
        bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(lambda: fused_qkv_rope_attention_bwd(qkv, cos, sin, lengths, dout, h))
        wall = wall_ms(lambda: fused_qkv_rope_attention_bwd(qkv, cos, sin, lengths, dout, h))
        plain = time_ms(lambda: fused_qkv_rope_attention_bwd_ref(qkv, cos, sin, lengths, dout, h),
                        reps=1, iters=3)
        # yardstick: SDPA's backward on pre-roped [b, h, n, d], the same key
        # mask, as (fwd + bwd) - fwd
        q, k, v = qkv.split(hd, dim=-1)
        qh, kh, vh = (t.reshape(b, n, h, d).transpose(1, 2).contiguous().requires_grad_() for t in
                      (apply_rotary_flat_tables(q, cos, sin), apply_rotary_flat_tables(k, cos, sin), v))
        gh = dout.reshape(b, n, h, d).transpose(1, 2).contiguous()
        kmask = (torch.arange(n, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=kmask)
            return torch.autograd.grad(o, (qh, kh, vh), gh)

        with torch.no_grad():
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=kmask))
        lib = time_ms(sdpa_fwd_bwd) - lib_fwd
        log(f"  fused_qkv_rope_attention_bwd b=2 h=16 d=64 n={n} lengths [{n}, 777]: rel-L2 "
            f"{rel:.3e} (tol {BWD_REL_L2_TOL}), max_abs_err {err:.3e} (tol {BWD_MAX_ABS_REL_TOL} x "
            f"largest entry {top:.3e}), dead rows max {dead:.1e}, {ms:.4f} ms "
            f"(eager call {wall:.4f} ms), bound {bound:.4f} ms (operations), plain {plain:.4f} ms, "
            f"sdpa bwd {lib:.4f} ms (fwd {lib_fwd:.4f} ms)")
        if dead != 0.0:
            raise AssertionError("fused_qkv_rope_attention_bwd: dead rows are not zero")
        if not (rel <= BWD_REL_L2_TOL and err <= BWD_MAX_ABS_REL_TOL * top):
            raise AssertionError(f"fused_qkv_rope_attention_bwd at n={n}: rel-L2 {rel}, "
                                 f"max_abs_err {err} against largest entry {top}")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": "operations", "library_ms": lib}
        if out_row is None:
            out_row = row
        out_row["max_abs_err"] = max(out_row["max_abs_err"], err)
    return out_row


def phase_kernels(dev) -> dict:
    import torch

    rng = np.random.default_rng(0)
    rows = {"adaln_norm": check_adaln(rng, dev),
            "conv_pos_embedding": check_conv_pos(rng, dev),
            "fused_qkv_rope_attention": check_attention(rng, dev),
            "fused_qkv_rope_attention_bwd": check_attention_bwd(rng, dev)}
    torch.cuda.synchronize()
    for name, tol in TOL.items():
        if not rows[name]["max_abs_err"] <= tol:
            raise AssertionError(f"{name}: max_abs_err {rows[name]['max_abs_err']} > {tol}")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

def phase_main_path(dev, arch, params, vocos_params, gpu: str) -> dict:
    import torch
    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import REF_TEXT, REQUESTS, VOCAB, synthetic_ref_wav
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    pipe = InferencePipeline(params, dit.DiTStatics(arch), Vocos(vocos_params, VocosConfig(), device=dev),
                             vocab_char_map=VOCAB, sampling=SamplingConfig(nfe_steps=NFE),
                             tokenizer="char", dtype=torch.bfloat16, device=dev)
    ref = synthetic_ref_wav()
    expect = {"fused_qkv_rope_attention": arch.depth * NFE,
              "adaln_norm": (2 * arch.depth + 1) * NFE, "conv_pos_embedding": 2 * NFE}
    total = {k: 0 for k in expect}
    for i, text in enumerate(REQUESTS):
        torch.cuda.synchronize()
        _build.reset_launches()  # every count to 0 just before the request
        t0 = time.perf_counter()
        wave, sr, mel = pipe.infer(ref, 24000, REF_TEXT, text, seed=i, nfe_step=NFE,
                                   cfg_strength=2.0, sway_sampling_coef=-1.0)
        wall = time.perf_counter() - t0
        counts = _build.launches()
        secs = len(wave) / sr
        rms = float(np.sqrt(np.mean(np.square(wave)))) if wave.size else 0.0
        log(f"  request {i}: {secs:.3f} s of audio ({mel.shape[1]} frames), wall {wall:.4f} s, "
            f"RTF {wall / max(secs, 1e-9):.5f}, rms {rms:.4f}, launches {counts} [{gpu}]")
        if not (wave.size and np.isfinite(wave).all() and np.isfinite(mel).all() and rms > 1e-4):
            raise AssertionError(f"request {i}: wav is empty, non-finite or silent")
        for name, want in expect.items():
            if counts.get(name, 0) != want:
                raise AssertionError(f"request {i}: {name} launched {counts.get(name, 0)} "
                                     f"times, expected {want} for one {NFE}-NFE generate")
            total[name] += counts[name]
    torch.cuda.synchronize()
    return total


def phase_card_vs_cpu(dev, arch, params, vocos_params) -> float:
    import torch
    from f5tts_tpu_torch.models import cfm, dit
    from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast
    from f5tts_tpu_torch.ops.mel import MelFrontend
    from f5tts_tpu_torch.scripts.common import synthetic_ref_wav
    from f5tts_tpu_torch.utils import make_time_grid
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    arch2 = dataclasses.replace(arch, depth=2)
    p2 = fuse_backbone_qkv(dict(params, blocks=params["blocks"][:2]))
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

    mels, waves = {}, {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        pw = tree_cast(p2, dtype, where)
        statics = dit.DiTStatics(arch2, where)
        t0 = time.perf_counter()
        mel = cfm.cfm_sample(pw, statics, cond.to(where), text.to(where), lens.to(where),
                             dur.to(where), grid.to(where), y0=y0.to(where), cfg_strength=2.0,
                             dtype=dtype)
        wav = Vocos(vocos_params, VocosConfig(), device=where)(mel.transpose(1, 2))
        mels[where.type], waves[where.type] = mel.float().cpu(), wav.float().cpu()
        log(f"  {where.type} {str(dtype)[6:]}: depth 2, {nfe} NFE, n {n}: "
            f"{time.perf_counter() - t0:.2f} s")
    a, b = mels["cuda"][:, prompt:total], mels["cpu"][:, prompt:total]
    rel = float((a - b).norm() / b.norm())
    wa, wb = waves["cuda"], waves["cpu"]
    wrel = float((wa - wb).norm() / wb.norm())
    log(f"  card bf16 vs cpu f32: mel rel-L2 {rel:.4e} (tol 3e-2), wav rel-L2 {wrel:.4e}")
    if not (np.isfinite(rel) and rel <= 3e-2):
        raise AssertionError(f"card vs cpu mel rel-L2 {rel} > 3e-2")
    return rel


# ---------------------------------------------------------------------------
# phases 5 and 6
# ---------------------------------------------------------------------------

def _train_dataset(rng, b: int, n: int):
    """b rows of mel with lens in [n/2, n] (the longest exactly n) and char text."""
    from f5tts_tpu_torch.scripts.common import VOCAB
    from f5tts_tpu_torch.train.dataset import InMemoryDataset

    lens = rng.integers(n // 2, n + 1, b)
    lens[0] = n
    chars = np.array(list(VOCAB))
    mels = [rng.standard_normal((int(t), 100)).astype(np.float32) for t in lens]
    texts = ["".join(rng.choice(chars, size=int(t) // 4)) for t in lens]
    return InMemoryDataset(mels, texts), int(lens.sum())


def phase_train(dev, arch, params, gpu: str) -> dict:
    import shutil
    import tempfile

    import torch
    from f5tts_tpu_torch.config import TrainConfig
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.scripts.common import VOCAB
    from f5tts_tpu_torch.train.step import ema_alpha
    from f5tts_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(11)
    total = {k: 0 for k in PER_UPDATE}
    base = tree_leaves(params)
    for b, n, updates in TRAIN_CELLS:
        data, live = _train_dataset(rng, b, n)
        save_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        # one batch of all b rows an epoch; the EMA copies at update 2 and
        # decays at update 4 (every 2, after 2)
        cfg = TrainConfig(batch_size_per_device=b * n, max_samples=b, epochs=updates + 1,
                          num_warmup_updates=2, ema_update_every=2, ema_update_after_step=2,
                          save_dir=save_dir, save_per_updates=10 ** 9, last_per_updates=10 ** 9,
                          logger=None)
        trainer = Trainer(params, dit.DiTStatics(arch), cfg, vocab_char_map=VOCAB, device=dev)
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
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        steady = [r["wall_ms"] for r in rows[1:]] or [rows[0]["wall_ms"]]
        ms = statistics.median(steady)
        for r in rows:
            log(f"  b={b} n={n} update {r['update']}: loss {r['loss']:.5f}, grad norm "
                f"{r['grad_norm']:.4f}, wall {r['wall_ms']:.1f} ms, launches {r['launches']}")
        log(f"  b={b} n={n} ({live} live frames): {ms:.1f} ms/step (median of updates 2..), "
            f"{b * n / ms * 1e3:.0f} frames/s padded, {live / ms * 1e3:.0f} live, peak "
            f"{peak:.2f} GB allocated [{gpu}]")
        for r in rows:
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"b={b} n={n} update {r['update']}: non-finite loss or grad norm")
            if r["launches"] != PER_UPDATE:
                raise AssertionError(f"b={b} n={n} update {r['update']}: launches {r['launches']}, "
                                     f"expected {PER_UPDATE}")
            for k in total:
                total[k] += r["launches"][k]
        unchanged = [i for i, (a, p0) in enumerate(zip(tree_leaves(trainer.state.params), base))
                     if torch.equal(a.cpu(), p0)]
        if unchanged:
            raise AssertionError(f"b={b} n={n}: {len(unchanged)} parameter leaves did not change")
        for u in range(1, updates + 1):
            alpha = ema_alpha(u, cfg.ema_decay, cfg.ema_update_every, cfg.ema_update_after_step)
            want = emas[u - 1] * float(alpha) + ps[u] * float(np.float32(1.0) - alpha)
            if not torch.allclose(emas[u], want, rtol=1e-6, atol=1e-7):
                raise AssertionError(f"b={b} n={n}: the EMA is off its cadence at update {u}")
        del trainer
        shutil.rmtree(save_dir)
        torch.cuda.empty_cache()
    return total


def phase_train_card_vs_cpu(dev, arch, params) -> None:
    import torch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import make_draws
    from f5tts_tpu_torch.models.modules import tree_cast, tree_leaves
    from f5tts_tpu_torch.ops import _build
    from f5tts_tpu_torch.train.step import make_optimizer, make_train_step

    arch2 = dataclasses.replace(arch, depth=2)
    p2 = dict(params, blocks=params["blocks"][:2])
    b, n = 4, 512
    rng = np.random.default_rng(12)
    mel = torch.from_numpy(rng.standard_normal((b, n, 100)).astype(np.float32))
    text = torch.from_numpy(rng.integers(1, 96, (b, 128)).astype(np.int32))
    lens = torch.tensor([512, 400, 300, 450], dtype=torch.int32)
    draws = make_draws(torch.Generator().manual_seed(5), b, n, 100)
    out = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        step = make_train_step(dit.DiTStatics(arch2, where), make_optimizer(7.5e-5, 10, 100),
                               dtype=dtype)
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, grads = step.grad_step(tree_cast(p2, torch.float32, where), mel.to(where),
                                     text.to(where), lens.to(where), draws=draws)
        out[where.type] = (float(loss), [g.float().cpu() for g in tree_leaves(grads)])
        log(f"  {where.type} {str(dtype)[6:]}: depth 2, b {b}, n {n}: loss {float(loss):.6f}, "
            f"{time.perf_counter() - t0:.2f} s, launches {_build.launches()}")
        if where.type == "cuda" and _build.launches() != {
                "fused_qkv_rope_attention": 2, "fused_qkv_rope_attention_bwd": 2,
                "adaln_norm": 5, "conv_pos_embedding": 1}:
            raise AssertionError(f"depth-2 training step launches {_build.launches()}")
    (la, ga), (lb, gb) = out["cuda"], out["cpu"]
    rels = [float((a - w).norm() / w.norm()) for a, w in zip(ga, gb) if float(w.norm()) > 0]
    loss_rel = abs(la - lb) / abs(lb)
    log(f"  card bf16 vs cpu f32: loss rel {loss_rel:.3e} (tol 2e-2), gradient rel-L2 over "
        f"{len(rels)} leaves: median {statistics.median(rels):.3e}, max {max(rels):.3e} (tol 1e-1)")
    if not (loss_rel <= 2e-2 and max(rels) <= 1e-1):
        raise AssertionError("training step: card bf16 and cpu f32 disagree")


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

    from f5tts_tpu_torch.scripts.common import base_models, gpu_name_and_limit

    gpu = gpu_name_and_limit()

    log("phase 1: build")
    phase_build()

    log("phase 2: kernels against their plain versions")
    rows = phase_kernels(dev)

    arch, params, vocos_params = base_models()
    log("phase 3: main path, InferencePipeline.infer at F5TTS_v1_Base + Vocos, bf16")
    launches = phase_main_path(dev, arch, params, vocos_params, gpu)

    log("phase 4: card bf16 against cpu f32, depth 2")
    phase_card_vs_cpu(dev, arch, params, vocos_params)
    torch.cuda.synchronize()

    log("phase 5: training path, Trainer.train at F5TTS_v1_Base, bf16 compute, f32 state")
    for name, count in phase_train(dev, arch, params, gpu).items():
        launches[name] = launches.get(name, 0) + count

    log("phase 6: training step, card bf16 against cpu f32, depth 2")
    phase_train_card_vs_cpu(dev, arch, params)
    torch.cuda.synchronize()

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
