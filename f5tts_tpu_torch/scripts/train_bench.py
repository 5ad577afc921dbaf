"""Training-step throughput of F5TTS_v1_Base, E2TTS_Base or MMDiT_Base on the card.

    python -m f5tts_tpu_torch.scripts.train_bench [--model F5TTS_v1_Base]
        [--cells 16x1024,4x3072,37x1024] [--steps 5] [--out train_bench.json]
        [--remat-policy none|nothing|attn_out|attn|dots] [--bf16-state]

The counterpart of the JAX package's scripts/train_bench.py: the preset
`--model` (F5TTS_v1_Base: DiT, dim 1024, depth 22, 16 x 64 heads, ff_mult 2,
text_dim 512, conv_layers 4; E2TTS_Base: UNetT, depth 24, ff_mult 4, concat
skips; MMDiT_Base: depth 22, ff_mult 2), text_num_embeds 2545, seeded random
weights (zero-init leaves randomised), bf16 compute, f32 params and optimizer
state, one `TrainStep` (cfm_loss through the model's backbone -> backward ->
clip + AdamW + EMA, the EMA update on every step) on b rows of n frames, lens
uniform in [n/2, n]; text ids of width 256 (as the JAX bench draws them), or
for MMDiT ceil(len / 6) ids a row (`common.synthetic_text_ids`). No block is
checkpointed by default (`--remat-policy none`, the yardstick of the
training rows in PERF.md); any other `--remat-policy` checkpoints each block
(`ModelArch.checkpoint_activations`) under that policy. `--bf16-state`
stores mu / nu and the EMA in bf16.

Cells (b x n), by default 16 x 1024 (the JAX bench default), the long band
(4 x 3072: K4's and, for MMDiT, K8's long joint band; 4 x 4096 for E2TTS:
the cap, 4224 rows, past the flat gate, K7's lse mode and K9) and 37 x 1024
(37,888 frames: whole 1024-frame rows within the reference's per-device
budget of 38,400 frames, TrainConfig.batch_size_per_device).
For each: 2 warm-up steps, then `steps` timed steps (host clock ending in a
device sync): ms/step, frames/s (b * n padded frames a step, as the JAX bench
counts, and the live frames), peak torch.cuda.max_memory_allocated; then one
step under torch.profiler: its device busy time against that step's wall
(the profiler's cost included) and against the median untraced step, device
time by class and the 15 kernels that took the most. A cell that runs out
of device memory is recorded as such. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from f5tts_tpu_torch.scripts.common import K2_NAMES

CELLS = {"F5TTS_v1_Base": "16x1024,4x3072,37x1024", "E2TTS_Base": "16x1024,4x4096,37x1024",
         "MMDiT_Base": "16x1024,4x3072,37x1024"}
CLASSES = (
    ("attention_fwd K3", ("fused_qkv_rope_attn_kernel", "fused_qkv_rope_attn_lse_kernel",
                          "fused_qkv_rope_attn_krot_kernel")),
    ("attention_bwd K4", ("attn_bwd_prologue_kernel", "attn_bwd_dq_kernel",
                          "attn_bwd_dkdv_kernel")),
    ("attention_fwd K5", ("fused_qkv_rope_attn_bias_kernel",
                          "fused_qkv_rope_attn_bias_lse_kernel",
                          "fused_qkv_rope_attn_bias_krot_kernel")),
    ("attention_bwd K8", ("attn_bias_bwd_prologue_kernel", "attn_bias_bwd_dq_kernel",
                          "attn_bias_bwd_dkdv_kernel")),
    ("attention_fwd K7 lse", ("flash_attn_lse_kernel",)),
    ("attention_bwd K9", ("flash_bwd_delta_kernel", "flash_bwd_dq_kernel",
                          "flash_bwd_dkdv_kernel")),
    ("adaln_norm K1", ("AdaLNEpi",)),
    ("rms_norm K6", ("RmsEpi",)),
    ("conv_pos K2", K2_NAMES),
    ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("conv (cuDNN, K2/ConvNeXt backward)", ("conv", "Conv", "cudnn", "dgrad", "wgrad")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
)


def run_cell(step_fn, state, b: int, n: int, steps: int, dev, model: str) -> dict:
    from f5tts_tpu_torch.scripts.common import synthetic_text_ids

    rng = np.random.default_rng(0)
    mel = torch.from_numpy((rng.standard_normal((b, n, 100)) * 0.3).astype(np.float32)).to(dev)
    lens_np = rng.integers(n // 2, n + 1, (b,)).astype(np.int32)
    text = torch.from_numpy(synthetic_text_ids(rng, lens_np, model)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    row = {"batch": b, "frames": n, "text_ids": text.shape[1], "padded_frames_per_step": b * n,
           "live_frames_per_step": int(lens.sum())}

    def one(i: int):
        return step_fn(state, mel * (1.0 + 0.01 * i), text, lens, generator=gen)[1]

    try:
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(2):
            m = one(i)
        torch.cuda.synchronize(dev)
        walls, losses = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            m = one(2 + i)
            losses.append(m["loss"])
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            one(100)
            torch.cuda.synchronize(dev)
            traced = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.synchronize(dev)
        return {**row, "oom": True, "error": str(e).splitlines()[0]}
    from f5tts_tpu_torch.scripts.common import device_time_by_class

    loss = [float(v) for v in losses]
    if not all(np.isfinite(loss)):
        raise AssertionError(f"non-finite loss at b={b} n={n}: {loss}")
    ms = statistics.median(walls) * 1e3
    trace = device_time_by_class(prof, CLASSES, top=15)
    return {**row, "oom": False, "ms_per_step": ms, "ms_per_step_all": [w * 1e3 for w in walls],
            "frames_per_s": b * n / ms * 1e3, "live_frames_per_s": row["live_frames_per_step"] / ms * 1e3,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "losses": loss,
            "grad_norm": float(m["grad_norm"]), "traced_step_ms": traced * 1e3,
            "device_busy_share": trace["device_busy_ms"] / (traced * 1e3),
            "device_busy_share_of_median_step": trace["device_busy_ms"] / ms, **trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="F5TTS_v1_Base", choices=sorted(CELLS))
    ap.add_argument("--cells", default=None, help="b x n cells (default: the model's)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--remat-policy", default="none",
                    choices=["none", "nothing", "attn_out", "attn", "dots"],
                    help="checkpoint each block under this policy (none: no checkpointing)")
    ap.add_argument("--bf16-state", action="store_true",
                    help="store AdamW's mu / nu and the EMA in bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_bench needs a CUDA device")

    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.models.modules import tree_leaves
    from f5tts_tpu_torch.scripts.common import base_models, gpu_name_and_limit
    from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bdef = BACKBONES[PRESETS[args.model].backbone]
    remat = args.remat_policy != "none"
    arch, params, _ = base_models(model=args.model, checkpoint_activations=remat,
                                  remat_policy=args.remat_policy if remat else "nothing")
    sdt = torch.bfloat16 if args.bf16_state else None
    state = init_train_state(params, dev, moment_dtype=sdt, ema_dtype=sdt)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    del params
    step_fn = make_train_step(bdef.statics_cls(arch, dev), make_optimizer(7.5e-5, 1000, 10000),
                              ema_update_every=1, ema_update_after_step=0, backbone=bdef)
    gpu = gpu_name_and_limit()
    result = {"gpu": gpu, "torch": torch.__version__, "model": args.model,
              "parameters": n_params, "cells": [],
              "remat_policy": args.remat_policy if remat else None,
              "bf16_state": args.bf16_state}
    for cell in (args.cells or CELLS[args.model]).split(","):
        b, n = (int(v) for v in cell.split("x"))
        row = run_cell(step_fn, state, b, n, args.steps, dev, args.model)
        result["cells"].append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
