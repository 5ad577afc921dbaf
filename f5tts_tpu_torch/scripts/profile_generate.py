"""Where the time of one zero-shot request goes, on the card.

    python -m f5tts_tpu_torch.scripts.profile_generate [--out profile_generate.json]

F5TTS_v1_Base + Vocos (seeded random weights, bf16 DiT, f32 Vocos), 16 NFE,
CFG 2, sway -1, through `InferencePipeline.infer` with a fixed duration per
bucket (768, 1024 and the 4096 cap). For each bucket: one warm-up request,
3 timed requests (host clock, ending in a device sync), then one request
under torch.profiler. From the trace: device busy time (the union of kernel
intervals) against the request's wall time, kernel time and launch count by
class (the port's three kernels, GEMM including cuDNN's implicit-GEMM convs,
FFT, the rest), and the traced request's wall (the profiler's own cost).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

BUCKETS = (768, 1024, 4096)
REPS = 3
CLASSES = (
    ("fused_qkv_rope_attention", ("fused_qkv_rope_attn_kernel",)),
    ("adaln_norm", ("adaln_norm_kernel",)),
    ("conv_pos_embedding", ("conv_mish_kernel",)),
    ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("fft", ("fft", "FFT")),
)


def profile_bucket(pipe, ref, text: str, bucket: int, reps: int) -> dict:
    from f5tts_tpu_torch.scripts.common import REF_TEXT, device_time_by_class

    hop, sr = pipe.hop, pipe.sr
    fix = (bucket - 10) * hop / sr  # total frames land in this bucket

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave, _, _ = pipe.infer(ref, sr, REF_TEXT, text, seed=0, nfe_step=16,
                                cfg_strength=2.0, sway_sampling_coef=-1.0, fix_duration=fix)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(wave) / sr

    request()  # warm-up: cuBLAS/cuFFT plans for this shape
    walls = []
    for _ in range(reps):
        wall, audio_s = request()
        walls.append(wall)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_wall, _ = request()
    trace = device_time_by_class(prof, CLASSES)
    busy_ms = trace["device_busy_ms"]
    wall = statistics.median(walls)
    return {
        "bucket": bucket, "audio_s": audio_s, "wall_s": wall, "walls_s": walls,
        "rtf": wall / audio_s, "traced_wall_s": traced_wall,
        "device_busy_share_of_wall": busy_ms / (traced_wall * 1e3), **trace,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA device")

    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.scripts.common import (REQUESTS, VOCAB, base_models, gpu_name_and_limit,
                                                synthetic_ref_wav)
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    arch, params, vocos_params = base_models()
    pipe = InferencePipeline(params, dit.DiTStatics(arch), Vocos(vocos_params, VocosConfig(), device=dev),
                             vocab_char_map=VOCAB, sampling=SamplingConfig(nfe_steps=16),
                             tokenizer="char", dtype=torch.bfloat16, device=dev)
    gpu = gpu_name_and_limit()
    ref = synthetic_ref_wav()
    result = {"gpu": gpu, "torch": torch.__version__, "buckets": []}
    for bucket in BUCKETS:
        row = profile_bucket(pipe, ref, REQUESTS[1], bucket, REPS)
        result["buckets"].append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
