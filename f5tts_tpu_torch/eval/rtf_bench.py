"""RTF / latency benchmark of the port (counterpart of
f5tts_tpu/eval/rtf_bench.py).

    python -m f5tts_tpu_torch.eval.rtf_bench [--model F5TTS_v1_Base] [--nfe 16]
        [--seq_frames 1024] [--batch 1] [--runs 5] [--quantization none|int8]
        [--no_fused] [--bench_line] [--output rtf.txt]

Any preset of the port's `PRESETS` (text_num_embeds 2545) with random
weights from seeds (`scripts/common.base_models`: the zero-initialised
leaves randomised) and Vocos, a bf16 backbone and f32 Vocos on the card,
`seq_frames` less the backbone's prepended tokens (the UNetT's 1024 ->
1023, the widths the pipeline's buckets take), a prompt of `prompt_frames`,
128 text ids, CFG 2, sway -1; `--quantization int8` runs the pipeline's
int8 W8A8 params (`ops.quant.quantize_dit_params`), as the root bench.py
does by default. Two measurements:
- staged: `cfm_sample`, a device sync, the vocoder, a device sync: the
  sampler / vocoder split and the latency percentiles of their sum;
- fused: `InferencePipeline.fused_generate`, the one-dispatch generate (one
  CUDA-graph replay of sampler + Vocos, captured at the warm-up request),
  then the wav's checksum read back as the sync.
Prints one JSON line with the JAX bench's keys, `device` the card's name
and power limit as nvidia-smi gives them, and appends it to `--output`;
`--bench_line` also prints the root bench.py's line, its value the median
fused request. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

BASELINE_RTF = 0.0402  # the reference's offline TRT-LLM RTF, batch 1, one L20 (BASELINE.md)
HOP, SR = 256, 24000


def percentile_stats(samples_s: list[float]) -> dict:
    a = np.asarray(samples_s)
    return {
        "avg_s": float(a.mean()),
        "p50_s": float(np.percentile(a, 50)),
        "p90_s": float(np.percentile(a, 90)),
        "p95_s": float(np.percentile(a, 95)),
        "p99_s": float(np.percentile(a, 99)),
    }


def bench_sampler(model: str = "F5TTS_v1_Base", nfe: int = 16, seq_frames: int = 1024,
                  prompt_frames: int = 256, batch: int = 1, runs: int = 5,
                  quantization: str = "none", fused: bool = True, device=None) -> dict:
    """The JAX `bench_sampler`'s measurement on `device` (the card unless
    the caller names one; on the CPU the plain versions run in f32)."""
    if quantization not in ("none", "int8"):
        raise ValueError(f"unknown quantization {quantization!r}")
    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.scripts.common import base_models, gpu_name_and_limit
    from f5tts_tpu_torch.utils import make_time_grid, resolve_device
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    backbone = PRESETS[model].backbone
    bdef = cfm.BACKBONES[backbone]
    seq_frames -= bdef.seq_extra_tokens
    arch, params, vocos_params = base_models(model=model)
    pipe = InferencePipeline(params, bdef.statics_cls(arch),
                             Vocos(vocos_params, VocosConfig(), device=dev), dtype=dtype,
                             device=dev, backbone=backbone, quantization=quantization)

    rng = np.random.default_rng(0)
    cond = torch.from_numpy((rng.standard_normal((batch, seq_frames, 100)) * 0.1)
                            .astype(np.float32)).to(dev)
    text = torch.from_numpy(rng.integers(1, 2545, (batch, 128)).astype(np.int32)).to(dev)
    lens = torch.full((batch,), prompt_frames, dtype=torch.int32, device=dev)
    duration = torch.full((batch,), seq_frames, dtype=torch.int32, device=dev)
    t_grid = make_time_grid(nfe, sway_sampling_coef=-1.0).to(dev)

    def noise(seed: int) -> torch.Tensor:
        return cfm.make_noise(torch.Generator(device=dev).manual_seed(seed), batch, seq_frames,
                              100, duration)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def sample(seed: int) -> torch.Tensor:
        return cfm.cfm_sample(pipe.params, pipe.statics, cond, text, lens, duration, t_grid,
                              y0=noise(seed), cfg_strength=2.0, dtype=dtype, backbone=bdef)

    def vocode(mel: torch.Tensor) -> torch.Tensor:
        return pipe.vocoder(mel.transpose(1, 2))

    vocode(sample(1000))  # warm-up (seed 1000+: the timed seeds never repeat it)
    sync()
    dit_times, voc_times, total_times = [], [], []
    for i in range(runs):
        t0 = time.perf_counter()
        mel = sample(i)
        sync()
        t1 = time.perf_counter()
        vocode(mel)
        sync()
        t2 = time.perf_counter()
        dit_times.append(t1 - t0)
        voc_times.append(t2 - t1)
        total_times.append(t2 - t0)

    audio_s = batch * (seq_frames - prompt_frames) * HOP / SR
    total = float(np.mean(total_times))
    out = {
        "model": model, "nfe": nfe, "batch": batch, "seq_frames": seq_frames,
        "audio_seconds_per_batch": audio_s,
        "dit_s": float(np.mean(dit_times)),
        "vocoder_s": float(np.mean(voc_times)),
        "total_s": total,
        "rtf": total / audio_s,
        "audio_seconds_per_s": audio_s / total,
        "latency": percentile_stats(total_times),
        "backend": "cuda" if on_card else "plain",
        "quantization": quantization,
        "device": gpu_name_and_limit() if on_card else str(dev),
    }
    if fused:
        def fused_request(seed: int) -> float:
            _, wav = pipe.fused_generate(cond, text, lens, duration, t_grid, noise(seed), 2.0)
            return float(wav.float().sum())  # the checksum read back: a hard sync

        assert np.isfinite(fused_request(2000))  # warm-up and capture
        fused_times = []
        for i in range(runs):
            t0 = time.perf_counter()
            v = fused_request(100 + i)
            fused_times.append(time.perf_counter() - t0)
            assert np.isfinite(v)
        ft = float(np.mean(fused_times))
        out["fused_total_s"] = ft
        out["fused_rtf"] = ft / audio_s
        out["fused_audio_seconds_per_s"] = audio_s / ft
        out["fused_latency"] = percentile_stats(fused_times)
    return out


def bench_line(stats: dict) -> dict:
    """The root bench.py's line from a fused `bench_sampler` result: the
    median fused request's RTF against the reference's 0.0402."""
    rtf = stats["fused_latency"]["p50_s"] / stats["audio_seconds_per_batch"]
    name = stats["model"].lower().replace("_", "")
    return {
        "metric": f"rtf_{name}_{stats['nfe']}nfe_bs{stats['batch']}",
        "value": round(rtf, 5),
        "unit": "rtf",
        "vs_baseline": round(BASELINE_RTF / rtf, 3),
        "extra": {
            "audio_seconds_per_s_per_chip": round(stats["audio_seconds_per_batch"]
                                                  / stats["fused_latency"]["p50_s"], 2),
            "wall_s_per_utt": round(stats["fused_latency"]["p50_s"], 4),
            "backend": stats["backend"],
            "device": stats["device"],
            "nfe": stats["nfe"],
            "seq_frames": stats["seq_frames"],
            "quant": stats["quantization"],
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--nfe", type=int, default=16)
    p.add_argument("--seq_frames", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--quantization", default="none", choices=["none", "int8"])
    p.add_argument("--output", default="rtf.txt")
    p.add_argument("--no_fused", action="store_true",
                   help="skip the one-dispatch measurement (saves a warm-up and a capture)")
    p.add_argument("--bench_line", action="store_true",
                   help="also print bench.py's line (needs the fused run and --runs >= 5)")
    args = p.parse_args(argv)
    if args.bench_line and (args.no_fused or args.runs < 5):
        p.error("--bench_line takes the median of at least 5 fused requests")
    stats = bench_sampler(args.model, args.nfe, args.seq_frames, batch=args.batch,
                          runs=args.runs, quantization=args.quantization,
                          fused=not args.no_fused)
    line = json.dumps(stats)
    print(line)
    with open(args.output, "a") as f:
        f.write(line + "\n")
    if args.bench_line:
        print(json.dumps(bench_line(stats)))


if __name__ == "__main__":
    main()
