"""Where the time of one zero-shot request goes, on the card.

    python -m f5tts_tpu_torch.scripts.profile_generate [--model F5TTS_v1_Base]
        [--qk-norm] [--quantization none|int8] [--vocoder vocos|bigvgan]
        [--serve] [--heads H --dim-head D] [--out profile_generate.json]

`--model` any preset: F5TTS_v1_Base / F5TTS_Base / F5TTS_v1_Small /
F5TTS_Small (DiT), E2TTS_Base / E2TTS_Small (UNetT) or MMDiT_Base;
`--qk-norm` sets qk_norm="rms_norm" (its RMSNorm weights randomised);
`--heads` / `--dim-head` replace the preset's head split (e.g. 4 x 256 at
the same inner width: the head layout, K7's native wide kernel, at every n);
`--quantization int8` runs the pipeline's int8 W8A8 params (K12's modes:
K1Q / K6Q, the GELU mode, the plain K12; the int8 product, K13: their
device time is read by class, and bf16's separate GELU pass too);
`--vocoder bigvgan` the full-size BigVGAN with the bigvgan (Slaney) mel in
Vocos' place; + the vocoder (seeded random weights, bf16 backbone, f32
vocoder), 16 NFE, CFG 2, sway -1,
with a fixed duration per bucket (the F5TTS_v1_Base DiT at 768, 1024 and
the 4096 cap; the others at 1024 and the cap). For each bucket, two paths:
- graphed: `InferencePipeline.infer`, the pipeline's only CUDA path (one
  CUDA-graph replay of sampler + vocoder a request); the first request warms
  up and captures (its wall and the capture time are reported apart);
- eager: the same request's host preparation (`prepare_chunk`), then
  `cfm_sample` and the vocoder called directly, and the copies to the host.
Each path: 3 timed requests after a warm-up (host clock, ending in a device
sync), then one request under torch.profiler. From each trace: device busy
time (the union of kernel intervals) against the traced request's wall,
kernel time and launch count by class (the port's kernels, GEMM including
cuDNN's implicit-GEMM convs, cuDNN's other convs, FFT, the rest).
`--serve` measures the serving path instead: `generate_batch` (one replay
of the serve graph a batch) of b = 1, 2 and 4 requests (references of 2.0 to
2.6 s in one wav bucket, the same text) at the 512 and 1024 buckets, the
same statistics a batch, the device time a request (busy / b), the graph's
capture time and pool. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from f5tts_tpu_torch.scripts.common import K2_NAMES

# total frames a request asks for, by model: each lands in the bucket it
# names (the UNetT's 1013 + 1 time token in the 1024-row bucket; 4096 is the
# cap, 4224 rows for the UNetT)
FRAMES = {"F5TTS_v1_Base": (758, 1014, 4086), "F5TTS_Base": (1014, 4086),
          "F5TTS_v1_Small": (1014, 4086), "F5TTS_Small": (1014, 4086),
          "E2TTS_Base": (1013, 4096), "E2TTS_Small": (1013, 4096), "MMDiT_Base": (1014, 4086)}
REPS = 3
CLASSES = (
    # K12's modes, before the norms' classes (K1Q / K6Q's names hold their
    # epilogue's) and K12's (whose kernel the GELU mode is)
    ("adaln_norm_quant", ("Quant<AdaLNEpi",)),
    ("rms_norm_quant", ("Quant<RmsEpi",)),
    ("gelu_quantize_rows", ("quant_rows_kernel<GeluTanhIn",)),
    ("quantize_rows", ("quant_rows_kernel",)),
    ("dequant_bias", ("dequant_bias_kernel",)),
    ("fused_qkv_rope_attention", ("fused_qkv_rope_attn_kernel",
                                  "fused_qkv_rope_attn_krot_kernel")),
    ("fused_qkv_rope_attention_bias", ("fused_qkv_rope_attn_bias_kernel",
                                       "fused_qkv_rope_attn_bias_krot_kernel")),
    ("masked_flash_attention", ("masked_flash_attn_kernel",)),  # before its substring
    ("flash_attention", ("flash_attn_kernel", "flash_attn_wide_kernel",
                         "flash_attn_native_kernel", "flash_attn_pair_kernel")),
    ("adaln_norm", ("AdaLNEpi",)),
    ("rms_norm", ("RmsEpi",)),
    ("conv_pos_embedding", K2_NAMES),  # before K10's, whose kernel it is a mode of
    ("grouped_conv1d", ("grouped_conv1d_kernel",)),
    ("gemm", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("fft", ("fft", "FFT")),
    ("gelu", ("GeluCUDAKernelImpl",)),  # PyTorch's tanh-GELU pass (bf16: ff.out's input)
    ("conv", ("conv", "Conv", "dgrad", "cudnn")),  # cuDNN's direct convolutions (BigVGAN)
)


def profile_bucket(pipe, ref, text: str, frames: int, reps: int) -> dict:
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.scripts.common import REF_TEXT, device_time_by_class
    from f5tts_tpu_torch.utils import duration_bucket

    hop, sr = pipe.hop, pipe.sr
    fix = (frames + 0.5) * hop / sr  # exactly `frames` total frames
    bucket = duration_bucket(frames, pipe.bucket_size, pipe.sampling.max_duration,
                             pipe.bdef.seq_extra_tokens)
    kw = dict(seed=0, nfe_step=16, cfg_strength=2.0, sway_sampling_coef=-1.0, fix_duration=fix)

    def graphed() -> float:
        wave, _, _ = pipe.infer(ref, sr, REF_TEXT, text, **kw)
        return len(wave) / sr

    def eager() -> float:
        req = pipe.prepare_chunk(ref, REF_TEXT + " ", text, **kw)  # infer's ref text
        mel = cfm.cfm_sample(pipe.params, pipe.statics, req["cond"], req["text"], req["lens"],
                             req["duration"], req["t_grid"].to(pipe.device), y0=req["y0"],
                             cfg_strength=req["cfg_strength"], dtype=pipe.dtype,
                             backbone=pipe.bdef)
        pipe.vocoder(mel.transpose(1, 2)).cpu().numpy()
        mel[0, req["ref_frames"]:req["total"]].cpu().numpy()
        return (req["total"] - req["ref_frames"]) * hop / sr

    def timed(fn) -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio_s = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, audio_s

    def measure(fn) -> dict:
        first_wall, _ = timed(fn)  # warm-up: cuBLAS/cuFFT plans (graphed: and the capture)
        walls = []
        for _ in range(reps):
            wall, audio_s = timed(fn)
            walls.append(wall)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced_wall, _ = timed(fn)
        trace = device_time_by_class(prof, CLASSES)
        wall = statistics.median(walls)
        return {"audio_s": audio_s, "wall_s": wall, "walls_s": walls, "rtf": wall / audio_s,
                "first_request_s": first_wall, "traced_wall_s": traced_wall,
                "device_busy_share_of_wall": trace["device_busy_ms"] / (traced_wall * 1e3),
                **trace}

    keys = set(pipe.graphs)
    row = {"bucket": bucket, "graphed": measure(graphed)}
    (entry,) = [e for k, e in pipe.graphs.items() if k not in keys]
    row["graphed"].update(capture_s=entry.capture_s, graph_pool_mib=entry.pool_bytes / 2**20,
                          launches_a_replay=entry.counts)
    row["eager"] = measure(eager)
    return row


SERVE_FRAMES = (506, 1014)
SERVE_BATCHES = (1, 2, 4)


def profile_serve(pipe, ref, text: str, frames: int, b: int, reps: int) -> dict:
    """One (bucket, b) cell of the serving path: `generate_batch` of b
    requests, timed and traced as `profile_bucket` times a request."""
    from f5tts_tpu_torch.scripts.common import REF_TEXT, device_time_by_class

    fix = (frames + 0.5) * pipe.hop / pipe.sr
    reqs = [{"ref_wav": ref[:int((2.0 + 0.2 * i) * pipe.sr)], "ref_text": REF_TEXT + " ",
             "gen_text": text, "fix_duration": fix} for i in range(b)]

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate_batch(reqs)
        return time.perf_counter() - t0

    keys = set(pipe.serve_graphs)
    first = timed()  # warm-up and capture
    walls = [timed() for _ in range(reps)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced = timed()
    trace = device_time_by_class(prof, CLASSES)
    (key,) = [k for k in pipe.serve_graphs if k not in keys]
    entry = pipe.serve_graphs[key]
    audio_s = sum(frames - pipe.mel_cfg.frames_for_samples(len(r["ref_wav"]))
                  for r in reqs) * pipe.hop / pipe.sr
    wall = statistics.median(walls)
    return {"key": list(key), "batch": b, "audio_s": audio_s, "wall_s": wall, "walls_s": walls,
            "rtf": wall / audio_s, "first_batch_s": first, "traced_wall_s": traced,
            "device_busy_share_of_wall": trace["device_busy_ms"] / (traced * 1e3),
            "device_ms_a_request": trace["device_busy_ms"] / b,
            "capture_s": entry.capture_s, "graph_pool_mib": entry.pool_bytes / 2**20,
            "launches_a_replay": entry.counts, **trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="F5TTS_v1_Base", choices=sorted(FRAMES))
    ap.add_argument("--qk-norm", action="store_true", help='qk_norm="rms_norm"')
    ap.add_argument("--quantization", default="none", choices=["none", "int8"])
    ap.add_argument("--vocoder", default="vocos", choices=["vocos", "bigvgan"],
                    help="bigvgan also selects the bigvgan (Slaney) mel")
    ap.add_argument("--serve", action="store_true",
                    help="the serving path: generate_batch at b = 1, 2, 4, buckets 512 / 1024")
    ap.add_argument("--heads", type=int, default=None, help="replace the preset's heads")
    ap.add_argument("--dim-head", type=int, default=None, help="replace the preset's dim_head")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA device")

    from f5tts_tpu_torch.config import PRESETS, MelConfig, SamplingConfig
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models.cfm import BACKBONES
    from f5tts_tpu_torch.scripts.common import (REQUESTS, VOCAB, base_models, gpu_name_and_limit,
                                                synthetic_ref_wav)
    from f5tts_tpu_torch.vocoder.bigvgan import BigVGAN
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    dev = torch.device("cuda")
    backbone = PRESETS[args.model].backbone
    split = {k: v for k, v in (("heads", args.heads), ("dim_head", args.dim_head))
             if v is not None}
    arch, params, vocoder_params = base_models(
        model=args.model, vocoder=args.vocoder,
        **({"qk_norm": "rms_norm"} if args.qk_norm else {}), **split)
    vocoder = (BigVGAN(vocoder_params, device=dev) if args.vocoder == "bigvgan"
               else Vocos(vocoder_params, VocosConfig(), device=dev))
    pipe = InferencePipeline(params, BACKBONES[backbone].statics_cls(arch), vocoder,
                             mel_cfg=MelConfig(mel_spec_type=args.vocoder),
                             vocab_char_map=VOCAB, sampling=SamplingConfig(nfe_steps=16),
                             tokenizer="char", dtype=torch.bfloat16, device=dev,
                             backbone=backbone, quantization=args.quantization)
    gpu = gpu_name_and_limit()
    ref = synthetic_ref_wav()
    result = {"gpu": gpu, "torch": torch.__version__, "model": args.model,
              "heads": arch.heads, "dim_head": arch.dim_head,
              "qk_norm": arch.qk_norm, "quantization": args.quantization,
              "vocoder": args.vocoder, "buckets": []}
    if args.serve:
        ref = synthetic_ref_wav(seconds=3.0)
        cells = [(f, b) for f in SERVE_FRAMES for b in SERVE_BATCHES]
        for frames, b in cells:
            row = profile_serve(pipe, ref, REQUESTS[1], frames, b, REPS)
            result["buckets"].append(row)
            print(json.dumps(row), flush=True)
    for frames in () if args.serve else FRAMES[args.model]:
        row = profile_bucket(pipe, ref, REQUESTS[1], frames, REPS)
        result["buckets"].append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
