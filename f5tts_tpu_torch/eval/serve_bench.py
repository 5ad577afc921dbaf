"""Client-server benchmark of the port (counterpart of
f5tts_tpu/eval/serve_bench.py): the HTTP front end over the DynamicBatcher
at concurrency C.

Its yardstick is the reference's Triton client-server row (README.md:131-140
of the reference: 26 prompt / target pairs, concurrency 2, on one NVIDIA
L20: RTF 0.0394, average latency 253 ms). The bench starts the stdlib HTTP
server over a `DynamicBatcher` (max batch 4, a 1 ms window, as the
reference's config.pbtxt), sends N distinct requests from C client threads
and reports the aggregate RTF and the latency percentiles, for each
batching window asked for; with `--stream N` also the time to the first
byte of N `/tts_stream` requests on the fine first-chunk bucket.

The model is F5TTS_v1_Base with random weights from seeds
(`scripts/common.base_models`), text_num_embeds 2545, the pinyin tokenizer
and the Emilia vocab, Vocos; bf16 on the card, f32 on the CPU; the
`--quantization int8` W8A8 params when asked. Before the sweep it captures
the serve graphs of every (bucket, batch) the sweep can form.

    python -m f5tts_tpu_torch.eval.serve_bench [--requests 26] [--concurrency 2]
        [--window_ms 1] [--stream N] [--profile long|ref] [--quantization int8]

Prints one JSON line with the JAX bench's keys on stdout, `device` (the
card's name and power limit) and, with `--stream`, the timed streams'
`stream_server_stats` added; `main` also returns it.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import struct
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np

BASELINE_RTF = 0.0394          # the reference's Triton client-server RTF, concurrency 2, one L20
BASELINE_LATENCY_MS = 253.0    # its average latency there

# ~4.5 s and ~9 s of speech at the reference speaking rate; with the ~4 s
# references they land in the 768 / 1024-frame buckets warmed below
GEN_SHORT = ("The quick brown fox jumps over the lazy dog while the "
             "morning sun rises slowly over the quiet valley town.")
GEN_LONG = GEN_SHORT + (" Meanwhile the river keeps flowing past the old "
                        "stone bridge, carrying small boats and fallen "
                        "leaves toward the distant sea, and the fishermen "
                        "wave at every traveler passing by the shore road.")
REF_TEXT = "This is the reference voice sample for the benchmark. "


def build_pipeline(nfe: int, quantization: str = "none", device=None):
    """The bench's InferencePipeline on `device` (the card unless named)."""
    import torch

    from f5tts_tpu_torch.config import SamplingConfig
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.scripts.common import base_models
    from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
    from f5tts_tpu_torch.utils import resolve_device
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

    dev = resolve_device(device)
    arch, params, vocos_params = base_models(model="F5TTS_v1_Base")
    return InferencePipeline(
        params, dit.DiTStatics(arch, dev), Vocos(vocos_params, VocosConfig(), device=dev),
        vocab_char_map=load_vocab(EMILIA_VOCAB),
        sampling=dataclasses.replace(SamplingConfig(), nfe_steps=nfe), tokenizer="pinyin",
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32, device=dev,
        quantization=quantization)


def make_payloads(n: int, sr: int, profile: str = "long") -> list[dict]:
    """n distinct requests (a different reference wav and text each):
    - "long": ~4 s references, 8.0 / 10.8 s totals (4-6.8 s generated), a
      harsher set than the reference's protocol;
    - "ref": ~2 s references, 5.4 s totals (~3.4 s generated), the scale of
      the reference's prompt / text pairs (its 253 ms row)."""
    rng = np.random.default_rng(0)
    payloads = []
    for i in range(n):
        ref_secs = (3.8 + 0.02 * (i % 8)) if profile == "long" else (1.9 + 0.02 * (i % 8))
        ref_len = int(sr * ref_secs)
        ref = (rng.standard_normal(ref_len) * 0.05).astype(np.float32)
        pcm = (np.clip(ref, -1, 1) * 32767).astype("<i2").tobytes()
        hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " + struct.pack(
            "<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) + b"data" + struct.pack("<I", len(pcm))
        gen = (GEN_SHORT if i % 2 == 0 else GEN_LONG) + f" Take {i}."
        if profile == "long":
            fix = 8.0 if i % 2 == 0 else 10.8  # the 768 / 1024-frame buckets
        else:
            gen = GEN_SHORT + f" Take {i}."
            fix = 5.4  # the 512-frame bucket
        payloads.append({
            "ref_audio_b64": base64.b64encode(hdr + pcm).decode(),
            "ref_text": REF_TEXT,
            "gen_text": gen,
            "fix_duration": fix,  # totals pinned to the warmed buckets
        })
    return payloads


def _serve(pipe, sr: int, max_batch: int, window_ms: float):
    from f5tts_tpu_torch.infer.serve import DynamicBatcher, make_handler

    batcher = DynamicBatcher(pipe, max_batch_size=max_batch, max_queue_delay_s=window_ms / 1000.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher, sr, pipeline=pipe))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return batcher, server, f"http://127.0.0.1:{server.server_address[1]}"


def main(argv=None, pipe=None) -> dict:
    """Run the bench; `pipe` replaces `build_pipeline`'s (a smaller model)."""
    from f5tts_tpu_torch.infer import audio_io
    from f5tts_tpu_torch.infer.client_http import send_request, send_request_stream
    from f5tts_tpu_torch.infer.pipeline import chunk_text_low_ttfb

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=26)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="the card unless named (e.g. 'cpu')")
    ap.add_argument("--quantization", default="none")
    ap.add_argument("--window_ms", type=float, nargs="+", default=[1.0],
                    help="batching windows to sweep; the best-p50 row is the headline")
    ap.add_argument("--fine_stream", action=argparse.BooleanOptionalAction, default=True,
                    help="warm and use the half-granularity first-chunk bucket in the "
                         "stream sweep")
    ap.add_argument("--stream", type=int, default=0,
                    help="also measure the time to first byte of N /tts_stream requests")
    ap.add_argument("--profile", choices=["long", "ref"], default="long",
                    help="'long': 8 / 10.8 s totals; 'ref': 5.4 s totals, the scale of the "
                         "reference protocol's 253 ms row")
    args = ap.parse_args(argv)

    if pipe is None:
        pipe = build_pipeline(args.nfe, args.quantization, args.device)
    sr = pipe.sr

    # capture every (bucket, batch) the sweep can form: with C clients,
    # batches of 1..min(C, max_batch) (padded to powers of two)
    rng = np.random.default_rng(99)
    t0 = time.time()
    warm_combos = ((8.0, GEN_SHORT), (10.8, GEN_LONG)) if args.profile == "long" \
        else ((5.4, GEN_SHORT),)
    warm_ref_secs = 4 if args.profile == "long" else 2  # the payloads' wav bucket
    for fd, gen in warm_combos:
        for bsz in range(1, min(args.concurrency, args.max_batch) + 1):
            reqs = [{
                "ref_wav": (rng.standard_normal(sr * warm_ref_secs) * 0.05).astype(np.float32),
                "ref_text": REF_TEXT, "gen_text": gen + f" Warm {j}.", "fix_duration": fd,
            } for j in range(bsz)]
            pipe.generate_batch(reqs)
            print(f"warmed fix_duration={fd} batch={bsz} ({time.time() - t0:.0f}s)",
                  file=sys.stderr)

    payloads = make_payloads(args.requests, sr, args.profile)

    def run_once(window_ms: float) -> dict:
        batcher, server, url = _serve(pipe, sr, args.max_batch, window_ms)
        lock = threading.Lock()
        latencies: list[float] = []
        samples: list[int] = []
        errors: list[str] = []
        work = list(enumerate(payloads))

        def worker():
            while True:
                with lock:
                    if not work:
                        return
                    _, p = work.pop()
                try:
                    lat, ns = send_request(url, p)
                    with lock:
                        latencies.append(lat)
                        samples.append(ns)
                except Exception as e:
                    with lock:
                        errors.append(str(e))

        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker) for _ in range(args.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        server.shutdown()
        server.server_close()
        srv_stats = batcher.stats.snapshot()
        print(batcher.stats.summary(), file=sys.stderr)
        batcher.close()
        lat = np.asarray(latencies) if latencies else np.zeros(1)
        audio_s = sum(samples) / sr
        return {
            "window_ms": window_ms,
            "rtf": round(wall / max(audio_s, 1e-9), 5),
            "requests": len(latencies), "errors": len(errors),
            "wall_s": round(wall, 2), "audio_seconds": round(audio_s, 1),
            "latency_avg_ms": round(float(lat.mean()) * 1e3, 1),
            "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
            "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 1),
            "server_stats": srv_stats,
        }

    def run_stream(n: int) -> dict:
        """Time to first byte over /tts_stream, one stream at a time (a
        property of a stream, not of saturation)."""
        batcher, server, url = _serve(pipe, sr, args.max_batch, 1.0)
        ttfbs, totals = [], []
        try:
            # the stream buckets (each growing text budget has its own), warmed
            # by one untimed request
            warm = dict(payloads[0])
            warm.pop("fix_duration", None)
            send_request_stream(url, warm)
            if args.fine_stream:
                # the fine first-chunk bucket at b = 1 and 2 (two concurrent
                # first chunks can share a batch)
                wav, in_sr = audio_io.read_wav(
                    io.BytesIO(base64.b64decode(payloads[0]["ref_audio_b64"])))
                first = chunk_text_low_ttfb(payloads[0]["gen_text"])[0]
                t_warm = time.time()
                req = {"ref_wav": audio_io.resample(wav, in_sr, sr),
                       "ref_text": payloads[0]["ref_text"], "gen_text": first, "speed": None}
                for wb in (1, 2):
                    pipe.generate_batch([dict(req) for _ in range(wb)],
                                        bucket_size=max(pipe.bucket_size // 2, 128))
                print(f"warmed fine first-chunk bucket at b=1,2 ({time.time() - t_warm:.0f}s)",
                      file=sys.stderr)
            batcher.stats.reset()  # the timed streams' stats only
            for p in payloads[:n]:
                p = dict(p)
                p.pop("fix_duration", None)  # the budgets pick their own durations
                ttfb, total, _ = send_request_stream(url, p)
                ttfbs.append(ttfb)
                totals.append(total)
            stats = batcher.stats.snapshot()
        finally:
            server.shutdown()
            server.server_close()
            batcher.close()
        return {
            "stream_requests": len(ttfbs),
            "ttfb_p50_ms": round(float(np.percentile(ttfbs, 50)) * 1e3, 1),
            "ttfb_p90_ms": round(float(np.percentile(ttfbs, 90)) * 1e3, 1),
            "stream_total_p50_ms": round(float(np.percentile(totals, 50)) * 1e3, 1),
            "stream_server_stats": stats,
        }

    rows = [run_once(w) for w in args.window_ms]
    for r in rows:
        print(f"[serve-bench] window={r['window_ms']:g}ms rtf={r['rtf']} "
              f"avg={r['latency_avg_ms']}ms p50={r['latency_p50_ms']}ms "
              f"p99={r['latency_p99_ms']}ms errors={r['errors']}", file=sys.stderr)
    best = min(rows, key=lambda r: r["latency_p50_ms"])
    stream_stats = {}
    if args.stream:
        stream_stats = run_stream(args.stream)
        print(f"[serve-bench] stream: {stream_stats}", file=sys.stderr)
    device = str(pipe.device)
    if pipe.device.type == "cuda":
        from f5tts_tpu_torch.scripts.common import gpu_name_and_limit

        device = gpu_name_and_limit()
    line = {
        "metric": "serve_rtf_concurrency%d" % args.concurrency,
        "value": best["rtf"],
        "unit": "rtf",
        "vs_baseline": round(BASELINE_RTF / best["rtf"], 3),
        "extra": {
            **best,
            **stream_stats,
            "baseline_latency_avg_ms": BASELINE_LATENCY_MS,
            "window_sweep": rows,
            "nfe": args.nfe, "max_batch": args.max_batch,
            "quant": args.quantization,
            "device": device,
        },
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
