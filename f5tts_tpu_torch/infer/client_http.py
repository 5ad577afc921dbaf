"""HTTP serving client with latency statistics (counterpart of
f5tts_tpu/infer/client_http.py; stdlib and numpy only).

As the reference's Triton clients
(src/f5_tts/runtime/triton_trtllm/client_http.py and client_grpc.py:425-447,
which reports latency percentiles and RTF across a request sweep): sends
concurrent /tts requests to f5tts_tpu_torch.infer.serve and prints p50/p90/p95/p99
latency + aggregate RTF.

Usage:
    python -m f5tts_tpu_torch.infer.client_http --server http://host:8000 \
        --ref_path ref.wav --ref_text "..." --text "..." -n 26 --concurrency 2
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request

import numpy as np


def send_request(server: str, payload: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        server.rstrip("/") + "/tts",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        wav_bytes = resp.read()
    latency = time.perf_counter() - t0
    # wav payload: 44-byte header + int16 pcm
    n_samples = max(len(wav_bytes) - 44, 0) // 2
    return latency, n_samples


def send_request_stream(server: str, payload: dict, timeout: float = 300.0):
    """POST /tts_stream; returns (ttfb_s, total_s, n_samples). TTFB = time to
    the first audio byte of the chunked s16le PCM stream."""
    req = urllib.request.Request(
        server.rstrip("/") + "/tts_stream",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    ttfb = None
    total_bytes = 0
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        while True:
            chunk = resp.read(4096)  # urllib de-chunks transfer encoding
            if not chunk:
                break
            if ttfb is None:
                ttfb = time.perf_counter() - t0
            total_bytes += len(chunk)
    total = time.perf_counter() - t0
    return (ttfb if ttfb is not None else total), total, total_bytes // 2


def run_sweep(server: str, payload: dict, n: int = 26, concurrency: int = 2,
              sr: int = 24000) -> dict:
    latencies: list[float] = []
    samples: list[int] = []
    lock = threading.Lock()
    errors: list[str] = []

    def worker(count: int):
        for _ in range(count):
            try:
                lat, ns = send_request(server, payload)
                with lock:
                    latencies.append(lat)
                    samples.append(ns)
            except Exception as e:
                with lock:
                    errors.append(str(e))

    per = [n // concurrency + (1 if i < n % concurrency else 0) for i in range(concurrency)]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(c,)) for c in per]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    lat = np.asarray(latencies) if latencies else np.zeros(1)
    audio_s = sum(samples) / sr
    return {
        "requests": len(latencies),
        "errors": len(errors),
        "concurrency": concurrency,
        "wall_s": round(wall, 3),
        "audio_seconds": round(audio_s, 2),
        "rtf": round(wall / max(audio_s, 1e-9), 5),
        "latency_avg_s": round(float(lat.mean()), 4),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 4),
        "latency_p90_s": round(float(np.percentile(lat, 90)), 4),
        "latency_p95_s": round(float(np.percentile(lat, 95)), 4),
        "latency_p99_s": round(float(np.percentile(lat, 99)), 4),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--server", default="http://localhost:8000")
    p.add_argument("--ref_path", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--text", required=True)
    p.add_argument("-n", "--num_requests", type=int, default=26)
    p.add_argument("--concurrency", type=int, default=2)
    args = p.parse_args(argv)
    payload = {"ref_path": args.ref_path, "ref_text": args.ref_text,
               "gen_text": args.text}
    print(json.dumps(run_sweep(args.server, payload, args.num_requests,
                               args.concurrency)))


if __name__ == "__main__":
    main()
