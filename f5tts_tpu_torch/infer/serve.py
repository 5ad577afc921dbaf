"""Batched TTS serving (counterpart of f5tts_tpu/infer/serve.py).

The reference's Triton deployment batches dynamically: max_batch_size 4
with a 1 ms queue window (its config.pbtxt). `DynamicBatcher` does the
same over `InferencePipeline.generate_batch_async`: requests that arrive
within the window run as one batch, padded to a power of two, through one
replay of the serve graph of their key. A dispatch thread prepares and
enqueues a batch while a finalizer thread waits for the one before, so
host preparation overlaps device work.

Front end: a stdlib HTTP server. POST /tts takes JSON {"ref_audio_b64" or
"ref_path", "ref_text", "gen_text", optional "speed", "fix_duration"} and
answers WAV bytes; POST /tts_stream answers a chunked s16le PCM stream,
the first text chunk at a small byte budget (`chunk_text_low_ttfb`) on the
fine first-chunk bucket; GET /stats answers `BatcherStats.snapshot()`.

Run on the card: python -m f5tts_tpu_torch.infer.serve --port 8000
[--ckpt_file model.safetensors | --ckpt_file random]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer.pipeline import InferencePipeline, chunk_text_low_ttfb
from f5tts_tpu_torch.utils import duration_bucket


@dataclass
class _Request:
    payload: dict
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    t_enqueue: float = field(default_factory=time.perf_counter)
    t_dispatch: float = 0.0


class BatcherStats:
    """Serving counters, as the reference's Triton stats summary reports
    them: each request's queue delay, each batch's execute time (dispatch
    to results) and size, and the (batch, n bucket) shapes served, with
    those that were cold (no graph captured yet) when a batch reached them."""

    _MAX_SAMPLES = 100_000

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.n_success = 0
            self.n_error = 0
            self.queue_delays: list[float] = []
            self.exec_times: list[float] = []
            self.batch_sizes: list[int] = []
            self.shapes_seen: dict[tuple, int] = {}   # (batch, n_bucket) -> hits
            self.new_shape_events: list[tuple] = []   # shapes cold when served

    def record_dispatch(self, batch: list, now: float):
        with self._lock:
            if len(self.queue_delays) < self._MAX_SAMPLES:
                self.queue_delays.extend(now - r.t_enqueue for r in batch)
            self.batch_sizes.append(len(batch))

    def record_shape(self, batch_size: int, n_bucket: int, cold: bool = False):
        """`cold` comes from the pipeline (`generate_batch_async`'s meta), so
        a warm-up run on the pipeline warms the shape for every batcher."""
        key = (batch_size, n_bucket)
        with self._lock:
            if cold:
                self.new_shape_events.append(key)
            self.shapes_seen[key] = self.shapes_seen.get(key, 0) + 1

    def record_done(self, n_requests: int, exec_s: float, ok: bool):
        with self._lock:
            if len(self.exec_times) < self._MAX_SAMPLES:
                self.exec_times.append(exec_s)
            if ok:
                self.n_success += n_requests
            else:
                self.n_error += n_requests

    def snapshot(self) -> dict:
        def pct(xs, q):
            return round(float(np.percentile(xs, q)) * 1e3, 2) if xs else None

        with self._lock:
            qd, et, bs = self.queue_delays, self.exec_times, self.batch_sizes
            occ: dict[str, int] = {}
            for b in bs:
                occ[str(b)] = occ.get(str(b), 0) + 1
            return {
                "request_count": self.n_success + self.n_error,
                "success_count": self.n_success,
                "error_count": self.n_error,
                "batch_count": len(bs),
                "avg_batch_size": round(sum(bs) / len(bs), 2) if bs else None,
                "batch_occupancy": occ,
                "queue_delay_avg_ms": round(sum(qd) / len(qd) * 1e3, 2) if qd else None,
                "queue_delay_p50_ms": pct(qd, 50),
                "queue_delay_p99_ms": pct(qd, 99),
                "exec_avg_ms": round(sum(et) / len(et) * 1e3, 2) if et else None,
                "exec_p50_ms": pct(et, 50),
                "exec_p99_ms": pct(et, 99),
                "compile_shapes": {f"b{b}_n{n}": c
                                   for (b, n), c in sorted(self.shapes_seen.items())},
                "cold_shape_events": [f"b{b}_n{n}" for b, n in self.new_shape_events],
            }

    def summary(self) -> str:
        s = self.snapshot()
        lines = [
            "serving stats:",
            f"  requests: {s['request_count']} (ok {s['success_count']} / err {s['error_count']})",
            f"  batches: {s['batch_count']}, avg occupancy {s['avg_batch_size']}, "
            f"histogram {s['batch_occupancy']}",
            f"  queue delay ms: avg {s['queue_delay_avg_ms']} p50 {s['queue_delay_p50_ms']} "
            f"p99 {s['queue_delay_p99_ms']}",
            f"  batch execute ms: avg {s['exec_avg_ms']} p50 {s['exec_p50_ms']} "
            f"p99 {s['exec_p99_ms']}",
            f"  graph shapes (batch,bucket)->hits: {s['compile_shapes']}",
        ]
        if s["cold_shape_events"]:
            lines.append(f"  COLD shapes first served mid-serve (a capture inside a request): "
                         f"{s['cold_shape_events']}")
        return "\n".join(lines)


class DynamicBatcher:
    """Collect requests for up to `max_queue_delay_s`, run up to
    `max_batch_size` of them as one padded batch. A failed batch answers
    each of its requests with the error."""

    def __init__(self, pipeline: InferencePipeline, max_batch_size: int = 4,
                 max_queue_delay_s: float = 0.001):
        self.pipeline = pipeline
        self.max_batch_size = max_batch_size
        self.max_queue_delay_s = max_queue_delay_s
        self.stats = BatcherStats()
        self.q: "queue.Queue[_Request]" = queue.Queue()
        # two stages: the dispatch thread prepares and enqueues the next
        # batch while the finalizer thread waits for the one before
        self._pending: "queue.Queue[tuple]" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()
        self._finalizer = threading.Thread(target=self._finalize_loop, daemon=True)
        self._finalizer.start()

    def submit(self, payload: dict, timeout: float = 120.0) -> np.ndarray:
        req = _Request(payload)
        self.q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("tts request timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def close(self):
        self._stop.set()
        self.thread.join(timeout=5)
        self._finalizer.join(timeout=5)

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.max_queue_delay_s
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            self._run(batch)

    def _run(self, batch: list[_Request]):
        now = time.perf_counter()
        for r in batch:
            r.t_dispatch = now
        self.stats.record_dispatch(batch, now)
        try:
            pending = self.pipeline.generate_batch_async([r.payload for r in batch])
            meta = pending[1]  # (ref_lens, totals, n_bucket, shape_is_cold, shape_key)
            self.stats.record_shape(len(batch), meta[2],
                                    cold=bool(meta[3]) if len(meta) > 3 else False)
            self._pending.put((batch, pending))
        except Exception as e:
            self.stats.record_done(len(batch), time.perf_counter() - now, False)
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()

    def _finalize_loop(self):
        while not (self._stop.is_set() and self._pending.empty()):
            try:
                batch, pending = self._pending.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                waves = self.pipeline.finalize_batch(pending)
                self.stats.record_done(len(batch), time.perf_counter() - batch[0].t_dispatch, True)
                for r, w in zip(batch, waves):
                    r.result = w
                    r.done.set()
            except Exception as e:
                self.stats.record_done(len(batch), time.perf_counter() - batch[0].t_dispatch,
                                       False)
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()


def _wav_bytes(wave: np.ndarray, sr: int) -> bytes:
    """A 16-bit mono PCM WAV file of `wave` (clipped to [-1, 1])."""
    import struct

    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " + struct.pack(
        "<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) + b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def warmup_buckets(pipeline: InferencePipeline, buckets: list[int]) -> list[int]:
    """The n buckets the pipeline selects for the requested frame counts:
    the UNetT's are 128k - 1 wide, so its prepended time token keeps the
    sequence 128-aligned (`utils.duration_bucket`)."""
    extra = pipeline.bdef.seq_extra_tokens
    return sorted({duration_bucket(f - extra, pipeline.bucket_size,
                                   pipeline.sampling.max_duration, extra) for f in buckets})


def warmup(pipeline: InferencePipeline, buckets: Optional[list[int]] = None,
           batch_sizes: Optional[list[int]] = None) -> list[dict]:
    """Capture the serve graphs of these n buckets and batch sizes before
    serving, so no request pays a warm-up and a capture. Each request pins
    its duration with `fix_duration`, so it lands in exactly the bucket
    asked for (the byte-ratio estimate overshoots with a short text). The
    JAX package's warm-up also turns on XLA's persistent compilation cache;
    the port has none (graphs live in the process), so that step is gone.
    A failed warm-up raises (the JAX one prints and goes on). Returns a row per (bucket, batch): seconds, and the key's capture
    seconds and pool bytes on a CUDA device."""
    buckets = warmup_buckets(pipeline, buckets or [256, 512, 1024])
    batch_sizes = batch_sizes or [1, 2, 4]
    sr = pipeline.sr
    rows = []
    for frames in buckets:
        for b in batch_sizes:
            reqs = [{"ref_wav": np.zeros(int(sr * 2.0), np.float32), "ref_text": "warm up. ",
                     "gen_text": "w " * max(int(frames * 0.1), 8),
                     "fix_duration": frames * pipeline.hop / sr} for _ in range(b)]
            before = set(pipeline.serve_graphs)
            t0 = time.time()
            pipeline.generate_batch(reqs)
            row = {"bucket": frames, "batch": b, "seconds": time.time() - t0}
            for key in set(pipeline.serve_graphs) - before:
                entry = pipeline.serve_graphs[key]
                row.update(key=list(key), capture_s=entry.capture_s, pool_bytes=entry.pool_bytes)
            rows.append(row)
            print(f"warmup bucket={frames} batch={b}: {row['seconds']:.1f}s")
    return rows


def make_handler(batcher: DynamicBatcher, sr: int, pipeline: Optional[InferencePipeline] = None):
    """The HTTP handler class: POST /tts, GET /stats and, given `pipeline`,
    POST /tts_stream. A stream's first text chunk asks for the fine
    first-chunk bucket; a stream that fails midway drops the connection
    without the chunked terminator, so the client sees an error."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/stats":
                out = json.dumps(batcher.stats.snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
            else:
                self.send_error(404)

        def _read_body(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length))
            if "ref_audio_b64" in body:
                wav, in_sr = audio_io.read_wav(io.BytesIO(base64.b64decode(body["ref_audio_b64"])))
            else:
                wav, in_sr = audio_io.read_wav(body["ref_path"])
            return audio_io.resample(wav, in_sr, sr), body

        def do_POST(self):
            if self.path == "/tts":
                self._tts()
            elif self.path == "/tts_stream" and pipeline is not None:
                self._tts_stream()
            else:
                self.send_error(404)

        def _tts(self):
            try:
                wav, body = self._read_body()
                wave = batcher.submit({
                    "ref_wav": wav, "ref_text": body.get("ref_text", ""),
                    "gen_text": body["gen_text"], "speed": body.get("speed"),
                    "fix_duration": body.get("fix_duration"),
                })
                out = _wav_bytes(wave, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
            except Exception as e:
                self.send_error(500, f"{type(e).__name__}: {e}")

        def _tts_stream(self):
            try:
                wav, body = self._read_body()
                ref_text = body.get("ref_text", "")
                if not ref_text.endswith((". ", "。")):
                    ref_text = ref_text + ". " if not ref_text.endswith(".") else ref_text + " "
                chunks = chunk_text_low_ttfb(body["gen_text"])
            except Exception as e:
                self.send_error(500, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", f"audio/L16;rate={sr};channels=1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            try:
                for ci, text_chunk in enumerate(chunks):
                    wave = batcher.submit({
                        "ref_wav": wav, "ref_text": ref_text, "gen_text": text_chunk,
                        "speed": body.get("speed"), "fine_bucket": ci == 0,
                    })
                    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
                    if pcm:
                        emit(pcm)
                        self.wfile.flush()
            except Exception:
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="Batched TTS over HTTP on the card")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="",
                   help="a reference .pt / .safetensors, a port checkpoint directory, or "
                        "'random' for random weights")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--device", default=None, help="the card unless named (e.g. 'cpu')")
    p.add_argument("--max_batch_size", type=int, default=4)
    p.add_argument("--max_queue_delay_ms", type=float, default=1.0)
    p.add_argument("--warmup_buckets", type=int, nargs="*", default=[512, 1024],
                   help="capture these n buckets at start-up")
    p.add_argument("--fine_stream", action="store_true",
                   help="warm the half-granularity first-chunk buckets of /tts_stream in "
                        "the background")
    args = p.parse_args(argv)

    from f5tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                device=args.device)
    if args.fine_stream:
        tts.pipeline.fine_autowarm = True
    if args.warmup_buckets:
        # batches are padded to powers of two: {1, 2, 4, ...} covers every size
        sizes = [1 << i for i in range(args.max_batch_size.bit_length())
                 if (1 << i) <= args.max_batch_size]
        warmup(tts.pipeline, args.warmup_buckets, sizes)
    batcher = DynamicBatcher(tts.pipeline, args.max_batch_size, args.max_queue_delay_ms / 1000.0)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(batcher, tts.mel_cfg.target_sample_rate,
                                              pipeline=tts.pipeline))
    print(f"serving on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
