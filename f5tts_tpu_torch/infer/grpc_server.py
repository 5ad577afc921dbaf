"""gRPC serving front end, JSON over gRPC with no .proto toolchain
(counterpart of f5tts_tpu/infer/grpc_server.py; the reference's Triton gRPC
path, runtime/triton_trtllm/client_grpc.py).

`f5tts.TTS/Synthesize` (unary: JSON request bytes -> WAV bytes) over the
same `DynamicBatcher` as the HTTP server, `SynthesizeStream` (unary-stream:
low-TTFB s16le PCM chunks, the first text chunk on the fine bucket) and
`Stats` (the batcher's queue / execute counters), registered with a
generic handler. `grpc` is imported at module level; the card's machine
has none, so nothing on the main path imports this module.

Server: python -m f5tts_tpu_torch.infer.grpc_server --ckpt_file random --port 8001
Client: f5tts_tpu_torch.infer.grpc_server.synthesize(...) or any gRPC client
        calling /f5tts.TTS/Synthesize with the JSON payload.
"""

from __future__ import annotations

import argparse
import json
from concurrent import futures

import numpy as np

import grpc

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer.pipeline import chunk_text_low_ttfb
from f5tts_tpu_torch.infer.serve import DynamicBatcher, _wav_bytes

SERVICE = "f5tts.TTS"
METHOD = "Synthesize"
STREAM_METHOD = "SynthesizeStream"
STATS_METHOD = "Stats"


def _make_service(batcher: DynamicBatcher, sr: int):
    def synthesize(request_bytes: bytes, context) -> bytes:
        body = json.loads(request_bytes)
        wav, in_sr = audio_io.read_wav(body["ref_path"])
        wav = audio_io.resample(wav, in_sr, sr)
        wave = batcher.submit({
            "ref_wav": wav,
            "ref_text": body.get("ref_text", ""),
            "gen_text": body["gen_text"],
            "speed": body.get("speed"),
            "fix_duration": body.get("fix_duration"),
        })
        return _wav_bytes(wave, sr)

    def synthesize_stream(request_bytes: bytes, context):
        """Server-streaming synthesis: yields raw s16le PCM chunks with the
        HTTP /tts_stream low-TTFB policy (small, growing first-chunk text
        budgets; first chunk on the fine half-granularity bucket when warm)
        — the gRPC counterpart of the reference's streaming Triton client
        (client_grpc.py, --mode streaming)."""
        body = json.loads(request_bytes)
        wav, in_sr = audio_io.read_wav(body["ref_path"])
        wav = audio_io.resample(wav, in_sr, sr)
        ref_text = body.get("ref_text", "")
        if not ref_text.endswith((". ", "。")):
            ref_text = ref_text + ". " if not ref_text.endswith(".") \
                else ref_text + " "
        for ci, text_chunk in enumerate(chunk_text_low_ttfb(body["gen_text"])):
            wave = batcher.submit({
                "ref_wav": wav,
                "ref_text": ref_text,
                "gen_text": text_chunk,
                "speed": body.get("speed"),
                "fine_bucket": ci == 0,
            })
            pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
            if pcm:
                yield pcm

    def stats(request_bytes: bytes, context) -> bytes:
        # server-side queue/compute counters, the analogue of the Triton
        # model stats the reference's client_grpc.py:425-447 scrapes
        return json.dumps(batcher.stats.snapshot()).encode()

    def h(fn):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)

    stream_h = grpc.unary_stream_rpc_method_handler(
        synthesize_stream, request_deserializer=lambda b: b,
        response_serializer=lambda b: b)

    return grpc.method_handlers_generic_handler(
        SERVICE, {METHOD: h(synthesize), STREAM_METHOD: stream_h,
                  STATS_METHOD: h(stats)})


def serve(batcher: DynamicBatcher, sr: int, host: str = "0.0.0.0",
          port: int = 8001, max_workers: int = 8) -> grpc.Server:
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_make_service(batcher, sr),))
    server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server


def synthesize(target: str, ref_path: str, ref_text: str, gen_text: str,
               timeout: float = 300.0, **kw) -> bytes:
    """Client helper: returns WAV bytes."""
    payload = json.dumps({"ref_path": ref_path, "ref_text": ref_text,
                          "gen_text": gen_text, **kw}).encode()
    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(
            f"/{SERVICE}/{METHOD}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        return fn(payload, timeout=timeout)


def synthesize_stream(target: str, ref_path: str, ref_text: str,
                      gen_text: str, timeout: float = 300.0, **kw):
    """Client helper: yields s16le PCM chunks as the server synthesizes them
    (low-TTFB: the first small chunk arrives long before the full utterance).
    """
    payload = json.dumps({"ref_path": ref_path, "ref_text": ref_text,
                          "gen_text": gen_text, **kw}).encode()
    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_stream(
            f"/{SERVICE}/{STREAM_METHOD}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        yield from fn(payload, timeout=timeout)


def fetch_stats(target: str, timeout: float = 10.0) -> dict:
    """Client helper: scrape server-side serving stats (queue delay, batch
    occupancy, execute times) — counterpart of the reference's
    write_triton_stats scrape (client_grpc.py:425-447)."""
    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(
            f"/{SERVICE}/{STATS_METHOD}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )
        return json.loads(fn(b"{}", timeout=timeout))


def main(argv=None):
    p = argparse.ArgumentParser(description="Batched TTS over gRPC on the card")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="",
                   help="a reference .pt / .safetensors, a port checkpoint directory, or "
                        "'random' for random weights")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--device", default=None, help="the card unless named (e.g. 'cpu')")
    p.add_argument("--max_batch_size", type=int, default=4)
    p.add_argument("--max_queue_delay_ms", type=float, default=1.0)
    args = p.parse_args(argv)

    from f5tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                device=args.device)
    batcher = DynamicBatcher(tts.pipeline, args.max_batch_size,
                             args.max_queue_delay_ms / 1000.0)
    server = serve(batcher, tts.mel_cfg.target_sample_rate, args.host, args.port)
    print(f"gRPC serving on {args.host}:{args.port} ({SERVICE}/{METHOD})")
    server.wait_for_termination()


if __name__ == "__main__":
    main()
