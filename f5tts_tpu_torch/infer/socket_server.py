"""TCP streaming TTS server (counterpart of f5tts_tpu/infer/socket_server.py).

As the reference's src/f5_tts/socket_server.py: a per-connection loop that
receives UTF-8 text and streams back float32 PCM chunks terminated by an
``END`` sentinel. Includes:
- model warm-up pass at startup (reference :122-136)
- low-TTFB first-chunk policy: the leading text chunks use descending byte
  budgets so the first audio arrives quickly (reference :138-143)
- a background wav-writer thread (reference :32-69)

Run on the card: python -m f5tts_tpu_torch.infer.socket_server --host 0.0.0.0 \
       --port 9998 --ref_audio ref.wav --ref_text "..." --ckpt_file model.safetensors
"""

from __future__ import annotations

import argparse
import queue
import socket
import struct
import threading
import traceback
from typing import Optional

import numpy as np

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer.pipeline import InferencePipeline


class WavWriterThread(threading.Thread):
    """Asynchronously append streamed chunks to a wav file (reference :32-69)."""

    def __init__(self, path: Optional[str], sr: int):
        super().__init__(daemon=True)
        self.path = path
        self.sr = sr
        self.q: queue.Queue = queue.Queue()
        self.chunks: list[np.ndarray] = []

    def run(self):
        while True:
            item = self.q.get()
            if item is None:
                break
            self.chunks.append(item)
        if self.path and self.chunks:
            audio_io.write_wav(self.path, np.concatenate(self.chunks), self.sr)

    def submit(self, chunk: np.ndarray):
        self.q.put(chunk)

    def finish(self):
        self.q.put(None)
        self.join()


class TTSStreamingProcessor:
    def __init__(self, pipeline: InferencePipeline, ref_wav: np.ndarray,
                 ref_sr: int, ref_text: str, chunk_size: int = 2048,
                 first_chunk_chars: tuple = (12, 40, 80)):
        self.pipeline = pipeline
        self.ref_wav = audio_io.resample(ref_wav, ref_sr, pipeline.sr)
        self.ref_text = ref_text if ref_text.endswith((". ", "。")) else ref_text + ". "
        self.chunk_size = chunk_size
        self.first_chunk_chars = first_chunk_chars
        self._warm_up()

    def _warm_up(self):
        """Run the full pipeline once, so its graph is captured before the
        first client connects (reference :122-136)."""
        list(self.generate_stream("Warm-up."))

    def _split_low_ttfb(self, text: str) -> list[str]:
        """First chunks use small descending budgets, rest the normal budget
        (shared with the HTTP /tts_stream path, pipeline.chunk_text_low_ttfb)."""
        from f5tts_tpu_torch.infer.pipeline import chunk_text_low_ttfb

        return chunk_text_low_ttfb(text, self.first_chunk_chars)

    def generate_stream(self, text: str):
        for gen_chunk in self._split_low_ttfb(text):
            wave, _ = self.pipeline.generate_chunk(self.ref_wav, self.ref_text, gen_chunk)
            for j in range(0, len(wave), self.chunk_size):
                yield wave[j : j + self.chunk_size].astype(np.float32)


def handle_client(conn: socket.socket, processor: TTSStreamingProcessor,
                  out_path: Optional[str] = None):
    try:
        with conn:
            while True:
                data = conn.recv(4096)
                if not data:
                    break
                text = data.decode("utf-8").strip()
                if not text:
                    continue
                writer = WavWriterThread(out_path, processor.pipeline.sr)
                writer.start()
                for chunk in processor.generate_stream(text):
                    conn.sendall(struct.pack(f"{len(chunk)}f", *chunk.tolist()))
                    writer.submit(chunk)
                conn.sendall(b"END")
                writer.finish()
    except Exception:
        traceback.print_exc()


def start_server(host: str, port: int, processor: TTSStreamingProcessor,
                 out_path: Optional[str] = None, max_requests: Optional[int] = None):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    print(f"listening on {host}:{port}")
    served = 0
    while max_requests is None or served < max_requests:
        conn, addr = srv.accept()
        handle_client(conn, processor, out_path)
        served += 1
    srv.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--ckpt_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--ref_audio", required=True)
    p.add_argument("--ref_text", default="")
    p.add_argument("--save_path", default=None)
    p.add_argument("--device", default=None, help="the card unless named (e.g. 'cpu')")
    args = p.parse_args(argv)

    from f5tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=args.model, ckpt_file=args.ckpt_file, vocab_file=args.vocab_file,
                device=args.device)
    ref_wav, ref_sr = audio_io.read_wav(args.ref_audio)
    ref_wav = audio_io.clip_ref_audio(ref_wav, ref_sr)
    processor = TTSStreamingProcessor(tts.pipeline, ref_wav, ref_sr, args.ref_text)
    start_server(args.host, args.port, processor, args.save_path)


if __name__ == "__main__":
    main()
