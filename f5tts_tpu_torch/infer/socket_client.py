"""Streaming TTS client with TTFB measurement (counterpart of
f5tts_tpu/infer/socket_client.py; numpy only, pyaudio optional).

As the reference's src/f5_tts/socket_client.py: connects to the socket
server, sends text, receives float32 PCM until the ``END`` sentinel, measures
time-to-first-byte, and plays (pyaudio, if available) or saves the audio.
"""

from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from f5tts_tpu_torch.infer import audio_io


def listen_to_f5tts(text: str, host: str = "localhost", port: int = 9998,
                    out_path: str = "client_out.wav", sr: int = 24000) -> dict:
    client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    client.connect((host, port))
    start = time.time()
    ttfb = None
    chunks: list[np.ndarray] = []
    buf = b""
    try:
        client.sendall(text.encode("utf-8"))
        while True:
            data = client.recv(32768)
            if not data:
                break
            if ttfb is None:
                ttfb = time.time() - start
            buf += data
            if buf.endswith(b"END"):
                buf = buf[:-3]
                break
        usable = len(buf) // 4 * 4
        audio = np.frombuffer(buf[:usable], dtype=np.float32)
        chunks.append(audio)
    finally:
        client.close()

    wave = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    total = time.time() - start
    if out_path:
        audio_io.write_wav(out_path, wave, sr)

    try:
        import pyaudio  # optional realtime playback

        pa = pyaudio.PyAudio()
        stream = pa.open(format=pyaudio.paFloat32, channels=1, rate=sr, output=True)
        stream.write(wave.tobytes())
        stream.stop_stream()
        stream.close()
        pa.terminate()
    except ImportError:
        pass

    return {"ttfb_s": ttfb, "total_s": total,
            "audio_s": len(wave) / sr, "samples": len(wave)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=9998)
    p.add_argument("--text", required=True)
    p.add_argument("--output", default="client_out.wav")
    args = p.parse_args(argv)
    stats = listen_to_f5tts(args.text, args.host, args.port, args.output)
    print(stats)


if __name__ == "__main__":
    main()
