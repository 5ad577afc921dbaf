"""LJSpeech prep (reference src/f5_tts/train/datasets/prepare_ljspeech.py):
metadata.csv rows `id|transcript|normalized`, wavs under wavs/<id>.wav; uses
the normalized transcript, char vocab derived from the corpus.

Counterpart of f5tts_tpu/train/datasets/prepare_ljspeech.py, output file for file.

Usage: python -m f5tts_tpu_torch.train.datasets.prepare_ljspeech LJ_DIR OUT_DIR
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from f5tts_tpu_torch.train.datasets.common import probe_duration, write_dataset


def prepare(lj_dir: str, output_dir: str, workers: int = 8) -> dict:
    meta = os.path.join(lj_dir, "metadata.csv")
    rows = []
    with open(meta, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 3:
                continue
            wav_id, _raw, norm = parts[0], parts[1], parts[2]
            rows.append((os.path.join(lj_dir, "wavs", wav_id + ".wav"), norm))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        durations = list(ex.map(lambda r: probe_duration(r[0]), rows))

    samples = []
    vocab: set[str] = set()
    for (path, text), dur in zip(rows, durations):
        samples.append({"audio_path": path, "text": text, "duration": dur})
        vocab.update(text)

    stats = write_dataset(output_dir, samples, vocab)
    print(f"prepared {stats['samples']} samples, {stats['hours']:.2f} h -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("lj_dir")
    p.add_argument("output_dir")
    args = p.parse_args(argv)
    prepare(args.lj_dir, args.output_dir)


if __name__ == "__main__":
    main()
