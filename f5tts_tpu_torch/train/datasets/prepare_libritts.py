"""LibriTTS prep (reference src/f5_tts/train/datasets/prepare_libritts.py):
walk train-clean-100/360 + train-other-500 speaker/chapter dirs, read
`.normalized.txt` transcripts next to each wav, char vocab.

Counterpart of f5tts_tpu/train/datasets/prepare_libritts.py, output file for file.

Usage: python -m f5tts_tpu_torch.train.datasets.prepare_libritts LIBRITTS_DIR OUT_DIR \
          --subsets train-clean-100 train-clean-360
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from f5tts_tpu_torch.train.datasets.common import probe_duration, write_dataset


def prepare(root: str, output_dir: str,
            subsets=("train-clean-100", "train-clean-360", "train-other-500"),
            workers: int = 8) -> dict:
    rows = []
    for subset in subsets:
        base = Path(root) / subset
        if not base.exists():
            continue
        for wav in sorted(base.rglob("*.wav")):
            txt = wav.with_suffix(".normalized.txt")
            if not txt.exists():
                continue
            text = txt.read_text(encoding="utf-8").strip()
            if text:
                rows.append((str(wav), text))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        durations = list(ex.map(lambda r: probe_duration(r[0]), rows))

    samples, vocab = [], set()
    for (path, text), dur in zip(rows, durations):
        samples.append({"audio_path": path, "text": text, "duration": dur})
        vocab.update(text)
    stats = write_dataset(output_dir, samples, vocab)
    print(f"prepared {stats['samples']} samples, {stats['hours']:.2f} h -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("libritts_dir")
    p.add_argument("output_dir")
    p.add_argument("--subsets", nargs="+",
                   default=["train-clean-100", "train-clean-360", "train-other-500"])
    args = p.parse_args(argv)
    prepare(args.libritts_dir, args.output_dir, args.subsets)


if __name__ == "__main__":
    main()
