"""Emilia v2 (new HF webdataset layout) prep — reference
prepare_emilia_v2.py: per-shard directories containing `.mp3`/`.wav` audio
with sidecar `.json` metadata ({"text": ..., "duration": ...}).

Counterpart of f5tts_tpu/train/datasets/prepare_emilia_v2.py, output file for file.

Usage: python -m f5tts_tpu_torch.train.datasets.prepare_emilia_v2 ROOT OUT
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin, is_chinese
from f5tts_tpu_torch.train.datasets.common import repetition_found, write_dataset


def prepare(root: str, output_dir: str, max_samples: int | None = None) -> dict:
    samples, vocab = [], set()
    bad = 0
    for meta in sorted(Path(root).rglob("*.json")):
        audio = None
        for ext in (".mp3", ".wav", ".flac"):
            cand = meta.with_suffix(ext)
            if cand.exists():
                audio = cand
                break
        if audio is None:
            continue
        try:
            obj = json.loads(meta.read_text(encoding="utf-8"))
        except json.JSONDecodeError:
            continue
        text = obj.get("text", "")
        duration = float(obj.get("duration", 0.0))
        if not text or not (0.3 <= duration <= 30.0) or repetition_found(text):
            bad += 1
            continue
        if any(is_chinese(c) for c in text):
            # store the token LIST — see prepare_emilia.py
            text = convert_char_to_pinyin([text])[0]
            vocab.update(text)
        else:
            vocab.update(text)
        samples.append({"audio_path": str(audio), "text": text, "duration": duration})
        if max_samples and len(samples) >= max_samples:
            break
    stats = write_dataset(output_dir, samples, vocab)
    stats["filtered"] = bad
    print(f"prepared {stats['samples']} samples, filtered {bad} -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root")
    p.add_argument("output_dir")
    p.add_argument("--max_samples", type=int, default=None)
    args = p.parse_args(argv)
    prepare(args.root, args.output_dir, args.max_samples)


if __name__ == "__main__":
    main()
