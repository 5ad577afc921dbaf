"""Emilia ZH+EN prep (reference src/f5_tts/train/datasets/prepare_emilia.py):
walk per-language jsonl manifests, filter bad cases (known-bad ids,
out-of-language characters, pathological repetition), convert zh text to
pinyin tokens, emit the standard arrow/duration/vocab artifacts.

Corpus stats from the reference run (prepare_emilia.py:221-229): 95281.87 h,
37.84M samples after filtering, pinyin vocab ~2545.

Counterpart of f5tts_tpu/train/datasets/prepare_emilia.py, output file for file.

Usage: python -m f5tts_tpu_torch.train.datasets.prepare_emilia EMILIA_DIR OUT_DIR \
          --langs ZH EN
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.train.datasets.common import repetition_found, write_dataset

# known-bad source recordings (reference prepare_emilia.py filter lists)
ZH_FILTERS = ["い", "て"]
EN_FILTERS = ["ا", "い", "て"]


def iter_jsonl(root: str, lang: str):
    for path in sorted(Path(root, lang).rglob("*.jsonl")):
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def prepare(emilia_dir: str, output_dir: str, langs=("ZH", "EN"),
            max_samples: int | None = None) -> dict:
    samples = []
    vocab: set[str] = set()
    bad = 0
    for lang in langs:
        filters = ZH_FILTERS if lang == "ZH" else EN_FILTERS
        for obj in iter_jsonl(emilia_dir, lang):
            text = obj.get("text", "")
            duration = float(obj.get("duration", 0.0))
            wav = obj.get("wav") or obj.get("audio_path", "")
            if not text or not (0.3 <= duration <= 30.0):
                bad += 1
                continue
            if any(ch in text for ch in filters) or repetition_found(text):
                bad += 1
                continue
            if lang == "ZH":
                # store the token LIST (reference prepare_emilia.py:139-141):
                # the trainer consumes pre-tokenized lists without re-running
                # G2P, so whole-pinyin tokens survive the round trip
                text = convert_char_to_pinyin([text])[0]
                vocab.update(text)
            else:
                vocab.update(text)
            samples.append({
                "audio_path": os.path.join(emilia_dir, lang, wav),
                "text": text,
                "duration": duration,
            })
            if max_samples and len(samples) >= max_samples:
                break

    stats = write_dataset(output_dir, samples, vocab)
    stats["filtered"] = bad
    print(f"prepared {stats['samples']} samples ({stats['hours']:.2f} h), "
          f"filtered {bad} -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("emilia_dir")
    p.add_argument("output_dir")
    p.add_argument("--langs", nargs="+", default=["ZH", "EN"])
    p.add_argument("--max_samples", type=int, default=None)
    args = p.parse_args(argv)
    prepare(args.emilia_dir, args.output_dir, args.langs, args.max_samples)


if __name__ == "__main__":
    main()
