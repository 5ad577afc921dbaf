"""Shared dataset-preparation helpers (counterpart of
f5tts_tpu/train/datasets/common.py).

Output artifact layout matches the reference prep scripts
(src/f5_tts/train/datasets/prepare_*.py): a directory
`data/<name>_<tokenizer>/` containing
- raw.arrow       : rows {audio_path, text, duration}
- duration.json   : {"duration": [...]} for the frame-budget batch sampler
- vocab.txt       : one token per line (space at idx 0)
so artifacts are interchangeable with the reference pipeline.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Iterable


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """Dirty-data filter (reference model/utils.py:191-199)."""
    pattern_count: dict = defaultdict(int)
    for i in range(len(text) - length + 1):
        pattern_count[text[i : i + length]] += 1
    return any(count > tolerance for count in pattern_count.values())


def write_dataset(
    out_dir: str,
    samples: Iterable[dict],          # {audio_path, text, duration}
    vocab: Iterable[str] | None = None,
    is_pinyin_vocab: bool = True,
) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    from datasets.arrow_writer import ArrowWriter

    durations = []
    total = 0
    writer = ArrowWriter(path=os.path.join(out_dir, "raw.arrow"))
    for s in samples:
        writer.write(s)
        durations.append(s["duration"])
        total += 1
    writer.finalize()
    writer.close()

    with open(os.path.join(out_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": durations}, f, ensure_ascii=False)

    if vocab is not None:
        vocab_set = set(vocab)
        vocab_set.discard("\n")
        tokens = sorted(vocab_set - {" "})
        with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write(" \n")  # space must be idx 0
            for t in tokens:
                f.write(t + "\n")

    return {"samples": total, "hours": sum(durations) / 3600.0}


def probe_duration(path: str) -> float:
    from f5tts_tpu_torch.infer import audio_io

    wav, sr = audio_io.read_wav(path)
    return len(wav) / sr
