"""WenetSpeech4TTS prep (reference prepare_wenetspeech4tts.py): Premium /
Standard / Basic tiers, each with `wavs/` + paired `.txt` transcripts;
zh text converted to pinyin tokens.

Counterpart of f5tts_tpu/train/datasets/prepare_wenetspeech4tts.py, output file for file.

Usage: python -m f5tts_tpu_torch.train.datasets.prepare_wenetspeech4tts ROOT OUT \
          --tiers Premium
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.train.datasets.common import probe_duration, write_dataset

TIERS = {"Premium": ["WenetSpeech4TTS_Premium"],
         "Standard": ["WenetSpeech4TTS_Premium", "WenetSpeech4TTS_Standard"],
         "Basic": ["WenetSpeech4TTS_Premium", "WenetSpeech4TTS_Standard",
                   "WenetSpeech4TTS_Basic"]}


def prepare(root: str, output_dir: str, tier: str = "Premium", workers: int = 8) -> dict:
    rows = []
    for sub in TIERS.get(tier, [tier]):
        base = Path(root) / sub
        if not base.exists():
            continue
        for wav in sorted(base.rglob("*.wav")):
            txt = wav.with_suffix(".txt")
            if not txt.exists():
                continue
            text = txt.read_text(encoding="utf-8").strip().split("\n")[0]
            if text:
                rows.append((str(wav), text))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        durations = list(ex.map(lambda r: probe_duration(r[0]), rows))

    token_lists = convert_char_to_pinyin([t for _, t in rows])
    samples, vocab = [], set()
    for (path, _), tokens, dur in zip(rows, token_lists, durations):
        # token LIST, not a joined string — see prepare_emilia.py
        samples.append({"audio_path": path, "text": tokens, "duration": dur})
        vocab.update(tokens)
    stats = write_dataset(output_dir, samples, vocab)
    print(f"prepared {stats['samples']} samples, {stats['hours']:.2f} h -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("root")
    p.add_argument("output_dir")
    p.add_argument("--tier", default="Premium", choices=list(TIERS))
    args = p.parse_args(argv)
    prepare(args.root, args.output_dir, args.tier)


if __name__ == "__main__":
    main()
