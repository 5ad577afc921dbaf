"""Generic dataset prep from a pipe-separated CSV (counterpart of
f5tts_tpu/train/datasets/prepare_csv_wavs.py; its output is the JAX
script's, file for file).

Rebuild of reference src/f5_tts/train/datasets/prepare_csv_wavs.py (~299
lines: chunked ThreadPoolExecutor duration probing with progress, missing-
file skipping, pretrained-vocab workflow for finetuning): input is
`<dir>/metadata.csv` with `audio_file|text` rows (audio paths relative to
the dir, wavs under `wavs/`), output is the standard
arrow/duration.json/vocab.txt artifact set.

- durations probed in parallel (worker count defaults to the host's cores,
  reference :113-121), rows whose audio is missing or unreadable are
  SKIPPED with a count, not fatal (reference process_audio_file :77-90);
- `--no-pretrained-vocab` switches from the finetune workflow (bundled
  Emilia pinyin vocab, so token ids match the pretrained checkpoint) to a
  from-scratch vocab built from this corpus (reference PRETRAINED_VOCAB
  handling).

Usage:
    python -m f5tts_tpu_torch.train.datasets.prepare_csv_wavs INPUT_DIR OUTPUT_DIR \
        [--no-pretrained-vocab] [--workers N]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB
from f5tts_tpu_torch.train.datasets.common import probe_duration, write_dataset

CHUNK_SIZE = 100  # probe submission granularity (progress + bounded queue)


def read_audio_text_pairs(input_dir: str) -> list[tuple[str, str]]:
    """Parse metadata.csv (`audio_file|text`, header tolerated)."""
    meta = os.path.join(input_dir, "metadata.csv")
    rows = []
    with open(meta, encoding="utf-8-sig") as f:
        for line in f:
            line = line.strip()
            if not line or line.lower().startswith("audio_file|"):
                continue
            audio, _, text = line.partition("|")
            if not text:
                continue
            rows.append((os.path.join(input_dir, audio), text))
    return rows


def probe_durations_parallel(paths: list[str], workers: int | None = None,
                             log=print) -> list[float | None]:
    """Probe every path's duration in a thread pool; None for missing or
    unreadable files. Chunked submission with progress (reference :129-147)."""
    workers = workers or max(2, min(32, (os.cpu_count() or 2) + 2))

    def probe(path):
        if not os.path.exists(path):
            return None
        try:
            return probe_duration(path)
        except Exception:
            return None

    out: list[float | None] = []
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for i in range(0, len(paths), CHUNK_SIZE):
            chunk = paths[i : i + CHUNK_SIZE]
            out.extend(ex.map(probe, chunk))
            log(f"probed {min(i + CHUNK_SIZE, len(paths))}/{len(paths)} files")
    return out


def prepare(input_dir: str, output_dir: str, use_pretrained_vocab: bool = True,
            workers: int | None = None) -> dict:
    rows = read_audio_text_pairs(input_dir)
    durations = probe_durations_parallel([p for p, _ in rows], workers,
                                         log=lambda *a: None)

    kept = [(r, d) for r, d in zip(rows, durations) if d is not None]
    skipped = len(rows) - len(kept)
    if skipped:
        print(f"skipped {skipped} rows with missing/unreadable audio",
              file=sys.stderr)
    if not kept:
        raise RuntimeError(f"no usable rows in {input_dir}/metadata.csv")

    polyphones = convert_char_to_pinyin([t for (_, t), _ in kept])
    samples = []
    vocab: set[str] = set()
    for ((path, _text), dur), tokens in zip(kept, polyphones):
        # token LIST, not a joined string — see prepare_emilia.py
        samples.append({"audio_path": path, "text": tokens, "duration": dur})
        vocab.update(tokens)

    if use_pretrained_vocab:
        with open(EMILIA_VOCAB, encoding="utf-8") as f:
            vocab = {line[:-1] for line in f}

    stats = write_dataset(output_dir, samples, vocab)
    stats["skipped"] = skipped
    print(f"prepared {stats['samples']} samples, {stats['hours']:.2f} h -> {output_dir}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--no-pretrained-vocab", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="duration-probe threads (default: cpu count + 2)")
    args = p.parse_args(argv)
    prepare(args.input_dir, args.output_dir,
            use_pretrained_vocab=not args.no_pretrained_vocab, workers=args.workers)


if __name__ == "__main__":
    main()
