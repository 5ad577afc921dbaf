"""Finetune-workbench logic as UI-independent, testable functions
(counterpart of f5tts_tpu/train/workbench.py; the gradio shell stays out).

The reference buries this in its gradio monolith
(src/f5_tts/train/finetune_gradio.py): the RMS silence Slicer (:197-309,
the slicer2 algorithm), transcribe_all (:636-704), create_metadata
(:745-853: metadata.csv -> raw.arrow + duration.json + vocab), the
batch-size calculator (:860-946), and vocab check/extend (:1014-1125).
Here each is a pure function over a project directory.
Differences from the JAX module: no ASR model ships with the port, so
`transcribe_directory` needs a `transcribe_fn`; `calculate_train` sizes
the frame budget from the port's own training memory on an H100 (and the
card's memory when there is one); `expand_reference_checkpoint_embeddings`
reads and writes safetensors with the port's own code.

Project layout (reference-compatible):
    <project>/dataset/       user-dropped audio files
    <project>/wavs/          sliced segments (segment_N.wav)
    <project>/metadata.csv   "name|transcript" lines (utf-8-sig)
    <project>/raw.arrow, duration.json, vocab.txt   training artifacts
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from glob import glob
from typing import Callable, Optional

import numpy as np

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB

AUDIO_EXTS = ("wav", "mp3", "aac", "flac", "m4a", "alac", "ogg", "aiff", "wma", "amr")


def _rms_frames(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered per-frame RMS (librosa.feature.rms semantics) via one
    cumulative-sum pass — no librosa dependency."""
    pad = frame_length // 2
    sq = np.pad(y.astype(np.float64), (pad, pad)) ** 2
    csum = np.concatenate([[0.0], np.cumsum(sq)])
    n = max(1 + (len(sq) - frame_length) // hop_length, 1)
    starts = np.arange(n) * hop_length
    sums = csum[starts + frame_length] - csum[starts]
    return np.sqrt(sums / frame_length)


class Slicer:
    """RMS-based silence slicer (the slicer2 algorithm contract the
    reference vendors at finetune_gradio.py:197-309).

    Upstream algorithm attribution: this follows the "slicer2" algorithm by
    RVC-Boss (GPT-SoVITS project, also vendored verbatim by the reference);
    exact cut positions are the behavior contract, so the constructor math
    and the three-case silence branch structure intentionally match the
    published algorithm. The RMS computation itself (cumsum-based, above)
    was re-derived independently — no librosa.

    Scans per-hop RMS; a silent run long enough (min_interval) after a clip
    of at least min_length frames produces a cut at the quietest frame of
    the silence (one or two cut points when the silence exceeds
    max_sil_kept, trimming the middle). Leading/trailing silence beyond
    max_sil_kept is trimmed. Units: threshold dB, min_length/min_interval/
    hop_size/max_sil_kept in ms.

    slice(wav) -> list of (chunk, start_sample, end_sample).
    """

    def __init__(self, sr: int, threshold: float = -40.0,
                 min_length: int = 20_000, min_interval: int = 300,
                 hop_size: int = 20, max_sil_kept: int = 2000):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if not max_sil_kept >= hop_size:
            raise ValueError("need max_sil_kept >= hop_size")
        interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _cut(self, wav, begin, end):
        return wav[begin * self.hop_size: min(len(wav), end * self.hop_size)]

    def slice(self, wav: np.ndarray) -> list[tuple[np.ndarray, int, int]]:
        samples = wav.mean(axis=0) if wav.ndim > 1 else wav
        rms = _rms_frames(samples, self.win_size, self.hop_size)
        total = len(rms)
        if len(samples) <= self.min_length * self.hop_size:
            return [(wav, 0, int(total * self.hop_size))]

        tags: list[tuple[int, int]] = []   # silent (begin, end) frame ranges to drop
        sil_start: Optional[int] = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if sil_start is None:
                    sil_start = i
                continue
            if sil_start is None:
                continue
            leading = sil_start == 0 and i > self.max_sil_kept
            middle = (i - sil_start >= self.min_interval
                      and i - clip_start >= self.min_length)
            if not leading and not middle:
                sil_start = None
                continue
            span = i - sil_start
            if span <= self.max_sil_kept:
                pos = int(rms[sil_start: i + 1].argmin()) + sil_start
                tags.append((0, pos) if sil_start == 0 else (pos, pos))
                clip_start = pos
            elif span <= self.max_sil_kept * 2:
                pos = int(rms[i - self.max_sil_kept: sil_start + self.max_sil_kept + 1]
                          .argmin()) + i - self.max_sil_kept
                pos_l = int(rms[sil_start: sil_start + self.max_sil_kept + 1]
                            .argmin()) + sil_start
                pos_r = int(rms[i - self.max_sil_kept: i + 1].argmin()) + i - self.max_sil_kept
                if sil_start == 0:
                    tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = int(rms[sil_start: sil_start + self.max_sil_kept + 1]
                            .argmin()) + sil_start
                pos_r = int(rms[i - self.max_sil_kept: i + 1].argmin()) + i - self.max_sil_kept
                tags.append((0, pos_r) if sil_start == 0 else (pos_l, pos_r))
                clip_start = pos_r
            sil_start = None

        if sil_start is not None and total - sil_start >= self.min_interval:
            sil_end = min(total, sil_start + self.max_sil_kept)
            pos = int(rms[sil_start: sil_end + 1].argmin()) + sil_start
            tags.append((pos, total + 1))

        if not tags:
            return [(wav, 0, int(total * self.hop_size))]
        chunks = []
        if tags[0][0] > 0:
            chunks.append((self._cut(wav, 0, tags[0][0]), 0,
                           int(tags[0][0] * self.hop_size)))
        for a, b in zip(tags[:-1], tags[1:]):
            chunks.append((self._cut(wav, a[1], b[0]),
                           int(a[1] * self.hop_size), int(b[0] * self.hop_size)))
        if tags[-1][1] < total:
            chunks.append((self._cut(wav, tags[-1][1], total),
                           int(tags[-1][1] * self.hop_size),
                           int(total * self.hop_size)))
        return chunks


def normalize_chunk(chunk: np.ndarray, alpha: float = 0.5,
                    max_amp: float = 1.0) -> np.ndarray:
    """Loudness blend the reference applies before writing segments
    (finetune_gradio.py:665-684): alpha-weighted mix of the peak-normalized
    signal and the original."""
    peak = float(np.abs(chunk).max()) or 1.0
    if peak > 1.0:
        chunk = chunk / peak
    return (chunk / peak) * (max_amp * alpha) + (1.0 - alpha) * chunk


def transcribe_directory(
    project_path: str,
    language: Optional[str] = None,
    audio_files: Optional[list[str]] = None,
    transcribe_fn: Optional[Callable[[str, Optional[str]], str]] = None,
    sr: int = 24_000,
) -> dict:
    """Slice every audio file into speech segments, write segment wavs +
    metadata.csv (reference transcribe_all, :636-704) with
    `transcribe_fn(segment_path, language) -> text`. No ASR model ships
    with the port: without one this raises."""
    wavs_dir = os.path.join(project_path, "wavs")
    meta_path = os.path.join(project_path, "metadata.csv")
    if audio_files is None:
        dataset_dir = os.path.join(project_path, "dataset")
        audio_files = [p for ext in AUDIO_EXTS
                       for p in glob(os.path.join(dataset_dir, f"*.{ext}"))]
    if not audio_files:
        raise FileNotFoundError(f"no audio files under {project_path}/dataset")

    if transcribe_fn is None:
        raise NotImplementedError("no ASR model ships with the port: pass transcribe_fn "
                                  "(segment path, language) -> text")

    if os.path.isdir(wavs_dir):
        shutil.rmtree(wavs_dir)
    os.makedirs(wavs_dir, exist_ok=True)

    slicer = Slicer(sr)
    num, errors, lines = 0, 0, []
    for path in audio_files:
        wav, in_sr = audio_io.read_wav(path)
        wav = audio_io.resample(wav, in_sr, sr)
        for chunk, _start, _end in slicer.slice(wav):
            name = f"segment_{num}"
            seg_path = os.path.join(wavs_dir, f"{name}.wav")
            audio_io.write_wav(seg_path, normalize_chunk(chunk), sr)
            try:
                text = transcribe_fn(seg_path, language).strip()
                lines.append(f"{name}|{text}")
                num += 1
            except Exception:
                errors += 1
    with open(meta_path, "w", encoding="utf-8-sig") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return {"segments": num, "errors": errors, "wavs_dir": wavs_dir,
            "metadata": meta_path}


def resolve_audio_path(name: str, base_path: str,
                       exts: tuple = AUDIO_EXTS) -> str:
    """metadata audio column -> file path (reference get_correct_audio_path,
    :714-742): absolute paths pass through; bare names search `base_path`
    across known extensions (defaulting to .wav)."""
    has_ext = any(name.endswith(f".{e}") for e in exts)
    if os.path.isabs(name) and has_ext:
        return name
    if has_ext:
        return os.path.join(base_path, name)
    for e in exts:
        cand = os.path.join(base_path, f"{name}.{e}")
        if os.path.exists(cand):
            return cand
    return os.path.join(base_path, f"{name}.{exts[0]}")


@dataclass
class MetadataResult:
    samples: int
    total_seconds: float
    min_seconds: float
    max_seconds: float
    vocab_size: int
    new_vocab: str
    errors: list
    arrow_path: str


def create_metadata(project_path: str, ch_tokenizer: bool = False,
                    polyphone: bool = True,
                    pretrained_vocab: Optional[str] = None) -> MetadataResult:
    """metadata.csv -> raw.arrow + duration.json + vocab.txt (reference
    create_metadata, :745-853). Filters: duration in [1, 30] s, text length
    >= 3; text is pinyin-converted. ch_tokenizer=True builds a char vocab
    from the data; otherwise the pretrained pinyin vocab is copied in."""
    wavs_dir = os.path.join(project_path, "wavs")
    meta_path = os.path.join(project_path, "metadata.csv")
    arrow_path = os.path.join(project_path, "raw.arrow")
    dur_path = os.path.join(project_path, "duration.json")
    vocab_path = os.path.join(project_path, "vocab.txt")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(meta_path)

    with open(meta_path, encoding="utf-8-sig") as f:
        raw_lines = f.read().split("\n")

    rows, durations, errors, vocab_set = [], [], [], set()
    for line in raw_lines:
        parts = line.split("|")
        if len(parts) != 2:
            continue
        name, text = parts
        path = resolve_audio_path(name, wavs_dir)
        if not os.path.isfile(path):
            errors.append([path, "error path"])
            continue
        try:
            wav, sr = audio_io.read_wav(path)
            duration = len(wav) / sr
        except Exception:
            errors.append([path, "duration"])
            continue
        if not 1.0 <= duration <= 30.0:
            errors.append([path, "duration > 30 sec" if duration > 30
                           else "duration < 1 sec"])
            continue
        if len(text) < 3:
            errors.append([path, "very short text length 3"])
            continue
        tokens = convert_char_to_pinyin([text.strip()], polyphone=polyphone)[0]
        rows.append({"audio_path": path, "text": tokens, "duration": duration})
        durations.append(duration)
        if ch_tokenizer:
            vocab_set.update(tokens)

    if not durations:
        raise RuntimeError(f"no usable rows in {meta_path} "
                           f"(errors: {errors[:5]})")

    from datasets.arrow_writer import ArrowWriter

    with ArrowWriter(path=arrow_path) as writer:
        for row in rows:
            writer.write(row)
        writer.finalize()
    with open(dur_path, "w") as f:
        json.dump({"duration": durations}, f, ensure_ascii=False)

    new_vocab = ""
    if ch_tokenizer:
        with open(vocab_path, "w", encoding="utf-8-sig") as f:
            for tok in sorted(vocab_set):
                f.write(tok + "\n")
        new_vocab = "\n".join(sorted(vocab_set))
        vocab_size = len(vocab_set)
    else:
        if not os.path.isfile(vocab_path):
            if pretrained_vocab is None:
                pretrained_vocab = EMILIA_VOCAB
            shutil.copy2(pretrained_vocab, vocab_path)
        with open(vocab_path, encoding="utf-8-sig") as f:
            vocab_size = sum(1 for _ in f)

    return MetadataResult(
        samples=len(rows), total_seconds=sum(durations),
        min_seconds=round(min(durations), 2), max_seconds=round(max(durations), 2),
        vocab_size=vocab_size, new_vocab=new_vocab, errors=errors,
        arrow_path=arrow_path)


# the frame budget's memory model: F5TTS_v1_Base training on one H100
# without activation checkpointing, bf16 compute, f32 state (PERF.md §5,
# scripts/train_bench.py): peak 18.58 GB at 16 x 1024 frames, 34.72 GB at
# 37 x 1024, i.e. 6.28 GB fixed and 0.7506 MB a frame; 10% kept free
TRAIN_FIXED_GB = 6.28
TRAIN_GB_PER_FRAME = 7.506e-4


def calculate_train(
    project_path: str,
    batch_size_type: str = "frame",
    max_samples: int = 64,
    num_warmup_updates: int = 20_000,
    finetune: bool = True,
    hbm_gb: Optional[float] = None,
    num_chips: int = 1,
    hop_length: int = 256,
    sampling_rate: int = 24_000,
) -> dict:
    """Suggest training hyperparameters from the prepared dataset (reference
    calculate_train, :860-946). The frame budget a card takes comes from
    the port's training memory (`TRAIN_FIXED_GB`, `TRAIN_GB_PER_FRAME`) and
    `hbm_gb`, the card's memory (80 GB, an H100's, when there is no card to
    ask); the JAX module sizes it for a 16 GB TPU. Keys as the JAX module's
    (`batch_size_per_chip`: frames or samples a card)."""
    dur_path = os.path.join(project_path, "duration.json")
    if not os.path.isfile(dur_path):
        raise FileNotFoundError(f"{dur_path} — run create_metadata first")
    with open(dur_path) as f:
        durations = json.load(f)["duration"]

    max_frames = max(durations) * sampling_rate / hop_length
    total_samples = len(durations)
    total_seconds = sum(durations)

    if hbm_gb is None:
        import torch

        hbm_gb = (torch.cuda.get_device_properties(0).total_memory / 1e9
                  if torch.cuda.is_available() else 80.0)

    if batch_size_type == "frame":
        batch_size_per_chip = max(int((0.9 * hbm_gb - TRAIN_FIXED_GB) / TRAIN_GB_PER_FRAME),
                                  int(max_frames))
    elif batch_size_type == "sample":
        batch_size_per_chip = int(200 / (total_seconds / total_samples))
    else:
        raise ValueError(batch_size_type)

    if total_samples < 64:
        max_samples = max(int(total_samples * 0.25), 1)
    num_warmup_updates = max(num_warmup_updates, int(total_samples * 0.05))

    max_updates = 1_200_000
    if batch_size_type == "frame":
        step_seconds = batch_size_per_chip * num_chips * hop_length / sampling_rate
        updates_per_epoch = max(total_seconds / step_seconds, 1e-9)
    else:
        updates_per_epoch = max(total_samples / batch_size_per_chip / num_chips, 1e-9)
    epochs = int(max_updates / updates_per_epoch)

    return {
        "epochs": epochs,
        "learning_rate": 1e-5 if finetune else 7.5e-5,
        "batch_size_per_chip": batch_size_per_chip,
        "max_samples": max_samples,
        "num_warmup_updates": num_warmup_updates,
        "total_samples": total_samples,
        "updates_per_epoch": updates_per_epoch,
    }


def vocab_check(project_path: str, tokenizer_type: str = "pinyin",
                pretrained_vocab: Optional[str] = None) -> tuple[str, list[str]]:
    """List dataset symbols missing from the pretrained vocab (reference
    vocab_check, :1081-1125). Returns (info message, missing symbols)."""
    meta_path = os.path.join(project_path, "metadata.csv")
    if pretrained_vocab is None:
        pretrained_vocab = EMILIA_VOCAB
    with open(pretrained_vocab, encoding="utf-8-sig") as f:
        vocab = set(f.read().split("\n"))
    with open(meta_path, encoding="utf-8-sig") as f:
        lines = f.read().split("\n")

    missing: list[str] = []
    seen = set()
    for line in lines:
        parts = line.split("|")
        if len(parts) != 2:
            continue
        text = parts[1].strip()
        tokens = (convert_char_to_pinyin([text], polyphone=True)[0]
                  if tokenizer_type == "pinyin" else list(text))
        for t in tokens:
            if t not in vocab and t not in seen:
                missing.append(t)
                seen.add(t)
    info = ("You can train using your language !" if not missing else
            f"The following {len(missing)} symbols are missing in your language")
    return info, missing


def vocab_extend(project_path: str, symbols: list[str],
                 base_vocab: Optional[str] = None,
                 ckpt_path: Optional[str] = None,
                 new_ckpt_path: Optional[str] = None) -> dict:
    """Append missing symbols to a copy of the pretrained vocab and (when a
    checkpoint is given) expand its text-embedding rows to match (reference
    vocab_extend, :1018-1078; expansion via finetune_cli.expand_text_embedding)."""
    if not symbols:
        raise ValueError("no symbols to extend")
    if base_vocab is None:
        base_vocab = EMILIA_VOCAB
    with open(base_vocab, encoding="utf-8-sig") as f:
        vocab = [v for v in f.read().split("\n")]
    have = set(vocab)
    miss = [s.replace(" ", "") for s in symbols]
    miss = [s for s in miss if s and s not in have]
    out_path = os.path.join(project_path, "vocab.txt")
    if vocab and vocab[-1] == "":
        vocab.pop()
    new_vocab = vocab + miss
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(new_vocab) + "\n")

    result = {"old_size": len(vocab), "new_size": len(new_vocab),
              "added": len(miss), "vocab_path": out_path}
    if ckpt_path and miss:
        result["new_vocab_size"] = expand_reference_checkpoint_embeddings(
            ckpt_path, new_ckpt_path or ckpt_path + ".expanded", len(miss))
        result["ckpt"] = new_ckpt_path or ckpt_path + ".expanded"
    return result


def expand_reference_checkpoint_embeddings(ckpt_path: str, new_ckpt_path: str,
                                           num_new_tokens: int,
                                           seed: int = 666) -> int:
    """Grow the text-embedding rows of a reference-format checkpoint by
    num_new_tokens, the new rows N(0, 1) from a generator seeded `seed`
    (reference expand_model_embeddings, finetune_gradio.py:974-1011; the
    global torch generator the JAX module seeds draws the same numbers).
    .pt files round-trip through torch.save, .safetensors through the
    port's own reader and writer, each tensor in its stored dtype."""
    import torch

    from f5tts_tpu_torch.compat.torch_import import read_safetensors, write_safetensors

    if ckpt_path.endswith(".safetensors"):
        ckpt = {"ema_model_state_dict": read_safetensors(ckpt_path)}
    else:
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)

    ema_sd = ckpt.get("ema_model_state_dict", {})
    key = "ema_model.transformer.text_embed.text_embed.weight"
    if key not in ema_sd:  # bare safetensors export (no ema_model. prefix)
        key = next(k for k in ema_sd if k.endswith("text_embed.text_embed.weight"))
    old = ema_sd[key]
    vocab_new = old.size(0) + num_new_tokens
    grown = torch.zeros((vocab_new, old.size(1)), dtype=old.dtype)
    grown[: old.size(0)] = old
    grown[old.size(0):] = torch.randn((num_new_tokens, old.size(1)),
                                      generator=torch.Generator().manual_seed(seed))
    ema_sd[key] = grown

    if new_ckpt_path.endswith(".safetensors"):
        write_safetensors(ema_sd, new_ckpt_path)
    else:
        torch.save(ckpt, new_ckpt_path)
    return vocab_new


def format_seconds_to_hms(seconds: float) -> str:
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"
