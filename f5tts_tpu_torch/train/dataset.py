"""Training data: host-side mel, datasets, frame-budget batching, collation
(counterpart of f5tts_tpu/train/dataset.py).

- NumpyMel: wav -> log-mel on the host in numpy (vocos or bigvgan variant).
- InMemoryDataset: rows of (mel, text) held in memory, with the
  `get_frame_len` / `get_text` / `__getitem__` interface the Trainer reads.
- CustomDataset: rows {audio_path | mel_spec, text, duration} of an arrow
  file (a HuggingFace `Dataset`) or a plain list of dicts; the wav is read,
  resampled to the target rate and turned into a mel on every access (as
  the JAX package does), rows outside 0.3-30 s are skipped forward.
- HFDataset: a HuggingFace dataset with an `audio` column ({array,
  sampling_rate}; channels averaged, resampled) and a `text` column.
- load_dataset: a prepared directory (raw.arrow | raw/ | mel.arrow, plus
  duration.json) by name or path, or a hub dataset. `datasets` is imported
  inside the functions that read arrow, so this module imports without it.
- DynamicBatchSampler: sort by frame length, pack batches greedily up to
  `frames_threshold` frames and `max_samples` rows, drop oversized samples,
  shuffle the batch order per epoch from a seed (python `random`, as the JAX
  package does, so the orders are the same).
- collate: pad mels to the batch max rounded up to `bucket_frames`.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.ops.mel import filterbank_for
from f5tts_tpu_torch.utils import round_up


class NumpyMel:
    """wav [l] -> log-mel [t, n_mels] (sequence-major) in numpy, as
    `ops.mel.MelFrontend` computes it: vocos (reflect pad n_fft / 2,
    |STFT|, HTK filterbank) or bigvgan (reflect pad (n_fft - hop) / 2,
    sqrt(|STFT|^2 + 1e-9), Slaney filterbank), then log(clamp(1e-5))."""

    def __init__(self, cfg: MelConfig = MelConfig()):
        self.cfg = cfg
        self.fb = filterbank_for(cfg)
        n = np.arange(cfg.win_length)
        self.window = (0.5 - 0.5 * np.cos(2 * np.pi * n / cfg.win_length)).astype(np.float64)

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        c = self.cfg
        vocos = c.mel_spec_type == "vocos"
        pad = c.n_fft // 2 if vocos else (c.n_fft - c.hop_length) // 2
        x = np.pad(wav, (pad, pad), mode="reflect")
        n_frames = (len(x) - c.n_fft) // c.hop_length + 1
        idx = np.arange(c.n_fft)[None, :] + c.hop_length * np.arange(n_frames)[:, None]
        spec = np.fft.rfft(x[idx] * self.window[None, :], axis=-1)
        mag = np.abs(spec) if vocos else np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
        mel = mag.astype(np.float32) @ self.fb.T
        return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


@dataclass
class Sample:
    mel: np.ndarray  # [t, n_mels]
    text: object     # raw string, or a pre-tokenized pinyin token list


class InMemoryDataset:
    """Rows of (mel [t, n_mels], text) held in memory."""

    def __init__(self, mels: Sequence[np.ndarray], texts: Sequence, mel_cfg: MelConfig = MelConfig()):
        if len(mels) != len(texts):
            raise ValueError("InMemoryDataset needs one text per mel")
        self.mels = list(mels)
        self.texts = list(texts)
        self.mel_cfg = mel_cfg

    def __len__(self) -> int:
        return len(self.mels)

    def get_frame_len(self, index: int) -> float:
        return float(self.mels[index].shape[0])

    def get_text(self, index: int):
        return self.texts[index]

    def __getitem__(self, index: int) -> Sample:
        return Sample(mel=np.asarray(self.mels[index], np.float32), text=self.texts[index])


class CustomDataset:
    """Arrow-backed dataset (reference dataset.py:58-166): `data` is a
    HuggingFace `Dataset` or a list of dicts, `durations` (seconds) those of
    duration.json when it was loaded."""

    def __init__(self, data, durations: Optional[Sequence[float]] = None,
                 mel_cfg: MelConfig = MelConfig(), preprocessed_mel: bool = False,
                 audio_root: str = ""):
        self.data = data
        self.durations = durations
        self.mel_cfg = mel_cfg
        self.preprocessed_mel = preprocessed_mel
        self.audio_root = audio_root
        self.mel = NumpyMel(mel_cfg)

    def __len__(self) -> int:
        return len(self.data)

    def get_frame_len(self, index: int) -> float:
        cfg = self.mel_cfg
        if self.durations is not None:
            return self.durations[index] * cfg.target_sample_rate / cfg.hop_length
        row = self.data[index]
        duration = row.get("duration") if hasattr(row, "get") else row["duration"]
        if duration is None:
            raise KeyError(
                f"row {index} has no 'duration' and no duration.json was loaded: frame-budget "
                "batching needs one of the two (the prep scripts always write duration.json)")
        return duration * cfg.target_sample_rate / cfg.hop_length

    def _resolve_index(self, index: int) -> int:
        """Rows outside 0.3-30 s are skipped forward (ref :129-140); the text
        and audio accessors agree on the row that replaces them."""
        if self.preprocessed_mel:
            return index
        while True:
            duration = self.data[index].get("duration")
            if duration is None or 0.3 <= duration <= 30.0:
                return index
            index = (index + 1) % len(self.data)

    def get_text(self, index: int):
        """The row's text without reading its audio."""
        return self.data[self._resolve_index(index)]["text"]

    def __getitem__(self, index: int) -> Sample:
        cfg = self.mel_cfg
        row = self.data[self._resolve_index(index)]
        if self.preprocessed_mel:
            mel = np.asarray(row["mel_spec"], np.float32)
            if mel.shape[0] == cfg.n_mel_channels:
                mel = mel.T
            return Sample(mel=mel, text=row["text"])
        from f5tts_tpu_torch.infer import audio_io

        wav, sr = audio_io.read_wav(os.path.join(self.audio_root, row["audio_path"]))
        wav = audio_io.resample(wav, sr, cfg.target_sample_rate)
        return Sample(mel=self.mel(wav), text=row["text"])


class HFDataset:
    """A HuggingFace dataset with an `audio` column ({"array",
    "sampling_rate"}) and a `text` column, the mel computed on access
    (reference dataset.py:17-56); multi-channel audio ([channels, samples],
    as `datasets` decodes it with mono=False) is averaged, then resampled
    by `audio_io.resample`. A row's duration counts its samples (the last
    axis): the JAX module counts `len(array)`, the channels of such a row,
    so every stereo row looks 0.3 s short to it and its skip-forward never
    ends."""

    def __init__(self, data, mel_cfg: MelConfig = MelConfig()):
        self.data = data
        self.mel_cfg = mel_cfg
        self.mel = NumpyMel(mel_cfg)

    def __len__(self) -> int:
        return len(self.data)

    @staticmethod
    def _seconds(audio) -> float:
        return np.shape(audio["array"])[-1] / audio["sampling_rate"]

    def get_frame_len(self, index: int) -> float:
        cfg = self.mel_cfg
        return self._seconds(self.data[index]["audio"]) * cfg.target_sample_rate / cfg.hop_length

    def _resolve_index(self, index: int) -> int:
        while True:
            if 0.3 <= self._seconds(self.data[index]["audio"]) <= 30.0:
                return index
            index = (index + 1) % len(self.data)

    def get_text(self, index: int):
        return self.data[self._resolve_index(index)]["text"]

    def __getitem__(self, index: int) -> Sample:
        row = self.data[self._resolve_index(index)]
        audio = row["audio"]
        wav = np.asarray(audio["array"], np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        from f5tts_tpu_torch.infer import audio_io

        wav = audio_io.resample(wav, audio["sampling_rate"], self.mel_cfg.target_sample_rate)
        return Sample(mel=self.mel(wav), text=row["text"])


def _load_arrow_dir(d: str, audio_type: str = "raw"):
    """A prepared directory -> (HF dataset, durations or None, preprocessed_mel)."""
    import datasets as hf_datasets

    if audio_type == "mel":
        data = hf_datasets.Dataset.from_file(os.path.join(d, "mel.arrow"))
        preprocessed = True
    elif os.path.isdir(os.path.join(d, "raw")):
        data = hf_datasets.load_from_disk(os.path.join(d, "raw"))
        preprocessed = False
    else:
        data = hf_datasets.Dataset.from_file(os.path.join(d, "raw.arrow"))
        preprocessed = False
    durations = None
    dur_path = os.path.join(d, "duration.json")
    if os.path.exists(dur_path):
        with open(dur_path) as f:
            durations = json.load(f)["duration"]
    return data, durations, preprocessed


def load_dataset(dataset_name: str, tokenizer: str = "pinyin", mel_cfg: MelConfig = MelConfig(),
                 data_root: Optional[str] = None, dataset_type: str = "CustomDataset",
                 audio_type: str = "raw"):
    """A training dataset (reference dataset.py:247-307):
    - "CustomDataset": <data_root or $F5TTS_DATA_ROOT or "data">/<name>_<tokenizer>/;
    - "CustomDatasetPath": `dataset_name` is the directory;
    - "HFDataset": `dataset_name` = "<repo>_<split>" through datasets.load_dataset
      (needs the hub or a populated $HF_DATASETS_CACHE)."""
    if dataset_type == "CustomDataset":
        root = data_root or os.environ.get("F5TTS_DATA_ROOT", "data")
        data, durations, preprocessed = _load_arrow_dir(
            os.path.join(root, f"{dataset_name}_{tokenizer}"), audio_type)
        return CustomDataset(data, durations=durations, mel_cfg=mel_cfg,
                             preprocessed_mel=preprocessed)
    if dataset_type == "CustomDatasetPath":
        data, durations, preprocessed = _load_arrow_dir(dataset_name, audio_type)
        return CustomDataset(data, durations=durations, mel_cfg=mel_cfg,
                             preprocessed_mel=preprocessed)
    if dataset_type == "HFDataset":
        import datasets as hf_datasets

        pre, post = dataset_name.rsplit("_", 1)
        try:
            data = hf_datasets.load_dataset(f"{pre}/{pre}", split=f"train.{post}")
        except Exception as e:
            raise RuntimeError(
                f"HFDataset '{pre}/{pre}' (split train.{post}) could not be loaded: hub access "
                "or a populated $HF_DATASETS_CACHE is required") from e
        return HFDataset(data, mel_cfg=mel_cfg)
    raise ValueError(f"unknown dataset_type {dataset_type!r}")


class DynamicBatchSampler:
    """Frame-budget batches (reference dataset.py:170-241)."""

    def __init__(self, frame_lens: Sequence[float], frames_threshold: int, max_samples: int = 0,
                 random_seed: Optional[int] = None, drop_residual: bool = False):
        self.frames_threshold = frames_threshold
        self.max_samples = max_samples
        self.random_seed = random_seed
        self.epoch = 0

        indices = sorted(range(len(frame_lens)), key=lambda i: frame_lens[i])
        batches: list[list[int]] = []
        batch: list[int] = []
        batch_frames = 0.0
        for idx in indices:
            fl = frame_lens[idx]
            if fl > frames_threshold:
                continue  # oversized sample dropped
            if (batch_frames + fl <= frames_threshold
                    and (max_samples == 0 or len(batch) < max_samples)):
                batch.append(idx)
                batch_frames += fl
            else:
                if batch:
                    batches.append(batch)
                batch = [idx]
                batch_frames = fl
        if batch and not drop_residual:
            batches.append(batch)
        self.batches = batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[list[int]]:
        order = list(range(len(self.batches)))
        if self.random_seed is not None:
            random.Random(self.random_seed + self.epoch).shuffle(order)
        for i in order:
            yield self.batches[i]


def collate(samples: list[Sample], bucket_frames: int = 64, max_frames: Optional[int] = None,
            pad_to: Optional[int] = None) -> dict:
    """Pad to the batch max rounded up to `bucket_frames` (or exactly `pad_to`);
    numpy arrays + the raw text list."""
    lens = np.asarray([s.mel.shape[0] for s in samples], np.int32)
    if pad_to is not None:
        width = pad_to
    else:
        width = round_up(int(lens.max()), bucket_frames)
        if max_frames is not None:
            width = min(width, max_frames)
    d = samples[0].mel.shape[1]
    mel = np.zeros((len(samples), width, d), np.float32)
    for i, s in enumerate(samples):
        t = min(s.mel.shape[0], width)
        mel[i, :t] = s.mel[:t]
    return {
        "mel": mel,
        "mel_lengths": np.minimum(lens, width),
        "text": [s.text for s in samples],
        "text_lengths": np.asarray([len(s.text) for s in samples], np.int32),
    }
