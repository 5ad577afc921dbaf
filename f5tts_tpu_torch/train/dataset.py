"""Training data: host-side mel, datasets, frame-budget batching, collation
(counterpart of f5tts_tpu/train/dataset.py:38-75 and :262-346).

- NumpyMel: wav -> log-mel on the host in numpy (vocos or bigvgan variant).
- InMemoryDataset: rows of (mel, text) held in memory, with the
  `get_frame_len` / `get_text` / `__getitem__` interface the Trainer reads.
  The arrow (CustomDataset) and HuggingFace loaders are not ported yet.
- DynamicBatchSampler: sort by frame length, pack batches greedily up to
  `frames_threshold` frames and `max_samples` rows, drop oversized samples,
  shuffle the batch order per epoch from a seed (python `random`, as the JAX
  package does, so the orders are the same).
- collate: pad mels to the batch max rounded up to `bucket_frames`.
"""

from __future__ import annotations

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
    text: object     # raw string


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
