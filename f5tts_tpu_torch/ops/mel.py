"""Log-mel front end, vocos variant (counterpart of f5tts_tpu/ops/mel.py:33-149).

torchaudio MelSpectrogram semantics: center=True reflect-padded STFT
magnitude (power 1), HTK mel scale, no filterbank norm, then
log(clamp(mel, 1e-5)). The filterbank is built in numpy float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.ops.stft import hann_window, stft_magnitude
from f5tts_tpu_torch.utils import resolve_device


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank_htk(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                       fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK filterbank, no norm."""
    if fmax is None:
        fmax = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    m_min, m_max = _hz_to_mel_htk(np.asarray([fmin, fmax], dtype=np.float64))
    f_pts = _mel_to_hz_htk(np.linspace(m_min, m_max, n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.T.astype(np.float32)


class MelFrontend:
    """wav [b, l] -> log-mel [b, n_mels, t], on `device`."""

    def __init__(self, cfg: Optional[MelConfig] = None, device=None):
        self.cfg = cfg or MelConfig()
        if self.cfg.mel_spec_type != "vocos":
            raise ValueError(f"mel_spec_type {self.cfg.mel_spec_type!r} is not ported")
        self.device = resolve_device(device)
        c = self.cfg
        self.window = hann_window(c.win_length, self.device)
        self.fb = torch.from_numpy(
            mel_filterbank_htk(c.target_sample_rate, c.n_fft, c.n_mel_channels)).to(self.device)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 1:
            wav = wav[None, :]
        c = self.cfg
        mag = stft_magnitude(wav.to(self.device), self.window, c.n_fft, c.hop_length)
        mel = torch.einsum("mf,bft->bmt", self.fb, mag)
        return torch.log(torch.clamp(mel, min=1e-5))

    def frames_to_mel_bnd(self, wav: torch.Tensor) -> torch.Tensor:
        """wav -> [b, t, n_mels] (the sequence-major layout the model takes)."""
        return self(wav).transpose(1, 2)
