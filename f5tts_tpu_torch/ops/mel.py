"""Log-mel front end (counterpart of f5tts_tpu/ops/mel.py:30-149).

Two variants, as in the JAX package:
- "vocos": torchaudio MelSpectrogram semantics: center=True reflect-padded
  STFT magnitude (power 1), HTK mel scale, no filterbank norm;
- "bigvgan": a reflect pad of (n_fft - hop) / 2, a center=False STFT,
  sqrt(|.|^2 + 1e-9), the Slaney mel scale (linear below 1 kHz, log above)
  with the Slaney area norm;
then log(clamp(mel, 1e-5)). The filterbanks are built in numpy float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import MelConfig
from f5tts_tpu_torch.ops.stft import hann_window, stft_magnitude, stft_magnitude_eps
from f5tts_tpu_torch.utils import resolve_device

_F_SP = 200.0 / 3.0          # Slaney: Hz per mel below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, mel_scale: str = "htk",
                   norm: Optional[str] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filterbank; `mel_scale` "htk" or
    "slaney", `norm` None or "slaney" (each filter's area 1)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    if mel_scale == "htk":
        to_mel, to_hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif mel_scale == "slaney":
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel_scale {mel_scale!r} (htk | slaney)")
    m_min, m_max = to_mel(np.asarray([fmin, fmax], dtype=np.float64))
    f_pts = to_hz(np.linspace(m_min, m_max, n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.T.astype(np.float32)


def filterbank_for(cfg: MelConfig) -> np.ndarray:
    """The filterbank of `cfg.mel_spec_type`: HTK (vocos) or Slaney with
    the Slaney norm (bigvgan)."""
    if cfg.mel_spec_type == "vocos":
        return mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels)
    if cfg.mel_spec_type == "bigvgan":
        return mel_filterbank(cfg.target_sample_rate, cfg.n_fft, cfg.n_mel_channels,
                              mel_scale="slaney", norm="slaney")
    raise ValueError(f"unknown mel_spec_type {cfg.mel_spec_type!r} (vocos | bigvgan)")


class MelFrontend:
    """wav [b, l] -> log-mel [b, n_mels, t], on `device`."""

    def __init__(self, cfg: Optional[MelConfig] = None, device=None):
        self.cfg = cfg or MelConfig()
        fb = filterbank_for(self.cfg)
        self.device = resolve_device(device)
        self.window = hann_window(self.cfg.win_length, self.device)
        self.fb = torch.from_numpy(fb).to(self.device)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 1:
            wav = wav[None, :]
        c = self.cfg
        wav = wav.to(self.device)
        if c.mel_spec_type == "vocos":
            mag = stft_magnitude(wav, self.window, c.n_fft, c.hop_length)
        else:
            mag = stft_magnitude_eps(wav, self.window, c.n_fft, c.hop_length)
        mel = torch.einsum("mf,bft->bmt", self.fb, mag)
        return torch.log(torch.clamp(mel, min=1e-5))

    def frames_to_mel_bnd(self, wav: torch.Tensor) -> torch.Tensor:
        """wav -> [b, t, n_mels] (the sequence-major layout the model takes)."""
        return self(wav).transpose(1, 2)
