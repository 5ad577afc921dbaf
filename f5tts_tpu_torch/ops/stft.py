"""STFT / iSTFT (counterpart of f5tts_tpu/ops/stft.py:28-223, irfft path).

No Pallas kernel is involved here, so the DFTs go to `torch.fft`.
- `stft_magnitude`: center=True reflect-padded STFT magnitude, [b, l] ->
  [b, n_fft//2+1, t] (torch.stft/torchaudio semantics).
- `stft_magnitude_eps`: the bigvgan mel's: a reflect pad of
  (n_fft - hop) / 2, a center=False STFT, sqrt(re^2 + im^2 + eps).
- `istft_center`: irfft per frame, window, overlap-add, divide by the
  squared-window envelope where it exceeds 1e-11, trim n_fft/2, keep
  (t-1)*hop samples (torch.istft(center=True) semantics).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default), built in float64."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[b, l] -> [b, t, frame_length]; t = (l - frame_length)//hop + 1."""
    return x.unfold(-1, frame_length, hop)


def stft_magnitude(x: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
                   hop: int = 256, center: bool = True) -> torch.Tensor:
    """|STFT| of [b, l] -> [b, n_fft//2+1, t] in f32."""
    x = x.float()
    if center:
        x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = frame_signal(x, n_fft, hop) * window[None, None, :]
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    return mag.transpose(1, 2)


def stft_magnitude_eps(x: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
                       hop: int = 256, pad: Optional[int] = None,
                       eps: float = 1e-9) -> torch.Tensor:
    """sqrt(|STFT|^2 + eps) of [b, l] -> [b, n_fft//2+1, t] in f32, after a
    reflect pad of `pad` ((n_fft - hop) // 2 by default) a side."""
    if pad is None:
        pad = (n_fft - hop) // 2
    x = F.pad(x.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * window[None, None, :], n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps).transpose(1, 2)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[b, t, frame_length] -> [b, (t-1)*hop + frame_length] by R shifted adds."""
    b, t, frame_length = frames.shape
    if frame_length % hop:
        raise ValueError("overlap_add needs frame_length % hop == 0")
    r = frame_length // hop
    out = frames.new_zeros((b, (t - 1) * hop + frame_length))
    chunks = frames.reshape(b, t, r, hop)
    for j in range(r):
        out[:, j * hop: j * hop + t * hop] += chunks[:, :, j, :].reshape(b, t * hop)
    return out


def istft_center(real: torch.Tensor, imag: torch.Tensor, window: torch.Tensor,
                 n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """real/imag [b, n_fft//2+1, t] -> wav [b, (t-1)*hop]."""
    spec = torch.complex(real.float(), imag.float()).transpose(1, 2)  # [b, t, f]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window[None, None, :]
    wav = overlap_add(frames, hop)
    t = real.shape[-1]
    env = overlap_add((window * window)[None, None, :].expand(1, t, n_fft), hop)[0]
    ok = env > 1e-11
    wav = torch.where(ok, wav / torch.where(ok, env, torch.ones_like(env)), wav)
    half = n_fft // 2
    return wav[:, half: half + (t - 1) * hop]
