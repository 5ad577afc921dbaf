"""Host-side audio helpers (counterpart of f5tts_tpu/infer/audio_io.py:58-68)."""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy resample_poly)."""
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def rms(wav: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0
