"""Host-side audio helpers (counterpart of f5tts_tpu/infer/audio_io.py).

numpy / scipy in place of the reference's pydub / torchaudio host path:
- WAV read / write through soundfile when it imports, else scipy.io.wavfile
  (int16 PCM out);
- polyphase resampling (scipy.signal.resample_poly);
- silence split and edge trim on 10 ms dBFS frames (pydub's
  split_on_silence / detect_leading_silence semantics), and the reference
  clip policy built on them.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def read_wav(path) -> tuple[np.ndarray, int]:
    """(float32 mono samples in [-1, 1], sample rate) of a WAV file path or
    file object; channels are averaged."""
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32", always_2d=True)
        return data.mean(axis=1).astype(np.float32), int(sr)
    except ImportError:
        pass
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data.astype(np.float32), int(sr)


def write_wav(path, wav: np.ndarray, sr: int) -> None:
    """Write mono samples in [-1, 1] (clipped) as a WAV file."""
    try:
        import soundfile as sf

        sf.write(path, wav, sr)
        return
    except ImportError:
        pass
    from scipy.io import wavfile

    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy resample_poly)."""
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, sr).limit_denominator(1000)
    return resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)


def rms(wav: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(wav)))) if wav.size else 0.0


def _frame_dbfs(wav: np.ndarray, sr: int, frame_ms: int = 10) -> np.ndarray:
    """dBFS of each whole `frame_ms` frame (0 dB = full scale)."""
    n = max(int(sr * frame_ms / 1000), 1)
    usable = len(wav) // n * n
    frames = wav[:usable].reshape(-1, n)
    r = np.sqrt(np.mean(frames * frames, axis=1))
    return 20.0 * np.log10(np.maximum(r, 1e-10))


def split_on_silence(wav: np.ndarray, sr: int, min_silence_len_ms: int = 1000,
                     silence_thresh_db: float = -50.0, keep_silence_ms: int = 1000,
                     seek_step_ms: int = 10) -> list[np.ndarray]:
    """The segments between silences of at least `min_silence_len_ms`
    (frames below `silence_thresh_db`), each keeping up to
    `keep_silence_ms` of the silence on either side."""
    db = _frame_dbfs(wav, sr, seek_step_ms)
    silent = db < silence_thresh_db
    min_frames = max(min_silence_len_ms // seek_step_ms, 1)
    frame_n = int(sr * seek_step_ms / 1000)

    sil_regions = []
    i = 0
    while i < len(silent):
        if silent[i]:
            j = i
            while j < len(silent) and silent[j]:
                j += 1
            if j - i >= min_frames:
                sil_regions.append((i * frame_n, j * frame_n))
            i = j
        else:
            i += 1
    if not sil_regions:
        return [wav]

    keep = int(sr * keep_silence_ms / 1000)
    segs = []
    prev_end = 0
    for s, e in sil_regions:
        seg_end = min(s + keep, len(wav))
        if seg_end > prev_end:
            segs.append(wav[prev_end:seg_end])
        prev_end = max(e - keep, 0)
    if prev_end < len(wav):
        segs.append(wav[prev_end:])
    return [s for s in segs if len(s) > 0]


def remove_silence_edges(wav: np.ndarray, sr: int, silence_thresh_db: float = -42.0) -> np.ndarray:
    """Trim leading and trailing 10 ms frames below `silence_thresh_db`."""
    db = _frame_dbfs(wav, sr, 10)
    frame_n = int(sr * 10 / 1000)
    nonsilent = np.where(db >= silence_thresh_db)[0]
    if len(nonsilent) == 0:
        return wav[:0]
    start = nonsilent[0] * frame_n
    end = min((nonsilent[-1] + 1) * frame_n, len(wav))
    return wav[start:end]


def clip_ref_audio(wav: np.ndarray, sr: int, max_ms: int = 12000) -> np.ndarray:
    """The reference clip policy: cut at long silences (-50 dB, 1 s), then
    at short ones (-40 dB, 100 ms), then hard at `max_ms`; trim the edges and
    pad 50 ms of silence at the end."""
    max_n = int(sr * max_ms / 1000)
    six_s = int(sr * 6)

    def accumulate(segs):
        out = np.zeros(0, np.float32)
        for seg in segs:
            if len(out) > six_s and len(out) + len(seg) > max_n:
                break
            out = np.concatenate([out, seg])
        return out

    acc = accumulate(split_on_silence(wav, sr, 1000, -50.0, 1000))
    if len(acc) > max_n:
        acc = accumulate(split_on_silence(wav, sr, 100, -40.0, 1000))
    if len(acc) > max_n:
        acc = acc[:max_n]
    acc = remove_silence_edges(acc, sr)
    tail = np.zeros(int(sr * 0.05), np.float32)
    return np.concatenate([acc, tail]).astype(np.float32)
