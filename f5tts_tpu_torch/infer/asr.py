"""Transcription of a reference clip (counterpart of f5tts_tpu/infer/asr.py;
the reference's utils_infer.py:150-184, a lazy whisper-large-v3-turbo
pipeline).

`transformers` is imported when called, and the model is read only from a
local directory or the local Hugging Face cache: nothing is downloaded.
Without `transformers` (the card's machine has none) or without the
weights it raises RuntimeError, and the caller passes the text instead.
`utils_infer.preprocess_ref_audio_text` calls `transcribe` on an empty
reference text.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_asr_pipe = None


def initialize_asr_pipeline(model: str = "openai/whisper-large-v3-turbo", device=None):
    """The ASR pipeline of `model` (a directory, or a hub name already in the
    local cache) on `device` (the card when None), built once."""
    global _asr_pipe
    if _asr_pipe is not None:
        return _asr_pipe
    try:
        from f5tts_tpu_torch.utils import resolve_device

        dev = resolve_device(device)
        from transformers import pipeline

        if not os.path.isdir(model):
            from huggingface_hub import snapshot_download

            model = snapshot_download(model, local_files_only=True)
        _asr_pipe = pipeline("automatic-speech-recognition", model=model, device=dev)
    except Exception as e:
        raise RuntimeError(
            f"ASR unavailable ({type(e).__name__}: {e}); pass ref_text explicitly "
            "or put the whisper model in the local Hugging Face cache") from e
    return _asr_pipe


def transcribe(wav: np.ndarray, sr: int, language: Optional[str] = None) -> str:
    """The stripped transcript of `wav` at `sr`."""
    pipe = initialize_asr_pipeline()
    kwargs = {"task": "transcribe"}
    if language:
        kwargs["language"] = language
    out = pipe({"array": wav.astype(np.float32), "sampling_rate": sr},
               generate_kwargs=kwargs, return_timestamps=False)
    return out["text"].strip()
