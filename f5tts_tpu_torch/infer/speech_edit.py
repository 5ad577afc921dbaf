"""Speech editing: regenerate chosen spans of an utterance to speak a new
text (counterpart of f5tts_tpu/infer/speech_edit.py:32-145).

1. the original mel (`pipeline.mel`);
2. a spliced `mel_cond`: the original frames where the audio is kept, zero
   frames (of the requested duration) for each edited span;
3. an `edit_mask`: True keeps a frame, False regenerates it;
4. `cfm_sample(edit_mask=...)`, eagerly: the sampler conditions on the kept
   frames only and re-imposes them on its result; the edited spans are
   synthesized from the target text. Then the pipeline's vocoder.

The spans come in seconds (`edit_speech`) or as text, aligned by the CTC
forced aligner of `infer/align.py` (`edit_speech_by_text`). The speech-edit
CLI waits for the port of the JAX package's `infer/api.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.utils import duration_bucket, make_time_grid


def build_edit_cond(original_mel: np.ndarray, parts_to_edit: Sequence[tuple],
                    fix_durations: Optional[Sequence[float]] = None,
                    sample_rate: int = 24000, hop: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """(mel_cond [t', d], edit_mask [t'] bool) from the original mel [t, d]
    and the spans [(start_s, end_s), ...]; `fix_durations` gives each
    span's new length in seconds (by default its old one)."""
    d = original_mel.shape[1]
    fix = list(fix_durations) if fix_durations is not None else None
    mel_cond = np.zeros((0, d), np.float32)
    edit_mask = np.zeros((0,), bool)
    offset = 0
    for start_s, end_s in parts_to_edit:
        part_dur_s = (end_s - start_s) if fix is None else fix.pop(0)
        start_f = round(start_s * sample_rate / hop)
        end_f = round(end_s * sample_rate / hop)
        part_f = round(part_dur_s * sample_rate / hop)
        mel_cond = np.concatenate(
            [mel_cond, original_mel[offset:start_f], np.zeros((part_f, d), np.float32)])
        edit_mask = np.concatenate(
            [edit_mask, np.ones(start_f - offset, bool), np.zeros(part_f, bool)])
        offset = end_f
    mel_cond = np.concatenate([mel_cond, original_mel[offset:]])
    edit_mask = np.concatenate(
        [edit_mask, np.ones(mel_cond.shape[0] - edit_mask.shape[0], bool)])
    return mel_cond, edit_mask


def prepare_edit(pipeline, wav: np.ndarray, sr: int, target_text: str,
                 parts_to_edit: Sequence[tuple], fix_durations: Optional[Sequence[float]] = None,
                 seed: int = 0, nfe_step: Optional[int] = None,
                 cfg_strength: Optional[float] = None, sway_sampling_coef="default",
                 y0: Optional[torch.Tensor] = None) -> dict:
    """The host side of one edit: `cfm_sample`'s arguments on the
    pipeline's device under their names (cond, text, lens, duration, t_grid,
    y0, cfg_strength, edit_mask), and `total` (frames) and `rms` (the input's,
    after resampling). The noise is `y0` or drawn from the seed."""
    s = pipeline.sampling
    nfe = nfe_step or s.nfe_steps
    cfg_v = s.cfg_strength if cfg_strength is None else cfg_strength
    sway = s.sway_sampling_coef if sway_sampling_coef == "default" else sway_sampling_coef

    wav = audio_io.resample(wav, sr, pipeline.sr)
    rms_v = audio_io.rms(wav)
    if 0 < rms_v < s.target_rms:
        wav = wav * (s.target_rms / rms_v)
    original_mel = pipeline.mel.frames_to_mel_bnd(
        torch.from_numpy(np.asarray(wav, np.float32))[None])[0].cpu().numpy()
    mel_cond, edit_mask = build_edit_cond(original_mel, parts_to_edit, fix_durations,
                                          pipeline.sr, pipeline.hop)

    total, d = mel_cond.shape
    n_bucket = duration_bucket(total, pipeline.bucket_size, s.max_duration,
                               pipeline.bdef.seq_extra_tokens)
    cond = np.zeros((1, n_bucket, d), np.float32)
    cond[0, :total] = mel_cond
    emask = np.zeros((1, n_bucket), bool)
    emask[0, :total] = edit_mask

    dev = pipeline.device
    duration = torch.tensor([total], dtype=torch.int32, device=dev)
    if y0 is None:
        y0 = cfm.make_noise(torch.Generator(device=dev).manual_seed(seed), 1, n_bucket, d,
                            duration)
    return {"cond": torch.from_numpy(cond).to(dev),
            "text": torch.from_numpy(pipeline.tokenize([target_text])).to(dev),
            "lens": duration.clone(), "duration": duration,
            "t_grid": make_time_grid(nfe, sway_sampling_coef=sway, use_epss=s.use_epss).to(dev),
            "y0": y0.to(dev), "cfg_strength": cfg_v,
            "edit_mask": torch.from_numpy(emask).to(dev), "total": total, "rms": rms_v}


def edit_speech(pipeline, wav: np.ndarray, sr: int, target_text: str,
                parts_to_edit: Sequence[tuple], fix_durations: Optional[Sequence[float]] = None,
                seed: int = 0, nfe_step: Optional[int] = None,
                cfg_strength: Optional[float] = None, sway_sampling_coef="default",
                y0: Optional[torch.Tensor] = None) -> tuple[np.ndarray, int]:
    """Edit the spans of `wav` to speak `target_text` through the
    `InferencePipeline` `pipeline` (its params, sampling defaults and
    vocoder); returns (wave, sample rate)."""
    req = prepare_edit(pipeline, wav, sr, target_text, parts_to_edit, fix_durations, seed,
                       nfe_step, cfg_strength, sway_sampling_coef, y0)
    total, rms_v = req.pop("total"), req.pop("rms")
    out = cfm.cfm_sample(pipeline.params, pipeline.statics, dtype=pipeline.dtype,
                         backbone=pipeline.bdef, **req)
    wave = pipeline.vocoder(out[:, :total].transpose(1, 2))[0].cpu().numpy()
    target = pipeline.sampling.target_rms
    if 0 < rms_v < target:
        wave = wave * (rms_v / target)
    return wave.astype(np.float32), pipeline.sr


def edit_speech_by_text(pipeline, wav: np.ndarray, sr: int, original_text: str,
                        target_text: str, edits: Sequence,
                        fix_durations: Optional[Sequence[float]] = None, char_spans=None,
                        **kwargs) -> tuple[np.ndarray, int]:
    """`edit_speech` with the spans given as text: `edits` are substrings of
    `original_text` (resolved left to right) or (char_start, char_end)
    pairs, mapped to seconds by the CTC forced aligner (`infer/align.py`).
    `char_spans` passes a precomputed alignment; otherwise the
    weights-gated `align_text` runs on the pipeline's device, and raises
    RuntimeError when the acoustic model is missing."""
    from f5tts_tpu_torch.infer.align import align_text, spans_for_edits

    if char_spans is None:
        char_spans = align_text(wav, sr, original_text, device=pipeline.device)
    parts = spans_for_edits(char_spans, edits, text=original_text)
    return edit_speech(pipeline, wav, sr, target_text, parts, fix_durations=fix_durations,
                       **kwargs)
