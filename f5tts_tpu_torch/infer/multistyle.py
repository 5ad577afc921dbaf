"""Multi-style generation (counterpart of f5tts_tpu/infer/multistyle.py; the
reference gradio app's multistyle tab, src/f5_tts/infer/infer_gradio.py:
349-390 and 611-689), with no UI.

- `parse_speechtypes_text`: `{Type}` tags or `{"name": ..., "seed": ...,
  "speed": ...}` JSON tags; a type holds until the next tag; text before
  any tag is "Regular".
- `synthesize_multistyle`: each segment through any `infer_fn` (the port's
  pipeline on the card, or a stub); an unknown type falls back to Regular
  with a warning, seed -1 draws a fresh seed a segment, a transcribed
  reference text is cached into its type, a JSON-lines transcript of
  (name, seed, speed) is kept, and the segments are concatenated without a
  cross-fade.
"""

from __future__ import annotations

import json
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

DEFAULT_TYPE = "Regular"

# {Type} or {"name": ..., ...} — non-greedy so adjacent tags split apart
_TAG_PATTERN = re.compile(r"(\{.*?\})")


@dataclass
class SpeechSegment:
    name: str = DEFAULT_TYPE
    seed: int = -1           # -1 = draw a fresh random seed at synthesis time
    speed: float = 1.0
    text: str = ""


@dataclass
class SpeechType:
    audio: str = ""          # path or handle understood by infer_fn
    ref_text: str = ""


def _tag_to_style(tag: str) -> tuple[str, int, float]:
    """``{Angry}`` -> ("Angry", -1, 1.0); JSON dicts may override seed/speed."""
    try:
        d = json.loads(tag)
        if isinstance(d, dict):
            return (str(d.get("name", DEFAULT_TYPE)), int(d.get("seed", -1)),
                    float(d.get("speed", 1.0)))
    except (json.JSONDecodeError, TypeError, ValueError):
        pass
    return tag.strip()[1:-1], -1, 1.0


def parse_speechtypes_text(gen_text: str) -> list[SpeechSegment]:
    """Split tagged text into (type, seed, speed, text) segments.

    The type is sticky: it applies to every following text chunk until the
    next tag. Empty text chunks (e.g. between two adjacent tags) produce no
    segment. Text before any tag gets the default type.
    """
    tokens = _TAG_PATTERN.split(gen_text)
    segments: list[SpeechSegment] = []
    name, seed, speed = DEFAULT_TYPE, -1, 1.0
    for i, tok in enumerate(tokens):
        if i % 2:  # tag
            name, seed, speed = _tag_to_style(tok.strip())
        else:      # text
            text = tok.strip()
            if text:
                segments.append(SpeechSegment(name, seed, speed, text))
    return segments


def collect_speech_types(
    names: list[str], audios: list[str], ref_texts: list[str]
) -> "OrderedDict[str, SpeechType]":
    """Assemble the UI's parallel row lists into an ordered name->type map.

    Rows missing a name or an audio get a positional ``@i@`` placeholder so
    the per-row ref-text outputs stay aligned with the UI's row order
    (reference infer_gradio.py:620-630).
    """
    types: OrderedDict[str, SpeechType] = OrderedDict()
    for i, (name, audio, ref_text) in enumerate(zip(names, audios, ref_texts)):
        if name and audio:
            types[name] = SpeechType(audio=audio, ref_text=ref_text or "")
        else:
            types[f"@{i}@"] = SpeechType()
    return types


@dataclass
class MultistyleResult:
    sample_rate: Optional[int]
    wave: Optional[np.ndarray]
    # per-type ref texts in speech_types order (transcriptions written back)
    ref_texts: list[str] = field(default_factory=list)
    metadata: str = ""       # JSON-lines transcript of what was synthesized
    warnings: list[str] = field(default_factory=list)


# infer_fn(audio, ref_text, text, seed, speed) -> (sr, wave, ref_text_out, used_seed)
InferFn = Callable[[str, str, str, int, float],
                   tuple[int, np.ndarray, str, int]]


def synthesize_multistyle(
    gen_text: str,
    speech_types: "OrderedDict[str, SpeechType]",
    infer_fn: InferFn,
    *,
    default_type: str = DEFAULT_TYPE,
    rng: Optional[np.random.Generator] = None,
) -> MultistyleResult:
    """Run every parsed segment through ``infer_fn`` and concatenate.

    Matches reference generate_multistyle_speech: unknown types fall back
    to ``default_type`` (warning recorded), a missing reference audio for
    the resolved type aborts with a warning, transcribed ref texts are
    cached into ``speech_types`` so repeated segments skip ASR.
    """
    rng = rng or np.random.default_rng()
    segments = parse_speechtypes_text(gen_text)

    result = MultistyleResult(sample_rate=None, wave=None)
    pieces: list[np.ndarray] = []
    current = default_type
    meta_lines: list[str] = []

    for seg in segments:
        if seg.name in speech_types and speech_types[seg.name].audio:
            current = seg.name
        else:
            result.warnings.append(
                f"Type {seg.name} is not available, will use {default_type} as default.")
            current = default_type
        st = speech_types.get(current)
        if st is None or not st.audio:
            result.warnings.append(
                f"Please provide reference audio for type {current}.")
            result.ref_texts = [t.ref_text for t in speech_types.values()]
            return result

        seed = seg.seed if seg.seed != -1 else int(rng.integers(0, 2**31 - 1))
        sr, wave, ref_text_out, used_seed = infer_fn(
            st.audio, st.ref_text, seg.text, seed, seg.speed)
        st.ref_text = ref_text_out
        result.sample_rate = sr
        pieces.append(np.asarray(wave))
        meta_lines.append(
            json.dumps({"name": seg.name, "seed": used_seed, "speed": seg.speed})
            + f" {seg.text}")

    result.ref_texts = [t.ref_text for t in speech_types.values()]
    if not pieces:
        result.warnings.append("No audio generated.")
        return result
    result.wave = np.concatenate(pieces)
    result.metadata = "\n".join(meta_lines) + "\n"
    return result
