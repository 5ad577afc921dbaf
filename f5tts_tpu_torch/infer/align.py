"""CTC forced alignment for speech editing (counterpart of
f5tts_tpu/infer/align.py).

The reference's speech-edit workflow takes per-char edit spans from an
external CTC forced aligner (a wav2vec2-CTC model + CTC segmentation). This
module is the port's own copy of the JAX package's equivalent:

- `ctc_viterbi_align`: the CTC segmentation dynamic program (Viterbi over
  the blank-interleaved CTC state graph), pure numpy. Repeated tokens need
  T >= L + the number of repeats; only T < L is checked, as in the JAX
  package.
- `align_with_logits`: logits + text + vocab -> per-char second spans.
- `load_alignment_model` / `align_text`: the weights-gated leg that runs a
  wav2vec2-CTC model from `transformers` on the card (or on the device the
  caller names); missing weights raise RuntimeError instead of a silent
  misalignment.
- `spans_for_edits`: (char_start, char_end) ranges or substrings of the
  original text -> (start_s, end_s) audio spans.

Alignment is a preprocessing step, not a serving hot path: only the
acoustic model runs on the device, the DP runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.precision import full_f32
from f5tts_tpu_torch.utils import resolve_device

NEG = -1.0e30


# ---------------------------------------------------------------------------
# CTC segmentation DP
# ---------------------------------------------------------------------------

def ctc_viterbi_align(
    log_probs: np.ndarray,   # [T, V] log-softmax frame posteriors
    tokens: Sequence[int],   # [L] target token ids (no blanks)
    blank: int = 0,
) -> list[tuple[int, int]]:
    """Most-likely CTC path through `tokens`; returns per-token frame spans.

    Standard blank-interleaved state graph: states s in [0, 2L], even s =
    blank, odd s = tokens[s//2]. Transitions: stay (s->s), advance (s-1->s),
    and the blank-skip (s-2->s) allowed only onto a token state whose token
    differs from the previous token (repeated tokens MUST pass through the
    separating blank — the CTC collapse rule). The returned span for token i
    is the half-open frame interval [start, end) the Viterbi path spends in
    state 2i+1.
    """
    log_probs = np.asarray(log_probs, np.float32)
    T, V = log_probs.shape
    tokens = list(tokens)
    L = len(tokens)
    if L == 0:
        return []
    if T < L:  # not enough frames to emit every token
        raise ValueError(f"cannot align {L} tokens into {T} frames")
    S = 2 * L + 1
    lab = np.full(S, blank, np.int64)
    lab[1::2] = tokens

    # skip allowed onto odd s>=3 when tokens differ across the blank
    can_skip = np.zeros(S, bool)
    for s in range(3, S, 2):
        can_skip[s] = tokens[s // 2] != tokens[s // 2 - 1]

    alpha = np.full(S, NEG, np.float32)
    alpha[0] = log_probs[0, blank]
    if S > 1:
        alpha[1] = log_probs[0, tokens[0]]
    back = np.zeros((T, S), np.int8)  # 0 = stay, 1 = from s-1, 2 = from s-2

    for t in range(1, T):
        stay = alpha
        adv = np.concatenate([[NEG], alpha[:-1]])
        skip = np.concatenate([[NEG, NEG], alpha[:-2]])
        skip = np.where(can_skip, skip, NEG)
        choice = np.argmax(np.stack([stay, adv, skip]), axis=0).astype(np.int8)
        best = np.maximum(stay, np.maximum(adv, skip))
        back[t] = choice
        alpha = best + log_probs[t, lab]

    # path must end in the last token state or the trailing blank
    s = S - 1 if (S < 2 or alpha[S - 1] >= alpha[S - 2]) else S - 2
    states = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):
        states[t] = s
        s -= back[t, s]

    spans: list[tuple[int, int]] = []
    for i in range(L):
        frames = np.nonzero(states == 2 * i + 1)[0]
        spans.append((int(frames[0]), int(frames[-1]) + 1))
    return spans


# ---------------------------------------------------------------------------
# Text -> token mapping + char-level second spans
# ---------------------------------------------------------------------------

@dataclass
class CharSpan:
    char: str
    start_s: Optional[float]   # None = char not in the acoustic vocab
    end_s: Optional[float]     # (punctuation/space); inherits for edits


def _chars_to_tokens(text: str, vocab: dict) -> tuple[list[int], list[int]]:
    """Lowercased char lookup; returns (token ids, char index per token)."""
    ids, owners = [], []
    for i, ch in enumerate(text):
        tid = vocab.get(ch, vocab.get(ch.lower()))
        if tid is not None:
            ids.append(int(tid))
            owners.append(i)
    return ids, owners


def align_with_logits(
    log_probs: np.ndarray,   # [T, V] log-softmax CTC posteriors
    text: str,
    vocab: dict,             # char -> token id (acoustic model vocab)
    frame_sec: float,        # seconds per logit frame
    blank: int = 0,
) -> list[CharSpan]:
    """Pure alignment core: per-char second spans from CTC posteriors.

    Chars missing from the acoustic vocab (space, punctuation, unromanized
    symbols) get (None, None) and are bridged by `spans_for_edits`.
    """
    ids, owners = _chars_to_tokens(text, vocab)
    if not ids:
        raise ValueError("no character of the text maps into the aligner vocab")
    spans = ctc_viterbi_align(log_probs, ids, blank=blank)
    out = [CharSpan(ch, None, None) for ch in text]
    for (f0, f1), owner in zip(spans, owners):
        out[owner] = CharSpan(text[owner], f0 * frame_sec, f1 * frame_sec)
    return out


def spans_for_edits(
    char_spans: list[CharSpan],
    edits: Sequence[Union[str, tuple]],
    text: Optional[str] = None,
) -> list[tuple[float, float]]:
    """(char_start, char_end) ranges — or substrings, resolved left-to-right —
    to (start_s, end_s) audio spans, bridging vocab-less chars via the
    nearest aligned neighbours inside the range."""
    if text is None:
        text = "".join(c.char for c in char_spans)
    out = []
    cursor = 0
    for e in edits:
        if isinstance(e, str):
            idx = text.find(e, cursor)
            if idx < 0:
                raise ValueError(f"edit substring {e!r} not found after {cursor}")
            lo, hi = idx, idx + len(e)
            cursor = hi
        else:
            lo, hi = e
        starts = [c.start_s for c in char_spans[lo:hi] if c.start_s is not None]
        ends = [c.end_s for c in char_spans[lo:hi] if c.end_s is not None]
        if not starts:
            raise ValueError(
                f"no aligned character inside edit range [{lo}, {hi})")
        out.append((float(min(starts)), float(max(ends))))
    return out


# ---------------------------------------------------------------------------
# Weights-gated acoustic leg (wav2vec2-CTC via transformers)
# ---------------------------------------------------------------------------

_DEFAULT_ALIGNER = "MahmoudAshraf/mms-300m-1130-forced-aligner"
_aligner_cache: dict = {}


def load_alignment_model(model_name: str = _DEFAULT_ALIGNER, device=None):
    """Load a wav2vec2-CTC model + its char vocab from the local files only
    (a directory, or the HuggingFace cache; nothing is downloaded) onto
    `device` (the card unless the caller names one). Gated: raises
    RuntimeError when `transformers` or the weights are missing — callers
    pass explicit second spans instead, never a silent guess."""
    dev = resolve_device(device)
    key = (model_name, dev)
    if key in _aligner_cache:
        return _aligner_cache[key]
    try:
        from transformers import AutoModelForCTC, AutoTokenizer

        model = AutoModelForCTC.from_pretrained(model_name, local_files_only=True)
        model.to(dev).eval()
        tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            f"alignment model {model_name!r} unavailable "
            f"({type(e).__name__}: {e}); pass parts_to_edit seconds explicitly"
        ) from e
    vocab = {k: v for k, v in tok.get_vocab().items() if len(k) == 1}
    blank = tok.pad_token_id if tok.pad_token_id is not None else 0
    _aligner_cache[key] = (model, vocab, blank)
    return model, vocab, blank


def align_text(
    wav: np.ndarray,
    sr: int,
    text: str,
    model_name: str = _DEFAULT_ALIGNER,
    device=None,
) -> list[CharSpan]:
    """Per-char second spans for `text` spoken in `wav` (weights-gated).
    The acoustic model runs on `device` (the card unless the caller names
    one); only its log-probs come back to the host for the DP."""
    dev = resolve_device(device)
    model, vocab, blank = load_alignment_model(model_name, dev)
    wav16 = audio_io.resample(np.asarray(wav, np.float32), sr, 16000)
    with torch.no_grad(), full_f32():
        logits = model(torch.from_numpy(wav16)[None].to(dev)).logits[0]
        log_probs = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
    frame_sec = (len(wav16) / 16000.0) / log_probs.shape[0]
    return align_with_logits(log_probs, text, vocab, frame_sec, blank=blank)
