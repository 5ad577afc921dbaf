"""Chinese G2P: text -> pinyin tokens with word segmentation (counterpart of
f5tts_tpu/text/pinyin.py, the names and behaviour kept).

- custom punctuation translation (; -> , and CJK quote normalisation);
- word segmentation: python `jieba` if it imports, else one character at a
  time. (The JAX package tries its native C++ copy of jieba first; it cuts
  exactly as jieba does and needs jieba's dictionary, so it is no other
  result.) `segmenter_name()` says which one runs;
- three branches per segment: pure ASCII (a space between words), pure CJK
  (pinyin per char, a space before each), mixed (char by char);
- pinyin style TONE3 with tone sandhi.

G2P backends, in order: `pypinyin` if it imports (`lazy_pinyin`, TONE3,
tone_sandhi=True); else the bundled tables (text/data/pinyin_char_tone3.tsv,
3000 chars; pinyin_words_tone3.tsv, the heteronym and neutral-suffix words)
with a greedy longest match over the word table and rule-based 不 / 一 /
third-tone sandhi, a user TSV (`set_pinyin_dict(path)` or
$F5TTS_PINYIN_DICT) overriding bundled chars; else the text passes through.
Neutral tone is the bare syllable ("de", not "de5"); u-umlaut is "v".
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Iterable, Optional

_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

_pinyin_dict: Optional[dict[str, str]] = None
_pinyin_words: Optional[dict[str, list[str]]] = None
_pinyin_words_max: Optional[int] = None


def is_chinese(c: str) -> bool:
    # the reference's common Chinese character range
    return "㄀" <= c <= "鿿"


def _read_tsv(path: str, into: dict, split: bool = False) -> None:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                into[parts[0]] = parts[1].split(" ") if split else parts[1]


def set_pinyin_dict(path: str) -> None:
    """Overlay a user char<TAB>pinyin(TONE3) TSV over the bundled table."""
    global _pinyin_dict
    _pinyin_dict = None
    _ensure_dict()
    _read_tsv(path, _pinyin_dict)


@lru_cache(maxsize=1)
def _pypinyin():
    try:
        from pypinyin import Style, lazy_pinyin
    except ImportError:
        return None
    return lazy_pinyin, Style


def _ensure_dict():
    global _pinyin_dict, _pinyin_words
    if _pinyin_dict is None:
        d: dict[str, str] = {}
        bundled = os.path.join(_DATA_DIR, "pinyin_char_tone3.tsv")
        if os.path.exists(bundled):
            _read_tsv(bundled, d)
        path = os.environ.get("F5TTS_PINYIN_DICT")
        if path and os.path.exists(path):
            _read_tsv(path, d)  # user entries override bundled ones
        _pinyin_dict = d
    if _pinyin_words is None:
        w: dict[str, list[str]] = {}
        bundled = os.path.join(_DATA_DIR, "pinyin_words_tone3.tsv")
        if os.path.exists(bundled):
            _read_tsv(bundled, w, split=True)
        _pinyin_words = w


def _pinyin_words_maxlen() -> int:
    global _pinyin_words_max
    if _pinyin_words_max is None:
        _pinyin_words_max = max((len(w) for w in _pinyin_words), default=1)
    return _pinyin_words_max


def _tone(r: str) -> int:
    """Trailing tone digit; neutral (bare syllable or raw char) counts as 5."""
    return int(r[-1]) if r and r[-1].isdigit() else 5


def _set_tone(r: str, t: int) -> str:
    return (r[:-1] if r and r[-1].isdigit() else r) + str(t)


def _apply_sandhi(chars: str, readings: list[str]) -> list[str]:
    """不 / 一 / third-tone sandhi within one word segment (pypinyin's
    tone_sandhi=True, per segment as the reference calls lazy_pinyin per
    word)."""
    n = len(chars)
    out = list(readings)
    for i, c in enumerate(chars):
        if c == "不":
            if i + 1 < n and _tone(out[i + 1]) == 4:
                out[i] = "bu2"
        elif c == "一":
            if 0 < i < n - 1 and chars[i - 1] == chars[i + 1]:
                out[i] = "yi"  # reduplication (看一看) -> neutral
            elif i > 0 and chars[i - 1] == "第":
                pass  # ordinal 第一 keeps yi1
            elif i + 1 < n:
                t = _tone(out[i + 1])
                if t == 4:
                    out[i] = "yi2"
                elif t in (1, 2, 3):
                    out[i] = "yi4"
    for i in range(n - 2, -1, -1):  # 3-3 -> 2-3, right to left
        if _tone(out[i]) == 3 and _tone(out[i + 1]) == 3:
            out[i] = _set_tone(out[i], 2)
    return out


def g2p(segment: str) -> list[str]:
    """Chinese string -> list of TONE3 pinyin syllables (one per char)."""
    pp = _pypinyin()
    if pp is not None:
        lazy_pinyin, Style = pp
        return lazy_pinyin(segment, style=Style.TONE3, tone_sandhi=True)
    _ensure_dict()
    if not _pinyin_dict:
        return list(segment)  # passthrough: no G2P backend available
    # greedy longest match over the word table (a compound like 处理结果
    # splits into 处理 + per-char readings), then per-char defaults
    readings: list[str] = []
    i, n = 0, len(segment)
    max_w = _pinyin_words_maxlen()
    while i < n:
        for ln in range(min(max_w, n - i), 1, -1):
            w = segment[i:i + ln]
            if w in _pinyin_words:
                readings.extend(_pinyin_words[w])
                i += ln
                break
        else:
            readings.append(_pinyin_dict.get(segment[i], segment[i]))
            i += 1
    return _apply_sandhi(segment, readings)


@lru_cache(maxsize=1)
def _segmenter():
    """(name, cut): python jieba if it imports, else one char at a time."""
    try:
        import jieba
    except ImportError:
        return "per-char", list
    jieba.setLogLevel(60)
    return "jieba", lambda s: list(jieba.cut(s))


def segmenter_name() -> str:
    return _segmenter()[0]


def segment(text: str) -> Iterable[str]:
    return _segmenter()[1](text)


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    """The reference's convert_char_to_pinyin: per-text token lists."""
    final: list[list[str]] = []
    for text in text_list:
        char_list: list[str] = []
        text = text.translate(_CUSTOM_TRANS)
        for seg in segment(text):
            seg_byte_len = len(bytes(seg, "utf-8"))
            if seg_byte_len == len(seg):  # pure ascii
                if char_list and seg_byte_len > 1 and char_list[-1] not in " :'\"":
                    char_list.append(" ")
                char_list.extend(seg)
            elif polyphone and seg_byte_len == 3 * len(seg):  # pure CJK
                seg_pinyin = g2p(seg)
                for i, c in enumerate(seg):
                    if is_chinese(c):
                        char_list.append(" ")
                    char_list.append(seg_pinyin[i])
            else:  # mixed
                for c in seg:
                    if ord(c) < 256:
                        char_list.extend(c)
                    elif is_chinese(c):
                        char_list.append(" ")
                        char_list.extend(g2p(c))
                    else:
                        char_list.append(c)
        final.append(char_list)
    return final
