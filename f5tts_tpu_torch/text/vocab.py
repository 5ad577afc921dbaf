"""Text -> id tokenization (counterpart of f5tts_tpu/text/vocab.py).

- list_str_to_idx: per-char lookup in a vocab map, unknown -> 0, -1 padded.
- list_str_to_tensor: UTF-8 byte tokenization (ByT5 style), -1 padded.
The pinyin tokenizer needs `pypinyin` and is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _pad_rows(rows: list[list[int]], padding_value: int, pad_to: Optional[int]) -> np.ndarray:
    width = max((len(r) for r in rows), default=0)
    if pad_to is not None:
        width = max(width, pad_to)
    out = np.full((len(rows), width), padding_value, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def list_str_to_idx(texts: Sequence, vocab_char_map: dict[str, int],
                    padding_value: int = -1, pad_to: Optional[int] = None) -> np.ndarray:
    """[b] strings (or token lists) -> [b, nt] int32 ids."""
    return _pad_rows([[vocab_char_map.get(c, 0) for c in t] for t in texts],
                     padding_value, pad_to)


def list_str_to_tensor(texts: Sequence[str], padding_value: int = -1,
                       pad_to: Optional[int] = None) -> np.ndarray:
    """[b] strings -> [b, nt] int32 UTF-8 bytes."""
    return _pad_rows([list(bytes(t, "utf-8")) for t in texts], padding_value, pad_to)
