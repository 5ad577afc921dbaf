"""Vocab loading and text -> id tokenization (counterpart of
f5tts_tpu/text/vocab.py).

- load_vocab / get_tokenizer: one token per line, index = line number,
  space at index 0 (0 doubles as the unknown-token fallback).
- list_str_to_idx: per-char (or per-pinyin-token) lookup in a vocab map,
  unknown -> 0, -1 padded.
- list_str_to_tensor: UTF-8 byte tokenization (ByT5 style), -1 padded.
The pinyin tokenizer converts text with `text.pinyin.convert_char_to_pinyin`
first; the Emilia pinyin vocab ships as `data/vocab_emilia_pinyin.txt`
(`EMILIA_VOCAB`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

EMILIA_VOCAB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                            "vocab_emilia_pinyin.txt")


def load_vocab(path: str) -> dict[str, int]:
    vocab: dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line[:-1]] = i  # strip only the trailing newline; " " stays " "
    return vocab


def get_tokenizer(dataset_or_path: str, tokenizer: str = "pinyin",
                  data_root: Optional[str] = None):
    """Returns (vocab_char_map | None, vocab_size).

    - "pinyin" / "char": loads data/<name>_<tokenizer>/vocab.txt under
      data_root (default $F5TTS_DATA_ROOT, else "data")
    - "byte": utf-8 bytes, vocab 256
    - "custom": dataset_or_path is a direct path to vocab.txt
    """
    if tokenizer in ("pinyin", "char"):
        root = data_root or os.environ.get("F5TTS_DATA_ROOT", "data")
        vocab = load_vocab(os.path.join(root, f"{dataset_or_path}_{tokenizer}", "vocab.txt"))
        if vocab.get(" ") != 0:
            raise ValueError("space must be idx 0 in vocab.txt (0 = unknown)")
        return vocab, len(vocab)
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab = load_vocab(dataset_or_path)
        return vocab, len(vocab)
    raise ValueError(f"unknown tokenizer: {tokenizer}")


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
