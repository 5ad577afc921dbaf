"""ctypes bindings for the native C++ segmenter (counterpart of
f5tts_tpu/native/segmenter.py; `segmenter.cc` is the JAX package's source
with its cut made to follow `jieba.cut` step for step).

jieba's algorithm (a prefix-dictionary DAG, the most probable path, and a
BMES HMM over out-of-vocabulary runs) in C++, with its own copies of
jieba 0.42.1's data (MIT; `data/JIEBA_LICENSE.txt`), since the card's
machine has no jieba:
- `data/jieba_dict.txt.gz`: jieba's `dict.txt`, byte for byte;
- `data/jieba_hmm.tsv.gz`: `jieba.finalseg`'s start / transition /
  emission log probabilities as the TSV `segmenter.cc` loads.
At first use the source is built with `g++ -O2 -shared -fPIC -std=c++17`
and the data decompressed, both into `build/f5tts_tpu_torch/` of the
checkout under names that carry a hash of what they come from, never
beside the source; nothing is downloaded, and the CUDA build is not
involved. `F5TTS_SEGMENTER_DICT` names another dictionary. A failure
raises ImportError, so `text.pinyin` can fall back to python jieba.
`write_data_files` writes the two data files from an installed jieba.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "segmenter.cc"
DATA_DIR = _HERE.parent / "data"
DICT_GZ = DATA_DIR / "jieba_dict.txt.gz"
HMM_GZ = DATA_DIR / "jieba_hmm.tsv.gz"
BUILD_DIR = _HERE.parent.parent / "build" / "f5tts_tpu_torch"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_BUF_CAP = 1 << 20
_lock = threading.Lock()
_lib = None


def _hashed(stem: str, suffix: str, *parts: bytes) -> Path:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build() -> str:
    """The shared library, compiled when no build of this source exists."""
    so = _hashed("libsegmenter", ".so", " ".join(GXX_FLAGS).encode(), SRC.read_bytes())
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return str(so)


def _unpacked(gz: Path, stem: str, suffix: str) -> Path:
    """`gz` decompressed into the build directory (once per content)."""
    packed = gz.read_bytes()
    path = _hashed(stem, suffix, packed)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _write_atomic(path, gzip.decompress(packed))
    return path


def dict_path() -> str:
    """`F5TTS_SEGMENTER_DICT` if it names a file, else the bundled jieba
    dictionary, decompressed."""
    path = os.environ.get("F5TTS_SEGMENTER_DICT")
    if path and os.path.exists(path):
        return path
    return str(_unpacked(DICT_GZ, "jieba_dict", ".txt"))


def hmm_path() -> str:
    return str(_unpacked(HMM_GZ, "jieba_hmm", ".tsv"))


def load():
    """The loaded library, built and given its data at the first call
    (ImportError when it cannot be)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build())
            dict_file, hmm_file = dict_path(), hmm_path()
        except (OSError, subprocess.CalledProcessError) as e:
            raise ImportError(f"the native segmenter cannot be built or loaded: {e}") from e
        lib.seg_load_dict.argtypes = [ctypes.c_char_p]
        lib.seg_load_dict.restype = ctypes.c_int
        lib.seg_load_hmm.argtypes = [ctypes.c_char_p]
        lib.seg_load_hmm.restype = ctypes.c_int
        lib.seg_cut.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.seg_cut.restype = ctypes.c_int
        if lib.seg_load_dict(dict_file.encode()) <= 0:
            raise ImportError(f"the native segmenter failed to load {dict_file}")
        if lib.seg_load_hmm(hmm_file.encode()) <= 0:
            raise ImportError(f"the native segmenter failed to load {hmm_file}")
        _lib = lib
        return lib


def cut(text: str) -> list[str]:
    """jieba's default cut (`jieba.cut(text, HMM=True)`) of `text`."""
    lib = load()
    buf = ctypes.create_string_buffer(_BUF_CAP)
    n = lib.seg_cut(text.encode("utf-8"), buf, _BUF_CAP)
    if n < 0:
        raise RuntimeError("segmenter error (buffer overflow or no dict)")
    if n == 0:
        return []
    return buf.value.decode("utf-8").split("\x01")


def hmm_table() -> str:
    """jieba.finalseg's BMES tables as the TSV `segmenter.cc` loads ("S
    <state> <logp>", "T <from> <to> <logp>", "E <state> <char> <logp>";
    emissions of whitespace characters left out), written as the JAX
    package's `_export_hmm` writes it. Needs jieba."""
    from jieba.finalseg import prob_emit, prob_start, prob_trans

    lines = [f"S {s} {p!r}\n" for s, p in prob_start.P.items()]
    lines += [f"T {a} {b} {p!r}\n" for a, row in prob_trans.P.items() for b, p in row.items()]
    lines += [f"E {s} {ch} {p!r}\n" for s, row in prob_emit.P.items()
              for ch, p in row.items() if ch.strip()]
    return "".join(lines)


def write_data_files(out_dir: Path = DATA_DIR) -> None:
    """Write `jieba_dict.txt.gz` and `jieba_hmm.tsv.gz` from the installed
    jieba (gzip level 9, no timestamp, so the files are reproducible)."""
    import jieba

    dict_txt = (Path(jieba.__file__).parent / "dict.txt").read_bytes()
    out_dir = Path(out_dir)
    (out_dir / DICT_GZ.name).write_bytes(gzip.compress(dict_txt, 9, mtime=0))
    (out_dir / HMM_GZ.name).write_bytes(gzip.compress(hmm_table().encode("utf-8"), 9, mtime=0))


if __name__ == "__main__":
    write_data_files()
