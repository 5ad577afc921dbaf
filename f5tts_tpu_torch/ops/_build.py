"""Build and load the hand-written CUDA kernels (route (b): nvcc + ctypes).

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, into `<checkout>/build/f5tts_tpu_torch/<name>-<hash>.so` at first
use, and loaded with `ctypes`. The file name carries the hash of the source,
the headers in `csrc/` and the flags, so a changed source is rebuilt. Each C
entry point takes plain pointers (`c_void_p`), ints and the CUDA stream, and
returns `cudaGetLastError()`; `check()` raises when that is not 0.

Launch counts: each kernel wrapper calls `count(name)` where it launches its
kernel and nowhere else, so a run can show which kernels it went through.
Inside `capture_counts()` (a CUDA-graph capture) a call records a launch the
graph will make: it goes to that capture's counts, not to the host counter,
and a replay of the graph makes no host call and adds nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "f5tts_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
LAUNCHES: dict[str, int] = {}
_capture: dict[str, int] | None = None  # the counts of the capture in progress


def count(name: str) -> None:
    target = LAUNCHES if _capture is None else _capture
    target[name] = target.get(name, 0) + 1


@contextlib.contextmanager
def capture_counts():
    """Counts the launches recorded while the block runs (a CUDA-graph
    capture) into the dict it yields, instead of the host counter."""
    global _capture
    _capture = counts = {}
    try:
        yield counts
    finally:
        _capture = None


def reset_launches() -> None:
    LAUNCHES.clear()


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every out-of-date source in parallel; return {name: .so path}.

    With `verbose`, nvcc's `-Xptxas -v` report (registers, shared memory,
    spills) is collected and returned under the key "<name>.ptxas"."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    out: dict[str, str] = {}
    for src in _sources():
        so = _target(src)
        out[src.stem] = str(so)
        if so.exists() and not verbose:
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, so)
    failed = []
    for name, (p, tmp, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, so)
        if verbose:
            out[f"{name}.ptxas"] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all kernels first if
    any library is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for stem, path in paths.items():
                if stem not in _libs:
                    _libs[stem] = ctypes.CDLL(path)
            lib = _libs[name]
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
