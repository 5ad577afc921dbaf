"""Full f32 for the port's f32 modules, whatever the caller's TF32 flags.

torch leaves `torch.backends.cudnn.allow_tf32` True by default, so an f32
convolution on the card runs in TF32 (10 mantissa bits) unless someone
turns it off; `torch.backends.cuda.matmul.allow_tf32` does the same for
f32 matmuls when a caller turns it on. The port's f32 modules are held to
f32 references: the vocoders (`vocoder/vocos.py`, `vocoder/bigvgan.py`),
the evaluation models (`eval/wavlm.py`, `eval/ecapa_tdnn.py`,
`eval/utmos22.py`), the CTC aligner (`infer/align.py`) and the mel front
end (`ops/mel.py`). Each runs under `full_f32()`: both flags False while it
runs, the caller's values restored after. So does every CUDA-graph capture
of the pipeline (`infer/pipeline.py`), which holds the vocoder.

The flags are process-global, and the serving threads call these modules
from more than one thread (`DynamicBatcher`'s dispatch and finalizer, a
fine-bucket capture). `full_f32` therefore holds one re-entrant process
lock while its block runs: no thread restores the flags while another is
inside, and a thread may nest it. Nothing inside a block takes another
lock, so the lock cannot deadlock against the pipeline's `device_lock`.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_lock = threading.RLock()


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS matmuls in full f32 (TF32 off) while the
    block runs; the caller's flags restored after."""
    with _lock:
        cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cuda.matmul.allow_tf32 = matmul


def f32_call(fn):
    """`fn` run under `full_f32()`."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)
    return run
