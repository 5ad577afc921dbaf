"""The per-rank input pipeline of data-parallel training (counterpart of
f5tts_tpu/train/multihost.py).

The reference trains multi-GPU with Accelerate / DDP, where each rank's
DataLoader serves its own batches. Here, as in the JAX package, every rank
walks the SAME `DynamicBatchSampler` sequence (same frame lengths, same
seed), loads audio only for its rows of each global batch, and pads them to
a width all ranks agree on without seeing each other's mels: the sampler's
frame estimates, rounded up to the 64-frame bucket (`global_pad_width`),
then `collate(pad_to=width)`. Text is cheap, so every rank tokenizes the
whole global batch and keeps its rows, which also fixes the token width.

The JAX `assemble_global` (local rows -> one global device array) has no
counterpart: a rank computes on its local rows, and the gradients are
reduced over the data group (`train.step`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from f5tts_tpu_torch.utils import round_up


def process_local_rows(mesh, n_rows: int) -> slice:
    """This rank's contiguous rows of a global batch of `n_rows` under the
    mesh's data axis (`parallel.mesh.batch_sharding`); all of them without a
    mesh or at data 1."""
    if mesh is None or mesh.data == 1:
        return slice(0, n_rows)
    from f5tts_tpu_torch.parallel.mesh import batch_sharding

    return batch_sharding(mesh, n_rows)


def global_pad_width(frame_len_estimates: Sequence[float], bucket_frames: int = 64,
                     max_frames: Optional[int] = None) -> int:
    """The pad width every rank agrees on, from the sampler's shared frame
    estimates (not the local mels, which other ranks cannot see)."""
    width = round_up(int(math.ceil(max(frame_len_estimates))), bucket_frames)
    if max_frames is not None:
        width = min(width, max_frames)
    return width
