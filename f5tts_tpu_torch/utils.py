"""Device choice, masks and ODE time-grid utilities.

Counterparts of f5tts_tpu/utils.py:22-137 (`lens_to_mask`, the training
span masks, the EPSS table, `sway_timesteps`, `make_time_grid`,
`duration_bucket`); the time grid is computed exactly as the JAX package
computes it (float64 table, f32 result).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    one; under torchrun (`LOCAL_RANK` set) this process's card,
    cuda:LOCAL_RANK. Without a card and without an explicit device this
    raises; the port never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local)) if local is not None else torch.device("cuda")


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """[b] lengths -> [b, length] bool mask."""
    seq = torch.arange(length, device=lens.device)
    return seq[None, :] < lens[:, None]


def mask_from_start_end_indices(start: torch.Tensor, end: torch.Tensor, length: int) -> torch.Tensor:
    """[b] start/end -> [b, length] bool mask of the spans [start, end)."""
    seq = torch.arange(length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor,
                           rand: torch.Tensor, length: int) -> torch.Tensor:
    """Random span covering `frac_lengths` (f32 [b]) of each sample's length;
    `rand` ~ U[0, 1) [b] places its start. f32 products truncated to int32,
    as the JAX package computes them."""
    frac_lengths = frac_lengths.float()
    lengths = (frac_lengths * seq_len.float()).to(torch.int32)
    max_start = seq_len.to(torch.int32) - lengths
    start = torch.clamp((max_start.float() * rand.float()).to(torch.int32), min=0)
    return mask_from_start_end_indices(start, start + lengths, length)


# Empirically Pruned Step Sampling: indices into a 32-step uniform grid
# (reference utils.py:205-218; dt = 1/32).
_EPSS_TIMESTEPS: dict[int, list[int]] = {
    5: [0, 2, 4, 8, 16, 32],
    6: [0, 2, 4, 6, 8, 16, 32],
    7: [0, 2, 4, 6, 8, 16, 24, 32],
    10: [0, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32],
    12: [0, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32],
    16: [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32],
}


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """f32 linspace bit-equal to jnp.linspace on the CPU for num <= 513.

    XLA computes start * (1 - i*r) + i * (stop*r) with r = f32(1/div),
    endpoint appended, in f32; its CPU backend unrolls the loop for these
    sizes and contracts i * (stop*r) into an FMA with the rounded
    start * (1 - i*r). At i = 1, where i * (stop*r) folds to stop*r, the
    scalar code of a grid of <= 34 points contracts the other product:
    start * (1 - r) + stop*r, rounded once. Each FMA is evaluated in float64
    (exact at these magnitudes) and rounded to f32.

    This copies XLA's CPU code generation as of jax / jaxlib 0.9.0, not what
    jnp.linspace is defined to compute. The port's grids have at most
    steps + 1 points; tests/test_torch_sampler_options.py holds every num up
    to 65 (64 steps) and a few larger ones bit-equal, so a change in XLA's
    unrolling shows there as a failure."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32)
    f32 = np.float32
    div = num - 1
    r = f32(1.0) / f32(div)
    iota = np.arange(div, dtype=f32)
    s, e = f32(start), f32(stop)
    er = e * r
    one_minus = f32(1.0) - iota * r
    out = iota.astype(np.float64) * np.float64(er) + (s * one_minus).astype(np.float64)
    if 2 <= div <= 33:
        out[1] = np.float64(s) * np.float64(one_minus[1]) + np.float64(er)
    return torch.from_numpy(np.append(out.astype(f32), e))


def get_epss_timesteps(n: int) -> torch.Tensor:
    """EPSS pruned grid for n steps, or uniform linspace if no table entry."""
    idx = _EPSS_TIMESTEPS.get(n)
    if idx is None:
        return linspace_f32(0.0, 1.0, n + 1)
    return torch.from_numpy((np.asarray(idx, dtype=np.float64) / 32.0).astype(np.float32))


def sway_timesteps(t: torch.Tensor, sway_sampling_coef: Optional[float]) -> torch.Tensor:
    """t <- t + s * (cos(pi/2 * t) - 1 + t) (reference cfm.py:215-216), in f32.
    The cosine of the f32 argument is taken in float64 and rounded, which is
    what the JAX package's f32 cosine gives on these grids."""
    if sway_sampling_coef is None:
        return t
    cos = torch.cos((math.pi / 2.0 * t).double()).to(t.dtype)
    return t + sway_sampling_coef * (cos - 1.0 + t)


def make_time_grid(steps: int, sway_sampling_coef: Optional[float] = None,
                   use_epss: bool = True, t_start: float = 0.0) -> torch.Tensor:
    """[steps+1] f32 sampling grid: EPSS (only from t=0) or linspace, + sway."""
    if t_start == 0.0 and use_epss:
        t = get_epss_timesteps(steps)
    else:
        t = linspace_f32(t_start, 1.0, steps + 1)
    return sway_timesteps(t, sway_sampling_coef)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def duration_bucket(n_frames: int, bucket_size: int = 256, max_frames: int = 4096,
                    extra_tokens: int = 0) -> int:
    """Round a frame count up to a bucket boundary, clamped at `max_frames`
    (the JAX package's clamp at 4096 frames, kept as it is)."""
    w = min(max(round_up(n_frames + extra_tokens, bucket_size), bucket_size),
            max_frames + extra_tokens)
    return w - extra_tokens
