"""Rotary position tables and rotations (counterpart of
f5tts_tpu/ops/rope.py:23-153).

Attention RoPE rotates INTERLEAVED pairs: out[2i] = x[2i]c - x[2i+1]s,
out[2i+1] = x[2i+1]c + x[2i]s (x_transformers semantics, not rotate-half
over two halves). The text position table is concat(cos | sin) halves.
Tables are built in float64 numpy and cast, as the JAX package builds them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rope_freqs_interleaved(dim_head: int, end: int, theta: float = 10000.0) -> torch.Tensor:
    """[end, dim_head] f32 angle table, each frequency repeated for its pair."""
    freqs = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    angles = np.outer(np.arange(end, dtype=np.float64), freqs)
    return torch.from_numpy(np.repeat(angles, 2, axis=-1).astype(np.float32))


def _rotate_pairs(xf: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...) over the last dim."""
    pairs = xf.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate [..., n, d] by the angle table's first n rows [n, d] in f32,
    cast back to x's dtype (the head layout [b, h, n, d])."""
    ang = angles[:x.shape[-2]].float()
    xf = x.float()
    return (xf * torch.cos(ang) + _rotate_pairs(xf) * torch.sin(ang)).to(x.dtype)


def apply_rotary_partial_heads(x: torch.Tensor, angles: torch.Tensor,
                               pe_attn_head: Optional[int]) -> torch.Tensor:
    """`apply_rotary` on the first `pe_attn_head` heads of [b, h, n, d] only
    (all heads when None)."""
    if pe_attn_head is None:
        return apply_rotary(x, angles)
    return torch.cat([apply_rotary(x[:, :pe_attn_head], angles), x[:, pe_attn_head:]], dim=1)


def rope_flat_tables(angles: torch.Tensor, n: int, heads: int,
                     pe_attn_head: Optional[int] = None,
                     dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [n, heads*d] for the flat layout, tiled per head;
    unrotated heads (`pe_attn_head`) get cos=1, sin=0."""
    d = angles.shape[-1]
    ang = angles[:n].float()
    cos = torch.cos(ang).repeat(1, heads)
    sin = torch.sin(ang).repeat(1, heads)
    if pe_attn_head is not None:
        rotated = torch.arange(heads * d, device=ang.device) < pe_attn_head * d
        cos = torch.where(rotated, cos, torch.ones_like(cos))
        sin = torch.where(rotated, sin, torch.zeros_like(sin))
    return cos.to(dtype), sin.to(dtype)


def apply_rotary_flat_tables(x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor) -> torch.Tensor:
    """RoPE on [b, n, h*d] from flat tables, in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * cos.float() + _rotate_pairs(xf) * sin.float()).to(x.dtype)


def apply_rotary_flat(x: torch.Tensor, angles: torch.Tensor, heads: int,
                      pe_attn_head: Optional[int] = None) -> torch.Tensor:
    """RoPE on the flat [b, n, h*d] layout before the head split."""
    n = x.shape[1]
    cos, sin = rope_flat_tables(angles.to(x.device), n, heads, pe_attn_head,
                                dtype=torch.float32)
    return apply_rotary_flat_tables(x, cos, sin)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0,
                         theta_rescale_factor: float = 1.0) -> torch.Tensor:
    """[end, dim] f32 table = concat(cos(f*t) | sin(f*t)) (reference
    modules.py:207-218, with the NTK rescale)."""
    theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(end, dtype=np.float64), freqs)
    table = np.concatenate([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(table.astype(np.float32))
