"""What the row engine of csrc/adaln_norm.cu takes (K1, K6 and K12's modes):
rows of at most MAX_D contiguous bf16 values, 16-byte aligned, lying at up to
three leading strides, at most MAX_ROWS of them."""

from __future__ import annotations

import torch

MAX_D = 4096  # the row engine gives a row at most 32 lanes of 16 16-byte vectors
MAX_ROWS = 2**31 - 2**16  # the row engine counts rows in 32-bit ints


def row_layout(x) -> tuple[int, int, int, int, int, int] | None:
    """(rows, n1, n2, s0, s1, s2): x's leading dimensions merged where their
    strides allow, as at most three (sizes n0 * n1 * n2 = rows, strides in
    elements), or None when more than three remain."""
    dims = []
    for size, stride in zip(x.shape[:-1], x.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > 3:
        return None
    dims = [(1, 0)] * (3 - len(dims)) + dims
    (n0, s0), (n1, s1), (n2, s2) = dims
    return n0 * n1 * n2, n1, n2, s0, s1, s2


def check_rows(x: torch.Tensor, what: str) -> tuple[int, int, int, int, int, int]:
    """Refuse an x the row engine does not take (TypeError for its dtype,
    ValueError for its layout); return `row_layout(x)`."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes a bf16 x")
    d = x.shape[-1]
    if x.dim() < 2 or x.stride(-1) != 1 or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel takes a 16-byte aligned [..., d] x whose last "
                         "dimension is contiguous")
    if d % 8 or d > MAX_D:
        raise ValueError(f"{what} kernel needs d % 8 == 0 and d <= {MAX_D}, got {d}")
    rows = row_layout(x)
    if rows is None or rows[0] > MAX_ROWS or any(s % 8 for s in rows[3:]):
        raise ValueError(f"{what} kernel takes rows 16-byte aligned at up to three leading "
                         f"strides, at most {MAX_ROWS} of them")
    return rows
