"""The kernels as `torch.library` operators `f5tts::<name>`.

Every inference forward kernel (K1, K2, K3, K5, K6, K7, K10, K11) and the
training attention forwards (K3's, K5's and K7's lse modes) run as an
operator: the models always reach a kernel through it, eagerly, inside a
CUDA graph, and in a `torch.export` program (`compat/export.py`), whose
tracer cannot follow a ctypes call on raw pointers. An operator's
implementation is its wrapper's: a CUDA tensor goes to the kernel or to an
exception, a CPU tensor to the plain version. Each has
- a fake (`register_fake`): the output's shape, dtype and strides without
  running anything, as the kernel writes them (contiguous);
- a FLOP formula (`torch.utils.flop_counter.register_flop_formula`): what
  `FlopCounterMode` counts for the operator's plain version, so a count
  (`scripts/count_params_gflops.py`) is the same on the card and on the
  CPU. `FlopCounterMode` counts matmul and convolution FLOPs only, so the
  norms count 0.
The operators register when their modules are imported;
`f5tts_tpu_torch.ops` imports all of them. They are defined on a
`torch.library.Library` with one implementation for the CPU and the CUDA
dispatch keys, not with `torch.library.custom_op`, whose Python autograd
and device layers and aliasing check cost an eager call several times as
much host time (`scripts/op_call_cost.py` measures both). No autograd
kernel is registered: the training paths reach the operators inside their
`torch.autograd.Function`s, where grad mode is off.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

OPERATORS: dict = {}  # name -> the operator (torch._ops.OpOverload)
IMPLEMENTATIONS: dict = {}  # name -> what the operator runs on CPU and CUDA
_LIB = torch.library.Library("f5tts", "DEF")


def operator(name: str, schema: str, impl: Callable, fake: Callable, flops: Callable):
    """`impl` registered as f5tts::`name` for CPU and CUDA tensors, with
    `fake` and the FLOP formula `flops` (called with the tensor arguments'
    shapes, the other arguments as they are, and `out_shape`)."""
    _LIB.define(name + schema)
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, impl, key)

    def checked_fake(x, *args):
        # a fake tensor reports the device it stands for; a meta tensor
        # reaches here too, and the wrappers refuse every device but two
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {x.device}")
        return fake(x, *args)

    torch.library.register_fake(f"f5tts::{name}", checked_fake, lib=_LIB)
    register_flop_formula(getattr(torch.ops.f5tts, name))(flops)
    OPERATORS[name] = op = getattr(torch.ops.f5tts, name).default
    IMPLEMENTATIONS[name] = impl
    return op


def no_flops(*args, out_shape=None, **kwargs) -> int:
    """Elementwise and reduction work: `FlopCounterMode` counts none."""
    return 0


def attention_flops(b: int, heads: int, n: int, d: int) -> int:
    """QK^T and PV over every row and key: 2 * 2 * b * h * n^2 * d, as
    `FlopCounterMode` counts the plain versions' two batched matmuls."""
    return 4 * b * heads * n * n * d


def conv_flops(x_shape, w_shape) -> int:
    """One same-padded grouped conv1d of x [b, n, c] with WIO w [k, c / g,
    c], as `FlopCounterMode` counts `F.conv1d`: 2 * b * n * c * (c / g) * k."""
    b, n, c = x_shape
    k, width, _ = w_shape
    return 2 * b * n * c * width * k


def contiguous_like(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """A contiguous empty tensor of x's shape (the kernels' output layout)."""
    return x.new_empty(x.shape, dtype=dtype or x.dtype)
