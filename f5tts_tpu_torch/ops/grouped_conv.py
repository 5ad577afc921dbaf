"""Grouped conv1d and ConvPositionEmbedding (counterparts of
f5tts_tpu/ops/grouped_conv.py:27-121 and :168-297).

ConvPositionEmbedding, the whole module: zero rows >= length -> grouped
conv1d (same padding) + bias -> mask -> Mish -> the same again. For 64
channels a group and k = 31 (`supports_fused_conv_pos`, the dim-1024 presets)
`conv_pos_embedding` launches the hand-written kernel K2
(csrc/grouped_conv.cu, replacing the Pallas `_cpe_kernel`) for CUDA tensors,
twice per call with the intermediate rounded to bf16 as the Pallas kernel
rounds it, and runs the plain version `conv_pos_embedding_ref` (the
`_xla_conv_pos` semantics) for CPU tensors only. Every other width (the
dim-768 presets: 16 groups of 48 channels) takes the unfused chain in
`models/modules.py`, whose convs are `grouped_conv1d`: kernel K10 (the same
file, replacing the Pallas `_grouped_conv_kernel` and its bias add) for CUDA
tensors, `grouped_conv1d_ref` for CPU tensors. K10 takes W = c / groups
channels a group with W % 8 == 0 and W <= 128, 1 <= k <= 31, any n (a
persistent wgmma pipeline: the group's taps resident in shared memory where
they fit, else a ring of tap chunks). K2 is that pipeline's LENGTH + MISH
mode: the input rows past the length zero-filled as they are copied, only
the live row tiles walked (the dead ones stored as zeros), and the
epilogue's bias, mask and Mish in f32 with one rounding.

Weights keep the JAX package's WIO layout: w [k, c // groups, c].

Both are differentiable (`torch.autograd.Function`). The JAX package has no
backward kernel for either: its custom_vjps take the VJP of the XLA formulas
`_xla_conv_pos` (f5tts_tpu/ops/grouped_conv.py:253-283) and
`_xla_grouped_conv` (:83-108), which convolve in x's dtype.
`conv_pos_embedding_bwd` and `grouped_conv1d_bwd` are those VJPs in PyTorch
ops (autograd through the same formulas), so a PyTorch backward is the
faithful port here, not a fallback; the forwards on the card stay the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops import _build

GROUP_WIDTH = 64  # channels per group K2 takes
MAX_K = 31
MAX_WIDTH = 128   # channels per group K10 takes, a multiple of 8


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in f32, softplus as jax.nn.softplus computes it."""
    xf = x.float()
    sp = torch.clamp(xf, min=0.0) + torch.log1p(torch.exp(-xf.abs()))
    return (xf * torch.tanh(sp)).to(x.dtype)


def grouped_conv1d_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       groups: int, dtype=torch.float32) -> torch.Tensor:
    """Same-padded grouped conv of x [b, n, c] with WIO w [k, c/g, c], in
    `dtype` (lead padding (k - 1) // 2, the rest trailing)."""
    k = w.shape[0]
    lead = (k - 1) // 2
    xt = F.pad(x.to(dtype).transpose(1, 2), (lead, k - 1 - lead))
    y = F.conv1d(xt, w.to(dtype).permute(2, 1, 0), groups=groups)
    return y.transpose(1, 2) + bias.to(dtype)


def conv_pos_embedding_ref(x, w1, b1, w2, b2, lengths, groups: int) -> torch.Tensor:
    """Plain version. Sums in f32; the intermediate and the output are
    rounded to x's dtype, as `_xla_conv_pos` and the Pallas kernel do."""
    n = x.shape[1]
    valid = (torch.arange(n, device=x.device)[None, :] < lengths[:, None])[..., None]
    h = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
    h = grouped_conv1d_ref(h, w1, b1, groups)
    h = mish(torch.where(valid, h, 0.0)).to(x.dtype)
    h = grouped_conv1d_ref(h, w2, b2, groups)
    return mish(torch.where(valid, h, 0.0)).to(x.dtype)


def conv_pos_embedding_xla(x, w1, b1, w2, b2, lengths, groups: int) -> torch.Tensor:
    """`_xla_conv_pos` as the JAX package writes it: each conv in x's dtype
    (the bias added in that dtype), Mish in f32, cast back."""
    n = x.shape[1]
    valid = (torch.arange(n, device=x.device)[None, :] < lengths[:, None])[..., None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    h = grouped_conv1d_ref(torch.where(valid, x, zero), w1, b1, groups, x.dtype)
    h = mish(torch.where(valid, h, zero))
    h = grouped_conv1d_ref(h, w2, b2, groups, x.dtype)
    return mish(torch.where(valid, h, zero))


def conv_pos_embedding_bwd(x, w1, b1, w2, b2, lengths, groups: int, dy):
    """(dx, dw1, db1, dw2, db2) of `conv_pos_embedding_xla` for dy."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
        y = conv_pos_embedding_xla(*xs, lengths, groups)
        return torch.autograd.grad(y, xs, dy)


class _ConvPosEmbedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, lengths, groups):
        ctx.save_for_backward(x, w1, b1, w2, b2, lengths)
        ctx.groups = groups
        return _forward(x, w1, b1, w2, b2, lengths, groups)

    @staticmethod
    def backward(ctx, dy):
        *xs, lengths = ctx.saved_tensors
        return (*conv_pos_embedding_bwd(*xs, lengths, ctx.groups, dy), None, None)


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.load("grouped_conv")
    fn = lib.f5_conv_mish_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, ws, bs, lengths, groups):
    if x.dim() != 3 or not x.is_contiguous() or x.dtype != torch.bfloat16:
        raise ValueError("conv_pos_embedding kernel takes a contiguous bf16 [b, n, c] x")
    b, _, c = x.shape
    if c % groups or c // groups != GROUP_WIDTH:
        raise ValueError(f"conv_pos_embedding kernel needs {GROUP_WIDTH} channels a group")
    if x.data_ptr() % 16:
        raise ValueError("conv_pos_embedding kernel needs a 16-byte aligned x")
    for w, bias in zip(ws, bs):
        k = w.shape[0]
        if (w.shape != (k, GROUP_WIDTH, c) or k > MAX_K or k % 2 == 0
                or not w.is_contiguous() or w.dtype != torch.bfloat16 or w.data_ptr() % 16):
            raise ValueError("conv_pos_embedding kernel takes contiguous, 16-byte aligned bf16 "
                             f"WIO weights [k <= {MAX_K} odd, {GROUP_WIDTH}, c]")
        if bias.shape != (c,) or not bias.is_contiguous() or bias.dtype != torch.bfloat16:
            raise ValueError("conv_pos_embedding kernel takes a contiguous bf16 [c] bias")
        if w.device != x.device or bias.device != x.device:
            raise ValueError("conv_pos_embedding: weights must be on x's device")
    if (lengths.shape != (b,) or lengths.dtype != torch.int32 or lengths.device != x.device
            or not lengths.is_contiguous()):
        raise ValueError("conv_pos_embedding kernel takes int32 [b] lengths on x's device")


def conv_pos_embedding(x, w1, b1, w2, b2, lengths, groups: int = 16) -> torch.Tensor:
    """x [b, n, c], w [k, c/groups, c] WIO, b [c], lengths [b] int32.
    Kernel K2 on CUDA, plain on the CPU; differentiable (`conv_pos_embedding_bwd`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _ConvPosEmbedding.apply(x, w1, b1, w2, b2, lengths, groups)
    return _forward(x, w1, b1, w2, b2, lengths, groups)


def _forward(x, w1, b1, w2, b2, lengths, groups):
    if x.device.type == "cpu":
        return conv_pos_embedding_ref(x, w1, b1, w2, b2, lengths, groups)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pos_embedding: unsupported device {x.device}")
    _check(x, (w1, w2), (b1, b2), lengths, groups)
    b, n, c = x.shape
    fn = _fn()
    stream = _build.stream_ptr(x.device)
    h = torch.empty_like(x)
    y = torch.empty_like(x)
    for src, w, bias, dst in ((x, w1, b1, h), (h, w2, b2, y)):
        err = fn(_build.ptr(src), _build.ptr(w), _build.ptr(bias), _build.ptr(lengths),
                 _build.ptr(dst), b, n, c, w.shape[0], stream)
        _build.check(err, "conv_pos_embedding")
    _build.count("conv_pos_embedding")
    return y


def supports_fused_conv_pos(c: int, groups: int, k: int) -> bool:
    """The shapes K2 (the fused conv-position kernel) serves: 64 channels a
    group and k = 31, as the JAX gate (grouped_conv.py:289-297) without its
    backend test."""
    return c % groups == 0 and c // groups == GROUP_WIDTH and k == MAX_K


# ---------------------------------------------------------------------------
# K10: generic grouped conv1d + bias
# ---------------------------------------------------------------------------

def grouped_conv1d_bwd(x, w, bias, groups: int, dy):
    """(dx, dw, dbias) of the plain formula in x's dtype (`_xla_grouped_conv`)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (x, w, bias)]
        y = grouped_conv1d_ref(*xs, groups, x.dtype)
        return torch.autograd.grad(y, xs, dy)


class _GroupedConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, groups):
        ctx.save_for_backward(x, w, bias)
        ctx.groups = groups
        return _gc_forward(x, w, bias, groups)

    @staticmethod
    def backward(ctx, dy):
        return (*grouped_conv1d_bwd(*ctx.saved_tensors, ctx.groups, dy), None)


@functools.lru_cache(maxsize=None)
def _gc_fn():
    fn = _build.load("grouped_conv").f5_grouped_conv1d_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gc_check(x, w, bias, groups):
    if (x.dim() != 3 or not x.is_contiguous() or x.dtype != torch.bfloat16
            or x.data_ptr() % 16):
        raise ValueError("grouped_conv1d kernel takes a contiguous, 16-byte aligned bf16 "
                         "[b, n, c] x")
    c = x.shape[2]
    width = c // groups if groups > 0 and c % groups == 0 else 0
    if width == 0 or width % 8 or width > MAX_WIDTH:
        raise ValueError(f"grouped_conv1d kernel needs c / groups a multiple of 8 and <= "
                         f"{MAX_WIDTH}: c {c}, groups {groups}")
    k = w.shape[0]
    if (w.shape != (k, width, c) or not 1 <= k <= MAX_K or not w.is_contiguous()
            or w.dtype != torch.bfloat16 or w.data_ptr() % 16):
        raise ValueError(f"grouped_conv1d kernel takes contiguous, 16-byte aligned bf16 WIO "
                         f"weights [1 <= k <= {MAX_K}, c / groups, c]")
    if bias.shape != (c,) or not bias.is_contiguous() or bias.dtype != torch.bfloat16:
        raise ValueError("grouped_conv1d kernel takes a contiguous bf16 [c] bias")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("grouped_conv1d: weights must be on x's device")


def grouped_conv1d(x, w, bias, groups: int) -> torch.Tensor:
    """Same-padded grouped conv of x [b, n, c] with WIO w [k, c/groups, c] +
    bias [c], f32 sums, the result in x's dtype. Kernel K10 on CUDA,
    `grouped_conv1d_ref` on the CPU; differentiable (`grouped_conv1d_bwd`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, bias)):
        return _GroupedConv1d.apply(x, w, bias, groups)
    return _gc_forward(x, w, bias, groups)


def _gc_forward(x, w, bias, groups):
    if x.device.type == "cpu":
        return grouped_conv1d_ref(x, w, bias, groups).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_conv1d: unsupported device {x.device}")
    _gc_check(x, w, bias, groups)
    b, n, c = x.shape
    y = torch.empty_like(x)
    err = _gc_fn()(_build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(y), b, n, c,
                   c // groups, w.shape[0], _build.stream_ptr(x.device))
    _build.check(err, "grouped_conv1d")
    _build.count("grouped_conv1d")
    return y
