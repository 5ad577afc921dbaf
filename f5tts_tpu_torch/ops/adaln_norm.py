"""AdaLN-modulated LayerNorm, y = LN(x) * (1 + scale[b]) + shift[b], and
RMSNorm, y = x * rsqrt(mean(x^2) + eps) * w.

Counterpart of f5tts_tpu/ops/adaln_norm.py. `adaln_norm` launches the
hand-written kernel K1 (csrc/adaln_norm.cu, replacing the Pallas
`_adaln_norm_kernel`) for CUDA tensors and runs the plain version
`adaln_norm_ref` for CPU tensors only. The DiT runs it 2 * depth + 1 times
per ODE step. `rms_norm` launches K6 (the same file, replacing the Pallas
`_rms_norm_kernel`) for CUDA tensors and `rms_norm_ref` for CPU tensors: the
UNetT runs it 2 * depth + 1 times per ODE step, qk-norm on q and k of every
attention. K1 and K6 are two epilogues of one row engine. K6 reads x in
place where its last dimension is contiguous and its rows lie at up to
three leading strides (qk-norm's head view of a projection) and writes a
contiguous result. The JAX package keeps its kernel behind a switch that
is off by default, because XLA fuses the RMS passes on a TPU; eager
PyTorch does not, so the port always runs K6.

`adaln_norm_quant` and `rms_norm_quant` hand the int8 projections of a
block their input quantized: the row engine's quantize stage (K1Q, K6Q)
writes int8 codes and one f32 scale a row in place of the bf16 rows, as
`quantize_rows` of K1's or K6's output would (`ops/quant.py`), in one pass.
Their plain versions are exactly that composition. Inference only.

It is differentiable (`torch.autograd.Function`). The JAX package has no
backward kernel for it: its custom_vjp takes the VJP of the XLA formula
`adaln_norm_ref` (f5tts_tpu/ops/adaln_norm.py:170-174). `adaln_norm_bwd` is
that VJP in PyTorch ops (autograd through `adaln_norm_ref`, in f32, cast back
to the inputs' dtypes), so a PyTorch backward is the faithful port here, not
a fallback; the forward on the card stays the kernel. `rms_norm` is
differentiable the same way (the JAX `_rms_bwd`, adaln_norm.py:145).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops._rows import MAX_D, MAX_ROWS, check_rows
from f5tts_tpu_torch.ops.quant import empty_codes, quantize_rows_ref


def adaln_norm_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 one-pass stats (var clamped >= 0), then modulation."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.load("adaln_norm")
    fn = lib.f5_adaln_norm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, shift):
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or shift.dtype != torch.bfloat16:
        raise TypeError("adaln_norm kernel takes bf16 x, scale and shift")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("adaln_norm kernel takes a contiguous [b, n, d] x")
    b, n, d = x.shape
    if d % 8 or d > MAX_D:
        raise ValueError(f"adaln_norm kernel needs d % 8 == 0 and d <= {MAX_D}, got {d}")
    if b * n > MAX_ROWS:
        raise ValueError(f"adaln_norm kernel takes at most {MAX_ROWS} rows, got {b * n}")
    for t in (scale, shift):
        if t.device != x.device:
            raise ValueError("adaln_norm: scale/shift must be on x's device")
        if t.shape != (b, d) or t.stride(1) != 1:
            raise ValueError("adaln_norm kernel takes [b, d] scale/shift with unit inner stride")
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError("adaln_norm kernel needs 16-byte aligned scale/shift rows")
    if x.data_ptr() % 16:
        raise ValueError("adaln_norm kernel needs a 16-byte aligned x")


def adaln_norm_bwd(x, scale, shift, dy, eps: float = 1e-6):
    """(dx, dscale, dshift) of `adaln_norm_ref` at (x, scale, shift) for dy."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (x, scale, shift)]
        y = adaln_norm_ref(*xs, eps)
        return torch.autograd.grad(y, xs, dy)


class _AdaLNNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.save_for_backward(x, scale, shift)
        ctx.eps = eps
        return _forward(x, scale, shift, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*adaln_norm_bwd(*ctx.saved_tensors, dy, ctx.eps), None)


def adaln_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """x [b, n, d], scale/shift [b, d]. Kernel K1 on CUDA, plain on the CPU;
    differentiable (`adaln_norm_bwd`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, shift)):
        return _AdaLNNorm.apply(x, scale, shift, eps)
    return _forward(x, scale, shift, eps)


def _forward(x, scale, shift, eps):
    if x.device.type == "cpu":
        return adaln_norm_ref(x, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_norm: unsupported device {x.device}")
    _check(x, scale, shift)
    b, n, d = x.shape
    out = torch.empty_like(x)
    err = _fn()(_build.ptr(x), _build.ptr(scale), _build.ptr(shift), _build.ptr(out),
                b, n, d, scale.stride(0), shift.stride(0), eps, _build.stream_ptr(x.device))
    _build.check(err, "adaln_norm")
    _build.count("adaln_norm")
    return out


def adaln_norm_quant_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1Q: `quantize_rows_ref` of `adaln_norm_ref`."""
    return quantize_rows_ref(adaln_norm_ref(x, scale, shift, eps))


@functools.lru_cache(maxsize=None)
def _quant_fn():
    fn = _build.load("adaln_norm").f5_adaln_norm_quant_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def adaln_norm_quant(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows(adaln_norm(x, scale, shift))` in one pass: (int8 codes
    [b, n, d], f32 scale [b, n, 1]). Kernel K1Q on CUDA, plain on the CPU."""
    if x.device.type == "cpu":
        return adaln_norm_quant_ref(x, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_norm_quant: unsupported device {x.device}")
    _check(x, scale, shift)
    b, n, d = x.shape
    codes, row_scale = empty_codes(x)
    err = _quant_fn()(_build.ptr(x), _build.ptr(scale), _build.ptr(shift), _build.ptr(codes),
                      _build.ptr(row_scale), b, n, d, scale.stride(0), shift.stride(0), eps,
                      _build.stream_ptr(x.device))
    _build.check(err, "adaln_norm_quant")
    _build.count("adaln_norm_quant")
    return codes, row_scale


# ---------------------------------------------------------------------------
# RMSNorm -> kernel K6
# ---------------------------------------------------------------------------

def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 mean of squares, (x * rstd) * w in f32; the result
    contiguous, as K6 writes it."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _rms_fn():
    lib = _build.load("adaln_norm")
    fn = lib.f5_rms_norm_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rms_check(x, w):
    """Refuse what K6 does not take; return the rows' layout
    (`_rows.row_layout`)."""
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("rms_norm kernel takes an f32 or bf16 weight")
    rows = check_rows(x, "rms_norm")
    if (w.shape != (x.shape[-1],) or not w.is_contiguous() or w.device != x.device
            or w.data_ptr() % 16):
        raise ValueError("rms_norm kernel takes a contiguous, 16-byte aligned [d] weight "
                         "on x's device")
    return rows


def rms_norm_bwd(x, w, dy, eps: float = 1e-6):
    """(dx, dw) of `rms_norm_ref` at (x, w) for dy."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (x, w)]
        return torch.autograd.grad(rms_norm_ref(*xs, eps), xs, dy)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        return (*rms_norm_bwd(*ctx.saved_tensors, dy, ctx.eps), None)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] (on the card: the last dimension contiguous, rows at up
    to three leading strides), w [d]; a contiguous result. Kernel K6 on
    CUDA, plain on the CPU; differentiable (`rms_norm_bwd`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _rms_forward(x, w, eps)


def _rms_forward(x, w, eps):
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    rows = _rms_check(x, w)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    err = _rms_fn()(_build.ptr(x), _build.ptr(w), int(w.dtype == torch.float32), _build.ptr(out),
                    *rows, x.shape[-1], eps, _build.stream_ptr(x.device))
    _build.check(err, "rms_norm")
    _build.count("rms_norm")
    return out


def rms_norm_quant_ref(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6Q: `quantize_rows_ref` of `rms_norm_ref`."""
    return quantize_rows_ref(rms_norm_ref(x, w, eps))


@functools.lru_cache(maxsize=None)
def _rms_quant_fn():
    fn = _build.load("adaln_norm").f5_rms_norm_quant_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rms_norm_quant(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows(rms_norm(x, w))` in one pass: (contiguous int8 codes
    [..., d], f32 scale [..., 1]); x as `rms_norm` takes it. Kernel K6Q on
    CUDA, plain on the CPU."""
    if x.device.type == "cpu":
        return rms_norm_quant_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_quant: unsupported device {x.device}")
    rows = _rms_check(x, w)
    codes, row_scale = empty_codes(x)
    err = _rms_quant_fn()(_build.ptr(x), _build.ptr(w), int(w.dtype == torch.float32),
                          _build.ptr(codes), _build.ptr(row_scale), *rows, x.shape[-1], eps,
                          _build.stream_ptr(x.device))
    _build.check(err, "rms_norm_quant")
    _build.count("rms_norm_quant")
    return codes, row_scale
