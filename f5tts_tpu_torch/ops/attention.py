"""Attention (counterpart of f5tts_tpu/ops/attention.py:31-546, :777-1224,
:1401-1641 and :1653-1790).

`fused_qkv_rope_attention` takes the fused QKV projection output flat
[b, n, 3*h*d], rotates q and k with interleaved RoPE from flat cos/sin
tables, scales q by 1/sqrt(d), takes the softmax over keys < lengths[b] and
writes flat [b, n, h*d] with rows >= lengths[b] zeroed. For CUDA tensors it
launches the hand-written kernel K3 (csrc/attention.cu, replacing the Pallas
`_fused_qkv_attn_kernel` and `_fused_qkv_attn_kernel_stream`: a k-RoPE
prologue and the FLAT + LENGTH mode of the wgmma forward core); CPU tensors
go to the plain version `fused_qkv_rope_attention_ref`. `mha_reference` is
the plain [b, h, n, d] oracle.

It is differentiable (`torch.autograd.Function`, as the JAX custom_vjp).
Under grad the forward runs K3's lse mode (`return_lse`: the row
log-sum-exp of the scores is saved with the output), and the backward maps
(qkv, out, lse, dO) to the flat dQKV [b, n, 3*h*d] through the hand-written
kernel K4 (csrc/attention_bwd.cu, replacing the Pallas `_fused_qkv_bwd_kernel`
and `_fused_qkv_bwd_kernel_long`) for CUDA tensors and the plain version
`fused_qkv_rope_attention_bwd_from_lse_ref` for CPU tensors: p = exp(s *
scale - lse), delta = rowsum(dO * O). `fused_qkv_rope_attention_bwd_ref` is
the JAX function (softmax recomputed, delta = rowsum(p * dp)); the two are
equal in exact arithmetic and differ by O's rounding. Rows >= lengths[b] are
zero in the forward, so their gradient is zero whatever dO holds there:
every backward reads dO as 0 on those rows.

`fused_qkv_rope_attention_bias` is the same flat attention under an arbitrary
[b, n] key mask (MMDiT's joint audio+text sequence, whose dead keys sit in
the middle): kernel K5 (the Pallas `_fused_qkv_attn_bias_kernel` and its
streaming twin; the core's FLAT + KMASK mode), plain version
`fused_qkv_rope_attention_bias_ref` (the function of the JAX
`_bias_decomposed_ref`, at the kernel's rounding points).
Every row is computed; the caller masks dead rows after to_out. Under grad it
saves its lse too, and its backward is kernel K8 (K4 in its key-mask mode,
replacing `_fused_bias_bwd_kernel` and the bias-row branch of
`_fused_qkv_bwd_kernel_long`), plain version
`fused_qkv_rope_attention_bias_bwd_from_lse_ref` (JAX function:
`fused_qkv_rope_attention_bias_bwd_ref`); dO is read as it is on every row.

`flash_attention` is head-layout attention [b, h, n, d] over keys <
lengths[b] on already-roped q/k: kernel K7 (csrc/attention.cu, replacing the
Pallas `_flash_kernel_single` and `_flash_kernel`; the core's HEAD + LENGTH
mode), plain version `flash_attention_fwd_ref` (`mha_reference`
with K7's zero q tiles); `attention` is the dispatcher of the JAX package's
attention.py:1766 without its mesh branch. When an input requires grad it
runs K7's lse mode (the row log-sum-exp saved, as the Pallas forward's
`return_lse`) and its backward is kernel K9 (csrc/attention_bwd.cu, replacing
`_flash_bwd_fused_kernel` and the split `_flash_bwd_dq_kernel` /
`_flash_bwd_dkv_kernel`), plain version `flash_attention_bwd_ref`.

Under grad the four forwards (K3's, K5's and K7's lse modes, K11) run as
`torch.library` operators `f5tts::...` (`TRAINING_ATTENTION_OPS`) inside
their autograd Functions, so activation checkpointing (`models/remat.py`)
can name them and keep their outputs; inference calls the kernels directly.

`masked_flash_attention` is head-layout attention [b, h, n, d] under an
arbitrary [b, n] key mask on already-normed and roped q/k (MMDiT joint
attention with qk-norm or unfused projections): kernel K11 (csrc/attention.cu,
replacing the Pallas `_flash_kernel_bias`; the core's HEAD + KMASK mode),
plain version
`mha_reference_masked` (the JAX function of that name). Every row is
computed. It is differentiable through the plain formula's VJP, as the JAX
custom_vjp (`_masked_bwd`) is: the JAX package has no backward kernel here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops.rope import apply_rotary_flat_tables

NEG_INF = -1e30
# a row whose saved lse is below this is dead (K7 writes NEG_INF on q tiles
# wholly past the length), as the Pallas backward tests lse > NEG_INF / 2
DEAD_LSE = NEG_INF / 2
HEAD_DIM = 64  # the kernels' head width
Q_TILE = 64    # K3's and K7's q tile: tiles wholly past the length are dead
# the longest sequence the JAX package sends through its flat kernels; past
# it `self_attention` splits heads for K7, as the JAX gate does
FLAT_ATTN_MAX_N = 4096


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[b,h,n,d] x3 -> [b,h,n,d]; f32 softmax; keys >= lengths masked."""
    n, d = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if lengths is not None:
        kmask = torch.arange(n, device=q.device)[None, :] < lengths[:, None]
        scores = torch.where(kmask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def _flat_fwd_ref(qkv, cos, sin, kmask, heads: int):
    """(o [b, n, h*d] in qkv's dtype, lse [b, h, n] f32) of the flat attention
    under a [b, n] key mask, at the kernels' rounding points: roped q *
    1/sqrt(d) and roped k in qkv's dtype, f32 scores and softmax,
    probabilities in qkv's dtype."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // heads
    q, k, v = qkv.split(hd, dim=-1)
    cos, sin = cos[:n], sin[:n]
    q = (apply_rotary_flat_tables(q, cos, sin).float() * (1.0 / math.sqrt(d))).to(qkv.dtype)
    k = apply_rotary_flat_tables(k, cos, sin)

    def split_heads(t):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    scores = torch.matmul(split_heads(q).float(), split_heads(k).float().transpose(-1, -2))
    scores = scores + torch.where(kmask, 0.0, NEG_INF)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    o = torch.matmul(probs.float(), split_heads(v).float())
    return o.transpose(1, 2).reshape(b, n, hd), torch.logsumexp(scores, dim=-1)


def fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, heads: int, return_lse: bool = False):
    """Plain version of K3 with the kernel's rounding points, rows >= length
    zeroed; with `return_lse`, also the row lse [b, h, n] f32 of the scaled
    scores over keys < length (K3's lse mode), NEG_INF on the q tiles wholly
    past the length."""
    n = qkv.shape[1]
    kmask = torch.arange(n, device=qkv.device)[None, :] < lengths[:, None]
    o, lse = _flat_fwd_ref(qkv, cos, sin, kmask, heads)
    o = torch.where(kmask[:, :, None], o, 0.0).to(qkv.dtype)
    if not return_lse:
        return o
    return o, torch.where(_live_tiles(lengths, n)[:, None, :], lse, NEG_INF)


def fused_qkv_rope_attention_bwd_ref(qkv, cos, sin, lengths, dout, heads: int) -> torch.Tensor:
    """Plain backward as the JAX package computes it (the Pallas backward's
    rounding points, attention.py:876-959): q and k roped in f32 and rounded to qkv's dtype
    (q not pre-scaled), f32 scores and softmax, ds and p rounded to qkv's
    dtype before the three products, dq and dk scaled and un-roped (rope with
    -sin) in f32. dO is read as 0 on rows >= length. One head at a time, so
    no [b, h, n, n] tensor exists."""
    live = torch.arange(qkv.shape[1], device=qkv.device)[None, :] < lengths[:, None]
    do = torch.where(live[:, :, None], dout.to(qkv.dtype),
                     torch.zeros((), dtype=qkv.dtype, device=qkv.device))
    return _flat_bwd_ref(qkv, cos, sin, live, do, heads)


def fused_qkv_rope_attention_bias_bwd_ref(qkv, cos, sin, kmask, dout, heads: int) -> torch.Tensor:
    """Plain backward of `fused_qkv_rope_attention_bias` as the JAX package
    computes it: `fused_qkv_rope_attention_bwd_ref` with the key mask as the
    bias row and dO read as it is on every row (the forward computes every
    row)."""
    return _flat_bwd_ref(qkv, cos, sin, kmask, dout.to(qkv.dtype), heads)


def fused_qkv_rope_attention_bwd_from_lse_ref(qkv, cos, sin, lengths, out, lse, dout,
                                              heads: int) -> torch.Tensor:
    """K4's function: dQKV from the forward's output and row lse (K3's lse
    mode). q and k roped in f32 and rounded to qkv's dtype (q not pre-scaled);
    p = exp(s * scale - lse) on rows and keys < length, else 0; delta =
    rowsum(dO * O) in f32 with dO read as 0 on rows >= length; ds = p * (dp -
    delta); ds and p rounded to qkv's dtype before the three products; dq and
    dk scaled and un-roped in f32."""
    live = torch.arange(qkv.shape[1], device=qkv.device)[None, :] < lengths[:, None]
    do = torch.where(live[:, :, None], dout.to(qkv.dtype),
                     torch.zeros((), dtype=qkv.dtype, device=qkv.device))
    return _flat_bwd_ref(qkv, cos, sin, live, do, heads, saved=(live, out, lse))


def fused_qkv_rope_attention_bias_bwd_from_lse_ref(qkv, cos, sin, kmask, out, lse, dout,
                                                   heads: int) -> torch.Tensor:
    """K8's function: `fused_qkv_rope_attention_bwd_from_lse_ref` with every
    row live, dO read as it is, and keys live where kmask is set (K5's output
    and lse)."""
    return _flat_bwd_ref(qkv, cos, sin, kmask, dout.to(qkv.dtype), heads,
                         saved=(torch.ones_like(kmask), out, lse))


def _flat_bwd_ref(qkv, cos, sin, key_live, do, heads: int, saved=None) -> torch.Tensor:
    """dQKV of the flat attention, one head at a time (no [b, h, n, n]
    tensor). With `saved` = (row_live [b, n], out, lse): p from the saved lse
    on live rows and keys and delta = rowsum(dO * O) (K4 / K8); without it
    the softmax recomputed and delta = rowsum(p * dp) (the JAX function)."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // heads
    scale = 1.0 / math.sqrt(d)
    dt = qkv.dtype
    q, k, v = qkv.split(hd, dim=-1)
    cos, sin = cos[:n], sin[:n]
    qr = apply_rotary_flat_tables(q, cos, sin)
    kr = apply_rotary_flat_tables(k, cos, sin)
    if saved is None:
        bias = torch.where(key_live, 0.0, NEG_INF)[:, None, :]
    else:
        row_live, out, lse = saved
        live = row_live[:, :, None] & key_live[:, None, :]
        delta_o = (do.float() * out.float()).reshape(b, n, heads, d).sum(dim=-1)
    grads = [torch.empty(b, n, hd, dtype=torch.float32, device=qkv.device) for _ in range(3)]
    for i in range(heads):
        lanes = slice(i * d, (i + 1) * d)
        qh, kh, vh, doh = (t[..., lanes].float() for t in (qr, kr, v, do))
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale
        dp = torch.matmul(doh, vh.transpose(1, 2))
        if saved is None:
            p = torch.softmax(s + bias, dim=-1)
            delta = (p * dp).sum(dim=-1, keepdim=True)
        else:
            p = torch.where(live, torch.exp(s - lse[:, i, :, None].float()), 0.0)
            delta = delta_o[:, :, i, None]
        ds = (p * (dp - delta)).to(dt).float()
        grads[0][..., lanes] = torch.matmul(ds, kh) * scale
        grads[1][..., lanes] = torch.matmul(ds.transpose(1, 2), qh) * scale
        grads[2][..., lanes] = torch.matmul(p.to(dt).float().transpose(1, 2), doh)
    dq = apply_rotary_flat_tables(grads[0], cos, -sin)
    dk = apply_rotary_flat_tables(grads[1], cos, -sin)
    return torch.cat([dq, dk, grads[2]], dim=-1).to(dt)


@functools.lru_cache(maxsize=None)
def _entry(lib: str, name: str, n_ptrs: int):
    """`name` of csrc/<lib>.cu: n_ptrs pointers, then (b, n, heads, scale, stream)."""
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(qkv, cos, sin, lengths, heads):
    _check_qkv(qkv, cos, sin, heads)
    _check_lengths(lengths, qkv.shape[0], qkv.device)


def _check_lengths(lengths, b, device):
    if (lengths.shape != (b,) or lengths.dtype != torch.int32 or lengths.device != device
            or not lengths.is_contiguous()):
        raise ValueError("attention kernel takes int32 [b] lengths on the inputs' device")


def _check_kmask(kmask, b, n, device):
    if (kmask.shape != (b, n) or kmask.dtype != torch.bool or kmask.device != device
            or not kmask.is_contiguous()):
        raise ValueError("attention bias kernel takes a contiguous bool [b, n] key mask on "
                         "qkv's device")


def _check_qkv(qkv, cos, sin, heads):
    if (qkv.dim() != 3 or not qkv.is_contiguous() or qkv.dtype != torch.bfloat16
            or qkv.data_ptr() % 16):
        raise ValueError("attention kernel takes a contiguous, 16-byte aligned bf16 "
                         "[b, n, 3*h*d] qkv")
    b, n, hd3 = qkv.shape
    if hd3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"attention kernel takes head width {HEAD_DIM}: "
                         f"qkv width {hd3} with {heads} heads")
    hd = heads * HEAD_DIM
    for t in (cos, sin):
        if (t.dim() != 2 or t.shape[0] < n or t.shape[1] != hd or not t.is_contiguous()
                or t.dtype != torch.bfloat16 or t.device != qkv.device):
            raise ValueError("attention kernel takes contiguous bf16 [>=n, h*d] "
                             "rope tables on qkv's device")


def _device(name: str, t: torch.Tensor) -> str:
    """"cpu" or "cuda"; any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _flat_bwd(entry: str, name: str, qkv, cos, sin, mask, out, lse, dout, heads: int) -> torch.Tensor:
    """Launch a flat dQKV backward (prologue, dk/dv, dq): K4 (`mask` =
    lengths) or K8 (`mask` = kmask), from the forward's out and lse."""
    b, n, hd3 = qkv.shape
    dout = dout.contiguous()
    for t in (dout, out):
        if (t.shape != (b, n, hd3 // 3) or t.dtype != qkv.dtype or t.device != qkv.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("attention backward kernel takes a contiguous, 16-byte aligned bf16 "
                             "[b, n, h*d] output and gradient on qkv's device")
    if (lse.shape != (b, heads, n) or lse.dtype != torch.float32 or lse.device != qkv.device
            or not lse.is_contiguous()):
        raise ValueError("attention backward kernel takes a contiguous f32 [b, h, n] lse")
    dqkv = torch.empty_like(qkv)
    k_rot = torch.empty((b, heads, n, HEAD_DIM), dtype=qkv.dtype, device=qkv.device)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    err = _entry("attention_bwd", entry, 10)(
        *(_build.ptr(t) for t in (qkv, cos, sin, mask, out, lse, dout, dqkv, k_rot, delta)),
        b, n, heads, 1.0 / math.sqrt(HEAD_DIM), _build.stream_ptr(qkv.device))
    _build.check(err, name)
    _build.count(name)
    return dqkv


# ---------------------------------------------------------------------------
# K3 forward, K4 backward: flat fused QKV + RoPE attention over keys < lengths
# ---------------------------------------------------------------------------

def fused_qkv_rope_attention_bwd(qkv, cos, sin, lengths, out, lse, dout, heads: int) -> torch.Tensor:
    """dQKV [b, n, 3*h*d] of `fused_qkv_rope_attention` from its output and
    row lse (`return_lse`) for the incoming gradient dout [b, n, h*d].
    Kernel K4 on CUDA, plain on the CPU."""
    if _device("fused_qkv_rope_attention_bwd", qkv) == "cpu":
        return fused_qkv_rope_attention_bwd_from_lse_ref(qkv, cos, sin, lengths, out, lse, dout,
                                                         heads)
    _check(qkv, cos, sin, lengths, heads)
    return _flat_bwd("f5_fused_qkv_rope_attn_bwd_bf16", "fused_qkv_rope_attention_bwd",
                     qkv, cos, sin, lengths, out, lse, dout, heads)


def _attention_op(name: str, schema: str, fn):
    """`fn` registered as the operator f5tts::`name`: what the training
    forwards call under grad, so activation checkpointing
    (`models/remat.py`) can name the attention and keep its outputs."""
    return torch.library.custom_op(f"f5tts::{name}", fn, mutates_args=(), schema=schema)


_flat_lse_op = _attention_op(
    "fused_qkv_rope_attention_lse",
    "(Tensor qkv, Tensor cos, Tensor sin, Tensor lengths, int heads) -> (Tensor, Tensor)",
    lambda qkv, cos, sin, lengths, heads: fused_qkv_rope_attention_fwd(
        qkv, cos, sin, lengths, heads, return_lse=True))


class _FusedQKVRopeAttention(torch.autograd.Function):
    """K3 forward in its lse mode, K4 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, lengths, heads):
        out, lse = _flat_lse_op(qkv, cos, sin, lengths, heads)
        ctx.save_for_backward(qkv, cos, sin, lengths, out, lse)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, dout):
        dqkv = fused_qkv_rope_attention_bwd(*ctx.saved_tensors, dout, ctx.heads)
        return dqkv, None, None, None, None


def fused_qkv_rope_attention(qkv, cos, sin, lengths, heads: int) -> torch.Tensor:
    """qkv [b, n, 3*h*d], cos/sin [>=n, h*d], lengths [b] int32 -> [b, n, h*d]
    over keys < lengths[b], rows >= lengths[b] zero. Kernel K3 on CUDA (a
    k-RoPE prologue and the wgmma core's FLAT + LENGTH mode), plain on the
    CPU; differentiable in qkv (K3's lse mode and K4 on CUDA)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedQKVRopeAttention.apply(qkv, cos, sin, lengths, heads)
    return fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, heads)


def fused_qkv_rope_attention_fwd(qkv, cos, sin, lengths, heads: int, return_lse: bool = False):
    """The forward of `fused_qkv_rope_attention`; with `return_lse` also the
    row lse [b, h, n] f32 (K3's lse mode on CUDA)."""
    if _device("fused_qkv_rope_attention", qkv) == "cpu":
        return fused_qkv_rope_attention_ref(qkv, cos, sin, lengths, heads, return_lse)
    _check(qkv, cos, sin, lengths, heads)
    return _flat_fwd("f5_fused_qkv_rope_attn", "fused_qkv_rope_attention", qkv, cos, sin,
                     lengths, heads, return_lse)


def _flat_fwd(entry: str, name: str, qkv, cos, sin, mask, heads: int, return_lse: bool):
    """Launch K3 (`mask` = lengths) or K5 (`mask` = kmask) with their
    roped-k scratch [b, h, n, d] (the prologue's output, freed after the
    call), in the lse mode (entry `<entry>_lse_bf16`, count `<name>_lse`)
    with `return_lse`."""
    b, n, hd3 = qkv.shape
    out = torch.empty((b, n, hd3 // 3), dtype=qkv.dtype, device=qkv.device)
    args = [_build.ptr(qkv), _build.ptr(cos), _build.ptr(sin), _build.ptr(mask), _build.ptr(out)]
    if return_lse:
        lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
        args.append(_build.ptr(lse))
        entry, name = entry + "_lse", name + "_lse"
    k_rot = torch.empty((b, heads, n, HEAD_DIM), dtype=qkv.dtype, device=qkv.device)
    args.append(_build.ptr(k_rot))
    err = _entry("attention", entry + "_bf16", len(args))(
        *args, b, n, heads, 1.0 / math.sqrt(HEAD_DIM), _build.stream_ptr(qkv.device))
    _build.check(err, name)
    _build.count(name)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# K5 forward, K8 backward: flat fused QKV + RoPE attention under a key mask
# ---------------------------------------------------------------------------

def fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, heads: int, return_lse: bool = False):
    """Plain version of K5: `fused_qkv_rope_attention_ref` with the key mask as
    an additive 0 / -1e30 row and no row zeroed; with `return_lse`, also the
    row lse [b, h, n] f32 of every row (K5's lse mode)."""
    o, lse = _flat_fwd_ref(qkv, cos, sin, kmask, heads)
    o = o.to(qkv.dtype)
    return (o, lse) if return_lse else o


def fused_qkv_rope_attention_bias_bwd(qkv, cos, sin, kmask, out, lse, dout,
                                      heads: int) -> torch.Tensor:
    """dQKV [b, n, 3*h*d] of `fused_qkv_rope_attention_bias` from its output
    and row lse for the incoming gradient dout [b, n, h*d]. Kernel K8 on
    CUDA, plain on the CPU."""
    if _device("fused_qkv_rope_attention_bias_bwd", qkv) == "cpu":
        return fused_qkv_rope_attention_bias_bwd_from_lse_ref(qkv, cos, sin, kmask, out, lse,
                                                              dout, heads)
    _check_qkv(qkv, cos, sin, heads)
    _check_kmask(kmask, qkv.shape[0], qkv.shape[1], qkv.device)
    return _flat_bwd("f5_fused_qkv_rope_attn_bias_bwd_bf16", "fused_qkv_rope_attention_bias_bwd",
                     qkv, cos, sin, kmask, out, lse, dout, heads)


_flat_bias_lse_op = _attention_op(
    "fused_qkv_rope_attention_bias_lse",
    "(Tensor qkv, Tensor cos, Tensor sin, Tensor kmask, int heads) -> (Tensor, Tensor)",
    lambda qkv, cos, sin, kmask, heads: fused_qkv_rope_attention_bias_fwd(
        qkv, cos, sin, kmask, heads, return_lse=True))


class _FusedQKVRopeAttentionBias(torch.autograd.Function):
    """K5 forward in its lse mode, K8 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, kmask, heads):
        out, lse = _flat_bias_lse_op(qkv, cos, sin, kmask, heads)
        ctx.save_for_backward(qkv, cos, sin, kmask, out, lse)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, dout):
        dqkv = fused_qkv_rope_attention_bias_bwd(*ctx.saved_tensors, dout, ctx.heads)
        return dqkv, None, None, None, None


def fused_qkv_rope_attention_bias(qkv, cos, sin, kmask, heads: int) -> torch.Tensor:
    """qkv [b, n, 3*h*d], joint cos/sin [>=n, h*d], kmask [b, n] bool (True =
    live key) -> [b, n, h*d]. Kernel K5 on CUDA, plain on the CPU;
    differentiable in qkv (K5's lse mode and K8 on CUDA)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedQKVRopeAttentionBias.apply(qkv, cos, sin, kmask, heads)
    return fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, heads)


def fused_qkv_rope_attention_bias_fwd(qkv, cos, sin, kmask, heads: int, return_lse: bool = False):
    """The forward of `fused_qkv_rope_attention_bias`; with `return_lse` also
    the row lse [b, h, n] f32 (K5's lse mode on CUDA)."""
    if _device("fused_qkv_rope_attention_bias", qkv) == "cpu":
        return fused_qkv_rope_attention_bias_ref(qkv, cos, sin, kmask, heads, return_lse)
    _check_qkv(qkv, cos, sin, heads)
    _check_kmask(kmask, qkv.shape[0], qkv.shape[1], qkv.device)
    return _flat_fwd("f5_fused_qkv_rope_attn_bias", "fused_qkv_rope_attention_bias", qkv, cos,
                     sin, kmask, heads, return_lse)


# ---------------------------------------------------------------------------
# K7 forward (its lse mode under grad), K9 backward: head-layout attention
# over keys < lengths
# ---------------------------------------------------------------------------

def _live_tiles(lengths, n: int) -> torch.Tensor:
    """[b, n] bool: the row's 64-row q tile starts before the length."""
    tile0 = torch.arange(n, device=lengths.device) // Q_TILE * Q_TILE
    return tile0[None, :] < lengths[:, None]


def flash_attention_fwd_ref(q, k, v, lengths, return_lse: bool = False):
    """K7's function: `mha_reference` with the q tiles wholly past the length
    written as 0; with `return_lse`, also the row lse [b, h, n] f32 of the
    scaled scores (log-sum-exp over keys < length), NEG_INF on those tiles."""
    n, d = q.shape[-2], q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    kmask = torch.arange(n, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(kmask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    live = _live_tiles(lengths, n)[:, None, :]
    o = torch.where(live[..., None], o, torch.zeros((), dtype=o.dtype, device=o.device))
    if not return_lse:
        return o
    return o, torch.where(live, torch.logsumexp(scores, dim=-1), NEG_INF)


def flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout) -> tuple:
    """(dq, dk, dv) of the head-layout attention from the saved row lse (K9's
    function, the Pallas backward bodies'): rows with lse <= DEAD_LSE and keys
    >= length get p = 0, else p = exp(s * scale - lse); delta = rowsum(dO *
    O) in f32; ds = p * (dp - delta); p and ds rounded to q's dtype before
    dv = p^T dO, dk = ds^T q * scale and dq = ds k * scale. One head at a
    time, so no [b, h, n, n] tensor exists."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    delta = (dout.float() * o.float()).sum(dim=-1, keepdim=True)
    key_live = (torch.arange(n, device=q.device)[None, :] < lengths[:, None])[:, None, :]
    grads = [torch.empty(b, h, n, d, dtype=torch.float32, device=q.device) for _ in range(3)]
    for i in range(h):
        qh, kh, vh, doh = (t[:, i].float() for t in (q, k, v, dout))
        lse_i = lse[:, i, :, None]
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale
        p = torch.where((lse_i > DEAD_LSE) & key_live, torch.exp(s - lse_i), 0.0)
        dp = torch.matmul(doh, vh.transpose(1, 2))
        ds = (p * (dp - delta[:, i])).to(dt).float()
        grads[0][:, i] = torch.matmul(ds, kh) * scale
        grads[1][:, i] = torch.matmul(ds.transpose(1, 2), qh) * scale
        grads[2][:, i] = torch.matmul(p.to(dt).float().transpose(1, 2), doh)
    return tuple(g.to(dt) for g in grads)


def _check_heads(*tensors):
    q = tensors[0]
    for t in tensors:
        if (t.dim() != 4 or t.shape != q.shape or t.shape[-1] != HEAD_DIM or not t.is_contiguous()
                or t.dtype != torch.bfloat16 or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"flash attention kernel takes contiguous, 16-byte aligned bf16 "
                             f"[b, h, n, {HEAD_DIM}] tensors of one shape")


def flash_attention_fwd(q, k, v, lengths, return_lse: bool = False):
    """[b, h, n, d] q/k/v (already roped), lengths [b] int32 -> out [b, h, n, d]
    (and with `return_lse` the row lse [b, h, n] f32). Kernel K7 on CUDA (its
    lse mode with `return_lse`), `flash_attention_fwd_ref` on the CPU."""
    if _device("flash_attention", q) == "cpu":
        return flash_attention_fwd_ref(q, k, v, lengths, return_lse)
    _check_heads(q, k, v)
    b, h, n, _ = q.shape
    _check_lengths(lengths, b, q.device)
    out = torch.empty_like(q)
    args = [_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths), _build.ptr(out)]
    if return_lse:
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        name, fn = "flash_attention_lse", _entry("attention", "f5_flash_attn_lse_bf16", 6)
        args.append(_build.ptr(lse))
    else:
        name, fn = "flash_attention", _entry("attention", "f5_flash_attn_bf16", 5)
    err = fn(*args, b, n, h, 1.0 / math.sqrt(HEAD_DIM), _build.stream_ptr(q.device))
    _build.check(err, name)
    _build.count(name)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, lengths, o, lse, dout) -> tuple:
    """(dq, dk, dv) [b, h, n, d] of `flash_attention` from its saved output o
    and row lse, for the incoming gradient dout. Kernel K9 on CUDA, plain on
    the CPU."""
    if _device("flash_attention_bwd", q) == "cpu":
        return flash_attention_bwd_ref(q, k, v, lengths, o, lse, dout)
    dout = dout.contiguous()
    _check_heads(q, k, v, o, dout)
    b, h, n, _ = q.shape
    _check_lengths(lengths, b, q.device)
    if (lse.shape != (b, h, n) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError("flash attention backward kernel takes a contiguous f32 [b, h, n] lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    err = _entry("attention_bwd", "f5_flash_attn_bwd_bf16", 11)(
        *(_build.ptr(t) for t in (q, k, v, lengths, o, lse, dout, dq, dk, dv, delta)),
        b, n, h, 1.0 / math.sqrt(HEAD_DIM), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention_bwd")
    _build.count("flash_attention_bwd")
    return dq, dk, dv


_flash_lse_op = _attention_op(
    "flash_attention_lse",
    "(Tensor q, Tensor k, Tensor v, Tensor lengths) -> (Tensor, Tensor)",
    lambda q, k, v, lengths: flash_attention_fwd(q, k, v, lengths, return_lse=True))


class _FlashAttention(torch.autograd.Function):
    """K7 forward in its lse mode, K9 backward (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths):
        o, lse = _flash_lse_op(q, k, v, lengths)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        return (*flash_attention_bwd(*ctx.saved_tensors, dout), None)


def flash_attention(q, k, v, lengths) -> torch.Tensor:
    """q/k/v [b, h, n, d] (already roped), lengths [b] int32 -> [b, h, n, d]
    over keys < lengths[b]; q tiles wholly past the length are written as 0.
    Kernel K7 on CUDA, `flash_attention_fwd_ref` on the CPU; differentiable
    in q, k and v (K7's lse mode and K9 on CUDA)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, lengths)
    return flash_attention_fwd(q, k, v, lengths)


def attention(q, k, v, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[b, h, n, d] attention over keys < lengths (all keys when None)."""
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[2], dtype=torch.int32, device=q.device)
    return flash_attention(q, k, v, lengths.to(torch.int32))


# ---------------------------------------------------------------------------
# K11 forward: head-layout attention under a key mask
# ---------------------------------------------------------------------------

def mha_reference_masked(q, k, v, kmask) -> torch.Tensor:
    """[b, h, n, d] attention under a [b, n] bool key mask (True = live):
    f32 scores and softmax, probabilities in v's dtype. A batch row with no
    live key gets the uniform mean of v (K11 writes zeros there)."""
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = torch.where(kmask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def masked_flash_attention_bwd(q, k, v, kmask, dout) -> tuple:
    """(dq, dk, dv) of `mha_reference_masked` for dout (JAX `_masked_bwd`)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(mha_reference_masked(*xs, kmask), xs, dout)


class _MaskedFlashAttention(torch.autograd.Function):
    """K11 forward (plain on the CPU), the plain formula's VJP backward."""

    @staticmethod
    def forward(ctx, q, k, v, kmask):
        ctx.save_for_backward(q, k, v, kmask)
        return _masked_op(q, k, v, kmask)

    @staticmethod
    def backward(ctx, dout):
        return (*masked_flash_attention_bwd(*ctx.saved_tensors, dout), None)


def masked_flash_attention(q, k, v, kmask) -> torch.Tensor:
    """q/k/v [b, h, n, d] (already normed and roped), kmask [b, n] bool (True
    = live key) -> [b, h, n, d], every row computed (a batch row with no live
    key: zeros). Kernel K11 on CUDA (the wgmma core's HEAD + KMASK mode, one
    launch), `mha_reference_masked` on the CPU; differentiable in q, k and v
    (the plain formula's VJP)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MaskedFlashAttention.apply(q, k, v, kmask)
    return _masked_forward(q, k, v, kmask)


def _masked_forward(q, k, v, kmask) -> torch.Tensor:
    if _device("masked_flash_attention", q) == "cpu":
        return mha_reference_masked(q, k, v, kmask)
    _check_heads(q, k, v)
    b, h, n, _ = q.shape
    _check_kmask(kmask, b, n, q.device)
    out = torch.empty_like(q)
    err = _entry("attention", "f5_masked_flash_attn_bf16", 5)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(kmask), _build.ptr(out),
        b, n, h, 1.0 / math.sqrt(HEAD_DIM), _build.stream_ptr(q.device))
    _build.check(err, "masked_flash_attention")
    _build.count("masked_flash_attention")
    return out


_masked_op = _attention_op("masked_flash_attention",
                           "(Tensor q, Tensor k, Tensor v, Tensor kmask) -> Tensor",
                           lambda q, k, v, kmask: _masked_forward(q, k, v, kmask))
# the operators the training forwards call: what remat's "attn_out" keeps
TRAINING_ATTENTION_OPS = (_flat_lse_op, _flat_bias_lse_op, _flash_lse_op, _masked_op)
