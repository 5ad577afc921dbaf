"""Building blocks of the DiT, UNetT and MMDiT backbones, as functions over
parameter dicts.

Counterparts of f5tts_tpu/models/modules.py. Parameters are nested dicts of
tensors with the JAX package's keys and layouts, which the port keeps:
- Linear weights (in, out), applied as `x @ w + b`;
- Conv1d weights (k, in/groups, out) (WIO);
- per-block dicts are kept in a Python list (the JAX package stacks them on
  a leading depth axis; `convert.py` unstacks).
Compute runs in the caller's dtype with LayerNorm, RMSNorm, GRN and softmax
statistics in f32, as in the JAX package.

On int8 params (`ops.quant.quantize_dit_params`) a block names the
projections that read each norm's rows (`attention_inputs`, ff.in), and
the norm writes codes and row scales (K1Q / K6Q) instead of bf16 rows where
every one of them is an int8 leaf without the outlier hedge
(`takes_quantized`); ff.out's input is quantized inside the GELU pass
(K12's GELU mode) on the same rule. `linear` takes those `QuantRows`.
bf16 leaves and leaves with the hedge get bf16 rows as before.

Tensor parallelism (`parallel.mesh`): given a `tp` group (`parallel.
collectives.TP`), the block functions take this rank's shards of the
column-parallel leaves (q / k / v, FF-in) and row-parallel leaves (attn-out,
FF-out): the input of the column projections passes `copy_to_tp` (its
gradient is summed over the group), the attention runs `local_heads`, and a
row projection's partial product is summed over the group before its bias
(`linear(..., tp)`). A whole weight that acts on this rank's heads only
(the qk-norm weights) passes `copy_to_tp` as well (`tp_whole`), so its
gradient is the sum over the group, as every rank's copy must be updated
alike. Under tp an int8 FF-out takes bf16 rows (no GELU quantize mode): its
row scale must be the whole row's (`ops.quant.int8_linear_partial_tp`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from f5tts_tpu_torch.models.remat import tagged
from f5tts_tpu_torch.ops.adaln_norm import adaln_norm, adaln_norm_quant, rms_norm_quant
from f5tts_tpu_torch.ops.adaln_norm import rms_norm as rms_norm_kernel
from f5tts_tpu_torch.ops.attention import (FLAT_ATTN_MAX_N, attention, flat_width_supported,
                                           fused_qkv_rope_attention)
from f5tts_tpu_torch.ops.grouped_conv import conv_pos_embedding as conv_pos_kernel
from f5tts_tpu_torch.ops.grouped_conv import (grouped_conv1d, grouped_conv1d_ref, mish,
                                              supports_fused_conv_pos, supports_grouped_conv)
from f5tts_tpu_torch.ops.quant import (QuantRows, gelu_quantize_rows, int8_linear,
                                       int8_linear_partial_tp)
from f5tts_tpu_torch.ops.rope import apply_rotary_flat, apply_rotary_partial_heads
from f5tts_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp

Params = dict


# ---------------------------------------------------------------------------
# Init (torch-default-like bounds, as the JAX package initialises)
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def init_linear(gen, d_in: int, d_out: int, bias: bool = True, zero: bool = False) -> Params:
    if zero:
        p = {"w": torch.zeros(d_in, d_out)}
        if bias:
            p["b"] = torch.zeros(d_out)
        return p
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(gen, (d_in, d_out), bound)}
    if bias:
        p["b"] = _uniform(gen, (d_out,), bound)
    return p


def init_conv1d(gen, c_in: int, c_out: int, kernel: int, groups: int = 1) -> Params:
    """Kernel [kernel, c_in // groups, c_out] (WIO)."""
    bound = 1.0 / math.sqrt((c_in // groups) * kernel)
    return {"w": _uniform(gen, (kernel, c_in // groups, c_out), bound),
            "b": _uniform(gen, (c_out,), bound)}


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def linear(p: Params, x, tp=None) -> torch.Tensor:
    """x @ w + b; x a tensor, or `QuantRows` for an int8 leaf without the
    outlier hedge. With `tp`, p is this rank's shard of a row-parallel leaf
    and x its slice of the input: the partial products are summed over the
    group, then the bias is added once."""
    if tp is not None:
        y = (int8_linear_partial_tp(p, x, tp) if "w_i8" in p
             else torch.matmul(x, p["w"].to(x.dtype)))
        y = reduce_from_tp(y, tp)
        return y + p["b"].to(y.dtype) if "b" in p else y
    if "w_i8" in p:  # an int8 leaf (ops.quant.quantize_dit_params): K12, the product, K13
        return int8_linear(p, x)
    if isinstance(x, QuantRows):
        raise TypeError("pre-quantized rows need an int8 leaf")
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6) -> torch.Tensor:
    """One-pass f32 statistics (var = E[x^2] - E[x]^2, clamped >= 0)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def init_rms_norm(dim: int) -> Params:
    return {"w": torch.ones(dim)}


def takes_quantized(*leaves: Params) -> bool:
    """Whether there are `leaves` and every one is an int8 leaf without the
    outlier hedge: the projections a norm or GELU hands its rows quantized."""
    return bool(leaves) and all("w_i8" in p and "act_mask" not in p for p in leaves)


def tp_whole(p: Params, tp) -> Params:
    """p with its weight through `copy_to_tp` under `tp`: a replicated leaf
    applied to this rank's heads only, its gradient summed over the group."""
    return p if tp is None else {**p, "w": copy_to_tp(p["w"], tp)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6, readers=()):
    """x * rsqrt(mean(x^2) + eps) * w, f32 statistics -> kernel K6; as
    `QuantRows` (K6Q) where the projection leaves `readers` all take them."""
    if takes_quantized(*readers):
        return QuantRows(*rms_norm_quant(x, p["w"], eps), x.dtype)
    return rms_norm_kernel(x, p["w"], eps)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def depthwise_conv1d(p: Params, x: torch.Tensor, dilation: int = 1,
                     padding: Optional[int] = None) -> torch.Tensor:
    """Depthwise conv of x [b, n, c] as k shifted multiply-adds in x's dtype
    (kernel [k, 1, c]), as the JAX package computes it."""
    kern = p["w"][:, 0, :].to(x.dtype)
    k = kern.shape[0]
    total = dilation * (k - 1)
    lead = total // 2 if padding is None else padding
    n = x.shape[1]
    xp = F.pad(x, (0, 0, lead, total - lead))
    y = None
    for i in range(k):
        term = xp[:, i * dilation: i * dilation + n] * kern[i]
        y = term if y is None else y + term
    return y + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# Position / timestep embeddings
# ---------------------------------------------------------------------------

def sinus_pos_embedding(x: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[b] -> [b, dim]; note the (half - 1) denominator."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = scale * x.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_timestep_embedding(gen, dim: int, freq_embed_dim: int = 256) -> Params:
    return {"mlp1": init_linear(gen, freq_embed_dim, dim), "mlp2": init_linear(gen, dim, dim)}


def timestep_embedding(p: Params, t: torch.Tensor, dtype=torch.float32,
                       freq_embed_dim: int = 256) -> torch.Tensor:
    h = sinus_pos_embedding(t, freq_embed_dim).to(dtype)
    return linear(p["mlp2"], F.silu(linear(p["mlp1"], h)))


# ---------------------------------------------------------------------------
# Conv position embedding -> kernel K2, or two launches of K10
# ---------------------------------------------------------------------------

def init_conv_pos_embedding(gen, dim: int, kernel: int = 31, groups: int = 16) -> Params:
    return {"conv1": init_conv1d(gen, dim, dim, kernel, groups),
            "conv2": init_conv1d(gen, dim, dim, kernel, groups)}


def conv_pos_embedding(p: Params, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                       groups: int = 16) -> torch.Tensor:
    """x [b, n, d]; rows >= lengths are zeroed before and after each conv.

    The JAX dispatch (modules.py:248-273): 64 channels a group with k = 31
    goes to the fused kernel K2; any other width (the dim-768 presets: 48)
    or k runs the unfused chain in the JAX rounding order: mask, conv + bias
    (out in x's dtype), mask, Mish in f32 cast back, conv, mask, Mish. Its
    convs are K10 where c / groups is a multiple of 8 (JAX's
    `supports_pallas_grouped_conv` on the width; K10 takes any n), else
    JAX's XLA `conv1d` in x's dtype. Without `lengths` nothing is
    masked."""
    b, n, c = x.shape
    w1, b1 = p["conv1"]["w"].to(x.dtype), p["conv1"]["b"].to(x.dtype)
    w2, b2 = p["conv2"]["w"].to(x.dtype), p["conv2"]["b"].to(x.dtype)
    if supports_fused_conv_pos(c, groups, w1.shape[0]):
        if lengths is None:
            lengths = torch.full((b,), n, dtype=torch.int32, device=x.device)
        return conv_pos_kernel(x, w1, b1, w2, b2, lengths.to(torch.int32), groups)

    def masked(h):
        if lengths is None:
            return h
        valid = torch.arange(n, device=x.device)[None, :, None] < lengths[:, None, None]
        return torch.where(valid, h, torch.zeros((), dtype=h.dtype, device=h.device))

    if supports_grouped_conv(c, groups):
        conv = grouped_conv1d
    else:
        def conv(h, w, bias, g):
            return grouped_conv1d_ref(h, w, bias, g, h.dtype)
    h = conv(masked(x), w1, b1, groups)
    h = conv(mish(masked(h)), w2, b2, groups)
    return mish(masked(h))


# ---------------------------------------------------------------------------
# GRN + ConvNeXt V2
# ---------------------------------------------------------------------------

def grn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Global response norm over the SEQUENCE axis (dim 1 of [b, n, d])."""
    xf = x.float()
    gx = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    y = p["gamma"].float() * (xf * nx) + p["beta"].float() + xf
    return y.to(x.dtype)


def init_convnext_v2_block(gen, dim: int, intermediate_dim: int) -> Params:
    return {
        "dwconv": init_conv1d(gen, dim, dim, 7, groups=dim),
        "norm_w": torch.ones(dim),
        "norm_b": torch.zeros(dim),
        "pw1": init_linear(gen, dim, intermediate_dim),
        "grn": {"gamma": torch.zeros(intermediate_dim), "beta": torch.zeros(intermediate_dim)},
        "pw2": init_linear(gen, intermediate_dim, dim),
    }


def convnext_v2_block(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    h = depthwise_conv1d(p["dwconv"], x, dilation=dilation, padding=(dilation * 6) // 2)
    h = layer_norm(h, p["norm_w"], p["norm_b"], eps=1e-6)
    h = gelu_exact(linear(p["pw1"], h))
    h = grn(p["grn"], h)
    return x + linear(p["pw2"], h)


# ---------------------------------------------------------------------------
# AdaLN -> kernel K1
# ---------------------------------------------------------------------------

def init_adaln(gen, dim: int, zero: bool = True) -> Params:
    return {"linear": init_linear(gen, dim, 6 * dim, zero=zero)}


def init_adaln_final(gen, dim: int, zero: bool = True) -> Params:
    return {"linear": init_linear(gen, dim, 2 * dim, zero=zero)}


def adaln_pre(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, readers=()):
    """LayerNorm (no affine) * (1 + scale) + shift, broadcast over the
    sequence -> K1; as `QuantRows` (K1Q) where the projection leaves
    `readers` all take them."""
    if takes_quantized(*readers):
        return QuantRows(*adaln_norm_quant(x, scale, shift), x.dtype)
    return adaln_norm(x, scale, shift)


def adaln_final(x: torch.Tensor, mod: torch.Tensor, readers=()):
    """Final AdaLN from a precomputed [b, 2*dim] modulation. NOTE the
    (scale, shift) order here against (shift, scale, gate, ...) in blocks."""
    scale, shift = mod.chunk(2, dim=-1)
    return adaln_pre(x, shift, scale, readers)


def init_feed_forward(gen, dim: int, mult: int) -> Params:
    return {"in": init_linear(gen, dim, dim * mult), "out": init_linear(gen, dim * mult, dim)}


def feed_forward(p: Params, x, tp=None) -> torch.Tensor:
    """out(GELU-tanh(in(x))); x a tensor, or `QuantRows` for an int8 ff.in.
    An int8 ff.out without the hedge takes its input quantized inside the
    GELU pass (K12's GELU mode). With `tp`: this rank's FF columns, ff.out
    reduced over the group."""
    if tp is not None:
        h = linear(p["in"], x if isinstance(x, QuantRows) else copy_to_tp(x, tp))
        return linear(p["out"], gelu_tanh(h), tp)
    h = linear(p["in"], x)
    if takes_quantized(p["out"]):
        return linear(p["out"], QuantRows(*gelu_quantize_rows(h), h.dtype))
    return linear(p["out"], gelu_tanh(h))


# ---------------------------------------------------------------------------
# Self-attention: flat K3 (K7 past 4096 rows) on fused params without
# qk-norm, else the head layout with K7 at every n
# ---------------------------------------------------------------------------

def init_attention(gen, dim: int, heads: int, dim_head: int,
                   qk_norm: Optional[str] = None) -> Params:
    inner = heads * dim_head
    p = {"to_q": init_linear(gen, dim, inner), "to_k": init_linear(gen, dim, inner),
         "to_v": init_linear(gen, dim, inner), "to_out": init_linear(gen, inner, dim)}
    if qk_norm == "rms_norm":
        p["q_norm"] = init_rms_norm(dim_head)
        p["k_norm"] = init_rms_norm(dim_head)
    return p


def attention_inputs(p: Params, context: bool = False) -> list:
    """The projection leaves that read an attention's input: to_qkv, or
    to_q / to_k / to_v (with `context`, the MMDiT's text-stream twins)."""
    suffix = "_c" if context else ""
    names = (f"to_qkv{suffix}",) if f"to_qkv{suffix}" in p else tuple(
        f"to_{t}{suffix}" for t in "qkv")
    return [p[name] for name in names]


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, n, h*d] -> contiguous [b, h, n, d]."""
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).transpose(1, 2).contiguous()


def head_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, n, h*d] (last dimension contiguous) -> its [b, h, n, d] view, no
    copy: K6 reads qk-norm's q and k in place from the projection."""
    b, n, hd = t.shape
    return t.view(b, n, heads, hd // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[b, h, n, d] -> [b, n, h*d]."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def local_heads(heads: int, pe_attn_head: Optional[int], tp=None) -> tuple:
    """(heads, pe_attn_head) of this rank under `tp`: heads // tp of them,
    global heads [rank h, (rank + 1) h); of the first `pe_attn_head` global
    heads that RoPE rotates, those among this rank's. A model axis that does
    not divide the heads raises (the JAX attention falls back to XLA)."""
    if tp is None:
        return heads, pe_attn_head
    if heads % tp.size:
        raise ValueError(f"{heads} heads do not split over a model axis of {tp.size}")
    h = heads // tp.size
    pe = None if pe_attn_head is None else min(max(pe_attn_head - tp.rank * h, 0), h)
    return h, pe


def self_attention(p: Params, x, heads: int, rope_tabs: tuple,
                   lengths: Optional[torch.Tensor] = None,
                   rope_angles: Optional[torch.Tensor] = None,
                   pe_attn_head: Optional[int] = None, tp=None) -> torch.Tensor:
    """x [b, n, dim], or `QuantRows` when every projection of x takes them
    (`takes_quantized`; the block's norm wrote them); rope_tabs = flat (cos, sin) [>=n, h*d] for K3;
    rope_angles [>=n, d] f32 with `pe_attn_head` for the head layout. Rows
    >= lengths of the output are zeroed after to_out.

    The JAX gate (modules.py:399-466). Fused to_qkv without qk-norm, head
    width 64 or 128 with h*d % 128 == 0 (`flat_width_supported`) and up to
    FLAT_ATTN_MAX_N rows (K3 takes any n, where JAX's Pallas body also asks
    n % 128 == 0 and its head-layout branch computes the same function):
    the flat kernel K3 takes the projection as it is. Otherwise the head layout, and K7: past
    the gate (UNetT at the 4096-frame cap: 4097 rows padded to 4224; any
    other head width), with unfused to_q/to_k/to_v, or under qk-norm
    (`q_norm` / `k_norm` leaves, at every n). RoPE goes on the flat projections before the head split, or under
    qk-norm after a per-head RMSNorm (K6, eps 1e-6, reading q and k in
    place from the projection's head view), on the first `pe_attn_head`
    heads. Unfused int8 q / k / v share one quantize of their input (the
    norm's K1Q / K6Q before this), as the JAX package does. Both
    layouts are differentiable: K4 is K3's backward; under grad the head
    layout runs K7's lse mode and K9 (without grad, K7 alone). The
    projections run `tagged("qkv")` (what remat's "attn" policy keeps).
    With `tp`, `heads` / `pe_attn_head` / `rope_tabs` are this rank's
    (`local_heads`) and to_out is reduced over the group."""
    b, n, _ = x.shape
    if tp is not None and not isinstance(x, QuantRows):
        x = copy_to_tp(x, tp)
    lens = (torch.full((b,), n, dtype=torch.int32, device=x.device) if lengths is None
            else lengths.to(torch.int32))
    qkv = None
    if "to_qkv" in p:
        with tagged("qkv"):
            qkv = linear(p["to_qkv"], x)
    if (qkv is not None and "q_norm" not in p and n <= FLAT_ATTN_MAX_N
            and flat_width_supported(heads, qkv.shape[-1] // (3 * heads))):
        o = fused_qkv_rope_attention(qkv.contiguous(), rope_tabs[0], rope_tabs[1], lens, heads)
    else:
        if qkv is not None:
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            with tagged("qkv"):  # int8 to_q / to_k / to_v with the hedge each quantize their rows
                q, k, v = (linear(leaf, x) for leaf in attention_inputs(p))
        if "q_norm" in p:
            q = rms_norm(tp_whole(p["q_norm"], tp), head_view(q, heads))
            k = rms_norm(tp_whole(p["k_norm"], tp), head_view(k, heads))
            q = apply_rotary_partial_heads(q, rope_angles, pe_attn_head)
            k = apply_rotary_partial_heads(k, rope_angles, pe_attn_head)
        else:
            q = split_heads(apply_rotary_flat(q, rope_angles, heads, pe_attn_head), heads)
            k = split_heads(apply_rotary_flat(k, rope_angles, heads, pe_attn_head), heads)
        o = merge_heads(attention(q, k, split_heads(v, heads), lens))
    o = linear(p["to_out"], o, tp)
    if lengths is not None:
        mask = torch.arange(n, device=x.device)[None, :] < lengths[:, None]
        o = torch.where(mask[:, :, None], o, torch.zeros((), dtype=o.dtype, device=o.device))
    return o


# ---------------------------------------------------------------------------
# DiT block
# ---------------------------------------------------------------------------

def init_dit_block(gen, dim: int, heads: int, dim_head: int, ff_mult: int,
                   qk_norm: Optional[str] = None) -> Params:
    return {
        "attn_norm": init_adaln(gen, dim, zero=True),  # AdaLN-zero
        "attn": init_attention(gen, dim, heads, dim_head, qk_norm),
        "ff": init_feed_forward(gen, dim, ff_mult),
    }


def dit_block(p: Params, x: torch.Tensor, mods: torch.Tensor, heads: int,
              rope_tabs: tuple, lengths: Optional[torch.Tensor] = None,
              rope_angles: Optional[torch.Tensor] = None,
              pe_attn_head: Optional[int] = None, tp=None) -> torch.Tensor:
    """mods [b, 6*dim]: shift_msa, scale_msa, gate_msa, shift/scale/gate_mlp.
    With `tp`, p holds this rank's shards and heads / pe_attn_head /
    rope_tabs are its own (`local_heads`)."""
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.chunk(6, dim=-1)
    norm = adaln_pre(x, shift_msa, scale_msa, attention_inputs(p["attn"]))
    x = x + gate_msa[:, None, :] * self_attention(p["attn"], norm, heads, rope_tabs, lengths,
                                                  rope_angles, pe_attn_head, tp)
    norm = adaln_pre(x, shift_mlp, scale_mlp, [p["ff"]["in"]])
    return x + gate_mlp[:, None, :] * feed_forward(p["ff"], norm, tp)


def fuse_attention_qkv(attn: Params, dtype=None) -> Params:
    """Merge to_q/to_k/to_v into one to_qkv linear (output axis concat), and
    MMDiT's context to_q_c/to_k_c/to_v_c into to_qkv_c. `dtype` casts each
    part first, as the training step fuses a per-step view of the f32 params
    straight in the compute dtype; `torch.cat` and `.to` are differentiable,
    so gradients reach the unfused leaves."""
    if "to_qkv" in attn or "to_q" not in attn:
        return attn
    cast = (lambda a: a.to(dtype)) if dtype is not None else (lambda a: a)

    def fuse3(names):
        parts = [attn[k] for k in names]
        fused = {"w": torch.cat([cast(q["w"]) for q in parts], dim=-1)}
        if "b" in parts[0]:
            fused["b"] = torch.cat([cast(q["b"]) for q in parts], dim=-1)
        return fused

    drop = {"to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"}
    out = {k: v for k, v in attn.items() if k not in drop}
    out["to_qkv"] = fuse3(("to_q", "to_k", "to_v"))
    if "to_q_c" in attn:
        out["to_qkv_c"] = fuse3(("to_q_c", "to_k_c", "to_v_c"))
    return out


def fuse_backbone_qkv(params: Params, dtype=None) -> Params:
    """fuse_attention_qkv on every attention a backbone carries: the block
    lists "blocks" (DiT, MMDiT), "first_half" / "second_half" (UNetT) and
    MMDiT's single "last_block"."""
    def fuse(blk):
        return dict(blk, attn=fuse_attention_qkv(blk["attn"], dtype))

    out = dict(params)
    for stack in ("blocks", "first_half", "second_half"):
        if stack in out:
            out[stack] = [fuse(blk) for blk in out[stack]]
    if "last_block" in out:
        out["last_block"] = fuse(out["last_block"])
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in tree_map's order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (in tree_leaves' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_cast(params, dtype=None, device=None):
    """Cast floating leaves to `dtype` and move every leaf to `device`."""
    def cast(a):
        if dtype is not None and a.is_floating_point():
            a = a.to(dtype)
        return a.to(device) if device is not None else a
    return tree_map(cast, params)
