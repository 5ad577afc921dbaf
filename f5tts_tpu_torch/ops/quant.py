"""int8 W8A8 inference for the backbone projections (counterpart of
f5tts_tpu/ops/quant.py, the names kept).

The per-token projections of every block (the fused q/k/v, attn-out, ff-in,
ff-out, and the MMDiT's context-stream twins) run as int8 x int8 -> int32
products:
- weights: symmetric per-output-channel int8, quantized once at load
  (`quantize_weight`, f32 amax over the contraction axis, amax / 127, round
  half to even, clip at +-127);
- activations: symmetric per-row int8, scales computed on the fly by kernel
  K12 (csrc/adaln_norm.cu) in one of three modes. The JAX package leaves
  the row quantize to XLA, which fuses its max-reduce into the elementwise
  chain before it; the port fuses it into the pass that makes the rows:
  - the norm before to_qkv and ff.in writes them quantized
    (`ops.adaln_norm.adaln_norm_quant` / `rms_norm_quant`: K1Q / K6Q, the
    row engine's quantize stage);
  - ff.out's input is `gelu_quantize_rows` of ff.in's output (the tanh-GELU
    inside K12: its bf16 output is never written);
  - to_out's input, and rows that carry the outlier hedge, go through
    `quantize_rows` as they lie;
  `QuantRows` carries such pre-quantized rows to `modules.linear`;
- the product: `torch._int_mm` (cuBLASLt s8 x s8 -> s32 on the card; exact
  integer arithmetic on the CPU), the counterpart of the plain XLA
  dot_general the JAX package leaves outside any Pallas kernel;
- the dequant, y = acc * (row_scale * col_scale) + bias in f32, then one
  cast (`dequant_bias`, kernel K13 on the card: csrc/quant.cu).
K12 and K13 have no Pallas counterpart: the JAX package computes both in
XLA. Each wrapper launches its kernel for a CUDA tensor and runs the plain
version (`quantize_rows_ref`, `gelu_quantize_rows_ref`, `dequant_bias_ref`)
for a CPU tensor only; the kernels are bit-equal to the plain versions
(the GELU mode as far as the card's `tanhf` and PyTorch's agree).

`quantize_dit_params` stores `w_i8` as [n, k] (the output channel's codes
contiguous; the product takes its `.t()`), `w_scale` f32 [1, n] and the
bias in the params' dtype. `smooth=True` adds the outlier hedge of the JAX
package (`flag_outlier_channels`, the LLM.int8-style side product).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops._rows import check_rows

Params = dict


def _quantize(x: torch.Tensor, dim: int, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim`: (codes, f32 scale with `dim` kept as 1).
    Both divisions are IEEE divisions on every device (a divisor that is a
    CPU scalar would become a product with its reciprocal on the card).
    With `group`, x is one rank's slice of `dim`: the abs max is the whole's
    (all-reduced over the group)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    if group is not None:
        from f5tts_tpu_torch.parallel.collectives import all_reduce_max

        amax = all_reduce_max(amax, group)
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), amax.new_ones(()))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., k, n] -> (int8 [..., k, n], f32 scale [..., 1, n]): symmetric
    per output channel over the contraction axis (-2); with `group`, w is a
    row-parallel slice of k and the scale is the whole column's."""
    return _quantize(w, -2, group)


def quantize_rows_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12: [..., k] -> (int8 [..., k], f32 scale [..., 1])."""
    return _quantize(x, -1)


def gelu_quantize_rows_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12's GELU mode: `quantize_rows_ref` of the
    tanh-GELU of x (in x's dtype, as `modules.gelu_tanh`)."""
    return quantize_rows_ref(F.gelu(x, approximate="tanh"))


@dataclasses.dataclass(frozen=True)
class QuantRows:
    """Rows handed to int8 projections already quantized: int8 `codes`
    [..., k], f32 `scale` [..., 1], and the `dtype` the rows were made in
    (the projections' output dtype). `modules.linear` takes it for an int8
    leaf without the outlier hedge."""

    codes: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype

    @property
    def shape(self) -> torch.Size:
        return self.codes.shape

    @property
    def device(self) -> torch.device:
        return self.codes.device


@functools.lru_cache(maxsize=None)
def _quant_rows_fn(entry: str):
    fn = getattr(_build.load("adaln_norm"), entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def empty_codes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uninitialised outputs of a row quantize of x: (contiguous int8
    codes like x, f32 scale [..., 1])."""
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device))


def _launch_quant_rows(x: torch.Tensor, entry: str, name: str):
    """K12 in the mode of C entry `entry` on a CUDA x; counted as `name`."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    rows = check_rows(x, name)
    codes, scale = empty_codes(x)
    err = _quant_rows_fn(entry)(_build.ptr(x), _build.ptr(codes), _build.ptr(scale), *rows,
                                x.shape[-1], _build.stream_ptr(x.device))
    _build.check(err, name)
    _build.count(name)
    return codes, scale


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., k] -> (contiguous int8 [..., k], f32 scale [..., 1]): dynamic
    per-row symmetric. Kernel K12 for a CUDA tensor (bf16; the last
    dimension contiguous, rows at up to three leading strides), the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return quantize_rows_ref(x)
    return _launch_quant_rows(x, "f5_quant_rows_bf16", "quantize_rows")


def gelu_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_rows(F.gelu(x, approximate="tanh"))` in one pass, the GELU
    never written: K12's GELU mode for a CUDA tensor (as `quantize_rows`
    takes it), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return gelu_quantize_rows_ref(x)
    return _launch_quant_rows(x, "f5_gelu_quant_rows_bf16", "gelu_quantize_rows")


def dequant_bias_ref(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor,
                     b, out_dtype) -> torch.Tensor:
    """Plain version of K13: acc int32 [m, n], xs f32 [m], w_scale f32 (n
    values), b [n] or None -> (acc * (xs * w_scale) + b) in f32, cast."""
    y = acc.float() * (xs[:, None] * w_scale.reshape(-1))
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


@functools.lru_cache(maxsize=None)
def _dequant_fn():
    fn = _build.load("quant").f5_dequant_bias_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dequant_bias(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor, b,
                 out_dtype) -> torch.Tensor:
    """acc int32 [m, n] -> out_dtype [m, n] = acc * (xs * w_scale) + b.
    Kernel K13 for CUDA tensors (bf16 out and bias), the plain version for
    CPU tensors."""
    if acc.device.type == "cpu":
        return dequant_bias_ref(acc, xs, w_scale, b, out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"dequant_bias: unsupported device {acc.device}")
    m, n = acc.shape
    if (acc.dtype != torch.int32 or xs.dtype != torch.float32 or w_scale.dtype != torch.float32
            or out_dtype != torch.bfloat16 or (b is not None and b.dtype != torch.bfloat16)):
        raise TypeError("dequant_bias kernel takes int32 acc, f32 scales, a bf16 bias and "
                        "gives bf16")
    parts = (acc, xs, w_scale) + (() if b is None else (b,))
    if (not all(t.is_contiguous() and t.device == acc.device and t.data_ptr() % 16 == 0
                for t in parts)
            or xs.numel() != m or w_scale.numel() != n or (b is not None and b.numel() != n)
            or n % 8):
        raise ValueError("dequant_bias kernel takes contiguous, 16-byte aligned operands on "
                         "one device: acc [m, n] with n % 8 == 0, xs [m], w_scale and b [n]")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=acc.device)
    err = _dequant_fn()(_build.ptr(acc), _build.ptr(xs), _build.ptr(w_scale),
                        None if b is None else _build.ptr(b), _build.ptr(out), m, n,
                        _build.stream_ptr(acc.device))
    _build.check(err, "dequant_bias")
    _build.count("dequant_bias")
    return out


def int8_mm(xq: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """xq int8 [m, k] x w_i8 int8 [n, k] -> int32 [m, n], exact:
    `torch._int_mm` (on the card cuBLASLt, which needs m > 16 and k, n
    multiples of 8; every projection of every preset has them)."""
    if xq.device.type == "cuda":
        _build.count("int8_mm")
    return torch._int_mm(xq, w_i8.t())


def int8_linear_pre(p: Params, xq: torch.Tensor, xs: torch.Tensor, out_dtype) -> torch.Tensor:
    """Product + dequant on pre-quantized activations (xq int8 [..., k],
    xs f32 [..., 1]) -> out_dtype [..., n]."""
    k = xq.shape[-1]
    acc = int8_mm(xq.reshape(-1, k), p["w_i8"])
    y = dequant_bias(acc, xs.reshape(-1), p["w_scale"], p.get("b"), out_dtype)
    return y.reshape(*xq.shape[:-1], y.shape[-1])


def int8_linear(p: Params, x) -> torch.Tensor:
    """`modules.linear` for a leaf holding {"w_i8", "w_scale"[, "b"]}; x a
    tensor, or `QuantRows` for a leaf without the hedge.

    A leaf carrying the outlier hedge ({"act_mask", "out_idx", "w_out"},
    `quantize_dit_params(smooth=True)`) runs the LLM.int8-style
    decomposition: the flagged channels are zeroed before the row quantize
    and contribute exactly through a small product over the saved original
    weight rows, y = int8(x * mask) + x[..., idx] @ w_out."""
    if isinstance(x, QuantRows):
        if "act_mask" in p:
            raise ValueError("a leaf with the outlier hedge quantizes its own masked rows: it "
                             "takes no pre-quantized rows")
        return int8_linear_pre(p, x.codes, x.scale, x.dtype)
    if "act_mask" in p:
        xq, xs = quantize_rows(x * p["act_mask"].to(x.dtype))
        y = int8_linear_pre(p, xq, xs, x.dtype)
        return y + x.index_select(-1, p["out_idx"]) @ p["w_out"].to(x.dtype)
    xq, xs = quantize_rows(x)
    return int8_linear_pre(p, xq, xs, x.dtype)


def int8_linear_partial_tp(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """This rank's partial product of a row-parallel int8 leaf under tensor
    parallelism, without the bias (`modules.linear` reduces and adds it):
    x [..., k / tp] is this rank's slice of the rows, quantized with the
    scale of the WHOLE row, as the single-device leaf quantizes it (the
    row's abs max all-reduced over the model group). K12 takes the slice
    with 8 more columns holding that max, so its scale is the whole row's;
    the extra codes are dropped. The dequant is linear, so the reduced
    partials are the single-device output up to the f32 sum's order."""
    from f5tts_tpu_torch.parallel.collectives import all_reduce_max

    k = x.shape[-1]
    amax = all_reduce_max(x.abs().amax(dim=-1, keepdim=True).float(), tp.group)
    padded = x.new_zeros((*x.shape[:-1], k + 8))
    padded[..., :k] = x
    padded[..., k:k + 1] = amax.to(x.dtype)  # a row's value: exact in x's dtype
    codes, scale = quantize_rows(padded)
    return int8_linear_pre({"w_i8": p["w_i8"], "w_scale": p["w_scale"]},
                           codes[..., :k].contiguous(), scale, x.dtype)


_QUANT_LEAVES = (
    ("attn", "to_qkv"), ("attn", "to_qkv_c"),  # inference-fused (modules.fuse_attention_qkv)
    ("attn", "to_q"), ("attn", "to_k"), ("attn", "to_v"), ("attn", "to_out"),
    # MMDiT joint attention (context stream)
    ("attn", "to_q_c"), ("attn", "to_k_c"), ("attn", "to_v_c"), ("attn", "to_out_c"),
    ("ff", "in"), ("ff", "out"),
    # MMDiT dual-stream FFNs
    ("ff_x", "in"), ("ff_x", "out"), ("ff_c", "in"), ("ff_c", "out"),
)

# every block stack a backbone carries: DiT / MMDiT "blocks" (+ MMDiT's
# single "last_block"), UNetT "first_half" / "second_half"
_BLOCK_STACKS = ("blocks", "first_half", "second_half", "last_block")

# residual WRITERS per stream (the columns outliers are visible in): the
# MMDiT keeps two residual streams, audio (x) and context (c), with disjoint
# writer and consumer leaves, so each stream gets its own flag pass
_RESIDUAL_WRITERS = {
    "audio": (("attn", "to_out"), ("ff", "out"), ("ff_x", "out")),
    "context": (("attn", "to_out_c"), ("ff_c", "out")),
}

# residual CONSUMERS eligible for the outlier decomposition, keyed to the
# stream whose flagged channels they read
_SMOOTH_LEAVES = {
    ("attn", "to_qkv"): "audio", ("attn", "to_q"): "audio",
    ("attn", "to_k"): "audio", ("attn", "to_v"): "audio",
    ("ff", "in"): "audio", ("ff_x", "in"): "audio",
    ("attn", "to_qkv_c"): "context", ("attn", "to_q_c"): "context",
    ("attn", "to_k_c"): "context", ("attn", "to_v_c"): "context",
    ("ff_c", "in"): "context",
}


def _blocks(params: Params):
    """Every block dict of every stack (a list of blocks, or one block)."""
    for stack in _BLOCK_STACKS:
        blocks = params.get(stack)
        if isinstance(blocks, dict):
            yield blocks
        elif isinstance(blocks, (list, tuple)):
            yield from blocks


def flag_outlier_channels(params: Params, threshold: float = 4.0, max_channels: int = 16,
                          writers: tuple = None) -> np.ndarray:
    """Statically flag heavy-tailed residual-stream channels: r[c] = rms
    over (layers, rows) of the output columns of the projections that WRITE
    the residual (default the audio stream's; `_RESIDUAL_WRITERS["context"]`
    for the MMDiT's context stream); channels with r > threshold * median
    (at most `max_channels`, largest first). A sorted int32 index array,
    possibly empty."""
    if writers is None:
        writers = _RESIDUAL_WRITERS["audio"]
    sq_sum = None
    count = 0
    for blk in _blocks(params):
        for mod, name in writers:
            leaf = blk.get(mod, {}).get(name)
            if leaf is None or "w" not in leaf:
                continue
            w = leaf["w"].detach().float().cpu().numpy()
            s = np.sum(w * w, axis=tuple(range(w.ndim - 1)))  # [dim]
            sq_sum = s if sq_sum is None else sq_sum + s
            count += int(np.prod(w.shape[:-1]))
    if sq_sum is None:
        return np.zeros((0,), np.int32)
    r = np.sqrt(sq_sum / max(count, 1))
    rel = r / max(float(np.median(r)), 1e-12)
    idx = np.nonzero(rel > threshold)[0]
    if idx.size > max_channels:
        idx = idx[np.argsort(rel[idx])[::-1][:max_channels]]
    return np.sort(idx).astype(np.int32)


def _copy_containers(tree):
    if isinstance(tree, dict):
        return {k: _copy_containers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_containers(v) for v in tree]
    return tree


def quantize_dit_params(params: Params, smooth: bool = False,
                        smooth_threshold: float = 4.0, tp=None) -> Params:
    """Rewrite the per-token projections of every block (`_QUANT_LEAVES`)
    to int8, on the DiT, UNetT (first_half / second_half) and MMDiT (blocks
    + last_block) trees; every other leaf stays as it is. Returns a new tree
    (the input is not changed; untouched leaves are shared).

    `smooth=True` adds the outlier hedge: channels flagged by
    `flag_outlier_channels` are zeroed in the quantized weight of every
    residual-consumer leaf and masked out of its activations before the row
    quantize, and contribute through a product over the saved original
    rows (`w_out`). Nothing changes where no channel passes the
    threshold.

    With `tp` (`parallel.collectives.TP`), params are this rank's
    tensor-parallel shards (`parallel.mesh.shard_params`): a row-parallel
    leaf's scales are taken over the whole contraction axis, so the result
    equals `shard_params` of the quantized whole tree. The hedge is not
    taken under tp (its channel statistics span the shards)."""
    if tp is not None and smooth:
        raise ValueError("quantize_dit_params: smooth=True takes the whole tree, not tp shards")
    from f5tts_tpu_torch.parallel.mesh import _ROW

    params = _copy_containers(params)
    empty = np.zeros((0,), np.int32)
    stream_idx = {s: (flag_outlier_channels(params, smooth_threshold,
                                            writers=_RESIDUAL_WRITERS[s]) if smooth else empty)
                  for s in _RESIDUAL_WRITERS}

    def quantize_leaf(d: Params, stream, row: bool) -> Params:
        w = d["w"]
        out = {}
        out_idx = stream_idx[stream] if stream else empty
        if out_idx.size:
            mask = np.ones((w.shape[-2],), np.float32)
            mask[out_idx] = 0.0
            idx = torch.from_numpy(out_idx).to(w.device)
            out.update(out_idx=idx, act_mask=torch.from_numpy(mask).to(w.device),
                       w_out=w.index_select(-2, idx))
            w = w * torch.from_numpy(mask)[:, None].to(w.device, w.dtype)
        w_i8, scale = quantize_weight(w, tp.group if tp is not None and row else None)
        out.update(w_i8=w_i8.t().contiguous(), w_scale=scale)
        if "b" in d:
            out["b"] = d["b"]
        return out

    for blk in _blocks(params):
        for mod, name in _QUANT_LEAVES:
            if mod in blk and name in blk[mod] and "w" in blk[mod][name]:
                blk[mod][name] = quantize_leaf(blk[mod][name], _SMOOTH_LEAVES.get((mod, name)),
                                               (mod, name) in _ROW)
    return params
