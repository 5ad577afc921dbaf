"""Time hand-written kernels of this checkout against the same kernels built
from another checkout, in turns on one card.

    python -m f5tts_tpu_torch.scripts.kernel_ab --other PATH
        [--kernel K1|K1Q|K2|K3|K3_lse|K4|K5|K5_lse|K6|K6Q|K7|K7_lse|K8|K9|K10|K11|K12|K12G|K13 ...]
        [--define NAME=VALUE ...] [--out FILE]

Kernels: K3 and K3_lse (the flat fused QKV + RoPE attention over keys <
length, and its lse mode), K4 (its dQKV backward), K5 and K5_lse (the
key-masked flat attention and its lse mode), K8 (the key-masked dQKV
backward), K7 and K7_lse (the head-layout attention over keys < length,
and its lse mode), K9 (the head-layout backward from a saved lse), K10 (the
generic grouped conv1d + bias), K11 (the key-masked head-layout
attention), K2 (one conv of the conv-position module: conv + bias, length
mask, Mish), K6 (RMSNorm), K1 (AdaLN norm), K12 (the int8 path's per-row
quantize), K1Q / K6Q (K1 / K6 with K12 as their quantize stage), K12G
(K12's GELU mode) and K13 (the int32 dequant + bias); `--kernel` may be
given several times. K1Q, K6Q and K12G need an other checkout that has
their entries (`--other .` with a `--define`). Both checkouts' source
(`f5tts_tpu_torch/csrc/attention.cu` for K3, K5, K7 and K11,
`attention_bwd.cu` for K4, K8 and K9, `grouped_conv.cu` for K10 and K2,
`adaln_norm.cu` for K6, K1 and K12's modes,
`quant.cu` for K13) are
compiled with the port's nvcc flags into a temporary directory (this
checkout's with `-D` of each `--define`, so `--other .` compares two builds
of one source) and loaded with ctypes. Each build's C entry is called with
the signature its own source declares: the pointer parameters are matched
by name (qkv, cos_t, sin_t, lengths / kmask, q, k, v, o / out, lse, dout,
dqkv, dq, dk, dv, k_rot, delta; x, w, bias, y, out, scale, shift; codes,
row_scale, acc, col_scale), the const ones shared
by both builds, the others (outputs and scratch) one set a build, and the
int and float parameters by name too (b, n, heads, sm_scale / scale; c,
width, ksize; rows, n1, n2, s0, s1, s2, d, eps, w_is_f32, scale_stride,
shift_stride; m). So an entry
that takes a scratch the other does not (the k_rot of K3 and K5, which
older sources lack) is timed whole against it, and a K6 build that takes
no strides (no `s0`) is given the contiguous copy of a strided view, made
outside the timing. The saved
`out` / `o` and `lse` of the backwards come from this checkout's K3 / K5 /
K7 lse mode.

Shapes: chip_smoke's phase 2, b = 2, h = 16, d = 64: K3 and K3_lse at n =
1024, 3200, 4096 and K4 at n = 1024, 3072, 4096 with lengths [n, 777]; K5,
K5_lse and K8 at joint n = 1152, 3200, 4352 (1024 / 3072 / 4096 audio + 128 /
128 / 256 text rows, K5's masks); K7, K7_lse and K9 at n = 1024 and 4224,
lengths [n, 777], K9's dO nonzero on every row; K11 on head-layout q, k, v
at joint n = 1152 and 4352 with K5's masks; K10 at [2, 1024, 768] and
[2, 4096, 768] (16 groups of 48, k = 31) and [2, 1024, 384] (16 groups of
24, k = 4) and [1, 1024 / 4096, 1024] (16 groups of 64, k = 31: K2's conv
without its mask and Mish); K2 at [1, 1024, 1024] with lengths 1024 and
777, [2, 1024, 1024] (the CFG batch) and [1, 4096, 1024] with length 3001;
K6 with a bf16 weight at [2, 16, 4096, 64], the same rows as the head view
of q in a [2, 4096, 3072] projection, [2, 16, 256, 64], [2, 1024, 1024] and
[2, 1024, 768]; K1 at [2, 1024 / 4096 / 256, 1024] and [2, 1024 / 4096,
768] with the scale and shift views of a [2, 6 * d] modulation (K1Q too);
K6Q at K6's shapes; K12 at [2, 1024 / 4096, 1024], [2, 1024, 2048 / 4096]
and the text rows of a joint [2, 1280, 1024] output in place; K12G at [2,
1024 / 4096, 2048] and [2, 1024, 4096]; K13 at [2048, 3072 / 1024 / 2048]
and [8192, 3072] with a bf16 bias. At each
shape the entries are timed by CUDA-graph replay (`common.time_ms`) in the
order other, this, this, other. The two outputs
must agree: the forwards' within chip_smoke's 2e-2 (their lse within 1e-3;
K10's and K2's output within 3e-2), the backwards' within its backward tolerance
(rel-L2 <= 1e-2, max-abs <= 2e-2 of the largest entry; two designs may take
delta at different rounding points), the codes and scales of K12's modes
and K13's output bit for bit.
Whether they are bit equal is reported, and each build's `-Xptxas -v` lines
for the kernel's `__global__` functions (registers, shared memory, spills)
and the source's ptxas notes (such as C7520, serialised wgmma).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops import attention as att
from f5tts_tpu_torch.ops._rows import row_layout
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved
from f5tts_tpu_torch.scripts.common import gpu_name_and_limit, time_ms

THIS = Path(__file__).resolve().parents[2]
JOINT = ((1024, 128), (3072, 128), (4096, 256))
CONV = ((2, 1024, 768, 31), (2, 4096, 768, 31), (2, 1024, 384, 4),  # b, n, c, k (16 groups)
        (1, 1024, 1024, 31), (1, 4096, 1024, 31))
CPE = ((1, 1024, 1024, 1024), (1, 1024, 1024, 777), (2, 1024, 1024, 1024),  # b, n, c, length
       (1, 4096, 1024, 3001))
RMS = ((2, 16, 4096, 64), "view", (2, 16, 256, 64), (2, 1024, 1024), (2, 1024, 768))
ADALN = ((1024, 1024), (4096, 1024), (256, 1024), (1024, 768), (4096, 768))  # n, d (b = 2)
QUANT_ROWS = ((2, 1024, 1024), (2, 4096, 1024), (2, 1024, 2048), (2, 1024, 4096), "text")
GELU_ROWS = ((2, 1024, 2048), (2, 4096, 2048), (2, 1024, 4096))
DEQUANT = ((2048, 3072), (2048, 1024), (2048, 2048), (8192, 3072))  # m, n
EXACT = ("K1Q", "K6Q", "K12", "K12G", "K13")  # bit-equal outputs, or the builds disagree
CODES = ("codes", "row_scale")
K3_GLOBALS = r"fused_qkv_rope_attn_(kernel|lse_kernel|krot_kernel)"
K7_GLOBALS = r"_Z\d+flash_attn_(lse_)?kernel"  # not masked_flash_attn_kernel
# kernel: (source, C entry, a pattern found in each of its __global__ names,
# shapes, the outputs compared)
KERNELS = {
    "K3": ("attention.cu", "f5_fused_qkv_rope_attn_bf16", K3_GLOBALS, (1024, 3200, 4096),
           ("out",)),
    "K3_lse": ("attention.cu", "f5_fused_qkv_rope_attn_lse_bf16", K3_GLOBALS, (1024, 3200, 4096),
               ("out", "lse")),
    "K4": ("attention_bwd.cu", "f5_fused_qkv_rope_attn_bwd_bf16", "attn_bwd_",
           (1024, 3072, 4096), ("dqkv",)),
    "K5": ("attention.cu", "f5_fused_qkv_rope_attn_bias_bf16", "fused_qkv_rope_attn_bias",
           JOINT, ("out",)),
    "K5_lse": ("attention.cu", "f5_fused_qkv_rope_attn_bias_lse_bf16",
               "fused_qkv_rope_attn_bias", JOINT, ("out", "lse")),
    "K8": ("attention_bwd.cu", "f5_fused_qkv_rope_attn_bias_bwd_bf16", "attn_bias_bwd_", JOINT,
           ("dqkv",)),
    "K7": ("attention.cu", "f5_flash_attn_bf16", K7_GLOBALS, (1024, 4224), ("out",)),
    "K7_lse": ("attention.cu", "f5_flash_attn_lse_bf16", K7_GLOBALS, (1024, 4224),
               ("out", "lse")),
    "K9": ("attention_bwd.cu", "f5_flash_attn_bwd_bf16", "flash_bwd_", (1024, 4224),
           ("dq", "dk", "dv")),
    "K11": ("attention.cu", "f5_masked_flash_attn_bf16", "masked_flash_attn_kernel",
            JOINT[::2], ("out",)),
    "K10": ("grouped_conv.cu", "f5_grouped_conv1d_bf16", r"grouped_conv1d_kernelILi\d+ELi\d+ELb0|"
            r"_Z\d+grouped_conv1d_kernelILi\d+EEv", CONV, ("y",)),
    "K2": ("grouped_conv.cu", "f5_conv_mish_bf16", r"conv_mish_kernel|grouped_conv1d_kernel\w+Lb1E",
           CPE, ("y",)),
    "K6": ("adaln_norm.cu", "f5_rms_norm_bf16", "rms_norm_kernel|norm_rows_kernelI6RmsEpi", RMS,
           ("out",)),
    "K1": ("adaln_norm.cu", "f5_adaln_norm_bf16", "adaln_norm_kernel|norm_rows_kernelI8AdaLNEpi",
           ADALN, ("out",)),
    "K6Q": ("adaln_norm.cu", "f5_rms_norm_quant_bf16", "QuantI6RmsEpi", RMS, CODES),
    "K1Q": ("adaln_norm.cu", "f5_adaln_norm_quant_bf16", "QuantI8AdaLNEpi", ADALN, CODES),
    "K12": ("adaln_norm.cu", "f5_quant_rows_bf16", r"quant_rows_kernelI(6RowsIn|Li)", QUANT_ROWS,
            CODES),
    "K12G": ("adaln_norm.cu", "f5_gelu_quant_rows_bf16", "quant_rows_kernelI10GeluTanhIn",
             GELU_ROWS, CODES),
    "K13": ("quant.cu", "f5_dequant_bias_bf16", "dequant_bias_kernel", DEQUANT, ("out",)),
}
CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
H = 16


def load(kernel: str, checkout: Path, out_dir: Path, tag: str, defines=()):
    """(the kernel's C entry, its parameters but the stream as (name, kind)
    with kind "const" or "out" for a pointer, else "int" or "float", ptxas'
    resource lines for its __global__ functions) of `checkout`."""
    src_name, entry_name, global_key = KERNELS[kernel][:3]
    so = out_dir / f"{kernel}_{tag}.so"
    src = checkout / "f5tts_tpu_torch" / "csrc" / src_name
    sig = re.search(r'extern "C" int ' + entry_name + r"\(([^)]*)\)", src.read_text())
    params = []
    for decl in sig.group(1).split(",")[:-1]:  # the last is the stream
        name = decl.split()[-1].lstrip("*")
        kind = ("const" if "const" in decl else "out") if "*" in decl else " ".join(
            decl.split()[:-1])
        params.append((name, kind))
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          *(f"-D{d}" for d in defines), "-o", str(so), str(src)],
                         check=True, capture_output=True, text=True)
    entry, usage = "", {}
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and re.search(global_key, entry):
            usage[entry] = "; ".join(filter(None, (usage.get(entry),
                                                   line.split("ptxas info    :")[-1].strip())))
        elif "Performance" in line or "warning" in line:  # e.g. serialised wgmma
            usage.setdefault("notes", []).append(line.strip())
    fn = getattr(ctypes.CDLL(str(so)), entry_name)
    fn.argtypes = [CTYPES.get(kind, ctypes.c_void_p) for _, kind in params] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, params, usage


def joint_kmask(na: int, n: int, dev) -> torch.Tensor:
    """K5's phase-2 key mask at joint n = na audio + text rows: row 0's audio
    live to 777 of 1024 (3/4 of longer buckets) and 100 text keys, row 1's
    audio all live and 120 text keys."""
    kmask = torch.zeros(2, n, dtype=torch.bool, device=dev)
    kmask[0, :777 if na == 1024 else 3 * na // 4] = True
    kmask[0, na:na + 100] = True
    kmask[1, :na] = True
    kmask[1, na:na + 120] = True
    return kmask


def attn_scalars(n: int) -> dict:
    """The int and float parameters of an attention entry (the forwards name
    the scale sm_scale, the backwards scale)."""
    scale = 1.0 / math.sqrt(64)
    return {"b": 2, "n": n, "heads": H, "sm_scale": scale, "scale": scale}


def inputs(kernel: str, shape, dev) -> tuple[dict, str]:
    """The tensors and scalars by parameter name, and the shape's description."""
    rng = np.random.default_rng(0)
    b, hd = 2, H * 64

    def bf16(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)

    def codes_for(t):  # the quantizing entries' outputs
        x = t["x"]
        t.update(codes=torch.empty(x.shape, dtype=torch.int8, device=dev),
                 row_scale=torch.empty(x.shape[:-1], dtype=torch.float32, device=dev))
        return t

    if kernel in ("K1", "K1Q"):
        n, d = shape
        mods = bf16(2, 6 * d) * 0.05
        t = {"x": bf16(2, n, d), "scale": mods[:, d:2 * d], "shift": mods[:, :d], "b": 2, "n": n,
             "d": d, "scale_stride": 6 * d, "shift_stride": 6 * d, "eps": 1e-6}
        t["out"] = torch.empty_like(t["x"])
        return codes_for(t), f"[2, {n}, {d}], scale / shift views of a [2, {6 * d}] modulation"
    if kernel in ("K12", "K12G"):
        if shape == "text":  # the text rows of a joint attention output, in place
            x = bf16(2, 1280, 1024)[:, 1024:]
            what = "[2, 256, 1024], the text rows of a joint [2, 1280, 1024] output"
        else:
            x = bf16(*shape)
            what = f"{list(shape)}"
        t = codes_for({"x": x, "d": x.shape[-1]})
        t.update(zip(("rows", "n1", "n2", "s0", "s1", "s2"), row_layout(x)))
        return t, what
    if kernel == "K13":
        m, n = shape
        gen = torch.Generator(device=dev).manual_seed(m + n)
        t = {"acc": torch.randint(-2**20, 2**20, (m, n), dtype=torch.int32, device=dev,
                                  generator=gen),
             "row_scale": torch.rand(m, device=dev, generator=gen) * 3e-2 + 1e-3,
             "col_scale": torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-4,
             "bias": bf16(n), "out": torch.empty((m, n), dtype=torch.bfloat16, device=dev),
             "m": m, "n": n}
        return t, f"[{m}, {n}] int32 -> bf16, bf16 bias"
    if kernel in ("K6", "K6Q"):
        view = shape == "view"
        shape = (2, 16, 4096, 64) if view else shape
        d = shape[-1]
        if view:  # q's head view inside a fused [b, n, 3 * h * 64] projection
            x = bf16(2, 4096, 3 * H * 64)[..., :H * 64].view(2, 4096, H, 64).transpose(1, 2)
        else:
            x = bf16(*shape)
        w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(
            dev, torch.bfloat16)
        t = {"x": x, "x_contig": x.contiguous(), "w": w, "w_is_f32": 0, "d": d, "eps": 1e-6,
             "out": torch.empty(shape, dtype=torch.bfloat16, device=dev)}
        t.update(zip(("rows", "n1", "n2", "s0", "s1", "s2"), row_layout(x)))
        what = (f"{list(shape)} as the head view of q in [2, 4096, 3072]" if view
                else f"{list(shape)}") + ", bf16 weight"
        return codes_for(t), what
    if kernel == "K2":
        b, n, c, length = shape
        lim = 1.0 / math.sqrt(64 * 31)
        t = {"x": bf16(b, n, c), "b": b, "n": n, "c": c, "ksize": 31,
             "lengths": torch.tensor([length] + [n] * (b - 1), dtype=torch.int32, device=dev)}
        for name, s in (("w", (31, 64, c)), ("bias", (c,))):
            t[name] = torch.from_numpy(rng.uniform(-lim, lim, s).astype(np.float32)).to(
                dev, torch.bfloat16)
        t["y"] = torch.empty_like(t["x"])
        return t, f"[{b}, {n}, {c}], 16 groups of 64, k 31, lengths {t['lengths'].tolist()}"
    if kernel == "K10":
        b, n, c, k = shape
        width = c // 16
        lim = 1.0 / math.sqrt(width * k)
        t = {"x": bf16(b, n, c), "b": b, "n": n, "c": c, "width": width, "ksize": k}
        for name, s in (("w", (k, width, c)), ("bias", (c,))):
            t[name] = torch.from_numpy(rng.uniform(-lim, lim, s).astype(np.float32)).to(
                dev, torch.bfloat16)
        t["y"] = torch.empty_like(t["x"])
        return t, f"[{b}, {n}, {c}], 16 groups of {width}, k {k}"

    if kernel in ("K7", "K7_lse", "K9"):
        n = shape
        t = {name: bf16(b, H, n, 64) for name in ("q", "k", "v", "dout")}
        t["lengths"] = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        if kernel != "K9":
            t["out"] = torch.empty_like(t["q"])
            t["lse"] = torch.empty((b, H, n), dtype=torch.float32, device=dev)
            return t | attn_scalars(n), f"b=2 h=16 d=64 n={n} lengths [{n}, 777], head layout"
        t["o"], t["lse"] = att.flash_attention_fwd(t["q"], t["k"], t["v"], t["lengths"],
                                                   return_lse=True)
        for name in ("dq", "dk", "dv"):
            t[name] = torch.empty_like(t["q"])
        t["delta"] = torch.empty((b, H, n), dtype=torch.float32, device=dev)
        return t | attn_scalars(n), f"b=2 h=16 d=64 n={n} lengths [{n}, 777], dO on every row"
    if kernel == "K11":
        na, nt = shape
        n = na + nt
        t = {name: bf16(b, H, n, 64) for name in ("q", "k", "v")}
        t["kmask"] = joint_kmask(na, n, dev)
        t["out"] = torch.empty_like(t["q"])
        what = f"b=2 h=16 d=64 joint n={n} ({na} audio + {nt} text), head layout"
        return t | attn_scalars(n), what
    n = shape if kernel in ("K3", "K3_lse", "K4") else sum(shape)
    t = {"qkv": bf16(b, n, 3 * hd), "dout": bf16(b, n, hd)}
    if kernel in ("K5", "K5_lse", "K8"):
        na, nt = shape
        kmask = joint_kmask(na, n, dev)
        ang = rope_freqs_interleaved(64, na).to(dev)
        (ca, sa), (ct, st) = (rope_flat_tables(ang, m, H) for m in (na, nt))
        t["cos_t"], t["sin_t"] = torch.cat([ca, ct]).contiguous(), torch.cat([sa, st]).contiguous()
        t["kmask"] = kmask
        t["out"], t["lse"] = att.fused_qkv_rope_attention_bias_fwd(
            t["qkv"], t["cos_t"], t["sin_t"], kmask, H, return_lse=True)
        what = f"b=2 h=16 d=64 joint n={n} ({na} audio + {nt} text)"
    else:
        t["cos_t"], t["sin_t"] = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, H)
        t["lengths"] = torch.tensor([n, 777], dtype=torch.int32, device=dev)
        t["out"], t["lse"] = att.fused_qkv_rope_attention_fwd(
            t["qkv"], t["cos_t"], t["sin_t"], t["lengths"], H, return_lse=True)
        what = f"b=2 h=16 d=64 n={n} lengths [{n}, 777]"
    t["dqkv"] = torch.empty_like(t["qkv"])
    t["k_rot"] = torch.empty((b, H, n, 64), dtype=torch.bfloat16, device=dev)
    t["delta"] = torch.empty((b, H, n), dtype=torch.float32, device=dev)
    return t | attn_scalars(n), what


def agreement(name: str, a: torch.Tensor, w: torch.Tensor, exact: bool = False) -> dict:
    """How `a` (this build's output `name`) agrees with `w` (the other's);
    `exact`: only bit for bit."""
    a, w = a.float(), w.float()
    diff, top = float((a - w).abs().max()), float(w.abs().max())
    rel = float((a - w).norm() / w.norm())
    bit_equal = bool(torch.equal(a, w))
    if exact:
        agree = bit_equal
    elif name in ("out", "lse", "y"):  # a forward's output and row lse, K10's and K2's output
        agree = diff <= {"out": 2e-2, "lse": 1e-3, "y": 3e-2}[name]
    else:
        agree = rel <= 1e-2 and diff <= 2e-2 * top
    return {"bit_equal": bit_equal, "max_abs_diff": diff, "rel_l2": rel,
            "largest_entry": top, "agree": agree}


def run_kernel(kernel: str, other: Path, defines, tmp: Path, dev) -> tuple[dict, bool]:
    """Both builds of `kernel` in turns at each of its shapes."""
    built = {"other": load(kernel, other, tmp, "other"),
             "this": load(kernel, THIS, tmp, "this", defines)}
    result = {"kernel": kernel, "ptxas_other": built["other"][2],
              "ptxas_this": built["this"][2], "shapes": []}
    ok = True
    for shape in KERNELS[kernel][3]:
        shared, what = inputs(kernel, shape, dev)
        own = {tag: {name: shared[name].clone() for name, kind in params if kind == "out"}
               for tag, (_, params, _) in built.items()}

        def call(tag):
            fn, params, _ = built[tag]
            names = {name for name, _ in params}
            args = [own[tag][name] if kind == "out" else
                    shared["x_contig"] if name == "x" and "x_contig" in shared
                    and "s0" not in names else shared[name] for name, kind in params]
            err = fn(*(_build.ptr(a) if isinstance(a, torch.Tensor) else a for a in args),
                     _build.stream_ptr(dev))
            _build.check(err, f"{kernel} ({tag})")

        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            times[tag].append(time_ms(lambda: call(tag), reps=20, iters=25))
        torch.cuda.synchronize()
        row = {"kernel": kernel, "shape": what, "ms_other": times["other"],
               "ms_this": times["this"]}
        for name in KERNELS[kernel][4]:
            row[name] = agreement(name, own["this"][name], own["other"][name], kernel in EXACT)
            ok &= row[name]["agree"]
        result["shapes"].append(row)
        print(json.dumps(row), flush=True)
    return result, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS),
                    help="a kernel to time (default K3); may be repeated")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE for this checkout's build (e.g. BW_WG=1)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    result = {"gpu": gpu_name_and_limit(), "defines": args.define, "kernels": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for kernel in args.kernel or ["K3"]:
            res, good = run_kernel(kernel, Path(args.other).resolve(), args.define, Path(tmp), dev)
            result["kernels"].append(res)
            ok &= good
            print(json.dumps({k: v for k, v in res.items() if k != "shapes"}), flush=True)
    print(json.dumps({"gpu": result["gpu"], "defines": args.define, "agree": ok}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
