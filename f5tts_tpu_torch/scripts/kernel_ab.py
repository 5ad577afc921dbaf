"""Time kernel K3 (the flat fused QKV + RoPE attention), K4 (its dQKV
backward) or K8 (the key-masked dQKV backward) of this checkout against the
same kernel built from another checkout, in turns on one card.

    python -m f5tts_tpu_torch.scripts.kernel_ab --other PATH [--kernel K3|K4|K8]
        [--define NAME=VALUE ...] [--out FILE]

Both checkouts' source (`f5tts_tpu_torch/csrc/attention.cu` for K3,
`attention_bwd.cu` for K4 and K8) are compiled with the port's nvcc flags
into a temporary directory (this checkout's with `-D` of each `--define`, so
`--other .` compares two builds of one source) and loaded with ctypes. Each
build's C entry is called with the signature its own source declares: the
pointer parameters are matched by name (qkv, cos_t, sin_t, lengths / kmask,
out, lse, dout, dqkv, k_rot, delta), the const ones shared by both builds,
the others (outputs and scratch) one set a build. So a K4 / K8 entry that
takes the forward's `out` and `lse` (the prologue, dk/dv and dq kernels) is
timed whole against one that recomputes the statistics (its pair). `out` and
`lse` come from this checkout's K3 / K5 lse mode.

Shapes: chip_smoke's phase 2, b = 2, h = 16, d = 64: K3 at n = 1024 and K4 at
n = 1024, 3072, 4096 with lengths [n, 777]; K8 at joint n = 1152, 3200, 4352
(1024 / 3072 / 4096 audio + 128 / 128 / 256 text rows, K5's masks). At each
shape the entries are timed by CUDA-graph replay (`common.time_ms`) in the
order other, this, this, other. The two outputs must agree: K3 within
chip_smoke's 2e-2, K4 and K8 within its backward tolerance (rel-L2 <= 1e-2,
max-abs <= 2e-2 of the largest entry; the two designs may take delta at
different rounding points). Whether they are bit equal is reported, and each
build's `-Xptxas -v` lines for the kernel's `__global__` functions
(registers, shared memory, spills). Needs a CUDA device.
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
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved
from f5tts_tpu_torch.scripts.common import gpu_name_and_limit, time_ms

THIS = Path(__file__).resolve().parents[2]
# kernel: (source, C entry, a substring of each of its __global__ names, shapes)
KERNELS = {
    "K3": ("attention.cu", "f5_fused_qkv_rope_attn_bf16", "fused_qkv_rope_attn_kernel", (1024,)),
    "K4": ("attention_bwd.cu", "f5_fused_qkv_rope_attn_bwd_bf16", "attn_bwd_",
           (1024, 3072, 4096)),
    "K8": ("attention_bwd.cu", "f5_fused_qkv_rope_attn_bias_bwd_bf16", "attn_bias_bwd_",
           ((1024, 128), (3072, 128), (4096, 256))),
}
H = 16


def load(kernel: str, checkout: Path, out_dir: Path, tag: str, defines=()):
    """(the kernel's C entry, its pointer parameters as (name, const), ptxas'
    resource lines for its __global__ functions) of `checkout`."""
    src_name, entry_name, global_key, _ = KERNELS[kernel]
    so = out_dir / f"{kernel}_{tag}.so"
    src = checkout / "f5tts_tpu_torch" / "csrc" / src_name
    sig = re.search(r'extern "C" int ' + entry_name + r"\(([^)]*)\)", src.read_text())
    params = [(m.group(2), bool(m.group(1))) for m in
              re.finditer(r"(const )?void\*\s*(\w+)", sig.group(1))][:-1]  # the last is the stream
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          *(f"-D{d}" for d in defines), "-o", str(so), str(src)],
                         check=True, capture_output=True, text=True)
    entry, usage = "", {}
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line and global_key in entry:
            usage[entry] = line.split("ptxas info    :")[-1].strip()
    fn = getattr(ctypes.CDLL(str(so)), entry_name)
    fn.argtypes = [ctypes.c_void_p] * len(params) + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, params, usage


def inputs(kernel: str, shape, dev) -> tuple[dict, str]:
    """The shared tensors by parameter name, and the shape's description."""
    rng = np.random.default_rng(0)
    b, hd = 2, H * 64
    n = shape if kernel != "K8" else sum(shape)

    def bf16(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)

    t = {"qkv": bf16(b, n, 3 * hd), "dout": bf16(b, n, hd)}
    if kernel == "K8":
        na, nt = shape
        kmask = torch.zeros(b, n, dtype=torch.bool, device=dev)
        kmask[0, :777 if na == 1024 else 3 * na // 4] = True
        kmask[0, na:na + 100] = True
        kmask[1, :na] = True
        kmask[1, na:na + 120] = True
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
    return t, what


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernel", default="K3", choices=sorted(KERNELS))
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE for this checkout's build (e.g. BW_WG=1)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    result = {"gpu": gpu_name_and_limit(), "kernel": args.kernel, "defines": args.define,
              "shapes": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        built = {"other": load(args.kernel, Path(args.other).resolve(), Path(tmp), "other"),
                 "this": load(args.kernel, THIS, Path(tmp), "this", args.define)}
        result["ptxas_other"], result["ptxas_this"] = built["other"][2], built["this"][2]
        out_name = "out" if args.kernel == "K3" else "dqkv"
        for shape in KERNELS[args.kernel][3]:
            shared, what = inputs(args.kernel, shape, dev)
            n = shared["qkv"].shape[1]
            own = {tag: {name: shared[name].clone() for name, const in params if not const}
                   for tag, (_, params, _) in built.items()}

            def call(tag):
                fn, params, _ = built[tag]
                ptrs = [own[tag][name] if not const else shared[name] for name, const in params]
                err = fn(*(_build.ptr(t) for t in ptrs), 2, n, H, 1.0 / math.sqrt(64),
                         _build.stream_ptr(dev))
                _build.check(err, f"{args.kernel} ({tag})")

            times = {"other": [], "this": []}
            for tag in ("other", "this", "this", "other"):
                times[tag].append(time_ms(lambda: call(tag), reps=20, iters=25))
            torch.cuda.synchronize()
            a, w = own["this"][out_name].float(), own["other"][out_name].float()
            diff, top = float((a - w).abs().max()), float(w.abs().max())
            rel = float((a - w).norm() / w.norm())
            agree = diff <= 2e-2 if args.kernel == "K3" else (rel <= 1e-2 and diff <= 2e-2 * top)
            ok &= agree
            row = {"shape": what, "ms_other": times["other"], "ms_this": times["this"],
                   "bit_equal": bool(torch.equal(a, w)), "max_abs_diff": diff, "rel_l2": rel,
                   "largest_entry": top, "agree": agree}
            result["shapes"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "shapes"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
