"""Time kernel K3 (the flat fused QKV + RoPE attention) or K4 (its dQKV
backward) of this checkout against the same kernel built from another
checkout, in turns on one card.

    python -m f5tts_tpu_torch.scripts.kernel_ab --other PATH [--kernel K3|K4] [--out FILE]

Both checkouts' source (`f5tts_tpu_torch/csrc/attention.cu` for K3,
`attention_bwd.cu` for K4) are compiled with the port's nvcc flags into a
temporary directory and loaded with ctypes; their C entry is timed by
CUDA-graph replay (`common.time_ms`) at chip_smoke's phase-2 shape, b = 2,
h = 16, n = 1024, lengths [1024, 777], in the order other, this, this,
other. The two outputs must agree within chip_smoke's tolerance (2e-2);
whether they are bit equal is reported, and each build's `-Xptxas -v` lines
for the kernel's `__global__` functions (registers, shared memory). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from f5tts_tpu_torch.ops import _build
from f5tts_tpu_torch.ops.rope import rope_flat_tables, rope_freqs_interleaved
from f5tts_tpu_torch.scripts.common import gpu_name_and_limit, time_ms

THIS = Path(__file__).resolve().parents[2]
# kernel: (source, C entry, pointer arguments, its __global__ functions)
KERNELS = {
    "K3": ("attention.cu", "f5_fused_qkv_rope_attn_bf16", 5, ("fused_qkv_rope_attn_kernel",)),
    "K4": ("attention_bwd.cu", "f5_fused_qkv_rope_attn_bwd_bf16", 8,
           ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")),
}


def load(kernel: str, checkout: Path, out_dir: Path, tag: str):
    """(the kernel's C entry, ptxas' resource lines for its __global__
    functions) of `checkout`."""
    src_name, entry_name, n_ptrs, globals_ = KERNELS[kernel]
    so = out_dir / f"{kernel}_{tag}.so"
    src = checkout / "f5tts_tpu_torch" / "csrc" / src_name
    log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                          str(src)], check=True, capture_output=True, text=True)
    entry, usage = "", {}
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "registers" in line:
            for g in globals_:
                if f"{len(g)}{g}" in entry:  # the mangled name: length, then the name
                    usage[g] = line.split("ptxas info    :")[-1].strip()
    fn = getattr(ctypes.CDLL(str(so)), entry_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, usage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--kernel", default="K3", choices=sorted(KERNELS))
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    b, h, n = 2, 16, 1024
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * 64)).astype(np.float32)).to(dev, torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((b, n, h * 64)).astype(np.float32)).to(dev, torch.bfloat16)
    cos, sin = rope_flat_tables(rope_freqs_interleaved(64, n).to(dev), n, h)
    lengths = torch.tensor([n, 777], dtype=torch.int32, device=dev)
    scratch = [torch.empty(b, h, n, dtype=torch.float32, device=dev) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        built = {"other": load(args.kernel, Path(args.other).resolve(), Path(tmp), "other"),
                 "this": load(args.kernel, THIS, Path(tmp), "this")}
        fns = {tag: fn for tag, (fn, _) in built.items()}
        outs = {}

        def call(tag):
            if args.kernel == "K3":
                out = outs.setdefault(tag, torch.empty(b, n, h * 64, dtype=torch.bfloat16, device=dev))
                ptrs = (qkv, cos, sin, lengths, out)
            else:
                out = outs.setdefault(tag, torch.empty_like(qkv))
                ptrs = (qkv, cos, sin, lengths, dout, out, *scratch)
            err = fns[tag](*(_build.ptr(t) for t in ptrs), b, n, h, 1.0 / math.sqrt(64),
                           _build.stream_ptr(dev))
            _build.check(err, f"{args.kernel} ({tag})")

        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            times[tag].append(time_ms(lambda: call(tag), reps=20, iters=25))
        torch.cuda.synchronize()
        same = bool(torch.equal(outs["this"], outs["other"]))
        diff = float((outs["this"].float() - outs["other"].float()).abs().max())
    result = {"gpu": gpu_name_and_limit(), "kernel": args.kernel,
              "shape": "b=2 h=16 d=64 n=1024 lengths [1024, 777]",
              "ms_other": times["other"], "ms_this": times["this"], "bit_equal": same,
              "max_abs_diff": diff, "ptxas_other": built["other"][1],
              "ptxas_this": built["this"][1]}
    print(json.dumps(result))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if diff <= 2e-2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
