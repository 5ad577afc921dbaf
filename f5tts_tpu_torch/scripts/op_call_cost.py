"""What one eager call of a kernel through its `f5tts::` operator costs the host.

    python -m f5tts_tpu_torch.scripts.op_call_cost [--iters 200] [--rounds 5]
        [--device cuda|cpu] [--out op_call_cost.json]

K1 (adaln_norm), K3 (fused_qkv_rope_attention) and K2 (conv_pos_embedding)
at the 1024 bucket's CFG-packed shapes of F5TTS_v1_Base (b 2, n 1024, dim
1024, 16 heads, bf16), each reached three ways:
- `direct`: the operator's implementation called as a Python function (the
  kernel's wrapper with no dispatcher in front);
- `operator`: the `f5tts::` operator as the port registers it
  (`ops/_operators.py`: a `torch.library.Library` implementation for the
  CPU and CUDA keys);
- `custom_op`: the same implementation registered with
  `torch.library.custom_op` (namespace f5tts_cost), torch's other way.
Each way, `iters` calls back to back under no_grad, the host's microseconds
a call up to the last launch (`host_us`) and up to a device sync after it
(`wall_us`); medians of `rounds` rounds, the three ways in turns. `host_us`
is what an eager path pays a call while the launch queue has room;
`wall_us` is the kernel's own time where the host keeps ahead of it. The
three outputs of a way are checked equal. One JSON line, with the card's
name and power limit. Runs on the card unless `--device cpu` (the plain
versions; host numbers only).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from f5tts_tpu_torch.ops._operators import IMPLEMENTATIONS, OPERATORS
from f5tts_tpu_torch.utils import resolve_device

NAMES = ("adaln_norm", "fused_qkv_rope_attention", "conv_pos_embedding")


def inputs(dev, b: int = 2, n: int = 1024, dim: int = 1024, heads: int = 16,
           kernel: int = 31, seed: int = 24) -> dict:
    """Each operator's arguments at [b, n, dim], bf16, from a seeded CPU draw."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

    x = r(b, n, dim)
    lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
    width = dim // heads
    return {"adaln_norm": (x, r(b, dim), r(b, dim), 1e-6),
            "fused_qkv_rope_attention": (r(b, n, 3 * dim), r(n, dim), r(n, dim), lengths, heads),
            "conv_pos_embedding": (x, r(kernel, width, dim), r(dim), r(kernel, width, dim),
                                   r(dim), lengths, heads)}


def custom_ops() -> dict:
    """The same implementations registered with torch.library.custom_op."""
    ops = {}
    for name in NAMES:
        if not hasattr(torch.ops.f5tts_cost, name):
            schema = str(OPERATORS[name]._schema)
            torch.library.custom_op(f"f5tts_cost::{name}", IMPLEMENTATIONS[name], mutates_args=(),
                                    schema=schema[schema.index("("):])
        ops[name] = getattr(torch.ops.f5tts_cost, name).default
    return ops


def call_costs(dev, iters: int = 200, rounds: int = 5, **shapes) -> dict:
    """{name: {way: {host_us, wall_us}}} for the three operators."""
    args = inputs(dev, **shapes)
    cost_ops = custom_ops()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    with torch.no_grad():
        for name in NAMES:
            ways = {"direct": IMPLEMENTATIONS[name], "operator": OPERATORS[name],
                    "custom_op": cost_ops[name]}
            first = {way: fn(*args[name]) for way, fn in ways.items()}
            if not all(torch.equal(v, first["direct"]) for v in first.values()):
                raise AssertionError(f"{name}: the three ways disagree")
            times = {way: ([], []) for way in ways}
            for _ in range(rounds):
                for way, fn in ways.items():
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn(*args[name])
                    t1 = time.perf_counter()
                    sync()
                    t2 = time.perf_counter()
                    times[way][0].append((t1 - t0) / iters * 1e6)
                    times[way][1].append((t2 - t0) / iters * 1e6)
            out[name] = {way: {"host_us": statistics.median(h), "wall_us": statistics.median(w)}
                         for way, (h, w) in times.items()}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gpu = "cpu"
    if dev.type == "cuda":
        from f5tts_tpu_torch.scripts.common import gpu_name_and_limit

        gpu = gpu_name_and_limit()
    row = {"gpu": gpu, "iters": args.iters, "rounds": args.rounds,
           "calls": call_costs(dev, args.iters, args.rounds)}
    line = json.dumps(row)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return row


if __name__ == "__main__":
    main()
