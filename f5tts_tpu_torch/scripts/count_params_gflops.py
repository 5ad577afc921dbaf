"""Model size and FLOPs of one backbone forward (counterpart of
f5tts_tpu/scripts/count_params_gflops.py).

    python -m f5tts_tpu_torch.scripts.count_params_gflops [--model F5TTS_v1_Base]
        [--secs 20] [--vocab 2545] [--device cuda|cpu]

Rebuild of the reference's src/f5_tts/scripts/count_params_gflops.py (thop
over the CFM forward). Parameters are counted over the port's param tree of
the preset (random weights from seed 0, text_num_embeds = `vocab`); FLOPs
come from `torch.utils.flop_counter.FlopCounterMode` over one backbone
forward of one sample: `secs` of mel (24 kHz, hop 256) and 128 text ids, no
CFG, t = 0.5, on the card in bf16 (the kernels) or on the CPU in f32 (their
plain versions). The kernels are `torch.library` operators with FLOP
formulas (`ops/_operators.py`), so the count is the same on both.
`FlopCounterMode` counts 2 FLOPs a multiply-add of every matmul and
convolution, the attention's two products included, and nothing
elementwise. The reference's numbers (:21-36) are thop's: multiply-adds of
the nn.Linear and nn.Conv1d modules only, its functional attention
uncounted; `main` prints them beside the port's, with the port's count cut
to what thop counts (the products outside the attention, halved).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from f5tts_tpu_torch.config import PRESETS
from f5tts_tpu_torch.models.cfm import BACKBONES
from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast, tree_leaves
from f5tts_tpu_torch.ops._operators import OPERATORS
from f5tts_tpu_torch.utils import resolve_device

# the reference's printed numbers: (params M, GFLOPs of 20 s, thop's count)
REFERENCE = {"F5TTS_v1_Base": ("DiT-Base", 335.8, 363.4),
             "F5TTS_Base": ("DiT-Base", 335.8, 363.4),
             "E2TTS_Base": ("UNetT-Base", 333.2, 622.1)}
TEXT_IDS = 128


def count(model: str = "F5TTS_v1_Base", secs: float = 20.0, vocab: int = 2545,
          device=None) -> tuple[int, dict, int]:
    """(parameters, FlopCounterMode's FLOPs by operator, frames) of one
    forward of the preset `model` on `device` (the card unless the caller
    names one)."""
    mcfg = PRESETS[model]
    arch = dataclasses.replace(mcfg.arch, text_num_embeds=vocab)
    bd = BACKBONES[mcfg.backbone]
    params = bd.init(torch.Generator().manual_seed(0), arch)
    n_params = sum(t.numel() for t in tree_leaves(params))
    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = fuse_backbone_qkv(tree_cast(params, dtype, dev))
    statics = bd.statics_cls(arch, dev)

    frames = int(secs * 24000 / 256)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, frames, arch.mel_dim)).astype(np.float32)).to(dev)
    text = torch.from_numpy(rng.integers(0, vocab, (1, TEXT_IDS)).astype(np.int32)).to(dev)
    t = torch.tensor([0.5], dtype=torch.float32, device=dev)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        bd.forward(params, statics, x, torch.zeros_like(x), text, t, dtype=dtype)
    flops = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    return n_params, flops, frames


def analyze(model: str = "F5TTS_v1_Base", secs: float = 20.0, vocab: int = 2545,
            device=None) -> dict:
    """{model, params, params_M, gflops_fwd, frames} of the preset `model`."""
    n_params, flops, frames = count(model, secs, vocab, device)
    return {"model": model, "params": n_params, "params_M": n_params / 1e6,
            "gflops_fwd": sum(flops.values()) / 1e9, "frames": frames}


def attention_flops(flops: dict) -> int:
    """The FLOPs of the attention operators among `count`'s."""
    names = {f"f5tts.{name}" for name in OPERATORS if "attention" in name}
    return sum(n for op, n in flops.items() if op in names)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--secs", type=float, default=20.0)
    p.add_argument("--vocab", type=int, default=2545)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    n_params, flops, frames = count(args.model, args.secs, args.vocab, args.device)
    row = {"model": args.model, "params": n_params, "params_M": n_params / 1e6,
           "gflops_fwd": sum(flops.values()) / 1e9, "frames": frames,
           "gflops_attention": attention_flops(flops) / 1e9,
           "gmacs_outside_attention": (sum(flops.values()) - attention_flops(flops)) / 2e9,
           "flops_by_op": flops}
    if args.model in REFERENCE and args.secs == 20.0:
        name, params_m, gflops = REFERENCE[args.model]
        row["reference"] = {"model": name, "params_M": params_m, "thop_gflops_20s": gflops}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
