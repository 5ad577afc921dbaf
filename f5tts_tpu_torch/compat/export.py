"""Ahead-of-time export of the sampler and the vocoder (counterpart of
f5tts_tpu/compat/export.py).

`torch.export.export` traces a function once, at fixed shapes, into an
`ExportedProgram`: a graph of aten operators and the port's kernels as
`torch.library` operators (`f5tts::...`, `ops/_operators.py`), with the
weights as its state. `torch.export.save` writes it to one file;
`load_exported` reads it back in any process that imports this package
(the operators register on import of `f5tts_tpu_torch.ops`), and
`run_exported(program, *args)` runs it: on the card the kernels, on the CPU
their plain versions, as the eager port. The JAX package exports its XLA
path to StableHLO; the port has no other path than the kernels, so the
program holds them.

- `export_sampler(...)`: the whole `cfm_sample` (Euler, CFG, the NFE steps
  unrolled) at a fixed (batch, seq_frames, text_len, nfe). Its inputs are
  (cond, text, lens, duration, y0): the noise y0 [batch, seq_frames,
  mel_dim] is an input, where the JAX function takes a PRNG key, because an
  exported program takes no `torch.Generator`. The time grid and the CFG
  strength are constants of the program.
- `export_vocoder(...)`: Vocos decode at a fixed (batch, frames).

An exported program records operators, not torch's TF32 flags: the
vocoder's f32 convolutions run at whatever flags its caller sets, so a
bare `program.module()(*args)` runs them in TF32 under torch's defaults.
`run_exported` holds `precision.full_f32()` around the call, as the eager
vocoder does. The int8 path is not exported (the JAX
exporter has no quantization either).

    python -m f5tts_tpu_torch.compat.export [--model F5TTS_v1_Base] [--nfe 16]
        [--seq-frames 1024] [--text-len 256] [--out DIR] [--device cuda|cpu]

exports a preset's sampler (seeded random weights, `scripts.common.
base_models`, in bf16 on the card, f32 on the CPU) and Vocos into `--out`
(a temporary directory by default, removed after), loads both back and
prints one JSON line: export, save and load seconds and the files' MB.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models.modules import (fuse_backbone_qkv, tree_cast, tree_leaves, tree_map,
                                            tree_unflatten)
from f5tts_tpu_torch.ops.stft import hann_window
from f5tts_tpu_torch.precision import full_f32
from f5tts_tpu_torch.utils import make_time_grid, resolve_device
from f5tts_tpu_torch.vocoder.vocos import VocosConfig, vocos_apply


def _leaf_names(tree, prefix: str = "p") -> list[str]:
    """Buffer names of a tree's leaves in `tree_leaves` order (the keys and
    list indices of each leaf's path joined by "_")."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}_{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}_{i}")]
    return [prefix]


class _TreeModule(torch.nn.Module):
    """A parameter tree held as buffers (the exported program's state)."""

    def __init__(self, params):
        super().__init__()
        self._skeleton = tree_map(lambda _: None, params)
        self._names = _leaf_names(params)
        for name, leaf in zip(self._names, tree_leaves(params)):
            self.register_buffer(name, leaf)

    def tree(self):
        return tree_unflatten(self._skeleton, [getattr(self, n) for n in self._names])


class _Sampler(_TreeModule):
    def __init__(self, params, statics, t_grid, cfg_strength: float, dtype, backbone):
        super().__init__(params)
        self.statics = statics
        self._static_names = [k for k, v in vars(statics).items() if isinstance(v, torch.Tensor)]
        for k in self._static_names:
            self.register_buffer(f"statics_{k}", getattr(statics, k))
        self.register_buffer("t_grid", t_grid)
        self.cfg_strength = cfg_strength
        self.dtype = dtype
        self.backbone = backbone

    def forward(self, cond, text, lens, duration, y0):
        statics = copy.copy(self.statics)
        for k in self._static_names:
            setattr(statics, k, getattr(self, f"statics_{k}"))
        return cfm.cfm_sample(self.tree(), statics, cond, text, lens, duration, self.t_grid,
                              y0=y0, cfg_strength=self.cfg_strength, dtype=self.dtype,
                              backbone=self.backbone)


class _Vocoder(_TreeModule):
    def __init__(self, params, cfg: VocosConfig, device):
        super().__init__(params)
        self.cfg = cfg
        self.register_buffer("window", hann_window(cfg.n_fft, device))

    def forward(self, mel):
        return vocos_apply(self.tree(), mel.transpose(1, 2), self.window, self.cfg.n_fft,
                           self.cfg.hop_length)


def _program(module: torch.nn.Module, args: tuple) -> torch.export.ExportedProgram:
    with torch.no_grad():
        return torch.export.export(module, args, strict=False)


def sampler_program(params: dict, statics, batch: int = 1, seq_frames: int = 1024,
                    text_len: int = 256, nfe: int = 16, sway_sampling_coef: float = -1.0,
                    cfg_strength: float = 2.0, dtype=torch.bfloat16,
                    backbone=None) -> torch.export.ExportedProgram:
    """The `ExportedProgram` that `export_sampler` saves."""
    bdef = cfm.BACKBONES[backbone] if isinstance(backbone, str) else (backbone or cfm.DIT)
    dev = tree_leaves(params)[0].device
    t_grid = make_time_grid(nfe, sway_sampling_coef=sway_sampling_coef).to(dev)
    module = _Sampler(fuse_backbone_qkv(params), statics, t_grid, cfg_strength, dtype, bdef)
    mel_dim = statics.arch.mel_dim
    args = (torch.zeros((batch, seq_frames, mel_dim), dtype=torch.float32, device=dev),
            torch.zeros((batch, text_len), dtype=torch.int32, device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev),
            torch.full((batch,), seq_frames, dtype=torch.int32, device=dev),
            torch.zeros((batch, seq_frames, mel_dim), dtype=torch.float32, device=dev))
    return _program(module, args)


def export_sampler(params: dict, statics, out_path: str, batch: int = 1,
                   seq_frames: int = 1024, text_len: int = 256, nfe: int = 16,
                   sway_sampling_coef: float = -1.0, cfg_strength: float = 2.0,
                   dtype=torch.bfloat16, backbone=None) -> str:
    """Export `cfm_sample` over `params` (a backbone's tree on its device,
    fused QKV or not) and `statics` at a fixed signature to `out_path`. The
    program takes (cond [batch, seq_frames, mel_dim] f32, text [batch,
    text_len] int32 (-1 padded), lens [batch] int32, duration [batch]
    int32, y0 [batch, seq_frames, mel_dim] f32) and returns the mel.
    `backbone` is a `cfm.BackboneDef` or its name (the DiT by default)."""
    torch.export.save(sampler_program(params, statics, batch, seq_frames, text_len, nfe,
                                      sway_sampling_coef, cfg_strength, dtype, backbone),
                      out_path)
    return out_path


def vocoder_program(voc_params: dict, batch: int = 1, frames: int = 1024,
                    cfg: Optional[VocosConfig] = None,
                    device=None) -> torch.export.ExportedProgram:
    """The `ExportedProgram` that `export_vocoder` saves."""
    cfg = cfg or VocosConfig()
    dev = resolve_device(device)
    params = tree_map(lambda a: a.to(device=dev, dtype=torch.float32), voc_params)
    mel = torch.zeros((batch, cfg.input_channels, frames), dtype=torch.float32, device=dev)
    return _program(_Vocoder(params, cfg, dev), (mel,))


def export_vocoder(voc_params: dict, out_path: str, batch: int = 1, frames: int = 1024,
                   cfg: Optional[VocosConfig] = None, device=None) -> str:
    """Export Vocos decode, mel [batch, n_mels, frames] f32 -> wav [batch,
    (frames - 1) * hop], to `out_path`; the weights in f32 on `device` (the
    card unless the caller names one)."""
    torch.export.save(vocoder_program(voc_params, batch, frames, cfg, device), out_path)
    return out_path


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The `ExportedProgram` saved at `path` (`run_exported` runs it)."""
    import f5tts_tpu_torch.ops  # noqa: F401  (registers the f5tts:: operators)

    return torch.export.load(path)


def run_exported(program, *args):
    """Run an exported program (or its `module()`) on `args` with TF32 off,
    as the eager modules run (`precision.full_f32`)."""
    fn = program.module() if isinstance(program, torch.export.ExportedProgram) else program
    with torch.no_grad(), full_f32():
        return fn(*args)


def main(argv=None) -> dict:
    import argparse
    import json
    import os
    import tempfile
    import time

    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.scripts.common import base_models

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--nfe", type=int, default=16)
    p.add_argument("--seq-frames", type=int, default=1024)
    p.add_argument("--text-len", type=int, default=256)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    arch, params, vocos_params = base_models(model=args.model)
    bdef = cfm.BACKBONES[PRESETS[args.model].backbone]
    params = fuse_backbone_qkv(tree_cast(params, dtype, dev))
    statics = bdef.statics_cls(arch, dev)
    row = {"model": args.model, "nfe": args.nfe, "seq_frames": args.seq_frames,
           "text_len": args.text_len, "device": str(dev)}
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        os.makedirs(out, exist_ok=True)
        for name, make in (
                ("sampler", lambda: sampler_program(params, statics, 1, args.seq_frames,
                                                    args.text_len, args.nfe, dtype=dtype,
                                                    backbone=bdef)),
                ("vocoder", lambda: vocoder_program(vocos_params, frames=args.seq_frames,
                                                    device=dev))):
            path = os.path.join(out, f"{name}.pt2")
            t0 = time.perf_counter()
            program = make()
            t1 = time.perf_counter()
            torch.export.save(program, path)
            t2 = time.perf_counter()
            load_exported(path)
            t3 = time.perf_counter()
            row[name] = {"export_s": t1 - t0, "save_s": t2 - t1, "load_s": t3 - t2,
                         "mb": os.path.getsize(path) / 1e6}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
