"""Data-parallel scaling of the sampler and of the train step over
`torch.distributed` processes (counterpart of f5tts_tpu/eval/scaling_bench.py).

Run one process a card (`torchrun --nproc_per_node=N -m
f5tts_tpu_torch.eval.scaling_bench`; NCCL). Each rank samples, or trains
on, `per_device_batch` rows of a global batch of N times that: the sampler
needs no collective, the train step all-reduces its gradients over the data
axis (`parallel.mesh`). Rank 0 first runs the same work alone (its own
one-process group) for throughput(1), then all N ranks run together, and it
prints one JSON line a mode:

    efficiency(N) = throughput(N) / (N x throughput(1))

At N = 1 (a machine with one card) the efficiency column holds a note
instead of a number: it waits for more cards. `device` names the card and
its power limit (`nvidia-smi`), or "cpu"; numbers from CPU processes
(gloo) check the harness, not the scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np

NO_SCALING = "waits for a machine with more than one card"


def _setup(model: str, arch_overrides: dict, dev):
    import torch

    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models.cfm import BACKBONES

    cfg = PRESETS[model]
    arch = dataclasses.replace(cfg.arch, text_num_embeds=256, **arch_overrides)
    bdef = BACKBONES[cfg.backbone]
    gen = torch.Generator().manual_seed(0)
    params = dit.activate_zero_init(bdef.init(gen, arch), gen)
    return arch, bdef, params


def _batch(b: int, frames: int, dev, seed: int = 0) -> dict:
    import torch

    rng = np.random.default_rng(seed)
    return {"cond": torch.from_numpy((rng.standard_normal((b, frames, 100)) * 0.1)
                                     .astype(np.float32)).to(dev),
            "text": torch.from_numpy(rng.integers(1, 256, (b, 64)).astype(np.int32)).to(dev),
            "lens": torch.full((b,), frames // 4, dtype=torch.int32, device=dev),
            "dur": torch.full((b,), frames, dtype=torch.int32, device=dev)}


def _timed(fn, reps: int, group, dev) -> float:
    """Median wall s of fn() over `reps`, every rank of `group` in step."""
    import torch
    import torch.distributed as dist

    fn()  # warm-up: kernels built, allocator warm
    times = []
    for _ in range(reps):
        dist.barrier(group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier(group=group)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_dp_sampling(mesh, arch, bdef, params, dev, seq_frames: int = 256, nfe: int = 2,
                      per_device_batch: int = 2, reps: int = 3) -> dict:
    """This rank's `per_device_batch` utterances through `cfm_sample` (no
    collective); audio s per s over the mesh's data axis."""
    import torch

    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.utils import make_time_grid

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    fused = m.fuse_backbone_qkv(m.tree_cast(params, dtype, dev))
    statics = bdef.statics_cls(arch, dev)
    batch = _batch(per_device_batch, seq_frames, dev, seed=mesh.data_rank)
    t_grid = make_time_grid(nfe, sway_sampling_coef=-1.0, use_epss=False)

    def run():
        mel = cfm.cfm_sample(fused, statics, batch["cond"], batch["text"], batch["lens"],
                             batch["dur"], t_grid, cfg_strength=2.0, dtype=dtype, backbone=bdef,
                             generator=torch.Generator(device=dev).manual_seed(1))
        if not bool(torch.isfinite(mel).all()):
            raise AssertionError("scaling_bench: non-finite mel")

    wall = _timed(run, reps, mesh.data_group, dev)
    b = per_device_batch * mesh.data
    audio_s = b * (seq_frames - seq_frames // 4) * 256 / 24000
    return {"mode": "sample", "devices": mesh.data, "batch": b, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "audio_s_per_s_per_device": audio_s / wall / mesh.data}


def bench_dp_train(mesh, arch, bdef, params, dev, seq_frames: int = 256,
                   per_device_batch: int = 2, reps: int = 3) -> dict:
    """One update on this rank's `per_device_batch` rows, gradients
    all-reduced over the data axis; frames per s over the mesh."""
    import torch

    from f5tts_tpu_torch.parallel.mesh import shard_train_state
    from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    statics = bdef.statics_cls(arch, dev)
    step = make_train_step(statics, make_optimizer(1e-4, 10, 100), dtype=dtype, backbone=bdef,
                           mesh=mesh)
    state = shard_train_state(init_train_state(params, dev), mesh, zero1=False)
    rng = np.random.default_rng(mesh.data_rank)
    mel = torch.from_numpy(rng.standard_normal((per_device_batch, seq_frames, arch.mel_dim))
                           .astype(np.float32)).to(dev)
    batch = _batch(per_device_batch, seq_frames, dev, seed=mesh.data_rank)
    lens = torch.full((per_device_batch,), seq_frames, dtype=torch.int32, device=dev)

    def run():
        _, metrics = step(state, mel, batch["text"], lens,
                          generator=torch.Generator(device=dev).manual_seed(1))
        if not bool(torch.isfinite(metrics["loss"])):
            raise AssertionError("scaling_bench: non-finite loss")

    wall = _timed(run, reps, mesh.data_group, dev)
    frames = per_device_batch * mesh.data * seq_frames
    return {"mode": "train", "devices": mesh.data, "batch": per_device_batch * mesh.data,
            "wall_s": wall, "frames_per_s": frames / wall,
            "frames_per_s_per_device": frames / wall / mesh.data}


def run(modes=("sample", "train"), model: str = "F5TTS_v1_Small", seq_frames: int = 256,
        nfe: int = 2, per_device_batch: int = 2, reps: int = 3, device=None,
        init: Optional[str] = None, rank: Optional[int] = None,
        world_size: Optional[int] = None, arch_overrides: Optional[dict] = None) -> list:
    """Every rank calls it; rank 0 gets the result lines (others [])."""
    import torch.distributed as dist

    from f5tts_tpu_torch.parallel.mesh import Mesh, make_mesh
    from f5tts_tpu_torch.train.train_cli import init_distributed
    from f5tts_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    made = init_distributed(dev, init, rank, world_size)
    try:
        arch, bdef, params = _setup(model, arch_overrides or {}, dev)
        mesh = make_mesh(dist.get_world_size(), 1)
        alone_group = dist.new_group([0])  # every rank creates it; rank 0 runs alone on it
        alone = Mesh(1, 1, 0, data_group=alone_group) if mesh.rank == 0 else None
        if dev.type == "cuda":
            from f5tts_tpu_torch.scripts.common import gpu_name_and_limit

            device_name = gpu_name_and_limit()
        else:
            device_name = "cpu"
        kw = dict(seq_frames=seq_frames, per_device_batch=per_device_batch, reps=reps)
        out = []
        for mode in modes:
            def bench(on):
                if mode == "sample":
                    return bench_dp_sampling(on, arch, bdef, params, dev, nfe=nfe, **kw)
                return bench_dp_train(on, arch, bdef, params, dev, **kw)

            one = bench(alone) if alone is not None else None
            dist.barrier()
            many = bench(mesh)
            if mesh.rank != 0:
                continue
            key = "audio_s_per_s" if mode == "sample" else "frames_per_s"
            many["throughput_1"] = one[key]
            many["scaling_efficiency"] = (many[key] / (mesh.data * one[key]) if mesh.data > 1
                                          else NO_SCALING)
            many["model"], many["device"] = model, device_name
            many["arch_overrides"] = arch_overrides or {}
            out.append(many)
        return out
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=("sample", "train", "both"), default="both")
    p.add_argument("--model", default="F5TTS_v1_Small")
    p.add_argument("--depth", type=int, default=None, help="cut the preset's depth")
    p.add_argument("--seq_frames", type=int, default=256)
    p.add_argument("--nfe", type=int, default=2)
    p.add_argument("--per_device_batch", type=int, default=2)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--init", default=None, help="init method (default env://, torchrun's)")
    args = p.parse_args(argv)
    modes = ("sample", "train") if args.mode == "both" else (args.mode,)
    lines = run(modes, args.model, args.seq_frames, args.nfe, args.per_device_batch, args.reps,
                args.device, args.init,
                arch_overrides={} if args.depth is None else {"depth": args.depth})
    for line in lines:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
