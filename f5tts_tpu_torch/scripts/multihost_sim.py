"""Multi-process data-parallel training step over `torch.distributed`
(counterpart of f5tts_tpu/scripts/multihost_sim.py).

Every process walks the same deterministic rows (`_row_mel` / `_row_len` /
`_row_text`, the JAX script's), loads only its rows of the global batch
(`train.multihost.process_local_rows`), pads them to the width the rows'
lengths agree on (`global_pad_width`), and runs ONE replicated-state step
and ONE ZeRO-1 step over a data mesh of all processes. Each prints
`RESULT loss=<f> cksum=<f> rows=<a>:<b> devices=<world> z_loss=<f>
z_cksum=<f> z_dist=<0|1> z_local=<elements of mu this rank holds>`: the
processes agree on loss and checksum, and both equal the one-process run
on the whole batch (`tests/test_torch_multihost.py`).

Usage (the card is the default device: one process a card, NCCL):
    torchrun --nproc_per_node=2 -m f5tts_tpu_torch.scripts.multihost_sim
On the CPU (gloo), two processes on a file store:
    python -m f5tts_tpu_torch.scripts.multihost_sim --device cpu --rank 0 --world_size 2 \\
        --init file:///tmp/f5_store &
    python -m f5tts_tpu_torch.scripts.multihost_sim --device cpu --rank 1 --world_size 2 \\
        --init file:///tmp/f5_store
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

GLOBAL_ROWS = 8
N_FRAMES = 64
N_TOKENS = 16
MEL_DIM = 16
VOCAB = 64


def _row_mel(i: int) -> np.ndarray:
    """Row i's mel: any process can make any row, identically (stands in for
    loading the audio of the rows it owns)."""
    rng = np.random.default_rng(1000 + i)
    return rng.standard_normal((N_FRAMES, MEL_DIM)).astype(np.float32)


def _row_len(i: int) -> int:
    return int(N_FRAMES - (i % 3) * 8)


def _row_text(i: int) -> np.ndarray:
    rng = np.random.default_rng(2000 + i)
    return rng.integers(0, VOCAB, (N_TOKENS,)).astype(np.int32)


def run(rank: Optional[int] = None, world_size: Optional[int] = None,
        init: Optional[str] = None, device=None) -> dict:
    """Bring the process group up (unless it is), run one replicated and
    one ZeRO-1 step on this rank's rows; returns the RESULT fields."""
    import torch
    import torch.distributed as dist

    from f5tts_tpu_torch.config import CFMConfig, ModelArch
    from f5tts_tpu_torch.models import dit
    from f5tts_tpu_torch.models import modules as m
    from f5tts_tpu_torch.parallel.mesh import make_mesh, shard_train_state
    from f5tts_tpu_torch.train import multihost
    from f5tts_tpu_torch.train.step import init_train_state, make_optimizer, make_train_step
    from f5tts_tpu_torch.train.train_cli import init_distributed
    from f5tts_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    made = init_distributed(dev, init, rank, world_size)
    try:
        mesh = make_mesh(dist.get_world_size(), 1)
        # the kernels' shapes: 64-wide heads, 8 channels a conv group
        arch = ModelArch(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=MEL_DIM,
                         text_num_embeds=VOCAB, text_dim=32, conv_layers=1)
        params = dit.init_dit(torch.Generator().manual_seed(0), arch)
        statics = dit.DiTStatics(arch, dev)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        step = make_train_step(statics, make_optimizer(1e-4, 10, 100), CFMConfig(), dtype=dtype,
                               mesh=mesh)

        rows = multihost.process_local_rows(mesh, GLOBAL_ROWS)
        width = multihost.global_pad_width([_row_len(i) for i in range(GLOBAL_ROWS)],
                                           bucket_frames=64)
        local = range(rows.start, rows.stop)
        mel = torch.from_numpy(np.stack([_row_mel(i)[:width] for i in local])).to(dev)
        text = torch.from_numpy(np.stack([_row_text(i) for i in local])).to(dev)
        lens = torch.tensor([_row_len(i) for i in local], dtype=torch.int32, device=dev)

        def one_step(zero1: bool):
            state = shard_train_state(init_train_state(params, dev), mesh, zero1)
            gen = torch.Generator(device=dev).manual_seed(1)
            state, metrics = step(state, mel, text, lens, generator=gen)
            cksum = float(sum(float(t.abs().sum()) for t in m.tree_leaves(state.params)))
            return state, float(metrics["loss"]), cksum

        _, loss, cksum = one_step(False)
        z, z_loss, z_cksum = one_step(True)
        total = sum(t.numel() for t in m.tree_leaves(params))
        return {"loss": loss, "cksum": cksum, "rows": (rows.start, rows.stop),
                "devices": mesh.data, "rank": mesh.rank, "z_loss": z_loss, "z_cksum": z_cksum,
                "z_dist": int(z.mu.numel() < total), "z_local": z.mu.numel()}
    finally:
        if made:
            dist.destroy_process_group()


def result_line(r: dict) -> str:
    return (f"RESULT loss={r['loss']:.8f} cksum={r['cksum']:.4f} "
            f"rows={r['rows'][0]}:{r['rows'][1]} devices={r['devices']} "
            f"z_loss={r['z_loss']:.8f} z_cksum={r['z_cksum']:.4f} "
            f"z_dist={r['z_dist']} z_local={r['z_local']}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, default=None, help="default: torchrun's RANK")
    p.add_argument("--world_size", type=int, default=None, help="default: torchrun's WORLD_SIZE")
    p.add_argument("--init", default=None, help="init method (default env://; file:// on the CPU)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)
    r = run(args.rank, args.world_size, args.init, args.device)
    print(result_line(r), flush=True)
    return r


if __name__ == "__main__":
    main()
