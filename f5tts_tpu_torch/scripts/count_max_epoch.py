"""Epoch budget calculators (counterpart of f5tts_tpu/scripts/count_max_epoch.py).

Rebuild of reference src/f5_tts/scripts/count_max_epoch.py (analytic) and
count_max_epoch_precise.py (via an instantiated sampler): given a corpus size
in hours and the frame-budget batch configuration, how many updates one epoch
costs and how many epochs fit a total update budget. `precise` packs the
port's `DynamicBatchSampler`.

Usage:
    python -m f5tts_tpu_torch.scripts.count_max_epoch --total_hours 100
"""

from __future__ import annotations

import argparse


def analytic(
    total_hours: float = 95_282.0,
    mel_hop: int = 256,
    mel_sr: int = 24_000,
    frames_per_update: int = 307_200,   # 38400/gpu * 8
    grad_accum: int = 1,
    total_updates: int = 1_200_000,
) -> dict:
    total_frames = total_hours * 3600 * mel_sr / mel_hop
    updates_per_epoch = total_frames / (frames_per_update * grad_accum)
    return {
        "updates_per_epoch": int(updates_per_epoch),
        "max_epochs": total_updates / updates_per_epoch,
        "audio_minutes_per_update": frames_per_update * mel_hop / mel_sr / 60.0,
    }


def precise(frame_lens: list[float], frames_threshold: int, max_samples: int = 64,
            grad_accum: int = 1, total_updates: int = 1_200_000) -> dict:
    from f5tts_tpu_torch.train.dataset import DynamicBatchSampler

    sampler = DynamicBatchSampler(frame_lens, frames_threshold, max_samples)
    updates_per_epoch = max(len(sampler) // grad_accum, 1)
    return {"updates_per_epoch": updates_per_epoch,
            "max_epochs": total_updates / updates_per_epoch}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--total_hours", type=float, default=95_282.0)
    p.add_argument("--frames_per_update", type=int, default=307_200)
    p.add_argument("--total_updates", type=int, default=1_200_000)
    args = p.parse_args(argv)
    print(analytic(args.total_hours, frames_per_update=args.frames_per_update,
                   total_updates=args.total_updates))


if __name__ == "__main__":
    main()
