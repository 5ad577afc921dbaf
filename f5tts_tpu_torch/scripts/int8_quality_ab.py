"""int8 W8A8 against bf16: how far the quantized generate drifts (counterpart
of f5tts_tpu/scripts/int8_quality_ab.py).

    python -m f5tts_tpu_torch.scripts.int8_quality_ab [--prompts 20] [--nfe 16 32]
        [--frames 1024] [--outlier-sim [--outlier-scale 100] [--outlier-channels 8]]
        [--smooth] [--ckpt model.safetensors]

F5TTS_v1_Base on the card. Seeded prompts (prompt length in [128, 384)
frames, a duration in [max(prompt + 256, 640), frames], a random cond and
128 random ids) go through two pipelines built from the same weights, bf16
and quantization="int8", each on its one-dispatch generate
(`InferencePipeline.fused_generate`, CFG 2, sway -1, EPSS grid) with the
same noise. Over the generated frames: mel MAE and relative L2, the
log-spectral distance (the mels are log-magnitude already) and the SNR of
the int8 wav against the bf16 one through the same Vocos. On the card the
reference is bf16: the kernels have no f32 path.

Weights: the preset at random from seed 0 with its zero-initialised leaves
randomised (`_activate_zero_init`: a raw AdaLN-zero DiT is the identity, and
int8 against bf16 would compare 0 with 0); `--outlier-sim` scales a fixed
set of residual channels in every block (`_inject_outlier_channels`), the
heavy-tailed channels trained weights develop; `--smooth` quantizes with
the outlier hedge. `--ckpt` reads a reference F5TTS_v1_Base checkpoint
(.safetensors / .pt) instead, through the audited importer
(`compat.convert_backbone_state_dict_audited`: a weight key left unread
raises). Prints one line per NFE and one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def _activate_zero_init(params, gen: torch.Generator):
    """Replace every all-zero float leaf (the AdaLN-zero modulation
    linears, the final norm and projection) with 0.05 N(0, 1), so every
    block contributes through the quantized products."""
    from f5tts_tpu_torch.models.modules import tree_map

    def fill(leaf):
        if leaf.is_floating_point() and leaf.numel() and not bool(leaf.any()):
            return 0.05 * torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype)
        return leaf

    return tree_map(fill, params)


def _inject_outlier_channels(params, gen: torch.Generator, n_channels: int = 8,
                             scale: float = 100.0):
    """Multiply a fixed set of residual-stream channels (the output columns
    of every block's attn.to_out and ff.out, weight and bias) by `scale`,
    the same channels in every block. Both pipelines get the changed
    weights, so the drift measured is the quantization's alone."""
    blocks = params["blocks"]
    dim = blocks[0]["attn"]["to_out"]["w"].shape[-1]
    idx = torch.randperm(dim, generator=gen)[:n_channels]
    mult = torch.ones(dim)
    mult[idx] = scale
    out = []
    for blk in blocks:
        blk = dict(blk)
        for mod, name in (("attn", "to_out"), ("ff", "out")):
            leaf = {k: v * mult if k in ("w", "b") else v for k, v in blk[mod][name].items()}
            blk[mod] = dict(blk[mod], **{name: leaf})
        out.append(blk)
    return dict(params, blocks=out)


def deltas(ref: tuple, test: tuple, prompt: int, dur: int, hop: int = 256) -> dict:
    """ref / test: (mel [1, n, d], wav [1, samples]) as numpy f32; the
    metrics over frames [prompt, dur)."""
    mel_r, mel_t = ref[0][0, prompt:dur], test[0][0, prompt:dur]
    wav_r, wav_t = ref[1][0, prompt * hop: dur * hop], test[1][0, prompt * hop: dur * hop]
    noise = np.sum((wav_r - wav_t) ** 2)
    return {
        "mel_mae": float(np.mean(np.abs(mel_r - mel_t))),
        "mel_rel_l2": float(np.linalg.norm(mel_r - mel_t) / max(np.linalg.norm(mel_r), 1e-9)),
        "lsd": float(np.sqrt(np.mean((mel_r - mel_t) ** 2))),
        "wav_snr_db": float(10 * np.log10(np.sum(wav_r ** 2) / max(noise, 1e-12))),
    }


def summarize(rows: list[dict]) -> dict:
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        out[f"{k}_mean"] = float(np.mean(vals))
        out[f"{k}_worst"] = float(np.min(vals) if "snr" in k else np.max(vals))
    out["prompts"] = len(rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, default=20)
    ap.add_argument("--nfe", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--outlier-sim", action="store_true",
                    help="scale a fixed set of residual channels in every block first")
    ap.add_argument("--outlier-scale", type=float, default=100.0)
    ap.add_argument("--outlier-channels", type=int, default=8)
    ap.add_argument("--smooth", action="store_true", help="quantize with the outlier hedge")
    ap.add_argument("--ckpt", default=None,
                    help="a reference checkpoint to read instead of random weights")
    args = ap.parse_args(argv)

    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.infer.pipeline import InferencePipeline
    from f5tts_tpu_torch.models import cfm
    from f5tts_tpu_torch.ops.quant import quantize_dit_params
    from f5tts_tpu_torch.scripts.common import gpu_name_and_limit
    from f5tts_tpu_torch.utils import make_time_grid, resolve_device
    from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig, init_vocos

    dev = resolve_device(None)
    cfg = PRESETS["F5TTS_v1_Base"]
    arch = dataclasses.replace(cfg.arch, text_num_embeds=2545)
    bdef = cfm.BACKBONES[cfg.backbone]
    if args.ckpt:
        from f5tts_tpu_torch.compat import (convert_backbone_state_dict_audited,
                                            load_torch_checkpoint)

        params, unread = convert_backbone_state_dict_audited(load_torch_checkpoint(args.ckpt),
                                                             arch, cfg.backbone)
        if unread:
            raise SystemExit(f"{args.ckpt}: weight keys the converter does not read: "
                             f"{unread[:5]}")
        weights = "reference"
    else:
        gen = torch.Generator().manual_seed(0)
        params = _activate_zero_init(bdef.init(gen, arch), torch.Generator().manual_seed(42))
        weights = "random-init (AdaLN activated)"
    if args.outlier_sim:
        params = _inject_outlier_channels(params, torch.Generator().manual_seed(7),
                                          args.outlier_channels, args.outlier_scale)
        weights += f" + outlier-sim ({args.outlier_channels}ch x{args.outlier_scale:g})"
    vocoder = Vocos(init_vocos(torch.Generator().manual_seed(1), VocosConfig()), VocosConfig(),
                    device=dev)
    pipes = {q: InferencePipeline(params, bdef.statics_cls(arch), vocoder, tokenizer="byte",
                                  dtype=torch.bfloat16, device=dev, backbone=cfg.backbone,
                                  quantization=q) for q in ("none", "int8")}
    if args.smooth:
        pipes["int8"].params = quantize_dit_params(pipes["none"].params, smooth=True)
        weights += " + smooth"
    del params

    n = args.frames - bdef.seq_extra_tokens
    rng = np.random.default_rng(123)
    report = {}
    for nfe in args.nfe:
        grid = make_time_grid(nfe, sway_sampling_coef=-1.0, use_epss=True)
        rows = []
        for i in range(args.prompts):
            prompt = int(rng.integers(128, 384))
            dur = int(rng.integers(max(prompt + 256, 640), n + 1))
            cond = torch.from_numpy((rng.standard_normal((1, n, 100)) * 0.4).astype(np.float32))
            text = torch.from_numpy(rng.integers(1, 2545, (1, 128)).astype(np.int32))
            duration = torch.tensor([dur], dtype=torch.int32)
            y0 = cfm.make_noise(torch.Generator().manual_seed(i), 1, n, 100, duration)
            out = {}
            for q, pipe in pipes.items():
                mel, wav = pipe.fused_generate(cond, text, torch.tensor([prompt], dtype=torch.int32),
                                               duration, grid, y0, 2.0)
                out[q] = (mel.float().cpu().numpy(), wav.float().cpu().numpy())
            rows.append(deltas(out["none"], out["int8"], prompt, dur))
        report[f"nfe{nfe}"] = {"int8_vs_bf16": summarize(rows)}
        print(f"[int8-ab] nfe{nfe}: {report[f'nfe{nfe}']}", flush=True)
    print(json.dumps({"model": cfg.name, "frames": args.frames, "weights": weights,
                      "device": gpu_name_and_limit(), **report}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
