"""One-command weights-level parity gate against a reference checkpoint
(counterpart of f5tts_tpu/scripts/parity_check.py, the same CLI and legs).

    python -m f5tts_tpu_torch.scripts.parity_check --ckpt model_1250000.safetensors \
        [--model F5TTS_v1_Base] [--vocab path] [--nfe 16 32] [--golden golden.npz]
        [--write-golden out.npz] [--mirror-golden] [--full] [--vocos_ckpt ...]
        [--bigvgan_ckpt ...] [--ecapa_ckpt ...] [--utmos_ckpt ...] [--smooth]
        [--workdir .] [--device cuda|cpu]

1. Digestion audit: the checkpoint through the port's audited converter
   (`compat.convert_backbone_state_dict_audited`); any weight tensor left
   unread fails (a dropped weight means wrong audio and no error).
2. Fixed-seed sampling: `cfm_sample` at 16 and 32 NFE (Euler, CFG 2, sway
   -1, the reference's eval protocol) on `build_fixed_inputs` (the JAX
   script's numpy draws), the noise from a seeded CPU `torch.Generator`;
   on the card in bf16 (the kernels), on the CPU in f32. Prints checksums.
3. Golden comparison: `--golden` (an npz with the JAX keys nfe16 / nfe32)
   allclose, `--write-golden` saves this run's mels.
`--mirror-golden` (and `--full`) compares the port's `cfm_sample` with
tests/torch_mirror.py's independent `t_cfm_sample` (torch and numpy only)
on the same weights and noise, both in f32 on the CPU. `--full` also runs
the vocoder decode (finite, not silent), the int8 A/B (mel rel-L2 < 10%)
and the WER / SIM / UTMOS smoke (SKIP without weights). Exits 0, or 2 when
a leg fails. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from f5tts_tpu_torch.models import cfm
from f5tts_tpu_torch.models.modules import fuse_backbone_qkv, tree_cast, tree_leaves, tree_unflatten
from f5tts_tpu_torch.utils import make_time_grid, resolve_device


def build_fixed_inputs(arch, n: int = 1024, nt: int = 64, b: int = 1, seed: int = 0):
    """(cond, text, lens, duration) as numpy arrays, the JAX script's draws."""
    rng = np.random.default_rng(seed)
    cond = (rng.standard_normal((b, n, arch.mel_dim)) * 0.5).astype(np.float32)
    text = rng.integers(1, arch.text_num_embeds, (b, nt)).astype(np.int32)
    lens = np.full((b,), n // 4, np.int32)       # 1/4 prompt
    duration = np.full((b,), n, np.int32)
    return cond, text, lens, duration


def fixed_noise(arch, duration: np.ndarray, n: int, seed: int = 0) -> torch.Tensor:
    """`make_noise` from a CPU `torch.Generator` seeded with `seed`, on the CPU."""
    return cfm.make_noise(torch.Generator().manual_seed(seed), len(duration), n, arch.mel_dim,
                          torch.from_numpy(duration))


def _sample(params, statics, backbone: str, nfe: int, n: int, nt: int, dev, dtype,
            seed: int = 0, fused=None) -> np.ndarray:
    arch = statics.arch
    cond, text, lens, duration = build_fixed_inputs(arch, n=n, nt=nt)
    y0 = fixed_noise(arch, duration, n, seed)
    tree = fused if fused is not None else tree_cast(fuse_backbone_qkv(params), dtype, dev)
    mel = cfm.cfm_sample(tree, statics, *(torch.from_numpy(a).to(dev)
                                          for a in (cond, text, lens, duration)),
                         make_time_grid(nfe, sway_sampling_coef=-1.0).to(dev), y0=y0.to(dev),
                         cfg_strength=2.0, method="euler", dtype=dtype,
                         backbone=cfm.BACKBONES[backbone])
    return mel.float().cpu().numpy()


def _hp_dtype(dev) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def run_configs(params, statics, nfe_list, seed: int = 0, dtype=None, device=None,
                backbone: str = "DiT") -> dict:
    """{"nfe<k>": mel [1, 1024, mel_dim] f32} at each NFE of `nfe_list`."""
    dev = resolve_device(device)
    dtype = dtype or _hp_dtype(dev)
    fused = tree_cast(fuse_backbone_qkv(params), dtype, dev)
    return {f"nfe{nfe}": _sample(params, statics, backbone, nfe, 1024, 64, dev, dtype, seed,
                                 fused) for nfe in nfe_list}


def _mirror_tree(params) -> dict:
    """The port's tree as the mirror (and the JAX package) lays it out:
    numpy leaves, the block lists stacked on a leading depth axis."""
    def stack(blocks):
        leaves = [np.stack([a.detach().float().cpu().numpy() for a in group])
                  for group in zip(*(tree_leaves(b) for b in blocks))]
        return tree_unflatten(blocks[0], leaves)

    return {k: stack(v) if isinstance(v, list) else
            tree_unflatten(v, [a.detach().float().cpu().numpy() for a in tree_leaves(v)])
            for k, v in params.items()}


def run_mirror_golden(params, statics, backbone: str, n: int = 256,
                      nfe: int = 7, atol: float = 2e-2, rtol: float = 2e-2) -> int:
    """The port's `cfm_sample` against tests/torch_mirror.py's independent
    `t_cfm_sample` (Euler + EPSS + sway + CFG + cond re-imposition) on the
    same weights and noise, both in f32 on the CPU. Returns 0 / 2."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    try:
        from tests import torch_mirror as tm
    except ImportError as e:
        print(f"[parity] mirror golden needs the repo checkout (tests/): {e}")
        return 2

    forwards = {"DiT": tm.t_dit_forward, "UNetT": tm.t_unett_forward}
    if backbone not in forwards:
        print(f"[parity] no torch mirror for backbone {backbone}; skipping")
        return 0
    arch = statics.arch
    cpu = torch.device("cpu")
    cpu_statics = cfm.BACKBONES[backbone].statics_cls(arch, cpu)
    nt = min(n // 4, 64)
    mel_port = _sample(params, cpu_statics, backbone, nfe, n, nt, cpu, torch.float32)
    cond, text, lens, duration = build_fixed_inputs(arch, n=n, nt=nt)
    mel_t = tm.t_cfm_sample(
        forwards[backbone], _mirror_tree(params), arch, torch.from_numpy(cond),
        torch.from_numpy(text).long(), torch.from_numpy(lens), torch.from_numpy(duration),
        fixed_noise(arch, duration, n), tm.t_time_grid(nfe, sway_sampling_coef=-1.0),
        cfg_strength=2.0).numpy()
    d = np.abs(mel_port - mel_t)
    ok = np.allclose(mel_port, mel_t, atol=atol, rtol=rtol)
    print(f"[parity] mirror golden ({backbone}, n={n}, nfe={nfe}): "
          f"max|d|={d.max():.4e} mean|d|={d.mean():.4e} {'OK' if ok else 'FAIL'}")
    return 0 if ok else 2


def _vocoder(kind: str, ckpt_path: str, dev, voc_cfg=None):
    from f5tts_tpu_torch.compat.torch_import import convert_vocos_state_dict, load_torch_checkpoint

    sd = load_torch_checkpoint(ckpt_path)
    if kind == "vocos":
        from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig

        cfg = voc_cfg or VocosConfig()
        return Vocos(convert_vocos_state_dict(sd, num_layers=cfg.num_layers), cfg, device=dev)
    from f5tts_tpu_torch.vocoder.bigvgan import BigVGAN, BigVGANConfig, convert_bigvgan_state_dict

    cfg = voc_cfg or BigVGANConfig()
    return BigVGAN(convert_bigvgan_state_dict(sd, cfg), cfg, device=dev)


def leg_vocoder_decode(outs: dict, kind: str, ckpt_path: str, voc_cfg=None,
                       device=None) -> tuple[str, str]:
    """Decode this run's first mel through a converted vocoder (kind vocos |
    bigvgan) on `device` and check the waveform: finite, not silent.
    `voc_cfg` overrides the full-size config (tests use a tiny one)."""
    dev = resolve_device(device)
    mel = torch.from_numpy(next(iter(outs.values()))).to(dev)  # [b, n, d]
    wav = _vocoder(kind, ckpt_path, dev, voc_cfg)(mel.transpose(1, 2)).cpu().numpy()
    if not np.all(np.isfinite(wav)):
        return "FAIL", f"{kind}: non-finite waveform"
    rms = float(np.sqrt(np.mean(wav ** 2)))
    if rms <= 1e-7:
        return "FAIL", f"{kind}: silent waveform (rms {rms:.2e})"
    return "OK", f"{kind}: wav {wav.shape}, rms {rms:.4f}"


def leg_int8_ab(params, statics, nfe: int = 16, n: int = 512, smooth: bool = False,
                device=None, backbone: str = "DiT") -> tuple[str, str]:
    """int8 against the high-precision sampler on these weights, the same
    noise: mel rel-L2 and SNR at the serving NFE; passes below 10% rel-L2."""
    from f5tts_tpu_torch.ops.quant import quantize_dit_params

    dev = resolve_device(device)
    hp = _hp_dtype(dev)
    fused = fuse_backbone_qkv(tree_cast(params, hp, dev))  # the pipeline's order
    nt = min(n // 4, 64)
    mel_hp = _sample(params, statics, backbone, nfe, n, nt, dev, hp, fused=fused)
    mel_q = _sample(params, statics, backbone, nfe, n, nt, dev, hp,
                    fused=quantize_dit_params(fused, smooth=smooth))
    rel = float(np.linalg.norm(mel_q - mel_hp) / (np.linalg.norm(mel_hp) + 1e-12))
    snr = float(10 * np.log10(np.mean(mel_hp ** 2) / (np.mean((mel_q - mel_hp) ** 2) + 1e-12)))
    detail = (f"int8{'+smooth' if smooth else ''} vs {str(hp).replace('torch.', '')}: "
              f"mel rel-L2 {rel * 100:.2f}%, SNR {snr:.1f} dB @ {nfe} NFE")
    return ("OK" if rel < 0.10 else "FAIL"), detail


def leg_metric_smoke(wav: np.ndarray, sr: int, workdir: str, ecapa_ckpt: str = "",
                     utmos_ckpt: str = "", device=None) -> list[tuple]:
    """WER / SIM / UTMOS smoke on one waveform: each scorer loads its
    weights (strict loaders) and gives a finite score; SKIP without them."""
    from f5tts_tpu_torch.infer import audio_io

    rows = []
    gen_path = os.path.join(workdir, "parity_gen.wav")
    audio_io.write_wav(gen_path, wav.astype(np.float32), sr)
    try:
        from f5tts_tpu_torch.infer.asr import transcribe

        hypo = transcribe(wav.astype(np.float32), sr, language="en")
        rows.append(("wer-asr", "OK", f"transcript: {hypo[:60]!r}"))
    except Exception as e:
        rows.append(("wer-asr", "SKIP", f"{type(e).__name__}: {e}"))
    if ecapa_ckpt:
        try:
            from f5tts_tpu_torch.eval.utils_eval import run_sim

            sim = run_sim([(gen_path, gen_path)], ecapa_ckpt, device=device)[0]["sim"]
            ok = np.isfinite(sim) and sim > 0.95  # self-sim must be ~1
            rows.append(("sim", "OK" if ok else "FAIL", f"self-sim {sim:.4f}"))
        except Exception as e:
            rows.append(("sim", "FAIL", f"{type(e).__name__}: {e}"))
    else:
        rows.append(("sim", "SKIP", "no --ecapa_ckpt"))
    if utmos_ckpt:
        try:
            from f5tts_tpu_torch.eval.utmos22 import load_predictor

            dev = resolve_device(device)
            model = load_predictor(utmos_ckpt).to(dev)
            score = float(model(torch.from_numpy(wav.astype(np.float32))[None].to(dev), sr)[0])
            ok = np.isfinite(score) and 0.0 < score < 6.0
            rows.append(("utmos", "OK" if ok else "FAIL", f"MOS {score:.3f}"))
        except Exception as e:
            rows.append(("utmos", "FAIL", f"{type(e).__name__}: {e}"))
    else:
        rows.append(("utmos", "SKIP", "no --utmos_ckpt"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--model", default="F5TTS_v1_Base")
    ap.add_argument("--vocab", default="")
    ap.add_argument("--nfe", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--golden", default="", help="golden .npz to compare against")
    ap.add_argument("--write-golden", default="", help="write this run's mels")
    ap.add_argument("--mirror-golden", action="store_true",
                    help="also compare with the independent torch CFM sampler mirror "
                         "(tests/torch_mirror.py) on the converted weights, f32 on the CPU")
    ap.add_argument("--mirror-n", type=int, default=256)
    ap.add_argument("--mirror-nfe", type=int, default=7)
    ap.add_argument("--atol", type=float, default=2e-2)
    ap.add_argument("--rtol", type=float, default=2e-2)
    ap.add_argument("--full", action="store_true",
                    help="every leg the given weights allow: audit, mirror golden, vocoder "
                         "decode, int8 A/B (+ --smooth), WER / SIM / UTMOS smoke; legs "
                         "without weights SKIP, a failed leg exits 2")
    ap.add_argument("--vocos_ckpt", default="", help="vocos weights (.pt/.safetensors)")
    ap.add_argument("--bigvgan_ckpt", default="", help="bigvgan generator weights")
    ap.add_argument("--ecapa_ckpt", default="", help="wavlm_large_finetune.pth for SIM")
    ap.add_argument("--utmos_ckpt", default="", help="utmos22_strong state dict")
    ap.add_argument("--smooth", action="store_true",
                    help="also run the int8 outlier-hedge variant in the A/B leg")
    ap.add_argument("--workdir", default=".", help="where --full writes its smoke wav")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.full:
        args.mirror_golden = True

    from f5tts_tpu_torch.compat.torch_import import (convert_backbone_state_dict_audited,
                                                     load_torch_checkpoint)
    from f5tts_tpu_torch.config import PRESETS
    from f5tts_tpu_torch.text.vocab import load_vocab

    dev = resolve_device(args.device)
    cfg = PRESETS[args.model]
    vocab = load_vocab(args.vocab or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
        "vocab_emilia_pinyin.txt"))
    arch = dataclasses.replace(cfg.arch, text_num_embeds=len(vocab))

    # 1. digestion audit
    sd = load_torch_checkpoint(args.ckpt)
    params, unconsumed = convert_backbone_state_dict_audited(sd, arch, cfg.backbone)
    print(f"[parity] converted {len(sd)} checkpoint tensors -> {len(tree_leaves(params))} "
          "param leaves")
    if unconsumed:
        print(f"[parity] FAIL: {len(unconsumed)} unconsumed weight tensors:")
        for k in unconsumed[:20]:
            print(f"  - {k}")
        sys.exit(2)
    print("[parity] digestion audit OK: zero unconsumed weight tensors")

    # 2. fixed-seed sampling
    statics = cfm.BACKBONES[cfg.backbone].statics_cls(arch, dev)
    outs = run_configs(params, statics, args.nfe, device=dev, backbone=cfg.backbone)
    for name, mel in outs.items():
        print(f"[parity] {name}: mel shape {mel.shape} "
              f"checksum {float(np.sum(mel)):.6f} mean {float(np.mean(mel)):.6f}")
        if not np.all(np.isfinite(mel)):
            print(f"[parity] FAIL: non-finite mel at {name}")
            sys.exit(2)

    # 3. the cross-implementation mirror golden
    if args.mirror_golden:
        rc = run_mirror_golden(params, statics, cfg.backbone, n=args.mirror_n,
                               nfe=args.mirror_nfe)
        if rc:
            sys.exit(rc)

    # 3b. --full: every remaining leg
    if args.full:
        legs: list[tuple] = []
        for kind, path in (("vocos", args.vocos_ckpt), ("bigvgan", args.bigvgan_ckpt)):
            if not path:
                legs.append((f"vocoder-{kind}", "SKIP", f"no --{kind}_ckpt"))
                continue
            try:
                status, detail = leg_vocoder_decode(outs, kind, path, device=dev)
            except Exception as e:
                status, detail = "FAIL", f"{type(e).__name__}: {e}"
            legs.append((f"vocoder-{kind}", status, detail))
        try:
            legs.append(("int8-ab", *leg_int8_ab(params, statics, device=dev,
                                                 backbone=cfg.backbone)))
            if args.smooth:
                legs.append(("int8-ab-smooth", *leg_int8_ab(params, statics, smooth=True,
                                                            device=dev, backbone=cfg.backbone)))
        except Exception as e:
            legs.append(("int8-ab", "FAIL", f"{type(e).__name__}: {e}"))
        # the metric smoke scores a decoded wav when there is a Vocos, else a tone
        sr = 24000
        voc_wav = None
        if args.vocos_ckpt:
            try:
                mel = torch.from_numpy(next(iter(outs.values()))[:1]).to(dev)
                voc_wav = _vocoder("vocos", args.vocos_ckpt, dev)(
                    mel.transpose(1, 2)).cpu().numpy()[0]
            except Exception:
                voc_wav = None
        if voc_wav is None:
            t = np.arange(sr, dtype=np.float32) / sr
            voc_wav = (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        legs.extend(leg_metric_smoke(voc_wav, sr, args.workdir, args.ecapa_ckpt,
                                     args.utmos_ckpt, device=dev))
        print("\n[parity] --full summary:")
        width = max(len(name) for name, _, _ in legs)
        for name, status, detail in legs:
            print(f"  {name:<{width}}  {status:<5}  {detail}")
        if any(status == "FAIL" for _, status, _ in legs):
            sys.exit(2)

    # 4. golden comparison
    if args.write_golden:
        np.savez(args.write_golden, **outs)
        print(f"[parity] wrote golden {args.write_golden}")
    if args.golden:
        golden = np.load(args.golden)
        failed = False
        for name, mel in outs.items():
            ref = golden[name]
            d = np.abs(mel - ref)
            ok = np.allclose(mel, ref, atol=args.atol, rtol=args.rtol)
            print(f"[parity] {name}: max|d|={d.max():.4e} mean|d|={d.mean():.4e} "
                  f"{'OK' if ok else 'FAIL'}")
            failed |= not ok
        sys.exit(2 if failed else 0)
    print("[parity] PASS (no golden provided; checksums above)")


if __name__ == "__main__":
    main()
