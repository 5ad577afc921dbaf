"""Command-line inference (counterpart of f5tts_tpu/infer/cli.py; the
reference's `f5-tts_infer-cli`, src/f5_tts/infer/infer_cli.py): a TOML
config with argparse overrides, multi-voice `[voice]` tags with per-voice
speed, chunk saving, silence removal. Runs on the card (`--device` names
another). A reference without text would need ASR: it raises.

Entry point: `python -m f5tts_tpu_torch.infer.cli -c config.toml [overrides]`
(also installed as `f5tts-tpu-torch-infer`).
"""

from __future__ import annotations

import argparse
import os
import re
import tomllib

import numpy as np

from f5tts_tpu_torch.infer import audio_io


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="f5tts-tpu-torch-infer",
        description="F5-TTS inference on the card (reference flags: infer_cli.py)",
    )
    p.add_argument("-c", "--config", default="", help="TOML config file")
    p.add_argument("-m", "--model", default=None, help="model preset or YAML path")
    p.add_argument("-p", "--ckpt_file", default=None)
    p.add_argument("-v", "--vocab_file", default=None)
    p.add_argument("-r", "--ref_audio", default=None)
    p.add_argument("-s", "--ref_text", default=None)
    p.add_argument("-t", "--gen_text", default=None)
    p.add_argument("-f", "--gen_file", default=None)
    p.add_argument("-o", "--output_dir", default=None)
    p.add_argument("-w", "--output_file", default=None)
    p.add_argument("--save_chunk", action="store_true")
    p.add_argument("--remove_silence", action="store_true")
    p.add_argument("--vocoder_name", default=None, choices=[None, "vocos", "bigvgan"])
    p.add_argument("--vocoder_ckpt", default=None)
    p.add_argument("--target_rms", type=float, default=None)
    p.add_argument("--cross_fade_duration", type=float, default=None)
    p.add_argument("--nfe_step", type=int, default=None)
    p.add_argument("--cfg_strength", type=float, default=None)
    p.add_argument("--sway_sampling_coef", type=float, default=None)
    p.add_argument("--speed", type=float, default=None)
    p.add_argument("--fix_duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="the card unless named (e.g. 'cpu')")
    return p


def load_config(args: argparse.Namespace) -> dict:
    """TOML config with argparse values taking precedence (reference
    infer_cli.py:182-223)."""
    config: dict = {}
    if args.config:
        with open(args.config, "rb") as f:
            config = tomllib.load(f)
    for key in ("model", "ckpt_file", "vocab_file", "ref_audio", "ref_text",
                "gen_text", "gen_file", "output_dir", "output_file",
                "vocoder_name", "vocoder_ckpt", "target_rms",
                "cross_fade_duration", "nfe_step", "cfg_strength",
                "sway_sampling_coef", "speed", "fix_duration", "seed"):
        v = getattr(args, key, None)
        if v is not None:
            config[key] = v
    config.setdefault("model", "F5TTS_v1_Base")
    config.setdefault("output_dir", "tests")
    config.setdefault("output_file", "infer_cli_out.wav")
    if args.save_chunk:
        config["save_chunk"] = True
    if args.remove_silence:
        config["remove_silence"] = True
    return config


VOICE_SPLIT = r"(?=\[\w+\])"
VOICE_TAG = r"\[(\w+)\]"


def split_voice_segments(gen_text: str) -> list[tuple[str, str]]:
    """[(voice_name, text), ...] from `[voice]`-tagged text
    (reference infer_cli.py:322-342)."""
    out = []
    for chunk in re.split(VOICE_SPLIT, gen_text):
        if not chunk.strip():
            continue
        match = re.match(VOICE_TAG, chunk)
        voice = match[1] if match else "main"
        text = re.sub(VOICE_TAG, "", chunk).strip()
        if text:
            out.append((voice, text))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = load_config(args)

    from f5tts_tpu_torch.infer.api import F5TTS

    gen_text = config.get("gen_text", "")
    if config.get("gen_file"):
        with open(config["gen_file"], encoding="utf-8") as f:
            gen_text = f.read()

    tts = F5TTS(
        model=config["model"],
        ckpt_file=config.get("ckpt_file", ""),
        vocab_file=config.get("vocab_file", ""),
        vocoder_ckpt=config.get("vocoder_ckpt", ""),
        seed=config.get("seed"),
        device=args.device,
    )

    # voices: main + any [voices.*] tables (per-voice ref audio/text/speed)
    voices = {"main": {"ref_audio": config["ref_audio"],
                       "ref_text": config.get("ref_text", "")}}
    voices.update(config.get("voices", {}))

    # each voice's reference clipped at silences and trimmed (reference
    # infer_cli.py:317-319)
    from f5tts_tpu_torch.infer.utils_infer import preprocess_ref_audio_text

    prepared = {}
    for name, v in voices.items():
        wav, sr, ref_text = preprocess_ref_audio_text(
            v["ref_audio"], v.get("ref_text", ""))
        prepared[name] = {"wav": wav, "sr": sr,
                          "ref_text": ref_text,
                          "speed": v.get("speed")}

    segments = []
    out_dir = config["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    chunk_dir = os.path.join(out_dir, os.path.splitext(config["output_file"])[0])
    if config.get("save_chunk"):
        os.makedirs(chunk_dir, exist_ok=True)

    for voice, text in split_voice_segments(gen_text):
        if voice not in prepared:
            print(f"Voice {voice} not found, using main.")
            voice = "main"
        v = prepared[voice]
        wave, sr_out, _ = tts.pipeline.infer(
            v["wav"], v["sr"], v["ref_text"], text,
            seed=config.get("seed", 0) or 0,
            speed=v["speed"] if v["speed"] is not None else config.get("speed"),
            fix_duration=config.get("fix_duration"),
            nfe_step=config.get("nfe_step"),
            cfg_strength=config.get("cfg_strength"),
            sway_sampling_coef=config.get("sway_sampling_coef", "default"),
            cross_fade_duration=config.get("cross_fade_duration"),
        )
        segments.append(wave)
        if config.get("save_chunk"):
            name = text[:200]
            audio_io.write_wav(os.path.join(chunk_dir, f"{len(segments)-1}_{name}.wav"),
                               wave, sr_out)

    if not segments:
        print("No text to generate.")
        return 1

    final = np.concatenate(segments)
    if config.get("remove_silence"):
        from f5tts_tpu_torch.infer.audio_io import remove_silence_edges

        final = remove_silence_edges(final, tts.mel_cfg.target_sample_rate)
    out_path = os.path.join(out_dir, config["output_file"])
    audio_io.write_wav(out_path, final, tts.mel_cfg.target_sample_rate)
    print(out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
