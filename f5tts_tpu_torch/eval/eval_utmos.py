"""UTMOS (MOS prediction) over a directory of wavs (counterpart of
f5tts_tpu/eval/eval_utmos.py; the reference's src/f5_tts/eval/eval_utmos.py).

Scores every `*.{ext}` under `audio_dir` with the utmos22_strong predictor
on the card (or `device`), writes `_utmos_results.jsonl` (one line a wav,
then the mean) and returns the mean. `--ckpt` loads a local weights file
through `eval/utmos22.py`; without it the predictor comes from
`torch.hub` (tarepan/SpeechMOS), which needs the network: offline it
raises RuntimeError.

    python -m f5tts_tpu_torch.eval.eval_utmos --audio_dir results/... --ckpt utmos22.pt
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.utils import resolve_device


def eval_utmos(audio_dir: str, ext: str = "wav", device=None, ckpt: str = "") -> dict:
    import torch

    dev = resolve_device(device)
    if ckpt:
        from f5tts_tpu_torch.eval.utmos22 import load_predictor

        predictor = load_predictor(ckpt).to(dev)
    else:
        try:
            predictor = torch.hub.load("tarepan/SpeechMOS:v1.2.0", "utmos22_strong",
                                       trust_repo=True).to(dev)
        except Exception as e:
            raise RuntimeError(
                "UTMOS needs either --ckpt (offline weights file, see eval/utmos22.py) or "
                "torch.hub network access for tarepan/SpeechMOS") from e

    results = {}
    for path in Path(audio_dir).rglob(f"*.{ext}"):
        wav, sr = audio_io.read_wav(str(path))
        score = predictor(torch.from_numpy(wav)[None].to(dev), sr)
        results[str(path.stem)] = float(score.item())

    mean = sum(results.values()) / max(len(results), 1)
    with open(Path(audio_dir) / "_utmos_results.jsonl", "w") as f:
        for k, v in results.items():
            f.write(json.dumps({"wav": k, "utmos": v}) + "\n")
        f.write(json.dumps({"utmos": mean}) + "\n")
    return {"utmos_mean": mean, "n": len(results)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--ext", default="wav")
    p.add_argument("--ckpt", default="", help="local utmos22_strong weights file (offline mode)")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    print(eval_utmos(args.audio_dir, args.ext, device=args.device, ckpt=args.ckpt))


if __name__ == "__main__":
    main()
