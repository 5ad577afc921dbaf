"""The high-level `F5TTS` API (counterpart of f5tts_tpu/infer/api.py; the
reference's src/f5_tts/api.py).

    from f5tts_tpu_torch.infer.api import F5TTS
    tts = F5TTS(model="F5TTS_v1_Base", ckpt_file="model_1250000.safetensors")
    wav, sr, mel = tts.infer(ref_file="ref.wav", ref_text="...", gen_text="...")
    tts.export_wav(wav, "out.wav")

`model` is a preset name or a reference-layout YAML; `ckpt_file` a
reference .pt / .safetensors (read through the audited importer), the
port's checkpoint directory, or "random" for random weights (a smoke test).
Nothing is downloaded: without `ckpt_file` the constructor raises and names
the reference's repository and file for the model. The vocoder is the one
of the config's mel type (Vocos or BigVGAN), from `vocoder_ckpt` or with
random weights. Everything runs on the card unless `device` names another.
`export_spectrogram` (and `infer(file_spec=)`) writes the mel as a PNG
through `viz.py` (matplotlib, imported when called).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.infer.utils_infer import load_model, load_vocoder


def checkpoint_spec(model: str, mel_spec_type: str = "vocos") -> tuple[str, str]:
    """(Hugging Face repo, file in it) of the reference's published
    checkpoint for `model` (the JAX package's `download.checkpoint_spec`)."""
    repo_name, ckpt_step, ckpt_type = "F5-TTS", 1_250_000, "safetensors"
    if model == "F5TTS_Base":
        if mel_spec_type == "vocos":
            ckpt_step = 1_200_000
        elif mel_spec_type == "bigvgan":
            model = "F5TTS_Base_bigvgan"
            ckpt_type = "pt"
    elif model == "E2TTS_Base":
        repo_name = "E2-TTS"
        ckpt_step = 1_200_000
    return f"SWivid/{repo_name}", f"{model}/model_{ckpt_step}.{ckpt_type}"


def missing_checkpoint(model: str, mel_spec_type: str = "vocos") -> RuntimeError:
    repo, filename = checkpoint_spec(model, mel_spec_type)
    return RuntimeError(
        f"no checkpoint for {model}: pass ckpt_file= a local copy of hf://{repo}/{filename} "
        "(the reference's published weights; nothing is downloaded), a port checkpoint "
        "directory, or ckpt_file='random' for random weights")


class F5TTS:
    def __init__(self, model: str = "F5TTS_v1_Base", ckpt_file: str = "",
                 vocab_file: str = "", vocoder_ckpt: str = "", ode_method: str = "euler",
                 use_ema: bool = True, dtype=None, seed: Optional[int] = None, device=None):
        from f5tts_tpu_torch.config import PRESETS, load_model_config

        if ode_method != "euler":
            raise ValueError(f"ode_method {ode_method!r}: the pipeline samples with euler")
        cfg = PRESETS[model] if model in PRESETS else load_model_config(model)
        if not ckpt_file:
            raise missing_checkpoint(model, cfg.mel_spec.mel_spec_type)
        loaded = load_model(model, "" if ckpt_file == "random" else ckpt_file, vocab_file,
                            use_ema=use_ema, device=device, dtype=dtype)
        vocoder = load_vocoder(cfg.mel_spec.mel_spec_type, is_local=bool(vocoder_ckpt),
                               local_path=vocoder_ckpt, device=loaded.device)
        self.seed = seed
        self.config = loaded.config
        self.mel_cfg = loaded.config.mel_spec
        self.ode_method = ode_method
        self.device = loaded.device
        self.pipeline = loaded.pipeline(vocoder)

    def infer(self, ref_file: str, ref_text: str, gen_text: str, show_info=print,
              file_wave: Optional[str] = None, file_spec: Optional[str] = None,
              seed: Optional[int] = None, **kw):
        """(wave, sample rate, mel [d, t]) of `InferencePipeline.infer` on
        the reference file; keywords as there. Writes `file_wave` and the
        mel's PNG `file_spec` if given."""
        seed = seed if seed is not None else (self.seed if self.seed is not None else 0)
        wav, sr = audio_io.read_wav(ref_file)
        wave, out_sr, mel = self.pipeline.infer(wav, sr, ref_text, gen_text, seed=seed, **kw)
        if file_wave:
            self.export_wav(wave, file_wave)
        if file_spec:
            self.export_spectrogram(mel, file_spec)
        return wave, out_sr, mel

    def export_wav(self, wav: np.ndarray, file_wave: str) -> None:
        audio_io.write_wav(file_wave, wav, self.mel_cfg.target_sample_rate)

    def export_spectrogram(self, mel: np.ndarray, file_spec: str) -> None:
        from f5tts_tpu_torch.infer.viz import save_spectrogram

        save_spectrogram(mel, file_spec)
