"""The reference's model loaders (counterpart of the loaders of
f5tts_tpu/infer/utils_infer.py:50-151; the reference's
src/f5_tts/infer/utils_infer.py load_vocoder / load_checkpoint /
load_model).

- `load_vocoder`: Vocos or BigVGAN, from a local torch checkpoint through
  `compat`, or with random weights from a `torch.Generator`.
- `load_checkpoint`: a reference checkpoint (.pt / .pth / .bin /
  .safetensors) through the audited importer (a weight key the converter
  does not read raises), or the port's own checkpoint directory
  (`train.checkpoint.load_params`).
- `load_model`: a preset name or a reference-layout YAML, the vocab, and a
  checkpoint or random weights; `LoadedModel.pipeline(vocoder)` builds the
  `InferencePipeline`.
Every loader takes `device=None`, which is the card (`utils.resolve_device`).

The one-call inference API (the reference's `infer_process`,
`infer_batch_process` with and without streaming,
`remove_silence_for_generated_wav`) runs through `LoadedModel.pipeline`;
`preprocess_ref_audio_text` clips, trims and caches a reference and fixes
its text's final punctuation. Audio rides as (float32 array, sample rate).
An empty `ref_text` is transcribed by `asr.transcribe`, which needs
whisper weights the repository does not hold: without them it raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from f5tts_tpu_torch.config import PRESETS, ModelConfig, load_model_config
from f5tts_tpu_torch.infer import audio_io
from f5tts_tpu_torch.models.cfm import BACKBONES
from f5tts_tpu_torch.models.modules import tree_cast
from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
from f5tts_tpu_torch.utils import resolve_device

REFERENCE_SUFFIXES = (".pt", ".pth", ".bin", ".safetensors")

# the reference's defaults (its utils_infer.py:40-57)
target_sample_rate = 24000
hop_length = 256
target_rms = 0.1
cross_fade_duration = 0.15
ode_method = "euler"
nfe_step = 32
cfg_strength = 2.0
sway_sampling_coef = -1.0
speed = 1.0
fix_duration = None

remove_silence_edges = audio_io.remove_silence_edges


def load_vocoder(vocoder_name: str = "vocos", is_local: bool = False, local_path: str = "",
                 device=None, generator: Optional[torch.Generator] = None) -> Callable:
    """A mel [b, d, t] -> wav [b, n] vocoder on `device`: the torch
    checkpoint at `local_path` when `is_local`, else random weights from
    `generator` (seed 1 when None). Nothing is downloaded."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(1)
    if vocoder_name == "vocos":
        from f5tts_tpu_torch.vocoder.vocos import Vocos, VocosConfig, init_vocos

        cfg = VocosConfig()
        if is_local and local_path:
            from f5tts_tpu_torch.compat import convert_vocos_state_dict, load_torch_checkpoint

            params = convert_vocos_state_dict(load_torch_checkpoint(local_path))
        else:
            params = init_vocos(gen, cfg)
        return Vocos(params, cfg, device=dev)
    if vocoder_name == "bigvgan":
        from f5tts_tpu_torch.vocoder.bigvgan import (BigVGAN, BigVGANConfig,
                                                     convert_bigvgan_state_dict, init_bigvgan)

        cfg = BigVGANConfig()
        if is_local and local_path:
            from f5tts_tpu_torch.compat import load_torch_checkpoint

            params = convert_bigvgan_state_dict(load_torch_checkpoint(local_path), cfg)
        else:
            params = init_bigvgan(gen, cfg)
        return BigVGAN(params, cfg, device=dev)
    raise ValueError(f"unknown vocoder {vocoder_name!r} (vocos | bigvgan)")


def load_checkpoint(arch, ckpt_path: str, device=None, dtype=None, use_ema: bool = True,
                    backbone: str = "DiT") -> dict:
    """The backbone params of `ckpt_path` on `device` (cast to `dtype` when
    given): a reference checkpoint through
    `compat.convert_backbone_state_dict_audited`, raising when a weight key
    is left unread, else the port's checkpoint directory (its EMA params
    with `use_ema`)."""
    dev = resolve_device(device)
    if ckpt_path.endswith(REFERENCE_SUFFIXES):
        from f5tts_tpu_torch.compat import (convert_backbone_state_dict_audited,
                                            load_torch_checkpoint)

        params, unread = convert_backbone_state_dict_audited(load_torch_checkpoint(ckpt_path),
                                                             arch, backbone)
        if unread:
            raise ValueError(f"{ckpt_path}: {len(unread)} weight keys the {backbone} converter "
                             f"does not read (arch {arch}): {unread[:8]}")
    else:
        from f5tts_tpu_torch.train.checkpoint import load_params

        params = load_params(ckpt_path, use_ema=use_ema)
    return tree_cast(params, dtype, dev)


@dataclass
class LoadedModel:
    """What `load_model` returns (the reference's `model_obj`): params, the
    config, the vocab, the compute dtype and the device; `pipeline(vocoder)`
    builds (once a vocoder) the InferencePipeline."""

    params: dict
    config: ModelConfig
    vocab: dict
    dtype: torch.dtype
    device: torch.device
    _pipelines: dict = field(default_factory=dict)

    def pipeline(self, vocoder: Callable):
        from f5tts_tpu_torch.infer.pipeline import InferencePipeline

        key = id(vocoder)
        if key not in self._pipelines:
            cfg = self.config
            self._pipelines[key] = InferencePipeline(
                params=self.params, statics=BACKBONES[cfg.backbone].statics_cls(cfg.arch),
                vocoder=vocoder, vocab_char_map=self.vocab, mel_cfg=cfg.mel_spec,
                sampling=cfg.sampling, tokenizer=cfg.tokenizer, dtype=self.dtype,
                device=self.device, backbone=cfg.backbone)
        return self._pipelines[key]


def load_model(model: str = "F5TTS_v1_Base", ckpt_path: str = "", vocab_file: str = "",
               use_ema: bool = True, device=None, dtype=None,
               generator: Optional[torch.Generator] = None) -> LoadedModel:
    """`model`: a preset name or a reference-layout YAML path. The arch's
    text_num_embeds follows the vocab (`vocab_file`, the Emilia pinyin vocab
    by default); the weights come from `ckpt_path`, else from `generator`
    (seed 0 when None) as the backbone's init draws them. `dtype` defaults to
    bf16 on the card and f32 on the CPU."""
    dev = resolve_device(device)
    dtype = dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)
    cfg = PRESETS[model] if model in PRESETS else load_model_config(model)
    vocab = load_vocab(vocab_file or EMILIA_VOCAB)
    arch = dataclasses.replace(cfg.arch, text_num_embeds=len(vocab))
    if ckpt_path:
        params = load_checkpoint(arch, ckpt_path, dev, use_ema=use_ema, backbone=cfg.backbone)
    else:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = tree_cast(BACKBONES[cfg.backbone].init(gen, arch), None, dev)
    return LoadedModel(params=params, config=dataclasses.replace(cfg, arch=arch), vocab=vocab,
                       dtype=dtype, device=dev)


_ref_audio_cache: dict = {}
_ref_text_cache: dict = {}


def preprocess_ref_audio_text(ref_audio_path: str, ref_text: str,
                              show_info: Callable = print,
                              language: Optional[str] = None) -> tuple[np.ndarray, int, str]:
    """(clipped wav, sample rate, ref text) of a reference file: the clip
    policy of `audio_io.clip_ref_audio` (cut at silences to <= 12 s, edges
    trimmed, 50 ms of silence appended), cached by the file's MD5, and the
    text ending in ". " or "。". An empty `ref_text` is transcribed
    (`asr.transcribe`, cached by the MD5); without the whisper weights that
    raises RuntimeError."""
    with open(ref_audio_path, "rb") as f:
        audio_hash = hashlib.md5(f.read()).hexdigest()
    if audio_hash in _ref_audio_cache:
        show_info("Using cached preprocessed reference audio...")
        wav, sr = _ref_audio_cache[audio_hash]
    else:
        wav, sr = audio_io.read_wav(ref_audio_path)
        wav = audio_io.clip_ref_audio(wav, sr)
        _ref_audio_cache[audio_hash] = (wav, sr)
    if not ref_text.strip():
        if audio_hash in _ref_text_cache:
            show_info("Using cached reference text...")
            ref_text = _ref_text_cache[audio_hash]
        else:
            from f5tts_tpu_torch.infer.asr import transcribe

            show_info("No reference text provided, transcribing reference audio...")
            ref_text = transcribe(wav, sr, language)
            _ref_text_cache[audio_hash] = ref_text
    else:
        show_info("Using custom reference text...")
    if not ref_text.endswith(". ") and not ref_text.endswith("。"):
        ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "
    return wav, sr, ref_text


def _ref_audio(ref_audio) -> tuple[np.ndarray, int]:
    if isinstance(ref_audio, str):
        return audio_io.read_wav(ref_audio)
    wav, sr = ref_audio
    return np.asarray(wav, np.float32), sr


def infer_process(ref_audio, ref_text: str, gen_text: str, model_obj: LoadedModel,
                  vocoder: Callable, show_info: Callable = print, target_rms: float = target_rms,
                  cross_fade_duration: float = cross_fade_duration, nfe_step: int = nfe_step,
                  cfg_strength: float = cfg_strength,
                  sway_sampling_coef: float = sway_sampling_coef, speed: float = speed,
                  fix_duration: Optional[float] = fix_duration, seed: int = 0):
    """One-call TTS: the text chunked by the reference's speech rate, each
    chunk generated, cross-faded. `ref_audio` is a WAV path or (array,
    sample rate). Returns (wave, sample rate, mel [d, t])."""
    wav, sr = _ref_audio(ref_audio)
    show_info(f"Generating audio for {len(gen_text)} chars...")
    return model_obj.pipeline(vocoder).infer(
        wav, sr, ref_text, gen_text, seed=seed, speed=speed, fix_duration=fix_duration,
        nfe_step=nfe_step, cfg_strength=cfg_strength, sway_sampling_coef=sway_sampling_coef,
        cross_fade_duration=cross_fade_duration, target_rms=target_rms)


def infer_batch_process(ref_audio, ref_text: str, gen_text_batches: list[str],
                        model_obj: LoadedModel, vocoder: Callable, streaming: bool = False,
                        chunk_size: int = 2048, seed: int = 0, **kw):
    """The given text chunks, each generated (`generate_chunk`, keywords as
    there). Without streaming: (cross-faded wave, sample rate, mel [d, t]);
    streaming: a generator of (wave piece of `chunk_size` samples, sample
    rate), not cross-faded."""
    from f5tts_tpu_torch.infer.pipeline import cross_fade

    wav, sr = _ref_audio(ref_audio)
    pipe = model_obj.pipeline(vocoder)
    xf = kw.pop("cross_fade_duration", cross_fade_duration)
    if streaming:
        return pipe.infer_stream(wav, sr, ref_text, gen_text_batches, chunk_size=chunk_size,
                                 seed=seed, **kw)
    ref = audio_io.resample(wav, sr, pipe.sr)
    waves, mels = [], []
    for chunk in gen_text_batches:
        w, m = pipe.generate_chunk(ref, ref_text, chunk, seed=seed, **kw)
        waves.append(w)
        mels.append(m)
    return cross_fade(waves, pipe.sr, xf), pipe.sr, np.concatenate(mels, axis=1)


def remove_silence_for_generated_wav(filename: str) -> None:
    """Cut the silences of >= 1 s (-50 dB) out of a WAV file, keeping 500 ms
    on either side, in place."""
    wav, sr = audio_io.read_wav(filename)
    segs = audio_io.split_on_silence(wav, sr, min_silence_len_ms=1000, silence_thresh_db=-50.0,
                                     keep_silence_ms=500)
    audio_io.write_wav(filename, np.concatenate(segs) if segs else wav[:0], sr)
