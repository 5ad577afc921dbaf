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
The one-call inference API (`infer_process`, `infer_batch_process`,
`remove_silence_for_generated_wav`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from f5tts_tpu_torch.config import PRESETS, ModelConfig, load_model_config
from f5tts_tpu_torch.models.cfm import BACKBONES
from f5tts_tpu_torch.models.modules import tree_cast
from f5tts_tpu_torch.text.vocab import EMILIA_VOCAB, load_vocab
from f5tts_tpu_torch.utils import resolve_device

REFERENCE_SUFFIXES = (".pt", ".pth", ".bin", ".safetensors")


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
