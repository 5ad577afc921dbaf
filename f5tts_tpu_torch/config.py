"""Config schema for the PyTorch/CUDA port.

Own copies of the JAX package's dataclasses (f5tts_tpu/config.py) that the
zero-shot inference and training paths read: the mel front end, the backbone
arch, the CFM and sampler defaults, the training hyperparameters and every
preset of the JAX package: F5TTS_v1 / F5TTS (DiT) and E2TTS (UNetT) at the
Base (dim 1024) and Small (dim 768) sizes, and MMDiT_Base. The port imports nothing of the
JAX package, so the values are repeated here and the parity tests pin them.

The reference's YAML layout loads through `model_config_from_dict` /
`load_model_config` and `train_config_from_dict`; the six reference YAMLs
ship in `f5tts_tpu_torch/configs/` (`CONFIG_DIR`). PyYAML is imported by
`load_model_config` alone, so this module imports without it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
REMAT_POLICIES = ("nothing", "attn_out", "dots", "attn")


@dataclass(frozen=True)
class MelConfig:
    """100-channel mel at 24 kHz, hop 256 / win 1024 / n_fft 1024."""

    target_sample_rate: int = 24_000
    n_mel_channels: int = 100
    hop_length: int = 256
    win_length: int = 1024
    n_fft: int = 1024
    mel_spec_type: str = "vocos"  # "vocos" | "bigvgan" (the Slaney mel)

    def frames_for_samples(self, num_samples: int) -> int:
        """Mel frames of a clip: the vocos STFT is centred (len // hop + 1),
        the bigvgan one pads (n_fft - hop) / 2 a side (len // hop)."""
        if self.mel_spec_type == "vocos":
            return num_samples // self.hop_length + 1
        return num_samples // self.hop_length


@dataclass(frozen=True)
class ModelArch:
    """Backbone architecture (reference configs/*.yaml model.arch)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256  # vocab size (without the +1 filler)
    text_dim: Optional[int] = 512
    text_mask_padding: bool = True
    # zipvoice-style: the text's live tokens spread evenly over the audio
    # frames (`dit.average_upsample_text`)
    text_embedding_average_upsampling: bool = False
    qk_norm: Optional[str] = None  # None | "rms_norm" (per-head RMSNorm of q and k)
    conv_layers: int = 4
    conv_mult: int = 2
    pe_attn_head: Optional[int] = None  # partial RoPE: first N heads only
    # the DiT's Linear(2 dim -> dim, no bias) over [blocks' output, their input]
    long_skip_connection: bool = False
    # training: recompute each block in the backward (`models/remat.py`),
    # keeping what `remat_policy` names: "nothing" (only the block's input),
    # "attn_out" (the attention output and its row lse), "attn" (also the qkv
    # projection), "dots" (every matmul output, not the attention's)
    checkpoint_activations: bool = False
    remat_policy: str = "nothing"
    skip_connect_type: str = "concat"  # UNetT only: "add" | "concat" | "none"

    def __post_init__(self):
        if self.qk_norm not in (None, "rms_norm"):
            raise ValueError(f"qk_norm {self.qk_norm!r}: None or 'rms_norm'")
        if self.skip_connect_type not in ("add", "concat", "none"):
            raise ValueError(f"skip_connect_type {self.skip_connect_type!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of {REMAT_POLICIES}")

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


@dataclass(frozen=True)
class CFMConfig:
    """CFM wrapper hyperparameters (reference model/cfm.py:34-77)."""

    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple = (0.7, 1.0)
    sigma: float = 0.0
    ode_method: str = "euler"  # "euler" | "midpoint" (cfm_sample's method)


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh layout (`parallel.mesh.make_mesh`): data axis DP, model
    axis TP (head-sharded attention, column / row-parallel projections)."""

    data: int = 1
    model: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference configs/*.yaml optim + datasets + ckpts)."""

    dataset_name: str = "Emilia_ZH_EN"
    dataset_type: str = "CustomDataset"
    audio_type: str = "raw"
    batch_size_per_device: int = 38_400  # frames per device per update
    batch_size_type: str = "frame"
    max_samples: int = 64
    num_workers: int = 4

    epochs: int = 11
    learning_rate: float = 7.5e-5
    num_warmup_updates: int = 20_000
    grad_accumulation_steps: int = 1
    max_grad_norm: float = 1.0

    ema_decay: float = 0.999
    ema_update_after_step: int = 100
    ema_update_every: int = 10

    save_per_updates: int = 50_000
    keep_last_n_checkpoints: int = -1
    last_per_updates: int = 5_000
    save_dir: str = "ckpts"
    logger: Optional[str] = "tensorboard"  # "wandb" | "tensorboard" | None
    log_samples: bool = False  # milestone samples (needs a vocoder in the Trainer)


@dataclass(frozen=True)
class SamplingConfig:
    """Defaults for sampling (reference infer/utils_infer.py:52-65)."""

    nfe_steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: Optional[float] = -1.0
    use_epss: bool = True
    max_duration: int = 4096  # frames; the bucket cap, as in the JAX package
    target_rms: float = 0.1
    cross_fade_duration: float = 0.15
    speed: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "F5TTS_v1_Base"
    backbone: str = "DiT"  # "DiT" | "UNetT" | "MMDiT"
    tokenizer: str = "pinyin"  # "pinyin" | "char" | "byte" | "custom"
    tokenizer_path: Optional[str] = None
    arch: ModelArch = dataclasses.field(default_factory=ModelArch)
    mel_spec: MelConfig = dataclasses.field(default_factory=MelConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)


def _filter_kwargs(cls, d: dict) -> dict:
    """The entries of `d` that name a field of dataclass `cls`."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def model_config_from_dict(cfg: dict) -> ModelConfig:
    """A ModelConfig from a dict in the reference YAML layout (the `model`
    block, or the model block itself); keys the schema lacks are dropped,
    among them the JAX arch's attn_backend, attn_mask_enabled and context_dim,
    which select nothing in the port (it picks its kernels by device). The JAX
    ModelConfig's `cfm` and `compute_dtype` have no counterpart: the trainer
    takes a `CFMConfig` and the loaders a `dtype`."""
    model = cfg.get("model", cfg)
    arch = ModelArch(**_filter_kwargs(ModelArch, dict(model.get("arch", {}))))
    mel = MelConfig(**_filter_kwargs(MelConfig, dict(model.get("mel_spec", {}))))
    return ModelConfig(name=model.get("name", "custom"), backbone=model.get("backbone", "DiT"),
                       tokenizer=model.get("tokenizer", "pinyin"),
                       tokenizer_path=model.get("tokenizer_path"), arch=arch, mel_spec=mel)


def load_model_config(path: str) -> ModelConfig:
    """`model_config_from_dict` of a YAML file (PyYAML, imported here)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_model_config reads YAML through PyYAML, which is not "
                          "installed; build the dict yourself and call "
                          "model_config_from_dict") from e
    with open(path, "r", encoding="utf-8") as f:
        return model_config_from_dict(yaml.safe_load(f))


def train_config_from_dict(cfg: dict) -> TrainConfig:
    """A TrainConfig from the reference YAML's datasets / optim / ckpts blocks."""
    datasets, optim, ckpts = (cfg.get(k, {}) for k in ("datasets", "optim", "ckpts"))
    return TrainConfig(
        dataset_name=datasets.get("name", "Emilia_ZH_EN"),
        dataset_type=datasets.get("dataset_type", "CustomDataset"),
        audio_type=datasets.get("audio_type", "raw"),
        batch_size_per_device=datasets.get("batch_size_per_gpu", 38_400),
        batch_size_type=datasets.get("batch_size_type", "frame"),
        max_samples=datasets.get("max_samples", 64),
        num_workers=datasets.get("num_workers", 4),
        epochs=optim.get("epochs", 11),
        learning_rate=optim.get("learning_rate", 7.5e-5),
        num_warmup_updates=optim.get("num_warmup_updates", 20_000),
        grad_accumulation_steps=optim.get("grad_accumulation_steps", 1),
        max_grad_norm=optim.get("max_grad_norm", 1.0),
        save_per_updates=ckpts.get("save_per_updates", 50_000),
        keep_last_n_checkpoints=ckpts.get("keep_last_n_checkpoints", -1),
        last_per_updates=ckpts.get("last_per_updates", 5_000),
        save_dir=ckpts.get("save_dir", "ckpts"),
        logger=ckpts.get("logger", "tensorboard"),
        log_samples=ckpts.get("log_samples", False),
    )


def _preset(name: str, backbone: str, **arch_kw: Any) -> ModelConfig:
    return ModelConfig(name=name, backbone=backbone, arch=ModelArch(**arch_kw))


PRESETS: dict[str, ModelConfig] = {
    # F5TTS_v1_Base.yaml: dim 1024, depth 22, heads 16, ff_mult 2, text_dim 512,
    # conv_layers 4, text_mask_padding True, pe_attn_head None
    "F5TTS_v1_Base": _preset(
        "F5TTS_v1_Base", "DiT", dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
        text_mask_padding=True, conv_layers=4, pe_attn_head=None,
    ),
    # F5TTS_Base.yaml (the original published F5-TTS checkpoint): the same
    # dims, text_mask_padding False, pe_attn_head 1 (RoPE on the first head)
    "F5TTS_Base": _preset(
        "F5TTS_Base", "DiT", dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
        text_mask_padding=False, conv_layers=4, pe_attn_head=1,
    ),
    "F5TTS_v1_Small": _preset(
        "F5TTS_v1_Small", "DiT", dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
        text_mask_padding=True, conv_layers=4, pe_attn_head=None,
    ),
    "F5TTS_Small": _preset(
        "F5TTS_Small", "DiT", dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
        text_mask_padding=False, conv_layers=4, pe_attn_head=1,
    ),
    # E2TTS_Base.yaml: UNetT dim 1024, depth 24, heads 16, ff_mult 4, the mel
    # width as text width, no ConvNeXt text blocks
    "E2TTS_Base": _preset(
        "E2TTS_Base", "UNetT", dim=1024, depth=24, heads=16, ff_mult=4, text_dim=None,
        text_mask_padding=False, conv_layers=0,
    ),
    "E2TTS_Small": _preset(
        "E2TTS_Small", "UNetT", dim=768, depth=20, heads=12, ff_mult=4, text_dim=None,
        text_mask_padding=False, conv_layers=0,
    ),
    # SD3-style dual-stream backbone: no published checkpoint; the upstream
    # class defaults at the DiT-Base size, as the JAX package sizes it
    "MMDiT_Base": _preset(
        "MMDiT_Base", "MMDiT", dim=1024, depth=22, heads=16, ff_mult=2, text_dim=None,
        text_mask_padding=True, conv_layers=0,
    ),
}


def get_preset(name: str, **overrides: Any) -> ModelConfig:
    """PRESETS[name] with ModelConfig fields replaced by `overrides`."""
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
