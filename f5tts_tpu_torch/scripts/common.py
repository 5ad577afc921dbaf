"""Seeded models and requests shared by chip_smoke.py and the profiler.

F5TTS_v1_Base (text_num_embeds 2545, as the JAX package's bench.py) and
Vocos with random weights from fixed seeds; the zero-initialised AdaLN,
norm_out, proj_out and GRN leaves are randomised so the DiT is no identity.
No checkpoint is read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from f5tts_tpu_torch.config import PRESETS, ModelArch
from f5tts_tpu_torch.models import dit
from f5tts_tpu_torch.vocoder.vocos import VocosConfig, init_vocos

REF_TEXT = "Some call me nature, others call me mother nature."
REQUESTS = [
    "I have been here for billions of years, and I will be here long after you are gone.",
    ("The river keeps its course through the valley, carrying the snow of the mountains down "
     "to the sea, while the forests grow slowly on either bank."),
    "Every morning the light returns, and the birds begin again.",
]
# char vocabulary: space (index 0) and printable ASCII
VOCAB = {c: i for i, c in enumerate(" " + "".join(chr(i) for i in range(33, 127)))}


def base_models(seed: int = 0) -> tuple[ModelArch, dict, dict]:
    """(arch, DiT params, Vocos params), f32 on the CPU."""
    arch = dataclasses.replace(PRESETS["F5TTS_v1_Base"].arch, text_num_embeds=2545)
    gen = torch.Generator().manual_seed(seed)
    params = dit.activate_zero_init(dit.init_dit(gen, arch), gen)
    vocos_params = init_vocos(torch.Generator().manual_seed(seed + 1), VocosConfig())
    return arch, params, vocos_params


def synthetic_ref_wav(seconds: float = 2.7, sr: int = 24000) -> np.ndarray:
    """A seeded voiced-like reference: harmonics of a wobbling pitch + noise."""
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 3.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 8))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t) ** 2)
    wav = 0.05 * wav / np.abs(wav).max() + 0.003 * rng.standard_normal(t.shape)
    return wav.astype(np.float32)
